"""Images in and out of the serving wire, without Pillow.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/core/imaging.py``'s
``base64_to_pil`` / ``to_pil`` / ``bytes_to_pil`` / ``pil_to_jpeg`` /
``pil_to_base64``, on (H, W, 3) uint8 arrays. The card host has no Pillow and
no cv2, so the entropy coding, the DCTs, the PNG row filters and the BMP,
GIF and WebP decoders run in ``csrc/host/`` (``image_codec.cc``,
``bmp_gif.cc``, ``webp.cc``): plain C entry points loaded with ``ctypes``,
built at first use with the system C++ compiler (``c++``, or ``$CXX``) into
``build/host/`` at the root of the checkout, under a name that carries a hash
of every source (as ``runtime/kernels.py`` builds the CUDA kernels). Nothing
is built when this module is imported; a missing compiler raises when a call
needs the library.

- :func:`decode` sniffs JPEG, PNG, BMP, GIF or WebP by its magic bytes,
  applies the orientation ``ImageOps.exif_transpose`` applies (the EXIF tag,
  else an XMP packet's ``tiff:Orientation``, as Pillow's ``getexif`` reads
  them) and returns RGB: its pixels equal Pillow's ``convert("RGB")`` bit
  for bit.
  JPEG (libjpeg-turbo's islow IDCT, fancy upsampling and fixed-point
  colour conversion): baseline, 8-bit extended sequential and progressive
  Huffman JPEG with 1, 3 or 4 components, any whole-number sampling ratio
  (fancy upsampling at 2, box replication above) and restart intervals;
  YCbCr, RGB-coded (Adobe transform 0), CMYK and YCCK (read as Pillow reads
  them: inverted, then its ``cmyk2rgb``).
  PNG, Adam7-interlaced or not, of every colour type at every depth it
  allows: gray at 1, 2 and 4 bits (scaled ×255, ×85, ×17, as libpng and
  Pillow scale them), palette at 1 to 8 bits, and 16-bit samples as
  Pillow's ``convert("RGB")`` gives them (RGB, RGBA and gray + alpha keep
  the high byte; 16-bit gray, Pillow's I;16, is clipped at 255); alpha and
  ``tRNS`` dropped.
  BMP (CORE, INFO, V4 and V5 headers; 1, 4 and 8 bits with a palette, 16,
  24 and 32 bits, ``BI_BITFIELDS`` at Pillow's layouts, RLE8 and RLE4;
  bottom-up or top-down), GIF (the first frame: LZW, interlace, global or
  local palette, an offset frame, the transparency index's canvas) and
  WebP (lossy VP8 with libwebp's fancy upsampling and YUV→RGB, lossless
  VP8L, ALPH checked and dropped, the extended container and an
  animation's first frame).
  Anything else raises a ``ValueError`` that names the feature:
  arithmetic-coded, lossless, hierarchical and 12-bit JPEG, a fractional
  sampling ratio, a progressive file whose scans leave coefficients that
  libjpeg-turbo would block-smooth, BMP compressions and bitfield layouts
  Pillow does not read, a GIF LZW code size above 8, a WebP frame that is
  not a key frame, and other formats (TIFF). So does an image above
  Pillow's decompression-bomb limit (:data:`MAX_PIXELS`), before anything of
  it is allocated; a PNG inflates no further than its rows, an LZW, prefix
  or LZ77 stream no further than its image, and data that runs out
  (truncated) raises naming its format, as does a progressive JPEG without
  its EOI.
- :func:`encode_jpeg` writes what Pillow's ``save(format="JPEG",
  quality=q)`` writes (JFIF, the scaled Annex K tables, 4:2:0, standard
  Huffman tables), so Pillow decodes the two files to the same pixels.
"""

from __future__ import annotations

import base64
import ctypes
import fractions
import hashlib
import math
import os
import re
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE_DIR = Path(__file__).resolve().parent.parent / "csrc" / "host"
# one library of every decoder (and the shared header, which the hash covers)
SOURCES = ("image_codec.cc", "bmp_gif.cc", "webp.cc")
HEADERS = ("codec_common.h",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Pillow's DecompressionBombError limit (2 * Image.MAX_IMAGE_PIXELS): larger
# images raise before anything is allocated (image_codec.cc holds JPEG to it)
MAX_PIXELS = 178956970
# ImageOps.exif_transpose: EXIF orientation → the transpose that undoes it
_ORIENT = {
    2: lambda a: a[:, ::-1],
    3: lambda a: a[::-1, ::-1],
    4: lambda a: a[::-1],
    5: lambda a: a.transpose(1, 0, 2),
    6: lambda a: np.rot90(a, -1),
    7: lambda a: a[::-1, ::-1].transpose(1, 0, 2),
    8: lambda a: np.rot90(a, 1),
}


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler found (set CXX): the image codec "
                           "is native code built at first use")
    return cxx


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode() + b"\0" + (SOURCE_DIR / name).read_bytes())
    return BUILD_DIR / f"libqie_codec_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """Every source compiled at once, one compiler process each, then linked
    into ``path`` (written under a temporary name, then renamed)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    work = path.with_suffix(f".{os.getpid()}.tmp")
    work.mkdir(exist_ok=True)
    try:
        objs = [work / f"{name}.o" for name in SOURCES]
        procs = [subprocess.Popen([_compiler(), *CXX_FLAGS, "-c", "-o", str(obj),
                                   str(SOURCE_DIR / name)],
                                  stderr=subprocess.PIPE, text=True)
                 for name, obj in zip(SOURCES, objs)]
        errors = [err for proc in procs for err in [proc.communicate()[1]]
                  if proc.returncode != 0]
        if not errors:
            link = subprocess.run([_compiler(), "-shared", "-o", str(work / "lib.so"),
                                   *map(str, objs)], capture_output=True, text=True)
            errors = [link.stderr] if link.returncode != 0 else []
        if errors:
            raise RuntimeError("building the image codec failed:\n" + "\n".join(errors))
        os.replace(work / "lib.so", path)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded codec library, built first if this checkout has none."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        vp, ci, cl, cp = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_char_p
        pi, pl = ctypes.POINTER(ci), ctypes.POINTER(cl)
        lib.qie_jpeg_info.argtypes = [cp, cl, pi, pi, pi, pl, pl, vp, ci]
        lib.qie_jpeg_info.restype = ci
        lib.qie_jpeg_decode.argtypes = [cp, cl, vp, vp, ci]
        lib.qie_jpeg_decode.restype = ci
        lib.qie_jpeg_encode.argtypes = [vp, ci, ci, ci, ci, ci, ci, vp, cl, vp, ci]
        lib.qie_jpeg_encode.restype = cl
        lib.qie_png_unfilter.argtypes = [cp, ci, cl, ci, vp, vp, ci]
        lib.qie_png_unfilter.restype = ci
        lib.qie_webp_info.argtypes = [cp, cl, pi, pi, pl, pl, pl, pl, vp, ci]
        lib.qie_webp_info.restype = ci
        lib.qie_webp_decode.argtypes = [cp, cl, vp, vp, ci]
        lib.qie_webp_decode.restype = ci
        for fmt in ("bmp", "gif"):
            info, dec = getattr(lib, f"qie_{fmt}_info"), getattr(lib, f"qie_{fmt}_decode")
            info.argtypes, info.restype = [cp, cl, pi, pi, vp, ci], ci
            dec.argtypes, dec.restype = [cp, cl, vp, vp, ci], ci
        _lib = lib
        return lib


def _err() -> ctypes.Array:
    return ctypes.create_string_buffer(256)


# the TIFF headers Pillow's ImageFileDirectory_v2 accepts
_TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
                  b"MM\x00\x2b", b"II\x2b\x00")
# TIFF field type → (bytes a value, struct code: None for no number, and a
# numerator and denominator of that code for the 8-byte rationals), as
# Pillow loads them
_TIFF_TYPES = {1: (1, None), 2: (1, None), 3: (2, "H"), 4: (4, "L"), 5: (8, "L"),
               6: (1, "b"), 7: (1, None), 8: (2, "h"), 9: (4, "l"), 10: (8, "l"),
               11: (4, "f"), 12: (8, "d"), 13: (4, "L"), 16: (8, "Q")}


def _exif_tag(exif: bytes) -> Optional[int]:
    """The orientation of an EXIF block as Pillow's ``Image.Exif`` reads it:
    None where IFD0 has no usable orientation entry (an unknown type, no
    data, a read past the block ending the directory), else the transpose's
    number (1 for a value that selects none). Raises where Pillow raises: a
    header that is not TIFF, short or BigTIFF."""
    while exif.startswith(b"Exif\x00\x00"):
        exif = exif[6:]
    if not exif:
        return None
    if exif[:4] not in _TIFF_PREFIXES or exif[2] == 0x2b or len(exif) < 8:
        raise ValueError(f"corrupt EXIF: header {exif[:8]!r} is not TIFF's")
    e = "<" if exif[:2] == b"II" else ">"
    (pos,) = struct.unpack_from(e + "L", exif, 4)
    if pos + 2 > len(exif):
        return None
    (count,) = struct.unpack_from(e + "H", exif, pos)
    pos += 2
    found = None
    for _ in range(count):
        if pos + 12 > len(exif):
            break
        tag, typ, n = struct.unpack_from(e + "HHL", exif, pos)
        data = exif[pos + 8:pos + 12]
        pos += 12
        if typ not in _TIFF_TYPES:
            continue
        size = n * _TIFF_TYPES[typ][0]
        if size > 4:
            (off,) = struct.unpack(e + "L", data)
            if off + size > len(exif):
                break  # Pillow's read past the data ends the directory
            data = exif[off:off + size]
        else:
            data = data[:size]
        if data and tag == 0x0112:
            found = (typ, data)
    if found is None:
        return None
    typ, data = found
    unit, code = _TIFF_TYPES[typ]
    if code is None:
        return 1
    if unit == 8 and code in "Ll":  # a rational: the first numerator / denominator
        num, den = struct.unpack_from(e + 2 * code, data)
        value = fractions.Fraction(num, den) if den else math.nan
    else:
        value = struct.unpack_from(e + code, data)[0]
    return int(value) if value in range(2, 9) else 1


# Image.getexif: an XMP packet's orientation where the EXIF has none
_XMP_ORIENTATION = re.compile(rb'tiff:Orientation(="|>)([0-9])')


def orientation(exif: Optional[bytes], xmp: Optional[bytes] = None) -> int:
    """The orientation ``ImageOps.exif_transpose`` applies: the EXIF tag,
    else the first ``tiff:Orientation`` of the XMP packet (as Pillow's
    ``getexif`` reads them), else 1."""
    v = _exif_tag(exif) if exif else None
    if v is None and xmp:
        m = _XMP_ORIENTATION.search(xmp)
        v = int(m[2]) if m else None
    return 1 if v is None else v


def _orient(arr: np.ndarray, o: int) -> np.ndarray:
    fix = _ORIENT.get(o)
    return np.ascontiguousarray(fix(arr)) if fix else arr


_XMP_APP1 = b"http://ns.adobe.com/xap/1.0/\x00"


def _jpeg_app1(data: bytes):
    """(EXIF, XMP, dpi) of a JPEG's APP segments before its first scan, as
    Pillow keeps them: the first Exif segment with the later ones' payloads
    appended, the last XMP packet, and whether a JFIF segment gives a
    density in dots per inch or centimetre."""
    pos, exif, xmp, dpi = 2, None, None, False
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker in (0xD9, 0xDA):
            break
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        (n,) = struct.unpack_from(">H", data, pos + 2)
        seg = data[pos + 4:pos + 2 + n]
        if marker == 0xE1 and seg.startswith(b"Exif\x00\x00"):
            exif = seg if exif is None else exif + seg[6:]
        elif marker == 0xE1 and seg.startswith(_XMP_APP1):
            xmp = seg.split(b"\x00", 1)[1]
        elif marker == 0xE0 and seg[:4] == b"JFIF" and len(seg) >= 12:
            dpi = dpi or seg[7] in (1, 2)
        pos += 2 + n
    return exif, xmp, dpi


def _decode_jpeg(data: bytes) -> np.ndarray:
    lib = library()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    off, ln = ctypes.c_long(), ctypes.c_long()
    err = _err()
    if lib.qie_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
                         ctypes.byref(off), ctypes.byref(ln), err, len(err)) != 0:
        raise ValueError(err.value.decode())
    out = np.empty((h.value, w.value, c.value), np.uint8)
    if lib.qie_jpeg_decode(data, len(data), out.ctypes.data, err, len(err)) != 0:
        raise ValueError(err.value.decode())
    if c.value == 1:
        out = np.repeat(out, 3, axis=2)
    exif, xmp, dpi = _jpeg_app1(data)
    try:
        o = orientation(exif, xmp)
    except ValueError:
        if dpi:
            raise
        # Pillow reads the EXIF while it opens a JPEG without a JFIF density
        # (for its dpi), swallows the error and keeps no orientation at all
        o = 1
    return _orient(out, o)


# PNG colour type → (channels, name)
_PNG_TYPES = {0: (1, "gray"), 2: (3, "RGB"), 3: (1, "palette"), 4: (2, "gray+alpha"),
              6: (4, "RGBA")}


def _decode_png(data: bytes) -> np.ndarray:
    pos, idat, palette, exif, hdr, xmp = 8, [], None, None, None, None
    while pos + 8 <= len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if len(body) < n:
            raise ValueError("truncated PNG: a chunk ends early")
        if not _PNG_CHUNK_TYPE.fullmatch(tag):
            if not idat:
                raise ValueError(f"corrupt PNG: chunk type {tag!r}")
            break  # past the image data Pillow stops reading there
        if not idat and tag != b"IDAT":
            # Pillow checks every chunk's CRC up to the image data
            crc = data[pos + 8 + n:pos + 12 + n]
            if len(crc) < 4:
                raise ValueError(f"truncated PNG: the {tag.decode()} chunk's CRC is missing")
            if zlib.crc32(tag + body) != struct.unpack(">I", crc)[0]:
                raise ValueError(f"corrupt PNG: bad CRC in the {tag.decode()} chunk")
        pos += 12 + n
        if tag == b"IHDR":
            if n != 13:
                raise ValueError("corrupt PNG: bad IHDR")
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            if n % 3:
                raise ValueError("corrupt PNG: bad PLTE")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"eXIf":
            exif = body
        elif tag in (b"tEXt", b"zTXt", b"iTXt") and body.startswith(_PNG_XMP_KEY):
            xmp = _png_text(tag, body[len(_PNG_XMP_KEY):])
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("corrupt PNG: no IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if w == 0 or h == 0:
        raise ValueError("corrupt PNG: zero width or height")
    if w * h > MAX_PIXELS:
        raise ValueError(f"unsupported PNG: {w}x{h} pixels exceed the "
                         f"decompression-bomb limit")
    if ctype not in _PNG_TYPES:
        raise ValueError(f"corrupt PNG: colour type {ctype}")
    if depth not in (1, 2, 4, 8, 16) or (depth < 8 and ctype not in (0, 3)) or (
            depth == 16 and ctype == 3):
        raise ValueError(f"corrupt PNG: bit depth {depth} with colour type {ctype}")
    if interlace > 1:
        raise ValueError(f"corrupt PNG: interlace method {interlace}")
    if ctype == 3 and palette is None:
        raise ValueError("corrupt PNG: palette image without PLTE")
    ch = _PNG_TYPES[ctype][0]
    # (x0, y0, dx, dy, rows, samples a row) of each pass: Adam7's seven, or
    # the one whole image
    passes = [(x0, y0, dx, dy, (h - y0 + dy - 1) // dy, (w - x0 + dx - 1) // dx)
              for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),))]
    passes = [p for p in passes if p[4] > 0 and p[5] > 0]  # a pass may be empty
    # a row of samples below 8 bits is padded to whole bytes
    sizes = [rows * ((cols * ch * depth + 7) // 8 + 1) for *_, rows, cols in passes]
    try:
        # inflate no further than the image's filtered rows: a small stream
        # of zeros must not inflate to gigabytes
        raw = zlib.decompressobj().decompress(b"".join(idat), sum(sizes))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG: {e}") from None
    if len(raw) < sum(sizes):
        raise ValueError("truncated PNG: image data ends early")
    dtype = np.uint16 if depth == 16 else np.uint8
    px = np.empty((h, w, ch), dtype) if interlace else None
    offset = 0
    for (x0, y0, dx, dy, rows, cols), size in zip(passes, sizes):
        sub = _png_samples(raw[offset:offset + size], rows, cols, ch, depth)
        offset += size
        if not interlace:
            px = sub
        else:
            px[y0::dy, x0::dx] = sub
    if depth == 16:
        # Pillow: RGB(A) and gray + alpha keep each sample's high byte; 16-bit
        # gray opens as I;16, which convert("RGB") clips at 255
        px = np.minimum(px, 255) if ctype == 0 else px >> 8
        px = px.astype(np.uint8)
    elif depth < 8 and ctype == 0:
        px = px * np.uint8(255 // ((1 << depth) - 1))  # as libpng and Pillow scale them
    if ctype == 3:
        full = np.zeros((256, 3), np.uint8)  # indices past PLTE read black
        full[:len(palette)] = palette[:256]
        rgb = full[px[..., 0]]
    elif ch <= 2:
        rgb = np.repeat(px[..., :1], 3, axis=2)
    else:
        rgb = np.ascontiguousarray(px[..., :3])
    return _orient(rgb, orientation(exif, xmp))


_PNG_CHUNK_TYPE = re.compile(rb"\w\w\w\w")
# the keyword of an XMP packet in a PNG text chunk, with its separator
_PNG_XMP_KEY = b"XML:com.adobe.xmp\x00"


def _png_text(tag: bytes, rest: bytes) -> Optional[bytes]:
    """The text of a tEXt, zTXt or iTXt chunk after its keyword, inflated
    where compressed; None where Pillow would not read it."""
    try:
        if tag == b"tEXt":
            return rest
        if tag == b"zTXt":
            return zlib.decompress(rest[1:]) if rest[:1] == b"\x00" else None
        flag, method, rest = rest[0], rest[1], rest[2:]
        _lang, _key, text = rest.split(b"\x00", 2)
        if flag:
            return zlib.decompress(text) if method == 0 else None
        return text
    except (ValueError, IndexError, zlib.error):
        return None


# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _png_samples(raw: bytes, rows: int, cols: int, ch: int, depth: int) -> np.ndarray:
    """The filtered rows of one image (or one Adam7 pass) → (rows, cols, ch)
    samples, uint16 at 16 bits, else uint8 (sub-byte samples unscaled)."""
    rowbytes = (cols * ch * depth + 7) // 8
    out = np.empty((rows, rowbytes), np.uint8)
    err = _err()
    # the filters step by whole pixels, or by one byte below 8 bits a pixel
    bpp = max(1, ch * depth // 8)
    if library().qie_png_unfilter(raw, rows, rowbytes, bpp, out.ctypes.data, err,
                                  len(err)) != 0:
        raise ValueError(err.value.decode())
    if depth == 16:
        return out.view(">u2").astype(np.uint16).reshape(rows, cols, ch)
    if depth < 8:  # samples packed most significant bits first
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        out = ((out[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(rows, -1)[:, :cols]
    return out.reshape(rows, cols, ch)


def _decode_rgb(fmt: str, data: bytes) -> np.ndarray:
    """A format whose C decoder gives RGB at the size its info call reads."""
    lib, err = library(), _err()
    w, h = ctypes.c_int(), ctypes.c_int()
    if getattr(lib, f"qie_{fmt}_info")(data, len(data), ctypes.byref(w), ctypes.byref(h),
                                         err, len(err)) != 0:
        raise ValueError(err.value.decode())
    out = np.empty((h.value, w.value, 3), np.uint8)
    if getattr(lib, f"qie_{fmt}_decode")(data, len(data), out.ctypes.data, err, len(err)) != 0:
        raise ValueError(err.value.decode())
    return out


def _decode_webp(data: bytes) -> np.ndarray:
    lib, err = library(), _err()
    w, h = ctypes.c_int(), ctypes.c_int()
    eo, el, xo, xl = ctypes.c_long(), ctypes.c_long(), ctypes.c_long(), ctypes.c_long()
    if lib.qie_webp_info(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(eo),
                         ctypes.byref(el), ctypes.byref(xo), ctypes.byref(xl), err,
                         len(err)) != 0:
        raise ValueError(err.value.decode())
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.qie_webp_decode(data, len(data), out.ctypes.data, err, len(err)) != 0:
        raise ValueError(err.value.decode())
    exif = data[eo.value:eo.value + el.value] if eo.value >= 0 else None
    xmp = data[xo.value:xo.value + xl.value] if xo.value >= 0 else None
    return _orient(out, orientation(exif, xmp))


def decode(data: bytes) -> np.ndarray:
    """Raw JPEG, PNG, BMP, GIF or WebP bytes → (H, W, 3)
    uint8 RGB, EXIF orientation applied (the serving input convention: the
    JAX ``bytes_to_pil``)."""
    data = bytes(data)
    if data[:3] == b"\xff\xd8\xff":
        return _decode_jpeg(data)
    if data[:8] == PNG_SIGNATURE:
        return _decode_png(data)
    if data[:2] == b"BM":
        return _decode_rgb("bmp", data)
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return _decode_rgb("gif", data)
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return _decode_webp(data)
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        raise ValueError("unsupported image format: TIFF")
    raise ValueError("unsupported image format: not a JPEG, PNG, BMP, GIF or WebP file")


def decode_base64(s: str) -> np.ndarray:
    """A base64 image, a data-URL prefix stripped (``data:...;base64,``), as
    the JAX ``base64_to_pil`` takes it."""
    if "," in s:
        s = s.split(",", 1)[1]
    return decode(base64.b64decode(s))


def to_array(x) -> np.ndarray:
    """An image the engine accepts: an array passes through (binary
    transports decode at their own boundary), a string is base64-decoded."""
    if isinstance(x, np.ndarray):
        return x
    return decode_base64(x)


def encode_jpeg(arr: np.ndarray, quality: int = 90) -> bytes:
    """(H, W, 3) uint8 (or (H, W) gray) → JPEG bytes as Pillow's
    ``save(format="JPEG", quality=quality)`` writes them: 4:2:0 for three
    channels."""
    return _encode(arr, quality, 2, 2)


def _encode(arr: np.ndarray, quality: int, hs: int, vs: int) -> bytes:
    """:func:`encode_jpeg` with the luma sampled ``hs`` × ``vs`` (1 or 2 each;
    the chroma 1×1)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (
            arr.ndim == 3 and arr.shape[2] not in (1, 3)):
        raise ValueError(f"encode_jpeg takes (H, W) or (H, W, 3) uint8, got "
                         f"{arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    comps = 1 if arr.ndim == 2 else arr.shape[2]
    lib, err = library(), _err()
    cap = 4096 + ((w + 15) // 16) * ((h + 15) // 16) * 6 * 512
    out = np.empty(cap, np.uint8)
    n = lib.qie_jpeg_encode(arr.ctypes.data, w, h, comps, int(quality), hs, vs,
                            out.ctypes.data, cap, err, len(err))
    if n < 0:
        raise ValueError(err.value.decode())
    if n > cap:
        raise RuntimeError(f"encode_jpeg: {n} bytes exceed the {cap}-byte bound")
    return out[:n].tobytes()


def to_base64_jpeg(arr: np.ndarray, quality: int = 90) -> str:
    """Base64 JPEG of an array (the JAX ``pil_to_base64``, q=90)."""
    return base64.b64encode(encode_jpeg(arr, quality)).decode()
