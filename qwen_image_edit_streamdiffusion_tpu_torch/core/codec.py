"""Images in and out of the serving wire, without Pillow.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/core/imaging.py``'s
``base64_to_pil`` / ``to_pil`` / ``bytes_to_pil`` / ``pil_to_jpeg`` /
``pil_to_base64``, on (H, W, 3) uint8 arrays. The card host has no Pillow and
no cv2, so the entropy coding, the DCTs, the PNG row filters and the BMP,
GIF, WebP and TIFF decoders run in ``csrc/host/`` (``image_codec.cc``,
``bmp_gif.cc``, ``webp.cc``, ``tiff.cc``): plain C entry points loaded with
``ctypes``, built at first use with the system C++ compiler (``c++``, or
``$CXX``) into ``build/host/`` at the root of the checkout, under a name that
carries a hash of every source (as ``runtime/kernels.py`` builds the CUDA
kernels). Nothing is built when this module is imported; a missing compiler
raises when a call needs the library.

- :func:`decode` sniffs JPEG, PNG, BMP, GIF, WebP or TIFF by its magic
  bytes, applies the orientation ``ImageOps.exif_transpose`` applies (the
  EXIF tag, else an XMP packet's ``tiff:Orientation``, as Pillow's
  ``getexif`` reads them) and returns RGB: its pixels equal Pillow's
  ``convert("RGB")`` bit for bit.
  JPEG (libjpeg-turbo 3's islow IDCT, fancy upsampling and fixed-point
  colour conversion): baseline, 8-bit extended sequential and progressive,
  Huffman or arithmetic-coded (jdarith.c's QM decoder, DAC conditioning),
  8-bit lossless (predictors 1-7, the point transform, box upsampling), with
  1, 3 or 4 components, any whole-number sampling ratio (fancy upsampling at
  2, box replication above) and restart intervals; a progressive file whose
  scans stop short is block-smoothed as jdcoefct.c smooths it; Annex K's
  Huffman tables where a sequential file defines none; YCbCr, RGB-coded
  (Adobe transform 0), CMYK and YCCK (read as Pillow reads them: inverted,
  then its ``cmyk2rgb``). An arithmetic scan whose data crosses the 64 KiB
  block of the file its header ended in raises, as Pillow's decode breaks
  there (libjpeg's arithmetic decoder cannot wait for Pillow's next block).
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
  TIFF (the first page; classic or little-endian BigTIFF; strips or padded
  tiles, planar configuration 1 or 2; uncompressed as Pillow's own raw
  decoder reads it, the rest as libtiff decodes it for Pillow: PackBits,
  LZW, Deflate, LZMA, JPEG with its JPEGTables, CCITT RLE, Group 3 1-D and
  2-D, Group 4; Predictor 2, FillOrder 2): each mode of Pillow's OPEN_INFO
  but CIELab and 12-bit gray, converted as its ``convert("RGB")`` converts
  it (bilevel and 2/4-bit gray scaled, 16-bit gray clipped, float
  truncated, 16-bit colour's high byte, premultiplied alpha divided out,
  palettes' 16-bit entries' high bytes, CMYK not inverted, YCbCr through
  libtiff's RGBA reader's fixed point), the Orientation tag (else XMP's)
  applied once.
  Anything else raises a ``ValueError`` that names the format and the
  feature: 12- and 16-bit JPEG, hierarchical and arithmetic lossless JPEG,
  lossless YCbCr or YCCK, a fractional sampling ratio, TIFF compressions
  other than those above (ZSTD, old-style JPEG, ThunderScan, NeXT,
  PixarLog, SGILog, JBIG, WebP), CIELab, 12-bit gray, the floating-point
  predictor, BMP compressions and bitfield layouts Pillow does not read, a
  GIF LZW code size above 8, a WebP frame that is not a key frame, and
  other formats. So does an image above Pillow's decompression-bomb limit
  (:data:`MAX_PIXELS`), before anything of it is allocated, and a TIFF
  whose tiles are; a PNG, a TIFF strip and an LZW, prefix, LZ77, PackBits
  or CCITT stream decompress no further than their image, a TIFF tile no
  further than the tile, and data that runs out
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
import lzma
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
SOURCES = ("image_codec.cc", "bmp_gif.cc", "webp.cc", "tiff.cc")
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
        lib.qie_tiff_jpeg.argtypes = [cp, cl, cp, cl, ci, ci, ci, ci, ci, ci, ci, vp, vp, ci]
        lib.qie_tiff_jpeg.restype = ci
        lib.qie_tiff_decompress.argtypes = [ci, cp, cl, vp, cl, ci, ci, ci, ci, vp, ci]
        lib.qie_tiff_decompress.restype = ci
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
    return _orientation_value(e, *found)


def _orientation_value(e: str, typ: int, data: bytes) -> int:
    """An Orientation entry's transpose as Pillow reads the tag's first
    value: its number where that is 2..8, else 1."""
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


# ---------------------------------------------------------------------------
# TIFF: Pillow's TiffImagePlugin over libtiff (tiff.cc decompresses)
# ---------------------------------------------------------------------------

_TIFF_COMPRESSION = {1: "uncompressed", 2: "CCITT RLE", 3: "CCITT Group 3",
                     4: "CCITT Group 4", 5: "LZW", 6: "old-style JPEG", 7: "JPEG",
                     8: "Deflate", 32766: "NeXT", 32771: "16-bit padded uncompressed",
                     32773: "PackBits", 32809: "ThunderScan", 32908: "PixarFilm",
                     32909: "PixarLog", 32946: "Deflate", 34661: "JBIG", 34676: "SGILog",
                     34677: "SGILog24", 34925: "LZMA", 50000: "ZSTD", 50001: "WebP"}
_TIFF_DECODED = (1, 2, 3, 4, 5, 7, 8, 32773, 32946, 34925)
# the strip and tile fields only libtiff reads (a compressed file's)
_TIFF_LIBTIFF_ONLY = {273, 278, 279, 292, 293, 317, 322, 323, 324, 325}


def _tiff_open_info() -> dict:
    """Pillow's TiffImagePlugin.OPEN_INFO as {(byte order, photometric,
    sample format, fill order, bits, extra samples): mode}; the mode names
    how :func:`_tiff_rgb` reads the samples."""
    both = ("<", ">")
    rows = [  # photometric, sample format, fill orders, bits, extra, byte orders, mode
        (0, (1,), (1, 2), (1,), (), both, "1;I"), (1, (1,), (1, 2), (1,), (), both, "1"),
        (0, (1,), (1, 2), (2,), (), both, "L;2I"), (1, (1,), (1, 2), (2,), (), both, "L;2"),
        (0, (1,), (1, 2), (4,), (), both, "L;4I"), (1, (1,), (1, 2), (4,), (), both, "L;4"),
        (0, (1,), (1, 2), (8,), (), both, "L;I"), (1, (1,), (1, 2), (8,), (), both, "L"),
        (1, (2,), (1,), (8,), (), both, "L"), (1, (1,), (1,), (12,), (), ("<",), "I;12"),
        (0, (1,), (1,), (16,), (), ("<",), "I;16"), (1, (1,), (1,), (16,), (), both, "I;16"),
        (1, (1,), (2,), (16,), (), ("<",), "I;16"), (1, (2,), (1,), (16,), (), both, "I"),
        (0, (3,), (1,), (32,), (), both, "F"), (1, (1,), (1,), (32,), (), ("<",), "I"),
        (1, (2,), (1,), (32,), (), both, "I"), (1, (3,), (1,), (32,), (), both, "F"),
        (1, (1,), (1,), (8, 8), (2,), both, "LA"),
        (2, (1,), (1, 2), (8, 8, 8), (), both, "RGB"),
        (3, (1,), (1, 2), (1,), (), both, "P"), (3, (1,), (1, 2), (2,), (), both, "P"),
        (3, (1,), (1, 2), (4,), (), both, "P"), (3, (1,), (1, 2), (8,), (), both, "P"),
        (3, (1,), (1,), (8, 8), (0,), both, "P"), (3, (1,), (1,), (8, 8), (2,), both, "P"),
        (5, (1,), (1,), (8,) * 4, (), both, "CMYK"),
        (5, (1,), (1,), (8,) * 5, (0,), both, "CMYK"),
        (5, (1,), (1,), (8,) * 6, (0, 0), both, "CMYK"),
        (5, (1,), (1,), (16,) * 4, (), both, "CMYK"),
        (6, (1,), (1,), (8,), (), both, "L"), (6, (1,), (1,), (8, 8, 8), (), both, "YCbCr"),
        (8, (1,), (1,), (8, 8, 8), (), both, "LAB"),
    ]
    for bits in (8, 16):
        for extra, mode in (((), "RGBA"), ((0,), "RGB"), ((1,), "RGBa"), ((2,), "RGBA")):
            rows.append((2, (1,), (1,), (bits,) * 4, extra, both, mode))
        rows.append((2, (1,), (1,), (16,) * 3, (), both, "RGB"))
    for extra, mode in (((0, 0), "RGB"), ((0, 0, 0), "RGB"), ((1, 0), "RGBa"),
                        ((1, 0, 0), "RGBa"), ((2, 0), "RGBA"), ((2, 0, 0), "RGBA"),
                        ((999,), "RGBA")):
        rows.append((2, (1,), (1,), (8,) * (3 + len(extra)), extra, both, mode))
    return {(e, photo, sf, fill, bits, extra): mode
            for photo, sf, fills, bits, extra, orders, mode in rows
            for e in orders for fill in fills}


_TIFF_OPEN = _tiff_open_info()


def _tiff_ifd(data: bytes):
    """(byte order, {tag: (type, values, raw bytes)}) of a TIFF's first
    directory, classic or BigTIFF, as Pillow's ImageFileDirectory_v2 loads
    it: values a tuple of numbers ((numerator, denominator) pairs for the
    rationals), or the bytes of a BYTE, ASCII or UNDEFINED field; an entry
    of an unknown type is skipped, and one whose data lies past the file
    ends the directory."""
    e = "<" if data[:2] == b"II" else ">"
    big = data[2] == 0x2B  # Pillow reads a big-endian BigTIFF header as classic
    head = 16 if big else 8
    if len(data) < head:
        raise ValueError("truncated TIFF: the header ends early")
    if big:
        size, zero, pos = struct.unpack_from(e + "HHQ", data, 4)
        if size != 8 or zero != 0:
            raise ValueError("corrupt TIFF: bad BigTIFF header")
    else:
        (pos,) = struct.unpack_from(e + "L", data, 4)
    count_fmt, entry_fmt, inline = ("Q", "HHQ", 8) if big else ("H", "HHL", 4)
    entry_size = struct.calcsize(e + entry_fmt) + inline
    if pos + struct.calcsize(e + count_fmt) > len(data):
        raise ValueError("truncated TIFF: the image directory lies past the end of the file")
    (count,) = struct.unpack_from(e + count_fmt, data, pos)
    pos += struct.calcsize(e + count_fmt)
    tags = {}
    for _ in range(count):
        if pos + entry_size > len(data):
            break
        tag, typ, n = struct.unpack_from(e + entry_fmt, data, pos)
        field = data[pos + entry_size - inline:pos + entry_size]
        pos += entry_size
        if typ not in _TIFF_TYPES:
            continue
        unit, code = _TIFF_TYPES[typ]
        size = n * unit
        if size > inline:
            (off,) = struct.unpack(e + ("Q" if big else "L"), field)
            if off + size > len(data):
                break
            raw = data[off:off + size]
        else:
            raw = field[:size]
        if code is None:
            vals = raw
        elif unit == 8 and code in "Ll":
            flat = struct.unpack(e + code * (2 * n), raw)
            vals = tuple(zip(flat[::2], flat[1::2]))
        else:
            vals = struct.unpack(e + code * n, raw)
        tags[tag] = (typ, vals, raw)
    return e, tags


class _Tiff:
    """The fields of a TIFF's first directory that its decode reads, with
    TiffImageFile._setup's defaults and normalisations."""

    def __init__(self, data: bytes):
        self.data = data
        self.e, self.tags = _tiff_ifd(data)
        self.comp = self.scalar(259, 1)
        self.photo, self.fill = self.scalar(262, 0), self.scalar(266, 1)
        self.w, self.h = self.scalar(256), self.scalar(257)
        sf = self.seq(339, (1,))
        self.sample_format = (1,) if len(sf) > 1 and max(sf) == min(sf) == 1 else sf
        bps, self.extra = self.seq(258, (1,)), self.seq(338, ())
        self.spp = self.scalar(277, 1)
        if self.spp > 6:
            raise ValueError(f"corrupt TIFF: {self.spp} samples a pixel")
        if self.spp < len(bps):
            bps = bps[:self.spp]
        elif self.spp > len(bps) == 1:
            bps = bps * self.spp
        if len(bps) != self.spp:
            raise ValueError("corrupt TIFF: BitsPerSample does not match SamplesPerPixel")
        self.bps = bps
        self.planar = self.scalar(284, 1)
        self.predictor = self.scalar(317, 1)
        self.tiled = 322 in self.tags or 324 in self.tags

    def seq(self, tag, default=(), rational: bool = False):
        """The tag's values: integers, or (numerator, denominator) pairs
        where ``rational``; anything else is a corrupt field."""
        if tag not in self.tags:
            return default
        typ, vals, _ = self.tags[tag]
        if isinstance(vals, bytes):
            # libtiff reads a BYTE field of the strip layout as numbers; in
            # the fields Pillow reads itself its one bytes value fails
            if typ == 1 and tag in _TIFF_LIBTIFF_ONLY:
                return tuple(vals)
            raise ValueError(f"corrupt TIFF: tag {tag} holds bytes, not numbers")
        if not all(isinstance(v, tuple if rational else int) for v in vals):
            raise ValueError(f"corrupt TIFF: tag {tag} holds values of type {typ}")
        return tuple(vals)

    def scalar(self, tag, default=None):
        """The tag's first value, as Pillow keeps a tag of one value."""
        vals = self.seq(tag, None)
        if vals is None:
            return default
        if not vals:
            raise ValueError(f"corrupt TIFF: tag {tag} holds no value")
        return vals[0]

    def layout(self):
        """(chunk width, chunk rows, chunks across, chunks down, planes,
        offsets, byte counts) of the strips or tiles."""
        if self.tiled:
            tw, th = self.scalar(322), self.scalar(323)
            if not tw or not th:
                raise ValueError("corrupt TIFF: bad TileWidth or TileLength")
            offsets, counts = self.seq(324), self.seq(325)
        else:
            rps = self.scalar(278, 2 ** 32 - 1)
            if rps == 0:  # Pillow's raw tiles and libtiff both refuse it
                raise ValueError("corrupt TIFF: RowsPerStrip 0")
            tw, th = self.w, min(rps, self.h)
            offsets, counts = self.seq(273), self.seq(279)
        planes = self.spp if self.planar == 2 else 1
        return tw, th, -(-self.w // tw), -(-self.h // th), planes, offsets, counts


def _decode_tiff(data: bytes) -> np.ndarray:
    """The first image of a TIFF as Pillow's ``Image.open`` → ``exif_transpose``
    → ``convert("RGB")`` gives it: the mode of TiffImagePlugin's OPEN_INFO,
    an uncompressed file's strips or tiles read as Pillow's raw decoder reads
    them and a compressed one's as libtiff gives them to Pillow, then the
    Orientation tag (else XMP's) applied once."""
    t = _Tiff(data)
    if t.comp not in _TIFF_DECODED:
        name = _TIFF_COMPRESSION.get(t.comp, "unknown")
        raise ValueError(f"unsupported TIFF: {name} compression ({t.comp})")
    if t.w is None or t.h is None:
        raise ValueError("corrupt TIFF: no ImageWidth or ImageLength")
    mode = _TIFF_OPEN.get((t.e, t.photo, t.sample_format, t.fill, t.bps, t.extra))
    if mode is None:
        raise ValueError(f"unsupported TIFF: photometric {t.photo} with {t.spp} samples of "
                         f"{t.bps} bits (sample format {t.sample_format}, extra samples "
                         f"{t.extra}, fill order {t.fill}): Pillow has no mode for it")
    if mode == "LAB":
        raise ValueError("unsupported TIFF: CIELab (Pillow converts it to RGB through LittleCMS)")
    if mode == "I;12":
        raise ValueError("unsupported TIFF: 12-bit gray")
    if t.w <= 0 or t.h <= 0:
        raise ValueError("corrupt TIFF: zero width or height")
    if t.w * t.h > MAX_PIXELS:
        raise ValueError(f"unsupported TIFF: {t.w}x{t.h} pixels exceed the "
                         f"decompression-bomb limit")
    if t.planar not in (1, 2):
        raise ValueError(f"corrupt TIFF: PlanarConfiguration {t.planar}")
    tag = t.tags.get(274)
    orient = _orientation_value(t.e, tag[0], tag[2]) if tag else None
    if orient is None:
        xmp = t.tags.get(700)
        orient = orientation(None, xmp[1] if xmp and isinstance(xmp[1], bytes) else None)
    if t.comp == 1:
        px = _tiff_raw(t, mode)
    else:
        px, mode = _tiff_coded(t, mode, orient)
    return _orient(_tiff_rgb(t, px, mode), orient)


def _tiff_raw(t: _Tiff, mode: str) -> np.ndarray:
    """An uncompressed TIFF as Pillow's own raw decoder reads it: each strip
    or tile from its offset, its byte count unread, rows of the bits its raw
    mode takes (bits reversed at FillOrder 2), Predictor not applied. So a
    YCbCr file reads as RGBX (past its strip, into what follows it) and a
    planar one a byte a sample, as Pillow reads them."""
    tw, th, across, down, planes, offsets, _ = t.layout()
    if mode == "RGBa" and t.planar == 2:
        raise ValueError("unsupported TIFF: uncompressed planar premultiplied alpha (Pillow "
                         "has no raw mode for its alpha band)")
    if tw == t.w and th == t.h and t.planar == 1:
        offsets = offsets[-1:]  # one chunk covers the image: Pillow reads the last offset
    if t.photo == 6 and t.spp == 3:
        bits = 32  # the raw mode RGBX
    elif t.planar == 2:
        bits = 8   # a band of the raw mode: one character, 8 bits
    else:
        bits = sum(t.bps)
    if len(offsets) < planes * across * down:
        raise ValueError(f"corrupt TIFF: {len(offsets)} strip or tile offsets, "
                         f"{planes * across * down} needed")
    out, k = [], 0
    for _ in range(planes):
        plane = np.zeros((t.h, (t.w * bits + 7) // 8), np.uint8)
        for ty in range(down):
            for tx in range(across):
                x0, y0 = tx * tw, ty * th
                x1, y1 = min(x0 + tw, t.w), min(y0 + th, t.h)
                # an edge tile's rows keep the tile's width
                stride = ((tw if x0 + tw > t.w else x1 - x0) * bits + 7) // 8
                off = offsets[k]
                k += 1
                chunk = t.data[off:off + stride * (y1 - y0)]
                if len(chunk) < stride * (y1 - y0):
                    raise ValueError("truncated TIFF: image data ends early")
                if t.fill == 2:  # the raw modes ";R": each byte's bits reversed
                    chunk = chunk.translate(_REVERSED_BITS)
                nb = ((x1 - x0) * bits + 7) // 8
                xb = x0 * bits // 8
                plane[y0:y1, xb:xb + nb] = np.frombuffer(chunk, np.uint8).reshape(
                    y1 - y0, stride)[:, :nb]
        out.append(plane)
    if bits == 32 and t.photo == 6:
        return out[0].reshape(t.h, t.w, 4)[..., :3]
    if t.planar == 2:
        return np.stack(out, -1)
    return _tiff_unpack(out[0], t.w, t.bps[0], t.spp, t.e, t.sample_format)


def _tiff_unpack(rows: np.ndarray, w: int, bits: int, spp: int, e: str, sample_format):
    """Rows of packed samples (H, rowbytes) → (H, W, spp) values: below 8
    bits unpacked most significant bits first, 16 and 32 bits in the file's
    byte order, signed or float by the sample format."""
    h = rows.shape[0]
    if bits < 8:
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        v = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(h, -1)[:, :w * spp]
        return v.reshape(h, w, spp)
    n = bits // 8
    if n == 1:
        return rows[:, :w * spp].reshape(h, w, spp)
    kind = {2: "i", 3: "f"}.get(sample_format[0], "u")
    dt = np.dtype(e + kind + str(n))
    return rows[:, :w * spp * n].copy().view(dt).reshape(h, w, spp)


def _tiff_coded(t: _Tiff, mode: str, orient: int):
    """A compressed TIFF's samples as libtiff gives them to Pillow: each
    strip or tile decompressed to exactly its bytes, Predictor 2 undone, the
    chunks assembled; JPEG strips decoded (YCbCr to RGB, as Pillow asks
    libtiff for JPEGCOLORMODE_RGB), other YCbCr through libtiff's RGBA
    reader. Returns (samples, mode)."""
    tw, th, across, down, planes, offsets, counts = t.layout()
    rps = t.scalar(278, 2 ** 32 - 1)
    if not t.tiled and 2 ** 31 <= rps < 2 ** 32 - 1:
        # Pillow's strip decoder refuses it (decoder error -9), and above
        # 2**32 - 1 - ImageLength libtiff counts no strips
        raise ValueError(f"corrupt TIFF: RowsPerStrip {rps}")
    if t.tiled and tw * th > MAX_PIXELS:
        # a tile is decompressed whole, however little of it the image shows;
        # at 8 bytes a pixel at most, this also keeps it under the 2**31 - 1
        # bytes that Pillow's libtiff decoder takes
        raise ValueError(f"unsupported TIFF: {tw}x{th} tiles exceed the "
                         f"decompression-bomb limit")
    need = planes * across * down
    if len(offsets) < need or len(counts) < need:
        raise ValueError(f"corrupt TIFF: {min(len(offsets), len(counts))} strips or tiles "
                         f"listed, {need} needed")
    if len(set(t.bps)) != 1:
        raise ValueError(f"unsupported TIFF: samples of different depths {t.bps}")
    b = t.bps[0]
    if t.predictor not in (1, 2):
        name = "floating-point" if t.predictor == 3 else "unknown"
        raise ValueError(f"unsupported TIFF: {name} predictor ({t.predictor})")
    if t.predictor == 2 and b not in (8, 16, 32):
        raise ValueError(f"corrupt TIFF: Predictor 2 with {b}-bit samples")
    per = 1 if t.planar == 2 else t.spp
    if t.planar == 2 and 0 in t.extra:
        raise ValueError("unsupported TIFF: planar with an unused extra sample (Pillow's "
                         "libtiff decoder fails on it)")
    if t.planar == 2 and mode == "RGBA" and not t.extra:
        mode = "RGBa"  # Pillow reads planar RGBA without ExtraSamples as premultiplied
    jpeg = t.comp == 7
    ycbcr = t.photo == 6 and not jpeg
    if t.photo == 6 and t.spp != 3:
        raise ValueError("unsupported TIFF: YCbCr of one sample (libtiff's RGBA reader takes "
                         "three)")
    sub = tuple(t.seq(530, (2, 2))[:2]) if t.photo == 6 else (1, 1)
    if ycbcr:
        if t.planar != 1 or b != 8:
            raise ValueError("unsupported TIFF: YCbCr (not JPEG) that is planar or not 8-bit")
        if tuple(sub) not in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2), (4, 4)):
            raise ValueError(f"unsupported TIFF: YCbCr subsampling {tuple(sub)}")
        if orient != 1:
            raise ValueError("unsupported TIFF: YCbCr (not JPEG) with an Orientation other than "
                             "1 (libtiff's RGBA reader flips it block by block)")
        block_rows = th if t.tiled or rps == 2 ** 32 - 1 else rps
        if block_rows > (2 ** 31 - 1) // 4 // t.w:
            # Pillow's RGBA decoder sizes its buffer by the unclamped rows
            raise ValueError(f"corrupt TIFF: YCbCr (not JPEG) in blocks of {block_rows} rows "
                             f"{t.w} pixels wide (Pillow's RGBA decoder takes 2**31 - 1 bytes)")
        ycc = _YCbCr(t)
    tables = None
    if jpeg:
        if t.planar != 1 or t.photo not in (0, 1, 2, 6) or b != 8:
            raise ValueError(f"unsupported TIFF: JPEG with photometric {t.photo}, planar "
                             f"configuration {t.planar} and {b}-bit samples")
        if 347 in t.tags:
            tables = t.tags[347][2]
    if t.photo == 3 and b < 8 and len(t.seq(320)) != 3 << b:
        # libtiff ignores a ColorMap of the wrong size, and then misses it
        raise ValueError(f"corrupt TIFF: a ColorMap of {len(t.seq(320))} values for "
                         f"{b}-bit palette samples")
    t4 = t.scalar(292 if t.comp == 3 else 293, 0) if t.comp in (3, 4) else 0
    lib, err = library(), _err()
    dtype = np.uint8 if b <= 8 else np.dtype("=u" + str(b // 8))
    out = np.empty((t.h, t.w, 3 if ycbcr else t.spp), dtype)
    k = 0
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                x0, y0 = tx * tw, ty * th
                rows = th if t.tiled else min(th, t.h - y0)
                off, cnt = offsets[k], counts[k]
                k += 1
                raw = t.data[off:off + cnt]
                if cnt == 0:
                    raise ValueError("corrupt TIFF: a strip or tile of 0 bytes")
                if len(raw) < cnt:
                    raise ValueError("truncated TIFF: a strip or tile lies past the end of "
                                     "the file")
                if jpeg:
                    last = not t.tiled and y0 + rows >= t.h
                    block = _tiff_jpeg_chunk(lib, err, raw, tables, tw, rows, last, t, sub)
                elif ycbcr:
                    hs, vs = sub
                    if -(-tw // hs) * (hs * vs + 2) % vs:
                        # TIFFScanlineSize rounds down: the RGBA reader reads the
                        # strip short and converts bytes it never read
                        raise ValueError(f"unsupported TIFF: YCbCr subsampled {hs}x{vs} at "
                                         f"width {tw} (libtiff's RGBA reader reads it short)")
                    size = -(-rows // vs) * -(-tw // hs) * (hs * vs + 2)
                    block = ycc.rgb(_tiff_decompress(lib, err, t, raw, size, tw, t4, True), tw,
                                    rows, hs, vs, min(tw, t.w - x0), min(rows, t.h - y0))
                else:
                    rowbytes = (tw * per * b + 7) // 8
                    dec = _tiff_decompress(lib, err, t, raw, rows * rowbytes, tw, t4).reshape(
                        rows, rowbytes)
                    if t.predictor == 2:
                        dec = _tiff_accumulate(dec, tw, per, b, t.e)
                    block = _tiff_unpack(dec, tw, b, per, t.e, (1,))
                x1, y1 = min(x0 + tw, t.w), min(y0 + rows, t.h)
                if t.planar == 2:
                    out[y0:y1, x0:x1, p] = block[:y1 - y0, :x1 - x0, 0]
                else:
                    out[y0:y1, x0:x1] = block[:y1 - y0, :x1 - x0]
    if b == 32:  # the words as the sample format reads them
        out = out.view(np.dtype({2: "=i4", 3: "=f4"}.get(t.sample_format[0], "=u4")))
    if ycbcr or (jpeg and t.photo == 6):
        mode = "RGB"
    return out, mode


def _tiff_decompress(lib, err, t: _Tiff, raw: bytes, size: int, width: int, t4: int,
                     tolerant: bool = False) -> np.ndarray:
    """One strip or tile decompressed to exactly ``size`` bytes (uint8):
    Deflate and LZMA here (bounded to ``size``), the rest in tiff.cc.
    FillOrder 2 reverses the bits of every byte first, as TIFFFillStrip does.
    ``tolerant``: an LZW or PackBits error keeps what was decoded before it,
    zeros after (libtiff's RGBA reader); the zeros are pages no one touches
    until they are read."""
    comp = t.comp
    if comp in (8, 32946, 34925):
        if t.fill == 2:
            raw = raw.translate(_REVERSED_BITS)
        try:
            # a dictionary above 256 MiB is refused, not allocated
            d = lzma.LZMADecompressor(memlimit=_LZMA_MEMLIMIT) if comp == 34925 else \
                zlib.decompressobj()
            out = d.decompress(raw, size)
        except (zlib.error, lzma.LZMAError) as ex:
            raise ValueError(f"corrupt TIFF: {_TIFF_COMPRESSION[comp]} data: {ex}") from None
        if len(out) < size:
            raise ValueError(f"truncated TIFF: {_TIFF_COMPRESSION[comp]} data ends short of "
                             f"its strip")
        return np.frombuffer(out, np.uint8)
    buf = (np.zeros if tolerant else np.empty)(size, np.uint8)
    if lib.qie_tiff_decompress(comp, raw, len(raw), buf.ctypes.data, size, width, t4, t.fill,
                               int(tolerant), err, len(err)) < 0:
        raise ValueError(err.value.decode())
    return buf


_REVERSED_BITS = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
_LZMA_MEMLIMIT = 256 << 20


def _tiff_accumulate(rows: np.ndarray, w: int, spp: int, bits: int, e: str) -> np.ndarray:
    """Undo horizontal differencing (Predictor 2): each sample plus the one a
    pixel to its left, wrapping at the sample's width, as tif_predict.c's
    horAcc8/16/32 do on native values; back in the file's byte order."""
    n = bits // 8
    dt = np.dtype(e + "u" + str(n))
    native = dt.newbyteorder("=")
    v = rows[:, :w * spp * n].copy().view(dt).reshape(rows.shape[0], w, spp)
    acc = np.cumsum(v.astype(native), axis=1, dtype=native)
    out = rows.copy()
    out[:, :w * spp * n] = acc.astype(dt).view(np.uint8).reshape(rows.shape[0], -1)
    return out


def _tiff_jpeg_chunk(lib, err, raw: bytes, tables, width: int, rows: int, last: bool,
                     t: _Tiff, sub) -> np.ndarray:
    """One JPEG strip or tile as libtiff's tif_jpeg.c decodes it for Pillow:
    the JPEGTables stream read first, the strip's own stream ending in a
    fake EOI (libtiff's source manager supplies one where the data runs
    out), libtiff's checks of the components and sampling factors, a last
    strip's taller frame cut to the strip; YCbCr converted to RGB
    (JPEGCOLORMODE_RGB), other photometrics left as their components."""
    c = 1 if t.spp == 1 else 3
    out = np.empty((rows, width, c), np.uint8)
    eoi = b"\xff\xd9" * 256  # what libtiff's source manager supplies past the data
    tables = tables + eoi if tables else b""
    hs, vs = sub
    data = raw + eoi
    if lib.qie_tiff_jpeg(tables, len(tables), data, len(data), int(t.photo == 6), hs, vs,
                         t.spp, width, rows, int(last), out.ctypes.data, err, len(err)) != 0:
        msg = err.value.decode()
        raise ValueError(msg if msg.startswith(("corrupt TIFF", "unsupported TIFF"))
                         else "corrupt TIFF: JPEG strip: " + msg)
    return out


class _YCbCr:
    """libtiff's TIFFYCbCrToRGB (tif_color.c) as tif_getimage.c applies it:
    tables from YCbCrCoefficients and ReferenceBlackWhite in float32 and
    16-bit fixed point, each subsampling block's one Cb and Cr on each of its
    luma samples (no interpolation)."""

    def __init__(self, t: _Tiff):
        f32 = np.float32
        luma = [f32(n / d) if d else f32(0) for n, d in t.seq(
            529, ((299, 1000), (587, 1000), (114, 1000)), rational=True)][:3]
        ref = [f32(n / d) if d else f32(0) for n, d in t.seq(
            532, ((0, 1), (255, 1), (128, 1), (255, 1), (128, 1), (255, 1)), rational=True)][:6]
        if len(luma) < 3 or len(ref) < 6 or not luma[1]:
            raise ValueError("corrupt TIFF: bad YCbCrCoefficients or ReferenceBlackWhite")

        def fix(x):
            return int(np.float64(f32(min(max(x, f32(0)), f32(2))) * f32(65536)) + 0.5)

        lr, lg, lb = luma
        f1 = f32(2) - f32(2) * lr
        d1, d2 = fix(f1), -fix(lr * f1 / lg)
        f3 = f32(2) - f32(2) * lb
        d3, d4 = fix(f3), -fix(lb * f3 / lg)

        def code2v(c, rb, rw, cr):
            den = rw - rb
            v = f32(f32(c - int(rb)) * f32(cr)) / (den if den != 0 else f32(1))
            return int(min(max(v, f32(-4096)), f32(4096)))

        x = range(-128, 128)
        cr = np.array([code2v(i, ref[4] - f32(128), ref[5] - f32(128), 127) for i in x], np.int64)
        cb = np.array([code2v(i, ref[2] - f32(128), ref[3] - f32(128), 127) for i in x], np.int64)
        self.y = np.array([code2v(i + 128, ref[0], ref[1], 255) for i in x], np.int64)
        self.cr_r = (d1 * cr + (1 << 15)) >> 16
        self.cb_b = (d3 * cb + (1 << 15)) >> 16
        self.cr_g = d2 * cr
        self.cb_g = d4 * cb + (1 << 15)

    def rgb(self, units: np.ndarray, width: int, rows: int, hs: int, vs: int, w: int,
            h: int) -> np.ndarray:
        """Data units (hs * vs luma samples, Cb, Cr) of a ``width`` x ``rows``
        strip or tile → RGB of its top left ``w`` x ``h`` pixels, (h, w, 3)."""
        bw, bh = -(-width // hs), -(-rows // vs)
        u = units.reshape(bh, bw, hs * vs + 2)[:-(-h // vs), :-(-w // hs)].astype(np.int64)
        bh, bw = u.shape[:2]
        y = u[..., :hs * vs].reshape(bh, bw, vs, hs).transpose(0, 2, 1, 3).reshape(
            bh * vs, bw * hs)[:h, :w]
        cb = np.repeat(np.repeat(u[..., -2], vs, 0), hs, 1)[:h, :w]
        cr = np.repeat(np.repeat(u[..., -1], vs, 0), hs, 1)[:h, :w]
        yy = self.y[y]
        r = yy + self.cr_r[cr]
        g = yy + ((self.cb_g[cb] + self.cr_g[cr]) >> 16)
        b = yy + self.cb_b[cb]
        return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _tiff_rgb(t: _Tiff, px: np.ndarray, mode: str) -> np.ndarray:
    """Samples in a Pillow mode → its ``convert("RGB")``."""
    if mode in ("1", "1;I"):
        v = (px[..., 0] != 0) if mode == "1" else (px[..., 0] == 0)
        gray = v.astype(np.uint8) * 255
    elif mode.startswith("L;") and mode[2].isdigit():
        bits = int(mode[2])
        v = px[..., 0].astype(np.uint16)
        scale = 255 // ((1 << bits) - 1)
        gray = ((((1 << bits) - 1) - v) if mode.endswith("I") else v) * scale
    elif mode in ("L", "L;I", "LA"):
        gray = 255 - px[..., 0] if mode == "L;I" else px[..., 0]
    elif mode in ("I;16", "I"):
        v = px[..., 0]
        if v.dtype.kind == "u" and v.dtype.itemsize == 4:  # mode I is signed ("I;32N" too)
            v = v.astype(np.uint32).view(np.int32)
        gray = np.clip(v.astype(np.int64), 0, 255)
    elif mode == "F":
        f = px[..., 0].astype(np.float32)
        gray = np.where(f <= 0, 0, np.where(f >= 255, 255, np.nan_to_num(f, nan=0.0)))
        gray = gray.astype(np.float32).astype(np.int64)  # Pillow truncates
    elif mode == "P":
        cmap = np.asarray(t.seq(320), np.int64) // 256
        n = len(cmap) // 3
        pal = np.zeros((256, 3), np.uint8)
        pal[:min(n, 256)] = np.stack([cmap[:n], cmap[n:2 * n], cmap[2 * n:3 * n]], -1)[:256]
        return np.ascontiguousarray(pal[px[..., 0].astype(np.int64) & 255])
    else:
        v = px.astype(np.int64)
        if px.dtype.itemsize == 2:  # 16-bit RGB(A) and CMYK: the high byte
            v = v >> 8
        if mode == "RGBa":  # premultiplied: divided by alpha, as Pillow's unpacker
            a = v[..., 3:4]
            v = np.where(a == 0, 0, np.minimum(v[..., :3] * 255 // np.maximum(a, 1), 255))
        elif mode == "CMYK":  # cmyk2rgb, not inverted
            nk = 255 - v[..., 3:4]
            t_ = v[..., :3] * nk + 128
            v = nk - (((t_ >> 8) + t_) >> 8)
        return np.ascontiguousarray(np.clip(v[..., :3], 0, 255).astype(np.uint8))
    return np.repeat(np.asarray(gray, np.uint8)[..., None], 3, axis=2)


def decode(data: bytes) -> np.ndarray:
    """Raw JPEG, PNG, BMP, GIF, WebP or TIFF bytes → (H, W, 3)
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
    if data[:4] in _TIFF_PREFIXES:
        return _decode_tiff(data)
    raise ValueError("unsupported image format: not a JPEG, PNG, BMP, GIF, WebP or TIFF file")


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
