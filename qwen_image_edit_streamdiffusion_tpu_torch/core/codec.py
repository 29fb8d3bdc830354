"""JPEG and PNG in and out of the serving wire, without Pillow.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/core/imaging.py``'s
``base64_to_pil`` / ``to_pil`` / ``bytes_to_pil`` / ``pil_to_jpeg`` /
``pil_to_base64``, on (H, W, 3) uint8 arrays. The card host has no Pillow and
no cv2, so the entropy coding, the DCTs and the PNG row filters run in
``csrc/host/image_codec.cc``: plain C entry points loaded with ``ctypes``,
built at first use with the system C++ compiler (``c++``, or ``$CXX``) into
``build/host/`` at the root of the checkout, under a name that carries a hash
of the source (as ``runtime/kernels.py`` builds the CUDA kernels). Nothing is
built when this module is imported; a missing compiler raises when a call
needs the library.

- :func:`decode` sniffs JPEG or PNG by its magic bytes, applies the EXIF
  orientation as ``ImageOps.exif_transpose`` does and returns RGB: its
  pixels equal Pillow's (libjpeg-turbo's islow IDCT, fancy upsampling and
  fixed-point YCbCr→RGB) bit for bit. It takes baseline, 8-bit extended
  sequential and progressive Huffman JPEG with 1 or 3 components, any
  whole-number sampling ratio (fancy upsampling at 2, box replication
  above) and restart intervals; and PNG, Adam7-interlaced or not, of every
  colour type at every depth it allows: gray at 1, 2 and 4 bits (scaled
  ×255, ×85, ×17, as libpng and Pillow scale them), palette at 1 to 8 bits,
  and 16-bit samples as Pillow's ``convert("RGB")`` gives them (RGB, RGBA and
  gray + alpha keep the high byte; 16-bit gray, Pillow's I;16, is clipped at
  255); alpha and ``tRNS`` dropped as ``convert("RGB")`` drops them.
  Anything else raises a ``ValueError`` that names the feature:
  arithmetic-coded, lossless, hierarchical, 12-bit, CMYK/YCCK and RGB-coded
  JPEG, a fractional sampling ratio, a progressive file whose scans leave
  coefficients that libjpeg-turbo would block-smooth, and other formats
  (WebP, GIF, BMP, TIFF). So does an image above Pillow's decompression-bomb
  limit (:data:`MAX_PIXELS`), before anything of it is allocated; a PNG
  inflates no further than its rows, and a JPEG scan stops where its data
  runs out (truncated), as does a progressive file without its EOI.
- :func:`encode_jpeg` writes what Pillow's ``save(format="JPEG",
  quality=q)`` writes (JFIF, the scaled Annex K tables, 4:2:0, standard
  Huffman tables), so Pillow decodes the two files to the same pixels.
"""

from __future__ import annotations

import base64
import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "host" / "image_codec.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

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
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libqie_codec_{h.hexdigest()[:16]}.so"


def library() -> ctypes.CDLL:
    """The loaded codec library, built first if this checkout has none."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp.so")
            proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"building the image codec failed:\n{proc.stderr}")
            os.replace(tmp, path)
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
        _lib = lib
        return lib


def _err() -> ctypes.Array:
    return ctypes.create_string_buffer(256)


def exif_orientation(tiff: bytes) -> int:
    """The orientation tag (0x0112) of a TIFF-structured EXIF block's IFD0,
    1 when absent or unreadable."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    (ifd,) = struct.unpack_from(e + "I", tiff, 4)
    if ifd + 2 > len(tiff):
        return 1
    (count,) = struct.unpack_from(e + "H", tiff, ifd)
    for i in range(count):
        off = ifd + 2 + 12 * i
        if off + 12 > len(tiff):
            break
        tag, typ = struct.unpack_from(e + "HH", tiff, off)
        if tag == 0x0112:
            if typ == 3:
                return struct.unpack_from(e + "H", tiff, off + 8)[0]
            if typ == 4:
                return struct.unpack_from(e + "I", tiff, off + 8)[0]
            return 1
    return 1


def _orient(arr: np.ndarray, tiff: Optional[bytes]) -> np.ndarray:
    fix = _ORIENT.get(exif_orientation(tiff)) if tiff else None
    return np.ascontiguousarray(fix(arr)) if fix else arr


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
    tiff = data[off.value:off.value + ln.value] if off.value >= 0 else None
    return _orient(out, tiff)


# PNG colour type → (channels, name)
_PNG_TYPES = {0: (1, "gray"), 2: (3, "RGB"), 3: (1, "palette"), 4: (2, "gray+alpha"),
              6: (4, "RGBA")}


def _decode_png(data: bytes) -> np.ndarray:
    pos, idat, palette, exif, hdr = 8, [], None, None, None
    while pos + 8 <= len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if len(body) < n:
            raise ValueError("truncated PNG: a chunk ends early")
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
    return _orient(rgb, exif)


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


def decode(data: bytes) -> np.ndarray:
    """Raw JPEG or PNG bytes → (H, W, 3) uint8 RGB, EXIF orientation
    applied (the serving input convention: the JAX ``bytes_to_pil``)."""
    data = bytes(data)
    if data[:3] == b"\xff\xd8\xff":
        return _decode_jpeg(data)
    if data[:8] == PNG_SIGNATURE:
        return _decode_png(data)
    raise ValueError("unsupported image format: not a JPEG or PNG file")


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
