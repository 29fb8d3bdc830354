"""Images in and out of the serving wire, without Pillow.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/core/imaging.py``'s
``base64_to_pil`` / ``to_pil`` / ``bytes_to_pil`` / ``pil_to_jpeg`` /
``pil_to_base64``, on (H, W, 3) uint8 arrays. The card host has no Pillow and
no cv2, so the entropy coding, the DCTs, the PNG row filters, the BMP, GIF,
WebP and TIFF decoders, the run-length codings of the plain raster
formats, the DDS blocks, JPEG 2000's tiles, FLI frames, PhotoCD's base
image, the CIELab to sRGB conversion and AV1 key frames run in
``csrc/host/`` (``image_codec.cc``, ``bmp_gif.cc``, ``webp.cc``,
``tiff.cc``, ``raster.cc``, ``bcn.cc``, ``jpeg2000.cc``, ``fli_pcd.cc``,
``lab_srgb.cc``, ``av1.cc`` with its tables in ``av1_tables.h``): plain C
entry points loaded with ``ctypes``, built at first use with the system C++
compiler (``c++``, or ``$CXX``) into ``build/host/`` at the root of the
checkout, under a name that carries a hash of every source (as
``runtime/kernels.py`` builds the CUDA kernels). Nothing is built when this module is imported; a missing compiler
raises when a call needs the library.

- :func:`decode` finds the format as ``Image.open`` finds it: Pillow's
  plugins in ``Image.ID``'s order (BMP, DIB, GIF, JPEG, PPM, PNG, then the
  rest as ``Image.init`` registers them, TGA, which has no ``_accept``,
  near the end), each ``_accept`` on the first 16 bytes, and where a
  plugin's ``_open`` fails as ``Image.open`` passes over (SyntaxError,
  IndexError, TypeError, KeyError, EOFError, struct.error, no pixels) the
  next plugin; a format Pillow opens and the port does not decode raises
  naming it and goes no further. It applies the orientation
  ``ImageOps.exif_transpose`` applies (the EXIF tag, else an XMP packet's
  ``tiff:Orientation``, as Pillow's ``getexif`` reads them) and returns
  RGB: its pixels equal Pillow's ``convert("RGB")`` bit for bit.
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
  LZW, Deflate, LZMA, ZSTD (through the host's libzstd), JPEG with its
  JPEGTables, CCITT RLE, RLEW (its rows aligned as libtiff aligns them),
  Group 3 1-D and 2-D, Group 4, ThunderScan; Predictor 2 and the
  floating-point Predictor 3, FillOrder 2): each mode of Pillow's OPEN_INFO,
  converted as its ``convert("RGB")`` converts it (bilevel and
  2/4-bit gray scaled, 12- and 16-bit gray clipped, float truncated, 16-bit
  colour's high byte, premultiplied alpha divided out, palettes' 16-bit
  entries' high bytes, CMYK not inverted, YCbCr through libtiff's RGBA
  reader's fixed point, at any Orientation, 4x4-subsampled strips read
  short where libtiff reads them short; 8-bit CIELab with a and b signed in
  a chunky file and taken as they are from planes, then converted as
  LittleCMS 2.17 converts Pillow's LAB images (:func:`lab_to_rgb`);
  big-endian signed and float samples of a compressed file byte-swapped,
  as Pillow reads libtiff's native ones), the Orientation tag (else XMP's)
  applied once. A damaged TIFF decodes, or raises, as it does through
  Pillow: the mode from Pillow's reading of the first directory, the strips
  and the fields they decode by from libtiff's own reading of it (which
  skips what Pillow stops at, and fails or ignores a field of the wrong
  type or count); each strip into Pillow's reused strip buffer; zlib and
  liblzma called as libtiff calls them; CCITT rows ended at a bad code and
  decoding on; a JPEG frame smaller than its strip; YCbCr strips converted
  up to their error; a likely invalid YCbCr tile byte count refused.
  The plain raster formats, as their plugins read them: PBM, PGM, PPM and
  PFM (P1-P6 and Pf, comments, any maxval, Pillow's private P0CMYK, PyP,
  PyRGBA and PyCMYK headers; the plain decoder's 1 MiB blocks, comments
  and token rules; 16-bit gray as mode I, clipped; PFM bottom-up,
  truncated), DIB (a BMP info header without the file header), ICO (the
  entry IcoFile sorts first; a PNG image without its orientation, a DIB
  image's upper half, its AND mask read and dropped) and CUR, TGA (each
  mode of its table, 15-bit colour, colour maps with their first entry,
  applied to gray as putpalette applies them, RLE whose literal packets
  run on across rows, the four origins), PSD's merged image (raw or
  PackBits; bitmap, gray, duotone, multichannel, palette, RGB(A), CMYK,
  Lab),
  QOI, PCX (1-bit in 1, 2 or 4 planes, 8-bit gray or with the VGA palette
  769 bytes before the file's end, RGB planes; padded lines) and DCX's
  first page, SGI (raw or RLE, 8 or 16 bits, 1, 3 or 4 channels).
  The small formats: SUN (depths 1, 4, 8, 24 and 32, a colour map on 4 and
  8 bits, rows padded to 16 bits, raw types and RLE), MSP (version 1 raw,
  version 2's row map and runs), XBM (its header on the first 512 bytes,
  then the hex bytes), XPM (P, or RGB above 256 colours; any characters a
  pixel), ICNS (the size ``bestsize()`` picks: RLE24 with its mask read
  and dropped, or a PNG member without its orientation) and DDS's first
  surface (RGB by its masks, luminance, an 8-bit palette, DX10 RGBA, and
  the blocks BC1, BC2, BC3, BC4, BC5, BC5S, BC6H unsigned and signed (half
  floats to 8 bits as Pillow's decoder maps them) and BC7).
  JPEG 2000, a raw codestream or a JP2 file (and an ICNS member of either),
  to the integers OpenJPEG 2.5.4 gives Pillow: every progression and POC,
  tiles and tile-parts, precincts, layers, each code-block style, ROI,
  5/3 and 9/7 at any number of levels, RCT and ICT, 1 to 31 bits, signed
  or not, subsampled components; then Pillow's unpacking (its mode from
  the SIZ or the JP2 header: L, I;16, LA, RGB, RGBA, CMYK, sYCC through
  its YCbCr tables, a palette as its ``ImagePalette`` builds it).
  The rare formats, each as its plugin reads it: IM (the types of its
  OPEN table Pillow decodes, and LAB: its L band, a and b zero;
  line-interleaved and bit-packed samples, a
  ``Lut``'s palette, rows bottom-up), BLP (BLP1's JPEG, unoriented and re-read
  as BGR, or palette; BLP2's palette or DXT1/3/5 through Pillow's Python
  arithmetic), FITS (BITPIX 8 to -64 read with the mode as raw mode,
  bottom-up; GZIP_1 tiles), FLI/FLC (the first frame's chunks), FTEX,
  GIMP brushes, IM Tools, IPTC records (raw or a band of RGB or CMYK, or a
  JPEG or another file read as ``Image.open`` reads it), McIdas areas,
  PhotoCD's base image at its orientation, Pixar's dumped RGB, SPIDER and
  XV thumbnails. Lossless AVIF, as ``core/avif.py`` says.
  Anything else raises a ``ValueError`` that names the format and the
  feature: 12- and 16-bit JPEG, hierarchical and arithmetic lossless JPEG,
  lossless YCbCr or YCCK, a fractional sampling ratio, TIFF compressions
  other than those above (old-style JPEG, NeXT, PixarLog, SGILog, JBIG,
  WebP), JPEG in a TIFF whose photometric is not gray, RGB, YCbCr or
  CIELab, ZSTD
  on a host without ``libzstd.so.1``, an uncompressed TIFF whose FillOrder-2
  raw mode Pillow lacks, BMP compressions and bitfield layouts Pillow does
  not read, a GIF LZW code size above 8, a WebP frame that is not a key
  frame, a TGA colour map Pillow cannot apply, the DXGI formats Pillow
  does not implement (BC6H's typeless one among them), JPEG 2000's HTJ2K
  (a CAP or CPF marker, an HT code-block), Part 2 transforms (MCT, MCC,
  MCO, CBD) and packed packet headers (PPM, PPT), an IPTC band from a
  record of one band that is not L or 1 as the first band (Image.merge
  takes its bytes) or from a record of a format whose mode the port does
  not read (any but PPM, JPEG, PNG, TIFF, BMP, PSD and IM), the AVIF files
  ``core/avif.py`` lists, and the formats Pillow opens and the port does
  not decode (BUFR, EPS, GRIB, HDF5, MPEG, WMF, each named). So does an
  image above Pillow's decompression-bomb limit (:data:`MAX_PIXELS`),
  before anything of it is allocated, and a TIFF whose tiles are; a PNG, a
  TIFF strip and an LZW, prefix, LZ77, PackBits or CCITT stream decompress
  no further than their image, a TIFF tile no further than the tile, a FITS
  GZIP_1 heap keeps no more than its image while each member is inflated in
  bounded steps to its CRC, and data that runs out (truncated) raises
  naming its format, as does a progressive JPEG without its EOI.
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

from qwen_image_edit_streamdiffusion_tpu_torch.core import avif

SOURCE_DIR = Path(__file__).resolve().parent.parent / "csrc" / "host"
# one library of every decoder (and the shared header, which the hash covers)
SOURCES = ("image_codec.cc", "bmp_gif.cc", "webp.cc", "tiff.cc", "raster.cc", "bcn.cc",
           "jpeg2000.cc", "fli_pcd.cc", "lab_srgb.cc", "av1.cc")
HEADERS = ("codec_common.h", "av1_tables.h")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17")
# a source's own flags: the CIELab transform rounds each product as
# LittleCMS does, so no multiply-add is fused there
SOURCE_FLAGS = {"lab_srgb.cc": ("-ffp-contract=off",)}

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
        h.update(name.encode() + b"\0" + " ".join(SOURCE_FLAGS.get(name, ())).encode() + b"\0"
                 + (SOURCE_DIR / name).read_bytes())
    return BUILD_DIR / f"libqie_codec_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """Every source compiled at once, one compiler process each, then linked
    into ``path`` (written under a temporary name, then renamed)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    work = path.with_suffix(f".{os.getpid()}.tmp")
    work.mkdir(exist_ok=True)
    try:
        objs = [work / f"{name}.o" for name in SOURCES]
        procs = [subprocess.Popen([_compiler(), *CXX_FLAGS, *SOURCE_FLAGS.get(name, ()), "-c",
                                   "-o", str(obj), str(SOURCE_DIR / name)],
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
        lib.qie_jpeg_decode.argtypes = [cp, cl, ci, vp, vp, ci]
        lib.qie_jpeg_decode.restype = ci
        lib.qie_fli_frame.argtypes = [cp, cl, vp, cl, cl, vp, ci]
        lib.qie_pcd.argtypes = [cp, cl, vp, vp, ci]
        lib.qie_im_bits.argtypes = [cp, cl, ci, cl, cl, vp, vp, ci]
        for name in ("qie_fli_frame", "qie_pcd", "qie_im_bits"):
            getattr(lib, name).restype = cl
        lib.qie_tiff_jpeg.argtypes = [cp, cl, cp, cl, ci, ci, ci, ci, ci, ci, ci, vp, vp, ci]
        lib.qie_tiff_jpeg.restype = ci
        lib.qie_tiff_decompress.argtypes = [ci, cp, cl, vp, cl, ci, ci, ci, ci, vp, vp, ci]
        lib.qie_tiff_decompress.restype = ci
        lib.qie_jpeg_encode.argtypes = [vp, ci, ci, ci, ci, ci, ci, vp, cl, vp, ci]
        lib.qie_jpeg_encode.restype = cl
        lib.qie_png_unfilter.argtypes = [cp, ci, cl, ci, vp, vp, ci]
        lib.qie_png_unfilter.restype = ci
        lib.qie_webp_info.argtypes = [cp, cl, pi, pi, pl, pl, pl, pl, vp, ci]
        lib.qie_webp_info.restype = ci
        lib.qie_webp_decode.argtypes = [cp, cl, vp, vp, ci]
        lib.qie_webp_decode.restype = ci
        lib.qie_dib_info.argtypes = [cp, cl, cl, cp, pi, pi, pl, vp, ci]
        lib.qie_dib_decode.argtypes = [cp, cl, cl, cp, ci, vp, vp, ci]
        lib.qie_tga_rle.argtypes = [cp, cl, ci, cl, cl, vp, vp, ci]
        lib.qie_packbits.argtypes = [cp, cl, cl, cl, vp, vp, ci]
        lib.qie_pcx_rle.argtypes = [cp, cl, cl, cl, ci, cl, vp, vp, ci]
        lib.qie_sgi_rle.argtypes = [cp, cl, ci, ci, ci, ci, vp, vp, ci]
        lib.qie_qoi.argtypes = [cp, cl, cl, vp, vp, ci]
        lib.qie_sun_rle.argtypes = [cp, cl, cl, cl, vp, vp, ci]
        lib.qie_msp_rle.argtypes = [cp, cl, cl, cl, vp, vp, ci]
        lib.qie_xbm.argtypes = [cp, cl, cl, vp, vp, ci]
        lib.qie_icns_rle.argtypes = [cp, cl, cl, vp, vp, ci]
        lib.qie_bcn.argtypes = [cp, cl, cl, cl, ci, ci, vp, vp, ci]
        lib.qie_j2k_tile.argtypes = [vp, cl, cp, cl, vp, vp, vp, ci]
        lib.qie_lab_srgb.argtypes = [vp, cl, vp]
        lib.qie_lab_srgb.restype = None
        lib.qie_lab_srgb_eval16.argtypes = [vp, cl, vp]
        lib.qie_lab_srgb_eval16.restype = None
        lib.qie_lab_srgb_grid.argtypes = [vp]
        lib.qie_lab_srgb_grid.restype = cl
        lib.qie_lab_srgb_colorants.argtypes = [vp]
        lib.qie_lab_srgb_colorants.restype = None
        for name in ("dib_info", "dib_decode", "tga_rle", "packbits", "pcx_rle", "sgi_rle",
                     "qoi", "sun_rle", "msp_rle", "xbm", "icns_rle", "bcn", "j2k_tile"):
            getattr(lib, f"qie_{name}").restype = ci
        for fmt in ("bmp", "gif"):
            info, dec = getattr(lib, f"qie_{fmt}_info"), getattr(lib, f"qie_{fmt}_decode")
            info.argtypes, info.restype = [cp, cl, pi, pi, vp, ci], ci
            dec.argtypes, dec.restype = [cp, cl, vp, vp, ci], ci
        _lib = lib
        return lib


def _err() -> ctypes.Array:
    return ctypes.create_string_buffer(256)


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 CIELab as Pillow's LAB mode holds it (LittleCMS's
    TYPE_Lab_8: L 0..255 for 0..100, a and b plus 128) → the same shape of
    sRGB, as Pillow's ``convert("RGB")`` converts it through LittleCMS
    (``lab_srgb.cc`` carries that arithmetic)."""
    lab = np.ascontiguousarray(lab, np.uint8)
    out = np.empty(lab.shape, np.uint8)
    library().qie_lab_srgb(lab.ctypes.data, lab.size // 3, out.ctypes.data)
    return out


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


def _jpeg_info(data: bytes) -> tuple:
    """A JPEG's (width, height, components out: 1 for gray, else 3)."""
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    off, ln, err = ctypes.c_long(), ctypes.c_long(), _err()
    if library().qie_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                               ctypes.byref(c), ctypes.byref(off), ctypes.byref(ln), err,
                               len(err)) != 0:
        raise ValueError(err.value.decode())
    return w.value, h.value, c.value


def _decode_jpeg(data: bytes, oriented: bool = True, plain_cmyk: bool = False) -> np.ndarray:
    """A JPEG's RGB; its EXIF or XMP orientation applied unless
    ``oriented`` is false; ``plain_cmyk`` reads 4 components as CMYK
    whatever the Adobe marker (Pillow's jpegmode "CMYK")."""
    w, h, c = _jpeg_info(data)
    out = np.empty((h, w, c), np.uint8)
    err = _err()
    if library().qie_jpeg_decode(data, len(data), int(plain_cmyk), out.ctypes.data, err,
                                 len(err)) != 0:
        raise ValueError(err.value.decode())
    if c == 1:
        out = np.repeat(out, 3, axis=2)
    if not oriented:
        return out
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


def _decode_png(data: bytes, oriented: bool = True) -> np.ndarray:
    """A PNG's RGB; its EXIF or XMP orientation applied unless ``oriented``
    is False (an icon's PNG image: the icon keeps none of its info)."""
    pos, idat, palette, exif, hdr, xmp = 8, [], None, None, None, None
    while pos + 8 <= len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IEND":  # Pillow stops at it, reading none of it
            break
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
    return _orient(rgb, orientation(exif, xmp)) if oriented else rgb


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


def _decode_webp(data: bytes, oriented: bool = True) -> np.ndarray:
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
    return _orient(out, orientation(exif, xmp)) if oriented else out


# ---------------------------------------------------------------------------
# TIFF: Pillow's TiffImagePlugin over libtiff (tiff.cc decompresses)
# ---------------------------------------------------------------------------

_TIFF_COMPRESSION = {1: "uncompressed", 2: "CCITT RLE", 3: "CCITT Group 3",
                     4: "CCITT Group 4", 5: "LZW", 6: "old-style JPEG", 7: "JPEG",
                     8: "Deflate", 32766: "NeXT", 32771: "CCITT RLEW",
                     32773: "PackBits", 32809: "ThunderScan", 32908: "PixarFilm",
                     32909: "PixarLog", 32946: "Deflate", 34661: "JBIG", 34676: "SGILog",
                     34677: "SGILog24", 34925: "LZMA", 50000: "ZSTD", 50001: "WebP"}
_TIFF_DECODED = (1, 2, 3, 4, 5, 7, 8, 32771, 32773, 32809, 32946, 34925, 50000)
_TIFF_FAX = (2, 3, 4, 32771)
# the offsets Pillow's raw tiles iterate: a BYTE field's bytes are numbers
_TIFF_ITERATED = {273, 324}
# the fields Pillow's mode and codec are looked up by
_TIFF_KEYS = {258, 259, 262, 266, 284, 338, 339}


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
    of an unknown type or of no data is skipped, and one whose data lies past
    the file ends the directory."""
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
        if not raw:  # no data: Pillow skips the entry
            continue
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
        # Pillow only asks whether the field is 2: anything else is chunky
        planar = self.tags.get(284, (3, (1,), b""))[1]
        self.planar = 2 if not isinstance(planar, bytes) and tuple(planar) == (2,) else 1
        # Pillow's raw tiles: strips where the file has StripOffsets
        self.tiled = 273 not in self.tags and 324 in self.tags

    def seq(self, tag, default=(), rational: bool = False):
        """The tag's values: integers, or (numerator, denominator) pairs
        where ``rational``; anything else is a corrupt field."""
        if tag not in self.tags:
            return default
        typ, vals, _ = self.tags[tag]
        if isinstance(vals, bytes):
            # Pillow iterates a BYTE field of offsets as numbers; in the
            # other fields it reads its one bytes value fails
            if typ == 1 and tag in _TIFF_ITERATED:
                return tuple(vals)
            raise ValueError(f"corrupt TIFF: tag {tag} holds bytes, not numbers")
        if not rational and tag in _TIFF_KEYS:
            # Pillow looks these up in OPEN_INFO or compares them: a float or
            # rational of a whole number is the number
            vals = tuple(v[0] // v[1] if isinstance(v, tuple) and v[1] and v[0] % v[1] == 0
                         else int(v) if isinstance(v, float) and v.is_integer() else v
                         for v in vals)
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
        offsets, byte counts) of the strips or tiles, as Pillow's raw tiles
        lay them out; the byte counts as the file holds them (Pillow reads
        none)."""
        if self.tiled:
            tw, th = self.scalar(322), self.scalar(323)
            if not tw or not th:
                raise ValueError("corrupt TIFF: bad TileWidth or TileLength")
            offsets, counts = self.seq(324), self.tags.get(325, (4, (), b""))[1]
        else:
            rps = self.scalar(278, 2 ** 32 - 1)
            if rps == 0:  # Pillow's raw tiles and libtiff both refuse it
                raise ValueError("corrupt TIFF: RowsPerStrip 0")
            tw, th = self.w, min(rps, self.h)
            offsets, counts = self.seq(273), self.tags.get(279, (4, (), b""))[1]
        planes = self.spp if self.planar == 2 else 1
        return tw, th, -(-self.w // tw), -(-self.h // th), planes, offsets, counts


# libtiff's field types: bytes a value, and the struct code of the integer
# types (the rest read as numbers fail its integer fields)
_LT_WIDTH = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4,
             16: 8, 17: 8, 18: 8}
_LT_INT = {1: "B", 6: "b", 3: "H", 8: "h", 4: "L", 9: "l", 16: "Q", 17: "q"}
# the codecs whose Predictor libtiff reads (_TIFFCheckFieldIsValidForCodec)
_LT_PREDICTED = (5, 8, 32909, 32946, 34925, 50000, 50001)


_LT_NAMES = {256: "ImageWidth", 257: "ImageLength", 258: "BitsPerSample", 259: "Compression",
             277: "SamplesPerPixel", 278: "RowsPerStrip", 280: "MinSampleValue",
             281: "MaxSampleValue", 284: "PlanarConfiguration", 322: "TileWidth",
             323: "TileLength", 338: "ExtraSamples", 339: "SampleFormat"}


class _LibTiff:
    """A TIFF's first directory as libtiff 4.7 reads it (tif_dirread.c's
    TIFFReadDirectory), which Pillow's libtiff decoder takes the strips and
    the fields it decodes by from: the first of duplicate tags; the size,
    layout and sample fields failing the directory on a bad type, count or
    value, the others ignored; a ColorMap read only after BitsPerSample and
    at its size; missing or zero byte counts estimated as libtiff estimates
    them. Raises ``ValueError`` where libtiff fails the directory."""

    def __init__(self, data: bytes):
        self.data = data
        fail = ValueError
        if len(data) < 8 or data[:2] not in (b"II", b"MM"):
            raise fail("corrupt TIFF: libtiff reads no TIFF header")
        e = self.e = "<" if data[:2] == b"II" else ">"
        (version,) = struct.unpack_from(e + "H", data, 2)
        if version == 42:
            self.big = False
            (pos,) = struct.unpack_from(e + "L", data, 4)
        elif version == 43:
            if len(data) < 16 or struct.unpack_from(e + "HH", data, 4) != (8, 0):
                raise fail("corrupt TIFF: libtiff refuses the BigTIFF header")
            self.big = True
            (pos,) = struct.unpack_from(e + "Q", data, 8)
        else:
            raise fail(f"corrupt TIFF: libtiff refuses version {version}")
        csize, esize = (8, 20) if self.big else (2, 12)
        if pos == 0 or pos + csize > len(data):
            raise fail("corrupt TIFF: libtiff cannot read the directory count")
        (n,) = struct.unpack_from(e + ("Q" if self.big else "H"), data, pos)
        if n == 0 or n > 4096:
            raise fail(f"corrupt TIFF: libtiff refuses a directory of {n} entries")
        if pos + csize + n * esize > len(data):
            raise fail("corrupt TIFF: libtiff cannot read the directory")
        self.entries, seen = [], set()
        fmt = e + ("HHQ" if self.big else "HHL")
        for k in range(n):
            at = pos + csize + k * esize
            tag, typ, count = struct.unpack_from(fmt, data, at)
            field = data[at + esize - (8 if self.big else 4):at + esize]
            # later duplicates of a tag are ignored (bugzilla 1994)
            self.entries.append([tag, typ, count, field, tag in seen])
            seen.add(tag)
        self.read()

    # -- TIFFReadDirEntry*: values, or an error name ------------------------

    def values(self, ent, limit=None):
        """The integers of an entry (at most ``limit`` of them), or raises
        KeyError naming libtiff's error."""
        tag, typ, count, field, _ = ent
        if typ not in _LT_INT:
            raise KeyError("type")
        width = _LT_WIDTH[typ]
        take = count if limit is None else min(count, limit)
        if take == 0:
            return ()
        if take > 2147483647 // max(width, 8):
            raise KeyError("size")
        if count * width <= (8 if self.big else 4):
            raw = field[:take * width]
        else:
            (off,) = struct.unpack(self.e + ("Q" if self.big else "L"), field)
            if off + take * width > len(self.data):
                raise KeyError("io")
            raw = self.data[off:off + take * width]
        return struct.unpack(self.e + _LT_INT[typ] * take, raw)

    def floats(self, ent):
        tag, typ, count, field, _ = ent
        width = _LT_WIDTH.get(typ, 0)
        if typ not in _LT_INT and typ not in (5, 10, 11, 12):
            raise KeyError("type")
        if count * width <= (8 if self.big else 4):
            raw = field[:count * width]
        else:
            (off,) = struct.unpack(self.e + ("Q" if self.big else "L"), field)
            if off + count * width > len(self.data):
                raise KeyError("io")
            raw = self.data[off:off + count * width]
        if typ in (5, 10):
            v = struct.unpack(self.e + ("L" if typ == 5 else "l") * (2 * count), raw)
            # (float) numerator / (float) denominator, as libtiff divides
            return tuple(np.float32(a) / np.float32(b) if b else np.float32(0)
                         for a, b in zip(v[::2], v[1::2]))
        code = {11: "f", 12: "d"}.get(typ, _LT_INT.get(typ))
        return tuple(np.float32(x) for x in struct.unpack(self.e + code * count, raw))

    def one(self, ent, top):
        """TIFFReadDirEntryShort / Long: one value in 0..top."""
        if ent[2] != 1:
            raise KeyError("count")
        (v,) = self.values(ent)
        if not 0 <= v <= top:
            raise KeyError("range")
        return v

    def shorts(self, ent):
        v = self.values(ent)
        if any(not 0 <= x <= 0xFFFF for x in v):
            raise KeyError("range")
        return v

    def per_sample(self, ent):
        """TIFFReadDirEntryShort, else TIFFReadDirEntryPersampleShort: every
        sample's value the same."""
        try:
            return self.one(ent, 0xFFFF)
        except KeyError as ex:
            if ex.args[0] != "count":
                raise
        if ent[2] < self.spp:
            raise KeyError("count")
        v = self.shorts(ent)
        if any(x != v[0] for x in v[1:self.spp]):
            raise KeyError("per-sample values differ")
        return v[0]

    # -- TIFFReadDirectory --------------------------------------------------

    def find(self, tag):
        return next((x for x in self.entries if x[0] == tag), None)

    def read(self):
        fail = ValueError

        def bad(what):
            return fail(f"corrupt TIFF: {what} (libtiff fails the directory)")

        self.spp, self.comp, self.planar = 1, 1, 1
        self.w = self.h = None
        self.rps = 2 ** 32 - 1
        self.tw = self.th = None
        self.extra = 0
        self.bps, self.sample_format, self.photo, self.fill = 1, 1, None, 1
        self.predictor, self.t4 = 1, 0
        self.sub, self.coef, self.refbw, self.tables = (2, 2), None, None, None
        self.colormap = None
        ent = self.find(277)
        if ent:
            try:
                self.spp = self.one(ent, 0xFFFF)
            except KeyError as ex:
                raise bad(f"SamplesPerPixel {ex.args[0]}") from None
            if self.spp == 0:
                raise bad("SamplesPerPixel 0")
            ent[4] = True
        ent = self.find(259)
        if ent:
            try:
                self.comp = self.per_sample(ent)
            except KeyError as ex:
                raise bad(f"Compression {ex.args[0]}") from None
            ent[4] = True
        codec_tags = {317: self.comp in _LT_PREDICTED or self.comp not in _TIFF_COMPRESSION,
                      347: self.comp == 7, 292: self.comp == 3, 293: self.comp == 4}
        present = set()
        for ent in self.entries:  # the first pass
            tag = ent[0]
            if ent[4]:
                continue
            if tag in (273, 279, 324, 325):
                present.add(tag)
            elif tag in (256, 257, 322, 323, 284, 278, 338):
                try:
                    if tag == 338:
                        if ent[2] > 0xFFFF:
                            raise KeyError("count")
                        v = self.shorts(ent)
                        if len(v) > self.spp or any(x > 2 and x != 999 for x in v):
                            raise KeyError("value")
                        self.extra = len(v)
                    elif tag == 284:
                        self.planar = self.one(ent, 0xFFFF)
                        if self.planar not in (1, 2):
                            raise KeyError("value")
                    else:
                        v = self.one(ent, 2 ** 32 - 1)
                        if tag == 278 and v == 0:
                            raise KeyError("0")
                        setattr(self, {256: "w", 257: "h", 322: "tw", 323: "th", 278: "rps"}[tag],
                                v)
                except KeyError as ex:
                    raise bad(f"{_LT_NAMES.get(tag, tag)} {ex.args[0]}") from None
                ent[4] = True
            elif tag in codec_tags and not codec_tags[tag]:
                ent[4] = True
        if self.w is None or self.h is None:
            raise bad("no ImageWidth or ImageLength")
        self.tiled = self.tw is not None or self.th is not None
        if self.tiled:
            tw, th = self.tw or 0, self.th or 0
            n = 0 if not tw or not th else -(-self.w // tw) * -(-self.h // th)
        else:
            rps = min(self.rps, self.h)
            n = 1 if rps == 0 else -(-self.h // rps)
        if self.planar == 2:
            n *= self.spp
        if n == 0 or n > 2 ** 32 - 1:
            raise bad("no strips or tiles")
        self.nstrips = n
        if not ({273, 324} & present):
            raise bad("no StripOffsets")
        bps_read = False
        offsets_ent = counts_ent = None
        for ent in self.entries:  # the second pass
            tag = ent[0]
            if ent[4]:
                continue
            try:
                if tag in (258, 280, 281, 339, 32996):
                    v = self.per_sample(ent)
                    if tag == 339 and not 1 <= v <= 6:
                        raise KeyError("value")
                    if tag == 258:
                        self.bps, bps_read = v, True
                    elif tag == 339:
                        self.sample_format = v
                elif tag in (340, 341):
                    if ent[2] < self.spp:
                        raise KeyError("count")
                    self.floats(ent)
                elif tag in (273, 324):
                    offsets_ent = ent
                elif tag in (279, 325):
                    counts_ent = ent
                elif tag == 320:
                    if not bps_read or self.bps > 24 or ent[2] != 3 << self.bps:
                        continue
                    try:
                        self.colormap = self.shorts(ent)
                    except KeyError:
                        pass
                else:
                    self.normal(ent)
            except KeyError as ex:
                raise bad(f"{_LT_NAMES.get(tag, tag)} {ex.args[0]}") from None
        if self.photo == 3 and self.colormap is None:
            if self.bps >= 8:
                self.photo = 2 if self.spp == 3 else 1
            else:
                raise bad("a palette without its ColorMap")
        self.offsets = self.strile(offsets_ent)
        if counts_ent is None:
            if (self.planar == 1 and n > 1) or (self.planar == 2 and n != self.spp):
                raise bad("no StripByteCounts")
            self.counts = self.estimate()
        else:
            self.counts = self.strile(counts_ent)
            if n == 1 and not self.tiled and self.offsets[0] and not self.counts[0] \
                    and self.comp != 1:
                self.counts = self.estimate()
        if not self.w or not self.h:
            raise bad("zero scanline or strip size")

    def normal(self, ent):
        """TIFFFetchNormalTag with recovery: a field that fails is ignored."""
        tag = ent[0]
        try:
            if tag in (262, 266, 317):
                v = self.one(ent, 0xFFFF)
                if tag == 266 and v not in (1, 2):
                    return
                name = {262: "photo", 266: "fill", 317: "predictor"}[tag]
                setattr(self, name, v)
            elif tag in (292, 293):
                self.t4 = self.one(ent, 2 ** 32 - 1)
            elif tag == 530:
                if ent[2] != 2:
                    return
                self.sub = tuple(self.shorts(ent))
            elif tag in (529, 532):
                if ent[2] != (3 if tag == 529 else 6):
                    return
                v = self.floats(ent)
                if tag == 529:
                    self.coef = v
                else:
                    self.refbw = v
            elif tag == 347:
                v = self.values(ent) if ent[1] not in (2, 7) else None
                if v is None:
                    raw = self.raw(ent)
                    if raw is None:
                        return
                    v = tuple(raw)
                if ent[2] == 0 or any(not 0 <= x <= 255 for x in v):
                    return
                self.tables = bytes(v)
        except KeyError:
            return

    def raw(self, ent):
        tag, typ, count, field, _ = ent
        if count <= (8 if self.big else 4):
            return field[:count]
        (off,) = struct.unpack(self.e + ("Q" if self.big else "L"), field)
        return self.data[off:off + count] if off + count <= len(self.data) else None

    def strile(self, ent):
        """TIFFFetchStripThing: nstrips values, zeros past the entry's."""
        try:
            v = self.values(ent, self.nstrips)
        except KeyError as ex:
            raise ValueError(f"corrupt TIFF: libtiff fails the strip array ({ex})") from None
        if any(x < 0 for x in v):
            raise ValueError("corrupt TIFF: libtiff fails the strip array (range)")
        if len(v) < self.nstrips and self.nstrips > 1000000:
            raise ValueError("corrupt TIFF: libtiff fails the strip array (count)")
        return tuple(v) + (0,) * (self.nstrips - len(v))

    def estimate(self):
        """EstimateStripByteCounts of a compressed file: what the file holds
        past its header, directory and out-of-line field data."""
        if self.comp == 1:
            raise ValueError("corrupt TIFF: uncompressed without byte counts")
        space = (16 + 8 + len(self.entries) * 20 + 8) if self.big else \
            (8 + 2 + len(self.entries) * 12 + 4)
        for tag, typ, count, field, _ in self.entries:
            width = _LT_WIDTH.get(typ, 0)
            if width == 0:
                raise ValueError(f"corrupt TIFF: libtiff cannot size a field of type {typ}")
            size = width * count
            space += size if size > (8 if self.big else 4) else 0
        size = len(self.data)
        space = size if size < space else size - space
        if self.planar == 2:
            space //= self.spp
        counts = [space] * self.nstrips
        last = self.offsets[-1]
        if last + counts[-1] > size:
            counts[-1] = 0 if last >= size else size - last
        if self.rps == 2 ** 32 - 1 and not any(x[0] == 278 for x in self.entries):
            self.rps = self.h
        return tuple(counts)

    def layout(self):
        """(chunk width, chunk rows, chunks across, chunks down, planes,
        offsets, byte counts) as libtiff lays the strips or tiles out."""
        if self.tiled:
            tw, th = self.tw or 0, self.th or 0
        else:
            tw, th = self.w, min(self.rps, self.h)
        planes = self.spp if self.planar == 2 else 1
        return tw, th, -(-self.w // tw), -(-self.h // th), planes, self.offsets, self.counts


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
    if mode == "P" and 320 not in t.tags:
        raise ValueError("corrupt TIFF: a palette image without its ColorMap (Pillow cannot "
                         "open it)")
    if mode == "P" and len(t.tags[320][1]) > 770:
        raise ValueError("corrupt TIFF: a ColorMap of more than 256 colours (Pillow's "
                         "putpalette refuses it)")
    if t.w <= 0 or t.h <= 0:
        raise ValueError("corrupt TIFF: zero width or height")
    if t.w * t.h > MAX_PIXELS:
        raise ValueError(f"unsupported TIFF: {t.w}x{t.h} pixels exceed the "
                         f"decompression-bomb limit")
    tag = t.tags.get(274)
    orient = _orientation_value(t.e, tag[0], tag[2]) if tag else None
    if orient is None:
        xmp = t.tags.get(700)
        orient = orientation(None, xmp[1] if xmp and isinstance(xmp[1], bytes) else None)
    if t.comp == 1:
        if t.fill == 2 and (mode, t.bps[0]) in (("L;I", 8), ("P", 1), ("P", 2), ("P", 4)):
            raise ValueError(f"unsupported TIFF: uncompressed {mode} of {t.bps[0]} bits at "
                             "FillOrder 2 (Pillow has no raw mode for it)")
        px, covered = _tiff_raw(t, mode)
        rgb = _tiff_rgb(t, px, mode)
        if covered is not None:  # what no tile covers is Pillow's image as made: zero
            zero = (_tiff_rgb(t, np.zeros((1, 1, 3), np.uint8), mode)[0, 0]
                    if mode in ("P", "LAB") else 255 if mode == "CMYK" else 0)
            rgb[~covered] = zero
        return _orient(rgb, orient)
    else:
        # Pillow decodes a compressed file through libtiff, which reads the
        # directory again, its own way
        lt = _LibTiff(data)
        if (lt.w, lt.h) != (t.w, t.h):
            raise ValueError(f"corrupt TIFF: libtiff reads a {lt.w}x{lt.h} image, Pillow "
                             f"{t.w}x{t.h}")
        px, mode = _tiff_coded(t, lt, mode)
    return _orient(_tiff_rgb(t, px, mode), orient)


def _tiff_raw(t: _Tiff, mode: str) -> np.ndarray:
    """An uncompressed TIFF as Pillow's own raw decoder reads it: each strip
    or tile from its offset, its byte count unread, rows of the bits its raw
    mode takes (bits reversed at FillOrder 2), Predictor not applied. So a
    YCbCr file reads as RGBX (past its strip, into what follows it) and a
    planar one a byte a sample, as Pillow reads them. Returns (samples, the
    pixels a tile covers, or None for all)."""
    if 273 not in t.tags and 324 not in t.tags:
        raise ValueError("corrupt TIFF: no StripOffsets or TileOffsets (Pillow knows no data "
                         "organization)")
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
    # Pillow's tiles: one an offset, left to right and down, wrapping to the
    # next plane (and, chunky, over the image again) past the last row; in
    # file order, a later one over an earlier; what no tile covers zero
    tiles, x0, y0, layer = [], 0, 0, 0
    for off in offsets:
        tiles.append((off, x0, y0, layer))
        x0 += tw
        if x0 >= t.w:
            x0, y0 = 0, y0 + th
            if y0 >= t.h:
                y0, layer = 0, layer + 1
    if t.planar == 2 and tiles[-1][3] >= planes:
        raise ValueError(f"corrupt TIFF: {len(offsets)} strip or tile offsets for {planes} "
                         "planes (Pillow has no raw mode past its last band)")
    out = [np.zeros((t.h, (t.w * bits + 7) // 8), np.uint8) for _ in range(planes)]
    covered = np.zeros((t.h, t.w), bool)
    # Pillow's bps_count: the photometric's colour samples and the extra ones
    bands = {2: 3, 6: 3, 8: 3, 5: 4}.get(t.photo, 1) + len(t.extra)
    for off, x0, y0, layer in sorted(tiles, key=lambda tile: tile[0]):
        plane = out[layer if t.planar == 2 else 0]
        x1, y1 = min(x0 + tw, t.w), min(y0 + th, t.h)
        covered[y0:y1, x0:x1] = True  # a plane's tile: Pillow sees its band's
        nb = ((x1 - x0) * bits + 7) // 8
        stride = nb
        if x0 + tw > t.w:
            # an edge tile's rows: Pillow's stride of the tile's width in the
            # file's bits a pixel (a band's, planar), cut to a whole byte
            stride = int(tw * sum(t.bps) / 8 / (bands if t.planar == 2 else 1))
            if stride < nb:
                raise ValueError("corrupt TIFF: an edge tile's rows are shorter than its raw "
                                 "mode's (Pillow's raw decoder refuses them)")
        need = stride * (y1 - y0 - 1) + nb  # the last row's padding is never read
        chunk = t.data[off:off + need]
        if len(chunk) < need:
            raise ValueError("truncated TIFF: image data ends early")
        if t.fill == 2:  # the raw modes ";R": each byte's bits reversed
            chunk = chunk.translate(_REVERSED_BITS)
        rows = np.frombuffer(chunk + bytes(stride - nb), np.uint8).reshape(y1 - y0, stride)
        xb = x0 * bits // 8
        plane[y0:y1, xb:xb + nb] = rows[:, :nb]
    covered = None if covered.all() else covered
    if bits == 32 and t.photo == 6:
        return out[0].reshape(t.h, t.w, 4)[..., :3], covered
    if t.planar == 2:  # a plane a band: the LAB planes go in as they are
        return np.stack(out, -1), covered
    px = _tiff_unpack(out[0], t.w, t.bps[0], t.spp, t.e, t.sample_format)
    return (_tiff_lab(px) if mode == "LAB" else px), covered


def _tiff_lab(px: np.ndarray) -> np.ndarray:
    """Pillow's raw mode LAB: a and b are signed in a TIFF, unsigned in its
    image (a chunky file's; planes are copied as they are)."""
    return px ^ np.uint8([0, 128, 128])


def _tiff_unpack(rows: np.ndarray, w: int, bits: int, spp: int, e: str, sample_format):
    """Rows of packed samples (H, rowbytes) → (H, W, spp) values: below 8
    bits unpacked most significant bits first, 16 and 32 bits in the file's
    byte order, signed or float by the sample format."""
    h = rows.shape[0]
    if bits < 8:
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        v = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(h, -1)[:, :w * spp]
        return v.reshape(h, w, spp)
    if bits == 12:  # Pillow's I;12 unpacker: three nibbles a sample, the first the highest
        n = (w * spp * 12 + 7) // 8
        nib = np.stack([rows[:, :n] >> 4, rows[:, :n] & 15], -1).reshape(h, -1).astype(np.uint16)
        nib = np.pad(nib, ((0, 0), (0, -nib.shape[1] % 3)))[:, :w * spp * 3].reshape(h, -1, 3)
        return (nib[..., 0] << 8 | nib[..., 1] << 4 | nib[..., 2]).reshape(h, w, spp)
    n = bits // 8
    if n == 1:
        return rows[:, :w * spp].reshape(h, w, spp)
    kind = {2: "i", 3: "f"}.get(sample_format[0], "u")
    dt = np.dtype(e + kind + str(n))
    return rows[:, :w * spp * n].copy().view(dt).reshape(h, w, spp)


def _tiff_coded(t: _Tiff, lt: _LibTiff, mode: str):
    """A compressed TIFF's samples as libtiff gives them to Pillow: each
    strip or tile decompressed into Pillow's strip or tile buffer, Predictor
    2 undone, the chunks assembled; JPEG strips decoded (YCbCr to RGB, as
    Pillow asks libtiff for JPEGCOLORMODE_RGB), other YCbCr through libtiff's
    RGBA reader. Pillow's directory ``t`` gives the mode, libtiff's ``lt``
    the strips and the fields they decode by. Returns (samples, mode)."""
    if len(set(t.bps)) != 1:
        raise ValueError(f"unsupported TIFF: samples of different depths {t.bps}")
    jpeg = lt.comp == 7
    ycbcr = lt.photo == 6 and not jpeg
    # Pillow reads libtiff's RGBA rows of YCbCr with its own raw mode: a
    # directory Pillow ends before SamplesPerPixel makes that L
    rgba_as_l = ycbcr and mode == "L" and t.spp == 1 and lt.spp == 3
    if (jpeg or ycbcr) and (lt.bps, lt.spp) != (t.bps[0], t.spp) and not rgba_as_l:
        raise ValueError("unsupported TIFF: libtiff reads the samples' layout apart from Pillow "
                         f"({lt.spp} of {lt.bps} bits, planar {lt.planar}, photometric "
                         f"{lt.photo})")
    tw, th, across, down, _, offsets, counts = lt.layout()
    rps = lt.rps
    if not lt.tiled and 2 ** 31 <= rps < 2 ** 32 - 1:
        # Pillow's strip decoder refuses it (decoder error -9), and above
        # 2**32 - 1 - ImageLength libtiff counts no strips
        raise ValueError(f"corrupt TIFF: RowsPerStrip {rps}")
    if lt.tiled and tw * th > MAX_PIXELS:
        # a tile is decompressed whole, however little of it the image shows;
        # at 8 bytes a pixel at most, this also keeps it under the 2**31 - 1
        # bytes that Pillow's libtiff decoder takes
        raise ValueError(f"unsupported TIFF: {tw}x{th} tiles exceed the "
                         f"decompression-bomb limit")
    b, pb = lt.bps, t.bps[0]  # libtiff's bits a sample, and Pillow's
    if lt.predictor not in (1, 2, 3):
        raise ValueError(f"unsupported TIFF: unknown predictor ({lt.predictor})")
    # tif_predict.c's PredictorSetup
    if lt.predictor == 2 and b not in (8, 16, 32):
        raise ValueError(f"corrupt TIFF: Predictor 2 with {b}-bit samples")
    if lt.predictor == 3 and lt.sample_format != 3:
        raise ValueError(f"corrupt TIFF: floating-point Predictor 3 with sample format "
                         f"{lt.sample_format} (libtiff takes IEEE floats only)")
    if lt.predictor == 3 and b not in (16, 24, 32, 64):
        raise ValueError(f"corrupt TIFF: floating-point Predictor 3 with {b}-bit samples")
    if lt.comp in _TIFF_FAX and b != 1:
        raise ValueError(f"corrupt TIFF: CCITT with {b}-bit samples (libtiff's Fax3SetupState "
                         "refuses them)")
    if lt.comp == 32809 and b != 4:
        raise ValueError(f"corrupt TIFF: ThunderScan with {b}-bit samples (libtiff's "
                         "ThunderSetupDecode refuses them)")
    if lt.comp == 32809 and lt.tiled:
        raise ValueError("corrupt TIFF: ThunderScan in tiles (libtiff decodes it in strips "
                         "only)")
    # Pillow's libtiff decoder unpacks a plane a band where libtiff reads
    # planes and its mode has more than one band (_pickUnpackers), else its
    # own raw mode from the start of each of libtiff's rows
    bands = {"LA": 2, "RGB": 3, "YCbCr": 3, "LAB": 3, "CMYK": 4, "RGBA": 4, "RGBa": 4}.get(
        mode, t.spp if mode == "P" else 1)
    nplanes = (bands if bands > 1 else 1) if lt.planar == 2 else 1
    per = 1 if lt.planar == 2 else lt.spp  # libtiff's samples a row's pixel
    pper = 1 if nplanes > 1 else t.spp     # Pillow's
    if lt.planar == 2 and 0 in t.extra:
        raise ValueError("unsupported TIFF: planar with an unused extra sample (Pillow's "
                         "libtiff decoder fails on it)")
    if not (jpeg or ycbcr):
        if nplanes > 1 and b not in (8, 16):
            raise ValueError(f"corrupt TIFF: {b}-bit planes (Pillow's libtiff decoder takes 8 "
                             "or 16)")
        if nplanes > lt.spp:
            raise ValueError(f"corrupt TIFF: {nplanes} planes of {lt.spp} samples")
        width = tw if lt.tiled else t.w
        if (width * sum(t.bps) // nplanes + 7) // 8 != (width * per * b + 7) // 8:
            raise ValueError("corrupt TIFF: Pillow's rows and libtiff's differ in length (its "
                             "decoder refuses them)")
    if lt.planar == 2 and mode == "RGBA" and not t.extra:
        mode = "RGBa"  # Pillow reads planar RGBA without ExtraSamples as premultiplied
    if lt.photo == 6 and lt.spp != 3:
        raise ValueError("unsupported TIFF: YCbCr of one sample (libtiff's RGBA reader takes "
                         "three)")
    sub = lt.sub if lt.photo == 6 else (1, 1)
    if ycbcr:
        if lt.planar != 1 or b != 8:
            raise ValueError("unsupported TIFF: YCbCr (not JPEG) that is planar or not 8-bit")
        if tuple(sub) not in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2), (4, 4)):
            raise ValueError(f"unsupported TIFF: YCbCr subsampling {tuple(sub)}")
        block_rows = th if lt.tiled or rps == 2 ** 32 - 1 else rps
        if block_rows > (2 ** 31 - 1) // 4 // t.w:
            # Pillow's RGBA decoder sizes its buffer by the unclamped rows
            raise ValueError(f"corrupt TIFF: YCbCr (not JPEG) in blocks of {block_rows} rows "
                             f"{t.w} pixels wide (Pillow's RGBA decoder takes 2**31 - 1 bytes)")
        ycc = _YCbCr(lt)
    if jpeg and (lt.planar != 1 or t.planar != 1 or lt.photo not in (0, 1, 2, 6, 8) or b != 8):
        raise ValueError(f"unsupported TIFF: JPEG with photometric {lt.photo}, planar "
                         f"configuration {lt.planar} and {b}-bit samples")
    t4 = lt.t4 if lt.comp in (3, 4) else 0
    lib, err = library(), _err()
    dtype = np.dtype("=u" + str(-(-pb // 8)))
    # libtiff hands Pillow native (little-endian) samples; Pillow reads them
    # in the file's order where its raw mode is a big-endian signed or float
    # one (it makes only the unsigned 16-bit ones native): their bytes swapped
    swapped = t.e == ">" and pb in (16, 32) and t.sample_format[0] in (2, 3)
    # the order the strip's bytes are read in: the file's, or, once fpAcc
    # put them together, native
    order = ("<" if swapped else t.e) if lt.predictor != 3 else (">" if swapped else "<")
    out = np.empty((t.h, t.w, 3 if ycbcr else t.spp), dtype)
    # Pillow's strip or tile buffer, one for every chunk: what a decoder
    # leaves unwritten keeps the last chunk's bytes (zero at first, as a
    # fresh allocation holds)
    rowbytes = tw * (1 if t.spp == 1 else 3) if jpeg else (tw * per * b + 7) // 8
    held = np.zeros(0 if ycbcr else th * rowbytes, np.uint8)
    # libtiff's CCITT run arrays and its no-EOL mode, kept across strips
    runs = np.zeros(2 * (2 if lt.comp == 4 or t4 & 1 else 1) * ((tw + 32) // 32 * 32) + 1,
                    np.uint32) if lt.comp in _TIFF_FAX else None
    # TIFFStripSize or TIFFTileSize: TIFFFillStrip and TIFFFillTile cut a
    # byte count over 1 MiB to ten of these and 4 KiB before they read it
    chunk = (-(-th // sub[1]) * -(-tw // sub[0]) * (sub[0] * sub[1] + 2) if ycbcr
             else th * ((tw * per * b + 7) // 8))
    k = 0
    for p in range(nplanes):
        for ty in range(down):
            units = None  # the RGBA reader's buffer, made for each strip or row of tiles
            for tx in range(across):
                x0, y0 = tx * tw, ty * th
                rows = th if lt.tiled else min(th, t.h - y0)
                w, h = min(tw, t.w - x0), min(rows, t.h - y0)
                off, cnt = offsets[k], counts[k]
                k += 1
                if cnt > 1 << 20 and (cnt - 4096) // 10 > chunk:
                    cnt = chunk * 10 + 4096
                if (ycbcr and lt.tiled and units is not None
                        and (cnt == 0 or off + cnt > len(t.data))):
                    # the RGBA reader goes on past a later tile of its row that
                    # libtiff cannot fill, converting the tile buffer it zeroed
                    units[:] = 0
                    block = ycc.rgb(units, tw, rows, *sub, w, h)
                    out[y0:y0 + h, x0:x0 + w] = block[:h, :w]
                    continue
                if cnt == 0:
                    raise ValueError("corrupt TIFF: a strip or tile of 0 bytes")
                raw = t.data[off:off + cnt]
                if len(raw) < cnt:
                    raise ValueError("truncated TIFF: a strip or tile lies past the end of "
                                     "the file")
                if jpeg:
                    last = not lt.tiled and y0 + rows >= t.h
                    block = held[:rows * rowbytes].reshape(rows, tw, -1)
                    _tiff_jpeg_chunk(lib, err, raw, lt, tw, rows, last, sub, block)
                elif ycbcr:
                    hs, vs = sub
                    unit_row = -(-tw // hs) * (hs * vs + 2)
                    size = -(-rows // vs) * unit_row
                    # a strip is read in rows of TIFFScanlineSize, which rounds
                    # down (4x4 at an odd number of units a row): the rest of
                    # the units converted are the zeros of libtiff's cleared
                    # strip buffer
                    read = size if lt.tiled else -(-rows // vs) * vs * (unit_row // vs)
                    if units is None:
                        if lt.tiled:
                            _tiff_check_ratio(lt, cnt, size)
                        units = np.zeros(size, np.uint8)
                    else:  # a tile that fails shows zeros past its error, not the tile before's
                        units[:] = 0
                    _tiff_decompress(lib, err, lt, raw, units[:read], tw, t4, tolerant=True)
                    block = ycc.rgb(units[:size], tw, rows, hs, vs, w, h)
                else:
                    dec = held[:rows * rowbytes]
                    # RLEW aligns its rows by the address: the offset's parity
                    _tiff_decompress(lib, err, lt, raw, dec, tw,
                                     off & 1 if lt.comp == 32771 else t4, runs=runs)
                    dec = dec.reshape(rows, rowbytes)
                    if lt.predictor == 2:
                        dec[:] = _tiff_accumulate(dec, tw, per, b, t.e)
                    elif lt.predictor == 3:
                        dec[:] = _tiff_fp_accumulate(dec, per, b)
                    block = _tiff_unpack(dec, tw, pb, pper, order, (1,))
                if lt.planar == 2:
                    out[y0:y0 + h, x0:x0 + w, p] = block[:h, :w, 0]
                else:
                    out[y0:y0 + h, x0:x0 + w] = block[:h, :w]
    if pb in (16, 32):  # the words as the sample format reads them
        n = str(pb // 8)
        out = out.view(np.dtype({2: "=i" + n, 3: "=f" + n}.get(t.sample_format[0], "=u" + n)))
    if rgba_as_l:  # each row's first bytes of R, G, B, A
        rgba = np.concatenate([out, np.full(out.shape[:2] + (1,), 255, np.uint8)], -1)
        return rgba.reshape(t.h, -1)[:, :t.w, None], mode
    if ycbcr or (jpeg and lt.photo == 6):
        mode = "RGB"
    if mode == "LAB" and nplanes == 1:
        out = _tiff_lab(out)
    return out, mode


def _tiff_check_ratio(lt: _LibTiff, cnt: int, size: int) -> None:
    """The check of _TIFFReadEncodedTileAndAllocBuffer, which libtiff's RGBA
    reader allocates a row of tiles' buffer through (a strip's has none):
    above 100,000,000 bytes, data under a thousandth of the tile (a 7000th
    for LZMA, a 33000th for ZSTD) is a likely invalid byte count, and fails
    the image."""
    ratio = {34925: 7000, 50000: 33000}.get(lt.comp, 1000)
    if size > 100_000_000 and cnt < size // ratio:
        raise ValueError(f"corrupt TIFF: likely invalid tile byte count ({cnt} for a tile of "
                         f"{size} bytes, libtiff's RGBA reader refuses it)")


def _tiff_decompress(lib, err, t, raw: bytes, out: np.ndarray, width: int, t4: int,
                     tolerant: bool = False, runs: Optional[np.ndarray] = None) -> None:
    """One strip or tile decompressed into ``out`` (uint8, the strip's
    bytes): Deflate, LZMA and ZSTD through zlib, liblzma and libzstd as
    libtiff calls them,
    the rest in tiff.cc. FillOrder 2 reverses the bits of every byte first,
    as TIFFFillStrip does. Raises where libtiff fails the strip, but
    ``tolerant``: what was decoded before the error stays, the rest of
    ``out`` as it was (libtiff's RGBA reader converts it all the same).
    ``runs``: libtiff's CCITT run arrays, kept across a file's strips."""
    comp = t.comp
    if comp in (8, 32946, 34925, 50000):
        if t.fill == 2:
            raw = raw.translate(_REVERSED_BITS)
        if not _inflate(comp, raw, out) and not tolerant:
            raise ValueError(f"corrupt TIFF: {_TIFF_COMPRESSION[comp]} data fails before the "
                             f"end of its strip")
        return
    if lib.qie_tiff_decompress(comp, raw, len(raw), out.ctypes.data, out.size, width, t4,
                               t.fill, int(tolerant), None if runs is None else runs.ctypes.data,
                               err, len(err)) < 0:
        raise ValueError(err.value.decode())


_REVERSED_BITS = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
_LZMA_MEMLIMIT = 256 << 20


class _ZStream(ctypes.Structure):
    _fields_ = [("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_uint),
                ("total_in", ctypes.c_ulong), ("next_out", ctypes.c_void_p),
                ("avail_out", ctypes.c_uint), ("total_out", ctypes.c_ulong),
                ("msg", ctypes.c_char_p), ("state", ctypes.c_void_p),
                ("zalloc", ctypes.c_void_p), ("zfree", ctypes.c_void_p),
                ("opaque", ctypes.c_void_p), ("data_type", ctypes.c_int),
                ("adler", ctypes.c_ulong), ("reserved", ctypes.c_ulong)]


class _LzmaStream(ctypes.Structure):
    _fields_ = [("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_size_t),
                ("total_in", ctypes.c_uint64), ("next_out", ctypes.c_void_p),
                ("avail_out", ctypes.c_size_t), ("total_out", ctypes.c_uint64),
                ("allocator", ctypes.c_void_p), ("internal", ctypes.c_void_p),
                ("reserved", ctypes.c_void_p * 4), ("seek_pos", ctypes.c_uint64),
                ("reserved_int2", ctypes.c_uint64), ("reserved_int3", ctypes.c_size_t * 2),
                ("reserved_enum", ctypes.c_int * 2)]


class _ZstdBuffer(ctypes.Structure):  # ZSTD_inBuffer and ZSTD_outBuffer
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


_stream_libs: dict = {}


def _stream_lib(name: str) -> ctypes.CDLL:
    """zlib (``libz.so.1``) or liblzma (``liblzma.so.5``), the libraries
    Python's ``zlib`` and ``lzma`` modules are built on (imported above, so
    the loader finds the copy they loaded), or the system's libzstd
    (``libzstd.so.1``: Python 3.12 has no zstd module), called as libtiff
    calls them: their errors come after output that Python's wrappers
    discard."""
    with _lock:
        if name not in _stream_libs:
            try:
                lib = ctypes.CDLL(name)
            except OSError:
                what = {"libzstd.so.1": "ZSTD", "liblzma.so.5": "LZMA"}.get(name, "Deflate")
                raise ValueError(f"unsupported TIFF: {what} compression needs the system's "
                                 f"{name}, which this host lacks") from None
            if name == "libzstd.so.1":
                lib.ZSTD_createDStream.restype = ctypes.c_void_p
                lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
                lib.ZSTD_initDStream.argtypes = [ctypes.c_void_p]
                lib.ZSTD_initDStream.restype = ctypes.c_size_t
                lib.ZSTD_decompressStream.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                                      ctypes.c_void_p]
                lib.ZSTD_decompressStream.restype = ctypes.c_size_t
                lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
                lib.ZSTD_isError.restype = ctypes.c_uint
            elif name == "libz.so.1":
                lib.zlibVersion.restype = ctypes.c_char_p
                lib.inflateInit_.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
                lib.inflate.argtypes = [ctypes.c_void_p, ctypes.c_int]
                lib.inflateEnd.argtypes = [ctypes.c_void_p]
            else:
                lib.lzma_stream_decoder.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                                    ctypes.c_uint32]
                lib.lzma_code.argtypes = [ctypes.c_void_p, ctypes.c_int]
                lib.lzma_end.argtypes = [ctypes.c_void_p]
            _stream_libs[name] = lib
        return _stream_libs[name]


def _inflate(comp: int, raw: bytes, out: np.ndarray) -> bool:
    """Decompress a Deflate, LZMA or ZSTD strip into ``out`` (uint8, its
    size the strip's) as tif_zip.c's ZIPDecode, tif_lzma.c's LZMADecode and
    tif_zstd.c's ZSTDDecode do, in one
    call on the whole strip: Deflate fails on any zlib error, even one after
    the strip is full, and zeroes what a stream that ends early leaves;
    LZMA fails only where the strip is not full, so an error liblzma reports
    in the call that fills it goes unseen. Returns whether libtiff counts the
    strip decoded; what came out before a failure stays in ``out``."""
    src = ctypes.create_string_buffer(raw, len(raw))
    size = out.size
    if comp == 50000:
        return _unzstd(src, len(raw), out)
    if comp == 34925:
        lib = _stream_lib("liblzma.so.5")
        s = _LzmaStream()
        if lib.lzma_stream_decoder(ctypes.byref(s), _LZMA_MEMLIMIT, 0) != 0:
            raise MemoryError("liblzma could not start a decoder")
        try:
            s.next_in, s.avail_in = ctypes.addressof(src), len(raw)
            s.next_out, s.avail_out = out.ctypes.data, size
            while s.avail_out > 0:
                ret = lib.lzma_code(ctypes.byref(s), 0)  # LZMA_RUN
                if ret == 6:  # LZMA_MEMLIMIT_ERROR
                    raise ValueError("unsupported TIFF: an LZMA dictionary above "
                                     f"{_LZMA_MEMLIMIT >> 20} MiB")
                if ret != 0:  # LZMA_STREAM_END ends the strip, the rest fail it
                    break
            return s.avail_out == 0
        finally:
            lib.lzma_end(ctypes.byref(s))
    lib = _stream_lib("libz.so.1")
    s = _ZStream()
    if lib.inflateInit_(ctypes.byref(s), lib.zlibVersion(), ctypes.sizeof(s)) != 0:
        raise MemoryError("zlib could not start a decoder")
    try:
        s.next_in, s.avail_in = ctypes.addressof(src), len(raw)
        s.next_out, left = out.ctypes.data, size
        while left > 0:
            s.avail_out = min(left, 0xFFFFFFFF)
            before = s.avail_out
            ret = lib.inflate(ctypes.byref(s), 1)  # Z_PARTIAL_FLUSH
            left -= before - s.avail_out
            if ret == 1:  # Z_STREAM_END
                break
            if ret != 0:  # a data, buffer or dictionary error fails the strip
                return False
        if left:
            out[size - left:] = 0
            return False
        return True
    finally:
        lib.inflateEnd(ctypes.byref(s))


def _unzstd(src, n: int, out: np.ndarray) -> bool:
    """tif_zstd.c's ZSTDDecode: a stream started afresh, then
    ZSTD_decompressStream while it reports more to come and both buffers
    have room; an error, or a strip left short, fails it, and what libzstd
    has not reported written is zeroed (it may have written past that)."""
    lib = _stream_lib("libzstd.so.1")
    ds = lib.ZSTD_createDStream()
    if not ds:
        raise MemoryError("libzstd could not start a decoder")
    try:
        if lib.ZSTD_isError(lib.ZSTD_initDStream(ds)):
            raise MemoryError("libzstd could not start a decoder")
        ibuf = _ZstdBuffer(ctypes.addressof(src), n, 0)
        obuf = _ZstdBuffer(out.ctypes.data, out.size, 0)
        while True:
            ret = lib.ZSTD_decompressStream(ds, ctypes.byref(obuf), ctypes.byref(ibuf))
            if lib.ZSTD_isError(ret) or not (ret != 0 and ibuf.pos < ibuf.size
                                             and obuf.pos < obuf.size):
                out[obuf.pos:] = 0
                return obuf.pos == out.size and not lib.ZSTD_isError(ret)
    finally:
        lib.ZSTD_freeDStream(ds)


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


def _tiff_fp_accumulate(rows: np.ndarray, stride: int, bits: int) -> np.ndarray:
    """Undo the floating-point predictor (Predictor 3) as tif_predict.c's
    fpAcc does, row by row: each byte plus the one ``stride`` bytes before it
    (mod 256), then the row's planes of bytes (every sample's most
    significant byte first, then the next) put back together as native,
    little-endian, samples."""
    n, (h, size) = bits // 8, rows.shape
    acc = np.cumsum(rows.reshape(h, size // stride, stride), axis=1, dtype=np.uint8)
    planes = acc.reshape(h, n, size // n)
    return np.ascontiguousarray(planes[:, ::-1].transpose(0, 2, 1)).reshape(h, size)


def _tiff_jpeg_chunk(lib, err, raw: bytes, lt: _LibTiff, width: int, rows: int, last: bool,
                     sub, out: np.ndarray) -> None:
    """One JPEG strip or tile as libtiff's tif_jpeg.c decodes it for Pillow,
    into ``out`` (rows, width, 1 or 3), Pillow's strip buffer: the
    JPEGTables stream read first, the strip's own stream ending in a fake EOI
    (libtiff's source manager supplies one where the data runs out),
    libtiff's checks of the components and sampling factors, a last strip's
    taller frame cut to the strip, a smaller frame written into its top left
    (the rest as the buffer held it); YCbCr converted to RGB
    (JPEGCOLORMODE_RGB), other photometrics left as their components."""
    eoi = b"\xff\xd9" * 256  # what libtiff's source manager supplies past the data
    tables = lt.tables + eoi if lt.tables else b""
    hs, vs = sub
    data = raw + eoi
    if lib.qie_tiff_jpeg(tables, len(tables), data, len(data), int(lt.photo == 6), hs, vs,
                         lt.spp, width, rows, int(last), out.ctypes.data, err, len(err)) != 0:
        msg = err.value.decode()
        raise ValueError(msg if msg.startswith(("corrupt TIFF", "unsupported TIFF"))
                         else "corrupt TIFF: JPEG strip: " + msg)


class _YCbCr:
    """libtiff's TIFFYCbCrToRGB (tif_color.c) as tif_getimage.c applies it:
    tables from YCbCrCoefficients and ReferenceBlackWhite in float32 and
    16-bit fixed point, each subsampling block's one Cb and Cr on each of its
    luma samples (no interpolation)."""

    def __init__(self, lt: _LibTiff):
        f32 = np.float32
        luma = list(lt.coef or (f32(0.299), f32(0.587), f32(0.114)))
        ref = list(lt.refbw or tuple(map(f32, (0, 255, 128, 255, 128, 255))))
        if not luma[1]:
            raise ValueError("corrupt TIFF: YCbCrCoefficients with a green of 0")

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
    elif mode in ("I;16", "I;12", "I"):
        v = px[..., 0]
        if v.dtype.kind == "u" and v.dtype.itemsize == 4:  # mode I is signed ("I;32N" too)
            v = v.astype(np.uint32).view(np.int32)
        gray = np.clip(v.astype(np.int64), 0, 255)
    elif mode == "F":
        f = px[..., 0].astype(np.float32)
        gray = np.where(f <= 0, 0, np.where(f >= 255, 255, np.nan_to_num(f, nan=0.0)))
        gray = gray.astype(np.float32).astype(np.int64)  # Pillow truncates
    elif mode == "LAB":
        return lab_to_rgb(px)
    elif mode == "P":
        # Pillow's palette: each value's high byte (a BYTE field's values are 0)
        cmap = np.asarray(list(t.tags[320][1]), np.int64) // 256
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
        elif mode == "CMYK":
            return _cmyk_rgb(v)
        return np.ascontiguousarray(np.clip(v[..., :3], 0, 255).astype(np.uint8))
    return np.repeat(np.asarray(gray, np.uint8)[..., None], 3, axis=2)


# ---------------------------------------------------------------------------
# The plain raster formats: Pillow's plugins' headers and modes here, their
# run-length codings in raster.cc
# ---------------------------------------------------------------------------


class _NotThisFormat(Exception):
    """A plugin's ``_open`` failed the way ``Image.open`` passes over: with
    SyntaxError, IndexError, TypeError, KeyError, EOFError or struct.error,
    or with no mode or no pixels (ImageFile's own check). Pillow tries the
    next plugin; so does :func:`decode`."""


class _Cursor:
    """A position in the file, read as a plugin reads its file object:
    short at the end, and free to stand past it."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n] if n >= 0 else self.data[self.pos:]
        self.pos += len(b)
        return b


def _u16(e: str, b: bytes, at: int = 0) -> int:
    return struct.unpack_from(e + "H", b, at)[0]


def _u32(e: str, b: bytes, at: int = 0) -> int:
    return struct.unpack_from(e + "I", b, at)[0]


def _bomb(fmt: str, w: int, h: int) -> None:
    """Image.open's decompression-bomb check, after the plugin opened."""
    if w * h > MAX_PIXELS:
        raise ValueError(f"unsupported {fmt}: {w}x{h} pixels exceed the "
                         f"decompression-bomb limit")


def _gray(g: np.ndarray) -> np.ndarray:
    return np.repeat(np.asarray(g, np.uint8)[..., None], 3, axis=2)


def _float_gray(f: np.ndarray) -> np.ndarray:
    """Mode F's ``convert("RGB")``: clipped to 0..255, NaN to 0, truncated."""
    f = f.astype(np.float32)
    g = np.where(f <= 0, 0, np.where(f >= 255, 255, np.nan_to_num(f, nan=0.0)))
    return _gray(g.astype(np.float32).astype(np.int64))


def _cmyk_rgb(v: np.ndarray) -> np.ndarray:
    """Pillow's cmyk2rgb (not inverted): each of C, M, Y against 255 - K."""
    v = v.astype(np.int64)
    nk = 255 - v[..., 3:4]
    t = v[..., :3] * nk + 128
    return np.ascontiguousarray((nk - (((t >> 8) + t) >> 8)).astype(np.uint8))


def _rows(fmt: str, data: bytes, offset: int, rows: int, row_bytes: int,
          stride: Optional[int] = None) -> np.ndarray:
    """Pillow's raw decoder on rows ``stride`` bytes apart (packed end to
    end by default): (rows, row_bytes), or a truncated file's error; the
    last row needs none of its padding."""
    stride = row_bytes if stride is None else stride
    if offset + max(rows - 1, 0) * stride + (row_bytes if rows > 0 else 0) > len(data):
        raise ValueError(f"truncated {fmt}: the pixel rows end early")
    return np.lib.stride_tricks.as_strided(
        np.frombuffer(data, np.uint8, len(data) - offset, offset), (rows, row_bytes), (stride, 1))


def _bits(rows: np.ndarray, w: int) -> np.ndarray:
    """Packed 1-bit samples, most significant first → (rows, w) of 0 and 1."""
    return np.unpackbits(rows, axis=1)[:, :w]


def _raster(name: str, *args) -> None:
    """A raster.cc entry point; its error as a ValueError."""
    err = _err()
    if getattr(library(), f"qie_{name}")(*args, err, len(err)) != 0:
        raise ValueError(err.value.decode())


# --- PPM, PGM, PBM, PFM (PpmImagePlugin) -----------------------------------

_PPM_WHITESPACE = b" \t\n\x0b\x0c\r"
_PPM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
              b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA",
              b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "I": 1, "F": 1, "P": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}
_SAFEBLOCK = 1 << 20  # ImageFile.SAFEBLOCK: what the plain decoders read at once


def _ppm_token(c: _Cursor) -> bytes:
    """PpmImageFile._read_token: up to 10 characters, whitespace before
    skipped, a comment (to CR or LF) dropped wherever it starts."""
    token = b""
    while len(token) <= 10:
        ch = c.read(1)
        if not ch:
            break
        if ch in _PPM_WHITESPACE:
            if not token:
                continue
            break
        if ch == b"#":
            while c.read(1) not in b"\r\n":
                pass
            continue
        token += ch
    if not token:
        raise ValueError("truncated PPM: the header ends early")
    if len(token) > 10:
        raise ValueError(f"corrupt PPM: header token {token!r} is too long")
    return token


def _ppm_number(token: bytes, kind=int):
    try:
        return kind(token)
    except ValueError:
        raise ValueError(f"corrupt PPM: header token {token!r} is not a number") from None


def _ppm_header(data: bytes) -> tuple:
    """PpmImageFile's header: (magic, mode, width, height, maxval, scale,
    the data's offset)."""
    c = _Cursor(data)
    magic = b""
    for _ in range(6):
        ch = c.read(1)
        if not ch or ch in _PPM_WHITESPACE:
            break
        magic += ch
    mode = _PPM_MODES.get(magic)
    if mode is None:
        raise _NotThisFormat("not a PPM file")
    w, h = _ppm_number(_ppm_token(c)), _ppm_number(_ppm_token(c))
    maxval = scale = None
    if mode == "F":
        scale = _ppm_number(_ppm_token(c), float)
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("corrupt PPM: a PFM scale must be finite and non-zero")
    elif mode != "1":
        maxval = _ppm_number(_ppm_token(c))
        if not 0 < maxval < 65536:
            raise ValueError(f"corrupt PPM: maxval {maxval} is not in 1..65535")
        if maxval > 255 and mode == "L":
            mode = "I"
    return magic, mode, w, h, maxval, scale, c.pos


def _open_ppm(data: bytes):
    magic, mode, w, h, maxval, scale, offset = _ppm_header(data)
    if w <= 0 or h <= 0:
        raise _NotThisFormat("a PPM of no pixels")
    _bomb("PPM", w, h)
    return lambda: _ppm_pixels(data, offset, magic in (b"P1", b"P2", b"P3"), mode, w, h,
                               maxval, scale)


def _ppm_pixels(data: bytes, offset: int, plain: bool, mode: str, w: int, h: int, maxval,
                scale) -> np.ndarray:
    bands = _BANDS[mode]
    top = 65535 if mode == "I" else 255
    if plain:
        dec = _PpmPlain(data, offset)
        if mode == "1":
            v = np.frombuffer(dec.bits(w * h), np.uint8)
            v = (v == ord("0")).astype(np.uint8) * 255
        else:
            v = dec.values(w * h * bands, maxval, top)
        if v.size < w * h * bands:
            raise ValueError("truncated PPM: the plain data ends before the image is full")
        px = v.reshape(h, w, bands)
    elif mode == "1":  # raw "1;I": a set bit is black
        px = (1 - _bits(_rows("PPM", data, offset, h, (w + 7) // 8), w))[..., None] * 255
    elif mode == "F":  # bottom-up 32-bit floats, little-endian where the scale is negative
        f = _rows("PPM", data, offset, h, 4 * w).view("<f4" if scale < 0 else ">f4")
        return _float_gray(f[::-1])
    elif maxval == 255 or (maxval == 65535 and mode == "I"):  # the raw decoder
        n = 1 if maxval == 255 else 2
        v = _rows("PPM", data, offset, h, w * bands * n)
        px = (v if n == 1 else v.view(">u2")).reshape(h, w, bands)
    else:  # PpmDecoder: whole pixels of 1 or 2 bytes a sample, scaled to 255 or 65535
        n = 1 if maxval < 256 else 2
        v = _rows("PPM", data, offset, h, w * bands * n)
        v = v.view(">u2") if n == 2 else v
        px = np.minimum(top, np.round(v / maxval * top)).astype(np.int64).reshape(h, w, bands)
    return _mode_rgb(px, mode)


def _mode_rgb(px: np.ndarray, mode: str, palette=None) -> np.ndarray:
    """(H, W, bands) samples of a Pillow mode → its ``convert("RGB")``;
    ``palette`` (N, 3) for mode P (None: Pillow's empty one, all black)."""
    if mode in ("1", "L", "LA"):
        return _gray(px[..., 0])
    if mode == "I":
        return _gray(np.clip(px[..., 0].astype(np.int64), 0, 255))
    if mode == "P":
        full = np.zeros((256, 3), np.uint8)
        if palette is not None:
            full[:len(palette)] = palette[:256]
        return full[px[..., 0].astype(np.int64)]
    if mode == "CMYK":
        return _cmyk_rgb(px)
    if mode == "LAB":
        return lab_to_rgb(px[..., :3])
    return np.ascontiguousarray(px[..., :3].astype(np.uint8))


def _comment_end(block: bytes, start: int = 0) -> int:
    """PpmPlainDecoder._find_comment_end, its sign test included."""
    a, b = block.find(b"\n", start), block.find(b"\r", start)
    return min(a, b) if a * b > 0 else max(a, b)


class _PpmPlain:
    """PpmPlainDecoder: the data read a 1 MiB block at a time, comments cut
    out of each block (a comment's end joins what stood either side), tokens
    split on whitespace and a token cut by the block's end carried on."""

    def __init__(self, data: bytes, offset: int):
        self.c, self.spans = _Cursor(data, offset), False

    def _block(self) -> bytes:
        return self.c.read(_SAFEBLOCK)

    def _uncommented(self, block: bytes) -> bytes:
        if self.spans:
            while block:
                end = _comment_end(block)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = self._block()
        self.spans = False
        while (start := block.find(b"#")) != -1:
            end = _comment_end(block, start)
            if end == -1:
                block, self.spans = block[:start], True
                break
            block = block[:start] + block[end + 1:]
        return block

    def bits(self, total: int) -> bytes:
        """P1: one character a pixel, whitespace optional; every character
        of the block that fills the image must be 0 or 1."""
        data = b""
        while len(data) != total:
            block = self._block()
            if not block:
                break
            tokens = b"".join(self._uncommented(block).split())
            bad = tokens.translate(None, b"01")
            if bad:
                raise ValueError(f"corrupt PPM: plain PBM data holds {bad[:1]!r}")
            data = (data + tokens)[:total]
        return data

    def values(self, total: int, maxval: int, top: int) -> np.ndarray:
        """P2, P3: decimal tokens of up to 10 characters, 0..maxval, each
        scaled to ``round(value / maxval * top)``."""
        out, count, half = [], 0, b""
        while count != total:
            block = self._block()
            if not block:
                if not half:
                    break
                block = b" "
            block = self._uncommented(block)
            if half:
                block, half = half + block, b""
            tokens = block.split()
            if block and not block[-1:].isspace():
                half = tokens.pop()
                if len(half) > 10:
                    raise ValueError(f"corrupt PPM: data token {half[:11]!r} is too long")
            tokens = tokens[:total - count]
            if tokens and max(map(len, tokens)) > 10:
                raise ValueError("corrupt PPM: a data token is too long")
            try:
                v = np.array([int(t) for t in tokens], np.int64)
            except ValueError:
                raise ValueError("corrupt PPM: a data token is not a number") from None
            if v.size and (v.min() < 0 or v.max() > maxval):
                raise ValueError(f"corrupt PPM: a value outside 0..{maxval}")
            out.append(np.round(v / maxval * top).astype(np.int64))
            count += v.size
        return np.concatenate(out) if out else np.zeros(0, np.int64)


# --- DIB, ICO and CUR (BmpImagePlugin's _bitmap, IcoImagePlugin, CurImagePlugin) ---

def _dib_info(data: bytes, at: int, fmt: str):
    """(width, height, pixel offset) of the DIB whose info header is at
    ``at``. The reads _bitmap makes with struct (the header's size, a
    40-byte header's three masks) pass over to the next plugin where they
    run past the file; the rest raises, as its OSErrors do."""
    hs = _u32("<", data, at)
    if hs == 40 and at + 40 <= len(data) < at + 52 and _u32("<", data, at + 16) == 3:
        raise _NotThisFormat("a DIB's bitfield masks run past the file")
    lib, err = library(), _err()
    w, h, off = ctypes.c_int(), ctypes.c_int(), ctypes.c_long()
    if lib.qie_dib_info(data, len(data), at, fmt.encode(), ctypes.byref(w), ctypes.byref(h),
                        ctypes.byref(off), err, len(err)) != 0:
        raise ValueError(err.value.decode())
    return w.value, h.value, off.value


def _dib_pixels(data: bytes, at: int, fmt: str, w: int, rows: int) -> np.ndarray:
    out = np.empty((rows, w, 3), np.uint8)
    _raster("dib_decode", data, len(data), at, fmt.encode(), rows, out.ctypes.data)
    return out


def _open_dib(data: bytes):
    w, h, _ = _dib_info(data, 0, "DIB")
    return lambda: _dib_pixels(data, 0, "DIB", w, h)


def _open_cur(data: bytes):
    """CurImageFile: the first entry, or a later one wider and taller; its
    DIB's upper half (the lower is the mask)."""
    c = _Cursor(data)
    s = c.read(6)
    m = b""
    for _ in range(_u16("<", s, 4)):
        e = c.read(16)
        if not m:
            m = e
        elif e[0] > m[0] and e[1] > m[1]:
            m = e
    if not m:
        raise _NotThisFormat("no cursors in the CUR file")
    # _bitmap seeks to the header unless its offset is 0
    at = _u32("<", m, 12) or c.pos
    w, h, _ = _dib_info(data, at, "CUR")
    if h // 2 <= 0:
        raise _NotThisFormat("a CUR image of no rows")
    _bomb("CUR", w, h // 2)
    return lambda: _dib_pixels(data, at, "CUR", w, h // 2)


def _open_ico(data: bytes):
    """IcoFile: the entries sorted by colour depth, then by area (largest
    first, a stable sort); IcoImageFile loads the first while it opens.
    A PNG entry decodes as the PNG from its offset to the file's end,
    without its orientation (the icon keeps none of the PNG's info); a DIB
    entry is its upper half, its AND mask (or a 32-bit entry's alpha
    bytes) read as Pillow reads them and then dropped with the alpha."""
    c = _Cursor(data)
    s = c.read(6)
    entries = []
    for _ in range(_u16("<", s, 4)):
        e = c.read(16)
        width, height, colors = e[0] or 256, e[1] or 256, e[2]
        bpp, size, offset = _u16("<", e, 6), _u32("<", e, 8), _u32("<", e, 12)
        depth = bpp or (colors != 0 and math.ceil(math.log(colors, 2))) or 256
        entries.append((width * height, depth, bpp, size, offset))
    entries = sorted(entries, key=lambda x: x[1])
    entries = sorted(entries, key=lambda x: x[0], reverse=True)
    if not entries:
        raise _NotThisFormat("no images in the ICO file")
    _, _, bpp, size, offset = entries[0]
    if data[offset:offset + 8] == PNG_SIGNATURE:
        px = _decode_png(data[offset:], oriented=False)
        return lambda: px
    w, full, pixels = _dib_info(data, offset, "ICO")
    h = int(full / 2)
    if h <= 0:
        raise ValueError("corrupt ICO: an image of no rows")
    if bpp == 32:  # the alpha bytes, mapped as a buffer
        if len(data) - pixels < 4 * w * h:
            raise ValueError("truncated ICO: the image's alpha bytes end early")
    else:  # the AND mask, at the entry's end, rows padded to 32 bits
        wpad = -(-w // 32) * 32
        total = int(wpad * h / 8)
        at = offset + size - total
        if at < 0:
            raise ValueError("corrupt ICO: the image's mask starts before the file")
        if len(data[at:at + total]) < (h - 1) * (wpad // 8) + (w + 7) // 8:
            raise ValueError("truncated ICO: the image's mask ends early")
    px = _dib_pixels(data, offset, "ICO", w, h)
    return lambda: px


# --- TGA (TgaImagePlugin) ---------------------------------------------------

# (image type & 7, depth) → (raw mode, bytes a pixel); others have no tile
_TGA_RAW = {(1, 8): ("P", 1), (3, 1): ("1", 0), (3, 8): ("L", 1), (3, 16): ("LA", 2),
            (2, 16): ("BGRA;15Z", 2), (2, 24): ("BGR", 3), (2, 32): ("BGRA", 4)}


def _bgr15(v: np.ndarray) -> np.ndarray:
    """Little-endian 5-5-5 pixels (B lowest) → RGB, as Pillow's BGR;15 and
    BGRA;15Z unpackers scale them (alpha dropped)."""
    v = v.astype(np.int64)
    return np.stack([((v >> 10) & 31) * 255 // 31, ((v >> 5) & 31) * 255 // 31,
                     (v & 31) * 255 // 31], -1).astype(np.uint8)


def _open_tga(data: bytes):
    s = data[:18]
    id_len, cmap_type, itype, depth, flags = s[0], s[1], s[2], s[16], s[17]
    w, h = _u16("<", s, 12), _u16("<", s, 14)
    if cmap_type not in (0, 1) or w <= 0 or h <= 0 or depth not in (1, 8, 16, 24, 32):
        raise _NotThisFormat("not a TGA file")
    if itype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif itype in (1, 9):
        mode = "P" if cmap_type else "L"
    elif itype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise _NotThisFormat("unknown TGA mode")
    orient = flags & 0x30
    c = _Cursor(data, 18)
    c.read(id_len)
    palette = map_depth = None
    if cmap_type:
        start, count, map_depth = _u16("<", s, 3), _u16("<", s, 5), s[7]
        if map_depth not in (16, 24, 32):
            raise _NotThisFormat("unknown TGA map depth")
        k = map_depth // 8
        raw = np.frombuffer(bytes(k * start) + c.read(k * count), np.uint8)
        raw = raw[:len(raw) // k * k].reshape(-1, k)
        palette = _bgr15(raw.view("<u2")[:, 0]) if k == 2 else raw[:, 2::-1]
    _bomb("TGA", w, h)
    return lambda: _tga_pixels(data, c.pos, itype, depth, mode, w, h, orient, palette,
                               map_depth)


def _tga_pixels(data, offset, itype, depth, mode, w, h, orient, palette,
                map_depth) -> np.ndarray:
    raw = _TGA_RAW.get((itype & 7, depth))
    if raw is None:
        raise ValueError(f"unsupported TGA: image type {itype} at {depth} bits a pixel")
    rawmode, k = raw
    if rawmode == "P" and mode != "P":
        raise ValueError("unsupported TGA: colour-mapped data without a colour map")
    if palette is not None:  # Pillow's putpalette: on P, and on L or LA, which become P
        if map_depth == 32 or mode not in ("P", "L", "LA"):
            raise ValueError(f"unsupported TGA: a {map_depth}-bit colour map on a {mode} image")
        if len(palette) > 256:
            raise ValueError(f"unsupported TGA: a colour map of {len(palette)} entries")
        mode = "P"
    row_bytes = (w * depth + 7) // 8
    if itype & 8:
        rows = np.empty((h, row_bytes), np.uint8)
        _raster("tga_rle", data[offset:], len(data) - offset, k, row_bytes, h,
                rows.ctypes.data)
    else:
        rows = _rows("TGA", data, offset, h, row_bytes)
    if orient in (0x00, 0x10):  # bottom-up
        rows = rows[::-1]
    if rawmode == "1":
        rgb = _gray(_bits(rows, w) * 255)
    elif rawmode == "BGRA;15Z":
        rgb = _bgr15(rows.view("<u2"))
    elif rawmode in ("BGR", "BGRA"):
        rgb = rows.reshape(h, w, k)[..., 2::-1]
    else:  # P, L, LA
        rgb = _mode_rgb(rows.reshape(h, w, k), mode, palette)
    if orient in (0x10, 0x30):  # right to left
        rgb = rgb[:, ::-1]
    return np.ascontiguousarray(rgb)


# --- PSD (PsdImagePlugin: the merged image) ---------------------------------

# (colour mode, bits) → (Pillow mode, channels)
_PSD_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
              (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
              (9, 8): ("LAB", 3)}


def _open_psd(data: bytes):
    c = _Cursor(data)
    s = c.read(26)
    if s[:4] != b"8BPS" or _u16(">", s, 4) != 1:
        raise _NotThisFormat("not a PSD file")
    bits, chans, pmode = _u16(">", s, 22), _u16(">", s, 12), _u16(">", s, 24)
    if (pmode, bits) not in _PSD_MODES:
        raise _NotThisFormat(f"PSD colour mode {pmode} at {bits} bits has no Pillow mode")
    mode, channels = _PSD_MODES[(pmode, bits)]
    if channels > chans:
        raise ValueError("corrupt PSD: not enough channels")
    if mode == "RGB" and chans == 4:
        mode, channels = "RGBA", 4
    w, h = _u32(">", s, 18), _u32(">", s, 14)
    palette = None
    size = _u32(">", c.read(4))
    if size:
        colors = c.read(size)
        if mode == "P" and size == 768:  # planar: 256 reds, then greens, then blues
            palette = np.frombuffer(colors, np.uint8).reshape(3, 256).T
    size = _u32(">", c.read(4))  # image resources
    end = c.pos + size
    while size and c.pos < end:
        if len(c.read(6)) < 6:  # the signature, then the id
            raise _NotThisFormat("a PSD image resource cut short")
        name = c.read(c.read(1)[0])
        if not len(name) & 1:
            c.read(1)
        if len(c.read(_u32(">", c.read(4)))) & 1:
            c.read(1)
    size = _u32(">", c.read(4))  # layer and mask information
    if size:
        end = c.pos + size
        if len(c.read(4)) < 4:  # the layer info's length
            raise _NotThisFormat("a PSD layer section cut short")
        c.pos = end
    comp = _u16(">", c.read(2))
    row_bytes = (w + 7) // 8 if mode == "1" else w
    offsets = []
    if comp == 0:
        offsets = [c.pos + k * w * h for k in range(channels)]
    elif comp == 1:  # each channel's rows' byte counts, then the channels
        counts = c.read(channels * h * 2)
        at = c.pos
        for k in range(channels):
            offsets.append(at)
            for y in range(h):
                at += _u16(">", counts, 2 * (k * h + y))
    if w <= 0 or h <= 0:
        raise _NotThisFormat("a PSD of no pixels")
    _bomb("PSD", w, h)
    return lambda: _psd_pixels(data, comp, offsets, mode, w, h, row_bytes, palette)


def _psd_pixels(data, comp, offsets, mode, w, h, row_bytes, palette) -> np.ndarray:
    if not offsets:
        raise ValueError(f"unsupported PSD: compression {comp}")
    planes = []
    for at in offsets:
        if comp == 0:
            planes.append(_rows("PSD", data, at, h, row_bytes))
        else:
            rows = np.empty((h, row_bytes), np.uint8)
            _raster("packbits", data[at:], max(0, len(data) - at), row_bytes, h,
                    rows.ctypes.data)
            planes.append(rows)
    if mode == "1":
        return _gray(_bits(planes[0], w) * 255)
    px = np.stack(planes, -1)
    if mode == "CMYK":  # stored inverted
        px = 255 - px
    return _mode_rgb(px, mode, palette)


# --- QOI (QoiImagePlugin) ---------------------------------------------------

def _open_qoi(data: bytes):
    if data[:4] != b"qoif" or len(data) < 13:  # the magic, size and channels
        raise _NotThisFormat("not a QOI file")
    w, h = _u32(">", data, 4), _u32(">", data, 8)
    if w <= 0 or h <= 0:
        raise _NotThisFormat("a QOI of no pixels")
    _bomb("QOI", w, h)

    def load():
        out = np.empty((h, w, 4), np.uint8)
        _raster("qoi", data[14:], max(0, len(data) - 14), w * h, out.ctypes.data)
        return np.ascontiguousarray(out[..., :3])

    return load


# --- PCX and DCX (PcxImagePlugin, DcxImagePlugin: the first page) ------------

def _open_pcx(data: bytes, at: int = 0, fmt: str = "PCX"):
    s = data[at:at + 68]
    if not (len(s) >= 2 and s[0] == 10 and s[1] in (0, 2, 3, 5)):
        raise _NotThisFormat("not a PCX file")
    x0, y0, x1, y1 = struct.unpack_from("<4H", s, 4)
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise _NotThisFormat("bad PCX image size")
    version, bits, planes = s[1], s[3], s[65]
    provided = _u16("<", s, 66)
    w, h = x1 + 1 - x0, y1 + 1 - y0
    palette = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode, palette = f"P;{planes}L", np.frombuffer(s[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"  # a VGA palette (marker 12) 769 bytes before the file's end makes it P
        tail = data[max(0, len(data) - 769):][:769]
        if len(tail) == 769 and tail[0] == 12:
            pal = np.frombuffer(tail, np.uint8, 768, 1).reshape(256, 3)
            if not (pal == np.arange(256, dtype=np.uint8)[:, None]).all():
                mode, palette = "P", pal
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB;L"
    else:
        raise ValueError(f"unsupported {fmt}: version {version}, {bits} bits, "
                         f"{planes} planes")
    stride = (w * bits + 7) // 8
    if provided != stride:  # Pillow pads its own stride to even where the header's differs
        stride += stride % 2
    _bomb(fmt, w, h)
    return lambda: _pcx_pixels(data, at + 128, mode, w, h, planes * stride, palette)


def _pcx_pixels(data, offset, mode, w, h, line_bytes, palette) -> np.ndarray:
    lines = np.empty((h, line_bytes), np.uint8)
    bits = {"1": 1, "P;2L": 2, "P;4L": 4, "RGB;L": 24}.get(mode, 8)  # the raw mode's
    _raster("pcx_rle", data[offset:], max(0, len(data) - offset), line_bytes, w, bits, h,
            lines.ctypes.data)
    if mode == "1":
        return _gray(_bits(lines, w) * 255)
    if mode.startswith("P;"):  # bit planes, each (w + 7) // 8 bytes on from the last
        s = (w + 7) // 8
        idx = sum(_bits(lines[:, k * s:(k + 1) * s], w) << k for k in range(int(mode[2])))
        return palette[idx]
    if mode == "RGB;L":  # a row's planes one after another, each w bytes
        return np.ascontiguousarray(lines[:, :3 * w].reshape(h, 3, w).transpose(0, 2, 1))
    return _mode_rgb(lines[:, :w, None], mode, palette)  # L or P


def _open_dcx(data: bytes):
    c = _Cursor(data, 4)
    offsets = []
    for _ in range(1024):
        off = _u32("<", c.read(4))
        if not off:
            break
        offsets.append(off)
    if not offsets:
        raise _NotThisFormat("a DCX file without pages")
    return _open_pcx(data, offsets[0], "DCX")


# --- SGI (SgiImagePlugin) ---------------------------------------------------

# (bytes a sample, dimension, channels) → mode
_SGI_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L",
              (1, 3, 3): "RGB", (2, 3, 3): "RGB", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA"}


def _open_sgi(data: bytes):
    s = data[:512]
    comp, bpc = s[2], s[3]
    dim, w, h, z = struct.unpack_from(">4H", s, 4)
    mode = _SGI_MODES.get((bpc, dim, z))
    if mode is None:
        raise ValueError(f"unsupported SGI: {bpc} bytes a sample, dimension {dim}, "
                         f"{z} channels")
    if w <= 0 or h <= 0:
        raise _NotThisFormat("an SGI image of no pixels")
    _bomb("SGI", w, h)
    return lambda: _sgi_pixels(data, comp, bpc, mode, w, h)


def _sgi_pixels(data, comp, bpc, mode, w, h) -> np.ndarray:
    bands = len(mode)
    if comp == 0:  # each channel's rows, bottom-up
        page = w * h * bpc
        px = np.stack([_rows("SGI", data, 512 + k * page, h, w * bpc)
                       for k in range(bands)], -1).reshape(h, w, bpc, bands)[:, :, 0]
    elif comp == 1:
        rows = np.zeros((h, w, bands, bpc), np.uint8)  # rows after an early end stay 0
        _raster("sgi_rle", data[512:], max(0, len(data) - 512), w, h, bands, bpc,
                rows.ctypes.data)
        px = rows[..., 0]
    else:
        raise ValueError(f"unsupported SGI: compression {comp}")
    return _mode_rgb(px[::-1], mode)  # 16-bit samples keep their high byte


# --- SUN (SunImagePlugin) ---------------------------------------------------

# depth → (mode, raw mode's unpacking): 1 is "1;I" (a set bit black), 4 is
# "L;4", 24 and 32 are BGR / BGRX but for type 3's RGB / RGBX
_SUN_MODES = {1: "1", 4: "L", 8: "L", 24: "RGB", 32: "RGB"}


def _open_sun(data: bytes):
    magic, w, h, depth, _, ftype, ptype, plen = struct.unpack_from(">8I", data)
    if depth not in _SUN_MODES:
        raise _NotThisFormat(f"SUN depth {depth}")
    mode = _SUN_MODES[depth]
    palette = None
    if plen:
        if plen > 1024 or ptype != 1:
            raise _NotThisFormat("an unsupported SUN palette")
        raw = data[32:32 + plen]  # planar: the reds, then the greens, then the blues
        k = len(raw) // 3
        palette = np.frombuffer(raw, np.uint8, 3 * k).reshape(3, k).T
        if mode == "L":
            mode = "P"
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise _NotThisFormat(f"SUN file type {ftype}")
    if w <= 0 or h <= 0:
        raise _NotThisFormat("a SUN image of no pixels")
    _bomb("SUN", w, h)
    return lambda: _sun_pixels(data, 32 + plen, mode, depth, ftype, w, h, palette)


def _sun_pixels(data, offset, mode, depth, ftype, w, h, palette) -> np.ndarray:
    if palette is not None and mode != "P":  # Pillow's putpalette refuses the mode
        raise ValueError(f"corrupt SUN: a colour map on a {depth}-bit image")
    if palette is not None and len(palette) > 256:
        raise ValueError(f"corrupt SUN: a colour map of {len(palette)} entries")
    row_bytes = (w * depth + 7) // 8
    if ftype == 2:  # RLE rows are not padded
        rows = np.empty((h, row_bytes), np.uint8)
        _raster("sun_rle", data[offset:], max(0, len(data) - offset), row_bytes, h,
                rows.ctypes.data)
    else:  # rows padded to 16 bits
        rows = _rows("SUN", data, offset, h, row_bytes, (w * depth + 15) // 16 * 2)
    if depth == 1:
        return _gray((1 - _bits(rows, w)) * 255)
    if depth == 4:
        px = np.stack([rows >> 4, rows & 15], -1).reshape(h, -1)[:, :w]
        return _mode_rgb(px[..., None], mode, palette) if mode == "P" else _gray(px * 17)
    if depth == 8:
        return _mode_rgb(rows[..., None], mode, palette)
    px = rows.reshape(h, w, depth // 8)[..., :3]
    return np.ascontiguousarray(px if ftype == 3 else px[..., ::-1])


# --- MSP (MspImagePlugin) ---------------------------------------------------

def _open_msp(data: bytes):
    s = data[:32]
    words = struct.unpack("<16H", s)
    if np.bitwise_xor.reduce(np.array(words)) != 0:
        raise _NotThisFormat("bad MSP checksum")
    w, h = words[2], words[3]
    if w <= 0 or h <= 0:
        raise _NotThisFormat("an MSP image of no pixels")
    _bomb("MSP", w, h)
    row_bytes = (w + 7) // 8

    def load():
        if s[:4] == b"DanM":
            rows = _rows("MSP", data, 32, h, row_bytes)
        else:  # LinS: the row map, then each row's runs
            rows = np.empty((h, row_bytes), np.uint8)
            _raster("msp_rle", data[32:], max(0, len(data) - 32), row_bytes, h,
                    rows.ctypes.data)
        return _gray(_bits(rows, w) * 255)

    return load


# --- XBM (XbmImagePlugin) ---------------------------------------------------

_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    rb"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    rb"(?P<hotspot>"
    rb"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    rb"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    rb")?"
    rb"[\000-\377]*_bits\[]")


def _open_xbm(data: bytes):
    """XbmImageFile: its header on the first 512 bytes, the bits from the
    header's end, each byte's least significant bit first, a set bit white."""
    m = _XBM_HEAD.match(data[:512])
    if not m:
        raise _NotThisFormat("not an XBM file")
    w, h, at = int(m["width"]), int(m["height"]), m.end()
    if w <= 0 or h <= 0:
        raise _NotThisFormat("an XBM image of no pixels")
    _bomb("XBM", w, h)

    def load():
        row_bytes = (w + 7) // 8
        rows = np.empty((h, row_bytes), np.uint8)
        _raster("xbm", data[at:], len(data) - at, rows.size, rows.ctypes.data)
        return _gray(np.unpackbits(rows, axis=1, bitorder="little")[:, :w] * 255)

    return load


# --- XPM (XpmImagePlugin) ---------------------------------------------------

_XPM_HEAD = re.compile(rb'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def _readline(c: _Cursor) -> bytes:
    """A file object's readline: up to and with the next newline."""
    end = c.data.find(b"\n", c.pos)
    return c.read(end + 1 - c.pos if end >= 0 else -1)


def _open_xpm(data: bytes):
    """XpmImageFile: the values line, then a colour a line (``c`` and
    ``#rrggbb`` or ``None``, the transparency key, which no pixel may use);
    over 256 colours make RGB, else P."""
    c = _Cursor(data, 9)
    while True:
        line = _readline(c)
        if not line:
            raise _NotThisFormat("broken XPM file")
        m = _XPM_HEAD.match(line)
        if m:
            break
    try:
        w, h, colours, cpp = (int(v) for v in m.groups())
    except ValueError:
        raise ValueError("corrupt XPM: a value of its header is empty") from None
    palette = {}
    for _ in range(colours):
        line = _readline(c).rstrip()
        key, s = line[1:cpp + 1], line[cpp + 1:-2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                rgb = s[i + 1]  # an IndexError passes the file on, as in Pillow
                if rgb.startswith(b"#"):
                    try:
                        v = int(rgb[1:], 16)
                    except ValueError:
                        raise ValueError(f"corrupt XPM: colour {rgb!r}") from None
                    palette[key] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
                elif rgb != b"None":
                    raise ValueError(f"unsupported XPM: colour {rgb[:20]!r}")
                break
        else:
            raise ValueError("corrupt XPM: a colour line without its colour")
    if w <= 0 or h <= 0:
        raise _NotThisFormat("an XPM image of no pixels")
    _bomb("XPM", w, h)
    return lambda: _xpm_pixels(data, c.pos, w, h, cpp, palette)


def _xpm_pixels(data, offset, w, h, cpp, palette) -> np.ndarray:
    """XpmDecoder: whole lines, their text between the first and the last
    quote, until the image is full (a "/* pixels */" line skipped once);
    every key of the lines read must be a colour's."""
    c, total, texts, header = _Cursor(data, offset), 0, [], False
    while total < w * h:
        line = _readline(c)
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        text = b'"'.join(line.split(b'"')[1:-1])
        if cpp <= 0 or len(text) % cpp:
            raise ValueError("corrupt XPM: a pixel line is not whole keys")
        texts.append(text)
        total += len(text) // cpp
    if total < w * h:
        raise ValueError("truncated XPM: not enough image data")
    keys = np.frombuffer(b"".join(texts), np.uint8).reshape(-1, cpp)
    known = np.frombuffer(b"".join(palette), np.uint8).reshape(-1, cpp)
    colours = np.array(list(palette.values()), np.uint8).reshape(-1, 3)
    if cpp <= 2:  # a table of every key
        lut = np.full(256 ** cpp, -1, np.int64)
        def code(k):
            return k[:, 0].astype(np.int64) << 8 | k[:, 1] if cpp == 2 else k[:, 0]

        lut[code(known)] = np.arange(len(known))
        at = lut[code(keys)]
        if (at < 0).any():
            raise ValueError("corrupt XPM: a pixel's key is not one of its colours")
        return np.ascontiguousarray(colours[at[:w * h]].reshape(h, w, 3))
    # wider keys compare as raw records
    keys, known = keys.copy().view(f"V{cpp}")[:, 0], known.copy().view(f"V{cpp}")[:, 0]
    order = np.argsort(known, kind="stable")
    at = np.minimum(np.searchsorted(known[order], keys), max(len(known) - 1, 0))
    if not len(known) or (known[order][at] != keys).any():
        raise ValueError("corrupt XPM: a pixel's key is not one of its colours")
    return np.ascontiguousarray(colours[order[at[:w * h]]].reshape(h, w, 3))


# --- JPEG 2000 (Jpeg2KImagePlugin over OpenJPEG 2.5.4) ---------------------
#
# Pillow opens the file in Python (_open, _parse_codestream,
# _parse_jp2_header, _parse_comment); OpenJPEG then reads it again, the JP2
# boxes and every marker segment, and decodes tile by tile
# (opj_read_tile_header / opj_decode_tile_data), each tile unpacked by
# Pillow's Jpeg2KDecode.c. The boxes, the markers and the unpacking are
# here, each tile's packets, code-blocks and wavelets in jpeg2000.cc.

_J2K_SOC_SIZ = b"\xff\x4f\xff\x51"
_J2K_MAXRES, _J2K_MAXBANDS = 33, 97
# OpenJPEG's decoder states, as its marker table lists them
_J2K_MHSIZ, _J2K_MH, _J2K_TPHSOT, _J2K_TPH, _J2K_NEOC, _J2K_EOC = 0x2, 0x4, 0x8, 0x10, 0x40, 0x100
_J2K_SOT, _J2K_SOD, _J2K_EOC_MARKER = 0xFF90, 0xFF93, 0xFFD9
# marker → the states it may come in (opj_j2k_memory_marker_handler_tab)
_J2K_MARKERS = {
    0xFF90: _J2K_MH | _J2K_TPHSOT, 0xFF52: _J2K_MH | _J2K_TPH, 0xFF53: _J2K_MH | _J2K_TPH,
    0xFF5E: _J2K_MH | _J2K_TPH, 0xFF5C: _J2K_MH | _J2K_TPH, 0xFF5D: _J2K_MH | _J2K_TPH,
    0xFF5F: _J2K_MH | _J2K_TPH, 0xFF51: _J2K_MHSIZ, 0xFF55: _J2K_MH, 0xFF57: _J2K_MH,
    0xFF58: _J2K_TPH, 0xFF60: _J2K_MH, 0xFF61: _J2K_TPH, 0xFF91: 0, 0xFF63: _J2K_MH,
    0xFF64: _J2K_MH | _J2K_TPH, 0xFF74: _J2K_MH | _J2K_TPH, 0xFF78: _J2K_MH,
    0xFF50: _J2K_MH, 0xFF59: _J2K_MH, 0xFF75: _J2K_MH | _J2K_TPH, 0xFF77: _J2K_MH | _J2K_TPH}
_J2K_UNKNOWN_STATES = _J2K_MH | _J2K_TPH
# refused by name: HTJ2K's capabilities, Part 2's multi-component transforms,
# packed packet headers
_J2K_REFUSED = {0xFF50: "HTJ2K (Part 15: the CAP marker)",
                0xFF59: "HTJ2K (Part 15: the CPF marker)",
                0xFF74: "Part 2 multi-component transforms (the MCT marker)",
                0xFF75: "Part 2 multi-component transforms (the MCC marker)",
                0xFF77: "Part 2 multi-component transforms (the MCO marker)",
                0xFF78: "Part 2 component bit depths (the CBD marker)",
                0xFF60: "packed packet headers (PPM)", 0xFF61: "packed packet headers (PPT)"}
# Pillow's unpackers: (mode, colour space, components) → how the tile unpacks
_J2K_UNPACK = {("L", "gray", 1): "gray", ("P", "srgb", 1): "gray", ("PA", "srgb", 2): "gray",
               ("I;16", "gray", 1): "i16", ("LA", "gray", 2): "gray",
               ("RGB", "gray", 1): "gray", ("RGB", "gray", 2): "gray",
               ("RGB", "srgb", 3): "rgb", ("RGB", "sycc", 3): "ycc", ("RGB", "srgb", 4): "rgb",
               ("RGB", "sycc", 4): "ycc", ("RGBA", "gray", 1): "gray",
               ("RGBA", "gray", 2): "gray", ("RGBA", "srgb", 3): "rgb",
               ("RGBA", "sycc", 3): "ycc", ("RGBA", "srgb", 4): "rgb",
               ("RGBA", "sycc", 4): "ycc", ("CMYK", "cmyk", 4): "cmyk"}
_J2K_ENUMCS = {16: "srgb", 17: "gray", 18: "sycc", 24: "eycc", 12: "cmyk"}


def _j2k_error(what: str) -> ValueError:
    return ValueError(f"corrupt JPEG2000: {what}")


class _BoxReader:
    """Jpeg2KImagePlugin.BoxReader over a cursor."""

    def __init__(self, c: _Cursor, length: int = -1):
        self.c, self.has_length, self.length, self.remaining = c, length >= 0, length, -1

    def _can_read(self, n: int) -> bool:
        if self.has_length and self.c.pos + n > self.length:
            return False
        return n <= self.remaining if self.remaining >= 0 else True

    def read(self, n: int) -> bytes:
        if not self._can_read(n):
            raise _NotThisFormat("JPEG2000: not enough data in header")
        b = self.c.read(n)
        if len(b) < n:
            raise ValueError(f"truncated JPEG2000: expected to read {n} bytes but only got "
                             f"{len(b)}")
        if self.remaining > 0:
            self.remaining -= n
        return b

    def fields(self, fmt: str):
        return struct.unpack(fmt, self.read(struct.calcsize(fmt)))

    def boxes(self) -> "_BoxReader":
        size = self.remaining
        return _BoxReader(_Cursor(self.read(size)), size)

    def has_next(self) -> bool:
        return self.c.pos + self.remaining < self.length if self.has_length else True

    def next_type(self) -> bytes:
        if self.remaining > 0:
            self.c.pos += self.remaining
        self.remaining = -1
        lbox, tbox = self.fields(">I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = self.fields(">Q")[0], 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise _NotThisFormat("JPEG2000: invalid header length")
        self.remaining = lbox - hlen
        return tbox


def _j2k_getcolor(palette: bytearray, colors: dict, mode: str, color: tuple) -> None:
    """ImagePalette.getcolor on a new palette: a colour seen before adds
    nothing; a short colour is stored as short as it is."""
    if mode == "RGB" and len(color) == 4:
        if color[3] != 255:
            raise ValueError("JPEG2000: cannot add non-opaque RGBA color to RGB palette")
        color = color[:3]
    elif mode == "RGBA" and len(color) == 3:
        color += (255,)
    if color in colors:
        return
    n = len(mode)
    index = len(palette) // n
    if index >= 256:
        raise ValueError("JPEG2000: cannot allocate more than 256 colors")
    colors[color] = index
    if index * n < len(palette):
        palette[index * n:index * n + n] = bytes(color)
    else:
        palette += bytes(color)


def _j2k_jp2_header(c: _Cursor):
    """_parse_jp2_header: (size, mode, palette (N, 3) or None)."""
    reader, header = _BoxReader(c), None
    while reader.has_next():
        tbox = reader.next_type()
        if tbox == b"jp2h":
            header = reader.boxes()
            break
        if tbox == b"ftyp":
            reader.fields(">4s")
    if header is None:
        raise ValueError("corrupt JPEG2000: no JP2 header box")
    size = mode = nc = None
    palette = None
    while header.has_next():
        tbox = header.next_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.fields(">IIHB")
            size = (width, height)
            mode = ("I;16" if nc == 1 and (bpc & 0x7F) > 8 else
                    {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode))
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.fields(">HB")
            if max(header.fields(">" + "B" * npc), default=0) <= 8:
                pmode = "RGBA" if npc == 4 else "RGB"
                raw, colors = bytearray(), {}
                for _ in range(ne):
                    _j2k_getcolor(raw, colors, pmode, header.fields(">" + "B" * npc))
                n = 4 if pmode == "RGBA" else 3
                palette = np.frombuffer(bytes(raw[:len(raw) // n * n]), np.uint8).reshape(
                    -1, n)[:, :3]
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.boxes()
            while res.has_next():
                if res.next_type() == b"resc":
                    vrcn, vrcd, hrcn, hrcd, vrce, hrce = res.fields(">HHHHBB")
                    for num, den, e in ((hrcn, hrcd, hrce), (vrcn, vrcd, vrce)):
                        if den:  # _res_to_dpi, whose float may overflow
                            try:
                                (254 * num * (10 ** e)) / (10000 * den)
                            except OverflowError as exc:
                                raise ValueError(f"corrupt JPEG2000: {exc}") from None
                    break
    if size is None or mode is None:
        raise _NotThisFormat("JPEG2000: malformed JP2 header")
    return size, mode, palette


def _j2k_comment(c: _Cursor) -> None:
    """_parse_comment's reads (its struct and index errors pass the file on)."""
    while True:
        marker = c.read(2)
        if not marker:
            return
        if marker[1] in (0x90, 0xD9):
            return
        length = _u16(">", c.read(2))
        if marker[1] == 0x64:
            return
        c.pos += length - 2


def _open_jpeg2000(data: bytes):
    """Jpeg2KImageFile._open: the raw codestream's SIZ or the JP2 header for
    the size and mode (Pillow's rules: one component is L, or I;16 above 8
    bits; two LA, three RGB, four RGBA or CMYK; a palette makes L P and LA
    PA); then OpenJPEG decodes it (:func:`_j2k_decode`)."""
    c = _Cursor(data, 4)
    palette = None
    if data[:4] == _J2K_SOC_SIZ:
        jp2 = False
        lsiz = _u16(">", c.read(2))
        siz = data[4:6] + c.read(lsiz - 2)
        _, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _, csiz = struct.unpack_from(">HHIIIIIIIIH", siz)
        size = (xsiz - xosiz, ysiz - yosiz)
        if csiz == 1:
            mode = "I;16" if (struct.unpack_from(">B", siz, 38)[0] & 0x7F) + 1 > 8 else "L"
        elif csiz in (2, 3, 4):
            mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
        else:
            raise _NotThisFormat("unable to determine J2K image mode")
        _j2k_comment(c)
    elif data[:12] == _JP2_SIGNATURE:
        jp2 = True
        c.pos = 12
        size, mode, palette = _j2k_jp2_header(c)
        if c.read(12).endswith(b"jp2c\xff\x4f\xff\x51"):
            length = _u16(">", c.read(2))
            c.pos = max(0, c.pos + length - 2)
            _j2k_comment(c)
    else:
        raise _NotThisFormat("not a JPEG 2000 file")
    if size[0] <= 0 or size[1] <= 0:
        raise _NotThisFormat("JPEG2000: a width or height of zero or less")
    _bomb("JPEG2000", *size)
    return lambda: _j2k_decode(data, jp2, mode, size, palette)


# --- OpenJPEG: the JP2 boxes (opj_jp2_read_header_procedure) ---

def _jp2_boxes(data: bytes):
    """OpenJPEG's reading of a JP2 file's boxes up to the codestream:
    (offset of the codestream, ihdr (w, h, components), colour space or
    None). Its errors are ValueErrors."""
    pos, state = 0, 0  # 1 signature, 2 file type, 4 header
    ihdr = None
    colr = {"has": False, "enumcs": 0}
    pclr = {"nch": None, "cmap": False, "cdef": False}
    while len(data) - pos >= 8:
        length, typ = struct.unpack_from(">I4s", data, pos)
        hdr = 8
        if length == 1:
            if len(data) - pos < 16:
                break
            hi, length = struct.unpack_from(">II", data, pos + 8)
            if hi:
                raise _j2k_error("a box larger than 2^32 bytes")
            hdr = 16
        elif length == 0:  # the last box
            length = len(data) - pos
            if length - 8 > 0xFFFFFFFF - 8:
                raise _j2k_error("a box larger than 2^32 bytes")
        if typ == b"jp2c":
            if not state & 4:
                raise _j2k_error("a codestream box before the JP2 header box")
            return pos + hdr, ihdr, colr["enumcs"]
        if length == 0:
            raise _j2k_error("a box of undefined size")
        if length < hdr:
            raise _j2k_error(f"an invalid box size {length}")
        body = length - hdr
        if typ in (b"jP  ", b"ftyp", b"jp2h"):
            handler = typ
        elif typ in (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap", b"cdef"):
            if not state & 4:
                if pos + length > len(data):
                    raise _j2k_error("a box past the end of the file")
                pos += length
                continue
            handler = typ
        else:
            if not state & 1:
                raise _j2k_error("the first box is not the JPEG 2000 signature box")
            if not state & 2:
                raise _j2k_error("the second box is not the file type box")
            if pos + length > len(data):
                raise _j2k_error("a box past the end of the file")
            pos += length
            continue
        if body > len(data) - pos - hdr:
            raise _j2k_error(f"a {typ.decode('latin-1')} box past the end of the file")
        box = data[pos + hdr:pos + length]
        if handler == b"jP  ":
            if state != 0:
                raise _j2k_error("the signature box is not the first box")
            if len(box) != 4 or box != b"\x0d\x0a\x87\x0a":
                raise _j2k_error("a bad signature box")
            state |= 1
        elif handler == b"ftyp":
            if state != 1:
                raise _j2k_error("the file type box is not the second box")
            if len(box) < 8 or (len(box) - 8) & 3:
                raise _j2k_error("a bad file type box")
            state |= 2
        elif handler == b"jp2h":
            if not state & 2:
                raise _j2k_error("a JP2 header box before the file type box")
            at, has_ihdr = 0, False
            while at < len(box):
                left = len(box) - at
                if left < 8:
                    raise _j2k_error("a box of less than 8 bytes in the JP2 header")
                blen, btyp = struct.unpack_from(">I4s", box, at)
                bhdr = 8
                if blen == 1:
                    if left < 16:
                        raise _j2k_error("an XL box of less than 16 bytes in the JP2 header")
                    hi, blen = struct.unpack_from(">II", box, at + 8)
                    if hi:
                        raise _j2k_error("a box larger than 2^32 bytes")
                    bhdr = 16
                if blen == 0:
                    raise _j2k_error("a box of undefined size in the JP2 header")
                if blen < bhdr or blen > left:
                    raise _j2k_error("a box length past the JP2 header")
                ihdr = _jp2_inner(btyp, box[at + bhdr:at + blen], ihdr, colr, pclr)
                has_ihdr |= btyp == b"ihdr"
                at += blen
            if not has_ihdr:
                raise _j2k_error("no ihdr box in the JP2 header")
            state |= 4
        else:  # an image header box past the JP2 header, read anyway
            ihdr = _jp2_inner(handler, box, ihdr, colr, pclr)
        pos += length
    if not state & 4:
        raise _j2k_error("no JP2 header box")
    raise ValueError("truncated JPEG2000: no codestream box")


def _jp2_inner(typ: bytes, box: bytes, ihdr, colr: dict, pclr: dict):
    """One box of the JP2 header (opj_jp2_read_ihdr, _colr, _bpcc, _pclr,
    _cmap, _cdef): the ihdr read so far."""
    if typ == b"ihdr":
        if ihdr is not None:
            return ihdr
        if len(box) != 14:
            raise _j2k_error("a bad image header box")
        h, w, nc = struct.unpack_from(">IIH", box)
        if not 1 <= nc <= 16384:
            raise _j2k_error("an invalid number of components in ihdr")
        return (w, h, nc)
    if typ == b"colr":
        if len(box) < 3:
            raise _j2k_error("a bad colour specification box")
        if colr["has"]:
            return ihdr
        meth = box[0]
        if meth == 1:
            if len(box) < 7:
                raise _j2k_error("a bad colour specification box")
            colr["enumcs"] = _u32(">", box, 3)
            colr["has"] = True
        elif meth == 2:
            colr["has"] = True
    elif typ == b"bpcc":
        if len(box) != (ihdr[2] if ihdr else 0):
            raise _j2k_error("a bad bits per component box")
    elif typ == b"pclr":
        if pclr["nch"] is not None or len(box) < 3:
            raise _j2k_error("a bad palette box")
        ne, nch = _u16(">", box), box[2]
        if not 1 <= ne <= 1024 or nch == 0 or len(box) < 3 + nch:
            raise _j2k_error("a bad palette box")
        width = sum(min(4, ((b & 0x7F) + 8) >> 3) for b in box[3:3 + nch])
        if len(box) < 3 + nch + ne * width:
            raise _j2k_error("a palette box shorter than its entries")
        pclr["nch"] = nch
    elif typ == b"cmap":
        if pclr["nch"] is None:
            raise _j2k_error("a component mapping box before the palette box")
        if pclr["cmap"] or len(box) < pclr["nch"] * 4:
            raise _j2k_error("a bad component mapping box")
        pclr["cmap"] = True
    elif typ == b"cdef":
        if pclr["cdef"] or len(box) < 2:
            raise _j2k_error("a bad channel definition box")
        n = _u16(">", box)
        if n == 0 or len(box) < 2 + n * 6:
            raise _j2k_error("a bad channel definition box")
        pclr["cdef"] = True
    return ihdr


# --- OpenJPEG: the codestream's markers (opj_j2k_read_header, _tile_header) ---

def _j2k_tccp() -> dict:
    return {"csty": 0, "numres": 0, "cblkw": 0, "cblkh": 0, "cblksty": 0, "qmfbid": 0,
            "prcw": [0] * _J2K_MAXRES, "prch": [0] * _J2K_MAXRES, "qntsty": 0, "numgbits": 0,
            "expn": [0] * _J2K_MAXBANDS, "mant": [0] * _J2K_MAXBANDS, "roishift": 0}


def _j2k_tcp(nc: int) -> dict:
    return {"csty": 0, "prg": 0, "numlayers": 0, "mct": 0, "cod": False, "pocs": [],
            "tccps": [_j2k_tccp() for _ in range(nc)]}


def _j2k_copy_tcp(tcp: dict) -> dict:
    out = dict(tcp, cod=False, pocs=list(tcp["pocs"]))
    out["tccps"] = [dict(t, prcw=list(t["prcw"]), prch=list(t["prch"]), expn=list(t["expn"]),
                         mant=list(t["mant"])) for t in tcp["tccps"]]
    return out


def _j2k_spcod(t: dict, seg: bytes) -> int:
    """opj_j2k_read_SPCod_SPCoc into ``t``: the bytes it read."""
    if len(seg) < 5:
        raise _j2k_error("a short coding style")
    t["numres"] = seg[0] + 1
    if t["numres"] > _J2K_MAXRES:
        raise _j2k_error(f"{t['numres']} resolution levels")
    t["cblkw"], t["cblkh"] = seg[1] + 2, seg[2] + 2
    if t["cblkw"] > 10 or t["cblkh"] > 10 or t["cblkw"] + t["cblkh"] > 12:
        raise _j2k_error("an invalid code-block size")
    t["cblksty"] = seg[3]
    if t["cblksty"] & 0x80:
        raise _j2k_error("mixed HT code-blocks")
    t["qmfbid"] = seg[4]
    if t["qmfbid"] > 1:
        raise _j2k_error("an invalid wavelet transformation")
    n = 5
    if t["csty"] & 1:
        if len(seg) - 5 < t["numres"]:
            raise _j2k_error("a short precinct size list")
        for i in range(t["numres"]):
            v = seg[5 + i]
            if i and (v & 0xF == 0 or v >> 4 == 0):
                raise _j2k_error("an invalid precinct size")
            t["prcw"][i], t["prch"][i] = v & 0xF, v >> 4
        n += t["numres"]
    else:
        t["prcw"][:t["numres"]] = [15] * t["numres"]
        t["prch"][:t["numres"]] = [15] * t["numres"]
    return n


def _j2k_sqcd(t: dict, seg: bytes) -> int:
    """opj_j2k_read_SQcd_SQcc into ``t``: the bytes it read."""
    if len(seg) < 1:
        raise _j2k_error("a short quantization marker")
    t["qntsty"], t["numgbits"] = seg[0] & 0x1F, seg[0] >> 5
    size = len(seg) - 1
    nb = 1 if t["qntsty"] == 1 else (size if t["qntsty"] == 0 else size // 2)
    if t["qntsty"] == 0:
        if size < nb:
            raise _j2k_error("a short quantization marker")
        for b in range(min(nb, _J2K_MAXBANDS)):
            t["expn"][b], t["mant"][b] = seg[1 + b] >> 3, 0
        read = 1 + nb
    else:
        if size < 2 * nb:
            raise _j2k_error("a short quantization marker")
        for b in range(min(nb, _J2K_MAXBANDS)):
            v = _u16(">", seg, 1 + 2 * b)
            t["expn"][b], t["mant"][b] = v >> 11, v & 0x7FF
        read = 1 + 2 * nb
    if t["qntsty"] == 1:  # scalar derived: the other bands' exponents from the first
        for b in range(1, _J2K_MAXBANDS):
            t["expn"][b] = max(t["expn"][0] - (b - 1) // 3, 0)
            t["mant"][b] = t["mant"][0]
    return read


class _J2kHeader:
    """What OpenJPEG has read of a codestream: the image (SIZ), the tile
    grid, the default coding parameters (the main header's COD, COC, QCD,
    QCC, RGN, POC), and the tile-parts' walk (:meth:`tiles`)."""

    def __init__(self, data: bytes, start: int, ihdr):
        self.data, self.pos, self.ihdr = data, start, ihdr
        self.state = _J2K_MHSIZ
        marker = self._marker_id()
        if marker != 0xFF4F:
            raise _j2k_error("no SOC marker")
        marker = self._marker_id()
        has = set()
        while marker != _J2K_SOT:
            if marker < 0xFF00:
                raise _j2k_error(f"a marker ID expected, not {marker:#x}")
            if marker not in _J2K_MARKERS:
                marker = self._unknown()
                if marker == _J2K_SOT:
                    break
            if marker in _J2K_REFUSED:
                raise _Refused("JPEG2000", _J2K_REFUSED[marker])
            has.add(marker)
            if not self.state & _J2K_MARKERS[marker]:
                raise _j2k_error(f"marker {marker:#x} out of place")
            self._segment(marker, self._segment_bytes())
            marker = self._marker_id()
        for m, name in ((0xFF51, "SIZ"), (0xFF52, "COD"), (0xFF5C, "QCD")):
            if m not in has:
                raise _j2k_error(f"no {name} marker in the main header")
        self.state = _J2K_TPHSOT

    # the stream
    def _left(self) -> int:
        return len(self.data) - self.pos

    def _take(self, n: int) -> bytes:
        if n > self._left():
            raise ValueError("truncated JPEG2000: the stream ends early")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def _marker_id(self) -> int:
        return _u16(">", self._take(2))

    def _segment_bytes(self) -> bytes:
        size = self._marker_id()
        if size < 2:
            raise _j2k_error("an invalid marker size")
        return self._take(size - 2)

    def _unknown(self) -> int:
        """opj_j2k_read_unk: the next known marker, two bytes at a time."""
        while True:
            m = self._marker_id()
            if m >= 0xFF00:
                states = _J2K_MARKERS.get(m, _J2K_UNKNOWN_STATES)
                if not self.state & states:
                    raise _j2k_error(f"marker {m:#x} out of place")
                if m in _J2K_MARKERS:
                    return m

    def _tcp(self) -> dict:
        if self.state != _J2K_TPH:
            return self.default
        return self._tile_tcp(self.tile)

    def _tile_tcp(self, tile: int) -> dict:
        """The tile's coding parameters: a copy of the main header's, made
        the first time the tile needs one of its own."""
        tcp = self.tcps.get(tile)
        if tcp is None:
            tcp = self.tcps[tile] = _j2k_copy_tcp(self.default)
        return tcp

    def _segment(self, marker: int, seg: bytes) -> None:
        if marker == 0xFF51:
            self._siz(seg)
            self.state = _J2K_MH
            return
        nc = len(self.comps)
        room = 1 if nc <= 256 else 2
        tcp = self._tcp() if marker != 0xFF90 else None
        if marker == 0xFF52:  # COD
            if len(seg) < 5:
                raise _j2k_error("a short COD marker")
            if tcp["cod"]:
                raise _j2k_error("a second COD marker")
            tcp["cod"] = True
            csty, prg, layers, mct = seg[0], seg[1], _u16(">", seg, 2), seg[4]
            if csty & ~0x7:
                raise _j2k_error("an unknown Scod value")
            tcp["csty"], tcp["prg"] = csty, prg if prg <= 4 else -1
            if layers < 1:
                raise _j2k_error("no quality layers")
            if mct > 1:
                raise _j2k_error("an invalid multiple component transformation")
            tcp["numlayers"], tcp["mct"] = layers, mct
            for t in tcp["tccps"]:
                t["csty"] = csty & 1
            if 5 + _j2k_spcod(tcp["tccps"][0], seg[5:]) != len(seg):
                raise _j2k_error("a COD marker of the wrong size")
            ref = tcp["tccps"][0]
            for t in tcp["tccps"][1:]:
                for k in ("numres", "cblkw", "cblkh", "cblksty", "qmfbid"):
                    t[k] = ref[k]
                t["prcw"][:ref["numres"]] = ref["prcw"][:ref["numres"]]
                t["prch"][:ref["numres"]] = ref["prch"][:ref["numres"]]
        elif marker == 0xFF53:  # COC
            if len(seg) < room + 1:
                raise _j2k_error("a short COC marker")
            comp = seg[0] if room == 1 else _u16(">", seg)
            if comp >= nc:
                raise _j2k_error("a COC marker for a component past the image's")
            t = tcp["tccps"][comp]
            t["csty"] = seg[room]
            if room + 1 + _j2k_spcod(t, seg[room + 1:]) != len(seg):
                raise _j2k_error("a COC marker of the wrong size")
        elif marker == 0xFF5C:  # QCD
            if _j2k_sqcd(tcp["tccps"][0], seg) != len(seg):
                raise _j2k_error("a QCD marker of the wrong size")
            ref = tcp["tccps"][0]
            for t in tcp["tccps"][1:]:
                t["qntsty"], t["numgbits"] = ref["qntsty"], ref["numgbits"]
                t["expn"], t["mant"] = list(ref["expn"]), list(ref["mant"])
        elif marker == 0xFF5D:  # QCC
            if len(seg) < room:
                raise _j2k_error("a short QCC marker")
            comp = seg[0] if room == 1 else _u16(">", seg)
            if comp >= nc:
                raise _j2k_error("a QCC marker for a component past the image's")
            if room + _j2k_sqcd(tcp["tccps"][comp], seg[room:]) != len(seg):
                raise _j2k_error("a QCC marker of the wrong size")
        elif marker == 0xFF5E:  # RGN
            if len(seg) != 2 + room:
                raise _j2k_error("a bad RGN marker")
            comp = seg[0] if room == 1 else _u16(">", seg)
            if comp >= nc:
                raise _j2k_error("an RGN marker for a component past the image's")
            tcp["tccps"][comp]["roishift"] = seg[room + 1]
        elif marker == 0xFF5F:  # POC
            chunk = 5 + 2 * room
            if len(seg) < chunk or len(seg) % chunk:
                raise _j2k_error("a bad POC marker")
            if len(tcp["pocs"]) + len(seg) // chunk >= 32:
                raise _j2k_error("too many progression order changes")
            for at in range(0, len(seg), chunk):
                e = seg[at:at + chunk]
                c0 = e[1] if room == 1 else _u16(">", e, 1)
                c1 = e[4 + room] if room == 1 else _u16(">", e, 4 + room)
                tcp["pocs"].append((e[0], c0, _u16(">", e, 1 + room), e[3 + room],
                                    min(c1, nc), e[4 + 2 * room]))
        elif marker == 0xFF57:  # PLM
            if len(seg) < 1:
                raise _j2k_error("a bad PLM marker")
        elif marker == 0xFF58:  # PLT
            if len(seg) < 1:
                raise _j2k_error("a bad PLT marker")
            plen = 0
            for b in seg[1:]:
                plen = ((plen | (b & 0x7F)) << 7) if b & 0x80 else 0
            if plen:
                raise _j2k_error("a bad PLT marker")
        elif marker == 0xFF63:  # CRG
            if len(seg) != nc * 4:
                raise _j2k_error("a bad CRG marker")
        elif marker == 0xFF90:
            self._sot(seg)

    def _siz(self, seg: bytes) -> None:
        """opj_j2k_read_siz."""
        if len(seg) < 36 or (len(seg) - 36) % 3:
            raise _j2k_error("a bad SIZ marker")
        (self.rsiz, x1, y1, x0, y0, self.tdx, self.tdy, self.ttx0, self.tty0,
         nc) = struct.unpack_from(">HIIIIIIIIH", seg)
        if nc >= 16385 or nc != (len(seg) - 36) // 3 or nc == 0:
            raise _j2k_error("a bad number of components")
        if x0 >= x1 or y0 >= y1:
            raise _j2k_error("a negative or zero image size")
        if self.tdx == 0 or self.tdy == 0:
            raise _j2k_error("a zero tile size")
        if (self.ttx0 > x0 or self.tty0 > y0 or min(self.ttx0 + self.tdx, 0xFFFFFFFF) <= x0
                or min(self.tty0 + self.tdy, 0xFFFFFFFF) <= y0):
            raise _j2k_error("an illegal tile offset")
        if self.ihdr is not None and self.ihdr[0] > 0 and self.ihdr[1] > 0 and (
                self.ihdr[0] != x1 - x0 or self.ihdr[1] != y1 - y0):
            raise _j2k_error("the ihdr box's size is not SIZ's")
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.comps = []
        for i in range(nc):
            ssiz, dx, dy = seg[36 + 3 * i:39 + 3 * i]
            prec, sgnd = (ssiz & 0x7F) + 1, ssiz >> 7
            if not (1 <= dx <= 255 and 1 <= dy <= 255):
                raise _j2k_error("an invalid component subsampling")
            if prec > 31:
                raise _j2k_error(f"a {prec}-bit component")
            self.comps.append((prec, sgnd, dx, dy))
        self.tw = -(-(x1 - self.ttx0) // self.tdx)
        self.th = -(-(y1 - self.tty0) // self.tdy)
        if self.tw == 0 or self.th == 0 or self.tw > 65535 // self.th:
            raise _j2k_error(f"{self.tw} x {self.th} tiles")
        self.subsampled = any(dx != 1 or dy != 1 for _, _, dx, dy in self.comps)
        self.default = _j2k_tcp(nc)

    # --- tile-parts ---
    def _sot(self, seg: bytes) -> None:
        """opj_j2k_read_sot."""
        if len(seg) != 8:
            raise _j2k_error("a bad SOT marker")
        tile, psot, part, nparts = struct.unpack(">HIBB", seg)
        if tile >= self.tw * self.th:
            raise _j2k_error(f"tile {tile} of {self.tw * self.th}")
        tp = self.parts.setdefault(tile, {"current": -1, "count": 0})
        if tp["current"] + 1 != part:
            raise _j2k_error(f"tile {tile}'s part {part}, not {tp['current'] + 1}")
        tp["current"] += 1
        if psot and psot < 14 and psot != 12:
            raise _j2k_error(f"a tile-part length of {psot}")
        self.last_part = psot == 0
        if tp["count"] and part >= tp["count"]:
            raise _j2k_error("a tile-part past its tile's count")
        if nparts:
            if part >= nparts:
                raise _j2k_error("a tile-part past its tile's count")
            tp["count"] = nparts
        if tp["count"] and tp["count"] == part + 1:
            self.can_decode = True
        self.sot_length = 0 if self.last_part else psot - 12
        self.tile = tile
        self.state = _J2K_TPH

    def _sod(self) -> None:
        """opj_j2k_read_sod (strict): the tile-part's bytes onto its tile's."""
        if self.last_part:
            n = self._left() - 2
            if n < 0:
                raise ValueError("truncated JPEG2000: a tile-part runs past the stream")
        else:
            n = self.sot_length - 2 if self.sot_length >= 2 else 0
        if n:
            if n > self._left():
                raise ValueError("truncated JPEG2000: a tile-part runs past the stream")
            self.tdata.setdefault(self.tile, []).append(self.data[self.pos:self.pos + n])
            self.pos += n
        self.state = _J2K_TPHSOT

    def tiles(self):
        """opj_read_tile_header then opj_decode_tile_data's tail, as Pillow
        calls them: (tile index, its coding parameters, its bytes) in the
        order OpenJPEG decodes them."""
        ntiles = self.tw * self.th
        # per tile, keyed by its index and made when a tile-part reaches it:
        # a header of a few bytes can declare 65535 tiles
        self.tcps, self.parts, self.tdata = {}, {}, {}
        self.tile, self.can_decode, self.last_part, self.sot_length = 0, False, False, 0
        marker = _J2K_SOT
        while True:
            if self.state == _J2K_EOC:
                marker = _J2K_EOC_MARKER
            elif self.state != _J2K_TPHSOT:
                raise ValueError("truncated JPEG2000: the stream does not end with EOC")
            while not self.can_decode and marker != _J2K_EOC_MARKER:
                while marker != _J2K_SOD:
                    if self._left() == 0:
                        self.state = _J2K_NEOC
                        break
                    seg = self._segment_bytes()
                    if marker in _J2K_REFUSED:
                        raise _Refused("JPEG2000", _J2K_REFUSED[marker])
                    states = _J2K_MARKERS.get(marker, _J2K_UNKNOWN_STATES)
                    if not self.state & states:
                        raise _j2k_error(f"marker {marker:#x} out of place")
                    if marker not in _J2K_MARKERS:
                        raise _j2k_error(f"an unknown marker {marker:#x} in a tile-part header")
                    if self.state == _J2K_TPH and self.sot_length:
                        if self.sot_length < len(seg) + 4:
                            raise _j2k_error("a tile-part shorter than its header")
                        self.sot_length -= len(seg) + 4
                    self._segment(marker, seg)
                    marker = self._marker_id()
                if self._left() == 0 and self.state == _J2K_NEOC:
                    break
                self._sod()
                if not self.can_decode:
                    marker = self._marker_id()
            if marker == _J2K_EOC_MARKER and self.state != _J2K_EOC:
                self.tile, self.state = 0, _J2K_EOC
            if not self.can_decode:
                while self.tile < ntiles and self.tile not in self.tdata:
                    self.tile += 1
                if self.tile == ntiles:
                    return
            t = self.tile
            if t not in self.tdata:
                raise ValueError(f"truncated JPEG2000: tile {t} has no data")
            yield t, self._tile_tcp(t), b"".join(self.tdata.pop(t))
            self.can_decode = False
            if self._left() == 0 and self.state == _J2K_NEOC:
                continue
            if self.state != _J2K_EOC:
                m = self._marker_id()
                if m == _J2K_EOC_MARKER:
                    self.tile, self.state = 0, _J2K_EOC
                elif m != _J2K_SOT:
                    if self._left() == 0:
                        self.state = _J2K_NEOC
                        continue
                    raise ValueError("truncated JPEG2000: no SOT marker after a tile")
                marker = m


def _j2k_params(h: _J2kHeader, t: int, tcp: dict):
    """The tile's rectangle and jpeg2000.cc's parameters."""
    p, q = t % h.tw, t // h.tw
    x0 = max(h.ttx0 + p * h.tdx, h.x0)
    y0 = max(h.tty0 + q * h.tdy, h.y0)
    x1 = min(h.ttx0 + (p + 1) * h.tdx, h.x1)
    y1 = min(h.tty0 + (q + 1) * h.tdy, h.y1)
    if tcp["prg"] < 0 and not tcp["pocs"]:
        raise _j2k_error("an unknown progression order")
    out = [x0, y0, x1, y1, len(h.comps), tcp["prg"], tcp["numlayers"], tcp["mct"],
           tcp["csty"], len(tcp["pocs"])]
    for (prec, sgnd, dx, dy), tc in zip(h.comps, tcp["tccps"]):
        if tc["numres"] == 0:
            raise _j2k_error("a component without a coding style")
        if tc["cblksty"] & 0x40:
            raise _Refused("JPEG2000", "HTJ2K (Part 15) code-blocks")
        out += [dx, dy, prec, sgnd, tc["numres"], tc["cblkw"], tc["cblkh"], tc["cblksty"],
                tc["qmfbid"], tc["qntsty"], tc["numgbits"], tc["roishift"]]
        out += tc["prcw"] + tc["prch"] + tc["expn"] + tc["mant"]
    for poc in tcp["pocs"]:
        out += list(poc)
    return (x0, y0, x1, y1), np.array(out, np.int32)


def _j2k_unpack(v: np.ndarray, prec: int, sgnd: int, bits: int = 8) -> np.ndarray:
    """Jpeg2KDecode.c's j2ku_shift of one component's tile: OpenJPEG's
    stored word (1, 2 or 4 bytes), plus the signed offset and the rounding
    half, shifted to ``bits`` and kept to them as Pillow's store keeps it."""
    csiz = (prec + 7) >> 3
    csiz = 4 if csiz == 3 else csiz
    x = v.view(np.uint32) if v.dtype == np.int32 else v.astype(np.uint32)
    if csiz < 4:
        x = x & np.uint32((1 << (8 * csiz)) - 1)
    shift = bits - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    x = x + np.uint32(offset)  # unsigned, wrapping as in C
    x = x >> np.uint32(-shift) if shift < 0 else x << np.uint32(shift)
    return (x & np.uint32((1 << bits) - 1)).astype(np.uint16 if bits > 8 else np.uint8)


def _j2k_ycc(ycc: np.ndarray) -> np.ndarray:
    """Pillow's ImagingConvertYCbCr2RGB (ConvertYCbCr.c's tables)."""
    i = np.arange(256) - 128
    tab = [np.trunc(k * i * 64 + 0.5).astype(np.int64) for k in (1.402, -0.34414, -0.71414,
                                                                    1.772)]
    y, cb, cr = (ycc[..., k].astype(np.int64) for k in range(3))
    rgb = np.stack([y + (tab[0][cr] >> 6), y + ((tab[1][cb] + tab[2][cr]) >> 6),
                    y + (tab[3][cb] >> 6)], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _j2k_decode(data: bytes, jp2: bool, mode: str, size, palette) -> np.ndarray:
    """Pillow's jpeg2k decoder: OpenJPEG reads the header (its colour space,
    its component count against Pillow's unpackers), then each tile is
    decoded and unpacked into the image (a tile never decoded stays 0)."""
    space = None
    ihdr = None
    start = 0
    if jp2:
        start, ihdr, enumcs = _jp2_boxes(data)
        space = _J2K_ENUMCS.get(enumcs)  # any other: unspecified, as for a codestream
    h = _J2kHeader(data, start, ihdr)
    nc = len(h.comps)
    if nc > 4:
        raise ValueError(f"unsupported JPEG2000: {nc} components in colour space "
                         f"{space or 'unspecified'}, which Pillow does not unpack")
    if space is None:  # Pillow's guess: sYCC where the first subsampled component is 1 or 2
        first = next((c for c, (_, _, dx, dy) in enumerate(h.comps) if (dx, dy) != (1, 1)), -1)
        space = "gray" if nc <= 2 else "sycc" if first in (1, 2) else "srgb"
    kind = _J2K_UNPACK.get((mode, space, nc))
    if h.subsampled and kind in ("gray", "i16"):
        kind = None  # Pillow's one- and two-component unpackers take no subsampling
    if kind is None:
        raise ValueError(f"unsupported JPEG2000: a {mode} image of {nc} components in "
                         f"colour space {space}, which Pillow does not unpack")
    lib, err = library(), _err()
    w, hgt = size
    bands = {"gray": 2 if mode in ("PA", "LA") or (mode == "RGBA" and nc == 2) else 1,
             "i16": 1, "rgb": 3, "ycc": 3, "cmyk": 4}[kind]
    img = np.zeros((hgt, w, bands), np.uint16 if kind == "i16" else np.uint8)
    resno = np.zeros(nc, np.int32)
    csiz = [4 if (prec + 7) >> 3 == 3 else (prec + 7) >> 3 for prec, _, _, _ in h.comps]
    words = {1: np.uint8, 2: np.uint16, 4: np.uint32}
    bits = 16 if kind == "i16" else 8
    for t, tcp, tile in h.tiles():
        (x0, y0, x1, y1), params = _j2k_params(h, t, tcp)
        tw, th = x1 - x0, y1 - y0
        # each component's tile, on its own grid
        dims = [(-(-x1 // dx) - -(-x0 // dx), -(-y1 // dy) - -(-y0 // dy))
                for _, _, dx, dy in h.comps]
        out = np.empty(sum(cw * ch for cw, ch in dims), np.int32)
        if lib.qie_j2k_tile(params.ctypes.data, params.size, tile, len(tile), out.ctypes.data,
                            resno.ctypes.data, err, len(err)) != 0:
            raise ValueError(err.value.decode())
        ox, oy = x0 - h.x0, y0 - h.y0
        if ox < 0 or oy < 0 or x1 - h.x0 > w or y1 - h.y0 > hgt:
            raise _j2k_error("a tile outside the image")
        region = img[oy:oy + th, ox:ox + tw]
        planes, at = [], 0
        for cw, ch in dims:
            planes.append(out[at:at + cw * ch].reshape(ch, cw))
            at += cw * ch
        if not h.subsampled and all(int(resno[c]) + 1 == tcp["tccps"][c]["numres"]
                                    for c in range(nc)):
            for b in range(bands):  # the buffer holds the planes as they are
                region[..., b] = _j2k_unpack(planes[b], *h.comps[b][:2], bits=bits)
            continue
        # OpenJPEG writes the resolution each component reached (a smaller
        # one where the highest levels had no packets), packed, each sample
        # in csiz bytes, into a zeroed buffer of the whole tile's size
        buf = np.zeros(sum(csiz) * tw * th, np.uint8)
        at = 0
        for c in range(nc):
            level = tcp["tccps"][c]["numres"] - 1 - int(resno[c])
            cx0, cy0 = -(-x0 // h.comps[c][2]), -(-y0 // h.comps[c][3])
            rw = -(-(cx0 + dims[c][0]) // (1 << level)) - -(-cx0 // (1 << level))
            rh = -(-(cy0 + dims[c][1]) // (1 << level)) - -(-cy0 // (1 << level))
            plane = planes[c][:rh, :rw].astype(np.int64) & ((1 << (8 * csiz[c])) - 1)
            raw = plane.astype(words[csiz[c]]).reshape(-1).view(np.uint8)
            buf[at:at + len(raw)] = raw
            at += len(raw)
        # Pillow reads each component as its unpacker sees it: the
        # subsampling-aware ones (3 and 4 components) rows of w // dx
        # samples, h // dy of them, sample (x // dx, y // dy) (the last
        # column or row past them reads on into what follows); the rest a
        # whole tile's plane
        at = 0
        for b in range(nc):
            dx, dy = h.comps[b][2:] if kind in ("rgb", "ycc", "cmyk") else (1, 1)
            cw, ch = tw // dx, th // dy
            if b < bands:
                flat = np.frombuffer(buf, words[csiz[b]], (len(buf) - at) // csiz[b], at)
                v = flat[(np.arange(th) // dy)[:, None] * cw + (np.arange(tw) // dx)[None]]
                region[..., b] = _j2k_unpack(v, *h.comps[b][:2], bits=bits)
            at += csiz[b] * cw * ch
    if kind == "i16":
        return _gray(np.minimum(img[..., 0], 255))
    if kind == "gray":
        if mode in ("P", "PA"):
            full = np.zeros((256, 3), np.uint8)
            if palette is not None:
                full[:min(len(palette), 256)] = palette[:256]
            return full[img[..., 0]]
        return _gray(img[..., 0])
    if kind == "ycc":
        return _j2k_ycc(img)
    if mode == "CMYK":
        return _cmyk_rgb(img)
    return np.ascontiguousarray(img[..., :3].astype(np.uint8))


# --- ICNS (IcnsImagePlugin) -------------------------------------------------

# IcnsFile.SIZES: (width, height, scale) → its members, in the order read
_ICNS_SIZES = {
    (512, 512, 2): (b"ic10",), (512, 512, 1): (b"ic09",), (256, 256, 2): (b"ic14",),
    (256, 256, 1): (b"ic08",), (128, 128, 2): (b"ic13",),
    (128, 128, 1): (b"ic07", b"it32", b"t8mk"), (64, 64, 1): (b"icp6",),
    (32, 32, 2): (b"ic12",), (48, 48, 1): (b"ih32", b"h8mk"),
    (32, 32, 1): (b"icp5", b"il32", b"l8mk"), (16, 16, 2): (b"ic11",),
    (16, 16, 1): (b"icp4", b"is32", b"s8mk")}
_ICNS_RLE = (b"it32", b"ih32", b"il32", b"is32")
_ICNS_MASKS = (b"t8mk", b"h8mk", b"l8mk", b"s8mk")
_JPEG2000_SIGNATURES = (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")
_JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"


def _open_icns(data: bytes):
    """IcnsFile's members (a later one of a type wins), the size
    ``bestsize()`` picks; its RGB member (RLE24, ``it32`` after a 4-byte
    prefix) with its mask read and dropped, or its PNG member decoded from
    its start to the file's end without the PNG's orientation (the icon
    keeps none of its info), or its JPEG 2000 member's bytes alone."""
    _, filesize = struct.unpack(">4sI", data[:8])
    members, at = {}, 8
    while at < filesize:
        sig, size = struct.unpack(">4sI", data[at:at + 8])
        if size <= 0:
            raise _NotThisFormat("invalid ICNS block header")
        members[sig] = (at + 8, size - 8)
        at += size
    sizes = [k for k, v in _ICNS_SIZES.items() if any(t in members for t in v)]
    if not sizes:
        raise _NotThisFormat("no 32-bit icon resources in the ICNS file")
    best = max(sizes)
    full = (best[0] * best[2], best[1] * best[2])
    return lambda: _icns_pixels(data, members, best, full, sizes)


def _icns_pixels(data, members, best, full, sizes) -> np.ndarray:
    rgb = png = None
    for typ in _ICNS_SIZES[best]:
        if typ not in members:
            continue
        start, length = members[typ]
        n = full[0] * full[1]
        if typ in _ICNS_MASKS:
            if len(data[start:start + n]) < n:
                raise ValueError("truncated ICNS: a mask ends early")
        elif typ in _ICNS_RLE:
            if typ == b"it32":
                if data[start:start + 4] != bytes(4):
                    raise ValueError("corrupt ICNS: an it32 member without its zero prefix")
                start, length = start + 4, length - 4
            rgb = _icns_rgb(data, start, length, full)
        else:
            sig = data[start:start + 12]
            if sig.startswith(PNG_SIGNATURE):
                png = _decode_png(data[start:], oriented=False)
            elif sig.startswith(_JPEG2000_SIGNATURES) or sig == _JP2_SIGNATURE:
                try:  # read_png_or_jpeg2000: the member's bytes alone
                    png = _open_jpeg2000(data[start:start + length])()
                except (_NotThisFormat, IndexError, struct.error) as e:
                    raise ValueError(f"corrupt ICNS: a JPEG 2000 member: {e}") from None
            else:
                raise ValueError("unsupported ICNS: an icon member that is neither PNG nor "
                                 "JPEG 2000")
    if png is not None:  # IcnsImageFile takes the PNG's size where its sizes allow it
        ph, pw = png.shape[:2]
        if not any((s[1] * s[2]) / ph == (s[0] * s[2]) // pw for s in sizes):
            raise ValueError(f"corrupt ICNS: a {pw}x{ph} PNG member is none of its sizes")
        return png
    if rgb is None:
        raise ValueError("corrupt ICNS: a mask without its image")
    return rgb


def _icns_rgb(data, start, length, size) -> np.ndarray:
    """IcnsImagePlugin.read_32: raw RGB where the member is exactly that
    long, else RLE24, the channels one after another."""
    w, h = size
    if length == w * h * 3:
        return _rows("ICNS", data, start, h, w * 3).reshape(h, w, 3)
    out = np.empty((h, w, 3), np.uint8)
    _raster("icns_rle", data[start:], max(0, len(data) - start), w * h, out.ctypes.data)
    return out


# --- DDS (DdsImagePlugin: the first surface) --------------------------------

_DDPF_ALPHAPIXELS, _DDPF_FOURCC, _DDPF_PAL8, _DDPF_RGB, _DDPF_LUMINANCE = (
    0x1, 0x4, 0x20, 0x40, 0x20000)
# FourCC → (block kind, signed)
_DDS_FOURCC = {b"DXT1": (1, 0), b"DXT3": (2, 0), b"DXT5": (3, 0), b"BC4U": (4, 0),
               b"ATI1": (4, 0), b"BC5S": (5, 1), b"BC5U": (5, 0), b"ATI2": (5, 0)}
# DXGI format → (block kind, signed), 0 for uncompressed RGBA
_DDS_DXGI = {70: (1, 0), 71: (1, 0), 73: (2, 0), 74: (2, 0), 76: (3, 0), 77: (3, 0),
             79: (4, 0), 80: (4, 0), 82: (5, 0), 83: (5, 0), 84: (5, 1), 95: (6, 0),
             96: (6, 1), 97: (7, 0), 98: (7, 0), 99: (7, 0), 27: (0, 0), 28: (0, 0),
             29: (0, 0)}


def _open_dds(data: bytes):
    """DdsImageFile: the 124-byte header, then uncompressed RGB by its masks,
    luminance (L, LA), an 8-bit palette of 1024 RGBA bytes, or blocks of a
    FourCC or of a DX10 header's DXGI format; what Pillow does not decode,
    or raises on, raises naming it. The pixels start where the header (and
    palette) ends: the first surface."""
    (hsize,) = struct.unpack("<I", data[4:8])
    if hsize != 124:
        raise ValueError(f"unsupported DDS: a header of {hsize} bytes")
    header = data[8:128]
    if len(header) != 120:
        raise ValueError(f"truncated DDS: a header of {len(header)} bytes")
    h, w = struct.unpack_from("<2I", header, 4)
    pfflags, fourcc, bitcount = struct.unpack_from("<I4sI", header, 72)
    offset, kind, sign, palette = 128, None, 0, None
    if pfflags & _DDPF_RGB:
        n = 4 if pfflags & _DDPF_ALPHAPIXELS else 3
        masks = struct.unpack_from(f"<{n}I", header, 84)[:3]
        load = lambda: _dds_rgb(data, w, h, bitcount // 8, masks)  # noqa: E731
    elif pfflags & _DDPF_LUMINANCE:
        if bitcount == 8:
            bands = 1
        elif bitcount == 16 and pfflags & _DDPF_ALPHAPIXELS:
            bands = 2
        else:
            raise ValueError(f"unsupported DDS: {bitcount}-bit luminance")
        load = lambda: _gray(_rows("DDS", data, offset, h, w * bands)[:, ::bands])  # noqa: E731
    elif pfflags & _DDPF_PAL8:
        raw = data[128:128 + 1024]
        palette = np.frombuffer(raw, np.uint8, len(raw) // 4 * 4).reshape(-1, 4)[:, :3]
        offset += len(raw)
        load = lambda: _mode_rgb(_rows("DDS", data, offset, h, w)[..., None], "P",  # noqa: E731
                                 palette)
    elif pfflags & _DDPF_FOURCC:
        if fourcc == b"DX10":
            (dxgi,) = struct.unpack("<I", data[128:132])
            offset = 148
            if dxgi not in _DDS_DXGI:
                raise ValueError(f"unsupported DDS: DXGI format {dxgi}, which Pillow does not "
                                 "implement")
            kind, sign = _DDS_DXGI[dxgi]
            if not kind:
                load = lambda: np.ascontiguousarray(  # noqa: E731
                    _rows("DDS", data, offset, h, w * 4).reshape(h, w, 4)[..., :3])
        elif fourcc in _DDS_FOURCC:
            kind, sign = _DDS_FOURCC[fourcc]
        else:
            raise ValueError(f"unsupported DDS: pixel format {fourcc!r}, which Pillow does not "
                             "implement")
        if kind:
            load = lambda: _dds_blocks(data, offset, w, h, kind, sign)  # noqa: E731
    else:
        raise ValueError(f"unsupported DDS: pixel format flags {pfflags:#x}")
    if w <= 0 or h <= 0:
        raise _NotThisFormat("a DDS of no pixels")
    _bomb("DDS", w, h)
    return load


def _dds_rgb(data: bytes, w: int, h: int, step: int, masks) -> np.ndarray:
    """DdsRgbDecoder: ``step`` bytes a pixel read as a little-endian number
    (past the file's end, zero), each mask's bits scaled to 255 and
    truncated."""
    size = max(0, len(data) - 128)
    n = min(w * h, -(-size // step)) if step else 0  # the pixels the file reaches
    px = np.frombuffer(data, np.uint8, min(size, n * step), 128)
    if px.size < n * step:  # the last pixel cut short: its missing bytes are zero
        px = np.concatenate([px, np.zeros(n * step - px.size, np.uint8)])
    low = np.zeros((w * h, 4), np.uint8)  # the masks are 32 bits: a number's low 4 bytes
    low[:n, :min(step, 4)] = px.reshape(n, step)[:, :4]
    v = low.view("<u4")[:, 0]
    out = np.zeros((w * h, 3), np.uint8)
    for k, mask in enumerate(masks):
        if mask:
            shift = (mask & -mask).bit_length() - 1
            out[:, k] = ((v & np.uint32(mask)) >> np.uint32(shift)) / (mask >> shift) * 255
    return out.reshape(h, w, 3)


def _dds_blocks(data, offset, w, h, kind, sign) -> np.ndarray:
    out = np.empty((h, w, 3), np.uint8)
    _raster("bcn", data[offset:], max(0, len(data) - offset), w, h, kind, sign,
            out.ctypes.data)
    return out


# --- the rare formats Pillow decodes ------------------------------------------
#
# Each opener follows its plugin's ``_open`` step by step (``_plugin``: what
# ``Image.open`` passes over goes on to the next format, what it lets through
# raises a ValueError naming the format), then ``Image.open``'s checks (a
# mode and pixels, the decompression-bomb limit); its loader follows the
# plugin's decoder, and whatever the decoder raises is a ValueError naming
# the format.


def _named(fmt: str, e: Exception) -> ValueError:
    if isinstance(e, ValueError) and fmt in str(e):
        return e
    return ValueError(f"corrupt {fmt}: {e}")


def _plugin(fmt: str):
    """``fmt``'s opener as ``ImageFile.__init__`` and ``ImageFile.load`` run
    a plugin: IndexError, TypeError, KeyError, EOFError and struct.error in
    ``_open`` pass the file on; anything else ``_open`` or the decoder
    raises is a ValueError naming ``fmt``."""
    def wrap(open_):
        def run(data: bytes):
            try:
                load = open_(data)
            except (IndexError, TypeError, KeyError, EOFError, struct.error) as e:
                raise _NotThisFormat(f"{fmt}: {e}") from None
            except (ValueError, OverflowError) as e:
                raise _named(fmt, e) from None

            def loaded():
                try:
                    return load()
                except (ValueError, OverflowError, EOFError, OSError, IndexError, KeyError,
                        TypeError, struct.error, zlib.error, _NotThisFormat) as e:
                    raise _named(fmt, e) from None
            return loaded
        return run
    return wrap


def _identified(fmt: str, mode: str, w, h) -> None:
    """ImageFile's check (a mode and pixels, else the next plugin), then
    Image.open's decompression-bomb check."""
    if not mode or w <= 0 or h <= 0:
        raise _NotThisFormat(f"not identified as {fmt}")
    _bomb(fmt, w, h)


# XV's fixed palette: 3 bits of red and green, 2 of blue
_XV_PALETTE = np.array([((r * 255) // 7, (g * 255) // 7, (b * 255) // 3)
                        for r in range(8) for g in range(8) for b in range(4)], np.uint8)


@_plugin("XVTHUMB")
def _open_xvthumb(data: bytes):
    """XVThumbImageFile: the magic's line, ``#`` lines, then the width and
    height; one byte a pixel into XV's palette from the next line on."""
    c = _Cursor(data, 6)
    _readline(c)
    while True:
        s = _readline(c)
        if not s:
            raise _NotThisFormat("an XV thumbnail header without its end")
        if s[0] != 35:
            break
    w, h = s.strip().split(maxsplit=2)[:2]
    w, h = int(w), int(h)
    _identified("XVTHUMB", "P", w, h)
    return lambda: _XV_PALETTE[_rows("XVTHUMB", data, c.pos, h, w)]


@_plugin("PIXAR")
def _open_pixar(data: bytes):
    """PixarImageFile: only the dumped 8-bit RGB layout (channels 14, depth
    2), its rows from byte 1024."""
    s = data[:512]
    w, h = _u16("<", s, 418), _u16("<", s, 416)
    mode = "RGB" if (_u16("<", s, 424), _u16("<", s, 426)) == (14, 2) else ""
    _identified("PIXAR", mode, w, h)
    return lambda: np.ascontiguousarray(_rows("PIXAR", data, 1024, h, 3 * w)).reshape(h, w, 3)


_MCIDAS_MODES = {1: ("L", "u1"), 2: ("I;16B", ">u2"), 4: ("I", ">i4")}


@_plugin("MCIDAS")
def _open_mcidas(data: bytes):
    """McIdasImageFile: the area directory's 64 big-endian words; 1, 2 or
    4 bytes a sample (L, I;16B, I from I;32B), the rows at the data
    offset plus the line prefix, a stride apart."""
    s = data[:256]
    if len(s) != 256:
        raise _NotThisFormat("not a McIdas area file")
    w = (0,) + struct.unpack(">64i", s)
    if w[11] not in _MCIDAS_MODES:
        raise _NotThisFormat("an unsupported McIdas format")
    mode, dtype = _MCIDAS_MODES[w[11]]
    width, height = w[10], w[9]
    offset, stride = w[34] + w[15], w[15] + w[10] * w[11] * w[14]
    _identified("MCIDAS", mode, width, height)

    def load():
        row = width * w[11]
        if not -2 ** 31 <= stride < 2 ** 31 or (stride and stride < row):
            raise ValueError(f"corrupt MCIDAS: a stride of {stride} bytes for rows of {row}")
        if offset < 0:
            raise ValueError("corrupt MCIDAS: a negative data offset")
        v = np.ascontiguousarray(_rows("MCIDAS", data, offset, height, row, stride or row))
        return _mode_rgb(v.view(dtype)[..., None], "I")
    return load


def _spider_int(f: float) -> bool:
    """SpiderImagePlugin.isInt."""
    try:
        return f - int(f) == 0
    except (ValueError, OverflowError):
        return False


def _spider_header(t) -> int:
    """isSpiderHeader: the header's length in bytes, 0 where it is none."""
    h = (99,) + t
    if not all(_spider_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    if int(h[22]) != int(h[13]) * int(h[23]):
        return 0
    return int(h[22])


@_plugin("SPIDER")
def _open_spider(data: bytes):
    """SpiderImageFile: 27 header floats, big-endian tried first; a 2-D
    image (iform 1) of 32-bit floats after the header, or a stack's first
    image after twice its length."""
    for e in (">", "<"):
        t = struct.unpack(e + "27f", data[:108])
        hdrlen = _spider_header(t)
        if hdrlen:
            break
    else:
        raise _NotThisFormat("not a valid Spider file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise _NotThisFormat("not a Spider 2D image")
    w, ht = int(h[12]), int(h[2])
    stack, number = int(h[24]), int(h[27])
    if stack == 0 and number == 0:
        offset = hdrlen
    elif stack > 0 and number == 0:
        int(h[26])  # the stack's number of images
        offset = 2 * hdrlen
    elif stack == 0 and number > 0:  # Pillow's AttributeError: no stack offset yet
        raise ValueError("unsupported SPIDER: an image of a stack, without its stack")
    else:
        raise _NotThisFormat("inconsistent stack header values")
    _identified("SPIDER", "F", w, ht)

    def load():
        if offset < 0:
            raise ValueError("corrupt SPIDER: a negative header length")
        return _float_gray(np.ascontiguousarray(_rows("SPIDER", data, offset, ht, 4 * w))
                           .view(e + "f4"))
    return load


_FITS_MODES = {8: ("L", "u1"), 16: ("I;16", "<u2"), 32: ("I", "<i4"), -32: ("F", "<f4"),
               -64: ("F", "<f4")}


def _fits_size(headers: dict, prefix: bytes):
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _fits_parse(headers: dict):
    """FitsImageFile._parse_headers: None where the unit has no axes, else
    (gzip, the data's offset within the unit, BITPIX, size, mode)."""
    prefix, gz, offset = b"", False, 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        w, h = _fits_size(headers, prefix) or (0, 0)
        offset = w * h * (int(headers[b"BITPIX"]) // 8)
        prefix, gz = b"Z", True
    size = _fits_size(headers, prefix)
    if not size:
        return None
    bits = int(headers[prefix + b"BITPIX"])
    return gz, offset, bits, size, _FITS_MODES.get(bits, ("", ""))


_GZIP_STEP = 1 << 16
_NONZERO = re.compile(rb"[^\x00]")


def _gunzip_head(data: bytes, pos: int, limit: int) -> bytes:
    """``gzip.decompress(data[pos:])[:limit]`` in bounded memory. Each
    member is inflated to its end, in steps of ``_GZIP_STEP`` bytes in and
    out, and its header, CRC and length are checked as gzip.decompress
    checks them, so a stream raises where it raises; the output past
    ``limit`` is dropped as it comes. Zeros between members are skipped."""
    view, out = memoryview(data), bytearray()
    while pos < len(data):
        if data[pos:pos + 2] != b"\x1f\x8b" or len(data) < pos + 10 or data[pos + 2] != 8:
            raise ValueError("corrupt gzip: a member without its header")
        flag, pos = data[pos + 3], pos + 10
        if flag & 4:  # FEXTRA: its length, then the field
            pos += 2 + (_u16("<", data, pos) if pos + 2 <= len(data) else len(data))
        for bit in (8, 16):  # FNAME, FCOMMENT: up to a zero byte, or the end
            if flag & bit:
                k = data.find(b"\0", pos)
                pos = len(data) if k < 0 else k + 1
        pos += 2 if flag & 2 else 0  # FHCRC, not checked
        if pos > len(data):
            raise ValueError("truncated gzip: a member's header is cut")
        do, crc, size = zlib.decompressobj(-zlib.MAX_WBITS), 0, 0
        while not do.eof:
            chunk = do.unconsumed_tail
            if not chunk:
                chunk = view[pos:pos + _GZIP_STEP]
                pos += len(chunk)
            piece = do.decompress(chunk, _GZIP_STEP)
            if not piece and not chunk:
                raise ValueError("truncated gzip: a member ends before its stream")
            crc, size = zlib.crc32(piece, crc), size + len(piece)
            out += piece[:max(0, limit - len(out))]
        pos -= len(do.unused_data)
        trailer = data[pos:pos + 8]
        if len(trailer) < 8 or struct.unpack("<II", trailer) != (crc, size & 0xFFFFFFFF):
            raise ValueError("corrupt gzip: a member's CRC or length does not match")
        found = _NONZERO.search(data, pos + 8)
        pos = found.start() if found else len(data)
    return bytes(out)


@_plugin("FITS")
def _open_fits(data: bytes):
    """FitsImageFile: 80-byte cards; the first header unit with axes sets
    the size and mode (BITPIX 8, 16, 32, -32, -64: L, I;16, I, F, F), its
    data read after the first card past the units; the raw decoder's rows
    bottom-up with the mode as raw mode (little-endian; 4-byte floats even
    at -64), or a GZIP_1 tile-compressed table's heap through gzip (all its
    members checked, only the image's bytes kept), each pixel the low bytes
    of a 4-byte word. BSCALE and BZERO are not read."""
    c, headers, in_header, parsed = _Cursor(data), {}, False, None
    while True:
        card = c.read(80)
        if not card:
            raise ValueError("truncated FITS: the file ends in its header")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_header = True
        elif headers and not in_header:
            break
        elif keyword == b"END":
            c.pos = math.ceil(c.pos / 2880) * 2880
            if not parsed:
                parsed = _fits_parse(headers)
            in_header = False
            continue
        if parsed:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE") or value != b"T"):
            raise _NotThisFormat("not a FITS file")
        headers[keyword] = value
    if not parsed:
        raise ValueError("unsupported FITS: no image data")
    gz, offset, bits, (w, h), (mode, dtype) = parsed
    offset += c.pos - 80
    _identified("FITS", mode, w, h)

    def load():
        if offset < 0:
            raise ValueError("corrupt FITS: a negative data offset")
        n = np.dtype(dtype).itemsize
        if gz:
            value = _gunzip_head(data, offset, 4 * w * h)
            if bits <= 0 or len(value) < 4 * w * h:
                raise ValueError("truncated FITS: not enough image data")
            rows = np.frombuffer(value, np.uint8, 4 * w * h).reshape(h, w, 4)[..., 4 - n:]
            rows = rows.reshape(h, w * n)
        else:
            rows = _rows("FITS", data, offset, h, w * n)
        v = np.ascontiguousarray(rows[::-1]).view(dtype)
        return _float_gray(v) if mode == "F" else _mode_rgb(v[..., None], "I")
    return load


@_plugin("GBR")
def _open_gbr(data: bytes):
    """GbrImageFile: a big-endian header (version 1, or 2 with ``GIMP`` and
    the spacing), the name, then L (depth 1) or RGBA (depth 4) samples."""
    c = _Cursor(data)
    header_size = _u32(">", c.read(4))
    if header_size < 20:
        raise _NotThisFormat("not a GIMP brush")
    version = _u32(">", c.read(4))
    if version not in (1, 2):
        raise _NotThisFormat("an unsupported GIMP brush version")
    w = _u32(">", c.read(4))
    h = _u32(">", c.read(4))
    depth = _u32(">", c.read(4))
    if w == 0 or h == 0 or depth not in (1, 4):
        raise _NotThisFormat("not a GIMP brush")
    if version == 2:
        if c.read(4) != b"GIMP":
            raise _NotThisFormat("not a GIMP brush: no GIMP magic")
        _u32(">", c.read(4))  # the spacing
    c.read(header_size - (20 if version == 1 else 28))  # the name (the rest where negative)
    _identified("GBR", "L", w, h)
    start, size = c.pos, w * h * depth

    def load():
        raw = data[start:start + size]
        if len(raw) < size:
            raise ValueError("truncated GBR: not enough image data")
        px = np.frombuffer(raw, np.uint8).reshape(h, w, depth)
        return _gray(px[..., 0]) if depth == 1 else np.ascontiguousarray(px[..., :3])
    return load


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


@_plugin("IMT")
def _open_imt(data: bytes):
    """ImtImageFile: ``key value`` lines (``*`` a comment) read through its
    100-byte buffer up to a line that starts with 0x0C; gray bytes after
    it (``pixel n8``)."""
    c = _Cursor(data)
    buffer = c.read(100)
    if b"\n" not in buffer:
        raise _NotThisFormat("not an IM Tools file")
    w = h = 0
    mode, offset = "", None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = c.read(1)
        if not s:
            break
        if s == b"\x0c":
            offset = c.pos - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += c.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            w = int(v)
        elif k == b"height":
            h = int(v)
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    _identified("IMT", mode, w, h)

    def load():
        if offset is None:
            raise ValueError("corrupt IMT: no image data after the header")
        return _gray(_rows("IMT", data, offset, h, w))
    return load


@_plugin("FTEX")
def _open_ftex(data: bytes):
    """FtexImageFile: one format's first mipmap, DXT1 (Pillow's bcn decoder:
    ``bcn.cc``'s BC1) or raw RGB."""
    c = _Cursor(data, 4)
    struct.unpack("<i", c.read(4))  # the version
    w, h = struct.unpack("<2i", c.read(8))
    _, formats = struct.unpack("<2i", c.read(8))
    if formats != 1:  # Pillow's assert
        raise ValueError(f"unsupported FTEX: {formats} formats, not one")
    kind, where = struct.unpack("<2i", c.read(8))
    if where < 0:
        raise ValueError("corrupt FTEX: a negative mipmap offset")
    c.pos = where
    (size,) = struct.unpack("<i", c.read(4))
    mip = c.read(size)  # all that is left where the size is negative
    if kind not in (0, 1):
        raise ValueError(f"unsupported FTEX: texture format {kind}")
    _identified("FTEX", "RGBA" if kind == 0 else "RGB", w, h)

    def load():
        if kind == 1:
            return np.ascontiguousarray(_rows("FTEX", mip, 0, h, 3 * w)).reshape(h, w, 3)
        if len(mip) < ((w + 3) // 4) * ((h + 3) // 4) * 8:
            raise ValueError("truncated FTEX: the DXT1 blocks end before the image is full")
        out = np.empty((h, w, 3), np.uint8)
        _raster("bcn", mip, len(mip), w, h, 1, 0, out.ctypes.data)
        return out
    return load


# IM: ImImagePlugin's OPEN table, "Image type" → (mode, raw mode)
_IM_OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
    "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"), "B2 image": ("P", "P;2"),
    "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"),
    "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"),
    "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    _IM_OPEN[f"L {_i} image"] = _IM_OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    _IM_OPEN[f"L {_i} image"] = _IM_OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
_IM_OPEN["L 32S image"] = _IM_OPEN["L*32S image"] = ("I", "I;32S")
for _i in range(2, 33):
    _IM_OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
del _i

# raw mode → (bits a pixel, planes a line or None for interleaved, dtype)
_IM_RAW = {
    "1": (1, None, "u1"), "L": (8, None, "u1"), "P": (8, None, "u1"), "P;2": (2, None, "u1"),
    "P;4": (4, None, "u1"), "LA;L": (16, 2, "u1"), "PA;L": (16, 2, "u1"),
    "RGB;L": (24, 3, "u1"), "YCbCr;L": (24, 3, "u1"), "RGBA;L": (32, 4, "u1"),
    "RGBX;L": (32, 4, "u1"), "CMYK;L": (32, 4, "u1"), "RGB": (24, None, "u1"),
    "I;16": (16, None, "<u2"), "I;16L": (16, None, "<u2"), "I;16B": (16, None, ">u2"),
    "I;32": (32, None, "<i4"), "I;32S": (32, None, "<i4"), "F;8": (8, None, "u1"),
    "F;8S": (8, None, "i1"), "F;16": (16, None, "<u2"), "F;16S": (16, None, "<i2"),
    "F;32": (32, None, "<u4"), "F;32F": (32, None, "<f4"),
}
# the (mode, raw mode) pairs Pillow has an unpacker for, of those an IM
# header can name
_IM_PAIRS = {
    ("1", "1"), ("L", "L"), ("P", "L"), ("P", "P"), ("P", "P;2"), ("P", "P;4"),
    ("LA", "LA;L"), ("PA", "PA;L"), ("RGB", "RGB"), ("RGBX", "RGB"), ("RGB", "RGB;L"),
    ("RGBX", "RGB;L"), ("RGB", "RGBA;L"), ("RGBA", "RGBA;L"), ("RGB", "RGBX;L"),
    ("RGBX", "RGBX;L"), ("CMYK", "CMYK;L"), ("YCbCr", "YCbCr;L"), ("I", "I;16"),
    ("I;16", "I;16"), ("I", "I;16B"), ("I;16", "I;16B"), ("I;16B", "I;16B"),
    ("I;16L", "I;16L"), ("I", "I;32"), ("I", "I;32S"), ("F", "F;8"), ("F", "F;8S"),
    ("F", "F;16"), ("F", "F;16S"), ("F", "F;32"), ("F", "F;32F"), ("LAB", "L"),
} | {(m, r) for m in ("RGB", "RGBA", "RGBX") for r in ("RGB;T", "RYB;T")} | {
    ("F", f"F;{n}") for n in range(2, 33)}

_IM_LINE = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = {"Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut",
            "Name", "Scale (x,y)", "Image size (x*y)", "Image type"}


def _im_number(s: str):
    """ImImagePlugin.number."""
    try:
        return int(s)
    except ValueError:
        return float(s)


@_plugin("IM")
def _open_im(data: bytes):
    """ImImageFile: ``Key: value`` lines up to a 0x00 or 0x1A (the type from
    its OPEN table, the size, ...), the data after the next 0x1A, a ``Lut``'s
    768 bytes first (a palette unless it is gray, making L or LA into P or
    PA); the first frame, its rows bottom-up. A type the table lacks is the
    mode itself, read with the raw mode L: of those, LAB (into its L band,
    a and b left zero) is a mode Pillow has."""
    mode, rawmode, size, offset, palette = _im_header(data)
    _identified("IM", mode, size[0], size[1])
    return lambda: _im_pixels(data, offset, mode, rawmode, size, palette)


def _im_header(data: bytes):
    """(mode, raw mode, size, data offset, palette or None) of an IM file."""
    if b"\n" not in data[:100]:
        raise _NotThisFormat("not an IM file")
    c, n, rawmode = _Cursor(data), 0, "L"
    info = {"Image type": "L", "Image size (x*y)": (512, 512), "File size (no of images)": 1}
    while True:
        s = c.read(1)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        s += _readline(c)
        if len(s) > 100:
            raise _NotThisFormat("not an IM file")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _IM_LINE.match(s)
        if not m:
            raise _NotThisFormat("a syntax error in an IM header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)", "Image size (x*y)"):
            v = tuple(map(_im_number, v.replace("*", ",").split(",")))
            v = v[0] if len(v) == 1 else v
        elif k == "Image type" and v in _IM_OPEN:
            v, rawmode = _IM_OPEN[v]
        info[k] = v
        n += k in _IM_TAGS
    if not n:
        raise _NotThisFormat("not an IM file")
    size, mode = info["Image size (x*y)"], info["Image type"]
    k = data.find(b"\x1a", c.pos) if s == b"\0" else c.pos - 1  # the data follows a 0x1A
    if not s or k < 0:
        raise _NotThisFormat("an IM file cut in its header")
    c.pos = k + 1
    palette = None
    if "Lut" in info:
        lut = c.read(768)
        gray = linear = True
        for i in range(256):
            if lut[i] == lut[i + 256] == lut[i + 512]:
                linear &= lut[i] == i
            else:
                gray = False
        if mode in ("L", "LA", "P", "PA") and not gray:
            mode, rawmode = ("P", "P") if mode in ("L", "P") else ("PA", "PA;L")
            palette = np.frombuffer(lut, np.uint8).reshape(3, 256).T
    if not isinstance(size, tuple):  # one number: the plugin's tile raises TypeError
        raise _NotThisFormat("an IM size of one number")
    return mode, rawmode, size, c.pos, palette


def _im_pixels(data, offset, mode, rawmode, size, palette) -> np.ndarray:
    if len(size) != 2 or not all(isinstance(v, int) for v in size):
        raise ValueError(f"unsupported IM: an image size of {size}")
    if (mode, rawmode) not in _IM_PAIRS:
        raise ValueError(f"unsupported IM: raw mode {rawmode!r} into mode {mode!r}")
    w, h = size
    if rawmode in ("RGB;T", "RYB;T"):  # three tiles: green, red, blue planes
        planes = [_rows("IM", data, offset + k * w * h, h, w) for k in range(3)]
        px = np.stack([planes[1], planes[0], planes[2]], -1)[::-1]
    elif rawmode.startswith("F;") and rawmode[2:].isdigit() and int(rawmode[2:]) not in (
            8, 16, 32):  # the bit decoder
        px = np.empty((h, w), np.float32)
        err = _err()
        if library().qie_im_bits(data[offset:], max(0, len(data) - offset), int(rawmode[2:]), w,
                                 h, px.ctypes.data, err, len(err)) != 0:
            raise ValueError(err.value.decode())
        px = px[..., None]
    else:
        bits, planes, dtype = _IM_RAW[rawmode]
        rows = _rows("IM", data, offset, h, (w * bits + 7) // 8)[::-1]
        if bits < 8:
            px = np.unpackbits(rows, axis=1).reshape(h, -1, bits)[:, :w]
            px = (px << np.arange(bits - 1, -1, -1, dtype=np.uint8)).sum(-1)
            px = (px * 255 if rawmode == "1" else px)[..., None]
        elif planes:
            px = np.ascontiguousarray(rows).reshape(h, planes, w).transpose(0, 2, 1)
        else:
            px = np.ascontiguousarray(rows).view(dtype).reshape(h, w, -1)
    return _im_rgb(px, mode, palette)


def _im_rgb(px: np.ndarray, mode: str, palette) -> np.ndarray:
    """An IM image's samples (H, W, bands) in ``mode`` → ``convert("RGB")``."""
    if mode in ("P", "PA"):
        return _mode_rgb(px, "P", palette)
    if mode == "F":
        return _float_gray(px[..., 0].astype(np.float32))
    if mode.startswith("I"):  # I, I;16, I;16L, I;16B: clipped to 0..255
        return _mode_rgb(px, "I")
    if mode == "YCbCr":
        return _j2k_ycc(px)
    if mode == "LAB":  # the L band read, a and b as Image.core.new made them
        return lab_to_rgb(np.concatenate([px, np.zeros(px.shape[:2] + (2,), np.uint8)], -1))
    return _mode_rgb(px, mode)


# BLP2's DXT1, DXT3 and DXT5 through BlpImagePlugin's Python decoders:
# 5:6:5 endpoints shifted without bit replication, integer means
def _blp_565(c: np.ndarray) -> np.ndarray:
    return np.stack([(c >> 11 & 0x1F) << 3, (c >> 5 & 0x3F) << 2, (c & 0x1F) << 3], -1)


def _blp_dxt(raw: bytes, kind: int, alpha: bool) -> np.ndarray:
    """(blocks, 16, bytes a pixel) of decode_dxt1 (kind 0), decode_dxt3 (1)
    or decode_dxt5 (2) on ``raw``'s whole blocks: RGBA, or RGB for DXT1
    without alpha."""
    size = 8 if kind == 0 else 16
    b = np.frombuffer(raw, np.uint8, len(raw) // size * size).reshape(-1, size).astype(np.int64)
    col = b[:, size - 8:]
    c0, c1 = col[:, 0] | col[:, 1] << 8, col[:, 2] | col[:, 3] << 8
    code = col[:, 4] | col[:, 5] << 8 | col[:, 6] << 16 | col[:, 7] << 24
    idx = code[:, None] >> (2 * np.arange(16)) & 3
    e0, e1 = _blp_565(c0), _blp_565(c1)
    four = (c0 > c1)[:, None] if kind == 0 else np.ones((len(b), 1), bool)
    table = np.stack([e0, e1, np.where(four, (2 * e0 + e1) // 3, (e0 + e1) // 2),
                      np.where(four, (2 * e1 + e0) // 3, 0)], 1)
    rgb = np.take_along_axis(table, idx[..., None], 1)
    if kind == 0:
        if not alpha:
            return rgb.astype(np.uint8)
        a = np.where((idx == 3) & ~four, 0, 255)
    elif kind == 1:  # 4 bits a pixel, the low nibble first
        a = ((b[:, :8, None] >> np.array([0, 4])) & 0xF).reshape(-1, 16) * 17
    else:  # two endpoints, 3-bit codes
        a0, a1 = b[:, :1], b[:, 1:2]
        ac = sum(b[:, 2 + k, None] << (8 * k) for k in range(6)) >> (3 * np.arange(16)) & 7
        a = np.where(ac == 0, a0, np.where(ac == 1, a1, np.where(
            a0 > a1, ((8 - ac) * a0 + (ac - 1) * a1) // 7, np.where(
                ac == 6, 0, np.where(ac == 7, 255, ((6 - ac) * a0 + (ac - 1) * a1) // 5)))))
    return np.concatenate([rgb, a[..., None]], -1).astype(np.uint8)


@_plugin("BLP")
def _open_blp(data: bytes):
    """BlpImageFile: BLP1 (JPEG or an 8-bit palette) or BLP2 (a palette,
    or DXT1/3/5); RGBA where the header says alpha, else RGB."""
    magic, c = data[:4], _Cursor(data, 4)
    (compression,) = struct.unpack("<i", c.read(4))
    if magic == b"BLP1":
        alpha = struct.unpack("<I", c.read(4))[0] != 0
        encoding = alpha_encoding = None
    else:
        encoding, alpha, alpha_encoding = struct.unpack("<3b", c.read(1) + c.read(1) + c.read(1))
        alpha = alpha != 0
        c.pos += 1  # the mipmap flag
    w, h = struct.unpack("<II", c.read(8))
    if magic == b"BLP1":
        (encoding,) = struct.unpack("<i", c.read(4))
    _identified("BLP", "RGBA" if alpha else "RGB", w, h)
    args = (compression, encoding, alpha, alpha_encoding)
    return lambda: (_blp1 if magic == b"BLP1" else _blp2)(data, w, h, *args)


def _safe_read(c: _Cursor, n: int) -> bytes:
    """ImageFile._safe_read: nothing for n <= 0, else n bytes or an error."""
    if n <= 0:
        return b""
    b = c.read(n)
    if len(b) < n:
        raise ValueError("truncated BLP: a read past the end of the file")
    return b


def _blp_palette(c: _Cursor) -> np.ndarray:
    """_read_palette: 256 BGRA entries → (256, 3) RGB."""
    return np.frombuffer(_safe_read(c, 1024), np.uint8).reshape(256, 4)[:, 2::-1]


def _blp_raw(flat: np.ndarray, w: int, h: int, mb: int) -> np.ndarray:
    """set_as_raw: ``mb`` bytes a pixel of the mode from the stream, RGB
    kept."""
    if flat.size < w * h * mb:
        raise ValueError("truncated BLP: not enough image data")
    return np.ascontiguousarray(flat[:w * h * mb].reshape(h, w, mb)[..., :3])


def _blp_indexed(c: _Cursor, n: int, palette: np.ndarray, w: int, h: int) -> np.ndarray:
    """_read_bgra: ``n`` index bytes into the palette (RGB, or RGBA: the
    same pixels a byte)."""
    idx = np.frombuffer(_safe_read(c, n), np.uint8)
    if idx.size < w * h:
        raise ValueError("truncated BLP: not enough image data")
    return palette[idx[:w * h]].reshape(h, w, 3)


def _blp1(data, w, h, compression, encoding, alpha, _) -> np.ndarray:
    c = _Cursor(data, 28)
    offsets = struct.unpack("<16I", _safe_read(c, 64))
    lengths = struct.unpack("<16I", _safe_read(c, 64))
    if compression == 0:  # the shared JPEG header, then mipmap 0
        (n,) = struct.unpack("<I", _safe_read(c, 4))
        jpeg = _safe_read(c, n)
        _safe_read(c, offsets[0] - c.pos)
        jpeg += _safe_read(c, lengths[0])
        if jpeg[:3] != b"\xff\xd8\xff":
            raise ValueError("corrupt BLP: mipmap 0 is not a JPEG")
        rgb = _decode_jpeg(jpeg, oriented=False, plain_cmyk=True)
        # its RGB bytes re-read as BGR at the BLP's size
        return np.ascontiguousarray(_blp_raw(rgb.reshape(-1), w, h, 3)[..., ::-1])
    if compression == 1 and encoding in (4, 5):
        return _blp_indexed(c, lengths[0], _blp_palette(c), w, h)  # no seek to the mipmap
    raise ValueError(f"unsupported BLP: BLP1 compression {compression}, encoding {encoding}")


def _blp2(data, w, h, compression, encoding, alpha, alpha_encoding) -> np.ndarray:
    c = _Cursor(data, 20)
    offsets = struct.unpack("<16I", _safe_read(c, 64))
    lengths = struct.unpack("<16I", _safe_read(c, 64))
    palette = _blp_palette(c)
    c.pos = offsets[0]
    if compression != 1:
        raise ValueError(f"unsupported BLP: BLP2 compression {compression}")
    if encoding == 1:
        return _blp_indexed(c, lengths[0], palette, w, h)
    if encoding != 2 or alpha_encoding not in (0, 1, 7):
        raise ValueError(f"unsupported BLP: BLP2 encoding {encoding}, alpha encoding "
                         f"{alpha_encoding}")
    kind = {0: 0, 1: 1, 7: 2}[alpha_encoding]
    across, down = (w + 3) // 4, (h + 3) // 4
    px = _blp_dxt(_safe_read(c, across * (8 if kind == 0 else 16) * down), kind, alpha)
    # rows of (w + 3) // 4 * 4 pixels, read w a row: sheared where w % 4
    rows = px.reshape(down, across, 4, 4, -1).transpose(0, 2, 1, 3, 4).reshape(-1)
    return _blp_raw(rows, w, h, 4 if alpha else 3)


def _fli_palette(c: _Cursor, palette: np.ndarray, shift: int) -> None:
    """FliImageFile._palette: packets of a skip and a count of RGB triples."""
    i = 0
    for _ in range(_u16("<", c.read(2))):
        s = c.read(2)
        i += s[0]
        n = s[1] or 256
        s = c.read(n * 3)
        for k in range(0, len(s), 3):
            palette[i] = (s[k] << shift, s[k + 1] << shift, s[k + 2] << shift)
            i += 1


@_plugin("FLI")
def _open_fli(data: bytes):
    """FliImageFile: the 128-byte header, the palette of the first frame's
    colour chunk (4: 8-bit, 11: 6-bit) over a gray ramp, then the first
    frame at byte 128 (even after a prefix chunk) through ``fli_pcd.cc``,
    read as ImageFile.load reads it: the frame's size a block."""
    s = data[:128]
    if not (len(s) >= 16 and _u16("<", s, 4) in (0xAF11, 0xAF12) and _u16("<", s, 14) in (0, 3)
            and s[20:22] == b"\0\0" and s[42:80] == bytes(38) and s[88:] == bytes(40)):
        raise _NotThisFormat("not an FLI/FLC file")
    frames, w, h = _u16("<", s, 6), _u16("<", s, 8), _u16("<", s, 10)
    palette = np.repeat(np.arange(256, dtype=np.int64)[:, None], 3, axis=1)
    c = _Cursor(data, 128)
    s = c.read(16)
    if _u16("<", s, 4) == 0xF100:  # a prefix chunk: the frame after it
        c.pos = 128 + _u32("<", s)
        s = c.read(16)
    if _u16("<", s, 4) == 0xF1FA:
        size = None
        for _ in range(_u16("<", s, 6)):
            if size is not None:
                c.pos = max(0, c.pos + size - 6)
            s = c.read(6)
            kind = _u16("<", s, 4)
            if kind in (4, 11):
                _fli_palette(c, palette, 2 if kind == 11 else 0)
                break
            size = _u32("<", s)
            if not size:
                break
    if frames == 0:
        raise _NotThisFormat("an FLI file of no frames")
    if not data[128:132]:
        raise _NotThisFormat("an FLI file without its first frame")
    block = _u32("<", data[128:132])
    _identified("FLI", "P", w, h)
    rgb = (palette & 0xFF).astype(np.uint8)
    return lambda: rgb[_fli_frame(data, block, w, h)]


def _fli_frame(data: bytes, block: int, w: int, h: int) -> np.ndarray:
    """ImageFile.load's loop over FliDecode: reads of ``block`` bytes joined
    to what the decoder left (``data[start:end]``), the decoder called after
    each. A call that would ask for more (fewer than 4 bytes held, or fewer
    than the frame size they give, one pad byte allowed) is not made: the
    reads go on at once to the first length that reaches it, so a small
    block costs no more calls than a large one."""
    im = np.zeros((h, w), np.uint8)
    lib, err = library(), _err()
    start = end = 128
    while True:
        if block == 0 or end >= len(data):
            raise ValueError("truncated FLI: the frame ends before its data")
        held, frame = end - start, int.from_bytes(data[start:start + 4], "little")
        k = max(1, -(-(max(4, frame - 1) - held) // block))
        if held + k * block < max(4, frame) and (held + k * block) % 2 == 0:
            k += 1  # one byte short of the frame is enough only at an odd length
        end = min(end + k * block, len(data))
        n = lib.qie_fli_frame(data[start:end], end - start, im.ctypes.data, w, h, err, len(err))
        if n == -2:
            raise ValueError(err.value.decode())
        if n < 0:
            return im
        start += n


@_plugin("PCD")
def _open_pcd(data: bytes):
    """PcdImageFile: the 768 x 512 base image (``fli_pcd.cc``: PcdDecode.c
    and the PhotoYCC unpacker), turned 90 or 270 degrees as the
    orientation byte says."""
    s = data[2048:2048 + 1539]
    if not s.startswith(b"PCD_"):
        raise _NotThisFormat("not a PCD file")
    orientation = s[1538] & 3

    def load():
        out = np.empty((512, 768, 3), np.uint8)
        base = data[96 * 2048:]
        _raster("pcd", base, len(base), out.ctypes.data)
        return np.ascontiguousarray(np.rot90(out, {1: 1, 3: -1}.get(orientation, 0)))
    return load


# the formats whose decode applies the orientation Image.open does not (a
# TIFF's load applies its own): their decode without it
_UNORIENTED = {"JPEG": _decode_jpeg, "PNG": _decode_png, "WEBP": _decode_webp}
_IPTC_RECORDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)


def _iptc_field(c: _Cursor):
    """IptcImageFile.field: (tag, size), or (None, 0) at zeros or the end."""
    s = c.read(5)
    if not s.strip(b"\x00"):
        return None, 0
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in _IPTC_RECORDS:
        raise _NotThisFormat("not an IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise ValueError("corrupt IPTC: an illegal field length")
    if size == 128:
        size = 0
    elif size > 128:
        size = _u32(">", (bytes(4) + c.read(size - 128))[-4:])
    else:
        size = _u16(">", s, 3)
    return tag, size


def _iptc_int(v) -> int:
    return _u32(">", (bytes(4) + v)[-4:])


@_plugin("IPTC")
def _open_iptc(data: bytes):
    """IptcImageFile: datasets up to the image's (8, 10); the layers (3,
    60), size (3, 20) and (3, 30), compression (3, 120: raw or JPEG) and
    band (3, 65). The image's data is reopened as a file of its own: raw
    bytes behind a P5 header, or the JPEG; one band of RGB or CMYK is that
    image, the others zero."""
    c, info = _Cursor(data), {}
    while True:
        offset = c.pos
        tag, size = _iptc_field(c)
        if not tag or tag == (8, 10):
            break
        v = c.read(size) if size else None
        if tag in info:
            info[tag] = (info[tag] if isinstance(info[tag], list) else [info[tag]]) + [v]
        else:
            info[tag] = v
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    band = None
    if layers == 1 and not component:
        mode = "L"
    else:
        mode = "RGB" if layers == 3 and component else "CMYK" if layers == 4 and component else ""
        band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
    w, h = _iptc_int(info[(3, 20)]), _iptc_int(info[(3, 30)])
    if (3, 120) not in info:
        raise ValueError("unsupported IPTC: no image compression")
    compression = _iptc_int(info[(3, 120)])
    if compression not in (1, 5):
        raise ValueError(f"unsupported IPTC: image compression {compression}")
    _identified("IPTC", mode, w, h)
    return lambda: _iptc_pixels(data, offset if tag == (8, 10) else None, compression, mode, band,
                                w, h)


def _iptc_pixels(data, offset, compression, mode, band, w, h) -> np.ndarray:
    if offset is None:
        raise ValueError("corrupt IPTC: no image record")
    c = _Cursor(data, offset)
    chunks = [b"P5\n%d %d\n255\n" % (w, h)] if compression == 1 else []
    while True:
        tag, size = _iptc_field(c)
        if tag != (8, 10):
            break
        chunks.append(c.read(size) if size > 0 else b"")
    inner = b"".join(chunks)
    fmt, load = _open(inner)
    unoriented = _UNORIENTED.get(fmt)  # Image.open of the record: no exif_transpose
    rgb = unoriented(inner, oriented=False) if unoriented else load()
    if band is None:
        # exif_transpose copies the record's image, LAB included, so its
        # convert("RGB") is the record's own
        return rgb
    # Image.merge: the record as one band of RGB or CMYK, the others zero L
    # images of its size. Another band than the first must be an L image
    # ("mode mismatch"); the first may be any image of one band, whose bytes
    # ImagingMerge takes as they are: the port takes those of L and 1 only
    planes = [np.zeros(rgb.shape[:2], np.uint8)] * len(mode)
    planes[band] = rgb[..., 0]
    record, first = _record_mode(fmt, inner), band % len(mode) == 0
    if record == "L" or (record == "1" and first):
        return _mode_rgb(np.stack(planes, -1), mode)
    if record is None or (first and (len(record) == 1 or record.startswith("I;"))):
        raise ValueError(f"unsupported IPTC: a {fmt} record of mode {record or 'unread'} as "
                         f"band {band + 1} of {mode}")
    raise ValueError(f"corrupt IPTC: a {record} record cannot be band {band + 1} of {mode}")


def _record_mode(fmt: str, data: bytes) -> Optional[str]:
    """The Pillow mode of an IPTC record that opened as ``fmt``, where the
    port reads it from the header (PPM, JPEG, PNG, TIFF, BMP, PSD, IM),
    else None."""
    if fmt == "PPM":
        return _ppm_header(data)[1]
    if fmt == "JPEG":
        return "L" if _jpeg_info(data)[2] == 1 else "RGB"
    if fmt == "PNG":
        pos = 8
        while pos + 18 <= len(data):
            n, tag = struct.unpack_from(">I4s", data, pos)
            if tag == b"IHDR":  # gray by its bit depth, the rest by the colour type
                depth, kind = data[pos + 16], data[pos + 17]
                if kind == 0:
                    return {1: "1", 16: "I;16"}.get(depth, "L")
                return {3: "P", 4: "LA", 6: "RGBA"}.get(kind, "RGB")
            pos += 12 + n
        return None
    if fmt == "TIFF":
        t = _Tiff(data)
        return _TIFF_OPEN.get((t.e, t.photo, t.sample_format, t.fill, t.bps, t.extra))
    if fmt == "PSD":
        mode, _ = _PSD_MODES[(_u16(">", data, 24), _u16(">", data, 22))]
        return "RGBA" if mode == "RGB" and _u16(">", data, 12) == 4 else mode
    if fmt == "IM":
        return _im_header(data)[0]
    if fmt == "BMP":  # a palette of Pillow's gray ramp (black and white for 2) reads as L or 1
        size = _u32("<", data, 14)
        bits = _u16("<", data, 24 if size == 12 else 28)
        if bits > 8:
            return "RGB"
        colors = (0 if size == 12 else _u32("<", data, 46)) or 1 << bits
        pad = 3 if size == 12 else 4
        pal = data[14 + size:14 + size + pad * colors]
        ramp = (0, 255) if colors == 2 else range(colors)
        if all(pal[k * pad:k * pad + 3] == bytes((v & 255,)) * 3 for k, v in enumerate(ramp)):
            return "1" if colors == 2 else "L"
        return "P"
    return None


# --- the formats Pillow opens and the port does not decode -------------------

def _refused(fmt: str, what: str):
    """The open of a format Pillow opens and the port does not decode:
    refused by name where the plugin's accept takes the file."""
    def open_(data: bytes):
        raise _Refused(fmt, what)
    return open_


def _decoded(fn):
    """A format whose magic settles it, as before the plugin order."""
    return lambda data: (lambda: fn(data))


# Image.ID's order once Image.open has run preinit, then init: (format,
# its _accept on the first 16 bytes, its open: a loader of the RGB array, or
# _NotThisFormat, IndexError or struct.error to go on to the next format)
_FORMATS = (
    ("BMP", lambda p: p[:2] == b"BM", _decoded(lambda d: _decode_rgb("bmp", d))),
    ("DIB", lambda p: _u32("<", p) in (12, 40, 52, 56, 64, 108, 124), _open_dib),
    ("GIF", lambda p: p[:6] in (b"GIF87a", b"GIF89a"), _decoded(lambda d: _decode_rgb("gif", d))),
    ("JPEG", lambda p: p[:3] == b"\xff\xd8\xff", _decoded(_decode_jpeg)),
    ("PPM", lambda p: len(p) >= 2 and p[:1] == b"P" and p[1] in b"0123456fy", _open_ppm),
    ("PNG", lambda p: p[:8] == PNG_SIGNATURE, _decoded(_decode_png)),
    ("AVIF", lambda p: p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis", b"mif1", b"msf1"),
     avif.open_avif),
    ("BLP", lambda p: p[:4] in (b"BLP1", b"BLP2"), _open_blp),
    ("BUFR", lambda p: p[:4] in (b"BUFR", b"ZCZC"), _refused("BUFR", "a stub Pillow cannot load")),
    ("CUR", lambda p: p[:4] == b"\0\0\2\0", _open_cur),
    ("PCX", lambda p: len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5), _open_pcx),
    ("DCX", lambda p: len(p) >= 4 and _u32("<", p) == 0x3ADE68B1, _open_dcx),
    ("DDS", lambda p: p[:4] == b"DDS ", _open_dds),
    ("EPS", lambda p: p[:4] == b"%!PS" or (len(p) >= 4 and _u32("<", p) == 0xC6D3D0C5),
     _refused("EPS", "PostScript, which Pillow renders with Ghostscript")),
    ("FITS", lambda p: p[:6] == b"SIMPLE", _open_fits),
    ("FLI", lambda p: len(p) >= 16 and _u16("<", p, 4) in (0xAF11, 0xAF12)
     and _u16("<", p, 14) in (0, 3), _open_fli),
    ("FTEX", lambda p: p[:4] == b"FTEX", _open_ftex),
    ("GBR", lambda p: len(p) >= 8 and _u32(">", p) >= 20 and _u32(">", p, 4) in (1, 2),
     _open_gbr),
    ("GRIB", lambda p: len(p) >= 8 and p[:4] == b"GRIB" and p[7] == 1,
     _refused("GRIB", "a stub Pillow cannot load")),
    ("HDF5", lambda p: p[:8] == b"\x89HDF\r\n\x1a\n", _refused("HDF5", "a stub Pillow cannot load")),
    ("JPEG2000", lambda p: p[:4] == b"\xff\x4f\xff\x51"
     or p[:12] == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a", _open_jpeg2000),
    ("ICNS", lambda p: p[:4] == b"icns", _open_icns),
    ("ICO", lambda p: p[:4] == b"\0\0\1\0", _open_ico),
    ("IM", lambda p: True, _open_im),
    ("IMT", lambda p: True, _open_imt),
    ("IPTC", lambda p: True, _open_iptc),
    ("MCIDAS", lambda p: p[:8] == b"\x00\x00\x00\x00\x00\x00\x00\x04", _open_mcidas),
    ("MPEG", lambda p: p[:4] == b"\x00\x00\x01\xb3", _refused("MPEG", "a stub Pillow cannot load")),
    ("TIFF", lambda p: p[:4] in _TIFF_PREFIXES, _decoded(_decode_tiff)),
    ("MSP", lambda p: p[:4] in (b"DanM", b"LinS"), _open_msp),
    ("PCD", lambda p: True, _open_pcd),
    ("PIXAR", lambda p: p[:4] == b"\200\350\000\000", _open_pixar),
    ("PSD", lambda p: p[:4] == b"8BPS", _open_psd),
    ("QOI", lambda p: p[:4] == b"qoif", _open_qoi),
    ("SGI", lambda p: len(p) >= 2 and _u16(">", p) == 474, _open_sgi),
    ("SPIDER", lambda p: True, _open_spider),
    ("SUN", lambda p: len(p) >= 4 and _u32(">", p) == 0x59A66A95, _open_sun),
    ("TGA", lambda p: True, _open_tga),
    ("WEBP", lambda p: p[:4] == b"RIFF" and p[8:12] == b"WEBP", _decoded(_decode_webp)),
    ("WMF", lambda p: p[:6] == b"\xd7\xcd\xc6\x9a\x00\x00" or p[:4] == b"\x01\x00\x00\x00",
     _refused("WMF", "Windows metafiles, which Pillow cannot load here")),
    ("XBM", lambda p: p.lstrip().startswith(b"#define"), _open_xbm),
    ("XPM", lambda p: p[:9] == b"/* XPM */", _open_xpm),
    ("XVTHUMB", lambda p: p[:6] == b"P7 332", _open_xvthumb),
)


class _Refused(ValueError):
    """A format Pillow opens and the port does not decode."""

    def __init__(self, fmt: str, what: str):
        super().__init__(f"unsupported image format: {fmt} ({what})")
        self.format = fmt


def _open(data: bytes):
    """(format, loader) of the first format in Pillow's order whose accept
    takes the first 16 bytes and whose open does not pass the file on."""
    head = data[:16]
    for fmt, accept, open_ in _FORMATS:
        try:
            if accept(head):
                return fmt, open_(data)
        except (_NotThisFormat, IndexError, struct.error):
            continue  # Image.open's except clause: the next plugin
    raise ValueError("unsupported image format: not a JPEG, PNG, BMP, GIF, WebP or TIFF file, "
                     "nor one of the other formats Pillow opens")


def decode(data: bytes) -> np.ndarray:
    """Raw image bytes → (H, W, 3) uint8 RGB, EXIF orientation applied (the
    serving input convention: the JAX ``bytes_to_pil``). The format is the
    one ``Image.open`` finds, trying Pillow's plugins in its order."""
    _, load = _open(bytes(data))
    return load()


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
