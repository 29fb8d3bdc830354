"""Write the image codec's committed fixtures and their manifest.

    python scripts/codec_fixtures.py [--out tests/fixtures/codec]

The files are what the port's Pillow-free codec (``core/codec.py``) must
decode on a host without Pillow, as Pillow decodes them:

- ``prog_512_420.jpg``: 512², progressive, 4:2:0, quality 90 (Pillow);
- ``prog_1024.jpg`` and ``base_1024.jpg``: one 1024² image, progressive and
  baseline, 4:2:0, quality 90 (Pillow): the decode-time pair;
- ``adam7_rgb.png``: 8-bit RGB, Adam7-interlaced, a random filter a row;
- ``rgb16.png``: 16-bit RGB, not interlaced, a random filter a row;
- ``cmyk.jpg`` (Pillow's, 2x2-sampled, progressive), ``ycck.jpg`` (the same
  file marked Adobe transform 2) and ``rgb_coded.jpg`` (a 4:2:0 file
  relabelled Adobe transform 0);
- ``pal8.bmp``, ``rgb24.bmp`` and ``rle8.bmp`` (:func:`bmp_file`);
- ``interlaced.gif`` (:func:`gif_file`: a local palette, an offset frame
  and a transparency index);
- ``lossy.webp``, ``lossy_alpha.webp`` and ``lossless.webp`` (Pillow's);
- ``lossy_1024.webp`` and ``lossless_1024.webp`` (an 8-colour image: colour
  indexing), a smooth 1024² image: the WebP half of the decode-time set
  beside ``base_1024.jpg`` (``chip_smoke.py`` writes the BMP, GIF and CMYK
  half itself, without Pillow), and the WebP upload of its /edit;
- the TIFF, JPEG-variant and plain raster files (:func:`raster_fixtures`:
  PPM, PGM, PBM, PFM, DIB, ICO, CUR, TGA, PSD, QOI, PCX, DCX, SGI) and the
  small formats (:func:`small_fixtures`: SUN, MSP, XBM, XPM, ICNS, DDS).

Pillow writes neither interlaced nor 16-bit RGB PNG, so :func:`png_file`
writes both here with ``zlib``; BMP and GIF variants Pillow does not write
come from :func:`bmp_file` and :func:`gif_file`, lossy WebP at encoder
settings Pillow does not expose from :func:`libwebp_encode`; PSD, CUR and
the TGA, PCX and SGI codings Pillow does not write from :func:`psd_file`,
:func:`icon_file`, :func:`tga_file`, :func:`pcx_file` and :func:`sgi_file`
(numpy only: ``chip_smoke.py`` writes its 1024² set with them on a host
without Pillow, as it does with :func:`ppm_file` and :func:`qoi_file`, and
with :func:`sun_file`, :func:`msp_file`, :func:`xbm_file`,
:func:`xpm_file`, :func:`icns_file`, :func:`dds_file` and its block
encoders :func:`bc1_blocks` and :func:`bc7_blocks`, and with the rare
formats' writers, :func:`im_file`, :func:`blp_file`, :func:`fits_file`,
:func:`fli_file`, :func:`ftex_file`, :func:`gbr_file`, :func:`imt_file`,
:func:`iptc_file`, :func:`mcidas_file`, :func:`pcd_file`,
:func:`pixar_file`, :func:`spider_file` and :func:`xvthumb_file`; ZSTD
strips come from the system's libzstd through :func:`zstd_compress`). ``manifest.json`` holds each file's shape and
the SHA-256 of Pillow's ``ImageOps.exif_transpose(...).convert("RGB")``
bytes. Run it where Pillow is installed; the images come from a numpy seed.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import math
import os
import struct
import zlib

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "fixtures", "codec")
# Adam7's passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _row_bytes(row: np.ndarray, depth: int) -> np.ndarray:
    """One row of samples (W, C) as its PNG bytes: big-endian at 16 bits,
    packed most significant bits first below 8."""
    if depth == 16:
        return np.frombuffer(row.astype(">u2").tobytes(), np.uint8)
    if depth == 8:
        return row.astype(np.uint8).reshape(-1)
    flat = row.reshape(-1).astype(np.uint16)
    per = 8 // depth
    flat = np.concatenate([flat, np.zeros(-len(flat) % per, np.uint16)]).reshape(-1, per)
    return (flat << np.arange(8 - depth, -1, -depth, dtype=np.uint16)).sum(-1).astype(np.uint8)


def _filtered(rows, bpp: int, rng) -> list:
    """Each row with a filter type drawn from ``rng`` (none, sub, up,
    average, Paeth) and its type byte in front."""
    out, prev = [], None
    for cur in rows:
        cur = cur.astype(np.int32)
        up = prev if prev is not None else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        f = int(rng.integers(0, 5))
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        out.append(bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    return out


def png_file(samples: np.ndarray, color_type: int, depth: int = 8, interlace: bool = False,
             palette: np.ndarray = None, trns: bytes = None, seed: int = 0) -> bytes:
    """A PNG of ``samples`` (H, W, C) at ``depth`` bits, Adam7-interlaced or
    not, each row (of each pass) filtered with a random filter type."""
    rng = np.random.default_rng(seed)
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    raw = []
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] and sub.shape[1]:  # a pass may be empty
            raw += _filtered([_row_bytes(r, depth) for r in sub], bpp, rng)
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color_type, 0, 0, int(interlace)))
    if palette is not None:
        data += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    return data + _chunk(b"IDAT", zlib.compress(b"".join(raw), 9)) + _chunk(b"IEND", b"")


def _rle_row(row, rle4: bool) -> bytes:
    """One row of palette indices as RLE8 (or RLE4) runs: repeats of three
    or more encoded, the rest in absolute runs of three or more (padded to
    an even length), single leftovers as runs of one; then end of line."""
    out, i, n = bytearray(), 0, len(row)
    while i < n:
        j = i
        while j < n and j - i < 255 and row[j] == row[i]:
            j += 1
        if j - i >= 3 or n - i < 3:
            k = max(j - i, 1)
            out += bytes([k, (row[i] << 4 | row[i]) if rle4 else row[i]])
            i += k
            continue
        j = i
        while j < n and j - i < 254 and not (j + 2 < n and row[j] == row[j + 1] == row[j + 2]):
            j += 1
        k = max(j - i, 3) if n - i >= 3 else n - i
        k -= k % 2 if rle4 else 0  # Pillow reads count // 2 bytes of an RLE4 run
        run = [int(v) for v in row[i:i + k]]
        body = bytes((a << 4) | b for a, b in zip(run[::2], run[1::2])) if rle4 else bytes(run)
        out += bytes([0, k]) + body + (b"\x00" if len(body) % 2 else b"")
        i += k
    return bytes(out) + b"\x00\x00"


def bmp_file(px: np.ndarray, bits: int, header: int = 40, palette=None, compression: int = 0,
             masks=None, top_down: bool = False) -> bytes:
    """A BMP of ``px``: palette indices (H, W) at 1, 4 or 8 bits (RLE8 or
    RLE4 with ``compression`` 1 or 2), else (H, W, 3 or 4) RGB(A) at 16 (5-5-5,
    or 5-6-5 through ``masks``), 24 or 32 bits (BGRX, or the byte order the
    ``masks`` give with BI_BITFIELDS); ``header`` 12 (CORE), 40, 108 or 124
    bytes; rows bottom-up, or top-down (a negative height)."""
    h, w = px.shape[:2]
    masks = tuple(masks) if masks is not None else None
    if bits <= 8:
        if compression:
            rows = b"".join(_rle_row(px[r], compression == 2)
                            for r in (range(h) if top_down else range(h - 1, -1, -1)))
            body = rows + b"\x00\x01"
        else:
            per = 8 // bits
            flat = px.astype(np.uint16)
            if w % per:
                flat = np.concatenate([flat, np.zeros((h, per - w % per), np.uint16)], 1)
            packed = (flat.reshape(h, -1, per) << np.arange(8 - bits, -1, -bits,
                                                            dtype=np.uint16)).sum(-1)
            body = _bmp_rows(packed.astype(np.uint8), top_down)
    elif bits == 16:
        r, g, b = (px[..., c].astype(np.uint16) for c in range(3))
        if masks == (0xF800, 0x7E0, 0x1F):
            v = (r >> 3) << 11 | (g >> 2) << 5 | b >> 3
        else:
            v = (r >> 3) << 10 | (g >> 3) << 5 | b >> 3
        body = _bmp_rows(v.astype("<u2").view(np.uint8).reshape(h, -1), top_down)
    elif bits == 24:
        body = _bmp_rows(px[..., 2::-1].reshape(h, -1), top_down)
    else:
        a = px[..., 3] if px.shape[2] == 4 else np.full((h, w), 255, np.uint8)
        chans = {0xFF0000: px[..., 0], 0xFF00: px[..., 1], 0xFF: px[..., 2], 0xFF000000: a}
        order = (0xFF0000, 0xFF00, 0xFF, 0) if masks is None else masks
        word = np.zeros((h, w), np.uint32)
        for mask, src in zip(order, (px[..., 0], px[..., 1], px[..., 2], a)):
            if mask:
                word |= src.astype(np.uint32) << (int(mask).bit_length() - 8)
        del chans
        body = _bmp_rows(word.astype("<u4").view(np.uint8).reshape(h, -1), top_down)
    pal = b""
    if bits <= 8:
        pal = b"".join(bytes([c[2], c[1], c[0]]) + (b"" if header == 12 else b"\x00")
                       for c in np.asarray(palette, np.uint8))
    comp = compression or (3 if masks is not None else 0)
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits, comp,
                           len(body), 2835, 2835, len(pal) // 4 if bits <= 8 else 0, 0)
        if header > 40:
            m = list(masks or (0, 0, 0, 0)) + [0] * 4
            info += struct.pack("<IIII", *m[:4]) + bytes(header - 56)
        elif masks is not None:
            info += struct.pack("<III", *masks[:3])
    off = 14 + len(info) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + info + pal + body


def _bmp_rows(rows: np.ndarray, top_down: bool) -> bytes:
    """Byte rows padded to 4 bytes, bottom row first unless ``top_down``."""
    h, n = rows.shape
    padded = np.zeros((h, (n + 3) // 4 * 4), np.uint8)
    padded[:, :n] = rows
    return (padded if top_down else padded[::-1]).tobytes()


def lzw(indices, min_code: int) -> bytes:
    """GIF LZW of ``indices``: a clear code first, the code size grown as
    the table does, a clear code where it fills, the end code last; packed
    least significant bits first."""
    clear, end = 1 << min_code, (1 << min_code) + 1
    codes = []

    def reset():
        return {(i,): i for i in range(clear)}, end + 1, min_code + 1

    table, nxt, size = reset()
    codes.append((clear, size))
    w = ()
    for k in (int(v) for v in indices):
        if w + (k,) in table:
            w += (k,)
            continue
        codes.append((table[w], size))
        if nxt < 4096:
            table[w + (k,)] = nxt
            if nxt == 1 << size and size < 12:
                size += 1
            nxt += 1
        else:
            codes.append((clear, size))
            table, nxt, size = reset()
        w = (k,)
    if w:
        codes.append((table[w], size))
    codes.append((end, size))
    acc, bits, out = 0, 0, bytearray()
    for code, n in codes:
        acc |= code << bits
        bits += n
        while bits >= 8:
            out.append(acc & 255)
            acc >>= 8
            bits -= 8
    if bits:
        out.append(acc & 255)
    return bytes(out)


def gif_file(indices: np.ndarray, palette=None, local=None, screen=None, offset=(0, 0),
             interlace: bool = False, transparency=None, min_code: int = 8) -> bytes:
    """A GIF89a of one frame of palette ``indices`` (H, W) at ``offset`` on a
    logical ``screen`` (W, H; the frame's size by default), with a global
    ``palette`` and/or a ``local`` one (N, 3; N a power of two), Adam7-style
    GIF interlace, a graphic control extension's ``transparency`` index and a
    comment block before the frame."""
    h, w = indices.shape
    sw, sh = screen or (w + offset[0], h + offset[1])

    def table(p):
        p = np.asarray(p, np.uint8)
        bits = max(1, int(np.ceil(np.log2(len(p)))))
        full = np.zeros((1 << bits, 3), np.uint8)
        full[:len(p)] = p
        return bits, full.tobytes()

    flags, gtab = 0, b""
    if palette is not None:
        bits, gtab = table(palette)
        flags = 0x80 | (bits - 1)
    out = b"GIF89a" + struct.pack("<HHBBB", sw, sh, flags, 0, 0) + gtab
    out += b"!\xfe" + bytes([7]) + b"fixture" + b"\x00"
    if transparency is not None:
        out += b"!\xf9\x04" + bytes([1, 0, 0, transparency, 0])
    lflags, ltab = 0, b""
    if local is not None:
        bits, ltab = table(local)
        lflags = 0x80 | (bits - 1)
    if interlace:
        lflags |= 0x40
        order = [r for start, step in ((0, 8), (4, 8), (2, 4), (1, 2))
                 for r in range(start, h, step)]
        indices = indices[order]
    out += b"," + struct.pack("<HHHHB", offset[0], offset[1], w, h, lflags) + ltab
    data = lzw(indices.reshape(-1), min_code)
    out += bytes([min_code]) + b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                                        for i in range(0, len(data), 255))
    return out + b"\x00;"


def libwebp_encode(rgb: np.ndarray, **config) -> bytes:
    """A lossy WebP of ``rgb`` written by the libwebp that Pillow bundles,
    called through ``ctypes`` with ``WebPConfig`` fields Pillow does not
    expose (``filter_type`` 0 for the simple loop filter,
    ``filter_sharpness``, ``partitions``, ``segments``, ...)."""
    import ctypes
    import glob

    import PIL
    from PIL import _webp  # noqa: F401  (loads libwebp's own dependencies first)

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    path = [p for p in glob.glob(os.path.join(libs, "libwebp-*.so*"))]
    if not path:
        raise RuntimeError("Pillow's bundled libwebp was not found")
    lib = ctypes.CDLL(path[0])
    abi = 0x020f
    ci, cf, vp = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    names = ("lossless quality method image_hint target_size target_PSNR segments sns_strength "
             "filter_strength filter_sharpness filter_type autofilter alpha_compression "
             "alpha_filtering alpha_quality pass show_compressed preprocessing partitions "
             "partition_limit emulate_jpeg_size thread_level low_memory near_lossless exact "
             "use_delta_palette use_sharp_yuv qmin qmax").split()

    class Config(ctypes.Structure):
        _fields_ = [(n, cf if n in ("quality", "target_PSNR") else ci) for n in names]

    class Picture(ctypes.Structure):
        _fields_ = [("use_argb", ci), ("colorspace", ci), ("width", ci), ("height", ci),
                    ("y", vp), ("u", vp), ("v", vp), ("y_stride", ci), ("uv_stride", ci),
                    ("a", vp), ("a_stride", ci), ("pad1", ctypes.c_uint32 * 2), ("argb", vp),
                    ("argb_stride", ci), ("pad2", ctypes.c_uint32 * 3), ("writer", vp),
                    ("custom_ptr", vp), ("extra_info_type", ci), ("extra_info", vp),
                    ("stats", vp), ("error_code", ci), ("progress_hook", vp),
                    ("user_data", vp), ("pad3", ctypes.c_uint32 * 3), ("pad4", vp),
                    ("pad5", vp), ("pad6", ctypes.c_uint32 * 8), ("memory_", vp),
                    ("memory_argb_", vp), ("pad7", vp * 2)]

    class Writer(ctypes.Structure):
        _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)), ("size", ctypes.c_size_t),
                    ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32)]

    cfg, pic, wr = Config(), Picture(), Writer()
    if not lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, cf(config.pop("quality", 75.0)), abi):
        raise RuntimeError("WebPConfigInit failed")
    for k, v in config.items():
        setattr(cfg, k, v)
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), abi):
        raise RuntimeError("WebPPictureInit failed")
    rgb = np.ascontiguousarray(rgb, np.uint8)
    pic.width, pic.height = rgb.shape[1], rgb.shape[0]
    lib.WebPMemoryWriterInit(ctypes.byref(wr))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, vp)
    pic.custom_ptr = ctypes.cast(ctypes.byref(wr), vp)
    try:
        if not lib.WebPPictureImportRGB(ctypes.byref(pic), rgb.ctypes.data_as(vp),
                                        rgb.shape[1] * 3):
            raise RuntimeError("WebPPictureImportRGB failed")
        if not lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)):
            raise RuntimeError(f"WebPEncode failed: error {pic.error_code}")
        return ctypes.string_at(wr.mem, wr.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(wr))


# opj_cparameters_t (OpenJPEG 2.5): byte offsets of the fields the writer sets
_OPJ_PARAMS = {"tile_size_on": 0, "cp_tx0": 4, "cp_ty0": 8, "cp_tdx": 12, "cp_tdy": 16,
               "cp_disto_alloc": 20, "csty": 48, "prog_order": 52, "POC": 56, "numpocs": 4792,
               "tcp_numlayers": 4796, "tcp_rates": 4800, "numresolution": 5600,
               "cblockw_init": 5604, "cblockh_init": 5608, "mode": 5612, "irreversible": 5616,
               "roi_compno": 5620, "roi_shift": 5624, "res_spec": 5628, "prcw_init": 5632,
               "prch_init": 5764, "image_offset_x0": 18188, "image_offset_y0": 18192,
               "subsampling_dx": 18196, "subsampling_dy": 18200, "tcp_mct": 18698}
_OPJ_POC_SIZE = 148  # opj_poc_t


def openjpeg_encode(planes: np.ndarray, *, jp2: bool = False, mode: int = 0,
                    irreversible: bool = False, resolutions: int = 6, cblk=(64, 64),
                    rates=(), progression: int = 0, pocs=(), roi=None, prec: int = 8,
                    signed: bool = False, mct=None, precincts=(), tile=None,
                    offset=(0, 0), subsampling=None) -> bytes:
    """A JPEG 2000 codestream (or JP2 file) of ``planes`` (C, H, W) written by
    the libopenjp2 that Pillow bundles, through ``ctypes``, with encoder
    parameters Pillow does not expose: ``mode`` the code-block style (1
    bypass, 2 reset, 4 termination on each pass, 8 vertically causal, 16
    predictable termination, 32 segmentation symbols), ``roi`` (component,
    shift) for an RGN marker, ``pocs`` (resno0, compno0, layno1, resno1,
    compno1, progression) entries for a POC marker, ``rates`` one per
    quality layer, ``precincts`` ((w, h), ...) from the highest resolution
    down, ``subsampling`` (dx, dy) of every component but the first, or a
    list of each component's."""
    import ctypes
    import glob
    import tempfile

    import PIL

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    path = glob.glob(os.path.join(libs, "libopenjp2-*.so*"))
    if not path:
        raise RuntimeError("Pillow's bundled libopenjp2 was not found")
    lib = ctypes.CDLL(path[0])
    u32, vp = ctypes.c_uint32, ctypes.c_void_p

    class CompParm(ctypes.Structure):
        _fields_ = [(n, u32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]

    class Comp(ctypes.Structure):
        _fields_ = [(n, u32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd",
                                       "resno_decoded", "factor")] + [
            ("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)]

    class Image(ctypes.Structure):
        _fields_ = [(n, u32) for n in ("x0", "y0", "x1", "y1", "numcomps")] + [
            ("color_space", ctypes.c_int), ("comps", ctypes.POINTER(Comp))]

    lib.opj_image_create.restype = ctypes.POINTER(Image)
    lib.opj_create_compress.restype = vp
    lib.opj_stream_create_default_file_stream.restype = vp
    lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p, ctypes.c_int]
    planes = np.asarray(planes)
    nc, h, w = planes.shape
    ox, oy = offset
    if subsampling is None or isinstance(subsampling[0], int):
        subsampling = [(1, 1)] + [subsampling or (1, 1)] * (nc - 1)
    parms = (CompParm * nc)()
    for i in range(nc):
        dx, dy = subsampling[i]
        parms[i] = CompParm(dx, dy, -(-w // dx), -(-h // dy), -(-ox // dx), -(-oy // dy), prec,
                            prec, int(signed))
    image = lib.opj_image_create(nc, parms, 1 if nc >= 3 else 2)
    im = image.contents
    im.x0, im.y0, im.x1, im.y1 = ox, oy, ox + w, oy + h
    for i in range(nc):
        c = im.comps[i]
        dx, dy = subsampling[i]
        plane = np.ascontiguousarray(planes[i][::dy, ::dx], np.int32)
        ctypes.memmove(c.data, plane.ctypes.data, plane.nbytes)
    raw = ctypes.create_string_buffer(1 << 15)
    lib.opj_set_default_encoder_parameters(raw)

    def put(name, value, fmt="i", at=0):
        struct.pack_into(fmt, raw, _OPJ_PARAMS[name] + at, value)

    put("numresolution", resolutions)
    put("cblockw_init", cblk[0])
    put("cblockh_init", cblk[1])
    put("mode", mode)
    put("irreversible", int(irreversible))
    put("prog_order", progression)
    put("tcp_numlayers", max(1, len(rates)))
    if rates:
        put("cp_disto_alloc", 1)
        for k, r in enumerate(rates):
            put("tcp_rates", float(r), "f", 4 * k)
    if roi is not None:
        put("roi_compno", roi[0])
        put("roi_shift", roi[1])
    if precincts:
        put("csty", 1)
        put("res_spec", len(precincts))
        for k, (pw, ph) in enumerate(precincts):
            put("prcw_init", pw, at=4 * k)
            put("prch_init", ph, at=4 * k)
    for k, (r0, c0, l1, r1, c1, prg) in enumerate(pocs):
        base = _OPJ_POC_SIZE * k
        for j, v in enumerate((r0, c0, l1, r1, c1)):
            put("POC", v, "I", base + 4 * j)
        put("POC", prg, "i", base + 36)  # prg (after prg1)
    put("numpocs", len(pocs))
    if tile is not None:
        put("tile_size_on", 1)
        put("cp_tdx", tile[0])
        put("cp_tdy", tile[1])
    put("image_offset_x0", ox)
    put("image_offset_y0", oy)
    put("tcp_mct", int(nc >= 3) if mct is None else mct, "b")
    codec = lib.opj_create_compress(2 if jp2 else 0)
    fd, out = tempfile.mkstemp()
    os.close(fd)
    stream = None
    try:
        if not lib.opj_setup_encoder(vp(codec), raw, image):
            raise RuntimeError("opj_setup_encoder failed")
        stream = lib.opj_stream_create_default_file_stream(out.encode(), 0)
        if not (lib.opj_start_compress(vp(codec), image, vp(stream))
                and lib.opj_encode(vp(codec), vp(stream))
                and lib.opj_end_compress(vp(codec), vp(stream))):
            raise RuntimeError("OpenJPEG failed to encode")
        lib.opj_stream_destroy(vp(stream))
        stream = None
        with open(out, "rb") as f:
            return f.read()
    finally:
        if stream is not None:
            lib.opj_stream_destroy(vp(stream))
        lib.opj_destroy_codec(vp(codec))
        lib.opj_image_destroy(image)
        os.unlink(out)


def jp2_box(typ: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + typ + body


def jp2_file(codestream: bytes, width: int, height: int, comps: int, bits: int = 8,
             colr=None, palette=None, extra: bytes = b"") -> bytes:
    """A JP2 file around a raw codestream: the signature and file type
    boxes, a JP2 header of ``ihdr`` (``bits`` a component), a colour box
    (``colr``: an enumerated colour space, 16 sRGB, 17 greyscale, 18 sYCC,
    12 CMYK; bytes for an ICC profile; None for none), ``palette`` ((N, C)
    uint8 entries: a ``pclr`` box and a ``cmap`` box mapping component 0
    through it) and ``extra`` boxes, then the codestream box."""
    head = jp2_box(b"ihdr", struct.pack(">IIHBBBB", height, width, comps, bits - 1, 7, 0, 0))
    if isinstance(colr, int):
        head += jp2_box(b"colr", struct.pack(">BBBI", 1, 0, 0, colr))
    elif colr is not None:
        head += jp2_box(b"colr", struct.pack(">BBB", 2, 0, 0) + colr)
    if palette is not None:
        palette = np.asarray(palette, np.uint8)
        n, c = palette.shape
        head += jp2_box(b"pclr", struct.pack(">HB", n, c) + bytes([7] * c) + palette.tobytes())
        head += jp2_box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, k) for k in range(c)))
    return (jp2_box(b"jP  ", b"\x0d\x0a\x87\x0a") + jp2_box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + jp2_box(b"jp2h", head + extra) + jp2_box(b"jp2c", codestream))


def packbits(data: bytes) -> bytes:
    """PackBits: repeats of two or more as runs, the rest as literals of up
    to 128 bytes."""
    b = np.frombuffer(bytes(data), np.uint8)
    if not len(b):
        return b""
    # the starts of runs of equal bytes
    starts = np.flatnonzero(np.concatenate([[True], b[1:] != b[:-1]]))
    ends = np.concatenate([starts[1:], [len(b)]])
    out, lit = bytearray(), bytearray()

    def flush():
        for i in range(0, len(lit), 128):
            chunk = lit[i:i + 128]
            out.append(len(chunk) - 1)
            out.extend(chunk)
        lit.clear()
    for s0, e0 in zip(starts.tolist(), ends.tolist()):
        n = e0 - s0
        if n == 1:
            lit.append(int(b[s0]))
            continue
        flush()
        while n > 0:
            k = min(n, 128)
            if k == 1:
                out += bytes([0, int(b[s0])])
            else:
                out += bytes([257 - k, int(b[s0])])
            n -= k
    flush()
    return bytes(out)


def dib_entry(px: np.ndarray, bits: int, palette=None, mask=None) -> bytes:
    """An icon's or a cursor's DIB image (:func:`bmp_file` without its file
    header): the height doubled, the rows bottom-up, then the AND mask
    (``mask`` (H, W) of 0 and 1, else 0s), 1 bit a pixel in rows padded to
    32 bits."""
    h, w = px.shape[:2]
    dib = bytearray(bmp_file(px, bits, palette=palette)[14:])
    struct.pack_into("<i", dib, 8, 2 * h)
    m = np.zeros((h, w), np.uint8) if mask is None else np.asarray(mask, np.uint8)
    m = np.concatenate([m, np.zeros((h, -w % 32), np.uint8)], 1)
    return bytes(dib) + np.packbits(m[::-1], axis=1).tobytes()


def icon_file(entries, kind: int = 1) -> bytes:
    """An ICO (``kind`` 1) or a CUR (2) of ``entries``: (width, height,
    colour count, planes or hotspot x, bits or hotspot y, image bytes),
    width and height as their directory bytes (0 for 256)."""
    head = struct.pack("<HHH", 0, kind, len(entries))
    offset = len(head) + 16 * len(entries)
    table, body = b"", b""
    for w, h, colors, planes, bits, image in entries:
        table += struct.pack("<BBBBHHII", w, h, colors, 0, planes, bits, len(image),
                             offset + len(body))
        body += image
    return head + table + body


def ppm_file(px: np.ndarray, maxval: int = 255, plain: bool = False) -> bytes:
    """A PGM (``px`` (H, W)) or PPM ((H, W, 3)): binary samples of one byte,
    or two big-endian bytes where ``maxval`` is above 255; or ``plain``
    decimal tokens, 12 a line, after a comment line."""
    h, w = px.shape[:2]
    magic = (b"P2" if plain else b"P5") if px.ndim == 2 else (b"P3" if plain else b"P6")
    head = magic + b"\n%d %d\n%d\n" % (w, h, maxval)
    if plain:
        flat = [str(int(v)).encode() for v in np.asarray(px).reshape(-1)]
        lines = [b" ".join(flat[i:i + 12]) for i in range(0, len(flat), 12)]
        return head + b"# written by codec_fixtures.ppm_file\n" + b"\n".join(lines) + b"\n"
    return head + np.asarray(px).astype(">u2" if maxval > 255 else np.uint8).tobytes()


def _rle_packets(units: np.ndarray, row: int, run_max: int, literal_max: int,
                 literal_rows: bool = False, single_runs=None, min_run: int = 2):
    """The packets of a run-length coding of ``units`` (N, bytes a unit):
    runs of ``min_run`` or more equal units within a row of ``row`` units,
    in pieces of up to ``run_max``; the rest as literal stretches in pieces
    of up to ``literal_max``, which cross rows unless ``literal_rows``.
    ``single_runs`` (N,) marks units coded as runs even alone. Returns the
    packets' first unit, unit count and whether each is a run, in order."""
    n = len(units)
    new = np.ones(n, bool)
    new[1:] = (units[1:] != units[:-1]).any(1)
    new[::row] = True  # a run never crosses a row
    starts = np.flatnonzero(new)
    lens = np.diff(np.append(starts, n))
    run = lens >= min_run
    if single_runs is not None:
        run |= single_runs[starts]
    # a literal stretch starts after a run (and at a row's start where
    # literals stop at the row's end)
    first = run | np.concatenate([[True], run[:-1]])
    if literal_rows:
        first |= starts % row == 0
    seg_start = starts[first]
    seg_len = np.add.reduceat(lens, np.flatnonzero(first))
    seg_run = run[first]
    cap = np.where(seg_run, run_max, literal_max)
    pieces = -(-seg_len // cap)
    seg = np.repeat(np.arange(len(seg_len)), pieces)
    k = np.arange(len(seg)) - np.repeat(np.cumsum(pieces) - pieces, pieces)
    count = np.minimum(cap[seg], seg_len[seg] - k * cap[seg])
    run = seg_run[seg]
    if min_run > 2:  # a run's last piece too short to be one is a literal
        run = run & (count >= min_run)
    return seg_start[seg] + k * cap[seg], count, run


def _emit(units: np.ndarray, heads: np.ndarray, head_bytes: np.ndarray, first: np.ndarray,
          count: np.ndarray) -> bytes:
    """Packets end to end: ``head_bytes`` bytes of ``heads`` (P, up to 2),
    then ``count`` units from unit ``first``."""
    k = units.shape[1]
    sizes = head_bytes + count * k
    offs = np.cumsum(sizes) - sizes
    out = np.empty(int(sizes.sum()), np.uint8)
    for j in range(heads.shape[1]):
        has = head_bytes > j
        out[offs[has] + j] = heads[has, j]
    pk = np.repeat(np.arange(len(count)), count)
    i = np.arange(int(count.sum())) - np.repeat(np.cumsum(count) - count, count)
    dst = offs[pk] + head_bytes[pk] + i * k
    out[dst[:, None] + np.arange(k)] = units[first[pk] + i]
    return out.tobytes()


def _tga_rle(units: np.ndarray, w: int) -> bytes:
    """TGA RLE of (pixels, bytes a pixel) units in file order: runs of two
    or more equal pixels within a row (a run may not cross a row), literal
    packets of the rest, which run on across rows; 128 pixels a packet."""
    first, count, run = _rle_packets(units, w, 128, 128)
    heads = ((count - 1) | np.where(run, 0x80, 0)).astype(np.uint8)[:, None]
    return _emit(units, heads, np.ones(len(count), np.int64), first, np.where(run, 1, count))


def tga_file(px: np.ndarray, image_type: int, depth: int, colormap=None, first_entry: int = 0,
             map_depth: int = 24, flags: int = 0x20, image_id: bytes = b"") -> bytes:
    """A TGA of ``px``: colour-map indices (H, W) for image types 1 and 9,
    gray (H, W) or gray + alpha (H, W, 2) for 3 and 11, RGB(A) (H, W, 3 or
    4) for 2 and 10 at 16 (5-5-5 and an attribute bit), 24 or 32 bits;
    types 9-11 RLE (:func:`_tga_rle`). ``colormap`` (N, 3) RGB, stored from
    entry ``first_entry`` at ``map_depth`` 16, 24 or 32; ``flags`` bits 4
    and 5 the origin (0x20 top-left, 0 bottom-left, 0x10 and 0x30 right to
    left)."""
    h, w = px.shape[:2]
    if flags & 0x10:
        px = px[:, ::-1]
    if not flags & 0x20:
        px = px[::-1]
    base = image_type & 7
    if base == 2 and depth == 16:
        v = ((px[..., 0].astype(np.uint16) >> 3) << 10 | (px[..., 1].astype(np.uint16) >> 3) << 5
             | px[..., 2].astype(np.uint16) >> 3 | (0x8000 if px.shape[2] == 3 else
                                                     (px[..., 3] > 127).astype(np.uint16) << 15))
        units = v.astype("<u2").view(np.uint8).reshape(h * w, 2)
    elif base == 2:
        units = np.concatenate([px[..., 2::-1], px[..., 3:]], -1).reshape(h * w, -1)
    elif depth == 1:
        units = np.packbits(px.astype(np.uint8), axis=1).reshape(-1, 1)
    else:
        units = px.reshape(h * w, -1).astype(np.uint8)
    units = np.ascontiguousarray(units)
    body = _tga_rle(units, w) if image_type & 8 else units.tobytes()
    cmap = b""
    if colormap is not None:
        c = np.asarray(colormap, np.uint16)
        if map_depth == 16:
            cmap = ((c[:, 0] >> 3) << 10 | (c[:, 1] >> 3) << 5 | c[:, 2] >> 3).astype(
                "<u2").tobytes()
        else:
            cmap = np.concatenate([c[:, 2::-1], np.full((len(c), map_depth // 8 - 3), 255)],
                                  1).astype(np.uint8).tobytes()
    head = struct.pack("<BBBHHBHHHHBB", len(image_id), int(colormap is not None), image_type,
                       first_entry, 0 if colormap is None else len(colormap),
                       map_depth if colormap is not None else 0, 0, 0, w, h, depth, flags)
    return head + image_id + cmap + body


def psd_file(planes: np.ndarray, color_mode: int, bits: int = 8, compression: int = 1,
             colors: bytes = b"", resources: bytes = b"", layers: bytes = b"",
             extra_channels: int = 0) -> bytes:
    """A PSD whose merged image is ``planes`` (C, H, W): bytes, or 0 and 1
    at ``bits`` 1 (packed); raw (``compression`` 0) or PackBits rows with
    their byte counts (1). ``colors`` the colour mode data (a 768-byte
    palette, planar), ``resources`` the image resource blocks, ``layers``
    the layer and mask section's body; ``extra_channels`` more channels in
    the header than the merged image holds for its mode."""
    c, h, w = planes.shape
    rows = (np.packbits(planes.astype(np.uint8), axis=2) if bits == 1
            else planes.astype(np.uint8))
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, c + extra_channels, h, w, bits, color_mode)
    head += struct.pack(">I", len(colors)) + colors + struct.pack(">I", len(resources)) + resources
    head += struct.pack(">I", len(layers)) + layers
    if compression == 0:
        return head + struct.pack(">H", 0) + rows.tobytes()
    # PackBits row by row: runs of 2 to 128 (257 - n), literals of 1 to 128 (n - 1)
    units = np.ascontiguousarray(rows).reshape(-1, 1)
    width = rows.shape[2]
    first, count, run = _rle_packets(units, width, 128, 128, literal_rows=True)
    run &= count >= 2
    heads = np.where(run, 257 - count, count - 1).astype(np.uint8)[:, None]
    n = np.where(run, 1, count)
    per_row = np.bincount(first // width, weights=1 + n, minlength=c * h).astype(np.int64)
    return (head + struct.pack(">H", 1) + per_row.astype(">u2").tobytes()
            + _emit(units, heads, np.ones(len(n), np.int64), first, n))


def psd_resource(rid: int, data: bytes, name: bytes = b"") -> bytes:
    """One image resource block: 8BIM, its id, a padded Pascal name, its
    data padded to even."""
    pname = bytes([len(name)]) + name
    pname += b"\x00" * (len(pname) % 2)
    return b"8BIM" + struct.pack(">H", rid) + pname + struct.pack(">I", len(data)) + data + (
        b"\x00" * (len(data) % 2))


def sgi_file(px: np.ndarray, rle: bool = True, dimension=None) -> bytes:
    """An SGI image of ``px`` (H, W) or (H, W, Z), uint8 (1 byte a sample)
    or uint16 (2, big-endian), rows bottom-up: verbatim, or RLE with its
    offset and length tables (rows in table order, channel by channel)."""
    px = px if px.ndim == 3 else px[..., None]
    h, w, z = px.shape
    bpc = px.dtype.itemsize
    dim = dimension or (3 if z > 1 else 2)
    head = struct.pack(">HBBHHHHII4x80sI", 474, int(rle), bpc, dim, w, h, z, 0,
                       (1 << 8 * bpc) - 1, b"fixture", 0).ljust(512, b"\x00")
    planes = [px[::-1, :, k] for k in range(z)]
    if not rle:
        return head + b"".join(p.astype(">u2" if bpc == 2 else np.uint8).tobytes()
                               for p in planes)
    # each row of each channel: runs (a count, then the value), literals
    # (0x80 | count, then the values), up to 127 a packet, then a 0; 16-bit
    # words at 2 bytes a sample
    units = np.concatenate(planes, 0).astype(">u2" if bpc == 2 else np.uint8)
    units = np.ascontiguousarray(units).view(np.uint8).reshape(-1, bpc)
    first, count, run = _rle_packets(units, w, 127, 127, literal_rows=True)
    rows = first // w
    ends = np.flatnonzero(np.append(rows[1:] != rows[:-1], True))  # each row's last packet
    order = np.argsort(np.concatenate([2 * np.arange(len(first)), 2 * ends + 1]), kind="stable")
    zeros = np.zeros(len(ends), np.int64)
    first = np.concatenate([first, zeros])[order]
    n = np.concatenate([np.where(run, 1, count), zeros])[order]
    word = np.concatenate([count | np.where(run, 0, 0x80), zeros])[order]
    heads = word.astype(">u2").view(np.uint8).reshape(-1, 2) if bpc == 2 else \
        word.astype(np.uint8)[:, None]
    sizes = bpc + n * bpc
    starts = np.cumsum(sizes) - sizes
    row_of = np.concatenate([rows, rows[ends]])[order]
    row_first = np.flatnonzero(np.append(True, row_of[1:] != row_of[:-1]))
    row_len = np.diff(np.append(starts[row_first], sizes.sum()))
    body = _emit(units, heads, np.full(len(n), bpc), first, n)
    at = 512 + 8 * h * z
    return (head + np.asarray(starts[row_first] + at, ">u4").tobytes()
            + np.asarray(row_len, ">u4").tobytes() + body)


def pcx_file(px: np.ndarray, bits: int, planes: int, palette=None, vga_palette=None,
             version: int = 5, stride=None) -> bytes:
    """A PCX of ``px``: indices (H, W) at ``bits`` 1 in 1, 2 or 4 bit
    planes (a 16-colour header ``palette`` (16, 3)), bytes (H, W) at 8 bits
    in one plane (``vga_palette`` (256, 3) appended after the 0x0C marker)
    or RGB (H, W, 3) in three; each line's planes ``stride`` bytes (default
    the even length), RLE a line at a time."""
    h, w = px.shape[:2]
    stride = stride or ((w * bits + 7) // 8 + 1) // 2 * 2
    if bits == 1:
        ps = [(px >> k) & 1 for k in range(planes)]
        ps = [np.packbits(p.astype(np.uint8), axis=1) for p in ps]
    else:
        ps = [px] if px.ndim == 2 else [px[..., k] for k in range(planes)]
    ps = [np.concatenate([p, np.zeros((h, max(0, stride - p.shape[1])), np.uint8)], 1)[:, :stride]
          for p in ps]
    lines = np.concatenate(ps, 1).astype(np.uint8)
    pal16 = np.zeros((16, 3), np.uint8) if palette is None else np.asarray(palette, np.uint8)
    head = struct.pack("<BBBBHHHHHH48sBBHHHH", 10, version, 1, bits, 0, 0, w - 1, h - 1, 72, 72,
                       pal16.tobytes(), 0, planes, stride, 1, 0, 0).ljust(128, b"\x00")
    # runs of up to 63 within a line, and a lone byte of 0xC0 or more as a
    # run of 1; the other bytes as they are
    units = lines.reshape(-1, 1)
    first, count, run = _rle_packets(units, lines.shape[1], 63, 1 << 30,
                                     single_runs=units[:, 0] >= 0xC0)
    heads = (0xC0 | np.where(run, count, 0)).astype(np.uint8)[:, None]
    body = _emit(units, heads, run.astype(np.int64), first, np.where(run, 1, count))
    tail = b"" if vga_palette is None else b"\x0c" + np.asarray(vga_palette, np.uint8).tobytes()
    return head + body + tail


def dcx_file(pages) -> bytes:
    """A DCX of PCX ``pages``: its magic, the pages' offsets and a 0."""
    at = 4 + 4 * (len(pages) + 1)
    offsets = []
    for p in pages:
        offsets.append(at)
        at += len(p)
    return struct.pack(f"<I{len(pages) + 1}I", 0x3ADE68B1, *offsets, 0) + b"".join(pages)


def qoi_file(px: np.ndarray) -> bytes:
    """A QOI of RGB or RGBA ``px`` (H, W, 3 or 4), coded with numpy: runs of
    the previous pixel, DIFF and LUMA where the differences fit, RGB or RGBA
    otherwise (no INDEX: its table is sequential). Valid QOI: Pillow's
    decoder and the spec's read it alike."""
    h, w, ch = px.shape
    rgba = np.concatenate([px, np.full((h, w, 1), 255, np.uint8)], -1) if ch == 3 else px
    p = rgba.reshape(-1, 4).astype(np.int16)
    prev = np.concatenate([[[0, 0, 0, 255]], p[:-1]]).astype(np.int16)
    same = (p == prev).all(1)
    # runs: each maximal stretch of pixels equal to the one before, in 62s
    idx = np.arange(len(p))
    start = same & ~np.concatenate([[False], same[:-1]])
    pos_in_run = idx - np.maximum.accumulate(np.where(start, idx, 0))
    d = (p - prev + 256) % 256
    d = np.where(d > 127, d - 256, d)
    dr, dg, db = d[:, 0], d[:, 1], d[:, 2]
    same_a = d[:, 3] == 0
    diff = same_a & (abs(dr + 0.5) < 2) & (abs(dg + 0.5) < 2) & (abs(db + 0.5) < 2)
    luma = same_a & ~diff & (dg >= -32) & (dg <= 31) & (dr - dg >= -8) & (dr - dg <= 7) & (
        db - dg >= -8) & (db - dg <= 7)
    ops = np.zeros((len(p), 5), np.uint8)
    size = np.zeros(len(p), np.int64)
    last = same & (np.concatenate([~same[1:], [True]]) | (pos_in_run % 62 == 61))
    run_len = pos_in_run % 62 + 1
    ops[last, 0] = 0xC0 | (run_len[last] - 1)
    size[last] = 1
    m = ~same & diff
    ops[m, 0] = 0x40 | ((dr[m] + 2) << 4 | (dg[m] + 2) << 2 | (db[m] + 2)).astype(np.uint8)
    size[m] = 1
    m = ~same & luma
    ops[m, 0] = 0x80 | (dg[m] + 32).astype(np.uint8)
    ops[m, 1] = ((dr[m] - dg[m] + 8) << 4 | (db[m] - dg[m] + 8)).astype(np.uint8)
    size[m] = 2
    m = ~same & ~diff & ~luma & same_a
    ops[m, 0] = 0xFE
    ops[m, 1:4] = p[m, :3]
    size[m] = 4
    m = ~same & ~diff & ~luma & ~same_a
    ops[m, 0] = 0xFF
    ops[m, 1:5] = p[m]
    size[m] = 5
    body = ops[np.arange(5)[None] < size[:, None]].tobytes()
    return (b"qoif" + struct.pack(">IIBB", w, h, ch, 0) + body + b"\x00" * 7 + b"\x01")


def sun_file(px: np.ndarray, depth: int, file_type: int = 1, palette=None,
             palette_type: int = 1) -> bytes:
    """A Sun raster of ``px``: bits (H, W) at depth 1 (a set bit black),
    4-bit values (H, W) at 4, bytes (H, W) at 8 (indices where a
    ``palette`` (N, 3) is given: planar, the reds first), RGB (H, W, 3) at
    24 and 32 (stored BGR and BGRX, RGB and RGBX for type 3). Rows padded to
    16 bits; type 2 codes the rows as Pillow reads them (unpadded) with
    0x80 escapes: a run of 3 to 256 as 0x80, count - 1, value (across
    rows), a lone 0x80 as 0x80 0x00, any other byte as itself."""
    h, w = px.shape[:2]
    if depth == 1:
        rows = np.packbits(px.astype(np.uint8), axis=1)
    elif depth == 4:
        v = np.concatenate([px, np.zeros((h, w % 2), px.dtype)], 1).astype(np.uint8)
        rows = v[:, 0::2] << 4 | v[:, 1::2]
    elif depth == 8:
        rows = px.astype(np.uint8)
    else:
        rgb = px if file_type == 3 else px[..., ::-1]
        if depth == 32:
            rgb = np.concatenate([rgb, np.zeros((h, w, 1), np.uint8)], -1)
        rows = rgb.reshape(h, -1)
    if file_type == 2:
        body = _sun_rle(rows.ravel())
    else:
        stride = (w * depth + 15) // 16 * 2
        body = np.concatenate([rows, np.zeros((h, stride - rows.shape[1]), np.uint8)], 1).tobytes()
    pal = b"" if palette is None else np.asarray(palette, np.uint8).T.tobytes()
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), file_type,
                       palette_type if pal else 0, len(pal)) + pal + body


def _sun_rle(units: np.ndarray) -> bytes:
    """SUN RLE of a byte stream: each stretch of equal bytes as runs of 256,
    then a run of the rest where it is 3 or more, else that many literal
    bytes (0x80 as 0x80 0x00)."""
    n = len(units)
    starts = np.flatnonzero(np.concatenate([[True], units[1:] != units[:-1]]))
    lens = np.diff(np.append(starts, n))
    vals = units[starts].astype(np.int64)
    big = lens >= 3
    full = np.where(big, lens // 256, 0)
    rem = np.where(big, lens % 256, lens)
    tail = big & (rem >= 3)
    runs, lits = full + tail, np.where(tail, 0, rem)
    seg = np.repeat(np.arange(len(lens)), runs + lits)  # each packet's stretch
    k = np.arange(len(seg)) - np.repeat(np.cumsum(runs + lits) - runs - lits, runs + lits)
    v = vals[seg]
    run = k < runs[seg]
    count = np.where(k < full[seg], 256, rem[seg])
    size = np.where(run, 3, np.where(v == 0x80, 2, 1))
    at = np.cumsum(size) - size
    out = np.zeros(int(size.sum()), np.uint8)
    out[at] = np.where(run | (v == 0x80), 0x80, v)
    out[at[run] + 1] = count[run] - 1
    out[at[run] + 2] = v[run]
    return out.tobytes()


def msp_file(bits: np.ndarray, version: int = 2) -> bytes:
    """A Windows Paint file of ``bits`` (H, W), 1 white: version 1 (DanM)
    raw, or version 2 (LinS): its row map, then each row's packets (a run as
    0, count, value; a literal as count, bytes), up to 255 a packet."""
    h, w = bits.shape
    rows = np.packbits(bits.astype(np.uint8), axis=1)
    words = [*struct.unpack("<2H", b"DanM" if version == 1 else b"LinS"), w, h, 1, 1, 1, 1, w, h,
             0, 0, 0, 0, 0, 0]
    words[12] = int(np.bitwise_xor.reduce(np.array(words)))
    head = struct.pack("<16H", *words)
    if version == 1:
        return head + rows.tobytes()
    units = rows.reshape(-1, 1)
    rb = rows.shape[1]
    first, count, run = _rle_packets(units, rb, 255, 255, literal_rows=True, min_run=3)
    heads = np.stack([np.where(run, 0, count), np.where(run, count, 0)], 1).astype(np.uint8)
    head_bytes = np.where(run, 2, 1)
    body = _emit(units, heads, head_bytes, first, np.where(run, 1, count))
    sizes = head_bytes + np.where(run, 1, count)
    row_len = np.bincount(first // rb, weights=sizes, minlength=h).astype("<u2")
    return head + row_len.tobytes() + body


def xbm_file(bits: np.ndarray, hotspot=None) -> bytes:
    """An X bitmap of ``bits`` (H, W), 1 white as Pillow reads it: its
    defines, then each row's bytes, least significant bit first, as hex."""
    h, w = bits.shape
    rows = np.packbits(bits.astype(np.uint8), axis=1, bitorder="little").ravel()
    table = [b"0x%02x" % i for i in range(256)]
    body = b",\n".join(b", ".join(table[v] for v in rows[i:i + 12])
                       for i in range(0, len(rows), 12))
    hot = b"" if hotspot is None else b"#define im_x_hot %d\n#define im_y_hot %d\n" % hotspot
    return (b"#define im_width %d\n#define im_height %d\n" % (w, h) + hot
            + b"static char im_bits[] = {\n" + body + b"\n};\n")


XPM_CHARS = bytes(c for c in range(0x21, 0x7F) if c not in b'"\\')


def xpm_file(indices: np.ndarray, palette: np.ndarray, cpp=None, transparent: bool = False,
             pixels_comment: bool = True) -> bytes:
    """An X pixmap of ``indices`` (H, W) into ``palette`` (N, 3): ``cpp``
    characters a pixel (the fewest that name N colours by default), a
    ``#rrggbb`` colour a line, an unused ``None`` colour where
    ``transparent``, a "/* pixels */" line, then a quoted row a line."""
    h, w = indices.shape
    n = len(palette)
    base = len(XPM_CHARS)
    cpp = cpp or max(1, math.ceil(math.log(n + transparent, base)) if n > 1 else 1)
    codes = np.arange(n + transparent)[:, None] // base ** np.arange(cpp) % base
    keys = np.frombuffer(XPM_CHARS, np.uint8)[codes]
    lines = [b"/* XPM */", b"static char *image[] = {",
             b'"%d %d %d %d",' % (w, h, n + transparent, cpp)]
    for k in range(n):
        lines.append(b'"' + keys[k].tobytes() + b" c #%02x%02x%02x" % tuple(palette[k]) + b'",')
    if transparent:
        lines.append(b'"' + keys[n].tobytes() + b' c None",')
    if pixels_comment:
        lines.append(b"/* pixels */")
    body = keys[indices].reshape(h, w * cpp)
    lines += [b'"' + r.tobytes() + b'",' for r in body]
    return b"\n".join(lines) + b"\n};\n"


def icns_rle24(rgb: np.ndarray) -> bytes:
    """IcnsImagePlugin's RLE24: each channel in turn, runs of 3 to 130 as
    count + 125 then the byte, literals of up to 128 as count - 1 then the
    bytes."""
    out = b""
    for k in range(3):
        units = np.ascontiguousarray(rgb[..., k]).reshape(-1, 1)
        first, count, run = _rle_packets(units, len(units), 130, 128, min_run=3)
        heads = np.where(run, count + 125, count - 1).astype(np.uint8)[:, None]
        out += _emit(units, heads, np.ones(len(count), np.int64), first, np.where(run, 1, count))
    return out


def icns_file(members) -> bytes:
    """An Apple icon file of ``members`` [(type, data)], in order."""
    body = b"".join(t + struct.pack(">I", len(d) + 8) + d for t, d in members)
    return b"icns" + struct.pack(">I", len(body) + 8) + body


def dds_file(w: int, h: int, data: bytes, pfflags: int, fourcc: bytes = b"\0" * 4,
             bitcount: int = 0, masks=(0, 0, 0, 0), dxgi=None, palette=None) -> bytes:
    """A DirectDraw surface: the 124-byte header (the pixel format's
    ``pfflags``, ``fourcc``, ``bitcount`` and RGBA ``masks``), a DX10
    header where ``dxgi`` is given (FourCC DX10), a 256-entry RGBA
    ``palette`` (bytes), then ``data``, the first surface."""
    if dxgi is not None:
        fourcc = b"DX10"
    head = struct.pack("<4sI6I44x2I4sI4I4I4x", b"DDS ", 124, 0x1007, h, w, 0, 0, 0, 32, pfflags,
                       fourcc, bitcount, *masks, 0x1000, 0, 0, 0)
    ext = b"" if dxgi is None else struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + ext + (palette or b"") + data


def _blocks(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) → (blocks, 16, 3): 4x4 blocks left to right, top to bottom,
    the image padded with its edge."""
    h, w = rgb.shape[:2]
    p = np.pad(rgb, ((0, -h % 4), (0, -w % 4), (0, 0)), mode="edge").astype(np.int64)
    bh, bw = p.shape[0] // 4, p.shape[1] // 4
    return p.reshape(bh, 4, bw, 4, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 3)


def bc1_blocks(rgb: np.ndarray) -> bytes:
    """A plain BC1 (DXT1) coding of ``rgb``: each block's darkest and
    brightest pixel as 5:6:5 endpoints (the brighter first, four-colour
    mode), each pixel's index by its projection on the line between them."""
    b = _blocks(rgb)
    luma = b @ np.array([2, 4, 1])
    hi = b[np.arange(len(b)), luma.argmax(1)]
    lo = b[np.arange(len(b)), luma.argmin(1)]
    c565 = lambda c: (c[:, 0] >> 3) << 11 | (c[:, 1] >> 2) << 5 | c[:, 2] >> 3  # noqa: E731
    c0, c1 = c565(hi), c565(lo)
    c0, c1 = np.maximum(c0, c1), np.minimum(c0, c1)

    def widen(c):
        r, g, bl = (c >> 11 & 31) << 3, (c >> 5 & 63) << 2, (c & 31) << 3
        return np.stack([r | r >> 5, g | g >> 6, bl | bl >> 5], -1)

    e0, e1 = widen(c0), widen(c1)
    d = (e1 - e0)[:, None, :]  # each pixel's place from e0 (0) to e1 (3) on their line
    t = ((b - e0[:, None, :]) * d).sum(-1) * 3 / np.maximum((d * d).sum(-1), 1)
    idx = np.array([0, 2, 3, 1])[np.clip(np.rint(t), 0, 3).astype(np.int64)]
    idx = np.where((c0 == c1)[:, None], 0, idx)
    lut = (idx << (2 * np.arange(16))).sum(1)
    out = np.zeros((len(b), 8), np.uint8)
    out[:, 0:2] = c0.astype("<u2").view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = c1.astype("<u2").view(np.uint8).reshape(-1, 2)
    out[:, 4:8] = lut.astype("<u4").view(np.uint8).reshape(-1, 4)
    return out.tobytes()


_WEIGHTS4 = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64])


def _one_subset_indices(px: np.ndarray, e0: np.ndarray, e1: np.ndarray):
    """(indices, swap) of blocks of one subset: each pixel's nearest of the
    16 weights by its projection on the line from ``e0`` to ``e1``; where
    the first pixel's index is 8 or more (``swap``), the block's endpoints
    are to be swapped, and its indices are already 15 - index."""
    d = (e1 - e0)[:, None, :]
    t = ((px - e0[:, None, :]) * d).sum(-1) * 64 / np.maximum((d * d).sum(-1), 1)
    idx = np.searchsorted((_WEIGHTS4[1:] + _WEIGHTS4[:-1]) / 2, t)
    swap = idx[:, 0] >= 8
    return np.where(swap[:, None], 15 - idx, idx), swap


def _packed_blocks(fields, n: int) -> bytes:
    """``n`` 16-byte blocks of ``fields`` [(values a block, bits)], least
    significant bit first."""
    bits = np.zeros((n, 128), np.uint8)
    at = 0
    for v, k in fields:
        bits[:, at:at + k] = (np.broadcast_to(np.asarray(v, np.int64), (n,))[:, None]
                              >> np.arange(k)) & 1
        at += k
    return np.packbits(bits, axis=1, bitorder="little").tobytes()


def bc7_blocks(rgb: np.ndarray) -> bytes:
    """A plain BC7 coding of ``rgb`` in mode 6 (one subset, 7-bit RGBA
    endpoints with a p-bit each, 4-bit indices): each block's per-channel
    minimum and maximum as endpoints, each pixel's nearest of the 16
    weights between them by each pixel's projection on the line from one
    to the other; the first pixel's index kept under 8 by swapping the
    endpoints."""
    b = _blocks(rgb)
    lo, hi = b.min(1) >> 1, b.max(1) >> 1  # 7 bits
    idx, swap = _one_subset_indices(b, lo << 1 | 1, hi << 1 | 1)  # p-bit 1
    lo, hi = np.where(swap[:, None], hi, lo), np.where(swap[:, None], lo, hi)
    fields = [(64, 7)]  # mode 6: bit 6 set
    for c in range(3):
        fields += [(lo[:, c], 7), (hi[:, c], 7)]
    fields += [(127, 7), (127, 7), (1, 1), (1, 1), (idx[:, 0], 3)]
    fields += [(idx[:, i], 4) for i in range(1, 16)]
    return _packed_blocks(fields, len(b))


def bc6h_blocks(rgb: np.ndarray, signed: bool = False) -> bytes:
    """A plain BC6H coding of ``rgb`` in mode 11 (one region, 10-bit
    endpoints, 4-bit indices, no deltas): each 8-bit value v taken as the
    half float nearest (v + 0.5) / 255, and given the endpoint whose
    unquantized value (e * 64 + 32) comes nearest it; each block's least
    and greatest endpoint a channel, each pixel's index as in
    :func:`bc7_blocks`. ``signed``: BC6H_SF16's endpoints (positive, under
    512)."""
    b = _blocks(rgb)
    half = ((b + 0.5) / 255).astype(np.float16).view(np.uint16).astype(np.int64)
    # the value that finalizes to the half: * 31 / 64 unsigned, * 31 / 32 signed
    v = -(-half * (32 if signed else 64) // 31)
    e = np.clip(np.rint((v - 32) / 64), 0, 510 if signed else 1022).astype(np.int64)
    lo, hi = e.min(1), e.max(1)
    idx, swap = _one_subset_indices(e, lo, hi)
    lo, hi = np.where(swap[:, None], hi, lo), np.where(swap[:, None], lo, hi)
    fields = [(0b00011, 5)] + [(lo[:, c], 10) for c in range(3)]
    fields += [(hi[:, c], 10) for c in range(3)] + [(idx[:, 0], 3)]
    fields += [(idx[:, i], 4) for i in range(1, 16)]
    return _packed_blocks(fields, len(b))


def zstd_compress(data: bytes, level: int = 9) -> bytes:
    """A zstd frame of ``data`` through the system's libzstd (ctypes)."""
    import ctypes

    lib = ctypes.CDLL("libzstd.so.1")
    lib.ZSTD_compressBound.argtypes, lib.ZSTD_compressBound.restype = [ctypes.c_size_t], \
        ctypes.c_size_t
    lib.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
                                  ctypes.c_size_t, ctypes.c_int]
    lib.ZSTD_compress.restype = ctypes.c_size_t
    lib.ZSTD_isError.argtypes, lib.ZSTD_isError.restype = [ctypes.c_size_t], ctypes.c_uint
    cap = lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(cap)
    n = lib.ZSTD_compress(out, cap, data, len(data), level)
    if lib.ZSTD_isError(n):
        raise RuntimeError("ZSTD_compress failed")
    return out.raw[:n]


# --- the rare formats (numpy and the standard library only) -----------------


def xv_indices(rgb: np.ndarray) -> np.ndarray:
    """RGB → indices into XV's fixed 3:3:2 palette (its top bits)."""
    return (rgb[..., 0] >> 5) << 5 | (rgb[..., 1] >> 5) << 2 | rgb[..., 2] >> 6


def xv_palette() -> np.ndarray:
    return np.array([((r * 255) // 7, (g * 255) // 7, (b * 255) // 3)
                     for r in range(8) for g in range(8) for b in range(4)], np.uint8)


def xvthumb_file(indices: np.ndarray, comments=(b"#XVVERSION:Version 2.28",)) -> bytes:
    """An XV thumbnail as xv writes one: ``P7 332``, comment lines, the
    size line, then a byte a pixel into the 3:3:2 palette."""
    h, w = indices.shape
    return (b"P7 332\n" + b"".join(c + b"\n" for c in comments) + b"#END_OF_COMMENTS\n"
            + b"%d %d 255\n" % (w, h) + indices.astype(np.uint8).tobytes())


def pixar_file(rgb: np.ndarray, channels: int = 14, depth: int = 2) -> bytes:
    """A Pixar image in the dumped layout: a 1024-byte header (the size at
    416, the channel and depth codes at 424), then RGB rows."""
    h, w = rgb.shape[:2]
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<4H", head, 416, h, w, 0, 0)
    struct.pack_into("<2H", head, 424, channels, depth)
    return bytes(head) + rgb.astype(np.uint8).tobytes()


def mcidas_file(px: np.ndarray, nbytes: int = 1, prefix: int = 0, bands: int = 1,
                offset: int = 256) -> bytes:
    """A McIdas area file: the 64-word directory (lines, elements, bytes an
    element, bands, the line prefix, the data offset), then each line's
    prefix and its samples, big-endian, the first band of ``bands``."""
    h, w = px.shape
    words = [0] * 64
    words[1] = 4
    words[8], words[9], words[10], words[13], words[14], words[33] = (
        h, w, nbytes, bands, prefix, offset)
    line = np.zeros((h, prefix + w * nbytes * bands), np.uint8)
    v = px.astype(">" + {1: "u1", 2: "u2", 4: "i4"}[nbytes]).view(np.uint8).reshape(h, -1)
    line[:, prefix:prefix + w * nbytes] = v
    return struct.pack(">64i", *words) + bytes(offset - 256) + line.tobytes()


def spider_file(f: np.ndarray, big_endian: bool = False, stack: int = 0) -> bytes:
    """A Spider 2-D image as Pillow's makeSpiderHeader lays it out: records
    of a row's bytes, enough of them for 1024 bytes of header, then 32-bit
    floats; ``stack`` > 0 writes a stack's header before the first image's."""
    h, w = f.shape
    lenbyt = w * 4
    labrec = -(-1024 // lenbyt)
    labbyt = labrec * lenbyt
    e = ">" if big_endian else "<"

    def header(values):
        hdr = np.zeros(labbyt // 4, e + "f4")
        for k, v in values.items():
            hdr[k - 1] = v
        return hdr.tobytes()
    image = {1: 1.0, 2: h, 3: h, 5: 1.0, 12: w, 13: labrec, 22: labbyt, 23: lenbyt}
    body = header(image) + f.astype(e + "f4").tobytes()
    if stack:
        return header({**image, 24: stack, 26: 1.0}) + body
    return body


def _fits_card(key: bytes, value: bytes = b"") -> bytes:
    card = key.ljust(8) + (b"= " + value.rjust(20) if value else b"")
    return card.ljust(80)


def _fits_unit(cards, body: bytes = b"") -> bytes:
    head = b"".join(_fits_card(k, v) for k, v in cards) + _fits_card(b"END")
    head += b" " * (-len(head) % 2880)
    return head + body + bytes(-len(body) % 2880)


_FITS_TYPES = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}


def fits_file(px: np.ndarray, bitpix: int = 8, gzip_tile: bool = False) -> bytes:
    """A FITS image (its rows bottom-up, big-endian, as the standard lays
    them out), or a GZIP_1 tile-compressed table of one tile: each pixel a
    big-endian 4-byte word in the gzip stream of the table's heap."""
    h, w = px.shape
    rows = np.ascontiguousarray(px[::-1])
    if not gzip_tile:
        return _fits_unit([(b"SIMPLE", b"T"), (b"BITPIX", b"%d" % bitpix), (b"NAXIS", b"2"),
                           (b"NAXIS1", b"%d" % w), (b"NAXIS2", b"%d" % h)],
                          rows.astype(_FITS_TYPES[bitpix]).tobytes())
    import gzip

    heap = gzip.compress(rows.astype(">i4").tobytes(), compresslevel=1, mtime=0)
    table = struct.pack(">ii", len(heap), 0)  # the tile's descriptor: length and heap offset
    primary = _fits_unit([(b"SIMPLE", b"T"), (b"BITPIX", b"8"), (b"NAXIS", b"0")])
    ext = _fits_unit([(b"XTENSION", b"'BINTABLE'"), (b"BITPIX", b"8"), (b"NAXIS", b"2"),
                      (b"NAXIS1", b"8"), (b"NAXIS2", b"1"), (b"PCOUNT", b"%d" % len(heap)),
                      (b"TFIELDS", b"1"), (b"TFORM1", b"'1PB(%d)'" % len(heap)),
                      (b"ZIMAGE", b"T"), (b"ZCMPTYPE", b"'GZIP_1  '"),
                      (b"ZBITPIX", b"%d" % bitpix), (b"ZNAXIS", b"2"),
                      (b"ZNAXIS1", b"%d" % w), (b"ZNAXIS2", b"%d" % h)], table + heap)
    return primary + ext


def fli_chunk(kind: int, body: bytes) -> bytes:
    return struct.pack("<IH", 6 + len(body), kind) + body


def fli_palette_chunk(palette: np.ndarray, kind: int = 11, first: int = 0) -> bytes:
    """A colour chunk (11: 6-bit entries, 4: 8-bit) of one packet setting
    ``palette``'s entries from ``first`` on."""
    n = len(palette)
    return fli_chunk(kind, struct.pack("<HBB", 1, first, n & 0xFF)
                     + palette.astype(np.uint8).tobytes())


def _fli_runs(row: np.ndarray, run_min: int = 3):
    """(start, length, is_run) spans of ``row``: runs of one value at least
    ``run_min`` long, literals between, each span at most 127."""
    starts = np.flatnonzero(np.diff(row.astype(np.int64), prepend=-1))
    lengths = np.diff(np.append(starts, len(row)))
    spans, lit = [], None
    for x, n in zip(starts.tolist(), lengths.tolist()):
        if n >= run_min:
            if lit is not None:
                spans += [(k, min(127, x - k), False) for k in range(lit, x, 127)]
                lit = None
            spans += [(k, min(127, x + n - k), True) for k in range(x, x + n, 127)]
        elif lit is None:
            lit = x
    if lit is not None:
        spans += [(k, min(127, len(row) - k), False) for k in range(lit, len(row), 127)]
    return spans


def fli_brun(indices: np.ndarray) -> bytes:
    """A BRUN chunk: each line a packet count byte, then runs (a positive
    count and a byte) and literals (a negative count and the bytes)."""
    out = bytearray()
    for row in indices.astype(np.uint8):
        spans = _fli_runs(row)
        out.append(len(spans) & 0xFF)
        for x, n, run in spans:
            out += bytes((n, row[x])) if run else bytes((256 - n,)) + row[x:x + n].tobytes()
    return fli_chunk(15, bytes(out))


def fli_lc(new: np.ndarray, old: np.ndarray) -> bytes:
    """An LC chunk (byte deltas): the first changed line and the number of
    lines, each line's packets of a skip, then a count of bytes (or a
    negative count and one byte repeated)."""
    changed = np.flatnonzero((new != old).any(1))
    y0, y1 = (int(changed[0]), int(changed[-1]) + 1) if changed.size else (0, 0)
    out = bytearray(struct.pack("<HH", y0, y1 - y0))
    for y in range(y0, y1):
        row, diff, packets, x = new[y].astype(np.uint8), new[y] != old[y], bytearray(), 0
        count = 0
        cols = np.flatnonzero(diff)
        while cols.size:
            start = int(cols[0])
            while start - x > 255:  # a skip too long for one packet: copy a byte
                packets += bytes((255, 1, row[x + 255]))
                x += 256
                count += 1
            end = min(start + 127, int(cols[-1]) + 1)
            n = end - start
            if n >= 3 and (row[start:end] == row[start]).all():
                packets += bytes((start - x, 256 - n, row[start]))
            else:
                packets += bytes((start - x, n)) + row[start:end].tobytes()
            count += 1
            x = end
            cols = cols[cols >= x]
        out += bytes((count,)) + packets
    return fli_chunk(12, bytes(out))


def fli_ss2(new: np.ndarray, old: np.ndarray) -> bytes:
    """An SS2 chunk (word deltas) of an even-width image: for each changed
    line, a skip word (0xC000 | -lines) where lines were skipped, the
    packet count, then packets of a column skip and a count of words (or
    a negative count and one word repeated)."""
    h, w = new.shape
    lines, out, y = 0, bytearray(), 0
    changed = np.flatnonzero((new != old).any(1))
    for yc in changed:
        words = bytearray()
        if yc > y:
            words += struct.pack("<H", 0x10000 - (int(yc) - y))
        row = new[yc].astype(np.uint8)
        pairs = row.reshape(-1, 2)
        diff = (new[yc] != old[yc]).reshape(-1, 2).any(1)
        packets, x = bytearray(), 0
        count = 0
        cols = np.flatnonzero(diff)
        while cols.size:
            start = int(cols[0])
            end = min(start + 127, int(cols[-1]) + 1)
            n = end - start
            if n >= 2 and (pairs[start:end] == pairs[start]).all():
                packets += bytes((2 * start - x, 256 - n)) + pairs[start].tobytes()
            else:
                packets += bytes((2 * start - x, n)) + pairs[start:end].tobytes()
            count += 1
            x = 2 * end
            cols = cols[cols >= end]
        out += words + struct.pack("<H", count) + packets
        lines += 1
        y = int(yc) + 1
    return fli_chunk(7, struct.pack("<H", lines) + bytes(out))


def fli_frame(*chunks: bytes) -> bytes:
    body = b"".join(chunks)
    return struct.pack("<IHH8x", 16 + len(body), 0xF1FA, len(chunks)) + body


def fli_file(frames, w: int, h: int, flc: bool = True, prefix: bytes = b"") -> bytes:
    """An FLC (magic 0xAF12) or FLI (0xAF11) animation of ``frames`` (each
    :func:`fli_frame`), an optional prefix chunk first."""
    body = prefix + b"".join(frames)
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 128 + len(body), 0xAF12 if flc else 0xAF11,
                     len(frames), w, h, 8, 3 if flc else 0, 70)
    return bytes(head) + body


def ftex_file(w: int, h: int, mip: bytes, kind: int = 0, formats: int = 1) -> bytes:
    """An FTEX texture: the header, one format (0: DXT1, 1: raw RGB) whose
    mipmap sits after it with its size in front."""
    head = b"FTEX" + struct.pack("<5i", 0x100, w, h, 1, formats) + struct.pack("<2i", kind, 32)
    return head + struct.pack("<i", len(mip)) + mip


def gbr_file(px: np.ndarray, version: int = 2, name: bytes = b"brush", spacing: int = 25) -> bytes:
    """A GIMP brush: gray (depth 1) or RGBA (depth 4) samples after the
    header and the brush's name."""
    h, w = px.shape[:2]
    depth = 1 if px.ndim == 2 else px.shape[2]
    size = (20 if version == 1 else 28) + len(name) + 1
    head = struct.pack(">5I", size, version, w, h, depth)
    if version == 2:
        head += b"GIMP" + struct.pack(">I", spacing)
    return head + name + b"\0" + px.astype(np.uint8).tobytes()


def imt_file(gray: np.ndarray, comment: bytes = b"* an IM Tools image") -> bytes:
    """An IM Tools image: ``key value`` lines, then 0x0C and the bytes."""
    h, w = gray.shape
    return (comment + b"\nwidth %d\nheight %d\npixel n8\n\x0c" % (w, h)
            + gray.astype(np.uint8).tobytes())


def iptc_dataset(record: int, dataset: int, data: bytes) -> bytes:
    """One IPTC dataset: 0x1C, its numbers, a 2-byte size; past 32767 bytes
    the size in 4 bytes after it, flagged as IptcImagePlugin reads the
    flag: 0x80 plus the size's length in the first byte of the two."""
    if len(data) < 0x8000:
        return struct.pack(">BBBH", 0x1C, record, dataset, len(data)) + data
    return struct.pack(">BBBBBI", 0x1C, record, dataset, 0x84, 0, len(data)) + data


def iptc_file(w: int, h: int, image: bytes, layers: int = 1, component: int = 0,
              compression: int = 1, band=None) -> bytes:
    """An IPTC/NAA record of an image: the object name, the layers and
    sampling (3, 60), the size, the compression (1 raw, 5 JPEG), a band
    (3, 65) if given, then the image's data (8, 10)."""
    out = (iptc_dataset(2, 5, b"picture") + iptc_dataset(3, 60, bytes((layers, component)))
           + iptc_dataset(3, 20, struct.pack(">H", w)) + iptc_dataset(3, 30, struct.pack(">H", h))
           + iptc_dataset(3, 120, bytes((compression,))))
    if band is not None:
        out += iptc_dataset(3, 65, bytes((band,)))
    return out + iptc_dataset(8, 10, image)


def pcd_file(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, orientation: int = 0) -> bytes:
    """A Kodak PhotoCD's base image: ``PCD_`` at 2048 and the orientation
    byte, then at 96 x 2048 each pair of 768-wide luma rows followed by a
    384-wide row of each chroma."""
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    rows = np.concatenate([y.astype(np.uint8).reshape(256, 2 * 768),
                           cb.astype(np.uint8).reshape(256, 384),
                           cr.astype(np.uint8).reshape(256, 384)], 1)
    return bytes(head) + rows.tobytes()


def photo_ycc(rgb: np.ndarray):
    """(Y, C1, C2) of a 512 x 768 RGB image, PhotoYCC's ranges roughly (the
    chroma halved in both directions): an image for :func:`pcd_file`."""
    v = rgb.astype(np.float64)
    luma = v @ [0.299, 0.587, 0.114]
    c1 = (v[..., 2] - luma) / 2.2179 + 156
    c2 = (v[..., 0] - luma) / 1.8215 + 137
    half = lambda c: c.reshape(256, 2, 384, 2).mean((1, 3))  # noqa: E731
    clip = lambda c: np.clip(np.rint(c), 0, 255).astype(np.uint8)  # noqa: E731
    return clip(luma / 1.3584), clip(half(c1)), clip(half(c2))


def im_file(image_type: bytes, w: int, h: int, body: bytes, lut: bytes = b"",
            lines=()) -> bytes:
    """An IFUNC IM file as Pillow's save lays it out: the header lines,
    zeros up to a 0x1A at byte 511, a ``Lut``'s 768 bytes, then ``body``
    (its rows bottom-up, as the caller gives them)."""
    head = (b"Image type: %s image\r\nImage size (x*y): %d*%d\r\nFile size (no of images): 1\r\n"
            % (image_type, w, h) + b"".join(line + b"\r\n" for line in lines)
            + (b"Lut: 1\r\n" if lut else b""))
    return head + bytes(511 - len(head)) + b"\x1a" + lut + body


def blp_file(version: int, w: int, h: int, mip: bytes, *, palette=None, alpha: int = 0,
             compression: int = 1, encoding: int = 1, alpha_encoding: int = 0,
             jpeg_header: bytes = b"") -> bytes:
    """A BLP1 or BLP2 texture of one mipmap: BLP1 as JPEG (compression 0,
    ``jpeg_header`` shared) or indexed (encoding 4 or 5, ``palette`` (256,
    3) RGB stored BGRA); BLP2 indexed (encoding 1) or DXT (2) with alpha
    encoding 0, 1 or 7."""
    pal = np.zeros((256, 4), np.uint8)
    if palette is not None:
        pal[:len(palette), :3] = np.asarray(palette, np.uint8)[:, ::-1]
        pal[:, 3] = 255
    if version == 1:
        head = b"BLP1" + struct.pack("<iIIIii", compression, alpha, w, h, encoding, 0)
        extra = (struct.pack("<I", len(jpeg_header)) + jpeg_header if compression == 0
                 else pal.tobytes())
    else:
        head = b"BLP2" + struct.pack("<i4bII", compression, encoding, alpha, alpha_encoding, 0,
                                     w, h)
        extra = pal.tobytes()
    start = len(head) + 128 + len(extra)
    return (head + struct.pack("<16I", start, *[0] * 15) + struct.pack("<16I", len(mip), *[0] * 15)
            + extra + mip)


def tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW: a clear code first, codes of 9 to 12 bits written most
    significant bit first, each width taken one code early (as libtiff's
    encoder does), a clear code before the table fills, EOI last."""
    clear, eoi = 256, 257
    codes, widths = [clear], [9]
    table, nxt, nbits = {}, 258, 9
    data = bytes(data)
    w = data[0] if data else None
    for c in data[1:]:
        key = (w << 8) | c  # a string: its prefix's code and its last byte
        code = table.get(key)
        if code is not None:
            w = code
            continue
        codes.append(w)
        widths.append(nbits)
        table[key] = nxt
        nxt += 1
        if nxt > (1 << nbits) - 1 and nbits < 12:
            nbits += 1
        if nxt >= 4093:
            codes.append(clear)
            widths.append(nbits)
            table, nxt, nbits = {}, 258, 9
        w = c
    if w is not None:
        codes.append(w)
        widths.append(nbits)
        nxt += 1
        if nxt > (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    codes.append(eoi)
    widths.append(nbits)
    return _pack_bits(np.array(codes, np.uint64), np.array(widths, np.int64), stuff=False,
                      pad=0)


# ITU T.4 run-length codes: terminating codes 0..63, then the make-up codes
# of 64..1728 by 64, of white and of black runs; the make-up codes of either
# colour from 1792 to 2560
FAX_WHITE = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
    "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
    "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
    "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
    "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100 11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 011010101 "
    "011010110 011010111 011011000 011011001 011011010 011011011 010011000 010011001 "
    "010011010 011000 010011011").split()
FAX_BLACK = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 "
    "00000100 00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 "
    "00001101100 00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 000011010111 "
    "000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
    "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 "
    "000000100100 000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 000001100111 "
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 "
    "000000110101 0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 "
    "0000001001101 0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 "
    "0000001011011 0000001100100 0000001100101").split()
FAX_EXTENDED = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
                "000000010101 000000010110 000000010111 000000011100 000000011101 "
                "000000011110 000000011111").split()
FAX_EOL = "000000000001"
FAX_VERTICAL = {0: "1", 1: "011", 2: "000011", 3: "0000011", -1: "010", -2: "000010",
                -3: "0000010"}


def _fax_run(n: int, black: bool) -> str:
    return "".join(_fax_run_codes(n, black))


def _fax_run_codes(n: int, black: bool) -> list:
    """A run's make-up codes, then its terminating code."""
    codes = FAX_BLACK if black else FAX_WHITE
    out = []
    while n >= 2560:
        out.append(FAX_EXTENDED[-1])
        n -= 2560
    if n >= 1792:
        out.append(FAX_EXTENDED[(n - 1792) // 64])
        n %= 64
    elif n >= 64:
        out.append(codes[63 + n // 64])
        n %= 64
    return out + [codes[n]]


def _fax_changes(row: np.ndarray) -> list:
    """The columns where a row of 0/1 pixels (1 = black) changes colour,
    white before the first."""
    r = row.astype(np.int8)
    return np.flatnonzero(np.diff(np.concatenate([[0], r]))).tolist()


def _fax_1d(row: np.ndarray) -> str:
    w = len(row)
    ch = _fax_changes(row) + [w]
    out, a0, black = [], 0, False
    for c in ch:
        out.append(_fax_run(c - a0, black))
        a0, black = c, not black
        if c >= w:
            break
    return "".join(out)


def _rlew(black: np.ndarray) -> str:
    """CCITT RLEW rows (compression 32771) where libtiff 4.7's Fax3DecodeRLE
    looks for them. Its FAXMODE_WORDALIGN keeps the whole 16-bit words of its
    bit accumulator and, where none are left, skips an odd byte: so a row
    starts after the bytes its decoder loaded for the row before (up to two
    for each code, to hold 12 bits for a white code and 13 for a black one),
    on a word of the strip (at an even offset) only where none was left over.
    A writer that pads every row to a word reads apart from it."""
    bits, pos, loaded, avail = [], 0, 0, 0
    for row in black:
        w = len(row)
        a0, colour = 0, False
        for c in _fax_changes(row) + [w]:
            for code in _fax_run_codes(c - a0, colour):
                for _ in range(2):  # NeedBits16
                    if avail < (13 if colour else 12):
                        loaded, avail = loaded + 1, avail + 8
                bits.append(code)
                pos, avail = pos + len(code), avail - len(code)
            a0, colour = c, not colour
            if c >= w:
                break
        avail -= avail & 15
        if avail == 0 and loaded & 1:
            loaded += 1
        bits.append("0" * (8 * loaded - avail - pos))
        pos = 8 * loaded - avail
    return "".join(bits)


def _fax_2d(row: np.ndarray, ref: np.ndarray) -> str:
    w = len(row)
    cur, up = _fax_changes(row), _fax_changes(ref)
    cur_s, up_s = cur + [w, w], up + [w, w]
    out, a0, black = [], -1, False
    while a0 < w:
        a1 = next(c for c in cur_s if c > a0)
        i = next(k for k, c in enumerate(up_s) if c > a0)
        if (i & 1) != int(black):
            i += 1
        b1 = up_s[i] if i < len(up_s) else w
        b2 = up_s[i + 1] if i + 1 < len(up_s) else w
        if b2 < a1:
            out.append("0001")
            a0 = b2
        elif abs(a1 - b1) <= 3:
            out.append(FAX_VERTICAL[a1 - b1])
            a0, black = a1, not black
        else:
            a2 = next((c for c in cur_s if c > a1), w)
            out.append("001" + _fax_run(a1 - max(a0, 0), black) + _fax_run(a2 - a1, not black))
            a0 = a2
    return "".join(out)


def fax_encode(black: np.ndarray, compression: int, t4options: int = 0, k: int = 4) -> bytes:
    """Rows of 0/1 pixels (1 = black) as CCITT modified Huffman RLE
    (compression 2: each row 1-D, byte-aligned), Group 3 (3: an EOL before
    each row; with T4Options bit 0 a tag bit after it and every ``k``-th
    row 1-D, the rest 2-D; bit 2 pads each EOL to end a byte; RTC last),
    Group 4 (4: every row 2-D, EOFB last) or RLEW (32771: :func:`_rlew`)."""
    bits, ref = [], np.zeros(black.shape[1], np.uint8)
    if compression == 32771:
        bits, black = [_rlew(black)], ()

    def eol():
        if t4options & 4:  # fill bits: the EOL ends on a byte boundary
            n = sum(map(len, bits))
            bits.append("0" * ((4 - n) % 8))
        bits.append(FAX_EOL)
    for y, row in enumerate(black):
        if compression == 2:  # rows end on a byte
            code = _fax_1d(row)
            code += "0" * (-len(code) % 8)
        elif compression == 3:
            eol()
            if t4options & 1:
                one_d = y % k == 0
                code = ("1" + _fax_1d(row)) if one_d else ("0" + _fax_2d(row, ref))
            else:
                code = _fax_1d(row)
        else:
            code = _fax_2d(row, ref)
        bits.append(code)
        ref = row
    if compression == 3:
        for _ in range(6):
            bits.append(FAX_EOL + ("1" if t4options & 1 else ""))
    elif compression == 4:
        bits.append(FAX_EOL * 2)
    s = "".join(bits)
    s += "0" * (-len(s) % 8)
    return int(s, 2).to_bytes(len(s) // 8, "big") if s else b""


_THUNDER_2BIT = {0: 0, 1: 1, -1: 3}
_THUNDER_3BIT = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}


def thunder_encode(rows: np.ndarray) -> bytes:
    """4-bit rows (H, W) as ThunderScan (compression 32809) codes, each row
    from a last pixel of 0: runs of the last pixel (up to 63), three 2-bit
    deltas, two 3-bit deltas (or one, the second skipped), else a raw
    value."""
    out = bytearray()
    for row in np.asarray(rows, np.int64):
        last, i, w = 0, 0, len(row)
        while i < w:
            n = 0
            while i + n < w and n < 63 and row[i + n] == last:
                n += 1
            if n >= 2:
                out.append(n)
                i += n
                continue
            d = [int((row[i + k] - (last if k == 0 else row[i + k - 1]) + 8) % 16 - 8)
                 for k in range(min(3, w - i))]
            if len(d) == 3 and all(x in _THUNDER_2BIT for x in d):
                out.append(0x40 | _THUNDER_2BIT[d[0]] << 4 | _THUNDER_2BIT[d[1]] << 2
                           | _THUNDER_2BIT[d[2]])
                i += 3
            elif d[0] in _THUNDER_3BIT:
                second = len(d) > 1 and d[1] in _THUNDER_3BIT
                out.append(0x80 | _THUNDER_3BIT[d[0]] << 3 | (_THUNDER_3BIT[d[1]] if second else 4))
                i += 2 if second else 1
            else:
                out.append(0xC0 | int(row[i]))
                i += 1
            last = int(row[i - 1])
    return bytes(out)


def jpeg_tables_split(jpeg: bytes):
    """A JPEG cut as JPEG-in-TIFF stores it: (JPEGTables, strip): the
    quantization and Huffman tables as an abbreviated table-only stream,
    the rest (SOI, frame, scans, EOI) as the strip's data."""
    pos, tables, rest = 2, b"", b"\xff\xd8"
    while True:
        marker = jpeg[pos + 1]
        (n,) = struct.unpack(">H", jpeg[pos + 2:pos + 4])
        seg = jpeg[pos:pos + 2 + n]
        if marker == 0xDA:
            return b"\xff\xd8" + tables + b"\xff\xd9", rest + jpeg[pos:]
        if marker in (0xDB, 0xC4):
            tables += seg
        elif not 0xE0 <= marker <= 0xEF:
            rest += seg
        pos += 2 + n


def _tiff_pack(plane: np.ndarray, bits: int, order: str) -> bytes:
    """Rows of samples (H, W*spp) as bytes: packed most significant bit
    first below 8 bits and at 12 (each row padded to a byte), in ``order``
    at 16 and 32."""
    if bits < 8:
        return b"".join(_row_bytes(r[:, None], bits).tobytes() for r in plane)
    if bits == 12:  # two samples in three bytes, most significant bits first
        v = plane.astype(np.uint16)
        nib = np.stack([v >> 8, v >> 4 & 15, v & 15], -1).reshape(v.shape[0], -1)
        nib = np.pad(nib, ((0, 0), (0, nib.shape[1] % 2)))
        return ((nib[:, 0::2] << 4) | nib[:, 1::2]).astype(np.uint8).tobytes()
    if bits == 8:
        return plane.astype(np.uint8).tobytes()
    if plane.dtype.kind == "f":
        return plane.astype(order + "f4").tobytes()
    return plane.astype(order + {16: "u2", 32: "u4"}[bits]).tobytes()


def _ycbcr_units(block: np.ndarray, hs: int, vs: int) -> np.ndarray:
    """(rows, W, 3) Y, Cb, Cr samples as TIFF's subsampled YCbCr data units,
    a row of units per ``vs`` rows: ``hs * vs`` luma samples, then the
    block's top-left Cb and Cr (edges padded with the last sample)."""
    h, w = block.shape[:2]
    bh, bw = -(-h // vs), -(-w // hs)
    full = np.pad(block, ((0, bh * vs - h), (0, bw * hs - w), (0, 0)), mode="edge")
    y = full[..., 0].reshape(bh, vs, bw, hs).transpose(0, 2, 1, 3).reshape(bh, bw, vs * hs)
    chroma = full[::vs, ::hs, 1:]
    return np.concatenate([y, chroma], -1).reshape(bh, -1)


def _tiff_diff(block: np.ndarray, spp: int, bits: int) -> np.ndarray:
    """Horizontal differencing (Predictor 2) of (rows, W*spp) samples."""
    d = block.astype(np.int64).copy()
    d[:, spp:] -= block.astype(np.int64)[:, :-spp]
    return (d % (1 << bits)).astype(np.uint64)


def _tiff_fp_diff(block: np.ndarray, spp: int, bits: int) -> bytes:
    """The floating-point predictor (Predictor 3) of (rows, W*spp) floats,
    as tif_predict.c's fpDiff writes it: each row's bytes as planes (every
    sample's most significant byte, then the next), then each byte less the
    one ``spp`` bytes before it."""
    n = bits // 8
    h = block.shape[0]
    be = np.ascontiguousarray(block.astype(">f" + str(n))).view(np.uint8).reshape(h, -1, n)
    planes = be.transpose(0, 2, 1).reshape(h, -1).astype(np.int64)
    planes[:, spp:] -= planes[:, :-spp].copy()
    return (planes % 256).astype(np.uint8).tobytes()


def tiff_file(samples: np.ndarray, photometric: int, bits: int = 8, compression: int = 1,
              big_endian: bool = False, bigtiff: bool = False, rows_per_strip: int = None,
              tile=None, planar: int = 1, predictor: int = 1, extra=(), sample_format=None,
              fill_order: int = 1, colormap=None, orientation: int = None, xmp: bytes = None,
              t4options: int = None, ycbcr_subsampling=None, jpeg=None, tags=None,
              lead: int = 0) -> bytes:
    """A one-page TIFF of ``samples`` (H, W, spp) at ``bits`` a sample.

    Strips of ``rows_per_strip`` rows (all rows by default), or tiles of
    ``tile`` (width, height) padded past the image's edge; PlanarConfiguration
    ``planar`` 1 (chunky) or 2 (a plane a sample); Predictor 2 (horizontal
    differencing) or 3 (floating point, of float samples); ``compression`` 1
    (none), 2/3/4/32771 (CCITT, ``bits`` 1, 1 = black pixels), 32809
    (ThunderScan, ``bits`` 4), 5 (LZW), 8/32946 (Deflate), 32773 (PackBits),
    34925 (LZMA, an xz stream), 50000 (ZSTD, a zstd frame) or 7 (JPEG:
    ``jpeg(block) -> JPEG bytes`` codes each strip or tile, its tables going
    to JPEGTables); FillOrder 2 reverses each coded byte's bits; big-endian (``MM``) or little-endian, classic or
    BigTIFF; an Orientation tag, an XMP packet, a ColorMap (N, 3) of 16-bit
    entries and any more ``tags`` ({tag: (type, values)}). YCbCr samples
    (photometric 6) not coded as JPEG are written as the data units of
    ``ycbcr_subsampling``. ``lead`` bytes come before the first strip or tile
    (an odd number puts every one at an odd offset)."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, spp = samples.shape
    order = ">" if big_endian else "<"
    tw, th = tile if tile else (w, rows_per_strip or h)
    across, down = (-(-w // tw), -(-h // th))
    planes = [samples] if planar == 1 else [samples[..., i:i + 1] for i in range(spp)]
    blobs = []
    tables = None
    for plane in planes:
        for ty in range(down):
            for tx in range(across if tile else 1):
                if tile:  # padded with the edge's samples
                    block = plane[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw]
                    block = np.pad(block, ((0, th - block.shape[0]), (0, tw - block.shape[1]),
                                           (0, 0)), mode="edge")
                else:
                    block = plane[ty * th:(ty + 1) * th]
                rows = block.reshape(block.shape[0], -1)
                if photometric == 6 and compression != 7 and ycbcr_subsampling:
                    rows = _ycbcr_units(block, *ycbcr_subsampling)
                if predictor == 2:
                    rows = _tiff_diff(rows, block.shape[2], bits)
                if compression in (2, 3, 4, 32771):
                    raw = fax_encode(rows, compression, t4options or 0)
                elif compression == 32809:
                    raw = thunder_encode(rows)
                elif compression == 7:
                    tables, raw = jpeg_tables_split(jpeg(block))
                else:
                    raw = (_tiff_fp_diff(rows, block.shape[2], bits) if predictor == 3
                           else _tiff_pack(rows, bits, order))
                    if compression == 5:
                        raw = tiff_lzw(raw)
                    elif compression in (8, 32946):
                        raw = zlib.compress(raw, 9)
                    elif compression == 32773:
                        raw = packbits(raw)
                    elif compression == 34925:
                        import lzma
                        raw = lzma.compress(raw, check=lzma.CHECK_NONE)
                    elif compression == 50000:
                        raw = zstd_compress(raw)
                if fill_order == 2 and compression != 7:
                    raw = bytes(int(f"{b:08b}"[::-1], 2) for b in raw)
                blobs.append(raw)
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
               262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if fill_order != 1:
        entries[266] = (3, [fill_order])
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra:
        entries[338] = (3, list(extra))
    if sample_format is not None:
        entries[339] = (3, [sample_format] * spp)
    if colormap is not None:
        cm = np.asarray(colormap, np.int64)
        entries[320] = (3, cm[:, 0].tolist() + cm[:, 1].tolist() + cm[:, 2].tolist())
    if orientation is not None:
        entries[274] = (3, [orientation])
    if xmp is not None:
        entries[700] = (1, xmp)
    if t4options is not None:
        entries[292 if compression == 3 else 293] = (4, [t4options])
    if ycbcr_subsampling is not None:
        entries[530] = (3, list(ycbcr_subsampling))
    if tables is not None:
        entries[347] = (7, tables)
    entries.update(tags or {})
    off_type = 16 if bigtiff else 4
    head = 16 if bigtiff else 8
    data, offsets = bytes(lead), []
    for b in blobs:
        offsets.append(head + len(data))
        data += b + (b"\x00" if len(b) % 2 else b"")
    if tile:
        entries[322], entries[323] = (3, [tw]), (3, [th])
        entries[324], entries[325] = (off_type, offsets), (off_type, [len(b) for b in blobs])
    else:
        entries[278] = (4, [th])
        entries[273], entries[279] = (off_type, offsets), (off_type, [len(b) for b in blobs])
    ifd_pos = head + len(data)
    fmt = {1: "B", 2: "B", 3: "H", 4: "L", 5: "L", 7: "B", 16: "Q"}
    count_fmt, entry_size, inline = ("Q", 20, 8) if bigtiff else ("H", 12, 4)
    extra_pos = ifd_pos + (8 if bigtiff else 2) + entry_size * len(entries) + (8 if bigtiff else 4)
    ifd, tail = struct.pack(order + count_fmt, len(entries)), b""
    for tag in sorted(entries):
        typ, vals = entries[tag]
        if isinstance(vals, (bytes, bytearray)):
            raw = bytes(vals)
            count = len(raw)
        elif typ == 5:
            raw = b"".join(struct.pack(order + "LL", *v) for v in vals)
            count = len(vals)
        else:
            raw = struct.pack(order + fmt[typ] * len(vals), *vals)
            count = len(vals)
        if len(raw) <= inline:
            field = raw.ljust(inline, b"\x00")
        else:
            field = struct.pack(order + ("Q" if bigtiff else "L"), extra_pos + len(tail))
            tail += raw + (b"\x00" if len(raw) % 2 else b"")
        ifd += struct.pack(order + ("HHQ" if bigtiff else "HHL"), tag, typ, count) + field
    ifd += struct.pack(order + ("Q" if bigtiff else "L"), 0)
    if bigtiff:
        hdr = (b"MM" if big_endian else b"II") + struct.pack(order + "HHHQ", 43, 8, 0, ifd_pos)
    else:
        hdr = (b"MM" if big_endian else b"II") + struct.pack(order + "HL", 42, ifd_pos)
    return hdr + data + ifd + tail


# a Huffman table of the 17 lossless difference categories: code lengths
_LL_LENGTHS = (2, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14)


def _ll_table():
    """(code, length) of each category 0..16, canonical, and the DHT body."""
    order = sorted(range(17), key=lambda s: (_LL_LENGTHS[s], s))
    codes, code, prev = {}, 0, 0
    for sym in order:
        code <<= _LL_LENGTHS[sym] - prev
        prev = _LL_LENGTHS[sym]
        codes[sym] = (code, prev)
        code += 1
    bits = [sum(1 for s in range(17) if _LL_LENGTHS[s] == n) for n in range(1, 17)]
    return codes, bytes([0x00] + bits) + bytes(order)


def _pack_bits(values: np.ndarray, lengths: np.ndarray, stuff: bool = True,
               pad: int = 1) -> bytes:
    """Values (uint64, each ``length`` bits, at most 32) written most
    significant bit first, the last byte padded with ``pad`` bits, every
    0xFF byte followed by a stuffed zero (a JPEG scan's) if ``stuff``."""
    values, lengths = values.astype(np.uint64), lengths.astype(np.int64)
    out = []
    for i in range(0, len(values), 1 << 20):  # in chunks: 32 bits a value in memory
        v, n = values[i:i + 1 << 20], lengths[i:i + 1 << 20]
        bits = np.unpackbits(v.astype(">u4").view(np.uint8).reshape(-1, 4), axis=1)
        keep = np.arange(32)[None, :] >= (32 - n)[:, None]
        out.append(bits[keep])
    bits = np.concatenate(out) if out else np.zeros(0, np.uint8)
    bits = np.concatenate([bits, np.full(-len(bits) % 8, pad, np.uint8)])
    data = np.packbits(bits)
    if not stuff:
        return data.tobytes()
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def lossless_jpeg(planes, predictor: int = 1, point_transform: int = 0, sampling=None,
                  restart_rows: int = 0, interleaved: bool = True, markers: bytes = b"") -> bytes:
    """A lossless JPEG (SOF3, ITU T.81 H) of 8-bit ``planes`` (an (H, W)
    array, an (H, W, C) array, or a list of (h, w) planes sampled
    ``sampling`` [(h, v), ...] of the image): predictor 1..7, a point
    transform, a restart marker every ``restart_rows`` MCU rows, one
    interleaved scan or a scan a component; ``markers`` (APPn segments) go
    after SOI. Component ids are 1, 2, 3, ...: without a JFIF or Adobe
    marker libjpeg-turbo reads three of them as RGB."""
    if isinstance(planes, np.ndarray):
        planes = [planes] if planes.ndim == 2 else [planes[..., c] for c in range(planes.shape[2])]
    sampling = sampling or [(1, 1)] * len(planes)
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    height = max(p.shape[0] * vmax // v for p, (_, v) in zip(planes, sampling))
    width = max(p.shape[1] * hmax // h for p, (h, _) in zip(planes, sampling))
    codes, dht = _ll_table()
    code_of = np.array([codes[s][0] for s in range(17)], np.uint64)
    len_of = np.array([codes[s][1] for s in range(17)], np.int64)
    pt, P = point_transform, 8

    def diffs(x: np.ndarray, v: int, rows_restart: int) -> np.ndarray:
        """Each sample's difference from its predictor, modulo 2^16."""
        x = x.astype(np.int64) >> pt
        ra = np.concatenate([np.zeros((x.shape[0], 1), np.int64), x[:, :-1]], 1)
        rb = np.concatenate([np.zeros((1, x.shape[1]), np.int64), x[:-1]], 0)
        rc = np.concatenate([np.zeros((x.shape[0], 1), np.int64), rb[:, :-1]], 1)
        pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor].copy()
        pred[:, 0] = rb[:, 0]
        first = np.arange(x.shape[0]) % (v * rows_restart) == 0 if rows_restart else (
            np.arange(x.shape[0]) == 0)
        pred[first] = ra[first]
        pred[first, 0] = 1 << (P - pt - 1)
        return (x - pred) & 0xFFFF

    def coded(d: np.ndarray):
        """Each difference's (Huffman code + magnitude bits, length)."""
        sd = np.where(d >= 0x8000, d - 0x10000, d)
        cat = np.where(sd == -0x8000, 16, np.ceil(np.log2(np.abs(sd) + 1)).astype(np.int64))
        mag = np.where(sd >= 0, sd, sd - 1) & ((np.int64(1) << cat) - 1)
        mag = np.where(cat == 16, 0, mag)
        extra = np.where(cat == 16, 0, cat)
        value = (code_of[cat] << extra.astype(np.uint64)) | mag.astype(np.uint64)
        return value, len_of[cat] + extra

    def seg(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    out = b"\xff\xd8" + markers + seg(0xC3, struct.pack(">BHHB", 8, height, width, len(planes))
                                      + b"".join(bytes([i + 1, h << 4 | v, 0])
                                                 for i, (h, v) in enumerate(sampling)))
    out += seg(0xC4, dht)
    scans = [list(range(len(planes)))] if interleaved else [[i] for i in range(len(planes))]
    for comps in scans:
        one = len(comps) == 1
        mx = planes[comps[0]].shape[1] if one else -(-width // hmax)
        my = planes[comps[0]].shape[0] if one else -(-height // vmax)
        if restart_rows:
            out += seg(0xDD, struct.pack(">H", restart_rows * mx))
        out += seg(0xDA, bytes([len(comps)]) + b"".join(bytes([c + 1, 0]) for c in comps)
                   + bytes([predictor, 0, pt]))
        # each component's differences laid out by MCU: (my, mx, v, h)
        units = []
        for c in comps:
            h, v = (1, 1) if one else sampling[c]
            d = diffs(planes[c], v, restart_rows)
            full = np.zeros((my * v, mx * h), np.int64)  # padding samples code as 0
            full[:d.shape[0], :d.shape[1]] = d
            units.append(full.reshape(my, v, mx, h).transpose(0, 2, 1, 3).reshape(my, mx, -1))
        order = np.concatenate(units, -1)  # (my, mx, samples an MCU)
        blocks = [order] if not restart_rows else [order[r:r + restart_rows]
                                                   for r in range(0, my, restart_rows)]
        for k, blk in enumerate(blocks):
            vals, lens = coded(blk.reshape(-1))
            out += _pack_bits(vals, lens)
            if k + 1 < len(blocks):
                out += bytes([0xFF, 0xD0 + k % 8])
    return out + b"\xff\xd9"


_ARITH_HELPER = r"""
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>
/* argv: width height components quality progressive restart h v infile outfile */
int main(int argc, char** argv) {
  if (argc != 11) return 2;
  int w = atoi(argv[1]), h = atoi(argv[2]), c = atoi(argv[3]);
  size_t n = (size_t)w * h * c;
  unsigned char* px = malloc(n);
  FILE* in = fopen(argv[9], "rb");
  if (!px || !in || fread(px, 1, n, in) != n) return 3;
  fclose(in);
  struct jpeg_compress_struct ci;
  struct jpeg_error_mgr je;
  ci.err = jpeg_std_error(&je);
  jpeg_create_compress(&ci);
  FILE* out = fopen(argv[10], "wb");
  jpeg_stdio_dest(&ci, out);
  ci.image_width = w;
  ci.image_height = h;
  ci.input_components = c;
  ci.in_color_space = c == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&ci);
  jpeg_set_quality(&ci, atoi(argv[4]), TRUE);
  ci.arith_code = TRUE;
  ci.restart_interval = atoi(argv[6]);
  if (c == 3) {
    ci.comp_info[0].h_samp_factor = atoi(argv[7]);
    ci.comp_info[0].v_samp_factor = atoi(argv[8]);
  }
  if (atoi(argv[5])) jpeg_simple_progression(&ci);
  jpeg_start_compress(&ci, TRUE);
  while (ci.next_scanline < ci.image_height) {
    JSAMPROW row = px + (size_t)ci.next_scanline * w * c;
    jpeg_write_scanlines(&ci, &row, 1);
  }
  jpeg_finish_compress(&ci);
  fclose(out);
  jpeg_destroy_compress(&ci);
  free(px);
  return 0;
}
"""


_arith_exe = {}


def arith_jpeg(rgb: np.ndarray, quality: int = 90, progressive: bool = False,
               restart: int = 0, sampling=(2, 2)) -> bytes:
    """An arithmetic-coded JPEG of (H, W, 3) or (H, W) uint8 written by the
    system's libjpeg (``arith_code = TRUE``, with ``jpeg_simple_progression``
    for a progressive file): a small C helper built once a process against
    ``jpeglib.h`` and linked with ``-ljpeg``, as Pillow writes no arithmetic
    coding."""
    import atexit
    import shutil
    import subprocess
    import tempfile

    rgb = np.ascontiguousarray(rgb, np.uint8)
    comps = 1 if rgb.ndim == 2 else 3
    if "exe" not in _arith_exe:
        tmp = tempfile.mkdtemp(prefix="arith_jpeg_")
        atexit.register(shutil.rmtree, tmp, True)
        src, exe = os.path.join(tmp, "arith.c"), os.path.join(tmp, "arith")
        with open(src, "w") as f:
            f.write(_ARITH_HELPER)
        subprocess.run([os.environ.get("CC", "cc"), "-O1", "-o", exe, src, "-ljpeg"], check=True)
        _arith_exe["exe"] = exe
    exe = _arith_exe["exe"]
    with tempfile.TemporaryDirectory() as tmp:
        raw, out = os.path.join(tmp, "in.raw"), os.path.join(tmp, "out.jpg")
        with open(raw, "wb") as f:
            f.write(rgb.tobytes())
        subprocess.run([exe, str(rgb.shape[1]), str(rgb.shape[0]), str(comps), str(quality),
                        str(int(progressive)), str(restart), str(sampling[0]), str(sampling[1]),
                        raw, out], check=True)
        with open(out, "rb") as f:
            return f.read()


def jpeg_scans(data: bytes):
    """(header, scans, tail) of a JPEG: the bytes before its first SOS, each
    scan with the tables before the next, and the EOI."""
    starts, pos = [], 2
    while pos < len(data):
        if data[pos] != 0xFF or data[pos + 1] in (0x00, 0xFF) or 0xD0 <= data[pos + 1] <= 0xD7:
            pos += 1
            continue
        if data[pos + 1] == 0xD9:
            break
        if data[pos + 1] == 0xDA:
            starts.append(pos)
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
    ends = starts[1:] + [pos]
    return data[:starts[0]], [data[a:b] for a, b in zip(starts, ends)], data[pos:]


def cut_progressive(data: bytes, scans: int) -> bytes:
    """A progressive JPEG cut after its first ``scans`` scans, its EOI kept:
    what a download cut short between scans leaves, and what libjpeg-turbo
    block-smooths (jdcoefct.c decompress_smooth_data)."""
    head, parts, tail = jpeg_scans(data)
    return head + b"".join(parts[:scans]) + tail


def scene(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A smooth colour scene with a little noise (small files)."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0, 1, h)[:, None]
    x = np.linspace(0, 1, w)[None]
    a = np.stack([128 + 90 * np.sin(6 * x + 2 * y), 128 + 90 * np.cos(4 * y + 3 * x),
                  128 + 70 * np.sin(9 * x * y)], -1)
    return np.clip(a + rng.normal(0, 2, a.shape), 0, 255).astype(np.uint8)


def smooth_scene(n: int) -> np.ndarray:
    """A smooth n² colour image with no noise: compresses far in lossless
    codings."""
    y = np.linspace(0, 1, n)[:, None]
    x = np.linspace(0, 1, n)[None]
    return np.stack([128 + 90 * np.sin(3 * x + y), 128 + 90 * np.cos(2 * y + 1.5 * x),
                     128 + 70 * np.sin(4.5 * x * y)], -1).astype(np.uint8)


def pil_rgb(data: bytes) -> np.ndarray:
    from PIL import Image, ImageOps

    return np.asarray(ImageOps.exif_transpose(Image.open(io.BytesIO(data))).convert("RGB"))


# --- LittleCMS, the library Pillow converts CIELab with (test oracles) -------
#
# Pillow's wheel bundles liblcms2 2.17; these call it through ctypes, as
# Pillow's ImageCms builds the transform of ``convert("RGB")`` on a LAB image
# (cmsCreateLab2Profile(NULL) to cmsCreate_sRGBProfile(), perceptual). Only
# tests use them; they return None where the library is absent.

TYPE_LAB_8, TYPE_LAB_16 = (10 << 16) | (3 << 3) | 1, (10 << 16) | (3 << 3) | 2
TYPE_RGB_8, TYPE_RGB_16 = (4 << 16) | (3 << 3) | 1, (4 << 16) | (3 << 3) | 2
CMS_FLAGS_NOOPTIMIZE = 0x0100
_lcms = {}


def lcms():
    """Pillow's bundled liblcms2 (ctypes), or None."""
    import ctypes
    import glob

    if "lib" not in _lcms:
        try:
            import PIL
        except ImportError:
            _lcms["lib"] = None
            return None
        found = glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs",
                                       "liblcms2-*.so*"))
        lib = ctypes.CDLL(found[0]) if found else None
        if lib is not None:
            vp, u32 = ctypes.c_void_p, ctypes.c_uint32
            for name in ("cmsCreateLab2Profile", "cmsCreate_sRGBProfile", "cmsCreateTransform",
                         "cmsReadTag"):
                getattr(lib, name).restype = vp
            lib.cmsCreateLab2Profile.argtypes = [vp]
            lib.cmsCreateTransform.argtypes = [vp, u32, vp, u32, u32, u32]
            lib.cmsDoTransform.argtypes = [vp, vp, vp, u32]
            lib.cmsReadTag.argtypes = [vp, u32]
            for name in ("cmsDeleteTransform", "cmsCloseProfile"):
                getattr(lib, name).argtypes = [vp]
        _lcms["lib"] = lib
    return _lcms["lib"]


def lcms_lab_to_rgb(lab: np.ndarray, lab_type: int = TYPE_LAB_8, rgb_type: int = TYPE_RGB_8,
                    flags: int = 0):
    """(N, 3) Lab → (N, 3) RGB through LittleCMS's transform from its Lab v2
    profile to its sRGB profile at ``lab_type`` / ``rgb_type`` (uint8 at 8
    bits, uint16 at 16) with ``flags``; None without the library."""
    lib = lcms()
    if lib is None:
        return None
    lab_p, srgb_p = lib.cmsCreateLab2Profile(None), lib.cmsCreate_sRGBProfile()
    xform = lib.cmsCreateTransform(lab_p, lab_type, srgb_p, rgb_type, 0, flags)
    lab = np.ascontiguousarray(lab)
    out = np.empty(lab.shape, np.uint16 if rgb_type == TYPE_RGB_16 else np.uint8)
    lib.cmsDoTransform(xform, lab.ctypes.data, out.ctypes.data, len(lab))
    lib.cmsDeleteTransform(xform)
    lib.cmsCloseProfile(lab_p)
    lib.cmsCloseProfile(srgb_p)
    return out


def lcms_srgb_colorants():
    """The built-in sRGB profile's rXYZ, gXYZ and bXYZ tags as LittleCMS
    holds them (doubles), as the columns of a (3, 3) RGB → XYZ matrix; None
    without the library."""
    import ctypes

    lib = lcms()
    if lib is None:
        return None
    srgb = lib.cmsCreate_sRGBProfile()
    cols = [np.ctypeslib.as_array(ctypes.cast(lib.cmsReadTag(srgb, tag),
                                              ctypes.POINTER(ctypes.c_double)), (3,)).copy()
            for tag in (0x7258595A, 0x6758595A, 0x6258595A)]
    lib.cmsCloseProfile(srgb)
    return np.stack(cols, 1)


# realloc with what it adds zeroed, preloaded into a Pillow process
_FRESH_REALLOC = r"""
#include <malloc.h>
#include <string.h>
extern void *__libc_realloc(void *, size_t);
void *realloc(void *p, size_t n) {
  size_t old = p ? malloc_usable_size(p) : 0;
  void *q = __libc_realloc(p, n);
  if (q && n > old) memset((char *)q + old, 0, n - old);
  return q;
}
"""

_fresh_lib = {}


def _fresh_realloc() -> str:
    """A shared library, built once a process with the system's C compiler,
    whose ``realloc`` zeroes the bytes it adds."""
    import atexit
    import shutil
    import subprocess
    import tempfile

    if "lib" not in _fresh_lib:
        tmp = tempfile.mkdtemp(prefix="fresh_realloc_")
        atexit.register(shutil.rmtree, tmp, True)
        src, lib = os.path.join(tmp, "fresh.c"), os.path.join(tmp, "fresh.so")
        with open(src, "w") as f:
            f.write(_FRESH_REALLOC)
        subprocess.run([os.environ.get("CC", "cc"), "-O1", "-shared", "-fPIC", "-o", lib, src],
                       check=True)
        _fresh_lib["lib"] = lib
    return _fresh_lib["lib"]


def pil_rgb_c_idct(cases, fresh_memory: bool = False, host_zstd: bool = True) -> list:
    """:func:`pil_rgb` of each file (None where Pillow raises), in a
    subprocess with ``JSIMD_FORCENONE=1``: libjpeg-turbo's C code paths (its
    x86 SIMD IDCT differs on the out-of-range coefficients of damaged data),
    which the port's codec follows.

    ``fresh_memory``: the process's ``realloc`` zeroes what it adds. Pillow's
    libtiff decoder grows its strip buffer with ``realloc`` and never clears
    it, so where a JPEG or Group 4 strip leaves bytes unwritten the first
    strip's pixels are whatever the heap held (pointers, varying run to
    run); so they are the zeros a fresh allocation holds, as in the port.

    ``host_zstd``: the host's libzstd is preloaded, so that Pillow's libtiff
    calls it for ZSTD strips, as the port does (libzstd releases decode a
    damaged frame apart, and Pillow bundles a release of its own); False
    runs Pillow as it is installed."""
    import subprocess
    import sys
    import tempfile

    preload = ([_fresh_realloc()] if fresh_memory else []) + (["libzstd.so.1"] if host_zstd
                                                              else [])
    env = {**os.environ, "JSIMD_FORCENONE": "1", "LD_PRELOAD": " ".join(preload)}
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "cases.npz"), os.path.join(tmp, "out.npz")
        np.savez(src, *[np.frombuffer(c, np.uint8) for c in cases])
        script = (
            "import io, sys, warnings, numpy as np\n"
            "warnings.simplefilter('ignore')\n"
            "from PIL import Image, ImageOps\n"
            "z = np.load(sys.argv[1])\n"
            "out = {}\n"
            "for k in z.files:\n"
            "    try:\n"
            "        im = ImageOps.exif_transpose(Image.open(io.BytesIO(z[k].tobytes())))\n"
            "        out[k] = np.asarray(im.convert('RGB'))\n"
            "    except Exception:\n"
            "        pass\n"
            "np.savez(sys.argv[2], **out)\n")
        subprocess.run([sys.executable, "-c", script, src, dst], check=True, env=env,
                       capture_output=True)
        got = np.load(dst)
        return [got[f"arr_{i}"] if f"arr_{i}" in got.files else None
                for i in range(len(cases))]


def fixtures() -> dict:
    """{file name: bytes}."""
    from PIL import Image

    def jpeg(arr, **kw):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", quality=90, subsampling=2, **kw)
        return buf.getvalue()

    big = scene(1024, 1024, 1)
    # the scene in the high bytes, noise in the low ones
    rgb16 = scene(72, 88, 3).astype(np.uint16) * 256 + np.random.default_rng(4).integers(
        0, 256, (72, 88, 3), np.uint16)
    def save(im, fmt, **kw):
        buf = io.BytesIO()
        im.save(buf, fmt, **kw)
        return buf.getvalue()

    rng = np.random.default_rng(11)
    small = scene(40, 56, 7)
    cmyk = save(Image.fromarray(np.concatenate([small, small[..., :1] // 3], -1), "CMYK"),
                "JPEG", quality=90, subsampling=2, progressive=True)
    adobe = cmyk.index(b"Adobe") + 11
    jfif = jpeg(scene(36, 50, 8))
    app0 = jfif.index(b"\xff\xe0")
    rgb_coded = (jfif[:app0] + b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
                 + jfif[app0 + 2 + struct.unpack(">H", jfif[app0 + 2:app0 + 4])[0]:])
    pal = rng.integers(0, 256, (256, 3))
    idx = np.asarray(Image.fromarray(scene(33, 45, 9)).quantize(200))
    alpha = np.concatenate([small, rng.integers(0, 256, small.shape[:2] + (1,), np.uint8)], -1)
    smooth = smooth_scene(1024)
    return {
        "prog_512_420.jpg": jpeg(scene(512, 512, 0), progressive=True),
        "prog_1024.jpg": jpeg(big, progressive=True),
        "base_1024.jpg": jpeg(big),
        "adam7_rgb.png": png_file(scene(97, 131, 2), 2, interlace=True, seed=5),
        "rgb16.png": png_file(rgb16, 2, depth=16, seed=6),
        "cmyk.jpg": cmyk,
        "ycck.jpg": cmyk[:adobe] + b"\x02" + cmyk[adobe + 1:],
        "rgb_coded.jpg": rgb_coded,
        "pal8.bmp": bmp_file(idx, 8, palette=pal),
        "rgb24.bmp": bmp_file(scene(21, 19, 10), 24, header=124, top_down=True),
        "rle8.bmp": bmp_file(idx, 8, palette=pal, compression=1),
        "interlaced.gif": gif_file(idx, pal[:2], local=pal, offset=(4, 2), screen=(53, 40),
                                   interlace=True, transparency=7),
        "lossy.webp": save(Image.fromarray(small), "WEBP", quality=80),
        "lossy_alpha.webp": save(Image.fromarray(alpha, "RGBA"), "WEBP", quality=80),
        "lossless.webp": save(Image.fromarray(small), "WEBP", lossless=True),
        "lossy_1024.webp": save(Image.fromarray(smooth), "WEBP", quality=75),
        "lossless_1024.webp": save(Image.fromarray(smooth).quantize(8).convert("RGB"), "WEBP",
                                   lossless=True),
        **tiff_fixtures(),
        **tiff_more_fixtures(),
        **damaged_tiff_fixtures(),
        **jpeg_variant_fixtures(jpeg(scene(48, 64, 14), progressive=True), smooth),
        **raster_fixtures(),
        **small_fixtures(),
        **jpeg2000_fixtures(),
        **jpeg2000_decode_pair(),
        **avif_fixtures(),
    }


def raster_fixtures() -> dict:
    """The plain raster formats Pillow opens (PpmImagePlugin, DIB, ICO, CUR,
    TGA, PSD, QOI, PCX, DCX, SGI): Pillow's own files where it writes the
    format (PBM, PFM, QOI, a PNG icon), the rest from the writers above."""
    from PIL import Image

    def save(im, fmt, **kw):
        buf = io.BytesIO()
        im.save(buf, fmt, **kw)
        return buf.getvalue()

    rng = np.random.default_rng(21)
    rgb = scene(40, 56, 22)
    gray = rgb[..., 1]
    idx = (rgb[..., 0] >> 2).astype(np.uint8)  # 64 colours
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    rgba = np.concatenate([rgb, rng.integers(0, 256, rgb.shape[:2] + (1,), np.uint8)], -1)
    sq, small = scene(32, 32, 23), scene(16, 16, 24)
    png16 = save(Image.fromarray(small), "PNG")
    icon = icon_file([(16, 16, 0, 1, 32, png16),
                      (32, 32, 0, 1, 24, dib_entry(sq, 24, mask=sq[..., 0] > 128)),
                      (32, 32, 16, 1, 4, dib_entry(sq[..., 1] >> 4, 4, palette=pal[:16]))])
    cursor = icon_file([(16, 16, 0, 2, 3, dib_entry(small, 24)),
                        (32, 32, 0, 9, 9, dib_entry(np.concatenate([sq, sq[..., :1]], -1), 32))],
                       kind=2)
    return {
        "maxval1000.ppm": ppm_file(rgb.astype(np.uint16) * 1000 // 255, maxval=1000),
        "plain.pgm": ppm_file(gray[:20, :24].astype(np.uint16) * 200 // 255, maxval=200,
                              plain=True),
        "bitmap.pbm": save(Image.fromarray(gray > 120), "PPM"),
        "gray.pfm": save(Image.fromarray(gray.astype(np.float32) * np.float32(1.13) - 9), "PPM"),
        "pal8.dib": bmp_file(idx, 8, palette=pal)[14:],
        "icon.ico": icon,
        "icon_png.ico": save(Image.fromarray(sq), "ICO", sizes=[(16, 16), (32, 32)]),
        "cursor.cur": cursor,
        "cmap_rle.tga": tga_file(idx, 9, 8, colormap=pal[:70], first_entry=3, map_depth=16,
                                 flags=0),
        "rgb_rle_rtl.tga": tga_file(rgb, 10, 24, flags=0x30, image_id=b"codec fixture"),
        "rgb15.tga": tga_file(rgba, 2, 16, flags=0),
        "rgb_rle.psd": psd_file(rgb.transpose(2, 0, 1), 3,
                                resources=psd_resource(1005, bytes(16)),
                                layers=struct.pack(">I", 0)),
        "cmyk_raw.psd": psd_file(rgba.transpose(2, 0, 1), 4, compression=0),
        "rgba.qoi": save(Image.fromarray(rgba, "RGBA"), "QOI"),
        "planes4.pcx": pcx_file(idx & 15, 1, 4, palette=pal[:16]),
        "vga.pcx": pcx_file(idx, 8, 1, vga_palette=pal),
        "pages.dcx": dcx_file([pcx_file(rgb, 8, 3), pcx_file(gray, 8, 1)]),
        "rgb16_rle.sgi": sgi_file(rgb.astype(np.uint16) * 257 + 7, rle=True),
        "rgba_raw.sgi": sgi_file(rgba, rle=False),
    }


def tiff_fixtures() -> dict:
    """The TIFF fixtures: every compression the codec decodes, tiles, planar
    2, Predictor 2, both byte orders, BigTIFF, FillOrder 2, the photometrics
    and depths of Pillow's OPEN_INFO, an Orientation tag and a multi-page
    file (its first page). :func:`tiff_file` writes what Pillow cannot;
    Pillow (its libtiff) writes Group 4, JPEG and the multi-page file."""
    from PIL import Image

    def save(im, **kw):
        buf = io.BytesIO()
        im.save(buf, "TIFF", **kw)
        return buf.getvalue()

    rng = np.random.default_rng(12)
    rgb = scene(40, 56, 13)
    bw = (scene(40, 56, 15)[..., 0] > 128).astype(np.uint8)
    cmap = rng.integers(0, 65536, (16, 3))
    f32 = rgb[..., 0].astype(np.float32) * np.float32(1.37) - np.float32(40.25)
    rgba = np.concatenate([rgb, rng.integers(0, 256, rgb.shape[:2] + (1,), np.uint8)], -1)
    ycc = np.concatenate([rgb[..., :1], rgb[..., 1:] // 2 + 64], -1)
    pages = [Image.fromarray(scene(24, 32, 20 + i)) for i in range(3)]
    multi = io.BytesIO()
    pages[0].save(multi, "TIFF", save_all=True, append_images=pages[1:], compression="tiff_lzw")
    return {
        "lzw_pred.tif": tiff_file(rgb, 2, 8, compression=5, predictor=2, rows_per_strip=7),
        "tiled_deflate_be.tif": tiff_file(rgb, 2, 8, compression=8, tile=(16, 16),
                                          big_endian=True),
        "planar_packbits.tif": tiff_file(rgb, 2, 8, compression=32773, planar=2,
                                         rows_per_strip=16),
        "bigtiff_lzma.tif": tiff_file(rgb, 2, 8, compression=34925, bigtiff=True),
        "g4.tif": save(Image.fromarray(bw * 255).convert("1"), compression="group4"),
        "g3_2d_fill2.tif": tiff_file(bw, 1, 1, compression=3, t4options=5, fill_order=2,
                                     rows_per_strip=16),
        "ccitt_rle.tif": tiff_file(bw, 0, 1, compression=2),
        "jpeg_ycbcr.tif": save(Image.fromarray(rgb), compression="jpeg", quality=85),
        "palette4.tif": tiff_file(rgb[..., 0] >> 4, 3, 4, compression=32773, colormap=cmap),
        "minwhite.tif": tiff_file(rgb[..., 1], 0, 8, compression=5),
        "gray16_be.tif": tiff_file(rgb[..., 2].astype(np.uint16) * 3, 1, 16, big_endian=True,
                                   compression=8, predictor=2),
        "float32.tif": tiff_file(f32, 1, 32, sample_format=3, compression=8),
        "rgba_assoc.tif": tiff_file(rgba, 2, 8, extra=(1,), compression=5),
        "cmyk.tif": tiff_file(rgba, 5, 8, compression=5),
        "ycbcr_lzw.tif": tiff_file(ycc, 6, 8, compression=5, rows_per_strip=8,
                                   ycbcr_subsampling=(2, 2)),
        "ycbcr_deflate.tif": tiff_file(ycc, 6, 8, compression=8, rows_per_strip=8,
                                       ycbcr_subsampling=(2, 2)),
        "ycbcr_lzma.tif": tiff_file(ycc, 6, 8, compression=34925, rows_per_strip=16,
                                    ycbcr_subsampling=(2, 1)),
        "g3_2d.tif": tiff_file(bw, 0, 1, compression=3, t4options=1, rows_per_strip=16),
        "multipage.tif": multi.getvalue(),
        "orient6.tif": tiff_file(rgb, 2, 8, compression=5, orientation=6),
        "zstd_pred.tif": tiff_file(rgb, 2, 8, compression=50000, predictor=2,
                                   rows_per_strip=16),
        "ycbcr_zstd_tiled.tif": tiff_file(ycc, 6, 8, compression=50000, tile=(16, 16),
                                          ycbcr_subsampling=(2, 2)),
    }


def tiff_more_fixtures() -> dict:
    """The TIFF cases past :func:`tiff_fixtures`, small (the fixture tree
    keeps under 1 MB): the floating-point predictor (Pillow's own LZW and
    Deflate files, big-endian LZMA tiles, ZSTD tiles), 12-bit gray
    (uncompressed, LZW tiles), YCbCr at an Orientation other than 1 (strips,
    tiles), 4x4-subsampled YCbCr strips an odd number of units wide (libtiff
    reads them short), ThunderScan (gray, and a palette at FillOrder 2) and
    CCITT RLEW (strips at even and at odd offsets)."""
    from PIL import Image

    def save(im, **kw):
        buf = io.BytesIO()
        im.save(buf, "TIFF", **kw)
        return buf.getvalue()

    rgb = smooth_scene(32)[:20, :24]
    f32 = rgb[..., 0].astype(np.float32) * np.float32(1.37) - np.float32(40.25)
    ycc = np.concatenate([rgb[..., :1], rgb[..., 1:] // 2 + 64], -1)
    g12 = (rgb[..., 1].astype(np.int64) * 3 - 100) % 4096
    g4 = rgb[..., 2] >> 4
    bw = (scene(20, 40, 15)[..., 0] > 128).astype(np.uint8)
    cmap = np.random.default_rng(23).integers(0, 65536, (16, 3))
    return {
        "fpred_lzw.tif": save(Image.fromarray(f32[:12, :16], "F"), compression="tiff_lzw",
                              tiffinfo={317: 3}),
        "fpred_deflate.tif": save(Image.fromarray(f32[:12, :16], "F"),
                                  compression="tiff_adobe_deflate", tiffinfo={317: 3}),
        "fpred_lzma_be_tiled.tif": tiff_file(f32[:16], 0, 32, sample_format=3,
                                             compression=34925, predictor=3, tile=(16, 16),
                                             big_endian=True),
        "fpred_zstd_tiled.tif": tiff_file(f32[:16], 1, 32, sample_format=3, compression=50000,
                                          predictor=3, tile=(16, 16)),
        "gray12.tif": tiff_file(g12, 1, 12),
        "gray12_lzw_tiled.tif": tiff_file(g12, 1, 12, compression=5, tile=(16, 16)),
        "ycbcr_orient3.tif": tiff_file(ycc, 6, 8, compression=5, rows_per_strip=8,
                                       ycbcr_subsampling=(2, 2), orientation=3),
        "ycbcr_orient6_tiled.tif": tiff_file(ycc, 6, 8, compression=8, tile=(16, 16),
                                             ycbcr_subsampling=(2, 1), orientation=6),
        "ycbcr44_short.tif": tiff_file(ycc[:, :20], 6, 8, compression=5, rows_per_strip=8,
                                       ycbcr_subsampling=(4, 4)),
        "ycbcr44_short_deflate.tif": tiff_file(ycc[:, :18], 6, 8, compression=8,
                                               rows_per_strip=12, ycbcr_subsampling=(4, 4)),
        "thunderscan.tif": tiff_file(g4, 1, 4, compression=32809, rows_per_strip=8),
        "thunderscan_palette_fill2.tif": tiff_file(g4, 3, 4, compression=32809, fill_order=2,
                                                   colormap=cmap),
        "rlew.tif": tiff_file(bw, 0, 1, compression=32771, rows_per_strip=8),
        "rlew_odd.tif": tiff_file(bw, 1, 1, compression=32771, rows_per_strip=7, lead=1),
    }


def small_fixtures() -> dict:
    """The small formats (SunImagePlugin, MSP, XBM, XPM, ICNS, DDS): Pillow's
    own files where it writes the format (MSP version 1, XBM, DDS's DXT5
    and uncompressed RGB), the rest from the writers above; DDS blocks of
    each kind (BC1, BC4, BC5S and BC7 from random bytes, where every bit
    pattern is a block)."""
    from PIL import Image

    def save(im, fmt, **kw):
        buf = io.BytesIO()
        im.save(buf, fmt, **kw)
        return buf.getvalue()

    rng = np.random.default_rng(21)
    rgb = scene(40, 56, 25)
    gray = rgb[..., 1]
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    bits = gray > 120
    blocks = rng.integers(0, 256, 14 * 10 * 16, np.uint8).tobytes()  # 56 x 40 at 16 bytes
    sq = scene(128, 128, 26) // 32 * 32  # runs for the RLE
    small = scene(16, 16, 27)
    return {
        "pal8_rle.ras": sun_file(gray >> 2, 8, 2, palette=pal[:64]),
        "bgr24.ras": sun_file(rgb[:, :55], 24),
        "v1.msp": save(Image.fromarray(bits), "MSP"),
        "v2.msp": msp_file(bits),
        "hotspot.xbm": save(Image.fromarray(bits), "XBM", hotspot=(3, 5)),
        "pal.xpm": xpm_file(gray >> 3, pal[:32], transparent=True),
        "rgb300.xpm": xpm_file((gray.astype(np.int64) * 300) >> 8, rng.integers(0, 256, (300, 3))),
        "it32.icns": icns_file([(b"is32", icns_rle24(small)), (b"s8mk", bytes(256)),
                                (b"it32", bytes(4) + icns_rle24(sq)),
                                (b"t8mk", bytes(128 * 128))]),
        "png.icns": icns_file([(b"icp4", save(Image.fromarray(small), "PNG")),
                               (b"ic11", save(Image.fromarray(scene(32, 32, 28)), "PNG"))]),
        "dxt5.dds": save(Image.fromarray(rgb), "DDS", pixel_format="DXT5"),
        "rgb.dds": save(Image.fromarray(rgb), "DDS"),
        "bc1.dds": dds_file(56, 40, bc1_blocks(rgb), 0x4, b"DXT1"),
        "bc4.dds": dds_file(56, 40, blocks[:len(blocks) // 2], 0x4, dxgi=80),
        "bc5s.dds": dds_file(56, 40, blocks, 0x4, b"BC5S"),
        "bc7.dds": dds_file(56, 40, blocks, 0x4, dxgi=98),
        "pal8.dds": dds_file(56, 40, (gray >> 2).tobytes(), 0x20,
                             palette=np.concatenate([pal, pal[:, :1]], 1).tobytes()),
    }


def jpeg2000_fixtures() -> dict:
    """JPEG 2000 files at most 128² (Jpeg2KImagePlugin over OpenJPEG 2.5.4):
    Pillow's own (5/3 and 9/7, JP2 and raw codestream, I;16, signed LA,
    RGBA, CMYK, tiles with image and tile offsets, quality layers under
    RPCL with precincts, cinema 4K with its POC marker and six tile-parts),
    OpenJPEG's through :func:`openjpeg_encode` (every code-block style at
    once, an RGN marker) and JP2 boxes built around a codestream by
    :func:`jp2_file` (sYCC, a palette)."""
    from PIL import Image

    def save(im, **kw):
        buf = io.BytesIO()
        im.save(buf, "JPEG2000", **kw)
        return buf.getvalue()

    rgb = scene(48, 64, 22)
    gray16 = (scene(40, 56, 23)[..., 0].astype(np.uint16) * 257
              + np.random.default_rng(22).integers(0, 256, (40, 56), np.uint16))
    rgba = np.concatenate([rgb, rgb[..., :1] // 2], -1)
    planes = rgb.transpose(2, 0, 1)
    codestream = openjpeg_encode(planes, resolutions=4)
    idx = openjpeg_encode(planes[:1] >> 3, prec=5, resolutions=4)
    pal = np.random.default_rng(23).integers(0, 256, (32, 3))
    return {
        "rev53.jp2": save(Image.fromarray(rgb)),
        "irr97_layers.j2k": save(Image.fromarray(rgb), irreversible=True, no_jp2=True,
                                 quality_layers=[40, 10, 2], mct=1),
        "gray16.jp2": save(Image.fromarray(gray16)),
        "signed_la.jp2": save(Image.fromarray(rgb[..., :2].copy(), "LA"), signed=True),
        "rgba.j2k": save(Image.fromarray(rgba, "RGBA"), no_jp2=True, irreversible=True),
        "cmyk.jp2": save(Image.fromarray(rgba, "CMYK")),
        "tiles_offsets.jp2": save(Image.fromarray(rgb), tile_size=(24, 20), offset=(5, 3),
                                  tile_offset=(2, 1), num_resolutions=3),
        "rpcl_precincts.jp2": save(Image.fromarray(rgb), progression="RPCL",
                                   precinct_size=(32, 32), num_resolutions=3,
                                   quality_layers=[30, 5], codeblock_size=(16, 16)),
        "cinema4k.j2k": save(Image.fromarray(scene(128, 128, 24)), no_jp2=True,
                             cinema_mode="cinema4k-24"),
        "styles_roi.j2k": openjpeg_encode(planes, mode=63, irreversible=True, rates=(20, 4),
                                          cblk=(16, 16), resolutions=4, roi=(0, 3)),
        "sycc.jp2": jp2_file(codestream, 64, 48, 3, colr=18),
        "palette.jp2": jp2_file(idx, 64, 48, 1, bits=5, colr=16, palette=pal),
    }


def jpeg2000_decode_pair() -> dict:
    """The 1024² JPEG 2000 pair ``chip_smoke.py`` times (the card host has no
    Pillow): the smooth scene as a 5/3 JP2 (184 KB, 1.40 bits a pixel),
    which decodes to its source, and the baseline JPEG's textured scene as
    a 9/7 codestream that fills its rate of 40 (79 KB, 0.60 bits a pixel),
    held by its manifest hash. Tier 1's time follows the coded bytes: the
    smooth scene codes to 0.16 bits a pixel at rate 20. (Rate 40 keeps the
    fixture tree under its 1 MB budget.)"""
    from PIL import Image

    out = {}
    for name, img, kw in (("rev53_1024.jp2", smooth_scene(1024), {}),
                          ("irr97_1024.j2k", scene(1024, 1024, 1),
                           {"irreversible": True, "no_jp2": True, "quality_layers": [40]})):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG2000", **kw)
        out[name] = buf.getvalue()
    return out


def tiff_strips(data: bytes):
    """[(offset, byte count)] of a little-endian classic TIFF's strips or
    tiles (StripOffsets or TileOffsets, LONG)."""
    ent = tiff_entries(data)
    offs, counts = (273, 279) if 273 in ent else (324, 325)

    def values(tag):
        n, at = struct.unpack_from("<L", data, ent[tag] + 4)[0], ent[tag] + 8
        if n > 1:
            (at,) = struct.unpack_from("<L", data, at)
        return struct.unpack_from(f"<{n}L", data, at)

    return list(zip(values(offs), values(counts)))


def tiff_entries(data: bytes) -> dict:
    """{tag: entry position} of a little-endian classic TIFF's first directory."""
    (pos,) = struct.unpack_from("<L", data, 4)
    (n,) = struct.unpack_from("<H", data, pos)
    return {struct.unpack_from("<H", data, pos + 2 + 12 * k)[0]: pos + 2 + 12 * k
            for k in range(n)}


def tiff_set_entry(data: bytes, tag: int, new_tag=None, typ=None, count=None,
                   value=None) -> bytes:
    """The file with one directory entry's tag, type, count or value field
    (LONG) replaced."""
    at = tiff_entries(data)[tag]
    out = bytearray(data)
    t, ty, c = struct.unpack_from("<HHL", data, at)
    struct.pack_into("<HHL", out, at, t if new_tag is None else new_tag,
                     ty if typ is None else typ, c if count is None else count)
    if value is not None:
        struct.pack_into("<L", out, at + 8, value)
    return bytes(out)


def tiff_damaged(data: bytes, chunk: int, at: float, patch: bytes) -> bytes:
    """The file with ``patch`` written into strip or tile ``chunk`` at the
    fraction ``at`` of its data."""
    off, count = tiff_strips(data)[chunk]
    out = bytearray(data)
    i = off + int(count * at)
    out[i:i + len(patch)] = patch
    return bytes(out)


def tiff_cut(data: bytes, chunk: int) -> bytes:
    """The file with strip ``chunk``'s byte count halved (StripByteCounts
    held out of line)."""
    ent = tiff_entries(data)
    (at,) = struct.unpack_from("<L", data, ent[279] + 8)
    out = bytearray(data)
    (count,) = struct.unpack_from("<L", data, at + 4 * chunk)
    struct.pack_into("<L", out, at + 4 * chunk, max(1, count // 2))
    return bytes(out)


def jpeg_frames(sizes, subsampling: int = 2) -> callable:
    """A ``jpeg`` writer for :func:`tiff_file` whose n-th strip or tile is
    coded from its top-left ``sizes[n]`` (rows, columns), None for whole, by
    Pillow at quality 90 (``subsampling`` 2 is 4:2:0, and samples a gray
    frame's one component 2x2)."""
    from PIL import Image

    sizes = list(sizes)

    def jpeg(block):
        size = sizes.pop(0) if sizes else None
        if size is not None:
            block = block[:size[0], :size[1]]
        if block.shape[2] == 1:
            block = block[..., 0]
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(block)).save(buf, "JPEG", quality=90,
                                                          subsampling=subsampling)
        return buf.getvalue()

    return jpeg


# --- AVIF: Pillow's files, their boxes edited, and files Pillow does not write ---

def avif_save(rgb: np.ndarray, mode: str = "RGB", **kw) -> bytes:
    """Pillow's AVIF file (libavif 1.3 over aom), lossless unless ``quality``
    says otherwise."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb, mode).save(buf, "AVIF", **{"quality": 100, **kw})
    return buf.getvalue()


def bmff_boxes(data: bytes, start: int = 0, end: int = None) -> list:
    """[(type, box start, body start, box end)] of the boxes in data[start:end]."""
    end = len(data) if end is None else end
    out = []
    while start + 8 <= end:
        size, typ = struct.unpack_from(">I4s", data, start)
        head = 8
        if size == 1:
            size, head = struct.unpack_from(">Q", data, start + 8)[0], 16
        size = size or end - start
        out.append((typ, start, start + head, start + size))
        start += size
    return out


def avif_parts(data: bytes) -> dict:
    """A Pillow AVIF file's primary item: its OBUs and its property boxes
    (bytes, in ipco order) as :func:`avif_file` takes them."""
    meta = next(b for b in bmff_boxes(data) if b[0] == b"meta")
    inner = {b[0]: b for b in bmff_boxes(data, meta[2] + 4, meta[3])}
    ipco = next(b for b in bmff_boxes(data, inner[b"iprp"][2], inner[b"iprp"][3])
                if b[0] == b"ipco")
    props = [data[b[1]:b[3]] for b in bmff_boxes(data, ipco[2], ipco[3])]
    iloc = data[inner[b"iloc"][2]:inner[b"iloc"][3]]
    version = iloc[0]
    sizes = iloc[4], iloc[5]
    count_at = 6
    count = struct.unpack_from(">H", iloc, count_at)[0]
    pos, items = count_at + 2, {}
    for _ in range(count):
        item_id = struct.unpack_from(">H", iloc, pos)[0]
        pos += 2 + (2 if version else 0) + 2 + (sizes[1] >> 4)
        extents = struct.unpack_from(">H", iloc, pos)[0]
        pos += 2
        chunks = []
        for _ in range(extents):
            off = int.from_bytes(iloc[pos:pos + (sizes[0] >> 4)], "big")
            pos += sizes[0] >> 4
            length = int.from_bytes(iloc[pos:pos + (sizes[0] & 15)], "big")
            pos += sizes[0] & 15
            chunks.append(data[off:off + length])
        items[item_id] = b"".join(chunks)
    pitm = data[inner[b"pitm"][2]:inner[b"pitm"][3]]
    types = {}
    for b in bmff_boxes(data, inner[b"iinf"][2] + 6, inner[b"iinf"][3]):
        item_id, typ = struct.unpack_from(">H", data, b[2] + 4)[0], data[b[2] + 8:b[2] + 12]
        types[item_id] = typ
    ipma = next(b for b in bmff_boxes(data, inner[b"iprp"][2], inner[b"iprp"][3])
                if b[0] == b"ipma")
    assoc, pos = {}, ipma[2] + 8
    for _ in range(struct.unpack_from(">I", data, ipma[2] + 4)[0]):
        item_id, n = struct.unpack_from(">HB", data, pos)
        assoc[item_id] = [(v & 0x7F, bool(v >> 7)) for v in data[pos + 3:pos + 3 + n]]
        pos += 3 + n
    refs = []
    if b"iref" in inner:
        for b in bmff_boxes(data, inner[b"iref"][2] + 4, inner[b"iref"][3]):
            src, n = struct.unpack_from(">HH", data, b[2])
            refs.append((b[0], src, list(struct.unpack_from(f">{n}H", data, b[2] + 4))))
    primary = struct.unpack_from(">H", pitm, 4)[0]
    return {"obus": items[primary], "props": props, "items": items, "types": types,
            "assoc": assoc, "refs": refs, "primary": primary}


def avif_remux(parts: dict, **kw) -> bytes:
    """:func:`avif_file` of :func:`avif_parts`, fields replaced by ``kw``
    (``items``, ``props``, ``assoc``, ``refs``, ``primary``, ...)."""
    p = {**parts, **kw}
    items = p.get("item_list") or [(i, p["types"][i], p["items"][i]) for i in sorted(p["items"])]
    extra = {k: v for k, v in kw.items() if k in ("major", "brands", "idat", "extents")}
    return avif_file(items, p["props"], p["assoc"], primary=p["primary"], refs=p["refs"], **extra)


def _bmff_box(typ: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + typ + body


def _bmff_full(typ: bytes, body: bytes, version: int = 0, flags: int = 0) -> bytes:
    return _bmff_box(typ, bytes([version]) + flags.to_bytes(3, "big") + body)


def avif_property(typ: bytes, body: bytes, version=None) -> bytes:
    """A property box: full (with version 0) where ``version`` is given."""
    return _bmff_box(typ, body) if version is None else _bmff_full(typ, body, version)


def avif_file(items, props, assoc, primary: int = 1, refs=(), major: bytes = b"avif",
              brands=(b"avif", b"mif1", b"miaf"), idat: bool = False, extents: int = 1) -> bytes:
    """A HEIF file as libavif lays one out: ``items`` [(id, type, payload)]
    (a ``mime`` item's type as (b"mime", content type)), ``props`` the ipco
    boxes, ``assoc`` {item id: [(1-based property index, essential)]},
    ``refs`` [(type, from, [to, ...])]; payloads in ``mdat`` (or ``idat``,
    construction method 1), each in ``extents`` pieces."""
    ftyp = _bmff_box(b"ftyp", major + b"\0\0\0\0" + b"".join(brands))
    hdlr = _bmff_full(b"hdlr", b"\0" * 4 + b"pict" + b"\0" * 12 + b"\0")
    pitm = _bmff_full(b"pitm", struct.pack(">H", primary))
    infe = []
    for item_id, typ, _ in items:
        kind, extra = (typ, b"") if isinstance(typ, bytes) else (typ[0], typ[1] + b"\0")
        infe.append(_bmff_full(b"infe", struct.pack(">HH", item_id, 0) + kind + b"\0" + extra,
                               version=2))
    iinf = _bmff_full(b"iinf", struct.pack(">H", len(items)) + b"".join(infe))
    iref = b""
    if refs:
        iref = _bmff_full(b"iref", b"".join(
            _bmff_box(t, struct.pack(">HH", src, len(dst)) + b"".join(struct.pack(">H", d) for d in dst))
            for t, src, dst in refs))
    ipma_body = struct.pack(">I", len(assoc))
    for item_id, entries in assoc.items():
        ipma_body += struct.pack(">HB", item_id, len(entries))
        ipma_body += bytes((0x80 if ess else 0) | idx for idx, ess in entries)
    iprp = _bmff_box(b"iprp", _bmff_box(b"ipco", b"".join(props)) + _bmff_full(b"ipma", ipma_body))

    def meta(offsets):
        body = struct.pack(">BBH", 0x44, 0x00, len(items))
        for (item_id, _, payload), off in zip(items, offsets):
            cuts = [len(payload) * k // extents for k in range(extents + 1)]
            body += struct.pack(">HHHH", item_id, 1 if idat else 0, 0, extents)
            body += b"".join(struct.pack(">II", off + a, b - a) for a, b in zip(cuts, cuts[1:]))
        iloc = _bmff_full(b"iloc", body, version=1)
        idat_box = _bmff_box(b"idat", b"".join(p for _, _, p in items)) if idat else b""
        return _bmff_full(b"meta", hdlr + pitm + iloc + iinf + iref + iprp + idat_box)

    size = len(meta([0] * len(items)))
    offsets, at = [], 0 if idat else len(ftyp) + size + 8
    for _, _, payload in items:
        offsets.append(at)
        at += len(payload)
    mdat = b"" if idat else _bmff_box(b"mdat", b"".join(p for _, _, p in items))
    return ftyp + meta(offsets) + mdat


class _BitWriter:
    def __init__(self):
        self.bits = []

    def f(self, n: int, v: int) -> None:
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def bytes(self, trailing: bool = True) -> bytes:
        bits = self.bits + ([1] if trailing else [])
        bits += [0] * (-len(bits) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))


class _BitReader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | ((self.data[self.pos >> 3] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v


def av1_obus(data: bytes) -> list:
    """[(type, body)] of a stream of OBUs with size fields."""
    out, pos = [], 0
    while pos < len(data):
        head = data[pos]
        pos += 1 + ((head >> 2) & 1)
        size = shift = 0
        while True:
            b = data[pos]
            pos += 1
            size |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        out.append(((head >> 3) & 15, data[pos:pos + size]))
        pos += size
    return out


def av1_join(obus) -> bytes:
    out = b""
    for typ, body in obus:
        n, size = len(body), b""
        while True:
            size += bytes([(n & 0x7F) | (0x80 if n > 0x7F else 0)])
            n >>= 7
            if not n:
                break
        out += bytes([(typ << 3) | 2]) + size + body
    return out


def av1_reduced_sequence(body: bytes) -> dict:
    """The fields of a reduced still-picture sequence header (aom's, as
    Pillow writes it)."""
    r = _BitReader(body)
    s = {"profile": r.f(3), "still": r.f(1), "reduced": r.f(1), "level": r.f(5)}
    assert s["reduced"], "not a reduced still-picture header"
    s["wbits"], s["hbits"] = r.f(4) + 1, r.f(4) + 1
    s["w"], s["h"] = r.f(s["wbits"]) + 1, r.f(s["hbits"]) + 1
    for k in ("sb128", "filter_intra", "edge_filter", "superres", "cdef", "restoration"):
        s[k] = r.f(1)
    s["high"] = r.f(1)
    s["twelve"] = r.f(1) if s["profile"] == 2 and s["high"] else 0
    s["mono"] = 0 if s["profile"] == 1 else r.f(1)
    s["desc"] = r.f(1)
    if s["desc"]:
        s["cp"], s["tc"], s["mc"] = r.f(8), r.f(8), r.f(8)
    s["range"] = r.f(1)
    s["ssx"], s["ssy"] = {0: (1, 1), 1: (0, 0)}.get(s["profile"], (1, 0))
    if s["mono"]:
        s["ssx"] = s["ssy"] = 1
    elif s["profile"] == 2 and s["twelve"]:
        s["ssx"] = r.f(1)
        s["ssy"] = r.f(1) if s["ssx"] else 0
    if not s["mono"] and s["ssx"] and s["ssy"]:
        s["csp"] = r.f(2)
    if not s["mono"]:
        s["sep_uv"] = r.f(1)
    s["grain"] = r.f(1)
    return s


def av1_write_sequence(s: dict) -> bytes:
    """:func:`av1_reduced_sequence`'s fields back to a header."""
    w = _BitWriter()
    w.f(3, s["profile"]), w.f(1, 1), w.f(1, 1), w.f(5, s["level"])
    w.f(4, s["wbits"] - 1), w.f(4, s["hbits"] - 1)
    w.f(s["wbits"], s["w"] - 1), w.f(s["hbits"], s["h"] - 1)
    for k in ("sb128", "filter_intra", "edge_filter", "superres", "cdef", "restoration"):
        w.f(1, s[k])
    w.f(1, s["high"])
    if s["profile"] == 2 and s["high"]:
        w.f(1, s["twelve"])
    if s["profile"] != 1:
        w.f(1, s["mono"])
    w.f(1, s["desc"])
    if s["desc"]:
        w.f(8, s["cp"]), w.f(8, s["tc"]), w.f(8, s["mc"])
    w.f(1, s["range"])
    if not s["mono"] and s["profile"] == 2 and s["twelve"]:
        w.f(1, s["ssx"])
        if s["ssx"]:
            w.f(1, s["ssy"])
    if not s["mono"] and s["ssx"] and s["ssy"]:
        w.f(2, s.get("csp", 0))
    if not s["mono"]:
        w.f(1, s.get("sep_uv", 0))
    w.f(1, s["grain"])
    return w.bytes()


def av1_frame_header_bits(body: bytes, s: dict) -> tuple:
    """(bits of the frame header, the tile group's bytes) of a lossless
    reduced still frame as aom writes it (no screen content, no segmentation,
    no quantizer matrices)."""
    r = _BitReader(body)
    r.f(1)  # disable_cdf_update
    assert r.f(1) == 0, "screen content"
    if s["superres"]:
        assert r.f(1) == 0
    if r.f(1):  # render_and_frame_size_different
        r.f(32)
    mi_cols, mi_rows = 2 * ((s["w"] + 7) >> 3), 2 * ((s["h"] + 7) >> 3)
    sb = 5 if s["sb128"] else 4
    sb_cols, sb_rows = -(-mi_cols // (1 << sb)), -(-mi_rows // (1 << sb))

    def log2_of(blk, target):
        k = 0
        while (blk << k) < target:
            k += 1
        return k

    min_cols = log2_of(4096 >> (sb + 2), sb_cols)
    max_cols, max_rows = log2_of(1, min(sb_cols, 64)), log2_of(1, min(sb_rows, 64))
    min_tiles = max(min_cols, log2_of((4096 * 2304) >> (2 * (sb + 2)), sb_rows * sb_cols))
    assert r.f(1), "explicit tile spacing"
    cols = min_cols
    while cols < max_cols and r.f(1):
        cols += 1
    rows = max(min_tiles - cols, 0)
    while rows < max_rows and r.f(1):
        rows += 1
    if cols or rows:
        r.f(cols + rows), r.f(2)
    assert r.f(8) == 0, "lossy"
    for _ in range(1 if s["mono"] else 3):
        assert r.f(1) == 0
    assert r.f(1) == 0 and r.f(1) == 0  # using_qmatrix, segmentation_enabled
    r.f(1)  # reduced_tx_set
    if s["grain"]:
        assert r.f(1) == 0
    header = [(body[i >> 3] >> (7 - (i & 7))) & 1 for i in range(r.pos)]
    return header, body[(r.pos + 7) // 8:]


def av1_rewrite(obus: bytes, seq=None, insert=None, append=()) -> bytes:
    """A Pillow AV1 item with its sequence header's fields replaced by
    ``seq`` and its frame header's bits changed: ``insert`` (bit position
    after the screen-content flag, bits) and ``append`` (bits after
    reduced_tx_set), then byte-aligned before the tile data."""
    parts = av1_obus(obus)
    s = av1_reduced_sequence(next(b for t, b in parts if t == 1))
    out = []
    for typ, body in parts:
        if typ == 1:
            body = av1_write_sequence({**s, **(seq or {})})
        elif typ == 6:
            bits, tiles = av1_frame_header_bits(body, s)
            if insert:
                at, extra = insert
                bits = bits[:at] + list(extra) + bits[at:]
            bits = bits + list(append)
            w = _BitWriter()
            w.bits = bits
            body = w.bytes(trailing=False) + tiles
        out.append((typ, body))
    return av1_join(out)


def av1_config(seq: dict) -> bytes:
    """The av1C box of a sequence header's fields."""
    b1 = (seq["profile"] << 5) | seq["level"]
    b2 = ((seq["high"] << 6) | (seq.get("twelve", 0) << 5) | (seq["mono"] << 4)
          | (seq["ssx"] << 3) | (seq["ssy"] << 2) | seq.get("csp", 0))
    return _bmff_box(b"av1C", bytes([0x81, b1, b2, 0]))


def avif_fixtures() -> dict:
    """Lossless AVIF files Pillow writes (libavif 1.3 over aom at quality
    100): 4:2:0, 4:2:2, 4:4:4 and 4:0:0 at an odd and an even size, the
    1024² scene (2x2 tiles), an RGBA file, an EXIF-rotated file (irot), a
    mirrored one (imir added), and ``colr`` variants made by editing the
    nclx box (identity over 4:4:4, BT.709, BT.2020, limited range, none)."""
    out = {}
    for name, (h, w) in (("odd", (29, 45)), ("even", (48, 64))):
        img = scene(h, w, 31)
        for ss in ("4:2:0", "4:2:2", "4:4:4", "4:0:0"):
            out[f"avif_{ss.replace(':', '')}_{name}.avif"] = avif_save(img, subsampling=ss)
    out["avif_1024.avif"] = avif_save(scene(1024, 1024, 1))
    rgba = np.concatenate([scene(40, 52, 32), scene(40, 52, 33)[..., :1]], -1)
    out["avif_rgba.avif"] = avif_save(rgba, "RGBA")
    from PIL import Image

    exif = Image.Exif()
    exif[0x0112] = 6
    rotated = avif_save(scene(36, 28, 34), exif=exif.tobytes())
    out["avif_irot.avif"] = rotated
    parts = avif_parts(rotated)
    props = parts["props"] + [avif_property(b"imir", b"\x01")]
    assoc = {1: [(i + 1, p[4:8] in (b"av1C", b"irot", b"imir")) for i, p in enumerate(props)]}
    out["avif_imir.avif"] = avif_file([(1, b"av01", parts["obus"])], props, assoc)
    base = avif_save(scene(30, 34, 35), subsampling="4:4:4")
    nclx = base.index(b"colrnclx") + 8
    for name, (mc, full) in (("identity", (0, 1)), ("bt709", (1, 1)), ("bt2020", (9, 1)),
                             ("limited", (6, 0))):
        out[f"avif_colr_{name}.avif"] = (base[:nclx + 4] + struct.pack(">H", mc)
                                         + bytes([full << 7]) + base[nclx + 7:])
    out["avif_no_colr.avif"] = base.replace(b"colrnclx", b"freenclx")
    return out


def damaged_tiff_fixtures() -> dict:
    """Damaged TIFFs that libtiff decodes for Pillow, each of a kind the
    port once refused or read apart from it: an LZMA strip damaged near its
    end (liblzma's error comes in the call that fills the strip); Deflate and
    LZMA YCbCr strips damaged in their data (libtiff's RGBA reader converts
    what came before the error); JPEG frames smaller than their strips or
    tiles after the first (the rest keeps the chunk before's bytes); CCITT
    RLE, Group 3 and Group 4 strips with bad codes (the row ends, decoding
    goes on) and a Group 4 strip cut short (its rows kept); directories
    libtiff reads apart from Pillow (an entry whose data lies past the file,
    a YCbCrSubsampling of one value, which libtiff ignores). Every byte
    Pillow shows was written: the first strip or tile is whole."""
    rgb = scene(40, 56, 13)
    ycc = np.concatenate([rgb[..., :1], rgb[..., 1:] // 2 + 64], -1)
    bw = (scene(40, 56, 15)[..., 0] > 128).astype(np.uint8)

    def ycbcr(comp):
        return tiff_file(ycc, 6, 8, compression=comp, rows_per_strip=16,
                         ycbcr_subsampling=(2, 2))

    def fax(comp, t4=None, fill=1):
        return tiff_file(bw, 0, 1, compression=comp, t4options=t4, rows_per_strip=16,
                         fill_order=fill)

    lzma_rgb = tiff_file(rgb, 2, 8, compression=34925)
    past = tiff_file(rgb, 2, 8, compression=5, predictor=2, tags={305: (2, b"x" * 100)})
    return {
        "lzma_damaged.tif": tiff_damaged(lzma_rgb, 0, 1 - 40 / tiff_strips(lzma_rgb)[0][1],
                                         b"\x55"),
        "ycbcr_deflate_damaged.tif": tiff_damaged(ycbcr(8), 1, 1 / 3, b"\xff\xff"),
        "ycbcr_lzma_damaged.tif": tiff_damaged(ycbcr(34925), 1, 1 / 3, b"\xff\xff"),
        "jpeg_short_strip.tif": tiff_file(rgb, 6, 8, compression=7, rows_per_strip=16,
                                          ycbcr_subsampling=(2, 2),
                                          jpeg=jpeg_frames([None, (10, 24), (7, 56)])),
        "jpeg_short_tile.tif": tiff_file(rgb, 6, 8, compression=7, tile=(16, 16),
                                         ycbcr_subsampling=(2, 2),
                                         jpeg=jpeg_frames([None] + [(9, 13)] * 11)),
        "rle_bad_code.tif": tiff_damaged(fax(2), 1, 0.5, b"\x00\x80"),
        "g3_bad_code.tif": tiff_damaged(fax(3, 1, 2), 1, 0.5, b"\x01"),
        "g4_bad_code.tif": tiff_damaged(fax(4), 1, 0.5, b"\x00\x80"),
        "g4_cut.tif": tiff_cut(fax(4), 2),
        "dir_past_file.tif": tiff_set_entry(past, 305, value=len(past) + 10),
        "dir_ycbcr_subsampling.tif": tiff_set_entry(
            tiff_file(ycc, 6, 8, compression=8, ycbcr_subsampling=(1, 1)), 530, count=1),
    }


def jpeg_variant_fixtures(progressive: bytes, smooth: np.ndarray) -> dict:
    """Arithmetic-coded sequential and progressive JPEG (small, and 1024²
    from the smooth image: each scan within Pillow's 64 KiB read block), a
    lossless JPEG (predictor 6, a point transform of 1, restarts) and a
    progressive file cut after its third scan (block-smoothed)."""
    small = scene(44, 60, 16)
    return {
        "arith.jpg": arith_jpeg(small, 90, restart=5),
        "arith_prog.jpg": arith_jpeg(small, 90, progressive=True),
        "arith_1024.jpg": arith_jpeg(smooth, 90),
        "arith_prog_1024.jpg": arith_jpeg(smooth, 90, progressive=True),
        "lossless.jpg": lossless_jpeg(small, predictor=6, point_transform=1, restart_rows=8),
        "smoothed.jpg": cut_progressive(progressive, 3),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    manifest = {}
    for name, data in fixtures().items():
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
        px = pil_rgb(data)
        manifest[name] = {"shape": list(px.shape), "bytes": len(data),
                          "sha256": hashlib.sha256(px.tobytes()).hexdigest()}
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    print(json.dumps(manifest, indent=1))


if __name__ == "__main__":
    main()
