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
  half itself, without Pillow), and the WebP upload of its /edit.

Pillow writes neither interlaced nor 16-bit RGB PNG, so :func:`png_file`
writes both here with ``zlib``; BMP and GIF variants Pillow does not write
come from :func:`bmp_file` and :func:`gif_file`, lossy WebP at encoder
settings Pillow does not expose from :func:`libwebp_encode`. ``manifest.json`` holds each file's shape and
the SHA-256 of Pillow's ``ImageOps.exif_transpose(...).convert("RGB")``
bytes. Run it where Pillow is installed; the images come from a numpy seed.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
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


def scene(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A smooth colour scene with a little noise (small files)."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0, 1, h)[:, None]
    x = np.linspace(0, 1, w)[None]
    a = np.stack([128 + 90 * np.sin(6 * x + 2 * y), 128 + 90 * np.cos(4 * y + 3 * x),
                  128 + 70 * np.sin(9 * x * y)], -1)
    return np.clip(a + rng.normal(0, 2, a.shape), 0, 255).astype(np.uint8)


def pil_rgb(data: bytes) -> np.ndarray:
    from PIL import Image, ImageOps

    return np.asarray(ImageOps.exif_transpose(Image.open(io.BytesIO(data))).convert("RGB"))


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
    y = np.linspace(0, 1, 1024)[:, None]
    x = np.linspace(0, 1, 1024)[None]
    smooth = np.stack([128 + 90 * np.sin(3 * x + y), 128 + 90 * np.cos(2 * y + 1.5 * x),
                       128 + 70 * np.sin(4.5 * x * y)], -1).astype(np.uint8)
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
