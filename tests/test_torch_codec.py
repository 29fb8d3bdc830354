"""The port's wire codec (``core/codec.py`` + ``csrc/host/image_codec.cc``) and
``imaging.blend`` against Pillow, the JAX package's codec.

Decoding must equal Pillow's pixels bit for bit (Pillow runs libjpeg-turbo:
islow IDCT, fancy upsampling, fixed-point YCbCr→RGB) on Pillow-made JPEGs at
q 50/90/100 in 4:4:4, 4:2:2, 4:2:0 and gray, at sizes 64², 333×517 and 17×9
(partial blocks and MCUs on both edges), with restart intervals, every EXIF
orientation (``ImageOps.exif_transpose``), whole-number sampling ratios
above 2 (files written here: Pillow writes none), every PNG colour type and
row filter and the 1-, 2- and 4-bit gray and palette PNGs. Pillow's decode
of the port's JPEG must equal Pillow's decode of Pillow's own file (the
files are byte-equal too). Unsupported variants raise a ``ValueError`` that
names them.
"""

import base64
import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image, ImageOps

from qwen_image_edit_streamdiffusion_tpu_torch.core import codec, imaging

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
from codec_fixtures import tiff_file  # noqa: E402

SIZES = [(64, 64), (333, 517), (17, 9)]


def _image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Smooth colour ramps plus noise: every coefficient band is exercised
    and chroma carries detail."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0, 1, h)[:, None]
    x = np.linspace(0, 1, w)[None]
    a = np.stack([128 + 100 * np.sin(7 * x + 3 * y), 128 + 100 * np.cos(5 * y + 2 * x),
                  128 + 80 * np.sin(11 * x * y)], -1)
    return np.clip(a + rng.normal(0, 24, a.shape), 0, 255).astype(np.uint8)


def _pil_jpeg(arr, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil_decode(data: bytes) -> np.ndarray:
    return np.asarray(ImageOps.exif_transpose(Image.open(io.BytesIO(data))).convert("RGB"))


@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_jpeg_decode_matches_pillow(hw, subsampling):
    arr = _image(*hw)
    noise = np.random.default_rng(1).integers(0, 256, arr.shape, np.uint8)
    for q in (50, 90, 100):
        for a in (arr, noise):
            data = _pil_jpeg(a, quality=q, subsampling=subsampling)
            got = codec.decode(data)
            assert got.dtype == np.uint8 and got.shape == a.shape
            np.testing.assert_array_equal(got, _pil_decode(data), err_msg=f"q{q}")


@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_gray_jpeg_decode_matches_pillow(hw):
    arr = _image(*hw)[..., 1]
    for q in (50, 90, 100):
        data = _pil_jpeg(arr, quality=q)
        np.testing.assert_array_equal(codec.decode(data), _pil_decode(data))


@pytest.mark.parametrize("hv", [(1, 1), (2, 1), (1, 2), (2, 2)], ids=str)
def test_every_luma_sampling_factor(hv):
    """Files written by the port's encoder with the luma sampled h × v (1×2,
    4:4:0, is one Pillow cannot write) decode as Pillow decodes them."""
    for h, w in SIZES:
        data = codec._encode(_image(h, w, 2), 90, *hv)
        np.testing.assert_array_equal(codec.decode(data), _pil_decode(data))


# zigzag position k → raster index of the 8×8 block
_ZIGZAG = sorted(range(64), key=lambda i: (i // 8 + i % 8,
                                           i % 8 if (i // 8 + i % 8) % 2 == 0 else i // 8))


def _segments(data: bytes, marker: int) -> list:
    """The whole marker segments (FFxx, length, body) of one kind."""
    out, pos = [], 2
    while data[pos + 1] != 0xDA:
        (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if data[pos + 1] == marker:
            out.append(data[pos:pos + 2 + n])
        pos += 2 + n
    return out


def _huffman_codes(dht: bytes) -> dict:
    """{(class, id): {symbol: (code, length)}} of a DHT segment."""
    tables, pos = {}, 4
    while pos < len(dht):
        tc_th, bits = dht[pos], dht[pos + 1:pos + 17]
        vals = dht[pos + 17:pos + 17 + sum(bits)]
        codes, code, k = {}, 0, 0
        for length in range(1, 17):
            for _ in range(bits[length - 1]):
                codes[vals[k]] = (code, length)
                code, k = code + 1, k + 1
            code <<= 1
        tables[(tc_th >> 4, tc_th & 15)] = codes
        pos += 17 + sum(bits)
    return tables


def _jpeg_sampled(arr: np.ndarray, factors) -> bytes:
    """A baseline JPEG of ``arr`` (H, W, 3) whose three components are
    sampled ``factors`` ((h, v) each), written here with the quantization
    and standard Huffman tables of Pillow's q90 file: Pillow cannot write
    luma factors above 2. Chroma is box-averaged; the DCT is a float one
    (only the decoders are compared)."""
    h, w = arr.shape[:2]
    base = _pil_jpeg(arr, quality=90, subsampling=0)
    dqt, dht = _segments(base, 0xDB), _segments(base, 0xC4)
    qt = {}
    for seg in dqt:
        pos = 4
        while pos < len(seg):
            qt[seg[pos] & 15] = np.frombuffer(seg[pos + 1:pos + 65], np.uint8).astype(float)
            pos += 65
    huff = {}
    for seg in dht:
        huff.update(_huffman_codes(seg))
    x = arr.astype(float)
    ycc = np.stack([0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2],
                    128 - 0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2],
                    128 + 0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2]], -1)
    mh, mv = max(f[0] for f in factors), max(f[1] for f in factors)
    mx, my = -(-w // (8 * mh)), -(-h // (8 * mv))
    n = np.arange(8)
    dct = (np.cos((2 * n[None] + 1) * n[:, None] * np.pi / 16)
           * np.where(n == 0, 0.5 ** 0.5, 1)[:, None] / 2)  # orthonormal DCT-II
    planes = []
    for c, (fh, fv) in enumerate(factors):
        rh, rv = mh // fh, mv // fv
        p = np.pad(ycc[..., c], ((0, my * mv * 8 - h), (0, mx * mh * 8 - w)), mode="edge")
        p = p.reshape(p.shape[0] // rv, rv, p.shape[1] // rh, rh).mean((1, 3))
        planes.append(p)
    bits = []

    def put(code: int, length: int):
        for i in range(length - 1, -1, -1):
            bits.append((code >> i) & 1)

    def put_value(v: int):
        size = int(abs(v)).bit_length()
        return size, (v if v >= 0 else v + (1 << size) - 1)

    pred = [0, 0, 0]
    for by in range(my):
        for bx in range(mx):
            for c, (fh, fv) in enumerate(factors):
                tq, tab = (0, 0) if c == 0 else (1, 1)
                for v in range(fv):
                    for u in range(fh):
                        r0, c0 = (by * fv + v) * 8, (bx * fh + u) * 8
                        blk = planes[c][r0:r0 + 8, c0:c0 + 8] - 128
                        coef = (dct @ blk @ dct.T).reshape(-1)[_ZIGZAG]
                        q = np.round(coef / qt[tq]).astype(int)
                        size, val = put_value(q[0] - pred[c])
                        pred[c] = q[0]
                        put(*huff[(0, tab)][size])
                        put(val, size)
                        run = 0
                        for k in range(1, 64):
                            if q[k] == 0:
                                run += 1
                                continue
                            while run > 15:
                                put(*huff[(1, tab)][0xF0])
                                run -= 16
                            size, val = put_value(q[k])
                            put(*huff[(1, tab)][(run << 4) | size])
                            put(val, size)
                            run = 0
                        if run:
                            put(*huff[(1, tab)][0x00])
    bits += [1] * (-len(bits) % 8)
    scan = bytearray()
    for i in range(0, len(bits), 8):
        byte = int("".join(map(str, bits[i:i + 8])), 2)
        scan.append(byte)
        if byte == 0xFF:
            scan.append(0)
    sof = struct.pack(">BHHB", 8, h, w, 3) + b"".join(
        struct.pack(">BBB", c + 1, (fh << 4) | fv, 0 if c == 0 else 1)
        for c, (fh, fv) in enumerate(factors))
    sos = struct.pack(">B", 3) + b"".join(
        struct.pack(">BB", c + 1, 0x00 if c == 0 else 0x11) for c in range(3)) + b"\x00\x3f\x00"
    return (b"\xff\xd8" + b"".join(dqt) + b"\xff\xc0" + struct.pack(">H", 2 + len(sof)) + sof
            + b"".join(dht) + b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos + bytes(scan)
            + b"\xff\xd9")


@pytest.mark.parametrize("luma", [(4, 1), (3, 1), (1, 3), (4, 2), (1, 1)], ids=str)
def test_whole_number_sampling_ratios_above_2_match_pillow(luma):
    """A luma sampled 4×1, 3×1, 1×3 or 4×2 against 1×1 chroma: libjpeg-turbo
    upsamples the chroma by box replication (``int_upsample``), and the
    port's decode equals Pillow's. (1, 1) holds the writer itself."""
    for h, w in ((21, 37), (40, 70), (9, 5)):
        data = _jpeg_sampled(_image(h, w, 4), [luma, (1, 1), (1, 1)])
        got = codec.decode(data)
        assert got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, _pil_decode(data), err_msg=f"{h}x{w}")


def test_fractional_sampling_ratio_raises():
    """A luma 3×1 against a chroma 2×1 is a ratio of 1.5: refused by name
    (libjpeg: JERR_FRACT_SAMPLE_NOTIMPL)."""
    data = _jpeg_sampled(_image(16, 48, 5), [(3, 1), (2, 1), (1, 1)])
    with pytest.raises(ValueError, match="fractional sampling ratio"):
        codec.decode(data)
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data)).load()


def test_restart_intervals_and_tiny_images():
    """DRI / RSTn every 3 MCUs and every MCU row; and images whose chroma is
    at most 2 samples wide (libjpeg-turbo replicates instead of fancy
    upsampling there)."""
    arr = _image(70, 53)
    for kw in ({"restart_marker_blocks": 3}, {"restart_marker_rows": 1}):
        data = _pil_jpeg(arr, quality=90, **kw)
        assert b"\xff\xdd" in data
        np.testing.assert_array_equal(codec.decode(data), _pil_decode(data))
    for h, w in ((1, 1), (3, 3), (4, 5), (2, 7), (9, 2)):
        for ss in (1, 2):
            data = _pil_jpeg(_image(h, w), quality=90, subsampling=ss)
            np.testing.assert_array_equal(codec.decode(data), _pil_decode(data))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_matches_exif_transpose(orientation):
    arr = _image(21, 34)
    exif = Image.Exif()
    exif[0x0112] = orientation
    for fmt in ("JPEG", "PNG"):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, fmt, exif=exif.tobytes())
        data = buf.getvalue()
        got = codec.decode(data)
        np.testing.assert_array_equal(got, _pil_decode(data), err_msg=fmt)
        assert got.shape[:2] == ((34, 21) if orientation >= 5 else (21, 34))


def _png(px: np.ndarray, color_type: int, palette=None, depth: int = 8,
         width: int = None) -> bytes:
    """A PNG of ``px`` (H, W, C), each row with filter type ``row % 5``
    (none, sub, up, average, Paeth), encoded here; below 8 bits ``px`` holds
    the packed row bytes (C = 1) and ``width`` the pixels a row."""
    h, w = px.shape[:2]
    bpp = px.shape[2]
    rows = px.reshape(h, -1).astype(np.int32)
    out = []
    for y in range(h):
        f = y % 5
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
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

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", width or w, h, depth,
                                                             color_type, 0, 0, 0))
    if palette is not None:
        data += chunk(b"PLTE", palette.tobytes())
    return data + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b"")


@pytest.mark.parametrize("color_type,channels", [(0, 1), (4, 2), (2, 3), (6, 4), (3, 1)],
                         ids=["gray", "gray_alpha", "rgb", "rgba", "palette"])
def test_png_color_types_and_filters_match_pillow(color_type, channels):
    rng = np.random.default_rng(3)
    palette = None
    if color_type == 3:
        palette = rng.integers(0, 256, (40, 3), np.uint8)
        px = rng.integers(0, 40, (23, 19, 1), np.uint8)
    else:
        px = rng.integers(0, 256, (23, 19, channels), np.uint8)
    data = _png(px, color_type, palette)
    got = codec.decode(data)
    np.testing.assert_array_equal(got, _pil_decode(data))
    # Pillow's own files (adaptive filters, zlib levels) too
    mode = {0: "L", 4: "LA", 2: "RGB", 6: "RGBA", 3: "P"}[color_type]
    img = Image.fromarray(px[..., 0] if channels == 1 else px, "L" if mode == "P" else mode)
    if mode == "P":
        img = img.convert("P")
        img.putpalette(palette.tobytes())
    for level in (0, 6, 9):
        buf = io.BytesIO()
        img.save(buf, "PNG", compress_level=level)
        np.testing.assert_array_equal(codec.decode(buf.getvalue()),
                                      _pil_decode(buf.getvalue()))


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("kind", ["gray", "palette"])
def test_png_low_bit_depths_match_pillow(kind, depth):
    """1-, 2- and 4-bit gray and palette PNGs (rows padded to a byte at an odd
    width), written by Pillow, decode to Pillow's ``convert("RGB")`` bytes:
    gray scaled ×255, ×85, ×17, palette indices looked up as they are."""
    rng = np.random.default_rng(depth)
    for h, w in ((13, 19), (5, 3), (1, 1)):
        idx = rng.integers(0, 1 << depth, (h, w), np.uint8)
        if kind == "gray" and depth == 1:
            img = Image.fromarray(idx.astype(bool))  # mode "1": a 1-bit file
        elif kind == "gray":
            img = None  # Pillow writes L at 8 bits: the file is made here
        else:
            img = Image.fromarray(idx, "P")
            img.putpalette(rng.integers(0, 256, (1 << depth) * 3, np.uint8).tobytes())
        if img is not None:
            buf = io.BytesIO()
            img.save(buf, "PNG", **({"bits": depth} if kind == "palette" else {}))
            data = buf.getvalue()
        else:
            data = _packed_gray_png(idx, depth)
        assert struct.unpack(">B", data[24:25])[0] == depth
        got = codec.decode(data)
        assert got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, _pil_decode(data), err_msg=f"{h}x{w}")


def _packed_gray_png(idx: np.ndarray, depth: int) -> bytes:
    """A ``depth``-bit gray PNG of the sample values ``idx`` (H, W), rows
    packed most significant bits first, each with filter type ``row % 5``
    applied to its bytes."""
    h, w = idx.shape
    per = 8 // depth
    pad = np.zeros((h, -w % per), np.uint8)
    s = np.concatenate([idx, pad], 1).reshape(h, -1, per).astype(np.uint16)
    shifts = np.arange(8 - depth, -1, -depth)
    packed = (s << shifts).sum(-1).astype(np.uint8)
    return _png(packed[..., None], 0, depth=depth, width=w)


def test_write_png_round_trips(tmp_path):
    arr = _image(31, 45)
    path = tmp_path / "x.png"
    imaging.write_png(str(path), arr)
    data = path.read_bytes()
    np.testing.assert_array_equal(codec.decode(data), arr)
    np.testing.assert_array_equal(_pil_decode(data), arr)


@pytest.mark.parametrize("quality", [90, 75])
def test_encode_matches_pillow_save(quality):
    """Pillow decodes the port's file to the pixels of Pillow's own file; the
    two files are byte-equal (JFIF, tables, 4:2:0, fdct, quantization and
    Huffman coding all as libjpeg-turbo does them)."""
    for h, w in SIZES + [(512, 512)]:
        for arr in (_image(h, w, 4), _image(h, w, 4)[..., 0]):
            mine, pil = codec.encode_jpeg(arr, quality), _pil_jpeg(arr, quality=quality)
            np.testing.assert_array_equal(_pil_decode(mine), _pil_decode(pil))
            assert mine == pil, f"{h}x{w} {arr.ndim}-D: files differ"
            np.testing.assert_array_equal(codec.decode(mine), _pil_decode(pil))


def test_base64_and_data_url():
    arr = _image(40, 24)
    b64 = codec.to_base64_jpeg(arr)
    assert base64.b64decode(b64) == _pil_jpeg(arr, quality=90)
    want = _pil_decode(base64.b64decode(b64))
    for s in (b64, "data:image/jpeg;base64," + b64):
        np.testing.assert_array_equal(codec.decode_base64(s), want)
    np.testing.assert_array_equal(codec.to_array(s), want)
    assert codec.to_array(arr) is arr


def _patched_sof(data: bytes, marker: int = None, precision: int = None) -> bytes:
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


def test_unsupported_inputs_raise_named_errors():
    arr = _image(24, 24)
    base = _pil_jpeg(arr, quality=90)
    # a 16-bit CIELab TIFF: Pillow has no mode for it (its 8-bit one decodes:
    # test_cielab_tiff_decodes_to_pillows_pixels)
    tiff = tiff_file(arr, 8, 16)
    gif, bmp, webp = io.BytesIO(), io.BytesIO(), io.BytesIO()
    Image.fromarray(arr).save(gif, "GIF")
    Image.fromarray(arr).save(bmp, "BMP")
    Image.fromarray(arr).save(webp, "WEBP")
    cases = {
        "hierarchical": _patched_sof(base, marker=0xC5),
        "arithmetic-coded lossless": _patched_sof(base, marker=0xCB),
        "12-bit": _patched_sof(base, precision=12),
        "lossless": _patched_sof(base, marker=0xC3),
        "TIFF": tiff,
        "truncated": base[:len(base) // 2],
        "truncated GIF": gif.getvalue()[:len(gif.getvalue()) // 2],
        "truncated BMP": bmp.getvalue()[:len(bmp.getvalue()) // 2],
        "truncated WebP": webp.getvalue()[:len(webp.getvalue()) // 2],
        "not a JPEG, PNG, BMP, GIF, WebP or TIFF": b"\x00\x01" + bytes(40),
    }
    for name, data in cases.items():
        with pytest.raises(ValueError, match=name):
            codec.decode(data)
    with pytest.raises(ValueError):
        codec.decode_base64("!!!not-base64!!!")


def test_cielab_tiff_decodes_to_pillows_pixels():
    """Pillow's LAB mode saved as TIFF (CIELab, a and b signed), once refused
    here: the port's LittleCMS arithmetic gives Pillow's RGB."""
    buf = io.BytesIO()
    Image.fromarray(_image(24, 24)).convert("LAB").save(buf, "TIFF")
    np.testing.assert_array_equal(codec.decode(buf.getvalue()),
                                  np.asarray(Image.open(buf).convert("RGB")))


def _png_chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def test_png_inflates_no_further_than_its_rows():
    """A 1×1 PNG whose IDAT inflates to 64 MiB of zeros decodes as Pillow
    decodes it, and the inflate stops at the image's 4 filtered bytes."""
    import tracemalloc

    comp = zlib.compressobj(9)
    zeros = bytes(1 << 20)
    idat = b"".join(comp.compress(zeros) for _ in range(64)) + comp.flush()
    del zeros
    bomb = (codec.PNG_SIGNATURE
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", 1, 1, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", idat) + _png_chunk(b"IEND", b""))
    codec.library()
    tracemalloc.start()
    try:
        got = codec.decode(bomb)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    np.testing.assert_array_equal(got, _pil_decode(bomb))
    assert peak < 8 * len(bomb), peak


def test_oversized_images_raise_before_allocating():
    """Past Pillow's DecompressionBombError limit (2 * MAX_IMAGE_PIXELS) a
    JPEG's frame header or a PNG's IHDR raises; a header that declares more
    pixels than its data holds raises as truncated."""
    assert codec.MAX_PIXELS == 2 * Image.MAX_IMAGE_PIXELS
    base = _pil_jpeg(_image(16, 16), quality=90)
    i = base.index(b"\xff\xc0")

    def sof(h: int, w: int) -> bytes:
        return base[:i + 5] + struct.pack(">HH", h, w) + base[i + 9:]

    side = int(codec.MAX_PIXELS ** 0.5) + 1  # 13378² > the limit
    png_hdr = codec.PNG_SIGNATURE + _png_chunk(
        b"IHDR", struct.pack(">IIBBBBB", side, side, 8, 2, 0, 0, 0))
    for data in (sof(side, side), sof(16384, 16384),
                 png_hdr + _png_chunk(b"IDAT", zlib.compress(bytes(64)))):
        with pytest.raises(ValueError, match="decompression-bomb limit"):
            codec.decode(data)
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(sof(side, side)))
    # no EOI: the data runs out, so the decode stops there (Pillow: truncated)
    with pytest.raises(OSError, match="truncated"):
        Image.open(io.BytesIO(sof(4096, 4096)[:-2])).load()
    for data in (sof(4096, 4096)[:-2],
                 codec.PNG_SIGNATURE + _png_chunk(
                     b"IHDR", struct.pack(">IIBBBBB", 4096, 4096, 8, 2, 0, 0, 0))
                 + _png_chunk(b"IDAT", zlib.compress(bytes(64)))):
        with pytest.raises(ValueError, match="truncated"):
            codec.decode(data)


def test_dc_huffman_symbol_above_15_is_refused():
    """A DC Huffman symbol is a bit count of 0..15; libjpeg refuses a table
    that holds a larger one (Pillow: broken data stream), and so does the
    port's decoder, before any scan reads it."""
    data = bytearray(_pil_jpeg(_image(24, 24), quality=90))
    i = data.index(b"\xff\xc4")
    assert data[i + 4] == 0x00  # Pillow writes the luma DC table first
    nsym = sum(data[i + 5:i + 21])
    data[i + 21 + nsym - 1] = 16
    with pytest.raises(OSError):
        Image.open(io.BytesIO(bytes(data))).load()
    with pytest.raises(ValueError, match="bad Huffman table"):
        codec.decode(bytes(data))


def _pil_decode_c_idct(cases, tmp_path) -> list:
    """Pillow's decode of each file in a process where libjpeg-turbo runs
    its C code (``JSIMD_FORCENONE``): jidctint.c, which the port follows."""
    import subprocess
    import sys

    src = tmp_path / "cases.npz"
    np.savez(src, *[np.frombuffer(c, np.uint8) for c in cases])
    script = (
        "import io, sys, numpy as np\n"
        "from PIL import Image, ImageOps\n"
        "z = np.load(sys.argv[1])\n"
        "out = [np.asarray(ImageOps.exif_transpose(Image.open(io.BytesIO("
        "z[f'arr_{i}'].tobytes()))).convert('RGB')) for i in range(len(z.files))]\n"
        "np.savez(sys.argv[2], *out)\n")
    dst = tmp_path / "decoded.npz"
    subprocess.run([sys.executable, "-c", script, str(src), str(dst)], check=True,
                   env={**os.environ, "JSIMD_FORCENONE": "1"})
    z = np.load(dst)
    return [z[f"arr_{i}"] for i in range(len(cases))]


def test_scan_cut_short_by_a_marker_matches_pillow(tmp_path):
    """Entropy-coded data that stops at a marker: zero bits are fed, the MCU
    that reads one is finished with them and the rest of the interval stays
    zero (jdhuff.c); at a restart boundary the marker that stands there is
    resynchronised as jdmarker.c does. The cuts land inside a scan without
    restarts (EOI, alone or followed by the rest of the file), at the restart
    markers of a file with one every MCU (EOI in place of one, a marker
    dropped, one of a later or an earlier interval) and 2 to 4 bytes before
    them.

    Such cuts can leave coefficients far outside a valid block's range, where
    libjpeg-turbo's x86 SIMD IDCT (16-bit saturating arithmetic) and its C
    IDCT (jidctint.c, the port's) disagree; so the reference here is Pillow
    with libjpeg-turbo's SIMD off. With it on, every case that does not
    reach that range agrees too."""
    arr = _image(40, 56)
    cases = []
    for sub in (0, 2):
        d = _pil_jpeg(arr, quality=90, subsampling=sub)
        sos = d.index(b"\xff\xda")
        start = sos + 2 + int.from_bytes(d[sos + 2:sos + 4], "big")
        for k in np.linspace(start + 1, len(d) - 3, 12).astype(int):
            cases += [d[:k] + b"\xff\xd9", d[:k] + b"\xff\xd9" + d[k:]]
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", quality=90, subsampling=sub,
                                  restart_marker_blocks=1)
        d = buf.getvalue()
        rsts = [i for i in range(start, len(d) - 1)
                if d[i] == 0xFF and 0xD0 <= d[i + 1] <= 0xD7]
        for i in rsts[1::3]:
            n = d[i + 1] - 0xD0
            cases += [d[:i] + b"\xff\xd9", d[:i] + d[i + 2:]]
            cases += [d[:i + 1] + bytes([0xD0 + (n + j) % 8]) + d[i + 2:] for j in (1, 3, 7)]
            cases += [d[:i - back] + b"\xff\xd9" for back in (2, 3, 4)]
    want = _pil_decode_c_idct(cases, tmp_path)
    simd_equal = 0
    for data, ref in zip(cases, want):
        got = codec.decode(data)
        np.testing.assert_array_equal(got, ref)
        simd_equal += np.array_equal(got, _pil_decode(data))
    assert simd_equal >= len(cases) * 9 // 10, (simd_equal, len(cases))


def test_jpeg_header_query_reads_no_scan():
    """``qie_jpeg_info`` stops at the first scan header: a file whose
    entropy-coded data is cut short still reports its size, and only the
    decode (the one entropy decode a request pays) raises."""
    import ctypes

    data = _pil_jpeg(_image(48, 40), quality=90)
    cut = data[:data.index(b"\xff\xda") + 40]
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    off, ln, err = ctypes.c_long(), ctypes.c_long(), ctypes.create_string_buffer(256)
    rc = codec.library().qie_jpeg_info(cut, len(cut), ctypes.byref(w), ctypes.byref(h),
                                       ctypes.byref(c), ctypes.byref(off), ctypes.byref(ln),
                                       err, len(err))
    assert rc == 0 and (w.value, h.value, c.value) == (40, 48, 3), err.value
    with pytest.raises(ValueError, match="truncated"):
        codec.decode(cut)


def test_blend_matches_pillow():
    rng = np.random.default_rng(5)
    a, b = (rng.integers(0, 256, (29, 31, 3), np.uint8) for _ in range(2))
    for ratio in (0.0, 0.25, 0.5, 0.3, 0.77, 1.0, 0.1234567, 1.5, -0.4):
        want = np.asarray(Image.blend(Image.fromarray(a), Image.fromarray(b), ratio))
        np.testing.assert_array_equal(imaging.blend(a, b, ratio), want)
    # a second image of another size is resized (LANCZOS) to the first's
    c = rng.integers(0, 256, (40, 17, 3), np.uint8)
    want = np.asarray(Image.blend(Image.fromarray(a),
                                  Image.fromarray(c).resize((31, 29), Image.LANCZOS), 0.5))
    np.testing.assert_array_equal(imaging.blend(a, c, 0.5), want)


def test_library_is_built_from_its_source_hash():
    path = codec.library_path()
    codec.library()
    assert path.exists() and path.parent.name == "host"
    assert path.name.startswith("libqie_codec_")


# ---------------------------------------------------------------------------
# Progressive JPEG, Adam7 and 16-bit PNG
# ---------------------------------------------------------------------------

PROGRESSIVE_SIZES = [(1, 1), (7, 5), (24, 24), (33, 17), (257, 129), (1024, 768)]


def _pil_progressive(arr, monkeypatch, **kw) -> bytes:
    """Pillow's progressive file: libjpeg's default script (interleaved DC at
    Al 1, the AC bands first at Al 2 or 1, then every refinement to Al 0) and
    its per-scan optimised Huffman tables. Pillow sizes its output buffer by
    the pixel count; a larger floor lets it write q100 files."""
    from PIL import ImageFile

    monkeypatch.setattr(ImageFile, "MAXBLOCK", 1 << 25)
    return _pil_jpeg(arr, progressive=True, **kw)


def _scans(data: bytes):
    """(header, [each scan with the tables before it], EOI) of a JPEG."""
    i, scans, start = 2, [], None
    while data[i + 1] != 0xD9:
        m, n = data[i + 1], int.from_bytes(data[i + 2:i + 4], "big")
        if m in (0xC4, 0xDA) and start is None:
            start = i
        i += 2 + n
        if m == 0xDA:
            while not (data[i] == 0xFF and data[i + 1] != 0 and not 0xD0 <= data[i + 1] <= 0xD7):
                i += 1
            scans.append(data[start:i])
            start = None
    head = data[:data.index(scans[0])]
    return head, scans, data[i:]


@pytest.mark.parametrize("subsampling", [0, 1, 2, "gray"], ids=["444", "422", "420", "gray"])
@pytest.mark.parametrize("hw", PROGRESSIVE_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_progressive_jpeg_matches_pillow(hw, subsampling, monkeypatch):
    arr = _image(*hw)
    for q in (50, 90, 100):
        if subsampling == "gray":
            data = _pil_progressive(arr[..., 0], monkeypatch, quality=q)
        else:
            data = _pil_progressive(arr, monkeypatch, quality=q, subsampling=subsampling)
        assert b"\xff\xc2" in data
        np.testing.assert_array_equal(codec.decode(data), _pil_decode(data), err_msg=f"q{q}")


def test_progressive_restarts_and_orientation(monkeypatch):
    """Restart intervals end EOB runs and DC predictions; EXIF orientation
    applies as in a baseline file."""
    arr = _image(70, 53)
    for kw in ({"restart_marker_blocks": 3}, {"restart_marker_blocks": 1},
               {"restart_marker_rows": 1}):
        data = _pil_progressive(arr, monkeypatch, quality=90, **kw)
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
        np.testing.assert_array_equal(codec.decode(data), _pil_decode(data), err_msg=str(kw))
    for orientation in (3, 6):
        exif = Image.Exif()
        exif[0x0112] = orientation
        data = _pil_progressive(arr, monkeypatch, quality=90, exif=exif.tobytes())
        got = codec.decode(data)
        np.testing.assert_array_equal(got, _pil_decode(data))
        assert got.shape[:2] == ((53, 70) if orientation == 6 else (70, 53))


def test_progressive_cut_files(monkeypatch):
    """A cut progressive file raises "truncated JPEG", where Pillow raises
    too; scans that stop short with an EOI after them are what libjpeg-turbo
    block-smooths, and decode to Pillow's smoothed pixels; a file without its
    DC first scan is not smoothed there, and decodes to Pillow's pixels."""
    data = _pil_progressive(_image(40, 56), monkeypatch, quality=90)
    head, scans, tail = _scans(data)
    assert len(scans) == 10 and head + b"".join(scans) + tail == data
    for cut in (len(data) // 2, len(head) + len(scans[0]) + len(scans[1]), len(data) - 2):
        with pytest.raises(ValueError, match="truncated JPEG"):
            codec.decode(data[:cut])
        with pytest.raises(OSError):
            Image.open(io.BytesIO(data[:cut])).load()
    for k in range(1, 10):
        cut = head + b"".join(scans[:k]) + tail
        np.testing.assert_array_equal(codec.decode(cut), _pil_decode(cut))
    no_dc = head + b"".join(scans[1:]) + tail
    np.testing.assert_array_equal(codec.decode(no_dc), _pil_decode(no_dc))


def test_progressive_bad_progression_is_refused(monkeypatch):
    """An AC scan over two components, Ah not Al + 1, Al above 13: libjpeg's
    JERR_BAD_PROGRESSION, named."""
    data = _pil_progressive(_image(16, 16), monkeypatch, quality=90)
    head, scans, tail = _scans(data)
    sos = scans[1].index(b"\xff\xda")
    n = scans[1][sos + 4]
    at = sos + 5 + 2 * n  # Ss, Se, Ah/Al
    for patch in (bytes([1, 63, 0x31]), bytes([1, 63, 0x0E]), bytes([0, 5, 0x00])):
        bad = scans[1][:at] + patch + scans[1][at + 3:]
        with pytest.raises(ValueError, match="bad progression"):
            codec.decode(head + scans[0] + bad + b"".join(scans[2:]) + tail)


_PNG_DEPTHS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2),
               (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("color_type,depth", _PNG_DEPTHS,
                         ids=[f"type{c}-{d}bit" for c, d in _PNG_DEPTHS])
def test_png_every_type_and_depth_interlaced_or_not(color_type, depth):
    """Every colour type at every depth PNG allows it, Adam7-interlaced and
    not, a random filter a row (of each pass), at sizes where passes are
    empty (under 8 on one or both axes): Pillow's ``convert("RGB")`` bytes.
    At 16 bits that keeps RGB(A)'s and gray + alpha's high bytes and clips
    16-bit gray (I;16) at 255; a tRNS chunk changes nothing."""
    from scripts.codec_fixtures import png_file

    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    for h, w in ((1, 1), (3, 5), (7, 2), (2, 9), (9, 13), (33, 17)):
        rng = np.random.default_rng(h * 100 + w)
        samples = rng.integers(0, 1 << depth, (h, w, channels))
        if color_type == 0 and depth == 16:
            samples[0, 0], samples[-1, -1] = 250, 500  # under and over 255
        palette = (rng.integers(0, 256, (1 << min(depth, 8), 3), np.uint8)
                   if color_type == 3 else None)
        trns = [None]
        if depth == 16 and color_type in (0, 2):
            trns.append(struct.pack(">" + "H" * channels, *samples[0, 0]))
        for interlace in (False, True):
            for t in trns:
                data = png_file(samples, color_type, depth, interlace, palette, t, seed=h + w)
                got = codec.decode(data)
                np.testing.assert_array_equal(
                    got, _pil_decode(data), err_msg=f"{h}x{w} interlace {interlace} tRNS {t}")


def test_committed_fixtures_match_their_manifest_and_pillow():
    """The files ``chip_smoke.py`` decodes on the card's host (which has no
    Pillow): the manifest's shapes and hashes are Pillow's decode, and the
    port's decode equals them."""
    import hashlib
    import json

    root = os.path.join(os.path.dirname(__file__), "fixtures", "codec")
    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    # the fixture tree's budget: 1 MB, and 0.8 MB more for the AVIF fixtures
    assert sum(e["bytes"] for e in manifest.values()) < 1_800_000
    for name, entry in manifest.items():
        with open(os.path.join(root, name), "rb") as f:
            data = f.read()
        assert len(data) == entry["bytes"]
        for px in (_pil_decode(data), codec.decode(data)):
            assert list(px.shape) == entry["shape"], name
            assert hashlib.sha256(px.tobytes()).hexdigest() == entry["sha256"], name
    assert b"\xff\xc2" in open(os.path.join(root, "prog_1024.jpg"), "rb").read()


def test_unmatched_huffman_code_is_read_as_libjpeg_reads_it(tmp_path):
    """A code that matches no entry of its table (all ones for up to 16 bits
    here, stuffed 0xFF bytes) makes libjpeg warn, drop the 17 bits it read
    and take the symbol as 0, and go on: the port decodes the damaged scan
    to the same pixels (baseline and progressive, every place tried)."""
    cases = []
    for progressive in (False, True):
        data = _pil_jpeg(_image(32, 40, 3), quality=90, progressive=progressive)
        sos = data.index(b"\xff\xda")
        start = sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]
        for at in (0, 7, 23):
            cases.append(data[:start + at] + b"\xff\x00" * 3 + data[start + at:])
    for got, want in zip([codec.decode(c) for c in cases], _pil_decode_c_idct(cases, tmp_path)):
        np.testing.assert_array_equal(got, want)
