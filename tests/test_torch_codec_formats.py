"""The port's codec on the rest of the upload formats (``core/codec.py`` over
``csrc/host/image_codec.cc``, ``bmp_gif.cc`` and ``webp.cc``) against Pillow,
which the JAX package's ``core/imaging.py`` opens every upload with
(``Image.open`` → ``ImageOps.exif_transpose`` → ``convert("RGB")``).

Every case must equal Pillow's bytes exactly: CMYK, YCCK and RGB-coded JPEG
at each sampling, baseline and progressive; BMP at every header, depth and
compression; GIF's first frame with global and local palettes, interlace,
transparency and an offset frame; WebP lossy (libwebp's own encoder driven
through ``ctypes`` for the simple loop filter, sharpness, token partitions
and segments), lossless, with alpha, EXIF- and XMP-rotated, and the first
frame of an animation. Files written by ``scripts/codec_fixtures.py``'s
writers where Pillow writes no such file. Cut and hostile files raise a
``ValueError`` that names the format, where Pillow refuses them too.
"""

import io
import os
import struct
import sys

import numpy as np
import pytest
from PIL import Image, ImageOps, PngImagePlugin

from qwen_image_edit_streamdiffusion_tpu.core import imaging as jimaging
from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
from codec_fixtures import bmp_file, gif_file, libwebp_encode, scene  # noqa: E402

SIZES = [(1, 1), (17, 9), (64, 64), (33, 70)]
IDS = [f"{h}x{w}" for h, w in SIZES]


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(ImageOps.exif_transpose(Image.open(io.BytesIO(data))).convert("RGB"))


def _same(data: bytes) -> np.ndarray:
    """The port's decode, held to Pillow's and the JAX ``bytes_to_pil``'s."""
    got = codec.decode(data)
    want = _pil(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def _noise(h, w, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), np.uint8)


def _save(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _exif(orientation: int) -> Image.Exif:
    exif = Image.Exif()
    exif[0x0112] = orientation
    return exif


# ---------------------------------------------------------------------------
# JPEG colour transforms
# ---------------------------------------------------------------------------


def _adobe_transform(data: bytes, transform: int) -> bytes:
    i = data.index(b"Adobe")
    return data[:i + 11] + bytes([transform]) + data[i + 12:]


def _rgb_coded(data: bytes) -> bytes:
    """A JFIF YCbCr file relabelled as RGB-coded: its APP0 replaced by an
    Adobe APP14 with transform 0, so the three components are read as R, G
    and B with no colour conversion (Pillow writes RGB-coded files at 1x1
    only)."""
    i = data.index(b"\xff\xe0")
    (n,) = struct.unpack(">H", data[i + 2:i + 4])
    app14 = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    return data[:i] + app14 + data[i + 2 + n:]


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("hw", SIZES, ids=IDS)
def test_cmyk_and_ycck_jpeg_match_pillow(hw, subsampling, progressive):
    """Pillow's CMYK files (Adobe transform 0, read inverted) and the same
    files marked YCCK (transform 2: libjpeg-turbo's ycck_cmyk_convert), the
    luma-position component sampled 1x1, 2x1 or 2x2, q 50/90/100."""
    h, w = hw
    for q, arr in ((50, _noise(h, w, 4)), (90, np.concatenate([scene(h, w), _noise(h, w, 1)], -1)),
                   (100, _noise(h, w, 4, 1))):
        data = _save(Image.fromarray(arr, "CMYK"), "JPEG", quality=q, subsampling=subsampling,
                     progressive=progressive)
        _same(data)
        _same(_adobe_transform(data, 2))


@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("hw", SIZES, ids=IDS)
def test_rgb_coded_jpeg_matches_pillow(hw, subsampling):
    h, w = hw
    for q in (50, 90, 100):
        for progressive in (False, True):
            _same(_rgb_coded(_save(Image.fromarray(_noise(h, w)), "JPEG", quality=q,
                                   subsampling=subsampling, progressive=progressive)))
    _same(_save(Image.fromarray(scene(h, w)), "JPEG", keep_rgb=True, quality=90))
    _same(_save(Image.fromarray(scene(h, w)), "JPEG", keep_rgb=True, progressive=True))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_cmyk_jpeg_exif_orientation(orientation):
    arr = np.concatenate([scene(12, 20), _noise(12, 20, 1)], -1)
    data = _save(Image.fromarray(arr, "CMYK"), "JPEG", quality=90, exif=_exif(orientation))
    got = _same(data)
    assert got.shape[:2] == ((20, 12) if orientation >= 5 else (12, 20))
    _same(_adobe_transform(data, 2))


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------

# (header, bits, masks): a CORE header written at 24 bits only, a 40-byte
# one with no alpha mask
BMP_RGB = [(12, 24, None)] + [
    (header, bits, masks) for header in (40, 108, 124)
    for bits, masks in ((16, None), (16, (0xF800, 0x7E0, 0x1F)), (16, (0x7C00, 0x3E0, 0x1F)),
                        (24, None), (32, None), (32, (0xFF0000, 0xFF00, 0xFF, 0)),
                        (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
                        (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)),
                        (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)),
                        (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)))
    if not (header == 40 and masks and len(masks) == 4 and masks[3])]


# (header, bits, compression): a CORE header has no compression field
BMP_PALETTE = [(header, bits, comp) for header in (12, 40, 108, 124)
               for bits, comp in ((1, 0), (4, 0), (8, 0), (4, 2), (8, 1))
               if not (header == 12 and comp)]


@pytest.mark.parametrize("header,bits,compression", BMP_PALETTE,
                         ids=[f"h{h}-{b}bit-c{c}" for h, b, c in BMP_PALETTE])
@pytest.mark.parametrize("hw", SIZES, ids=IDS)
def test_bmp_palette_depths_match_pillow(hw, header, bits, compression):
    h, w = hw
    rng = np.random.default_rng(bits)
    pal = rng.integers(0, 256, (1 << bits, 3))
    idx = rng.integers(0, 1 << bits, (h, w))
    idx[:, :w // 2] = idx[:, :1]  # runs for RLE
    for top_down in ((False, True) if header > 12 and not compression else (False,)):
        _same(bmp_file(idx, bits, header, pal, compression, top_down=top_down))
    if bits == 8:
        _same(bmp_file(idx, 8, header, pal[:5], compression))  # indices past the palette
        gray = np.arange(256)[:, None].repeat(3, 1)
        _same(bmp_file(idx, 8, header, gray, compression))  # Pillow's "L"
    if bits == 1:
        _same(bmp_file(idx, 1, header, [[0, 0, 0], [255, 255, 255]]))  # Pillow's "1"


@pytest.mark.parametrize("header,bits,masks", BMP_RGB,
                         ids=[f"h{h}-{b}-{m and hex(m[0])}-{m and len(m)}" for h, b, m in BMP_RGB])
@pytest.mark.parametrize("hw", SIZES[1:], ids=IDS[1:])
def test_bmp_rgb_depths_and_bitfields_match_pillow(hw, header, bits, masks):
    h, w = hw
    rgba = np.concatenate([scene(h, w, 2), _noise(h, w, 1)], -1)
    for top_down in ((False, True) if header > 12 else (False,)):
        _same(bmp_file(rgba if bits == 32 else rgba[..., :3], bits, header, masks=masks,
                       top_down=top_down))


def test_bmp_written_by_pillow_and_rle_quirks():
    """Pillow's own BMPs (1, 8 and 24 bits) and the RLE streams its decoder
    reads its own way: a delta escape (it skips two bytes and reads the
    next two), an RLE4 absolute run of odd length, a row overflowing its
    width and padding by end-of-line."""
    arr = scene(21, 13)
    for im in (Image.fromarray(arr), Image.fromarray(arr).convert("L"),
               Image.fromarray(arr).convert("1"), Image.fromarray(arr).quantize(50)):
        _same(_save(im, "BMP"))
    pal = np.random.default_rng(3).integers(0, 256, (256, 3))
    head = bmp_file(np.zeros((4, 6), np.int64), 8, 40, pal, 1)
    off = struct.unpack("<I", head[10:14])[0]
    for rle4, stream in ((False, b"\x03\x07\x00\x02\x00\x00\x02\x01\x00\x03\x01\x02\x03\x00"
                                  b"\x00\x00\x09\x05\x00\x00\x02\x06\x00\x00\x00\x01"),
                         (True, b"\x00\x03\x12\x30\x04\x45\x00\x00\x06\x67\x00\x00"
                                b"\x00\x05\x89\xab\x00\x00\x00\x00\x06\x11\x00\x01")):
        data = bytearray(head[:off] + stream)
        data[30:34] = struct.pack("<I", 2 if rle4 else 1)
        data[28:30] = struct.pack("<H", 4 if rle4 else 8)
        data[2:6] = struct.pack("<I", len(data))
        try:
            want = _pil(bytes(data))
        except (OSError, ValueError):
            with pytest.raises(ValueError, match="BMP"):
                codec.decode(bytes(data))
            continue
        np.testing.assert_array_equal(codec.decode(bytes(data)), want)


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("interlace", [False, True], ids=["progressive", "interlaced"])
@pytest.mark.parametrize("hw", SIZES, ids=IDS)
def test_gif_first_frame_matches_pillow(hw, interlace):
    """Global and local palettes (a local gray identity one makes the image
    "L"), a transparency index, a frame offset on a larger screen, the
    minimum code size 2 to 8, Pillow's own files."""
    h, w = hw
    rng = np.random.default_rng(h * w)
    pal = rng.integers(0, 256, (256, 3))
    idx = rng.integers(0, 200, (h, w))
    gray = np.arange(256)[:, None].repeat(3, 1)
    cases = [gif_file(idx, pal, interlace=interlace),
             gif_file(idx, gray[:8] + 9, local=pal, interlace=interlace, offset=(3, 2),
                      screen=(w + 5, h + 9), transparency=5),
             gif_file(idx % 16, None, local=pal[:16], min_code=4, transparency=3, offset=(1, 0),
                      interlace=interlace),
             gif_file(idx % 4, None, min_code=2, interlace=interlace),
             gif_file(idx, pal, local=gray, interlace=interlace),
             gif_file(idx % 64, pal[:8], min_code=6, interlace=interlace)]  # past the palette
    im = Image.fromarray(scene(h, w))
    cases += [_save(im, "GIF", interlace=interlace), _save(im.convert("L"), "GIF"),
              _save(im.quantize(7), "GIF", transparency=2, interlace=interlace)]
    for data in cases:
        _same(data)


def test_gif_table_full_and_clear_codes():
    """Noise long enough to fill the 4096-entry table many times over."""
    idx = np.random.default_rng(5).integers(0, 256, (300, 257))
    pal = np.random.default_rng(6).integers(0, 256, (256, 3))
    _same(gif_file(idx, pal))
    _same(gif_file(idx, pal, interlace=True))
    _same(gif_file(np.random.default_rng(7).integers(0, 2, (200, 300)), pal[:2], min_code=2))


# ---------------------------------------------------------------------------
# WebP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quality", [50, 90, 100])
@pytest.mark.parametrize("hw", SIZES, ids=IDS)
def test_lossy_webp_matches_pillow(hw, quality):
    h, w = hw
    for arr in (scene(h, w), _noise(h, w)):
        for method in (0, 4, 6):
            _same(_save(Image.fromarray(arr), "WEBP", quality=quality, method=method))
    rgba = np.concatenate([scene(h, w), _noise(h, w, 1)], -1)
    _same(_save(Image.fromarray(rgba, "RGBA"), "WEBP", quality=quality))
    _same(_save(Image.fromarray(rgba, "RGBA"), "WEBP", quality=quality, alpha_quality=50))


@pytest.mark.parametrize("hw", SIZES, ids=IDS)
def test_lossless_webp_matches_pillow(hw):
    """VP8L: Pillow's lossless files at its speeds, noise and smooth images,
    with alpha, exact and palette images (colour indexing at 1, 2, 4 and 8
    bits a pixel)."""
    h, w = hw
    rgba = np.concatenate([scene(h, w), _noise(h, w, 1)], -1)
    for arr in (scene(h, w), _noise(h, w)):
        for method in (0, 6):
            _same(_save(Image.fromarray(arr), "WEBP", lossless=True, method=method))
    _same(_save(Image.fromarray(rgba, "RGBA"), "WEBP", lossless=True, exact=True))
    _same(_save(Image.fromarray(rgba, "RGBA"), "WEBP", lossless=True, quality=0))
    for colors in (2, 3, 11, 40):
        _same(_save(Image.fromarray(scene(h, w)).quantize(colors).convert("RGB"), "WEBP",
                    lossless=True))


LIBWEBP = [dict(filter_type=0, filter_strength=60), dict(filter_type=0, filter_sharpness=5),
           dict(filter_type=1, filter_sharpness=7, filter_strength=100),
           dict(filter_strength=0), dict(partitions=1), dict(partitions=3),
           dict(segments=1), dict(segments=4, sns_strength=100, quality=30.0),
           dict(use_sharp_yuv=1, method=6, autofilter=1), dict(quality=0.0),
           dict(quality=100.0, method=0)]


@pytest.mark.parametrize("config", LIBWEBP, ids=["-".join(f"{k}{v}" for k, v in c.items())
                                                  for c in LIBWEBP])
def test_lossy_webp_encoder_settings_match_pillow(config):
    """Settings Pillow's writer does not expose: the simple loop filter,
    filter sharpness and strength, 2 and 8 token partitions, 1 and 4
    segments."""
    for h, w in ((17, 9), (130, 97)):
        arr = scene(h, w, 1)
        arr[h // 3:, :w // 2] = _noise(h, w)[h // 3:, :w // 2]
        _same(libwebp_encode(arr, **{"quality": 70.0, **config}))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_webp_exif_and_xmp_orientation(orientation):
    arr = scene(12, 20)
    for kw in (dict(quality=90), dict(lossless=True)):
        got = _same(_save(Image.fromarray(arr), "WEBP", exif=_exif(orientation), **kw))
        assert got.shape[:2] == ((20, 12) if orientation >= 5 else (12, 20))
        xmp = f'<x:xmpmeta><rdf:Description tiff:Orientation="{orientation}"/>'.encode()
        _same(_save(Image.fromarray(arr), "WEBP", xmp=xmp, **kw))
        # an EXIF without the tag leaves the XMP's
        _same(_save(Image.fromarray(arr), "WEBP", xmp=xmp, exif=Image.Exif(), **kw))


@pytest.mark.parametrize("orientation", [3, 6, 8])
def test_xmp_orientation_of_jpeg_and_png(orientation):
    """Pillow's ``getexif`` takes ``tiff:Orientation`` from XMP where the
    EXIF has none (a JPEG's APP1, a PNG's iTXt, zTXt or tEXt); an EXIF tag
    wins over it."""
    arr = scene(6, 10)
    xmp = f'<x:xmpmeta><rdf:Description tiff:Orientation="{orientation}"/>'
    _same(_save(Image.fromarray(arr), "JPEG", xmp=xmp.encode(), quality=95))
    _same(_save(Image.fromarray(arr), "JPEG", xmp=xmp.encode(), exif=_exif(2), quality=95))
    for add in ("itxt", "itxt_zip", "text", "text_zip"):
        info = PngImagePlugin.PngInfo()
        if add.startswith("itxt"):
            info.add_itxt("XML:com.adobe.xmp", xmp, zip=add.endswith("zip"))
        else:
            info.add_text("XML:com.adobe.xmp", xmp, zip=add.endswith("zip"))
        got = _same(_save(Image.fromarray(arr), "PNG", pnginfo=info))
        assert got.shape[:2] == ((10, 6) if orientation >= 5 else (6, 10))


def _riff(chunks) -> bytes:
    body = b"".join(tag + struct.pack("<I", len(d)) + d + b"\x00" * (len(d) & 1)
                    for tag, d in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _chunks(data: bytes) -> list:
    out, pos = [], 12
    while pos + 8 <= len(data):
        tag, (n,) = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])
        out.append((tag, data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def _animated(frame: bytes, canvas, offset, alpha: bool = False, second: bytes = None) -> bytes:
    """An animated WebP by hand: VP8X (animation flag), ANIM, the first ANMF
    frame holding ``frame``'s image chunks at ``offset`` (even) on
    ``canvas`` (W, H), and a second full-canvas frame."""
    def anmf(data, x, y):
        inner = [c for c in _chunks(data) if c[0] in (b"ALPH", b"VP8 ", b"VP8L")]
        im = Image.open(io.BytesIO(data))
        head = (struct.pack("<I", x // 2)[:3] + struct.pack("<I", y // 2)[:3]
                + struct.pack("<I", im.width - 1)[:3] + struct.pack("<I", im.height - 1)[:3]
                + struct.pack("<I", 100)[:3] + b"\x00")
        return (b"ANMF", head + b"".join(t + struct.pack("<I", len(d)) + d + b"\x00" * (len(d) & 1)
                                         for t, d in inner))
    w, h = canvas
    flags = 0x02 | (0x10 if alpha else 0)
    vp8x = bytes([flags, 0, 0, 0]) + struct.pack("<I", w - 1)[:3] + struct.pack("<I", h - 1)[:3]
    chunks = [(b"VP8X", vp8x), (b"ANIM", b"\x00\x00\x00\x00\x00\x00"), anmf(frame, *offset)]
    if second is not None:
        chunks.append(anmf(second, 0, 0))
    return _riff(chunks)


def test_animated_webp_first_frame_matches_pillow():
    """The first frame of an animation, smaller than the canvas and offset
    on it, lossy, lossy with alpha and lossless: black around it, as
    WebPAnimDecoder's first frame is (Pillow's own animations too)."""
    small = scene(20, 14, 4)
    rgba = np.concatenate([small, _noise(20, 14, 1)], -1)
    full = _save(Image.fromarray(scene(40, 30, 5)), "WEBP", quality=80)
    for frame, alpha in ((_save(Image.fromarray(small), "WEBP", quality=80), False),
                         (_save(Image.fromarray(rgba, "RGBA"), "WEBP", quality=80), True),
                         (_save(Image.fromarray(rgba, "RGBA"), "WEBP", lossless=True), True)):
        for offset in ((0, 0), (6, 10), (16, 20)):
            data = _animated(frame, (30, 40), offset, alpha, second=full)
            assert Image.open(io.BytesIO(data)).n_frames == 2
            _same(data)
    frames = [Image.fromarray(scene(24, 16, i)) for i in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=50)
    _same(buf.getvalue())


def test_webp_container_variants():
    """An extended (VP8X) still with ICCP/EXIF/XMP and unknown chunks, data
    past the RIFF size, and raw (uncompressed) ALPH."""
    arr = scene(15, 23)
    data = _save(Image.fromarray(arr), "WEBP", quality=80, exif=_exif(1), icc_profile=b"x" * 9,
                 xmp=b"<x/>")
    assert data[12:16] == b"VP8X"
    _same(data)
    _same(data + b"trailing bytes past the RIFF size")
    chunks = _chunks(data)
    _same(_riff(chunks[:1] + [(b"ZZZZ", b"unknown")] + chunks[1:]))
    rgba = np.concatenate([arr, _noise(15, 23, 1)], -1)
    lossy = _chunks(_save(Image.fromarray(rgba, "RGBA"), "WEBP", quality=70))
    raw = [(b"ALPH", b"\x00" + rgba[..., 3].tobytes()) if t == b"ALPH" else (t, d)
           for t, d in lossy]
    _same(_riff(raw))


# ---------------------------------------------------------------------------
# Cut and hostile files
# ---------------------------------------------------------------------------


def _formats():
    arr = scene(24, 24, 8)
    rgba = np.concatenate([arr, _noise(24, 24, 1)], -1)
    pal = np.random.default_rng(9).integers(0, 256, (256, 3))
    idx = np.random.default_rng(10).integers(0, 256, (24, 24))
    idx[:, :10] = 1
    return {
        "BMP": [bmp_file(arr, 24), bmp_file(idx, 8, 40, pal, 1), bmp_file(idx % 16, 4, 40, pal, 2)],
        "GIF": [gif_file(idx, pal), gif_file(idx, pal, interlace=True)],
        "WebP": [_save(Image.fromarray(arr), "WEBP", quality=80),
                 _save(Image.fromarray(arr), "WEBP", lossless=True),
                 _save(Image.fromarray(rgba, "RGBA"), "WEBP", quality=80)],
        "JPEG": [_save(Image.fromarray(rgba, "CMYK"), "JPEG", quality=90, progressive=True)],
    }


@pytest.mark.parametrize("fmt", ["BMP", "GIF", "WebP", "JPEG"])
def test_cut_files_fail_where_pillow_fails(fmt):
    """Every file cut at 16 points: where Pillow refuses the cut file the
    port raises a ValueError naming the format; where Pillow decodes it
    (the bytes cut are not needed), the port gives Pillow's pixels."""
    for data in _formats()[fmt]:
        for cut in sorted({1, 6, 13} | {len(data) * k // 13 for k in range(1, 13)}):
            part = data[:cut]
            try:
                want = _pil(part)
            except Exception:  # noqa: BLE001 - whatever Pillow raises
                with pytest.raises(ValueError, match=fmt if cut > 12 else None):
                    codec.decode(part)
                continue
            np.testing.assert_array_equal(codec.decode(part), want)


def test_hostile_files_raise_named_errors():
    """Headers past the decompression-bomb limit (refused before anything is
    allocated), LZW codes past the table, back-references and prefix codes
    the VP8L stream cannot have, an ALPH chunk that does not decode,
    variants named by what they are."""
    pal = np.zeros((2, 3), np.int64)
    huge = bytearray(bmp_file(np.zeros((2, 2), np.int64), 8, 40, pal))
    huge[18:26] = struct.pack("<ii", 60000, 60000)
    gif = bytearray(gif_file(np.zeros((4, 4), np.int64), pal))
    gif[6:10] = struct.pack("<HH", 65535, 65535)
    webp = bytearray(_save(Image.fromarray(scene(8, 8)), "WEBP", lossless=True))
    webp[21:25] = struct.pack("<I", (0x3FFF) | (0x3FFF << 14))
    cases = {
        "decompression-bomb limit": [bytes(huge), bytes(gif), bytes(webp)],
        "unsupported BMP: 2 bits": [_set_bmp(bmp_file(np.zeros((2, 2), np.int64), 8, 40, pal),
                                             28, struct.pack("<H", 2))],
        "unsupported BMP: compression 4 \\(JPEG\\)": [
            _set_bmp(bmp_file(np.zeros((2, 2), np.int64), 8, 40, pal), 30, struct.pack("<I", 4))],
        "unsupported BMP: a palette of 300 colours": [
            bmp_file(np.zeros((2, 2), np.int64), 8, 40, np.ones((300, 3), np.int64))],
        "unsupported BMP: bitfields layout": [
            bmp_file(_noise(3, 3, 4), 32, 108, masks=(0xFF00, 0xFF0000, 0xFF, 0))],
        "corrupt GIF: (bad first|LZW code past)": [_gif_codes([256 + 5]), _gif_codes([1, 300])],
        "corrupt GIF: no image": [b"GIF89a" + struct.pack("<HHBBB", 4, 4, 0, 0, 0) + b";"],
        "unsupported GIF: LZW minimum code size 9": [_gif_min_code(9)],
        "unsupported WebP: a VP8 frame that is not a key frame": [_vp8_not_key()],
        "corrupt WebP: bad VP8 start code": [_vp8_bad_start()],
        "(corrupt|truncated) WebP: ": _vp8l_damaged(),
        "corrupt WebP: bad ALPH header|truncated WebP: the raw alpha": _alph_damaged(),
        "corrupt WebP: an animation without frames": [
            _riff([(b"VP8X", b"\x02" + bytes(9)), (b"ANIM", bytes(6))])],
        "truncated WebP: no chunk after VP8X": [_riff([(b"VP8X", b"\x02" + bytes(9))])],
        "corrupt WebP: reserved VP8X flags": [_reserved_flag()],
        "corrupt WebP: ANMF before ANIM": [_riff([(b"VP8X", b"\x02" + bytes(9)),
                                                  (b"ANMF", bytes(16))])],
        "not a WebP file|unsupported image format": [b"RIFF\x10\x00\x00\x00WAVEfmt "],
    }
    for match, blobs in cases.items():
        for data in blobs:
            with pytest.raises(ValueError, match=match):
                codec.decode(data)
            with pytest.raises(Exception):  # noqa: B017 - Pillow refuses it too
                _pil(data)


def _reserved_flag() -> bytes:
    data = bytearray(_save(Image.fromarray(scene(8, 8)), "WEBP", quality=80, exif=_exif(1)))
    assert data[12:16] == b"VP8X"
    data[20] |= 0x01
    return bytes(data)


def _set_bmp(data: bytes, offset: int, value: bytes) -> bytes:
    return data[:offset] + value + data[offset + len(value):]


def _gif_codes(codes, min_code: int = 8) -> bytes:
    """A 4x4 GIF whose LZW stream is a clear code then ``codes``, 9 bits each."""
    acc, nbits, out = 0, 0, bytearray()
    for code in [1 << min_code] + list(codes):
        acc |= code << nbits
        nbits += 9
    while nbits > 0:
        out.append(acc & 255)
        acc >>= 8
        nbits -= 8
    head = b"GIF89a" + struct.pack("<HHBBB", 4, 4, 0x87, 0, 0) + bytes(768)
    return (head + b"," + struct.pack("<HHHHB", 0, 0, 4, 4, 0) + bytes([min_code])
            + bytes([len(out)]) + bytes(out) + b"\x00;")


def _gif_min_code(n: int) -> bytes:
    data = bytearray(gif_file(np.zeros((4, 4), np.int64), np.zeros((2, 3), np.int64)))
    i = data.index(b",") + 10
    data[i] = n
    return bytes(data)


def _vp8_data() -> bytearray:
    return bytearray(_save(Image.fromarray(scene(16, 16)), "WEBP", quality=80))


def _vp8_not_key() -> bytes:
    data = _vp8_data()
    data[20] |= 1
    return bytes(data)


def _vp8_bad_start() -> bytes:
    data = _vp8_data()
    data[23] = 0
    return bytes(data)


def _vp8l_damaged() -> list:
    """A lossless file with bytes of its entropy-coded data flipped, kept
    where Pillow refuses the result."""
    base = _save(Image.fromarray(_noise(16, 16)), "WEBP", lossless=True)
    out = []
    for pos in range(25, len(base), 7):
        data = bytearray(base)
        data[pos] ^= 0xA5
        try:
            _pil(bytes(data))
        except Exception:  # noqa: BLE001
            out.append(bytes(data))
    assert len(out) >= 3
    return out


def _alph_damaged() -> list:
    rgba = np.concatenate([scene(16, 16), _noise(16, 16, 1)], -1)
    chunks = _chunks(_save(Image.fromarray(rgba, "RGBA"), "WEBP", quality=80))
    bad_header = [(t, bytes([d[0] | 0xC0]) + d[1:]) if t == b"ALPH" else (t, d)
                  for t, d in chunks]
    raw_short = [(t, b"\x00" + bytes(10)) if t == b"ALPH" else (t, d) for t, d in chunks]
    return [_riff(bad_header), _riff(raw_short)]


# ---------------------------------------------------------------------------
# The JAX path and the committed fixtures
# ---------------------------------------------------------------------------


def test_jax_bytes_to_pil_gives_the_same_arrays():
    """The JAX package's ``core/imaging.py::bytes_to_pil``, the reference the
    port is held to, on one file of each new kind."""
    for fmt, blobs in _formats().items():
        for data in blobs:
            np.testing.assert_array_equal(codec.decode(data),
                                          np.asarray(jimaging.bytes_to_pil(data)), err_msg=fmt)
    data = _save(Image.fromarray(scene(10, 14)), "WEBP", quality=80, exif=_exif(6))
    np.testing.assert_array_equal(codec.decode(data), np.asarray(jimaging.bytes_to_pil(data)))


def test_manifest_covers_each_new_kind():
    import json

    root = os.path.join(os.path.dirname(__file__), "fixtures", "codec")
    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    for name in ("cmyk.jpg", "ycck.jpg", "rgb_coded.jpg", "pal8.bmp", "rgb24.bmp", "rle8.bmp",
                 "interlaced.gif", "lossy.webp", "lossy_alpha.webp", "lossless.webp"):
        assert name in manifest, name
        with open(os.path.join(root, name), "rb") as f:
            data = f.read()
        _same(data)


def test_chip_script_inputs_match_pillow(monkeypatch):
    """The files ``chip_smoke.py`` writes without Pillow on the card's host
    (4-component JPEGs from the port's own gray scans, BMP, RLE8 BMP, GIF,
    and each rare format of ``rare_decode_set``) and the committed 1024²
    WebP files decode as Pillow decodes them, and the sources it holds them
    to are Pillow's pixels (the shapes it holds the others to, theirs)."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DECODE_SIZE", 80)
    rows = chip_smoke.decode_set()
    assert set(chip_smoke.rare_decode_set(8)) <= set(rows)
    for name, (data, want) in rows.items():
        got = _same(data)
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif want is not None:
            assert got.shape == want, name
    rgb = scene(37, 29, 3)
    for transform in (0, 2):
        _same(chip_smoke.cmyk_jpeg([rgb[..., 0], rgb[..., 1], rgb[..., 2], rgb[..., 1] // 4],
                                   transform))


@pytest.mark.parametrize("name", codec.SOURCES + codec.HEADERS)
def test_library_hash_covers_every_source(name, tmp_path, monkeypatch):
    """Each decoder's source (and the header they share) is part of the
    built library's name, so an edit to any of them rebuilds it."""
    import shutil

    for f in codec.SOURCES + codec.HEADERS:
        shutil.copy(codec.SOURCE_DIR / f, tmp_path / f)
    monkeypatch.setattr(codec, "SOURCE_DIR", tmp_path)
    before = codec.library_path()
    with open(tmp_path / name, "a") as f:
        f.write("\n// edited\n")
    assert codec.library_path() != before


def test_image_chunk_reads_its_pad_byte():
    """libwebp hands the VP8 and VP8L decoders an image chunk with its pad
    byte: a stream one byte short of an even payload, whose last bits then
    come from the (zero) pad, decodes as Pillow decodes it."""
    decoded = 0
    for seed in range(12):
        arr = _noise(9 + seed, 13, seed=seed)
        for kw in (dict(lossless=True), dict(quality=90)):
            chunks = _chunks(_save(Image.fromarray(arr), "WEBP", **kw))
            tag, payload = chunks[0]
            if len(payload) % 2:
                continue
            data = _riff([(tag, payload[:-1])])  # odd: _riff adds the zero pad byte
            try:
                want = _pil(data)
            except Exception:  # noqa: BLE001 - Pillow refuses it: so must the port
                with pytest.raises(ValueError, match="WebP"):
                    codec.decode(data)
                continue
            np.testing.assert_array_equal(codec.decode(data), want)
            decoded += 1
    assert decoded >= 3


def test_bmp_last_row_needs_no_padding():
    """Pillow's raw decoder reads a row's pixels and then its padding up to
    the stride: a file cut inside the last row's padding still decodes."""
    idx = np.random.default_rng(4).integers(0, 256, (5, 30))
    pal = np.random.default_rng(5).integers(0, 256, (256, 3))
    data = bmp_file(idx, 8, 40, pal, top_down=True)  # rows of 30 bytes in 32
    for cut in (1, 2, 3):
        part = data[:-cut]
        try:
            want = _pil(part)
        except Exception:  # noqa: BLE001 - Pillow refuses it: so must the port
            with pytest.raises(ValueError, match="truncated BMP"):
                codec.decode(part)
            continue
        np.testing.assert_array_equal(codec.decode(part), want)


def _tiff(entries, big_endian: bool = False) -> bytes:
    """A TIFF-structured EXIF block: IFD0 at 8 with ``entries`` (tag, type,
    count, 4-byte field), then any out-of-line data the fields point at
    (given as bytes, placed after the IFD)."""
    e = ">" if big_endian else "<"
    ifd_end = 8 + 2 + 12 * len(entries) + 4
    out, extra = bytearray(), bytearray()
    for tag, typ, count, field in entries:
        if isinstance(field, bytes) and len(field) > 4:
            out += struct.pack(e + "HHLL", tag, typ, count, ifd_end + len(extra))
            extra += field
        else:
            out += struct.pack(e + "HHL", tag, typ, count) + bytes(field).ljust(4, b"\x00")
    head = (b"MM\x00\x2a" if big_endian else b"II\x2a\x00") + struct.pack(e + "L", 8)
    return head + struct.pack(e + "H", len(entries)) + bytes(out) + bytes(4) + bytes(extra)


EXIF_CASES = {
    "short": _tiff([(0x0112, 3, 1, struct.pack("<H", 6))]),
    "short_big_endian": _tiff([(0x0112, 3, 1, struct.pack(">H", 8))], big_endian=True),
    "short_count_2": _tiff([(0x0112, 3, 2, struct.pack("<HH", 5, 7))]),
    "count_0": _tiff([(0x0112, 3, 0, b"")]),
    "unknown_type": _tiff([(0x0112, 99, 1, struct.pack("<H", 6))]),
    "long": _tiff([(0x0112, 4, 1, struct.pack("<L", 3))]),
    "signed_short": _tiff([(0x0112, 8, 1, struct.pack("<h", 2))]),
    "rational": _tiff([(0x0112, 5, 1, struct.pack("<LL", 12, 2))]),
    "rational_zero": _tiff([(0x0112, 5, 1, struct.pack("<LL", 6, 0))]),
    "float": _tiff([(0x0112, 11, 1, struct.pack("<f", 6.0))]),
    "byte": _tiff([(0x0112, 1, 1, b"\x06")]),
    "value_9": _tiff([(0x0112, 3, 1, struct.pack("<H", 9))]),
    "duplicate": _tiff([(0x0112, 3, 1, struct.pack("<H", 6)), (0x0112, 3, 1, struct.pack("<H", 8))]),
    "data_past_the_end": _tiff([(0x0112, 3, 3, struct.pack("<L", 4000))]),
    "prefixed_twice": b"Exif\x00\x00" + _tiff([(0x0112, 3, 1, struct.pack("<H", 5))]),
    "bad_header": b"IX*\x00\x08\x00\x00\x00" + bytes(10),
    "short_header": b"II*\x00\x08",
}


def _with_exif(fmt: str, tiff: bytes, xmp: bytes, dpi: bool = False) -> bytes:
    """A file of ``fmt`` carrying ``tiff`` as its EXIF block and ``xmp``
    (orientation 3) as its XMP packet, spliced in by hand."""
    arr = scene(10, 14, 6)
    if fmt == "WEBP":
        chunks = _chunks(_save(Image.fromarray(arr), "WEBP", quality=80))
        vp8x = bytes([0x0C, 0, 0, 0]) + struct.pack("<I", 13)[:3] + struct.pack("<I", 9)[:3]
        return _riff([(b"VP8X", vp8x)] + chunks + [(b"EXIF", tiff), (b"XMP ", xmp)])
    if fmt == "PNG":
        info = PngImagePlugin.PngInfo()
        info.add_itxt("XML:com.adobe.xmp", xmp.decode())
        data = _save(Image.fromarray(arr), "PNG", pnginfo=info)
        i = data.index(b"IDAT") - 4
        body = b"eXIf" + tiff
        chunk = struct.pack(">I", len(tiff)) + body + struct.pack(">I", zlib_crc(body))
        return data[:i] + chunk + data[i:]
    data = _save(Image.fromarray(arr), "JPEG", quality=90, xmp=xmp, **({"dpi": (96, 96)} if dpi else {}))
    app1 = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + data[2:]


def zlib_crc(data: bytes) -> int:
    import zlib

    return zlib.crc32(data) & 0xFFFFFFFF


@pytest.mark.parametrize("fmt", ["WEBP", "PNG", "JPEG", "JPEG_dpi"])
@pytest.mark.parametrize("case", sorted(EXIF_CASES))
def test_exif_blocks_read_as_pillow_reads_them(case, fmt):
    """Orientation from EXIF blocks Pillow's ``Image.Exif`` reads its own
    way: a count above one (its first value), none or an unknown type (absent:
    the XMP's orientation), LONG, signed, rational and float values, a BYTE
    (present, no transpose), the last of two entries, out-of-line data past
    the block (the directory ends), a doubled ``Exif`` prefix; and headers it
    cannot read, which fail the file except in a JPEG without a JFIF density
    (Pillow reads that EXIF while opening, for its dpi, and keeps nothing)."""
    xmp = b'<x:xmpmeta><rdf:Description tiff:Orientation="3"/></x:xmpmeta>'
    data = _with_exif(fmt.split("_")[0], EXIF_CASES[case], xmp, dpi=fmt == "JPEG_dpi")
    try:
        want = _pil(data)
    except Exception:  # noqa: BLE001 - Pillow refuses it: so must the port
        with pytest.raises(ValueError, match="corrupt EXIF"):
            codec.decode(data)
        return
    np.testing.assert_array_equal(codec.decode(data), want)


def test_png_chunks_are_checked_up_to_the_image_data():
    """Pillow checks the CRC and the type of every chunk before IDAT and
    stops reading at a malformed chunk after it."""
    data = _save(Image.fromarray(scene(9, 11, 2)), "PNG")
    ihdr_crc = data.index(b"IHDR") + 4 + 13
    bad_crc = data[:ihdr_crc] + bytes([data[ihdr_crc] ^ 1]) + data[ihdr_crc + 1:]
    bad_type = data[:12] + b"IH?R" + data[16:]
    for blob, match in ((bad_crc, "bad CRC in the IHDR"), (bad_type, "chunk type")):
        with pytest.raises(Exception):  # noqa: B017 - Pillow refuses it
            _pil(blob)
        with pytest.raises(ValueError, match=match):
            codec.decode(blob)
    xmp = '<x:xmpmeta><rdf:Description tiff:Orientation="6"/></x:xmpmeta>'
    info = PngImagePlugin.PngInfo()
    info.add_itxt("XML:com.adobe.xmp", xmp)
    tail = _save(Image.fromarray(scene(9, 11, 2)), "PNG", pnginfo=info)
    # the text chunk moved after IDAT, behind a chunk whose type is malformed
    i, j = tail.index(b"iTXt") - 4, tail.index(b"IDAT") - 4
    text = tail[i:j]
    end = tail.index(b"IEND") - 4
    broken = b"\x00\x00\x00\x00b?d!" + struct.pack(">I", zlib_crc(b"b?d!"))
    for blob in (tail[:i] + tail[j:end] + text + tail[end:],
                 tail[:i] + tail[j:end] + broken + text + tail[end:]):
        _same(blob)
