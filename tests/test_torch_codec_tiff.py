"""The port's TIFF decoder (``core/codec.py`` over ``csrc/host/tiff.cc``)
against Pillow, which the JAX package's ``core/imaging.py`` opens every
upload with (``Image.open`` → ``ImageOps.exif_transpose`` → ``convert("RGB")``;
Pillow reads an uncompressed TIFF itself and a compressed one through
libtiff).

Every case must equal Pillow's bytes exactly: each compression the port
decodes (none, PackBits, LZW, Deflate, LZMA, ZSTD, JPEG, CCITT RLE, Group 3
1-D and 2-D, Group 4), big- and little-endian, BigTIFF, strips and padded tiles,
planar configuration 2, Predictor 2, FillOrder 2, every photometric and
depth of Pillow's OPEN_INFO (CIELab's conversion in
``tests/test_torch_codec_lab.py``), a multi-page file's first page and
orientations 1-8 from the tag or an XMP packet. Files come from
``scripts/codec_fixtures.py``'s writers where Pillow writes no such file.
What the port refuses raises a ``ValueError`` naming the format and the
feature: on bytes Pillow refuses too, or, where Pillow decodes them, as a
feature ROADMAP.md lists as not yet ported. Damaged files decode as libtiff
decodes them for Pillow, or both raise: an LZMA strip damaged in its data,
Deflate and LZMA YCbCr strips, a likely invalid YCbCr tile byte count, JPEG
frames smaller than their strips or tiles, damaged CCITT strips, damaged
and cut ZSTD strips, byte counts of 0, past the file's end or over 1 MiB
(which libtiff cuts) and directories libtiff reads apart from Pillow, each
pinned by cases here, and differential fuzzes of the fixtures with every
disagreement counted.
"""

import base64
import functools
import io
import json
import os
import struct
import sys
import tracemalloc
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image, ImageOps

from qwen_image_edit_streamdiffusion_tpu.core import imaging as jimaging
from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
from codec_fixtures import (fax_encode, jpeg_frames, packbits, pil_rgb_c_idct,  # noqa: E402
                            scene, tiff_cut, tiff_damaged, tiff_entries, tiff_file, tiff_lzw,
                            tiff_set_entry, tiff_strips, zstd_compress)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "codec")


def _pil(data: bytes) -> np.ndarray:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return np.asarray(ImageOps.exif_transpose(Image.open(io.BytesIO(data))).convert("RGB"))


def _same(data: bytes) -> np.ndarray:
    got, want = codec.decode(data), _pil(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def _pil_save(im: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "TIFF", **kw)
    return buf.getvalue()


RGB = scene(37, 53, 3)
RNG = np.random.default_rng(5)
# bilevel rows that take every 2-D mode: pass, horizontal, vertical -3..3
BW = ((scene(41, 77, 4)[..., 0].astype(int) + RNG.integers(-60, 60, (41, 77))) > 128).astype(
    np.uint8)
BW[5] = 1
BW[7] = RNG.integers(0, 2, BW.shape[1])

COMPRESSIONS = {
    "none": dict(compression=1),
    "lzw": dict(compression=5),
    "lzw-predictor": dict(compression=5, predictor=2),
    "deflate": dict(compression=8),
    "adobe-deflate-predictor": dict(compression=32946, predictor=2),
    "packbits": dict(compression=32773, rows_per_strip=5),
    "lzma": dict(compression=34925),
    "lzw-fillorder2": dict(compression=5, fill_order=2),
    "deflate-fillorder2": dict(compression=8, fill_order=2),
    "packbits-fillorder2": dict(compression=32773, fill_order=2),
    "none-fillorder2": dict(compression=1, fill_order=2),
    "zstd": dict(compression=50000),
    "zstd-predictor": dict(compression=50000, predictor=2, rows_per_strip=9),
    "zstd-fillorder2": dict(compression=50000, fill_order=2),
}


@pytest.mark.parametrize("kw", COMPRESSIONS.values(), ids=COMPRESSIONS.keys())
def test_compression_matches_pillow(kw):
    _same(tiff_file(RGB, 2, 8, **kw))


LAYOUTS = {
    "big-endian": dict(big_endian=True, compression=5, predictor=2),
    "bigtiff": dict(bigtiff=True, compression=8),
    "bigtiff-none": dict(bigtiff=True),
    "tiles-padded": dict(tile=(16, 16), compression=5),
    "tiles-none": dict(tile=(32, 16)),
    "tiles-planar-predictor": dict(tile=(16, 16), planar=2, compression=8, predictor=2),
    "planar-lzw": dict(planar=2, compression=5),
    "planar-none": dict(planar=2, rows_per_strip=7),
    "partial-last-strip": dict(rows_per_strip=10, compression=32773),
    "one-row-strips": dict(rows_per_strip=1, compression=5),
    "tiles-planar-zstd-predictor": dict(tile=(16, 16), planar=2, compression=50000,
                                        predictor=2),
}


@pytest.mark.parametrize("kw", LAYOUTS.values(), ids=LAYOUTS.keys())
def test_layout_matches_pillow(kw):
    _same(tiff_file(RGB, 2, 8, **kw))


def _photometric_cases() -> dict:
    g = RGB[..., 0]
    rgba = np.concatenate([RGB, RNG.integers(0, 256, RGB.shape[:2] + (1,), np.uint8)], -1)
    r16 = RGB.astype(np.uint16) * 257 + RNG.integers(0, 256, RGB.shape, np.uint16)
    a16 = np.concatenate([r16, RNG.integers(0, 65536, RGB.shape[:2] + (1,), np.uint16)], -1)
    g16 = g.astype(np.uint16) * 3
    g16[0, :4] = [0, 255, 256, 65535]
    f32 = g.astype(np.float32) * np.float32(1.5) - np.float32(40.5)
    f32[0, :4] = [-3.5, 0.5, 254.9, 300.0]
    cmap = RNG.integers(0, 65536, (256, 3))
    idx = RNG.integers(0, 256, g.shape, np.uint8)
    cases = {}
    for photo in (0, 1):
        for bits in (1, 2, 4, 8):
            cases[f"gray{bits}-photometric{photo}"] = (g >> (8 - bits), photo, bits, dict(
                compression=5))
        cases[f"gray16-photometric{photo}"] = (g16, photo, 16, dict(compression=8))
    cases.update({
        "gray16-big-endian": (g16, 1, 16, dict(big_endian=True, compression=5, predictor=2)),
        "gray16-signed": (g16, 1, 16, dict(sample_format=2)),
        "gray32-uint": (g.astype(np.uint32) * 70000 + np.uint32(2 ** 31), 1, 32,
                        dict(compression=8)),
        "gray32-int-be": (g.astype(np.int32) - 60, 1, 32, dict(sample_format=2, big_endian=True)),
        "float32": (f32, 1, 32, dict(sample_format=3, compression=5, predictor=2)),
        "float32-min-is-white": (f32, 0, 32, dict(sample_format=3)),
        "gray-alpha": (rgba[..., [0, 3]], 1, 8, dict(extra=(2,), compression=5)),
        "rgb16": (r16, 2, 16, dict(compression=5, predictor=2)),
        "rgb16-big-endian": (r16, 2, 16, dict(big_endian=True)),
        "palette8": (idx, 3, 8, dict(colormap=cmap, compression=5)),
        "palette-alpha": (np.stack([idx, idx // 2], -1), 3, 8, dict(
            colormap=cmap, extra=(2,), compression=8)),
        "cmyk": (rgba, 5, 8, dict(compression=5)),
        "cmyk16": (a16, 5, 16, dict(compression=8)),
        "cmyk-planar": (rgba, 5, 8, dict(planar=2, compression=32773)),
        "ycbcr-one-sample-jpeg": (g, 6, 8, dict(compression=1)),
    })
    for bits in (1, 2, 4):
        cases[f"palette{bits}"] = (idx >> (8 - bits), 3, bits, dict(
            colormap=cmap[:1 << bits], compression=32773))
    for extra in ((), (0,), (1,), (2,), (0, 0), (1, 0), (2, 0)):
        px = np.concatenate([rgba] + [rgba[..., :1]] * (len(extra) - 1), -1) if extra else rgba
        name = "".join(map(str, extra)) or "none"
        cases[f"rgba-extra-{name}"] = (px, 2, 8, dict(extra=extra, compression=5))
        if len(extra) == 1:
            cases[f"rgba16-extra-{name}"] = (a16, 2, 16, dict(extra=extra, compression=8))
    for extra in ((), (1,), (2,)):
        name = "".join(map(str, extra)) or "none"
        cases[f"rgba-planar-extra-{name}"] = (rgba, 2, 8, dict(extra=extra, planar=2,
                                                                compression=8))
    ycc = np.concatenate([RGB[..., :1], RGB[..., 1:] // 2 + 64], -1)
    for sub in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2)):
        cases[f"ycbcr-{sub[0]}x{sub[1]}"] = (ycc, 6, 8, dict(
            compression=5, rows_per_strip=8, ycbcr_subsampling=sub))
    cases["ycbcr-reference-black-white"] = (ycc, 6, 8, dict(
        compression=8, ycbcr_subsampling=(2, 1), tags={532: (5, [(16, 1), (235, 1), (128, 1),
                                                                 (240, 1), (128, 1), (240, 1)])}))
    cases["ycbcr-coefficients"] = (ycc, 6, 8, dict(
        compression=8, ycbcr_subsampling=(1, 1), tags={529: (5, [(2126, 10000), (7152, 10000),
                                                                 (722, 10000)])}))
    cases["ycbcr-tiles"] = (ycc, 6, 8, dict(compression=5, tile=(16, 16),
                                            ycbcr_subsampling=(2, 2)))
    cases["ycbcr-uncompressed-rgbx"] = (ycc[:1, :4], 6, 8, dict(ycbcr_subsampling=(1, 1)))
    return cases


PHOTOMETRICS = _photometric_cases()


@pytest.mark.parametrize("case", PHOTOMETRICS.values(), ids=PHOTOMETRICS.keys())
def test_photometric_and_depth_match_pillow(case):
    """Each row of Pillow's OPEN_INFO the port decodes, and its
    ``convert("RGB")``: 16-bit gray clipped at 255, float truncated, 16-bit
    colour's high byte, premultiplied alpha divided out, CMYK not inverted,
    YCbCr through libtiff's RGBA reader's fixed point (an uncompressed one
    read as Pillow's raw decoder reads it, as RGBX)."""
    px, photo, bits, kw = case
    _same(tiff_file(px, photo, bits, **kw))


def _jpeg_strip(block):
    return codec.encode_jpeg(np.ascontiguousarray(block), 90)


JPEG_CASES = {
    "pillow-rgb": lambda: _pil_save(Image.fromarray(RGB), compression="jpeg", quality=80),
    "pillow-gray": lambda: _pil_save(Image.fromarray(RGB[..., 0]), compression="jpeg"),
    "pillow-large": lambda: _pil_save(Image.fromarray(scene(150, 211, 6)), compression="jpeg"),
    "ycbcr-strips": lambda: tiff_file(RGB, 6, 8, compression=7, rows_per_strip=16,
                                      ycbcr_subsampling=(2, 2), jpeg=_jpeg_strip),
    "ycbcr-tiles": lambda: tiff_file(RGB, 6, 8, compression=7, tile=(32, 16),
                                     ycbcr_subsampling=(2, 2), jpeg=_jpeg_strip),
    "gray-strips": lambda: tiff_file(RGB[..., 0], 1, 8, compression=7, rows_per_strip=8,
                                     jpeg=lambda b: _jpeg_strip(b[..., 0])),
}


@pytest.mark.parametrize("make", JPEG_CASES.values(), ids=JPEG_CASES.keys())
def test_jpeg_compressed_matches_pillow(make):
    """JPEG (7): each strip or tile its own stream after the JPEGTables
    tables, YCbCr converted to RGB as libtiff's JPEGCOLORMODE_RGB asks of
    libjpeg, at the strip's or tile's own edges."""
    _same(make())


CCITT = [(2, None), (3, 0), (3, 1), (3, 4), (3, 5), (4, 0)]


@pytest.mark.parametrize("fill", [1, 2], ids=["msb", "lsb"])
@pytest.mark.parametrize("photo", [0, 1], ids=["min-is-white", "min-is-black"])
@pytest.mark.parametrize("comp,t4", CCITT, ids=[f"c{c}-t4_{t}" for c, t in CCITT])
def test_ccitt_matches_pillow(comp, t4, photo, fill):
    _same(tiff_file(BW, photo, 1, compression=comp, t4options=t4, rows_per_strip=16,
                    fill_order=fill))


@pytest.mark.parametrize("name", ["group3", "group4", "tiff_ccitt", "packbits", "tiff_lzw",
                                  "tiff_deflate", "tiff_adobe_deflate", "lzma", "jpeg", "raw",
                                  "zstd"])
def test_pillow_written_matches_pillow(name):
    """Files libtiff writes (through Pillow), bilevel and RGB."""
    if name in ("group3", "group4", "tiff_ccitt"):
        im = Image.fromarray(BW * 255).convert("1")
    else:
        im = Image.fromarray(scene(45, 67, 7))
    _same(_pil_save(im, compression=name))


@pytest.mark.parametrize("mode", ["L", "P", "RGBA", "CMYK", "I;16", "I", "F", "LA", "1"])
def test_pillow_modes_match_pillow(mode):
    rgb = scene(30, 41, 8)
    gray = rgb[..., 0].astype(np.uint16) * 3
    im = {"I;16": lambda: Image.fromarray(gray),
          "I": lambda: Image.fromarray(gray.astype(np.int32) - 100),
          "F": lambda: Image.fromarray(gray.astype(np.float32) * np.float32(0.7))}.get(
        mode, lambda: Image.fromarray(rgb).convert(mode))()
    for kw in ({}, {"compression": "tiff_lzw"}):
        _same(_pil_save(im, **kw))


def test_pillow_ycbcr_matches_pillow():
    """Pillow writes YCbCr uncompressed, and reads it back as RGBX: four
    bytes a pixel from its strip on, past the end of the file here, so both
    refuse it; compressed, libtiff's RGBA reader converts it."""
    im = Image.fromarray(scene(30, 41, 8)).convert("YCbCr")
    _both_raise(_pil_save(im), "truncated TIFF")
    _same(_pil_save(im, compression="tiff_lzw"))


def test_multipage_decodes_its_first_page():
    pages = [Image.fromarray(scene(20, 30, i)) for i in range(3)]
    buf = io.BytesIO()
    pages[0].save(buf, "TIFF", save_all=True, append_images=pages[1:], compression="tiff_lzw")
    np.testing.assert_array_equal(_same(buf.getvalue()), np.asarray(pages[0]))


@pytest.mark.parametrize("source", ["tag", "xmp"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_applied_once(orientation, source):
    """The Orientation tag (else XMP's tiff:Orientation), applied once, as
    Pillow's TIFF load_end and the later exif_transpose leave it."""
    kw = {"orientation": orientation} if source == "tag" else {
        "xmp": b'<x:xmpmeta><rdf:Description tiff:Orientation="%d"/></x:xmpmeta>' % orientation}
    _same(tiff_file(RGB, 2, 8, compression=5, **kw))


def _with_tag(data: bytes, tag: int, value: int) -> bytes:
    """A little-endian classic TIFF with one SHORT/LONG entry's value set."""
    (pos,) = struct.unpack_from("<L", data, 4)
    (n,) = struct.unpack_from("<H", data, pos)
    out = bytearray(data)
    for i in range(n):
        at = pos + 2 + 12 * i
        t, typ = struct.unpack_from("<HH", data, at)
        if t == tag:
            struct.pack_into("<H" if typ == 3 else "<L", out, at + 8, value)
            return bytes(out)
    raise KeyError(tag)


def _both_raise(data: bytes, match: str) -> None:
    with pytest.raises(ValueError, match=match):
        codec.decode(data)
    with pytest.raises(Exception):
        _pil(data)


REFUSED_BOTH = {
    "old-style-jpeg": (lambda: _with_tag(tiff_file(RGB, 2, 8), 259, 6), "old-style JPEG"),
    "next": (lambda: _with_tag(tiff_file(RGB, 2, 8), 259, 32766), "NeXT"),
    "pixarlog": (lambda: _with_tag(tiff_file(RGB, 2, 8), 259, 32909), "PixarLog"),
    "jbig": (lambda: _with_tag(tiff_file(RGB, 2, 8), 259, 34661), "JBIG"),
    "webp": (lambda: _with_tag(tiff_file(RGB, 2, 8), 259, 50001), "WebP"),
    "sglog": (lambda: _with_tag(tiff_file(RGB, 2, 8), 259, 34676), "SGILog"),
    "unknown-mode": (lambda: tiff_file(RGB[..., :2], 2, 8), "Pillow has no mode"),
    "big-endian-bigtiff": (lambda: tiff_file(RGB, 2, 8, bigtiff=True, big_endian=True),
                           "TIFF"),
    "planar-unused-extra": (lambda: tiff_file(np.concatenate([RGB, RGB[..., :1]], -1), 2, 8,
                                              extra=(0,), planar=2, compression=5),
                            "unused extra sample"),
    "truncated-strip": (lambda: tiff_file(RGB, 2, 8, compression=5)[:300], "truncated TIFF"),
    "truncated-raw": (lambda: _truncated_raw(), "truncated TIFF"),
    # Pillow reads an uncompressed YCbCr file as RGBX: four bytes a pixel,
    # past the end of the file
    "ycbcr-uncompressed": (lambda: tiff_file(RGB, 6, 8, ycbcr_subsampling=(1, 1)),
                           "truncated TIFF"),
    "lzw-short": (lambda: _short_strip(5), "LZW"),
    "packbits-short": (lambda: _short_strip(32773), "PackBits"),
    "deflate-short": (lambda: _short_strip(8), "Deflate"),
    "jpeg-rgb-subsampled": (lambda: tiff_file(RGB, 2, 8, compression=7, rows_per_strip=16,
                                              jpeg=_jpeg_strip), "sampling factors"),
    "jpeg-taller-strip": (lambda: _taller_first_strip(), "JPEG in a"),
    "lzw-no-clear-code": (lambda: _lzw_without_clear_code(2), "clear code"),
    "rows-per-strip-0": (lambda: _with_tag(tiff_file(RGB, 2, 8, compression=5, rows_per_strip=8),
                                           278, 0), "RowsPerStrip 0"),
    "raw-rows-per-strip-0": (lambda: _with_tag(tiff_file(RGB, 2, 8, rows_per_strip=8), 278, 0),
                             "RowsPerStrip 0"),
    "rows-per-strip-2**31": (lambda: _with_tag(tiff_file(RGB, 2, 8, compression=5), 278,
                                               2 ** 31), "RowsPerStrip"),
    # Pillow's RGBA decoder sizes its buffer by RowsPerStrip x width x 4
    "ycbcr-rows-per-block": (lambda: _with_tag(_ycbcr_strips(), 278,
                                               (2 ** 31 - 1) // 4 // RGB.shape[1] + 1),
                             "RGBA decoder"),
}


def _truncated_raw() -> bytes:
    data = tiff_file(RGB, 2, 8)
    (ifd,) = struct.unpack_from("<L", data, 4)
    return data[:8] + data[ifd:]  # the directory, with the strip gone


def _ycbcr_strips() -> bytes:
    return tiff_file(RGB, 6, 8, compression=5, ycbcr_subsampling=(2, 2), rows_per_strip=8)


def _lzw_without_clear_code(photometric: int) -> bytes:
    """An LZW file of strips of 8 rows whose first strip lacks its leading
    clear code (libtiff refuses every code before one)."""
    data = _ycbcr_strips() if photometric == 6 else tiff_file(RGB, 2, 8, compression=5,
                                                               rows_per_strip=8)
    layout = codec._Tiff(data).layout()
    off, cnt = layout[5][0], layout[6][0]
    bits = "".join(f"{b:08b}" for b in data[off:off + cnt])[9:] + "0" * 9
    strip = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    return data[:off] + strip + data[off + cnt:]


def test_ycbcr_strip_without_clear_code_matches_pillow():
    """libtiff's RGBA reader converts a YCbCr strip it could not decode as
    zeros; the port's tolerant LZW gives the same pixels."""
    _same(_lzw_without_clear_code(6))


def _short_strip(comp: int) -> bytes:
    """A strip whose data decompresses to half the strip's bytes."""
    half = RGB[:RGB.shape[0] // 2].tobytes()
    raw = {5: tiff_lzw, 32773: packbits, 8: lambda b: zlib.compress(b)}[comp](half)
    data = tiff_file(RGB, 2, 8, compression=comp)
    (ifd,) = struct.unpack_from("<L", data, 4)
    body = b"II*\x00" + struct.pack("<L", 8 + len(raw) + len(raw) % 2) + raw + b"\x00" * (
        len(raw) % 2)
    rest = data[ifd:]
    shift = len(body) - ifd
    out = bytearray(body + rest)
    (n,) = struct.unpack_from("<H", out, len(body))
    for i in range(n):  # the strip's offset and byte count, and the moved values
        at = len(body) + 2 + 12 * i
        tag, typ, count, val = struct.unpack_from("<HHLL", out, at)
        if tag == 273:
            struct.pack_into("<L", out, at + 8, 8)
        elif tag == 279:
            struct.pack_into("<L", out, at + 8, len(raw))
        elif count * {3: 2, 4: 4, 5: 8}.get(typ, 1) > 4:
            struct.pack_into("<L", out, at + 8, val + shift)
    return bytes(out)


def _taller_first_strip() -> bytes:
    """A JPEG strip whose frame is taller than its strip, and not the last:
    libtiff refuses it (a last strip's it cuts to size)."""
    data = tiff_file(RGB, 6, 8, compression=7, rows_per_strip=16, ycbcr_subsampling=(2, 2),
                     jpeg=_jpeg_strip)
    sof = data.index(b"\xff\xc0")
    return data[:sof + 5] + struct.pack(">H", 24) + data[sof + 7:]


def _taller_last_strip() -> bytes:
    data = tiff_file(RGB, 6, 8, compression=7, rows_per_strip=16, ycbcr_subsampling=(2, 2),
                     jpeg=_jpeg_strip)
    sof = data.rindex(b"\xff\xc0")
    return data[:sof + 5] + struct.pack(">H", 40) + data[sof + 7:]


def _cut_jpeg_strip() -> bytes:
    """A JPEG strip whose byte count stops halfway: libtiff's source manager
    supplies an EOI and the rest of the strip decodes gray."""
    data = tiff_file(RGB, 6, 8, compression=7, rows_per_strip=16, ycbcr_subsampling=(2, 2),
                     jpeg=_jpeg_strip)
    t = codec._Tiff(data)
    counts = t.seq(279)
    (ifd,) = struct.unpack_from("<L", data, 4)
    (n,) = struct.unpack_from("<H", data, ifd)
    out = bytearray(data)
    for k in range(n):
        at = ifd + 2 + 12 * k
        tag, typ, count, val = struct.unpack_from("<HHLL", data, at)
        if tag == 279:
            struct.pack_into("<L", out, val + 4, counts[1] // 2)
    return bytes(out)


@pytest.mark.parametrize("make", [_taller_last_strip, _cut_jpeg_strip],
                         ids=["taller-last-strip", "cut-strip"])
def test_jpeg_strip_edges_match_libtiff(make):
    """The last strip's taller JPEG frame is cut to the strip, and a strip's
    data that ends early reads a fake EOI: both as libtiff decodes them."""
    _same(make())


@pytest.mark.parametrize("case", REFUSED_BOTH.values(), ids=REFUSED_BOTH.keys())
def test_refusals_where_pillow_raises(case):
    make, match = case
    _both_raise(make(), match)


def _lab() -> bytes:
    return tiff_file(RGB, 8, 8)


REFUSED_PORT_ONLY = {
    # Pillow decodes these; the port refuses them by name, or, with no name,
    # decodes them since (tests/test_torch_codec_tiff_more.py, and CIELab
    # through LittleCMS's arithmetic: tests/test_torch_codec_lab.py)
    "thunderscan": (lambda: _with_tag(tiff_file(RGB[..., 0] >> 4, 1, 4), 259, 32809),
                    "ThunderScan"),
    "ccitt-rlew": (lambda: _with_tag(tiff_file(BW, 0, 1, compression=2), 259, 32771), None),
    "cielab": (_lab, None),
    "float-predictor": (lambda: tiff_file(RGB[..., 0].astype(np.float32), 1, 32, sample_format=3,
                                          compression=8, tags={317: (3, [3])}), None),
    "zstd-float-predictor": (lambda: tiff_file(RGB[..., 0].astype(np.float32), 1, 32,
                                               sample_format=3, compression=50000,
                                               tags={317: (3, [3])}), None),
    "ycbcr-rotated": (lambda: tiff_file(RGB, 6, 8, compression=5, ycbcr_subsampling=(1, 1),
                                        orientation=3), None),
    "ycbcr-4x4-odd": (lambda: tiff_file(RGB[:, :49], 6, 8, compression=5, rows_per_strip=8,
                                        ycbcr_subsampling=(4, 4)), None),
}


@pytest.mark.parametrize("case", REFUSED_PORT_ONLY.values(), ids=REFUSED_PORT_ONLY.keys())
def test_refusals_where_pillow_decodes_are_named(case):
    """The cases decoded since they were refused (CIELab among them) equal
    Pillow's pixels; the ThunderScan case (raw samples labelled 32809, more
    pixels than a row) fails in Pillow too, and in the port naming
    ThunderScan."""
    make, match = case
    if match is None:
        _same(make())
    elif match == "ThunderScan":
        _both_raise(make(), match)
    else:
        with pytest.raises(ValueError, match="unsupported TIFF: .*" + match):
            codec.decode(make())


def test_bomb_limit_before_allocating():
    """A header past Pillow's decompression-bomb limit raises before any
    strip is read or allocated."""
    data = tiff_file(np.zeros((1, 1, 3), np.uint8), 2, 8)
    big = _with_tag(_with_tag(data, 256, 20000), 257, 20000)
    tracemalloc.start()
    with pytest.raises(ValueError, match="decompression-bomb"):
        codec.decode(big)
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    assert peak < 1 << 20
    with pytest.raises(Exception):
        _pil(big)


def _huge_tiles(photometric: int, size: int, **kw) -> bytes:
    """A 16x16 LZW TIFF whose tiles are ``size`` x ``size`` (LONG fields)."""
    data = bytearray(tiff_file(np.zeros((16, 16, 3), np.uint8), photometric, 8, compression=5,
                               tile=(16, 16), **kw))
    (pos,) = struct.unpack_from("<L", data, 4)
    (n,) = struct.unpack_from("<H", data, pos)
    for k in range(n):
        at = pos + 2 + 12 * k
        (tag,) = struct.unpack_from("<H", data, at)
        if tag in (322, 323):
            struct.pack_into("<HHLL", data, at, tag, 4, 1, size)
    return bytes(data)


def _pil_raises_within(data: bytes, limit: int = 4 << 30) -> bool:
    """Whether Pillow raises on ``data``, opened in a process whose address
    space is held to ``limit`` bytes (a hostile file must not take the host's
    memory if Pillow were to allocate what it describes)."""
    import subprocess

    script = ("import io, resource, sys, warnings\n"
              f"resource.setrlimit(resource.RLIMIT_AS, ({limit}, {limit}))\n"
              "warnings.simplefilter('ignore')\n"
              "from PIL import Image, ImageOps\n"
              "d = sys.stdin.buffer.read()\n"
              "try:\n"
              "    ImageOps.exif_transpose(Image.open(io.BytesIO(d))).convert('RGB')\n"
              "except Exception:\n"
              "    sys.exit(3)\n")
    run = subprocess.run([sys.executable, "-c", script], input=data, capture_output=True)
    assert run.returncode in (0, 3), run.stderr.decode()
    return run.returncode == 3


HUGE_TILES = {
    # libtiff's RGBA reader refuses the tile ("Likely invalid tile byte count")
    "tile-ycbcr": lambda: _huge_tiles(6, 65536, ycbcr_subsampling=(2, 2)),
    # Pillow's tile decoder refuses a tile over 2**31 - 1 bytes
    "tile-rgb": lambda: _huge_tiles(2, 30000),
}


@pytest.mark.parametrize("comp", [5, 32773, 8, 34925, 50000, 4, *HUGE_TILES])
def test_strip_output_is_bounded(comp):
    """A 2x2 image whose strip holds the coding of 16 MiB: each decoder stops
    at the strip's bytes, as libtiff does, and the pixels are Pillow's. A
    16x16 image whose tiles are far past the decompression-bomb limit raises
    before a tile is allocated, where Pillow raises too."""
    if comp in HUGE_TILES:
        data = HUGE_TILES[comp]()
        tracemalloc.start()
        with pytest.raises(ValueError, match="tiles exceed the decompression-bomb limit"):
            codec.decode(data)
        peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
        assert peak < 12 << 20
        assert _pil_raises_within(data)
        return
    if comp == 4:
        rows = np.zeros((4096, 2), np.uint8)
        raw = fax_encode(rows, 4)
    else:
        zeros = bytes(16 << 20)
        raw = {5: tiff_lzw, 32773: packbits, 8: zlib.compress, 50000: zstd_compress,
               34925: lambda b: __import__("lzma").compress(b)}[comp](zeros) if comp != 5 else \
            tiff_lzw(zeros[:1 << 20])
    px = np.zeros((2, 2, 1 if comp == 4 else 3), np.uint8)
    data = tiff_file(px, 0 if comp == 4 else 2, 1 if comp == 4 else 8, compression=comp)
    small = {4: fax_encode(px[..., 0], 4), 5: tiff_lzw(px.tobytes()),
             32773: packbits(px.tobytes()), 8: zlib.compress(px.tobytes(), 9),
             50000: zstd_compress(px.tobytes()),
             34925: __import__("lzma").compress(px.tobytes(), check=0)}[comp]
    assert small in data
    i = data.index(small)
    (ifd,) = struct.unpack_from("<L", data, 4)
    grown = data[:i] + raw + data[i + len(small):]
    shift = len(raw) - len(small)
    out = bytearray(grown)
    struct.pack_into("<L", out, 4, ifd + shift)
    (n,) = struct.unpack_from("<H", out, ifd + shift)
    for k in range(n):
        at = ifd + shift + 2 + 12 * k
        tag, typ, count, val = struct.unpack_from("<HHLL", out, at)
        if tag == 279:
            struct.pack_into("<L", out, at + 8, len(raw))
        elif count * {3: 2, 4: 4, 5: 8}.get(typ, 1) > 4:
            struct.pack_into("<L", out, at + 8, val + shift)
    tracemalloc.start()
    got = codec.decode(bytes(out))
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    assert peak < 12 << 20  # the 16 MiB are never made (LZMA's 8 MiB dictionary is)
    np.testing.assert_array_equal(got, _pil(bytes(out)))


def test_jax_package_gives_the_same_arrays(tmp_path):
    """``codec.decode_base64`` of a TIFF equals the JAX package's
    ``core/imaging.base64_to_pil``; a manifest item naming ``.tif`` files
    loads through the port's ``EditDataset`` as through the JAX one."""
    from qwen_image_edit_streamdiffusion_tpu.training import data as jdata
    from qwen_image_edit_streamdiffusion_tpu_torch.training import data

    tif = tiff_file(RGB, 2, 8, compression=5, predictor=2, orientation=6)
    b64 = "data:image/tiff;base64," + base64.b64encode(tif).decode()
    np.testing.assert_array_equal(codec.decode_base64(b64),
                                  np.asarray(jimaging.base64_to_pil(b64)))
    (tmp_path / "in.tif").write_bytes(tif)
    (tmp_path / "out.tif").write_bytes(_pil_save(Image.fromarray(scene(37, 53, 9)),
                                                 compression="tiff_adobe_deflate"))
    manifest = tmp_path / "m.jsonl"
    manifest.write_text(json.dumps({"image": "in.tif", "target": "out.tif", "prompt": "p"}) + "\n")
    ours = data.EditDataset.from_manifest(str(manifest)).load(0)
    theirs = jdata.EditDataset.from_manifest(str(manifest)).load(0)
    for key in ("image", "target"):
        np.testing.assert_array_equal(ours[key], np.asarray(theirs[key]))


FUZZ_FIXTURES = ["lzw_pred.tif", "tiled_deflate_be.tif", "planar_packbits.tif",
                 "bigtiff_lzma.tif", "g4.tif", "g3_2d_fill2.tif", "ccitt_rle.tif",
                 "jpeg_ycbcr.tif", "palette4.tif", "minwhite.tif", "gray16_be.tif",
                 "float32.tif", "rgba_assoc.tif", "cmyk.tif", "ycbcr_lzw.tif", "multipage.tif",
                 "orient6.tif"]


def _fuzz(names, seed: int, count: int):
    """``count`` random edits (1 to 3 bytes each) of the fixtures ``names``,
    in turn, from ``seed``: [(fixture, edited bytes, edited positions)]."""
    rng = np.random.default_rng(seed)
    seeds = []
    for name in names:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            seeds.append(f.read())
    cases = []
    for it in range(count):
        d = bytearray(seeds[it % len(seeds)])
        at = []
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(0, len(d)))
            d[i] = int(rng.integers(0, 256))
            at.append(i)
        cases.append((names[it % len(seeds)], bytes(d), at))
    return cases


def _disagreements(cases, host_zstd: bool = True) -> list:
    """The cases whose port decode is not Pillow's: both raise, or their
    pixels are equal. Pillow decodes in a process where libjpeg-turbo runs
    its C code (``JSIMD_FORCENONE``), as the port does, and where realloc
    zeroes what it adds (bytes of Pillow's strip buffer that no strip wrote
    are the zeros a fresh buffer holds, not whatever the heap held)."""
    want = pil_rgb_c_idct([d for _, d, _ in cases], fresh_memory=True, host_zstd=host_zstd)
    disagree = []
    for (name, d, at), w in zip(cases, want):
        try:
            got = codec.decode(d)
        except ValueError:
            got = None
        if (w is None) != (got is None) or (w is not None and not np.array_equal(w, got)):
            disagree.append((name, at))
    return disagree


def test_differential_fuzz_against_pillow():
    """Random byte edits of every TIFF fixture: the port and Pillow both
    raise, or their pixels are equal, every disagreement counted (the strips,
    the codes and the directory, Pillow's reading and libtiff's)."""
    disagree = _disagreements(_fuzz(FUZZ_FIXTURES, 17, 2000))
    assert not disagree, f"edits {disagree} decode differently from Pillow"


def test_differential_fuzz_of_damaged_codes():
    """The same over fixtures whose damage the first fuzz reaches least: a
    YCbCr Deflate and a YCbCr LZMA file (libtiff's RGBA reader converts what
    a damaged strip decoded) and Group 3 2-D at fill order 1, 500 edits
    each."""
    disagree = _disagreements(_fuzz(["ycbcr_deflate.tif", "ycbcr_lzma.tif", "g3_2d.tif"], 19,
                                    1500))
    assert not disagree, f"edits {disagree} decode differently from Pillow"


# ---------------------------------------------------------------------------
# Damaged files of each kind libtiff decodes for Pillow its own way
# ---------------------------------------------------------------------------

_REFERENCE = {}


def _pillow(cases: dict) -> dict:
    """Pillow's pixels (None where it raises) of every case of ``cases``
    ({name: bytes}), decoded once in one process with fresh memory."""
    todo = [k for k in cases if k not in _REFERENCE]
    if todo:
        for k, w in zip(todo, pil_rgb_c_idct([cases[k] for k in todo], fresh_memory=True)):
            _REFERENCE[k] = w
    return {k: _REFERENCE[k] for k in cases}


def _held_to_pillow(cases: dict, name: str, decodes=None) -> None:
    """The port's pixels of ``cases[name]`` are Pillow's, or both raise;
    ``decodes``: whether Pillow must decode it (the kind the case shows)."""
    want = _pillow(cases)[name]
    if decodes is not None:
        assert (want is not None) == decodes
    if want is None:
        with pytest.raises(ValueError):
            codec.decode(cases[name])
    else:
        np.testing.assert_array_equal(codec.decode(cases[name]), want)


_SCENE = scene(40, 56, 13)
_YCC = np.concatenate([_SCENE[..., :1], _SCENE[..., 1:] // 2 + 64], -1)
_BW = (scene(40, 56, 15)[..., 0] > 128).astype(np.uint8)


def _lzma_cases() -> dict:
    base = tiff_file(_SCENE, 2, 8, compression=34925)
    (_, count), = tiff_strips(base)
    return {
        # the xz footer: liblzma's error comes after the strip is full
        "footer": tiff_damaged(base, 0, 1 - 8 / count, b"\x55"),
        # the last chunk's data: the strip fills with what it decodes first
        "data-end": tiff_damaged(base, 0, 1 - 40 / count, b"\x55"),
        # the middle: liblzma fails before the strip is full, and so does libtiff
        "data-middle": tiff_damaged(base, 0, 0.5, b"\x55"),
    }


LZMA_CASES = _lzma_cases()


@pytest.mark.parametrize("name,decodes", [("footer", True), ("data-end", True),
                                          ("data-middle", False)])
def test_lzma_strip_damaged_in_its_data(name, decodes):
    """libtiff's LZMADecode stops once the strip is full: an error liblzma
    reports in the call that filled it is never seen."""
    _held_to_pillow(LZMA_CASES, name, decodes)


def _zstd_cases() -> dict:
    base = tiff_file(_SCENE, 2, 8, compression=50000, rows_per_strip=20)
    return {
        # a block's data: libzstd fails before the strip is full
        "zstd-data-middle": tiff_damaged(base, 0, 0.5, b"\x55\xaa\x55"),
        # the strip's bytes end before its frame: "Not enough data"
        "zstd-cut": tiff_cut(base, 1),
        # a frame of 40 rows in a strip of 20 (ImageLength cut): decoding
        # stops once the strip is full
        "zstd-longer-frame": tiff_set_entry(tiff_file(_SCENE[:40], 2, 8, compression=50000),
                                            257, value=20),
        # the frame's magic damaged
        "zstd-magic": tiff_damaged(base, 0, 0.0, b"\x00"),
    }


ZSTD_CASES = _zstd_cases()


@pytest.mark.parametrize("name", ZSTD_CASES)
def test_damaged_zstd_strip_matches_libtiff(name):
    """tif_zstd.c's ZSTDDecode: an error from ZSTD_decompressStream fails
    the strip, and so does a strip its frame leaves short; a frame longer
    than the strip stops once the strip is full."""
    _held_to_pillow(ZSTD_CASES, name)


def test_zstd_without_libzstd_is_refused_by_name(monkeypatch):
    """A host without libzstd.so.1 refuses a ZSTD TIFF naming ZSTD and the
    library: a refusal, not a fallback."""
    import ctypes

    real = ctypes.CDLL

    def cdll(name, *a, **kw):
        if name == "libzstd.so.1":
            raise OSError(f"{name}: cannot open shared object file")
        return real(name, *a, **kw)

    data = tiff_file(RGB, 2, 8, compression=50000)
    monkeypatch.setattr(codec, "_stream_libs", {})
    monkeypatch.setattr(codec.ctypes, "CDLL", cdll)
    with pytest.raises(ValueError, match="ZSTD compression needs the system's libzstd.so.1"):
        codec.decode(data)


def test_differential_fuzz_of_zstd():
    """Random byte edits of the ZSTD fixtures (Predictor 2 strips, YCbCr
    tiles) at seed 21, every disagreement counted, against Pillow calling
    the host's libzstd as the port does. Pillow as installed calls the
    libzstd it bundles, another release, which decodes some damaged frames
    to other bytes: its disagreements are counted too and reported as a
    warning, not asserted."""
    cases = _fuzz(["zstd_pred.tif", "ycbcr_zstd_tiled.tif"], 21, 200)
    disagree = _disagreements(cases)
    assert not disagree, f"edits {disagree} decode differently from Pillow"
    stock = _disagreements(cases, host_zstd=False)
    warnings.warn(f"{len(stock)} of {len(cases)} ZSTD fuzz edits decode differently from "
                  "Pillow with its bundled libzstd", UserWarning)


_YCBCR_COMP = {"deflate": 8, "lzma": 34925, "zstd": 50000}
YCBCR_CASES = {
    f"{name}-strip{k}": tiff_damaged(tiff_file(_YCC, 6, 8, compression=comp, rows_per_strip=16,
                                               ycbcr_subsampling=(2, 2)), k, 1 / 3, b"\xff\xff")
    for name, comp in _YCBCR_COMP.items() for k in (0, 1)}


@pytest.mark.parametrize("name", YCBCR_CASES)
def test_damaged_ycbcr_strip_converts_what_was_decoded(name):
    """A Deflate, LZMA or ZSTD strip of YCbCr (not JPEG) damaged in its
    data: zlib, liblzma and libzstd fail on it, and libtiff's RGBA reader
    converts what the strip decoded before the error, zeros after."""
    import lzma

    comp = _YCBCR_COMP[name.split("-")[0]]
    data = YCBCR_CASES[name]
    off, count = tiff_strips(data)[int(name[-1])]
    if comp == 50000:
        assert not codec._inflate(comp, data[off:off + count], np.zeros(1 << 16, np.uint8))
    else:
        with pytest.raises((zlib.error, lzma.LZMAError)):
            (zlib.decompress if comp == 8 else lzma.decompress)(data[off:off + count])
    _held_to_pillow(YCBCR_CASES, name, True)


def _set_count(data: bytes, chunk: int, count: int) -> bytes:
    """The file with strip or tile ``chunk``'s byte count (LONG) set to
    ``count``."""
    ent = tiff_entries(data)
    tag = 279 if 279 in ent else 325
    n, at = struct.unpack_from("<L", data, ent[tag] + 4)[0], ent[tag] + 8
    if n > 1:
        (at,) = struct.unpack_from("<L", data, at)
    out = bytearray(data)
    struct.pack_into("<L", out, at + 4 * chunk, count)
    return bytes(out)


# (file, chunk, libtiff's strip or tile size): the first of two 20-row RGB
# strips (56 x 20 x 3 bytes), and the first and a later tile of a row of
# 16x16 YCbCr tiles subsampled 2x2 (8 x 8 units of 6 bytes), where the RGBA
# reader goes on past a tile libtiff cannot fill
_COUNT_LAYOUTS = {
    "strip0": (lambda comp: tiff_file(_SCENE, 2, 8, compression=comp, rows_per_strip=20), 0,
               3360),
    "tile0": (lambda comp: tiff_file(_YCC, 6, 8, compression=comp, tile=(16, 16),
                                     ycbcr_subsampling=(2, 2)), 0, 384),
    "tile1": (lambda comp: tiff_file(_YCC, 6, 8, compression=comp, tile=(16, 16),
                                     ycbcr_subsampling=(2, 2)), 1, 384),
}


def _count_cases() -> dict:
    """Each branch of TIFFFillStrip's and TIFFFillTile's byte count: 0;
    past the file's end; over 1 MiB, cut to ten strips or tiles and 4 KiB
    that end at the file's end (data padded after it); and so cut, still
    past the end."""
    cases = {}
    for cname, comp in (("deflate", 8), ("zstd", 50000)):
        for lname, (make, chunk, size) in _COUNT_LAYOUTS.items():
            base = make(comp)
            off, _ = tiff_strips(base)[chunk]
            cut = size * 10 + 4096
            assert off + cut > len(base)
            padded = base + bytes(off + cut - len(base))  # the cut span ends at the file's
            cases[f"{cname}-{lname}-zero"] = _set_count(base, chunk, 0)
            cases[f"{cname}-{lname}-past-end"] = _set_count(base, chunk, len(base) - off + 1)
            cases[f"{cname}-{lname}-limited"] = _set_count(padded, chunk, 2 << 20)
            cases[f"{cname}-{lname}-limited-past-end"] = _set_count(base, chunk, 2 << 20)
    return cases


COUNT_CASES = _count_cases()


@pytest.mark.parametrize("name", COUNT_CASES)
def test_byte_count_read_as_libtiff_reads_it(name):
    """libtiff fills every strip and tile alike: a byte count of 0, or one
    past the file's end, fails it (the RGBA reader goes on past a later
    YCbCr tile of its row, converting zeros), and a count over 1 MiB is cut
    to ten strips or tiles and 4 KiB first, so a file holding that much
    decodes."""
    decodes = not name.endswith(("zero", "past-end")) or "tile1" in name
    _held_to_pillow(COUNT_CASES, name, decodes)


@functools.lru_cache(maxsize=None)
def _zeros_coded(size: int, comp: int) -> bytes:
    import lzma

    if comp == 50000:
        return zstd_compress(bytes(size))
    return zlib.compress(bytes(size), 9) if comp == 8 else lzma.compress(bytes(size),
                                                                         check=lzma.CHECK_NONE)


def _ycbcr_tile(tw: int, th: int, comp: int, count: int) -> bytes:
    """A 16x16 YCbCr (2x1) file of one ``tw`` x ``th`` tile of zeros whose
    TileByteCounts is ``count`` (its data padded to it)."""
    raw = _zeros_coded(th * -(-tw // 2) * 4, comp)
    data = tiff_file(np.zeros((16, 16, 3), np.uint8), 6, 8, compression=comp, tile=(16, 16),
                     ycbcr_subsampling=(2, 1))
    out = data + raw + bytes(max(0, count - len(raw)))
    for tag, value in ((322, tw), (323, th), (324, len(data)), (325, count)):
        out = tiff_set_entry(out, tag, typ=4, count=1, value=value)
    return out


# (tile width, tile length, compression, byte count): a tile over
# 100,000,000 bytes (10000 x 5008 at 2x1, 100,160,000) whose data is under a
# thousandth of it (a 7000th for LZMA, a 33000th for ZSTD, where the count
# also cuts the frame short) and at it; a tile of 100,000,000 bytes exactly,
# which libtiff does not check
BIG_TILES = {"deflate-under": (10000, 5008, 8, 100159, False),
             "deflate-at": (10000, 5008, 8, 100160, True),
             "lzma-under": (10000, 5008, 34925, 14307, False),
             "lzma-at": (10000, 5008, 34925, 14308, True),
             "zstd-under": (10000, 5008, 50000, 3034, False),
             "zstd-at": (10000, 5008, 50000, 3035, True),
             "100MB-unchecked": (10000, 5000, 8, 97209, True)}


@pytest.fixture(scope="module")
def big_tiles():
    return {k: _ycbcr_tile(*v[:4]) for k, v in BIG_TILES.items()}


@pytest.mark.parametrize("name", BIG_TILES)
def test_likely_invalid_ycbcr_tile(big_tiles, name):
    """libtiff's RGBA reader refuses a YCbCr tile of over 100,000,000 bytes
    whose byte count is under a thousandth of it (a 7000th for LZMA, a
    33000th for ZSTD), before
    allocating it ("Likely invalid tile byte count"); at the ratio, or at
    100,000,000 bytes, it decodes the tile. (It checks no strip.)"""
    if not BIG_TILES[name][4]:
        with pytest.raises(ValueError, match="likely invalid tile byte count"):
            codec.decode(big_tiles[name])
    _held_to_pillow(big_tiles, name, BIG_TILES[name][4])


JPEG_CASES = {
    "strips": tiff_file(_SCENE[:32], 6, 8, compression=7, rows_per_strip=16,
                        ycbcr_subsampling=(2, 2), jpeg=jpeg_frames([(12, 40)] * 2)),
    "strip-after-the-first": tiff_file(_SCENE, 6, 8, compression=7, rows_per_strip=16,
                                       ycbcr_subsampling=(2, 2),
                                       jpeg=jpeg_frames([None, (10, 24), (7, 56)])),
    "tiles": tiff_file(_SCENE, 6, 8, compression=7, tile=(16, 16), ycbcr_subsampling=(2, 2),
                       jpeg=jpeg_frames([(8, 8)] * 12)),
    "tiles-after-the-first": tiff_file(_SCENE, 6, 8, compression=7, tile=(16, 16),
                                       ycbcr_subsampling=(2, 2),
                                       jpeg=jpeg_frames([None] + [(9, 13)] * 11)),
    "gray": tiff_file(_SCENE[..., 0], 1, 8, compression=7, rows_per_strip=16,
                      jpeg=jpeg_frames([(7, 30)] * 3, subsampling=0)),
    # a gray frame's component sampled 2x2: libtiff refuses its factors
    "gray-sampled-2x2": tiff_file(_SCENE[..., 0], 1, 8, compression=7, rows_per_strip=16,
                                  jpeg=jpeg_frames([(7, 30)] * 3)),
}


@pytest.mark.parametrize("name", JPEG_CASES)
def test_jpeg_frame_smaller_than_its_strip(name):
    """A JPEG strip or tile whose frame is narrower or shorter than it:
    libtiff warns and decodes it into Pillow's strip buffer, whose other
    bytes keep what the strip or tile before left (zeros at first)."""
    _held_to_pillow(JPEG_CASES, name, name != "gray-sampled-2x2")


CCITT_MODES = {"rle": (2, None), "g3-1d": (3, 0), "g3-2d": (3, 1), "g4": (4, None)}
# a bad code: 00 80 is no white or black run code (and a Group 4 EOL)
CCITT_CASES = {
    f"{mode}-fill{fill}-{damage}": (
        tiff_damaged(data, 1, 0.5, b"\x00\x80") if damage == "bad-code" else tiff_cut(data, k))
    for mode, (comp, t4) in CCITT_MODES.items() for fill in (1, 2)
    for data in [tiff_file(_BW, 0, 1, compression=comp, t4options=t4, rows_per_strip=16,
                           fill_order=fill)]
    for damage, k in (("bad-code", 1), ("cut-middle", 1), ("cut-last", 2))}


@pytest.mark.parametrize("name", CCITT_CASES)
def test_damaged_ccitt_decodes_as_libtiff(name):
    """CCITT RLE, Group 3 (1-D and 2-D) and Group 4 at both fill orders, with
    a bad code or a strip cut short: libtiff ends the row at a bad code, pads
    or cuts it and decodes on; data that runs out fails an RLE strip, Group 3
    reads it again without EOLs, and a Group 4 strip keeps the rows it made
    (the rest of Pillow's strip buffer the strip before's)."""
    decodes = True if "bad-code" in name else (False if name.startswith("rle") else None)
    _held_to_pillow(CCITT_CASES, name, decodes)


def _entry_count(data: bytes, delta: int) -> bytes:
    (pos,) = struct.unpack_from("<L", data, 4)
    (n,) = struct.unpack_from("<H", data, pos)
    return data[:pos] + struct.pack("<H", n + delta) + data[pos + 2:]


def _colormap(bits: int, entries: int) -> bytes:
    idx = np.random.default_rng(8).integers(0, 1 << bits, RGB.shape[:2], np.uint8)
    cmap = np.random.default_rng(9).integers(0, 65536, (entries, 3))
    return tiff_file(idx, 3, bits, colormap=cmap, compression=5)


def _colormap_first() -> bytes:
    """An 8-bit palette whose ColorMap entry comes before BitsPerSample."""
    data = bytearray(_colormap(8, 256))
    ent = tiff_entries(bytes(data))
    a, b = ent[258], ent[320]
    data[a:a + 12], data[b:b + 12] = data[b:b + 12], data[a:a + 12]
    return bytes(data)


def _past_file() -> bytes:
    data = tiff_file(RGB, 2, 8, compression=5, predictor=2, tags={305: (2, b"x" * 100)})
    return tiff_set_entry(data, 305, value=len(data) + 10)


_YCC_SMALL = np.concatenate([RGB[..., :1], RGB[..., 1:] // 2 + 64], -1)
# (bytes, whether Pillow decodes it, or None where both raise as they should)
DIRECTORY_CASES = {
    # an entry whose data lies past the file: Pillow's directory ends there
    # (without Predictor here), libtiff skips the field
    "software-past-file": (_past_file, True),
    # StripByteCounts past the file: libtiff estimates the counts, and
    # Pillow, its directory ended, reads the planar strips as libtiff's planes
    "counts-past-file": (lambda: tiff_set_entry(
        tiff_file(RGB, 2, 8, compression=32773, planar=2, rows_per_strip=16), 279,
        count=1 << 20), True),
    "offsets-past-file": (lambda: tiff_set_entry(
        tiff_file(RGB, 2, 8, compression=32773, planar=2, rows_per_strip=16), 279,
        value=1 << 24), False),
    "orientation-past-file": (lambda: tiff_set_entry(
        tiff_file(RGB, 2, 8, compression=5, orientation=6), 274, typ=4, count=1 << 20), False),
    # a field libtiff reads of the wrong type or count: the size, layout and
    # sample fields fail its directory, the rest it ignores (defaults)
    "ycbcr-subsampling-count": (lambda: tiff_set_entry(
        tiff_file(_YCC_SMALL, 6, 8, compression=8, ycbcr_subsampling=(1, 1)), 530, count=1),
        True),
    "ycbcr-coefficients-type": (lambda: tiff_set_entry(
        tiff_file(_YCC_SMALL, 6, 8, compression=8, ycbcr_subsampling=(2, 2),
                  tags={529: (5, [(2990, 10000), (5870, 10000), (1140, 10000)])}), 529, typ=4),
        True),
    "predictor-type": (lambda: tiff_set_entry(tiff_file(RGB, 2, 8, compression=5, predictor=2),
                                              317, typ=4), True),
    "rows-per-strip-type": (lambda: tiff_set_entry(
        tiff_file(RGB, 2, 8, compression=5, rows_per_strip=8), 278, typ=2), False),
    "rows-per-strip-count": (lambda: tiff_set_entry(
        tiff_file(RGB, 2, 8, compression=5, rows_per_strip=8), 278, count=2), False),
    "width-rational": (lambda: tiff_set_entry(tiff_file(RGB, 2, 8, compression=5), 256, typ=5),
                       False),
    "fill-order-3": (lambda: tiff_set_entry(tiff_file(RGB, 2, 8, compression=5), 278,
                                            new_tag=266, typ=3, count=1, value=3), False),
    # a ColorMap of the wrong size: libtiff ignores it (and a 4-bit palette
    # then fails its directory); Pillow takes up to 256 colours
    "colormap-4bit-size": (lambda: _colormap(4, 17), False),
    "colormap-8bit-short": (lambda: _colormap(8, 255), True),
    "colormap-8bit-long": (lambda: _colormap(8, 257), False),
    "colormap-first": (_colormap_first, True),
    # libtiff keeps the first of duplicate tags, Pillow the last
    "duplicate-tag": (lambda: tiff_set_entry(tiff_file(RGB, 2, 8, compression=5, orientation=3),
                                             274, new_tag=262, value=2), True),
    # byte counts libtiff estimates: 0 in a one-strip file, or none
    "byte-count-zero": (lambda: tiff_set_entry(tiff_file(RGB, 2, 8, compression=8), 279,
                                               value=0), True),
    "byte-counts-missing": (lambda: tiff_set_entry(tiff_file(RGB, 2, 8, compression=8), 279,
                                                   new_tag=65000), True),
    "byte-counts-short": (lambda: tiff_set_entry(
        tiff_file(RGB, 2, 8, compression=5, rows_per_strip=8), 279, count=2), False),
    # PackBits ignores a Predictor (LZW, Deflate and LZMA read it)
    "packbits-predictor": (lambda: tiff_file(RGB, 2, 8, compression=32773,
                                             tags={317: (3, [2])}), True),
    # the entry count and the header
    "entry-count-up": (lambda: _entry_count(tiff_file(RGB, 2, 8, compression=5), 1), False),
    "entry-count-down": (lambda: _entry_count(tiff_file(RGB, 2, 8, compression=5,
                                                        orientation=3), -1), True),
    "entry-count-zero": (lambda: _entry_count(tiff_file(RGB, 2, 8, compression=5), -10),
                         False),
    "bigtiff-offset-size": (lambda: (lambda d: d[:4] + b"\x04" + d[5:])(
        tiff_file(RGB, 2, 8, bigtiff=True, compression=5)), False),
    "header-version": (lambda: (lambda d: d[:2] + b"\x2b\x00" + d[4:])(
        tiff_file(RGB, 2, 8, compression=5)), False),
}
DIRECTORY_FILES = {k: make() for k, (make, _) in DIRECTORY_CASES.items()}


@pytest.mark.parametrize("name", DIRECTORY_CASES)
def test_libtiff_reads_the_directory_its_own_way(name):
    """A compressed file's first directory as libtiff reads it for Pillow's
    decoder, the strips and the fields it decodes by from there, the mode
    still from Pillow's reading: the port's pixels are Pillow's, or both
    raise."""
    _held_to_pillow(DIRECTORY_FILES, name, DIRECTORY_CASES[name][1])
