"""The JPEG variants the port's codec gained (``csrc/host/image_codec.cc``)
against Pillow (libjpeg-turbo 3), which the JAX package's
``core/imaging.py`` opens every upload with.

Every case must equal Pillow's pixels exactly: arithmetic-coded sequential
(SOF9) and progressive (SOF10) files written by the system's libjpeg
(``scripts/codec_fixtures.py::arith_jpeg``), with restarts, every sampling
and gray; lossless (SOF3) files at every predictor and point transform,
restarts, a scan a component and subsampled components
(``lossless_jpeg``); progressive files cut between scans with their EOI
kept, which libjpeg-turbo block-smooths (``cut_progressive``). Where Pillow
refuses a file (an arithmetic scan past its 64 KiB read block, 12-bit and
16-bit lossless, lossless YCbCr, hierarchical and arithmetic lossless
frames) the port raises a ``ValueError`` naming the feature.
"""

import base64
import io
import os
import struct
import sys
import warnings

import numpy as np
import pytest
from PIL import Image, ImageOps

from qwen_image_edit_streamdiffusion_tpu.core import imaging as jimaging
from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
from codec_fixtures import (arith_jpeg, cut_progressive, jpeg_scans, lossless_jpeg,  # noqa: E402
                            pil_rgb_c_idct, scene)

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


def _both_raise(data: bytes, match: str) -> None:
    with pytest.raises(ValueError, match=match):
        codec.decode(data)
    with pytest.raises(Exception):
        _pil(data)


def _noisy(h: int, w: int, seed: int = 0) -> np.ndarray:
    a = scene(h, w, seed).astype(np.int32)
    noise = np.random.default_rng(seed).integers(-50, 50, a.shape)
    return np.clip(a + noise, 0, 255).astype(np.uint8)


ARITH_SIZES = [(1, 1), (17, 9), (37, 53), (64, 64)]


@pytest.mark.parametrize("progressive", [False, True], ids=["sequential", "progressive"])
@pytest.mark.parametrize("quality", [50, 90, 100])
@pytest.mark.parametrize("hw", ARITH_SIZES, ids=[f"{h}x{w}" for h, w in ARITH_SIZES])
def test_arithmetic_matches_pillow(hw, quality, progressive):
    """jdarith.c: the QM decoder, DC and AC statistics, the DC first and
    refinement and AC first and refinement scans into the coefficients the
    Huffman path fills."""
    _same(arith_jpeg(_noisy(*hw), quality, progressive))


ARITH_VARIANTS = {
    "gray": dict(gray=True),
    "restart-3": dict(restart=3),
    "restart-1-progressive": dict(restart=1, progressive=True),
    "444": dict(sampling=(1, 1)),
    "422-progressive": dict(sampling=(2, 1), progressive=True),
    "440": dict(sampling=(1, 2)),
}


@pytest.mark.parametrize("kw", ARITH_VARIANTS.values(), ids=ARITH_VARIANTS.keys())
def test_arithmetic_variants_match_pillow(kw):
    kw = dict(kw)
    px = _noisy(45, 61, 3)
    if kw.pop("gray", False):
        px = px[..., 0]
    _same(arith_jpeg(px, 85, **kw))


def _pad_app(data: bytes, total: int) -> bytes:
    """APP15 segments of ``total`` bytes after the SOI."""
    out = b""
    while total > 0:
        n = min(total, 60000)
        out += b"\xff\xef" + struct.pack(">H", n + 2) + bytes(n)
        total -= n
    return data[:2] + out + data[2:]


def test_arithmetic_scan_past_pillow_read_block():
    """libjpeg's arithmetic decoder cannot suspend, and Pillow hands it the
    file 64 KiB at a time: a scan whose data crosses the block its header
    ended in breaks Pillow's decode, and the port refuses it by name; the
    same scan moved to start past 64 KiB decodes."""
    px = _noisy(100, 100, 5)
    data = arith_jpeg(px, 95)
    _both_raise(_pad_app(data, 65536 - 4000), "64 KiB")
    _same(_pad_app(data, 3 * 30000))
    _same(data)
    big = arith_jpeg(_noisy(300, 300, 6), 100, progressive=True)
    assert len(big) > 65536
    _both_raise(big, "64 KiB")


PREDICTORS = [(p, t) for p in range(1, 8) for t in (0, 3)]


@pytest.mark.parametrize("predictor,pt", PREDICTORS, ids=[f"p{p}-pt{t}" for p, t in PREDICTORS])
def test_lossless_matches_pillow(predictor, pt):
    """jdlossls.c / jddiffct.c: each predictor, the point transform, the
    first row and column predicted as the standard has it; a lossless file
    without a JFIF or Adobe marker is RGB."""
    px = _noisy(23, 31, predictor)
    got = _same(lossless_jpeg(px, predictor, pt))
    np.testing.assert_array_equal(got, (px >> pt) << pt)


def _sub(px, sampling):
    hm, vm = max(h for h, _ in sampling), max(v for _, v in sampling)
    return [np.ascontiguousarray(px[::vm // v, ::hm // h, c]) for c, (h, v) in enumerate(sampling)]


LOSSLESS_VARIANTS = {
    "gray": lambda px: lossless_jpeg(px[..., 0], 6),
    "restarts": lambda px: lossless_jpeg(px, 4, restart_rows=3),
    "scan-a-component": lambda px: lossless_jpeg(px, 5, interleaved=False, restart_rows=2),
    "sampled-2x1": lambda px: lossless_jpeg(_sub(px, [(2, 1), (1, 1), (1, 1)]), 1,
                                           sampling=[(2, 1), (1, 1), (1, 1)]),
    "sampled-2x2-restarts": lambda px: lossless_jpeg(_sub(px, [(2, 2), (1, 1), (1, 1)]), 7,
                                                    sampling=[(2, 2), (1, 1), (1, 1)],
                                                    restart_rows=2),
    "sampled-2x2-1x2": lambda px: lossless_jpeg(_sub(px, [(2, 2), (1, 2), (1, 1)]), 2,
                                               sampling=[(2, 2), (1, 2), (1, 1)]),
    "cmyk": lambda px: lossless_jpeg(np.concatenate([px, px[..., :1]], -1), 1),
    "adobe-rgb": lambda px: lossless_jpeg(px, 1, markers=b"\xff\xee\x00\x0eAdobe\x00\x64"
                                          b"\x00\x00\x00\x00\x00"),
    "large": lambda px: lossless_jpeg(_noisy(300, 410, 9), 1),
}


@pytest.mark.parametrize("make", LOSSLESS_VARIANTS.values(), ids=LOSSLESS_VARIANTS.keys())
def test_lossless_variants_match_pillow(make):
    """Box upsampling (jdsample.c takes no fancy upsampling when a block is
    one sample), restarts in whole MCU rows, a file read past Pillow's
    64 KiB blocks (the lossless Huffman decoder suspends)."""
    _same(make(_noisy(29, 37, 4)))


def _relabel(data: bytes, marker: int = None, precision: int = None) -> bytes:
    i = data.index(b"\xff\xc3")
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


JFIF = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
REFUSED = {
    "12-bit": (lambda d: _relabel(d, precision=12), "12-bit lossless"),
    "16-bit": (lambda d: _relabel(d, precision=16), "16-bit lossless"),
    "ycbcr": (lambda d: d[:2] + JFIF + d[2:], "lossless JPEG coded as YCbCr"),
    "ycck": (lambda d: lossless_jpeg(np.concatenate([_noisy(9, 11), _noisy(9, 11)[..., :1]], -1),
                                     1, markers=b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00"
                                     b"\x00\x02"), "YCCK"),
    "restart-not-a-row": (lambda d: lossless_jpeg(_noisy(9, 11), 1, restart_rows=1).replace(
        b"\xff\xdd\x00\x04\x00\x0b", b"\xff\xdd\x00\x04\x00\x07"), "whole number of MCU rows"),
    "arithmetic-lossless": (lambda d: _relabel(d, marker=0xCB), "arithmetic-coded lossless"),
    "hierarchical-5": (lambda d: _relabel(d, marker=0xC5), "hierarchical"),
    "hierarchical-6": (lambda d: _relabel(d, marker=0xC6), "hierarchical"),
    "hierarchical-7": (lambda d: _relabel(d, marker=0xC7), "hierarchical"),
    "hierarchical-13": (lambda d: _relabel(d, marker=0xCD), "hierarchical"),
    "hierarchical-14": (lambda d: _relabel(d, marker=0xCE), "hierarchical"),
    "hierarchical-15": (lambda d: _relabel(d, marker=0xCF), "hierarchical"),
    "height-from-dnl": (lambda d: d[:d.index(b"\xff\xc3") + 5] + b"\x00\x00"
                        + d[d.index(b"\xff\xc3") + 7:], "DNL"),
}


@pytest.mark.parametrize("case", REFUSED.values(), ids=REFUSED.keys())
def test_refusals_where_pillow_raises(case):
    make, match = case
    _both_raise(make(lossless_jpeg(_noisy(9, 11), 1)), match)


def test_dnl_after_the_frame_is_skipped():
    """A DNL segment once the frame has its height: jdmarker.c skips it."""
    data = arith_jpeg(_noisy(20, 30, 1), 90)
    sos = data.index(b"\xff\xda")
    _same(data[:sos] + b"\xff\xdc\x00\x04\x00\x14" + data[sos:])


def test_missing_huffman_tables_take_the_standard_ones():
    """libjpeg-turbo gives a sequential Huffman file without DHT Annex K's
    tables (Motion JPEG frames); a lossless one without them fails."""
    buf = io.BytesIO()
    Image.fromarray(_noisy(20, 30, 2)).save(buf, "JPEG", quality=80)
    data = buf.getvalue()
    out, pos = data[:2], 2
    while data[pos + 1] != 0xDA:
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if data[pos + 1] != 0xC4:
            out += data[pos:pos + 2 + n]
        pos += 2 + n
    _same(out + data[pos:])


def _progressive(px, quality=85, subsampling=2) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "JPEG", quality=quality, progressive=True,
                             subsampling=subsampling)
    return buf.getvalue()


SMOOTH = [(64, 64, 2), (37, 53, 2), (100, 140, 0), (9, 300, 1), (45, 17, 2), (45, 12, 2),
          (23, 9, 2), (33, 33, -1)]


@pytest.mark.parametrize("h,w,sub", SMOOTH, ids=[f"{h}x{w}-{s}" for h, w, s in SMOOTH])
def test_block_smoothing_matches_pillow(h, w, sub):
    """jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1+): each cut of a
    progressive file between its scans (EOI kept) block-smoothed, DC
    interpolation when no AC data arrived, the 5x5 window's edges as
    libjpeg counts block rows in an iMCU row; Huffman and arithmetic."""
    px = _noisy(h, w, h + w)
    data = _progressive(px[..., 0] if sub < 0 else px, 70, max(sub, 0))
    n = len(jpeg_scans(data)[1])
    for k in range(1, n):
        _same(cut_progressive(data, k))
    if sub >= 0:
        arith = arith_jpeg(px, 80, progressive=True)
        for k in range(1, len(jpeg_scans(arith)[1])):
            _same(cut_progressive(arith, k))


def test_block_smoothing_of_a_short_last_scan():
    """A last scan whose data runs into its EOI early: the iMCU rows past
    the last one decoded with data take the previous scan's bits
    (libjpeg-turbo's last_good_iMCU_row)."""
    data = _progressive(_noisy(64, 80, 7), 85)
    head, scans, tail = jpeg_scans(data)
    cut = scans[5][:len(scans[5]) // 2]
    _same(head + b"".join(scans[:5]) + cut + tail)


def test_committed_fixtures_match_pillow():
    for name in ("arith.jpg", "arith_prog.jpg", "arith_1024.jpg", "arith_prog_1024.jpg",
                 "lossless.jpg", "smoothed.jpg"):
        with open(os.path.join(FIXTURES, name), "rb") as f:
            _same(f.read())


def test_jax_package_gives_the_same_arrays():
    """``codec.decode_base64`` of an arithmetic-coded and of a lossless JPEG
    equals the JAX package's ``core/imaging.base64_to_pil``."""
    for data in (arith_jpeg(_noisy(33, 47, 8), 90, progressive=True),
                 lossless_jpeg(_noisy(33, 47, 9), 4)):
        b64 = "data:image/jpeg;base64," + base64.b64encode(data).decode()
        np.testing.assert_array_equal(codec.decode_base64(b64),
                                      np.asarray(jimaging.base64_to_pil(b64)))


def test_differential_fuzz_against_pillow():
    """Random byte edits of the arithmetic, lossless and block-smoothed
    fixtures: the port and Pillow (libjpeg-turbo's C code) both raise, or
    their pixels are equal."""
    rng = np.random.default_rng(23)
    names = ["arith.jpg", "arith_prog.jpg", "lossless.jpg", "smoothed.jpg"]
    seeds = []
    for name in names:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            seeds.append(f.read())
    cases = []
    for it in range(400):
        d = bytearray(seeds[it % len(seeds)])
        for _ in range(int(rng.integers(1, 4))):
            d[int(rng.integers(0, len(d)))] = int(rng.integers(0, 256))
        cases.append(bytes(d))
    want = pil_rgb_c_idct(cases)
    disagree = []
    for it, (d, w) in enumerate(zip(cases, want)):
        try:
            got = codec.decode(d)
        except ValueError:
            got = None
        if (w is None) != (got is None) or (w is not None and not np.array_equal(w, got)):
            disagree.append((names[it % len(seeds)], it))
    assert not disagree, f"edits {disagree} decode differently from Pillow"
