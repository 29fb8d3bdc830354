"""The TIFF cases the port's decoder (``core/codec.py`` over
``csrc/host/tiff.cc``) took on after the rest: the floating-point predictor,
12-bit gray, YCbCr (not JPEG) at any Orientation and 4x4-subsampled strips
that libtiff reads short, ThunderScan and CCITT RLEW, against Pillow 12.1
over its bundled libtiff 4.7.1, which the JAX package opens every upload with
(``Image.open`` → ``ImageOps.exif_transpose`` → ``convert("RGB")``).

Every case equals Pillow's bytes, or both raise. The fixtures are
``scripts/codec_fixtures.py::tiff_more_fixtures()``; the fuzzes (cut files
and byte edits of each kind) count every disagreement and excuse none. As in
``test_torch_codec_tiff.py``, batches of damaged files go to Pillow in a
subprocess whose ``realloc`` zeroes what it adds, so that a byte of its strip
buffer no strip wrote is the zero a fresh buffer holds in the port.
"""

import functools
import hashlib
import io
import json
import os
import sys
import warnings

import numpy as np
import pytest
from PIL import Image, ImageOps

from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
from codec_fixtures import (fax_encode, pil_rgb_c_idct, scene, thunder_encode,  # noqa: E402
                            tiff_file, tiff_more_fixtures)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "codec")
MORE = ["fpred_lzw.tif", "fpred_deflate.tif", "fpred_lzma_be_tiled.tif", "fpred_zstd_tiled.tif",
        "gray12.tif", "gray12_lzw_tiled.tif", "ycbcr_orient3.tif", "ycbcr_orient6_tiled.tif",
        "ycbcr44_short.tif", "ycbcr44_short_deflate.tif", "thunderscan.tif",
        "thunderscan_palette_fill2.tif", "rlew.tif", "rlew_odd.tif"]


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


def _fixture(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def _fresh_pillow() -> dict:
    """Pillow's pixels (None where it raises) of every case held to Pillow
    with fresh memory (the 4x4 strips read short, the fuzzes), decoded in one
    subprocess."""
    cases = dict(_short_4x4_cases())
    for kind in FUZZ:
        cases.update(_fuzz_cases(kind))
    keys = list(cases)
    return dict(zip(keys, pil_rgb_c_idct([cases[k] for k in keys], fresh_memory=True)))


def _disagreements(cases: dict) -> list:
    """The cases whose port decode is not Pillow's: both raise, or their
    pixels are equal."""
    want = _fresh_pillow()
    disagree = []
    for k, data in cases.items():
        try:
            got = codec.decode(data)
        except ValueError:
            got = None
        if (want[k] is None) != (got is None) or (got is not None
                                                  and not np.array_equal(want[k], got)):
            disagree.append(k)
    return disagree


# ---------------------------------------------------------------------------
# The committed fixtures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MORE)
def test_fixture_matches_pillow_and_its_manifest(name):
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        entry = json.load(f)[name]
    got = _same(_fixture(name))
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]


def test_fixtures_reproduce_byte_for_byte():
    made = tiff_more_fixtures()
    assert sorted(made) == sorted(MORE)
    for name, data in made.items():
        assert data == _fixture(name), name
    assert sum(map(len, made.values())) < 150_000


# ---------------------------------------------------------------------------
# The floating-point predictor (Predictor 3)
# ---------------------------------------------------------------------------

F32 = scene(23, 37, 3)[..., 0].astype(np.float32) * np.float32(1.37) - np.float32(40.25)
F32[3, 5], F32[4, 6], F32[5, 7], F32[6, 8] = np.nan, np.inf, -np.inf, -0.0
FP_CASES = {f"{c}-{lay}-{'be' if be else 'le'}": (c, lay, be)
            for c in (5, 8, 34925, 50000) for lay in ("strips", "tiles") for be in (False, True)}


@pytest.mark.parametrize("case", FP_CASES.values(), ids=FP_CASES.keys())
def test_float_predictor_matches_pillow(case):
    """fpAcc over each row's bytes, then the planes put back together as
    native floats; a big-endian file's floats read swapped, as Pillow reads
    libtiff's native samples with its big-endian raw mode."""
    comp, layout, be = case
    for photometric, planar in ((1, 1), (0, 2)):
        _same(tiff_file(F32, photometric, 32, sample_format=3, compression=comp, predictor=3,
                        big_endian=be, planar=planar, rows_per_strip=7,
                        tile=(16, 16) if layout == "tiles" else None))


def test_pillow_written_float_predictor_reads_back():
    """Pillow writes Predictor 3 (``tiffinfo={317: 3}``) under LZW and
    Deflate; the port reads its files to Pillow's pixels."""
    for comp in ("tiff_lzw", "tiff_adobe_deflate"):
        buf = io.BytesIO()
        Image.fromarray(F32, "F").save(buf, "TIFF", compression=comp, tiffinfo={317: 3})
        assert Image.open(io.BytesIO(buf.getvalue())).tag_v2[317] == 3
        _same(buf.getvalue())


PREDICTOR_REFUSED = {
    # tif_predict.c's PredictorSetup fails these, so Pillow raises
    "uint8": (lambda: tiff_file(scene(9, 11, 1)[..., 0], 1, 8, compression=5,
                                tags={317: (3, [3])}), "sample format 1"),
    "int16": (lambda: tiff_file(scene(9, 11, 1)[..., 0].astype(np.uint16), 1, 16,
                                sample_format=2, compression=8, tags={317: (3, [3])}),
              "sample format 2"),
    "predictor-4": (lambda: tiff_file(F32, 1, 32, sample_format=3, compression=5,
                                      tags={317: (3, [4])}), "predictor"),
}


@pytest.mark.parametrize("case", PREDICTOR_REFUSED.values(), ids=PREDICTOR_REFUSED.keys())
def test_float_predictor_refused_where_libtiff_refuses_it(case):
    make, match = case
    _both_raise(make(), match)


def test_big_endian_signed_and_float_read_as_pillow_reads_them():
    """A compressed big-endian file's signed and float samples (Pillow's raw
    modes I;16BS, I;32BS, F;32BF) read swapped from libtiff's native ones,
    Predictor 2 or not; unsigned ones (I;16B, made native) read right; a
    negative 16-bit sample clips to 0."""
    g = scene(13, 17, 2)[..., 0].astype(np.int64) * 3 - 300
    for comp, pred in ((5, 1), (8, 2), (1, 1)):
        for bits, fmt in ((16, 2), (32, 2), (16, 1)):
            for be in (False, True):
                _same(tiff_file((g % (1 << bits)).astype(np.uint64), 1, bits, sample_format=fmt,
                                compression=comp, predictor=pred, big_endian=be))
        # the floats' words, so that Predictor 2 differences them as libtiff does
        _same(tiff_file(F32.view(np.uint32), 1, 32, sample_format=3, compression=comp,
                        predictor=pred, big_endian=True))


# ---------------------------------------------------------------------------
# 12-bit gray
# ---------------------------------------------------------------------------

G12 = (scene(21, 29, 6)[..., 0].astype(np.int64) * 3 - 100) % 4096
G12_CASES = {f"{c}-{lay}": (c, lay) for c in (1, 5, 8, 32773, 34925)
             for lay in ("strips", "tiles")}


@pytest.mark.parametrize("case", G12_CASES.values(), ids=G12_CASES.keys())
def test_gray12_matches_pillow(case):
    """Pillow's I;12 unpacker (three nibbles a sample, the first the
    highest) into I;16, then its conversion clipping at 255; odd and even
    widths."""
    comp, layout = case
    for w in (29, 28, 1):
        _same(tiff_file(G12[:, :w], 1, 12, compression=comp, rows_per_strip=8,
                        tile=(16, 16) if layout == "tiles" else None))


def test_gray12_refusals_where_pillow_raises():
    _both_raise(tiff_file(G12, 1, 12, compression=5, predictor=2), "Predictor 2 with 12-bit")
    _both_raise(tiff_file(G12, 1, 12, big_endian=True), "Pillow has no mode")


# ---------------------------------------------------------------------------
# YCbCr at any Orientation, and 4x4 read short
# ---------------------------------------------------------------------------

_RGB = scene(37, 53, 13)
YCC = np.concatenate([_RGB[..., :1], _RGB[..., 1:] // 2 + 64], -1)
ORIENTED = {f"{o}-{lay}": (o, lay) for o in range(1, 9) for lay in ("strips", "tiles")}


@pytest.mark.parametrize("case", ORIENTED.values(), ids=ORIENTED.keys())
def test_ycbcr_orientation_matches_pillow(case):
    """Pillow's RGBA reader asks libtiff for the file's own orientation, so
    no strip or tile is flipped; Pillow's transpose of the Orientation tag
    then runs once, as for every TIFF."""
    orientation, layout = case
    tile = (16, 16) if layout == "tiles" else None
    for comp, sub in ((5, (2, 2)), (8, (4, 2)), (34925, (1, 1))):
        _same(tiff_file(YCC, 6, 8, compression=comp, rows_per_strip=8, tile=tile,
                        ycbcr_subsampling=sub, orientation=orientation))


def _short_4x4_cases() -> dict:
    return {("4x4", w, rps, comp): tiff_file(YCC[:, :w], 6, 8, compression=comp,
                                             rows_per_strip=rps, ycbcr_subsampling=(4, 4),
                                             orientation=1 + (w + rps) % 8)
            for w, rps in ((49, 8), (49, 37), (13, 5), (4, 8), (1, 5), (45, 12))
            for comp in (5, 8, 34925)}


def test_ycbcr_4x4_read_short_matches_pillow():
    """4x4-subsampled strips an odd number of units wide: TIFFScanlineSize
    rounds the units of a row of blocks down, so gtStripContig reads two
    bytes a block row short and converts the zeros of the strip buffer
    libtiff cleared in their place; the port converts the zeros of its own.
    Each width, RowsPerStrip and codec, against Pillow with fresh memory."""
    assert not _disagreements(_short_4x4_cases())


# ---------------------------------------------------------------------------
# ThunderScan
# ---------------------------------------------------------------------------

G4 = scene(29, 47, 5)[..., 0] >> 4
FLAT = G4.copy()
FLAT[:, 30:] = FLAT[:, 29:30]  # rows that end in a run
CMAP = np.random.default_rng(3).integers(0, 65536, (16, 3))


@pytest.mark.parametrize("photometric", [0, 1, 3])
@pytest.mark.parametrize("fill", [1, 2])
def test_thunderscan_matches_pillow(photometric, fill):
    """Runs, 2- and 3-bit deltas and raw values, a row at a time, each from a
    last pixel of 0; gray, inverted gray and a palette; strips of 1, 5 and
    all rows."""
    cmap = CMAP if photometric == 3 else None
    for rps in (None, 5, 1):
        data = tiff_file(G4, photometric, 4, compression=32809, rows_per_strip=rps,
                         fill_order=fill, colormap=cmap)
        got = _same(data)
    if photometric == 1:  # the codes round-trip
        np.testing.assert_array_equal(got[..., 0], (G4 * 17).astype(np.uint8))


def _strips_file(w: int, h: int, bits: int, compression: int, rps: int, blobs,
                 lead: int = 0) -> bytes:
    """A gray TIFF of the coded strips ``blobs``, after ``lead`` bytes."""
    body, offsets = bytes(lead), []
    for b in blobs:
        offsets.append(8 + len(body))
        body += b + (b"\x00" if len(b) % 2 else b"")
    return _rebuild(w, h, bits, 1, rps, body, {259: (3, [compression]), 273: (4, offsets),
                                               279: (4, [len(b) for b in blobs])})


def _rebuild(w, h, bits, photometric, rps, body, tags) -> bytes:
    import struct

    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits]), 262: (3, [photometric]),
               277: (3, [1]), 278: (4, [rps])}
    entries.update(tags)
    ifd_pos = 8 + len(body)
    extra_pos = ifd_pos + 2 + 12 * len(entries) + 4
    ifd, extra = struct.pack("<H", len(entries)), b""
    for tag in sorted(entries):
        typ, vals = entries[tag]
        raw = struct.pack("<" + {3: "H", 4: "L"}[typ] * len(vals), *vals)
        if len(raw) <= 4:
            field = raw.ljust(4, b"\x00")
        else:
            field = struct.pack("<L", extra_pos + len(extra))
            extra += raw
        ifd += struct.pack("<HHL", tag, typ, len(vals)) + field
    return b"II*\x00" + struct.pack("<L", ifd_pos) + body + ifd + b"\x00" * 4 + extra


def test_thunderscan_runs_ending_on_the_row_end():
    """A run that ends on its row's end is written (one past it fails the
    row); at odd and even widths, from odd and even positions; codes past
    the last row are never read."""
    for w in (47, 46, 31):
        for rps in (None, 4):
            got = _same(tiff_file(FLAT[:, :w], 1, 4, compression=32809, rows_per_strip=rps))
            np.testing.assert_array_equal(got[..., 0], (FLAT[:, :w] * 17).astype(np.uint8))
    _same(_strips_file(47, 29, 4, 32809, 29, [thunder_encode(G4) + b"\x3f"]))


THUNDER_REFUSED = {
    "8-bit": (lambda: tiff_file(G4, 1, 8, compression=32809), "ThunderScan with 8-bit"),
    "tiles": (lambda: tiff_file(G4, 1, 4, compression=32809, tile=(16, 16)),
              "ThunderScan in tiles"),
    "too-little": (lambda: _strips_file(47, 29, 4, 32809, 29, [thunder_encode(G4)[:-20]]),
                   "ThunderScan row"),
}


@pytest.mark.parametrize("case", THUNDER_REFUSED.values(), ids=THUNDER_REFUSED.keys())
def test_thunderscan_refused_where_pillow_raises(case):
    make, match = case
    _both_raise(make(), match)


def test_thunderscan_row_of_the_wrong_length_is_refused():
    """A run past the row's end (npixels over the width) fails the strip."""
    codes = bytes([0xC5, 63, 63])  # a raw 5, then 126 of it in a row of 47
    _both_raise(_strips_file(47, 1, 4, 32809, 1, [codes]), "wrong number of pixels")


# ---------------------------------------------------------------------------
# CCITT RLEW
# ---------------------------------------------------------------------------

BW = (scene(21, 45, 4)[..., 0] > 128).astype(np.uint8)


@pytest.mark.parametrize("width", [45, 16, 17, 8, 1])
@pytest.mark.parametrize("lead", [0, 1])
def test_rlew_matches_pillow(width, lead):
    """Modified Huffman rows aligned as FAXMODE_WORDALIGN aligns them (by
    the address, the strip at an even or an odd offset); photometric 0 and 1,
    FillOrder 2, strips of 7 rows and of all."""
    bw = (scene(21, width, 4)[..., 0] > 128).astype(np.uint8)
    for photometric, fill, rps in ((0, 1, 7), (1, 2, None)):
        got = _same(tiff_file(bw, photometric, 1, compression=32771, rows_per_strip=rps,
                              fill_order=fill, lead=lead))
        if lead == 0 and photometric == 0:  # the writer's rows are where libtiff reads them
            np.testing.assert_array_equal(got[..., 0] == 0, bw == 1)


def test_rlew_rows_padded_to_words_read_as_libtiff_reads_them():
    """A writer that pads every row to a 16-bit word: libtiff finds some rows
    elsewhere (it aligns by its bit accumulator), and the port reads each
    file as it does, or both raise."""
    for width in (45, 17, 33, 100):
        bw = (scene(11, width, 9)[..., 0] > 128).astype(np.uint8)
        words = b""
        for row in bw:  # each row byte-aligned by RLE, then to a word
            code = fax_encode(row[None], 2)
            words += code + b"\x00" * (len(code) % 2)
        for lead in (0, 1):
            data = _strips_file(width, 11, 1, 32771, 11, [words], lead=lead)
            try:
                want = _pil(data)
            except Exception:
                with pytest.raises(ValueError):
                    codec.decode(data)
            else:
                np.testing.assert_array_equal(codec.decode(data), want)


def test_rlew_refusals_where_pillow_raises():
    _both_raise(_strips_file(45, 21, 1, 32771, 21, [fax_encode(BW, 32771)[:40]]),
                "CCITT data ends short")
    _both_raise(_strips_file(45, 21, 8, 32771, 21, [b"\x00" * 64]), "CCITT with 8-bit")


# ---------------------------------------------------------------------------
# The uncompressed FillOrder 2 modes Pillow has no raw mode for
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("photometric,bits", [(0, 8), (3, 1), (3, 2), (3, 4)])
def test_fill_order_2_raw_modes_pillow_lacks_are_refused(photometric, bits):
    g = scene(9, 13, 1)[..., 0] >> (8 - bits)
    cmap = np.zeros((1 << bits, 3), np.int64) if photometric == 3 else None
    _both_raise(tiff_file(g, photometric, bits, fill_order=2, colormap=cmap),
                "Pillow has no raw mode")
    _same(tiff_file(g, photometric, bits, fill_order=2, colormap=cmap, compression=32773))


# ---------------------------------------------------------------------------
# Differential fuzzes: cut files and byte edits of each kind
# ---------------------------------------------------------------------------

FUZZ = {
    "float-predictor": ["fpred_lzw.tif", "fpred_lzma_be_tiled.tif", "fpred_zstd_tiled.tif"],
    "gray12": ["gray12.tif", "gray12_lzw_tiled.tif"],
    "ycbcr": ["ycbcr_orient3.tif", "ycbcr_orient6_tiled.tif", "ycbcr44_short.tif",
              "ycbcr44_short_deflate.tif"],
    "thunderscan": ["thunderscan.tif", "thunderscan_palette_fill2.tif"],
    "rlew": ["rlew.tif", "rlew_odd.tif"],
}


def _fuzz_cases(kind: str) -> dict:
    """Each fixture of the kind cut at 10 lengths, and 100 random edits of 1
    to 3 bytes (seed 23)."""
    names = FUZZ[kind]
    rng = np.random.default_rng(23)
    seeds = [_fixture(n) for n in names]
    cases = {}
    for name, data in zip(names, seeds):
        for cut in np.linspace(8, len(data) - 1, 10).astype(int):
            cases[(name, "cut", int(cut))] = data[:cut]
    for it in range(100):
        d = bytearray(seeds[it % len(seeds)])
        at = []
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(0, len(d)))
            d[i] = int(rng.integers(0, 256))
            at.append(i)
        cases[(names[it % len(seeds)], "edit", tuple(at))] = bytes(d)
    return cases


@pytest.mark.parametrize("kind", FUZZ)
def test_differential_fuzz_against_pillow(kind):
    """Cut files and byte edits of each kind's fixtures: the port and Pillow
    both raise, or their pixels are equal; every disagreement counted."""
    cases = _fuzz_cases(kind)
    disagree = _disagreements(cases)
    assert not disagree, f"{len(disagree)} of {len(cases)} decode apart from Pillow: {disagree}"
