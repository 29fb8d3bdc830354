"""CIELab uploads and DDS's BC6H blocks against Pillow 12.1 (``core/codec.py``
over ``csrc/host/lab_srgb.cc`` and ``bcn.cc``).

Pillow converts a LAB image to RGB through LittleCMS 2.17: a transform from
``cmsCreateLab2Profile(NULL)`` to ``cmsCreate_sRGBProfile()`` at
``TYPE_Lab_8`` → RGB. The port carries that arithmetic itself (the card's
host has no LittleCMS), and is held to it here:

- all 2^24 Lab8 inputs through the port and through Pillow: 0 mismatches;
- each stage against LittleCMS itself, Pillow's bundled ``liblcms2`` called
  through ctypes (``scripts/codec_fixtures.py``'s ``lcms`` helpers, skipped
  where the library is absent): the sRGB profile's colorants as doubles,
  the 33³ grid's 16-bit nodes and the unoptimized pipeline at random 16-bit
  inputs, both against a 16-bit transform with ``cmsFLAGS_NOOPTIMIZE``;
- Lab files as each plugin reads them: TIFF (a and b signed in a chunky
  file, planes as they are; every compression, JPEG's 4:4:4 strips among
  them, layout, byte order and Orientation of the TIFF path), PSD (raw,
  PackBits) and IM (type LAB: the L band, a and b zero), each equal to
  Pillow's pixels and to the JAX package's ``bytes_to_pil``; an IPTC image
  of a Lab record decodes as Pillow's, a band of one raises as Pillow
  raises; a fuzz of header edits and cuts counts every disagreement;
- BC6H_UF16 and BC6H_SF16: random blocks with each of the 14 modes and the
  4 reserved ones forced, every 16-bit endpoint through mode 14 (the half
  float's mapping to 8 bits) and unsaturated interpolation, equal to
  Pillow's ``bcn`` decoder;
- the hashes ``chip_smoke.py`` holds its card-host decodes to are Pillow's.
"""

import hashlib
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from codec_fixtures import (CMS_FLAGS_NOOPTIMIZE, TYPE_LAB_16, TYPE_RGB_16,  # noqa: E402
                            bc6h_blocks, dds_file, im_file, iptc_file, lcms, lcms_lab_to_rgb,
                            lcms_srgb_colorants, pil_rgb_c_idct, psd_file, scene, tiff_file,
                            tiff_set_entry)

needs_lcms = pytest.mark.skipif(lcms() is None, reason="Pillow's bundled liblcms2 is absent")
LAB = scene(19, 23, 4)  # any bytes are Lab samples


def _pil(data: bytes) -> np.ndarray:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return np.asarray(ImageOps.exif_transpose(Image.open(io.BytesIO(data))).convert("RGB"))


def _pil_or_none(data: bytes):
    try:
        return _pil(data)
    except Exception:  # noqa: BLE001 - whatever Pillow raises
        return None


def _port_or_none(data: bytes):
    try:
        return codec.decode(data)
    except ValueError:
        return None


def _all_lab8() -> np.ndarray:
    i = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([i >> 16, (i >> 8) & 255, i & 255], -1).astype(np.uint8)


# ---------------------------------------------------------------------------
# The conversion: every input, and each stage against LittleCMS
# ---------------------------------------------------------------------------


def test_every_lab8_input_converts_as_pillow():
    """All 2^24 (L, a + 128, b + 128) triples as a Pillow LAB image's bytes
    (its raw mode LAB takes a and b signed, so they go in XORed with 128):
    the port's RGB is Pillow's, with 0 mismatches, and its SHA-256 the one
    ``chip_smoke.py`` holds the card host's sweep to."""
    import chip_smoke

    lab = _all_lab8()
    got = codec.lab_to_rgb(lab)
    raw = (lab ^ np.uint8([0, 128, 128])).tobytes()
    want = np.asarray(Image.frombytes("LAB", (4096, 4096), raw).convert("RGB")).reshape(-1, 3)
    mismatches = int((got != want).any(-1).sum())
    assert mismatches == 0, f"{mismatches} of 2^24 inputs differ from Pillow"
    assert hashlib.sha256(want.tobytes()).hexdigest() == chip_smoke.LAB_SWEEP_SHA256


@needs_lcms
def test_srgb_colorants_are_littlecms_doubles():
    """The sRGB profile's colorants (Rec. 709 primaries, D65 Bradford-adapted
    to D50) are the doubles LittleCMS's built-in profile holds: unrounded,
    bit for bit."""
    got = np.empty(9)
    codec.library().qie_lab_srgb_colorants(got.ctypes.data)
    np.testing.assert_array_equal(got.reshape(3, 3), lcms_srgb_colorants())


@needs_lcms
def test_grid_nodes_are_littlecms_unoptimized_values():
    """The 33³ grid the 8-bit conversion interpolates in: each node is what
    LittleCMS's unoptimized 16-bit transform gives at the node's input."""
    n = 33
    grid = np.empty(n ** 3 * 3, np.uint16)
    assert codec.library().qie_lab_srgb_grid(grid.ctypes.data) == n
    q = np.floor(np.arange(n) * 65535 / (n - 1) + 0.5).astype(np.uint16)
    nodes = np.stack(np.meshgrid(q, q, q, indexing="ij"), -1).reshape(-1, 3)
    want = lcms_lab_to_rgb(nodes, TYPE_LAB_16, TYPE_RGB_16, CMS_FLAGS_NOOPTIMIZE)
    np.testing.assert_array_equal(grid.reshape(-1, 3), want)


@needs_lcms
def test_pipeline_at_16_bit_inputs_is_littlecms_unoptimized():
    """The float pipeline the grid samples (Lab → XYZ, the inverse colorant
    matrix, the inverse sRGB curve) at 2^18 random 16-bit inputs and at the
    corners: LittleCMS's unoptimized 16-bit transform's values."""
    rng = np.random.default_rng(25)
    lab = rng.integers(0, 65536, (1 << 18, 3)).astype(np.uint16)
    lab[:8] = np.array([[a, b, c] for a in (0, 65535) for b in (0, 65535) for c in (0, 65535)])
    got = np.empty_like(lab)
    codec.library().qie_lab_srgb_eval16(lab.ctypes.data, len(lab), got.ctypes.data)
    want = lcms_lab_to_rgb(lab, TYPE_LAB_16, TYPE_RGB_16, CMS_FLAGS_NOOPTIMIZE)
    np.testing.assert_array_equal(got, want)


def test_no_littlecms_in_the_port():
    """The package and ``chip_smoke.py`` load no LittleCMS and import none of
    the test helpers that do."""
    pkg = os.path.join(ROOT, "qwen_image_edit_streamdiffusion_tpu_torch")
    paths = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith((".py", ".cc"))]
    for path in paths:
        with open(path) as f:
            assert "lcms" not in f.read(), path


# ---------------------------------------------------------------------------
# Lab files: TIFF, PSD, IM
# ---------------------------------------------------------------------------


def _jpeg444(block: np.ndarray) -> bytes:
    """A JPEG strip of 4:4:4 samples (libtiff takes no other sampling for a
    photometric but YCbCr)."""
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(block)).save(buf, "JPEG", quality=90, subsampling=0)
    return buf.getvalue()


def _pillow_lab_tiff() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(scene(17, 21, 6)).convert("LAB").save(buf, "TIFF")
    return buf.getvalue()


LAB_FILES = {
    "tiff_raw": lambda: tiff_file(LAB, 8),
    "tiff_raw_be": lambda: tiff_file(LAB, 8, big_endian=True, rows_per_strip=5),
    "tiff_lzw": lambda: tiff_file(LAB, 8, compression=5, rows_per_strip=4),
    "tiff_lzw_be_predictor": lambda: tiff_file(LAB, 8, compression=5, big_endian=True,
                                               predictor=2),
    "tiff_deflate": lambda: tiff_file(LAB, 8, compression=8),
    "tiff_adobe_deflate_be": lambda: tiff_file(LAB, 8, compression=32946, big_endian=True),
    "tiff_packbits": lambda: tiff_file(LAB, 8, compression=32773, rows_per_strip=7),
    "tiff_lzma": lambda: tiff_file(LAB, 8, compression=34925),
    "tiff_tiled_raw": lambda: tiff_file(LAB, 8, tile=(16, 16)),
    # two tiles' offsets of four: what no tile covers is the LAB image's zeros
    "tiff_tiles_uncovered": lambda: tiff_set_entry(tiff_set_entry(
        tiff_file(LAB, 8, tile=(16, 16)), 324, count=2), 325, count=2),
    "tiff_tiled_deflate_be": lambda: tiff_file(LAB, 8, compression=8, tile=(16, 16),
                                               big_endian=True),
    "tiff_planar_raw": lambda: tiff_file(LAB, 8, planar=2),
    "tiff_planar_lzw": lambda: tiff_file(LAB, 8, compression=5, planar=2, rows_per_strip=6),
    "tiff_bigtiff": lambda: tiff_file(LAB, 8, compression=8, bigtiff=True),
    "tiff_jpeg": lambda: tiff_file(LAB, 8, compression=7, jpeg=_jpeg444, rows_per_strip=8),
    "tiff_jpeg_tiled_be": lambda: tiff_file(LAB, 8, compression=7, jpeg=_jpeg444,
                                            tile=(16, 16), big_endian=True),
    "tiff_orientation_3": lambda: tiff_file(LAB, 8, compression=5, orientation=3),
    "tiff_orientation_6": lambda: tiff_file(LAB, 8, orientation=6),
    "tiff_orientation_8_be": lambda: tiff_file(LAB, 8, compression=8, orientation=8,
                                               big_endian=True),
    "tiff_pillow": _pillow_lab_tiff,
    "psd_raw": lambda: psd_file(LAB.transpose(2, 0, 1), 9, compression=0),
    "psd_rle": lambda: psd_file(LAB.transpose(2, 0, 1), 9),
    "psd_extra_channel": lambda: psd_file(LAB.transpose(2, 0, 1), 9, extra_channels=1),
    "im": lambda: im_file(b"LAB", 23, 19, LAB[::-1, :, 0].tobytes()).replace(b"LAB image",
                                                                            b"LAB"),
    "im_lut": lambda: im_file(b"LAB", 23, 19, LAB[::-1, :, 1].tobytes(),
                              lut=bytes(range(256))[::-1] * 3).replace(b"LAB image", b"LAB"),
    "dds_bc6h": lambda: dds_file(23, 19, bc6h_blocks(LAB), 0x4, dxgi=95),
    "dds_bc6hs": lambda: dds_file(23, 19, bc6h_blocks(LAB, signed=True), 0x4, dxgi=96),
}


@pytest.mark.parametrize("name", LAB_FILES)
def test_lab_files_decode_as_pillow(name):
    data = LAB_FILES[name]()
    np.testing.assert_array_equal(codec.decode(data), _pil(data))


def test_jax_bytes_to_pil_gives_the_same_arrays():
    """The JAX package's ``core/imaging.py::bytes_to_pil`` (Pillow's open,
    exif_transpose and convert) on each Lab and BC6H file."""
    for name, make in LAB_FILES.items():
        data = make()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = np.asarray(jimaging.bytes_to_pil(data))
        np.testing.assert_array_equal(codec.decode(data), want, err_msg=name)


def test_planar_lab_tiff_keeps_its_bytes():
    """Pillow reads a planar Lab TIFF's planes as they are (the raw mode's
    bands L, A and B, and libtiff's plane copy), a chunky one's a and b
    XORed with 128: the same samples give other pixels, each as Pillow's."""
    for comp in (1, 5):
        chunky, planar = (tiff_file(LAB, 8, compression=comp, planar=p) for p in (1, 2))
        assert not np.array_equal(codec.decode(chunky), codec.decode(planar))
        np.testing.assert_array_equal(codec.decode(planar), codec.lab_to_rgb(LAB))


def test_lab_refusals_stay_named():
    """What has no Pillow mode stays refused by name: a 16-bit or an
    extra-sample Lab TIFF, a 16-bit Lab PSD. A Lab TIFF of 4:2:0 JPEG
    strips fails libtiff's check of the sampling factors, in both."""
    for data in (tiff_file(LAB.astype(np.uint16) * 257, 8, 16),
                 tiff_file(np.concatenate([LAB, LAB[..., :1]], -1), 8, extra=(0,))):
        assert _pil_or_none(data) is None
        with pytest.raises(ValueError, match="unsupported TIFF: photometric 8"):
            codec.decode(data)
    psd16 = psd_file(LAB.transpose(2, 0, 1), 9, bits=16, compression=0)
    with pytest.raises(ValueError, match="unsupported image format"):
        codec.decode(psd16)
    jpeg = tiff_file(LAB, 8, compression=7, jpeg=lambda b: codec.encode_jpeg(
        np.ascontiguousarray(b), 90))
    assert _pil_or_none(jpeg) is None
    with pytest.raises(ValueError, match="improper JPEG sampling factors"):
        codec.decode(jpeg)


def test_iptc_bands_of_lab_records_follow_pillow():
    """An IPTC image whose record is a Lab TIFF, PSD or IM file. As the image
    itself it decodes: ``exif_transpose`` copies the record's LAB image, so
    ``convert("RGB")`` goes through LittleCMS (Pillow's C convert of the
    IPTC image as opened has no LAB to RGB). As a band of RGB or CMYK,
    Image.merge refuses a three-band image, and the port raises naming
    IPTC. An L record of PSD or IM as a band merges as Pillow merges it."""
    records = {"TIFF": tiff_file(LAB, 8), "PSD": psd_file(LAB.transpose(2, 0, 1), 9),
               "IM": LAB_FILES["im"]()}
    for fmt, record in records.items():
        data = iptc_file(23, 19, record, compression=5)
        np.testing.assert_array_equal(codec.decode(data), _pil(data), err_msg=fmt)
        for kw in (dict(layers=3, component=1, band=1), dict(layers=3, component=1, band=2),
                   dict(layers=4, component=1, band=1)):
            data = iptc_file(23, 19, record, compression=5, **kw)
            assert _pil_or_none(data) is None, (fmt, kw)
            with pytest.raises(ValueError, match="IPTC: a LAB record"):
                codec.decode(data)
    for record in (psd_file(LAB[..., :1].transpose(2, 0, 1), 1),
                   im_file(b"Greyscale", 23, 19, LAB[..., 0].tobytes())):
        data = iptc_file(23, 19, record, layers=3, component=1, compression=5, band=2)
        np.testing.assert_array_equal(codec.decode(data), _pil(data))


# the fuzz: header edits and cuts; (file, header ranges to edit in)
def _header_ranges(name: str, data: bytes):
    if name.startswith("tiff"):
        big = data[2] == 0x2B
        (ifd,) = struct.unpack_from(("<" if data[:2] == b"II" else ">") + ("Q" if big else "L"),
                                    data, 8 if big else 4)
        return [(0, 16), (ifd, len(data))]
    if name.startswith("psd"):
        return [(0, 40 + 2 * 3 * 19 if name == "psd_rle" else 40)]
    return [(0, 512 if name.startswith("im") else 148)]


FUZZ = {"tiff": (["tiff_raw", "tiff_lzw_be_predictor", "tiff_tiled_deflate_be",
                  "tiff_planar_lzw", "tiff_packbits", "tiff_orientation_6", "tiff_jpeg"], 490),
        "psd": (["psd_raw", "psd_rle"], 300), "im": (["im"], 80),
        "dds": (["dds_bc6h", "dds_bc6hs"], 150)}


def _mutate(data: bytes, ranges, rng) -> bytes:
    """One to three byte edits in the header ranges, and a cut of the file
    one time in four."""
    b = bytearray(data)
    for _ in range(int(rng.integers(1, 4))):
        lo, hi = ranges[int(rng.integers(len(ranges)))]
        b[int(rng.integers(lo, hi))] = int(rng.integers(256))
    if rng.random() < 0.25:
        b = b[:int(rng.integers(1, len(b) + 1))]
    return bytes(b)


@pytest.mark.parametrize("kind", sorted(FUZZ))
def test_fuzz_agrees_with_pillow(kind):
    """Header edits and cuts of the Lab and BC6H files at seed 25: Pillow
    and the port both fail, or give equal pixels. Every disagreement counts;
    none is excused. Pillow reads the TIFF edits in a process whose realloc
    zeroes what it adds (its strip buffer is never cleared) and whose
    libjpeg-turbo runs its C IDCT, as the port does."""
    names, count = FUZZ[kind]
    rng = np.random.default_rng(25)
    seeds = [(LAB_FILES[n](), n) for n in names]
    cases = []
    for i in range(count):
        data, name = seeds[i % len(seeds)]
        cases.append(_mutate(data, _header_ranges(name, data), rng))
    wants = (pil_rgb_c_idct(cases, fresh_memory=True) if kind == "tiff"
             else [_pil_or_none(d) for d in cases])
    disagreements = []
    for i, (data, want) in enumerate(zip(cases, wants)):
        got = _port_or_none(data)
        if (want is None) != (got is None) or (
                want is not None and (want.shape != got.shape or not np.array_equal(want, got))):
            disagreements.append(i)
    assert disagreements == [], f"{len(disagreements)} of {count}: {disagreements[:10]}"


# ---------------------------------------------------------------------------
# BC6H: every mode, every endpoint
# ---------------------------------------------------------------------------

BC6H_MODES = [0b00, 0b01, 0b00010, 0b00110, 0b01010, 0b01110, 0b10010, 0b10110, 0b11010,
              0b11110, 0b00011, 0b00111, 0b01011, 0b01111,
              0b10011, 0b10111, 0b11011, 0b11111]  # the last four reserved


def _dds(blocks: bytes, w: int, h: int, dxgi: int) -> bytes:
    return dds_file(w, h, blocks, 0x4, dxgi=dxgi)


@pytest.mark.parametrize("mode", BC6H_MODES, ids=[f"{m:05b}" for m in BC6H_MODES])
@pytest.mark.parametrize("dxgi", [95, 96], ids=["UF16", "SF16"])
def test_bc6h_random_blocks_of_each_mode(dxgi, mode):
    """256 random blocks with the mode's bits forced (two bits for modes 1
    and 2, five for the rest; a reserved mode is transparent black): each
    pixel equal to Pillow's ``bcn`` decoder's."""
    rng = np.random.default_rng(mode * 2 + dxgi)
    blocks = rng.integers(0, 256, (256, 16), dtype=np.uint8)
    bits = 2 if mode < 2 else 5
    blocks[:, 0] = (blocks[:, 0] & ~np.uint8((1 << bits) - 1)) | mode
    data = _dds(blocks.tobytes(), 64, 16, dxgi)
    np.testing.assert_array_equal(codec.decode(data), _pil(data))


def _mode14(v: int) -> bytes:
    """A mode 14 block whose endpoints are ``v`` (16 bits) on every channel,
    no delta, every index 0."""
    bits, pos = 0b01111, 5
    for _ in range(3):
        bits |= (v & 1023) << pos
        pos += 10
    for _ in range(3):
        pos += 4
        for b in range(15, 9, -1):  # the top bits stored reversed
            bits |= ((v >> b) & 1) << pos
            pos += 1
    return bits.to_bytes(16, "little")


@pytest.mark.parametrize("dxgi", [95, 96], ids=["UF16", "SF16"])
def test_bc6h_every_endpoint_maps_as_pillow(dxgi):
    """All 65536 16-bit endpoints through mode 14 (unquantized as they are):
    the half float each finalizes to, and its 8 bits, are Pillow's."""
    data = _dds(b"".join(_mode14(v) for v in range(65536)), 1024, 1024, dxgi)
    got, want = codec.decode(data), _pil(data)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) == 256


@pytest.mark.parametrize("dxgi", [95, 96], ids=["UF16", "SF16"])
def test_bc6h_interpolation_below_one(dxgi):
    """Mode 11 blocks whose endpoints stay under 1.0 (unsaturated) and random
    4-bit indices: the interpolation's rounding shows in every byte."""
    rng = np.random.default_rng(dxgi)
    top = 520 if dxgi == 95 else 260
    blocks = []
    for _ in range(1024):
        bits, pos = 0b00011, 5
        for v in rng.integers(0, top, 6):
            bits |= int(v) << pos
            pos += 10
        for i, x in enumerate(rng.integers(0, 16, 16)):
            n = 3 if i == 0 else 4
            bits |= int(x & ((1 << n) - 1)) << pos
            pos += n
        blocks.append(bits.to_bytes(16, "little"))
    data = _dds(b"".join(blocks), 128, 128, dxgi)
    want = _pil(data)
    np.testing.assert_array_equal(codec.decode(data), want)
    assert len(np.unique(want)) > 200


# ---------------------------------------------------------------------------
# The card host's files
# ---------------------------------------------------------------------------


def test_chip_script_lab_files_match_their_hashes():
    """``chip_smoke.lab_decode_set(1024)`` (written there without Pillow):
    Pillow's RGB of each file has the SHA-256 ``chip_smoke.py`` commits (the
    port's decode of the same files, at any size, is held to Pillow's by
    ``test_chip_script_inputs_match_pillow``)."""
    import chip_smoke

    rows = chip_smoke.lab_decode_set(1024)
    assert set(rows) == set(chip_smoke.LAB_DECODE_SHA256)
    for name, (data, _) in rows.items():
        digest = hashlib.sha256(_pil(data).tobytes()).hexdigest()
        assert digest == chip_smoke.LAB_DECODE_SHA256[name], name
