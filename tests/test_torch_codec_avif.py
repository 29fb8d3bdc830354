"""Lossless AVIF uploads against Pillow 12.1 (``core/avif.py`` and
``core/codec.py`` over ``csrc/host/av1.cc``).

Pillow's AVIF plugin is libavif 1.3, which decodes with dav1d 1.5.1 and
converts YUV to RGB with its bundled libyuv. The port reads the HEIF boxes
as libavif reads them, decodes the AV1 key frame from the specification's
decoding process (the default CDFs committed in ``csrc/host/av1_tables.h``)
and converts as libavif does; every case here is held to Pillow's pixels:

- the committed fixtures and generated cases (every chroma layout at odd
  and even sizes, noise that reaches every intra mode, several tiles, RGBA,
  EXIF, ``irot``/``imir`` and XMP orientations, ``colr`` variants, the box
  layouts libavif reads) equal Pillow's ``convert("RGB")`` after
  ``exif_transpose`` and the JAX package's ``bytes_to_pil``;
- the committed tables equal ``libaom.so.3``'s and ``libdav1d.so.6``'s
  (skipped where the libraries are absent);
- a seeded differential fuzz of single-byte edits inside the tile data
  (and the alpha item's), which dav1d decodes to garbage the port must
  equal (or both fail), of byte edits in the boxes and of cuts: 0
  disagreements; a declared refusal
  met by an edit (a frame of another size than its ``ispe``, a matrix the
  port does not convert) is counted apart;
- each declared refusal raises a ValueError naming AVIF and the feature
  where Pillow decodes the file;
- no AV1, AVIF or YUV library is loaded by a decode.
"""

import functools
import io
import json
import os
import struct
import subprocess
import sys
import warnings

import numpy as np
import pytest
from PIL import Image, ImageOps

from qwen_image_edit_streamdiffusion_tpu.core import imaging as jimaging
from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "codec")
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import av1_tables  # noqa: E402
from codec_fixtures import (av1_config, av1_obus, av1_reduced_sequence,  # noqa: E402
                            av1_rewrite, avif_file, avif_parts, avif_property, avif_remux,
                            avif_save, scene)

SAMPLINGS = ("4:2:0", "4:2:2", "4:4:4", "4:0:0")
# the refusals a fuzz edit may meet where Pillow decodes (see test_declared_refusals)
DECLARED = ("another size than its ispe", "matrix coefficients")


def _pil(data: bytes):
    """Pillow's pixels, or None where Pillow raises."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return np.asarray(ImageOps.exif_transpose(Image.open(io.BytesIO(data))).convert("RGB"))
        except Exception:  # noqa: BLE001
            return None


def _port(data: bytes):
    try:
        return codec.decode(data)
    except ValueError as e:
        return e


def _fixture_names():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return [n for n in json.load(f) if n.endswith(".avif")]


@pytest.mark.parametrize("name", _fixture_names())
def test_committed_fixture_equals_pillow_and_jax(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    want = _pil(data)
    assert want is not None
    got = codec.decode(data)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jimaging.bytes_to_pil(data)))


def _nclx(data: bytes, matrix: int, full: int) -> bytes:
    at = data.index(b"colrnclx") + 8
    return data[:at + 4] + struct.pack(">H", matrix) + bytes([full << 7]) + data[at + 7:]


@functools.lru_cache(maxsize=None)
def _save(key, **kw) -> bytes:
    """Pillow's file of a named image (cached across the cases)."""
    images = {"small": lambda: scene(26, 18, 30), "colr": lambda: scene(30, 34, 31),
              "gray": lambda: np.repeat(np.arange(256, dtype=np.uint8).reshape(16, 16, 1), 3, 2)}
    return avif_save(images[key](), **kw)


def _noise(h: int, w: int, c: int = 3) -> np.ndarray:
    return np.random.default_rng(h * 1000 + w).integers(0, 256, (h, w, c), np.uint8)


def _exif_orientation(o: int) -> bytes:
    exif = Image.Exif()
    exif[0x0112] = o
    return _save("small", exif=exif.tobytes())


def _exif_item_without_irot() -> bytes:
    parts = avif_parts(_save("small"))
    exif = Image.Exif()
    exif[0x0112] = 3
    return avif_remux(parts, item_list=[(1, b"av01", parts["obus"]),
                                        (2, b"Exif", struct.pack(">I", 6) + exif.tobytes())],
                      refs=[(b"cdsc", 2, [1])])


def _clap() -> bytes:
    parts = avif_parts(_save("small"))
    props = parts["props"] + [avif_property(b"clap", struct.pack(">8I", 10, 1, 12, 1, 0, 1, 0, 1))]
    return avif_remux(parts, props=props, assoc={1: parts["assoc"][1] + [(len(props), True)]})


XMP = (b'<x:xmpmeta xmlns:x="adobe:ns:meta/"><rdf:RDF xmlns:rdf="http://www.w3.org/'
       b'1999/02/22-rdf-syntax-ns#"><rdf:Description xmlns:tiff="http://ns.adobe.com/'
       b'tiff/1.0/" tiff:Orientation="6"/></rdf:RDF></x:xmpmeta>')


def _cases() -> dict:
    """{name: a function that writes a file Pillow decodes}; nothing is encoded until
    a case runs."""
    out = {}
    for h, w in ((1, 1), (2, 3), (7, 5), (17, 33), (64, 64), (65, 63), (70, 130)):
        for ss in SAMPLINGS:
            out[f"noise_{h}x{w}_{ss}"] = lambda h=h, w=w, ss=ss: avif_save(_noise(h, w),
                                                                          subsampling=ss)
    for ss in SAMPLINGS:
        out[f"scene_256_{ss}"] = lambda ss=ss: avif_save(scene(256, 256, 27), subsampling=ss)
    out["tiles_2x2"] = lambda: avif_save(scene(128, 128, 28), tile_rows=1, tile_cols=1)
    out["tiles_1x2_422"] = lambda: avif_save(scene(72, 140, 29), tile_cols=1, subsampling="4:2:2")
    out["rgba_odd"] = lambda: avif_save(_noise(21, 34, 4), "RGBA")
    for o in range(1, 9):
        out[f"exif_orientation_{o}"] = lambda o=o: _exif_orientation(o)
    out["xmp_orientation"] = lambda: _save("small", xmp=XMP)
    out["exif_item_without_irot"] = _exif_item_without_irot
    for name, kw in (("idat", {"idat": True}), ("three_extents", {"extents": 3}),
                     ("mif1_major", {"major": b"mif1", "brands": (b"mif1", b"avif")})):
        out[f"boxes_{name}"] = lambda kw=kw: avif_remux(avif_parts(_save("small")), **kw)
    out["clap_kept"] = _clap
    for ss in ("4:2:0", "4:2:2", "4:4:4"):
        for matrix in (1, 2, 5, 6, 9):
            for full in (0, 1):
                out[f"colr_{ss}_m{matrix}_full{full}"] = (
                    lambda ss=ss, m=matrix, f=full: _nclx(_save("colr", subsampling=ss), m, f))
        out[f"colr_{ss}_none"] = lambda ss=ss: _save("colr", subsampling=ss).replace(
            b"colrnclx", b"freenclx")
    out["colr_4:4:4_identity_limited"] = lambda: _nclx(_save("colr", subsampling="4:4:4"), 0, 0)
    for matrix in (0, 1, 4, 7, 9, 12, 15):
        for full in (0, 1):
            out[f"colr_4:0:0_m{matrix}_full{full}"] = (
                lambda m=matrix, f=full: _nclx(_save("gray", subsampling="4:0:0"), m, f))
    return out


@functools.lru_cache(maxsize=None)
def _case(name: str) -> bytes:
    return _cases()[name]()


@pytest.mark.parametrize("name", list(_cases()))
def test_case_equals_pillow(name):
    data = _case(name)
    want = _pil(data)
    assert want is not None, name
    np.testing.assert_array_equal(codec.decode(data), want)


def test_jax_bytes_to_pil_gives_the_same_arrays():
    """The JAX ``core/imaging.py::bytes_to_pil`` on the generated cases."""
    for name in ("noise_65x63_4:2:0", "exif_orientation_6", "xmp_orientation", "rgba_odd"):
        data = _case(name)
        np.testing.assert_array_equal(codec.decode(data),
                                      np.asarray(jimaging.bytes_to_pil(data)), err_msg=name)


def test_committed_tables_equal_the_libraries():
    """``csrc/host/av1_tables.h`` is what ``scripts/av1_tables.py`` reads
    out of libaom and checks against dav1d today."""
    if not (av1_tables.LIBAOM.exists() and av1_tables.LIBDAV1D.exists()):
        pytest.skip("libaom.so.3 or libdav1d.so.6 is absent")
    with open(av1_tables.OUT) as f:
        assert f.read() == av1_tables.build()


@functools.lru_cache(maxsize=None)
def _refusals() -> dict:
    """The refusals, each a file Pillow decodes."""
    img = scene(36, 44, 40)
    base = avif_save(img)
    parts = avif_parts(base)
    obus = parts["obus"]
    seq = av1_reduced_sequence(next(b for t, b in av1_obus(obus) if t == 1))

    def remux(new_obus, seq_fields=None, extra=(), essential=(b"av1C",), depth=None):
        props = []
        for p in parts["props"]:
            if p[4:8] == b"av1C" and seq_fields:
                p = av1_config({**seq, **seq_fields})
            if p[4:8] == b"pixi" and depth:
                p = avif_property(b"pixi", bytes([3, depth, depth, depth]), 0)
            props.append(p)
        props += list(extra)
        assoc = {1: [(i + 1, p[4:8] in essential) for i, p in enumerate(props)]}
        return avif_file([(1, b"av01", new_obus)], props, assoc)

    grain = [1] + [0, 1] * 8 + [0] * 4 + [0] + [0] * 8 + [0, 0]
    rgba = avif_parts(avif_save(np.concatenate([img, img[..., :1]], -1), "RGBA"))
    tiles = [avif_parts(avif_save(scene(64, 64, k))) for k in (41, 42)]
    grid_props = tiles[0]["props"] + [avif_property(b"ispe", struct.pack(">II", 128, 64), 0)]
    tile_assoc = [(i + 1, p[4:8] == b"av1C") for i, p in enumerate(tiles[0]["props"])]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "AVIF", quality=100, save_all=True,
                              append_images=[Image.fromarray(img[::-1].copy())])
    ispe = base.index(b"ispe") + 8
    return {
        "lossy frames": avif_save(img, quality=90),
        "screen-content tools": avif_save(
            np.asarray(Image.fromarray(img).quantize(4).convert("RGB"))),
        "10-bit streams": remux(av1_rewrite(obus, seq={"high": 1}), {"high": 1}, depth=10),
        "12-bit streams": remux(av1_rewrite(obus, seq={"profile": 2, "high": 1, "twelve": 1}),
                                {"profile": 2, "high": 1, "twelve": 1}, depth=12),
        "superres": remux(av1_rewrite(obus, seq={"superres": 1}, insert=(2, [1, 1, 1, 1]))),
        "film grain": remux(av1_rewrite(obus, seq={"grain": 1}, append=grain)),
        "several operating points or layers (a1op)": remux(
            obus, extra=[avif_property(b"a1op", b"\0")], essential=(b"av1C", b"a1op")),
        "several operating points or layers (lsel)": remux(
            obus, extra=[avif_property(b"lsel", b"\0\0")], essential=(b"av1C", b"lsel")),
        "image sequences (avis)": buf.getvalue(),
        "grid derived images": avif_file(
            [(3, b"grid", bytes([0, 0, 0, 1]) + struct.pack(">HH", 128, 64)),
             (1, b"av01", tiles[0]["obus"]), (2, b"av01", tiles[1]["obus"])],
            grid_props, {1: tile_assoc, 2: tile_assoc, 3: [(len(grid_props), False)]},
            primary=3, refs=[(b"dimg", 3, [1, 2])]),
        "premultiplied alpha (prem)": avif_remux(rgba, refs=rgba["refs"] + [(b"prem", 1, [2])]),
        "another size than its ispe": base[:ispe] + struct.pack(">II", 40, 36) + base[ispe + 8:],
        **{f"matrix coefficients {m}": _nclx(base, m, 1) for m in (4, 7, 8, 12, 15)},
    }


REFUSED = ("lossy frames", "screen-content tools", "10-bit streams", "12-bit streams", "superres",
           "film grain", "several operating points or layers (a1op)",
           "several operating points or layers (lsel)", "image sequences (avis)",
           "grid derived images", "premultiplied alpha (prem)", "another size than its ispe",
           *(f"matrix coefficients {m}" for m in (4, 7, 8, 12, 15)))


@pytest.mark.parametrize("feature", REFUSED)
def test_declared_refusals(feature):
    """Pillow decodes each file; the port raises a ValueError naming AVIF
    and the feature (listed in ROADMAP queue 3 under the formats and
    variants that raise)."""
    data = _refusals()[feature]
    assert _pil(data) is not None, feature
    words = feature.split(" (")[0]
    with pytest.raises(ValueError, match=r"AVIF \(.*" + words.replace("(", r"\(")):
        codec.decode(data)


def _tile_span(data: bytes):
    """(start, end) in the file of the primary item's tile data."""
    parts = avif_parts(data)
    obus = parts["obus"]
    at, pos = data.index(obus), 0
    seq = av1_reduced_sequence(next(b for t, b in av1_obus(obus) if t == 1))
    from codec_fixtures import av1_frame_header_bits

    for typ, body in av1_obus(obus):
        start = obus.index(body, pos)
        if typ == 6:
            _, tiles = av1_frame_header_bits(body, seq)
            return at + start + len(body) - len(tiles), at + start + len(body)
        pos = start + len(body)
    raise AssertionError("no frame OBU")


@functools.lru_cache(maxsize=None)
def _fuzz_files(kind: str):
    if kind == "alpha":
        return [avif_save(np.random.default_rng(4).integers(0, 256, (20, 30, 4), np.uint8), "RGBA")]
    files = [avif_save(scene(24, 20, 50), subsampling=ss) for ss in SAMPLINGS]
    files.append(avif_save(np.random.default_rng(3).integers(0, 256, (16, 24, 3), np.uint8)))
    files.append(avif_save(scene(72, 136, 51), tile_cols=1))
    files.append(_fuzz_files("alpha")[0])
    return files


def _fuzz(kind: str, n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    files = _fuzz_files(kind)
    counts = {"both fail": 0, "equal": 0, "declared refusal": 0}
    bad = []
    for k in range(n):
        data = files[k % len(files)]
        b = bytearray(data)
        if kind == "tile":
            lo, hi = _tile_span(data)
            at = int(rng.integers(lo, hi))
            b[at] = int(rng.integers(0, 256))
        elif kind == "alpha":  # the alpha item's data, after its headers
            item = avif_parts(data)["items"][2]
            lo = data.index(item)
            at = int(rng.integers(lo + len(item) // 3, lo + len(item)))
            b[at] = int(rng.integers(0, 256))
        elif kind == "box":
            at = int(rng.integers(0, data.index(b"mdat") - 4))
            b[at] = int(rng.integers(0, 256))
        else:
            at = int(rng.integers(0, len(data)))
            b = b[:at]
        b = bytes(b)
        want, got = _pil(b), _port(b)
        if want is None and isinstance(got, Exception):
            counts["both fail"] += 1
        elif want is not None and isinstance(got, ValueError) and any(
                w in str(got) for w in DECLARED):
            counts["declared refusal"] += 1
        elif want is not None and not isinstance(got, Exception) and np.array_equal(want, got):
            counts["equal"] += 1
        else:
            bad.append((k, kind, at, "Pillow fails" if want is None else "Pillow decodes",
                        repr(got)[:80] if isinstance(got, Exception) else "port decodes"))
    print(kind, counts, "disagreements", len(bad))
    assert not bad, bad[:5]
    return counts


def test_fuzz_tile_data_edits_agree_with_dav1d():
    """Single-byte edits inside the tile data: dav1d decodes most to
    garbage (the port equals it), and fails where the symbols run 15 bits
    or more past a tile's end or a 4:2:2 frame reads a vertical partition,
    as the port does."""
    counts = _fuzz("tile", 720, 26)
    assert counts["equal"] > 300 and counts["both fail"] > 30


def test_fuzz_alpha_data_edits_agree_with_dav1d():
    """libavif decodes the alpha item that ``convert("RGB")`` drops, and
    fails where dav1d fails on it; the port decodes it to fail alike."""
    counts = _fuzz("alpha", 240, 326)
    assert counts["equal"] > 150


def test_fuzz_box_edits_agree_with_libavif():
    counts = _fuzz("box", 900, 126)
    assert counts["equal"] > 200 and counts["both fail"] > 300


def test_fuzz_cuts_agree_with_libavif():
    _fuzz("cut", 150, 226)


def test_open_passes_a_bad_box_on_as_pillow_does():
    """A file type or box libavif cannot parse is Pillow's SyntaxError,
    which sends ``Image.open`` to the next plugin; the port's AVIF row
    passes the file on the same way (and no later plugin takes it)."""
    base = avif_save(scene(12, 12, 52))
    no_brand = base.replace(b"ftypavif", b"ftypmif1").replace(b"avifmif1", b"heicmif1")
    for data in (base[:40], base.replace(b"hdlr", b"hdlX"), no_brand):
        assert _pil(data) is None
        with pytest.raises(codec._NotThisFormat):
            dict((f, o) for f, _, o in codec._FORMATS)["AVIF"](data)
        with pytest.raises(ValueError, match="not a JPEG, PNG"):
            codec.decode(data)


def test_no_av1_library_is_loaded():
    """A decode on a host without Pillow loads no AV1, AVIF or YUV library:
    the tables are the committed constants."""
    code = f"""
import sys
sys.modules["PIL"] = None
sys.path.insert(0, {ROOT!r})
from qwen_image_edit_streamdiffusion_tpu_torch.core import codec
with open({os.path.join(FIXTURES, "avif_420_odd.avif")!r}, "rb") as f:
    out = codec.decode(f.read())
maps = open("/proc/self/maps").read()
bad = [n for n in ("libaom", "libdav1d", "libavif", "libyuv", "_avif") if n in maps]
print(out.shape, bad, "jax" in sys.modules)
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["(29,", "45,", "3)", "[]", "False"], res.stdout
