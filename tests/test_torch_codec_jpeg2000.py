"""The port's JPEG 2000 decoder (``core/codec.py`` over
``csrc/host/jpeg2000.cc``) against Pillow 12.1, which decodes with its
bundled OpenJPEG 2.5.4 and which the JAX package's ``core/imaging.py`` opens
every upload with (``Image.open`` → ``ImageOps.exif_transpose`` →
``convert("RGB")``).

Each case must equal Pillow's bytes exactly: every option of Pillow's
``_save`` (5/3 and 9/7, one to four components, I;16, ``signed``,
``no_jp2``, each progression, quality layers, one to six resolutions,
code-block and precinct sizes, tiles with image and tile offsets, ``mct``,
``plt``, ``comment``, the three cinema modes, whose 4K one carries a POC
marker), OpenJPEG's own files through ``scripts/codec_fixtures.py``'s
``openjpeg_encode`` (each code-block style, ROI, POC entries, 4- and 12-bit
and signed components, subsampled components), JP2 boxes built around a
codestream (sYCC, greyscale, CMYK, unknown colour spaces, palettes) and
ICNS JPEG 2000 members. What stays refused (HTJ2K, Part 2, packed packet
headers) raises naming it; a file Pillow's ``_open`` passes on goes on to
the next plugin; a bomb header raises before anything is allocated, a
header of many tiles allocates nothing for tiles no tile-part reaches, a
tile decodes when its threads cannot start. Three
fuzzes at seed 22 run Pillow in process: cut files and edits of marker
segment bytes count every disagreement and allow none, edits of packet
bodies report theirs.
"""

import hashlib
import io
import json
import os
import struct
import sys
import tracemalloc
import warnings

import numpy as np
import pytest
from PIL import Image, ImageOps

from qwen_image_edit_streamdiffusion_tpu.core import imaging as jimaging
from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
from codec_fixtures import (icns_file, jp2_file, jpeg2000_fixtures, openjpeg_encode,  # noqa: E402
                            scene, smooth_scene)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "codec")


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


def _pil_format(data: bytes):
    try:
        return Image.open(io.BytesIO(data)).format
    except Exception:  # noqa: BLE001
        return None


def _port_format(data: bytes):
    try:
        return codec._open(data)[0]
    except codec._Refused as e:
        return e.format
    except ValueError:
        return None


def _save(im: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        im.save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def _same(data: bytes) -> bool:
    """Both raise, or both decode to the same pixels."""
    a, b = _port_or_none(data), _pil_or_none(data)
    if a is None or b is None:
        return a is None and b is None
    return a.shape == b.shape and np.array_equal(a, b)


def _held(data: bytes, label: str) -> None:
    want = _pil(data)
    np.testing.assert_array_equal(codec.decode(data), want, err_msg=label)


# ---------------------------------------------------------------------------
# Pillow's _save options
# ---------------------------------------------------------------------------

RGB = scene(40, 56, 22)
SQUARE = scene(128, 128, 24)
GRAY16 = (scene(40, 56, 23)[..., 0].astype(np.uint16) * 251 + 77).astype(np.uint16)


def _option_cases() -> dict:
    im = Image.fromarray(RGB)
    rgba = Image.fromarray(np.concatenate([RGB, RGB[..., 1:2]], -1), "RGBA")
    i16 = Image.fromarray(GRAY16)
    cases = {
        "53": (im, {}),
        "97": (im, {"irreversible": True}),
        "gray": (Image.fromarray(RGB[..., 0]), {}),
        "la": (Image.fromarray(RGB[..., :2].copy(), "LA"), {}),
        "rgba": (rgba, {}),
        "cmyk": (Image.fromarray(np.concatenate([RGB, RGB[..., :1]], -1), "CMYK"), {}),
        "i16_53": (i16, {}),
        "i16_97": (i16, {"irreversible": True}),
        "signed_rgb": (im, {"signed": True}),
        "signed_gray_97": (Image.fromarray(RGB[..., 2]), {"signed": True, "irreversible": True}),
        "no_jp2": (im, {"no_jp2": True}),
        "quality_layers": (im, {"quality_layers": [40, 10, 3]}),
        "quality_db": (im, {"quality_mode": "dB", "quality_layers": [30, 40, 50],
                            "irreversible": True}),
        "codeblock_size": (im, {"codeblock_size": (16, 8)}),
        "precinct_size": (im, {"precinct_size": (16, 16), "num_resolutions": 3}),
        "tiles": (im, {"tile_size": (16, 16), "offset": (3, 5), "tile_offset": (1, 2),
                       "irreversible": True}),
        "mct_0": (im, {"mct": 0}),
        "mct_1": (im, {"mct": 1}),
        "mct_1_97": (im, {"mct": 1, "irreversible": True}),
        "plt_comment": (im, {"plt": True, "comment": "a comment"}),
    }
    for n in range(1, 7):
        cases[f"resolutions_{n}"] = (Image.fromarray(SQUARE[:64, :80]), {"num_resolutions": n})
    for prog in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        cases[f"progression_{prog}"] = (im, {"progression": prog, "precinct_size": (16, 16),
                                             "quality_layers": [30, 8], "tile_size": (32, 32),
                                             "offset": (1, 1), "num_resolutions": 3})
    for mode in ("cinema2k-24", "cinema2k-48", "cinema4k-24"):
        cases[mode] = (Image.fromarray(SQUARE), {"cinema_mode": mode})
    return cases


OPTION_CASES = _option_cases()


@pytest.mark.parametrize("label", sorted(OPTION_CASES))
def test_pillow_save_options_match_pillow(label):
    im, kw = OPTION_CASES[label]
    _held(_save(im, **kw), label)


def test_cinema4k_carries_a_poc_marker():
    """Pillow's cinema 4K file has a POC marker in its first tile-part
    header and six tile-parts of its one tile: the POC path is held to
    Pillow by the cinema cases."""
    data = _save(Image.fromarray(SQUARE), cinema_mode="cinema4k-24", no_jp2=True)
    sot = data.index(b"\xff\x90")
    (psot,) = struct.unpack_from(">I", data, sot + 6)
    assert b"\xff\x5f" in data[sot:sot + psot][:64]
    assert data[sot + 11] == 6  # TNsot


def test_a_resolution_without_packets_matches_pillow():
    """A POC whose last entry starts past the resolutions leaves the highest
    resolution without packets: OpenJPEG reconstructs one wavelet level
    fewer and writes that smaller plane packed, and Pillow reads its
    zeroed tile buffer as the whole tile's planes."""
    data = _save(Image.fromarray(SQUARE), cinema_mode="cinema4k-24", no_jp2=True)
    poc = data.index(b"\xff\x5f")
    assert data[poc + 11] == 5  # the second entry's first resolution
    for resno0 in (6, 152):
        edited = data[:poc + 11] + bytes([resno0]) + data[poc + 12:]
        _held(edited, f"resno0 {resno0}")
        assert not np.array_equal(codec.decode(edited), codec.decode(data))


# ---------------------------------------------------------------------------
# OpenJPEG's encoder: code-block styles, ROI, POC entries, precisions
# ---------------------------------------------------------------------------

PLANES = RGB.transpose(2, 0, 1)
STYLES = {"bypass": 1, "reset": 2, "termall": 4, "vertically_causal": 8,
          "predictable_termination": 16, "segmentation_symbols": 32, "bypass_termall": 5,
          "bypass_causal": 9, "all": 63}


@pytest.mark.parametrize("irreversible", [False, True], ids=["53", "97"])
@pytest.mark.parametrize("style", sorted(STYLES))
def test_code_block_styles_match_pillow(style, irreversible):
    data = openjpeg_encode(PLANES, mode=STYLES[style], irreversible=irreversible,
                           rates=(20, 5, 1), cblk=(16, 16))
    _held(data, style)


SUBSAMPLING = {
    "chroma_2x2": [(1, 1), (2, 2), (2, 2)],
    "chroma_2x1": [(1, 1), (2, 1), (2, 1)],
    "second_only": [(1, 1), (2, 2), (1, 1)],
    "third_1x2": [(1, 1), (1, 1), (1, 2)],
    "first_too": [(2, 2), (2, 2), (1, 1)],
    "first_only_3x1": [(3, 1), (1, 1), (1, 1)],
    "all_3x3": [(3, 3), (3, 3), (3, 3)],
    "rgba_alpha_2x2": [(1, 1), (1, 1), (1, 1), (2, 2)],
    "rgba_chroma_4x2": [(1, 1), (4, 2), (4, 2), (1, 1)],
}


@pytest.mark.parametrize("label", sorted(SUBSAMPLING))
def test_subsampled_components_match_pillow(label):
    """XRsiz / YRsiz above 1: OpenJPEG decodes each component on its own
    grid, Pillow's three- and four-component unpackers read each at
    ``(x // dx, y // dy)`` in planes ``w // dx`` wide (reading on past a
    row where the division leaves some over), and guess sYCC where the
    first subsampled component is 1 or 2. Odd sizes, offsets and tiles."""
    sub = SUBSAMPLING[label]
    planes = np.concatenate([PLANES, PLANES[:1]])[:len(sub)]
    odd = np.concatenate([scene(37, 53, 7).transpose(2, 0, 1)] * 2)[:len(sub)]
    for name, data in (("plain", openjpeg_encode(planes, subsampling=sub, mct=0)),
                       ("odd_offset", openjpeg_encode(odd, subsampling=sub, mct=0,
                                                      offset=(3, 5), resolutions=3)),
                       ("tiles", openjpeg_encode(planes, subsampling=sub, mct=0,
                                                 tile=(16, 16), offset=(3, 1),
                                                 resolutions=2))):
        _held(data, f"{label} {name}")
    if len(sub) == 3:
        cs = openjpeg_encode(planes, subsampling=sub, mct=0)
        for colr in (16, 18):
            _held(jp2_file(cs, 56, 40, 3, colr=colr), f"{label} colr {colr}")


def test_subsampled_gray_raises_as_pillow_raises():
    """One or two components with one subsampled: Pillow's gray unpackers
    take no subsampling, so both raise."""
    for sub in ([(2, 2)], [(1, 1), (2, 2)], [(2, 1), (1, 1)]):
        data = openjpeg_encode(PLANES[:len(sub)], subsampling=sub, mct=0)
        assert _pil_or_none(data) is None, sub
        with pytest.raises(ValueError, match="Pillow does not unpack"):
            codec.decode(data)


def test_roi_poc_and_precisions_match_pillow():
    """An RGN marker (max-shift) on either wavelet, POC entries changing
    the progression midway, 4- and 12-bit components, signed and not."""
    cases = {
        "roi_53": openjpeg_encode(PLANES, roi=(0, 5)),
        "roi_97": openjpeg_encode(PLANES, roi=(1, 7), irreversible=True, rates=(10,)),
        "poc": openjpeg_encode(PLANES, rates=(20, 5, 1), cblk=(8, 8),
                               pocs=((0, 0, 3, 3, 3, 1), (3, 0, 3, 6, 3, 4))),
        "prec4": openjpeg_encode(PLANES >> 4, prec=4),
        "prec12": openjpeg_encode(PLANES.astype(np.int32) * 16, prec=12),
        "prec12_gray": openjpeg_encode(PLANES[:1].astype(np.int32) * 16 + 7, prec=12),
        "signed12_gray": openjpeg_encode(PLANES[:1].astype(np.int32) * 16 - 2048, prec=12,
                                         signed=True, irreversible=True),
    }
    for label, data in cases.items():
        _held(data, label)


# ---------------------------------------------------------------------------
# JP2 boxes
# ---------------------------------------------------------------------------


def test_jp2_boxes_match_pillow():
    """Colour boxes (sRGB, sYCC, greyscale, CMYK, an unknown enumerated
    space or an ICC profile: decoded as unspecified), palettes (pclr + cmap:
    duplicate entries that Pillow's palette drops, an RGBA palette), and the
    colour spaces Pillow has no unpacker for, where both raise."""
    three = openjpeg_encode(PLANES, resolutions=4)
    one = openjpeg_encode(PLANES[:1], resolutions=4)
    four = openjpeg_encode(np.concatenate([PLANES, PLANES[:1]]), resolutions=4, mct=0)
    pal = np.random.default_rng(22).integers(0, 256, (256, 3))
    decoded = {
        "srgb": jp2_file(three, 56, 40, 3, colr=16),
        "sycc": jp2_file(three, 56, 40, 3, colr=18),
        "unknown_enumcs": jp2_file(three, 56, 40, 3, colr=99),
        "no_colr": jp2_file(three, 56, 40, 3),
        "icc": jp2_file(three, 56, 40, 3, colr=bytes(64)),
        "gray": jp2_file(one, 56, 40, 1, colr=17),
        "cmyk": jp2_file(four, 56, 40, 4, colr=12),
        "rgba": jp2_file(four, 56, 40, 4, colr=16),
        "sycc_alpha": jp2_file(four, 56, 40, 4, colr=18),
        "palette": jp2_file(one, 56, 40, 1, colr=16, palette=pal),
        "palette_duplicates": jp2_file(one, 56, 40, 1, colr=16,
                                       palette=np.concatenate([pal[:90], pal[:40], pal[90:]])),
        "palette_rgba": jp2_file(one, 56, 40, 1, colr=16, palette=np.random.default_rng(23)
                                 .integers(0, 256, (200, 4))),
    }
    for label, data in decoded.items():
        _held(data, label)
    for label, data in {"eycc": jp2_file(three, 56, 40, 3, colr=24),
                        "gray_of_three": jp2_file(three, 56, 40, 3, colr=17),
                        "srgb_of_one": jp2_file(one, 56, 40, 1, colr=16),
                        "palette_gray": jp2_file(one, 56, 40, 1, colr=17, palette=pal)}.items():
        assert _pil_or_none(data) is None, label
        with pytest.raises(ValueError, match="Pillow does not unpack"):
            codec.decode(data)


def test_icns_jpeg2000_members_match_pillow():
    """An ICNS icon whose member is a JPEG 2000 codestream or JP2 file
    decodes as Pillow's IcnsImagePlugin reads it (the member's bytes
    alone); a damaged member raises where Pillow raises."""
    small = Image.fromarray(scene(16, 16, 3))
    for label, member in (("jp2", _save(small)), ("j2k", _save(small, no_jp2=True)),
                          ("jp2_32", _save(Image.fromarray(scene(32, 32, 4)), irreversible=True))):
        data = icns_file([(b"icp4" if label != "jp2_32" else b"ic11", member)])
        _held(data, label)
    member = _save(small, no_jp2=True)
    for cut in (member[:-40], member[:30]):
        data = icns_file([(b"icp4", cut)])
        assert _pil_or_none(data) is None
        with pytest.raises(ValueError):
            codec.decode(data)


def test_fixtures_decode_and_open_as_pillow_opens_them():
    """This slice's committed fixtures (and the 1024² pair phase inputs
    times) decode to Pillow's pixels and their manifest's hashes, and open
    as ``Image.open(...).format`` names."""
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    names = [n for n in manifest if n.endswith((".jp2", ".j2k"))]
    assert set(jpeg2000_fixtures()) | {"rev53_1024.jp2", "irr97_1024.j2k"} == set(names)
    for name in names:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        px = codec.decode(data)
        assert hashlib.sha256(px.tobytes()).hexdigest() == manifest[name]["sha256"], name
        np.testing.assert_array_equal(px, _pil(data), err_msg=name)
        assert _port_format(data) == _pil_format(data) == "JPEG2000", name


def test_chip_script_rows_match_pillow():
    """``chip_smoke.py``'s two JPEG 2000 rows: the 5/3 JP2 decodes to its
    source, the 9/7 codestream to Pillow's pixels."""
    import chip_smoke

    rows = chip_smoke.jpeg2000_decode_set()
    assert set(rows) == {"jpeg2000_53", "jpeg2000_97"}
    for name, (data, want) in rows.items():
        got = codec.decode(data)
        np.testing.assert_array_equal(got, _pil(data), err_msg=name)
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(rows["jpeg2000_53"][1], smooth_scene(1024))


def test_jax_bytes_to_pil_gives_the_same_arrays():
    """The JAX ``core/imaging.py::bytes_to_pil`` on a JP2 and a codestream."""
    for data in (_save(Image.fromarray(RGB)), _save(Image.fromarray(RGB), no_jp2=True,
                                                    irreversible=True)):
        np.testing.assert_array_equal(codec.decode(data),
                                      np.asarray(jimaging.bytes_to_pil(data)))


# ---------------------------------------------------------------------------
# What stays refused, the plugin order, bombs
# ---------------------------------------------------------------------------


def _insert(data: bytes, segment: bytes) -> bytes:
    """``segment`` right after a codestream's SIZ."""
    at = 4 + struct.unpack_from(">H", data, 4)[0]
    return data[:at] + segment + data[at:]


def test_refusals_are_named():
    """HTJ2K (a CAP or CPF marker, or an HT code-block style), Part 2's
    multi-component transforms (MCT) and packed packet headers (PPM) raise
    naming them. Pillow decodes the CAP and CPF files; it raises on the
    others."""
    base = _save(Image.fromarray(RGB[:24, :32]), no_jp2=True)
    cod = base.index(b"\xff\x52")
    cases = {
        "CAP marker": (_insert(base, b"\xff\x50" + struct.pack(">HIH", 8, 0x20000, 0)), True),
        "CPF marker": (_insert(base, b"\xff\x59" + struct.pack(">HH", 4, 0)), True),
        "HTJ2K \\(Part 15\\) code-blocks": (base[:cod + 12] + bytes([base[cod + 12] | 0x40])
                                          + base[cod + 13:], False),
        "MCT marker": (_insert(base, b"\xff\x74" + struct.pack(">HHH", 6, 0, 0)), False),
        "PPM": (_insert(base, b"\xff\x60" + struct.pack(">HB", 3, 0)), False),
    }
    for what, (data, pillow_decodes) in cases.items():
        assert (_pil_or_none(data) is not None) == pillow_decodes, what
        with pytest.raises(ValueError, match=f"unsupported image format: JPEG2000 .*{what}"):
            codec.decode(data)


def test_rsiz_alone_refuses_nothing():
    """An Rsiz that claims Part 2 or HTJ2K over a Part 1 codestream: OpenJPEG
    decodes by the markers, and so does the port."""
    base = _save(Image.fromarray(RGB[:24, :32]), no_jp2=True)
    for rsiz in (b"\x80\x00", b"\x40\x00", b"\xc0\x03"):
        _held(base[:6] + rsiz + base[8:], rsiz.hex())


def test_files_pillow_passes_on_go_to_the_next_plugin():
    """Where Jpeg2KImagePlugin's _open raises SyntaxError (five components,
    a size of zero or less, a JP2 header without ihdr, a box shorter than
    its header) or a struct or index error, ``Image.open`` tries the next
    plugin; none takes these files, in Pillow or in the port."""
    base = _save(Image.fromarray(RGB[:24, :32]), no_jp2=True)
    jp2 = jp2_file(openjpeg_encode(PLANES[:, :24, :32], resolutions=3), 32, 24, 3, colr=16)
    jp2h = jp2.index(b"jp2h") - 4
    no_ihdr = (jp2[:jp2h] + struct.pack(">I", 8 + 15) + b"jp2h"
               + struct.pack(">I", 15) + b"colr" + struct.pack(">BBBI", 1, 0, 0, 16)
               + jp2[jp2h + struct.unpack_from(">I", jp2, jp2h)[0]:])
    cases = {
        "five_components": base[:40] + struct.pack(">H", 5) + base[42:],
        "negative_width": base[:8] + struct.pack(">I", 3) + base[12:16] + struct.pack(">I", 10)
        + base[20:],
        "jp2_without_ihdr": no_ihdr,
        "short_box": jp2[:12] + struct.pack(">I", 4) + jp2[16:],
        "short_siz": base[:30],
    }
    for label, data in cases.items():
        assert _pil_format(data) is None, label
        assert _port_format(data) is None, label
        with pytest.raises(ValueError, match="not a JPEG, PNG"):
            codec.decode(data)


def test_bomb_headers_raise_before_allocating():
    """A SIZ past Pillow's decompression-bomb limit raises naming JPEG2000
    before any of the image is allocated, where Pillow raises."""
    base = _save(Image.fromarray(RGB[:24, :32]), no_jp2=True)
    data = base[:8] + struct.pack(">II", 60000, 60000) + base[16:]
    assert _pil_or_none(data) is None
    tracemalloc.start()
    with pytest.raises(ValueError, match="unsupported JPEG2000: .*decompression-bomb"):
        codec.decode(data)
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    assert peak < 1 << 20


def test_a_many_tile_header_allocates_per_tile_state_lazily():
    """A SIZ of 65535 one-pixel tiles of four components, one empty
    tile-part and EOC: a hundred bytes. Both raise; the port keeps no coding
    parameters for tiles that no tile-part reached."""
    im, _ = OPTION_CASES["rgba"]
    base = _save(im, no_jp2=True)
    sot = base.index(b"\xff\x90")
    data = (base[:8] + struct.pack(">8I", 255, 257, 0, 0, 1, 1, 0, 0) + base[40:sot]
            + b"\xff\x90" + struct.pack(">HHIBB", 10, 0, 14, 0, 1) + b"\xff\x93\xff\xd9")
    assert _pil_or_none(data) is None
    codec.library()
    tracemalloc.start()
    with pytest.raises(ValueError, match="JPEG2000: tile 0 has no data"):
        codec.decode(data)
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    assert peak < 1 << 20


def test_a_tile_decodes_when_its_threads_cannot_start():
    """The 1024² 5/3 JP2 decoded in a process whose address space leaves
    room for one 1 GiB thread stack and not two: the code-blocks that
    threads which could not start would have taken run on the others, and
    the pixels are the manifest's (a joinable thread left behind by the
    error would abort the process)."""
    import subprocess

    codec.library()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = ("import hashlib, resource, sys\n"
              f"sys.path.insert(0, {root!r})\n"
              "from qwen_image_edit_streamdiffusion_tpu_torch.core import codec\n"
              "codec.library()\n"
              "data = sys.stdin.buffer.read()\n"
              "vm = next(int(s.split()[1]) for s in open('/proc/self/status')\n"
              "          if s.startswith('VmSize')) << 10\n"
              "resource.setrlimit(resource.RLIMIT_AS, (vm + (1536 << 20),) * 2)\n"
              "print(hashlib.sha256(codec.decode(data).tobytes()).hexdigest())\n")
    with open(os.path.join(FIXTURES, "rev53_1024.jp2"), "rb") as f:
        data = f.read()
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        want = json.load(f)["rev53_1024.jp2"]["sha256"]
    # glibc sizes a new thread's stack by RLIMIT_STACK as the process starts
    run = subprocess.run(["sh", "-c", 'ulimit -s 1048576 && exec "$0" -c "$1"', sys.executable,
                          script], input=data, capture_output=True)
    assert run.returncode == 0, run.stderr.decode()
    assert run.stdout.decode().strip() == want


# ---------------------------------------------------------------------------
# Fuzzes at seed 22, Pillow in process
# ---------------------------------------------------------------------------


def _fuzz_base() -> dict:
    rgb = RGB[:24, :32]
    planes = rgb.transpose(2, 0, 1)
    return {
        "53_jp2": _save(Image.fromarray(rgb)),
        "97_layers": _save(Image.fromarray(rgb), irreversible=True, no_jp2=True,
                           quality_layers=[20, 5]),
        "gray_tiles": _save(Image.fromarray(rgb[..., 0]), tile_size=(16, 16), offset=(1, 2),
                            num_resolutions=3),
        "mct_cprl": _save(Image.fromarray(rgb), mct=1, precinct_size=(16, 16),
                          num_resolutions=3, progression="CPRL", quality_layers=[10, 2]),
        "bypass_reset_causal": openjpeg_encode(planes, mode=1 | 2 | 8 | 32, rates=(10, 2),
                                               cblk=(16, 16), resolutions=3),
        "termall_97": openjpeg_encode(planes, mode=4 | 16, irreversible=True, rates=(8,),
                                      cblk=(8, 8), resolutions=3),
    }


def _segments(data: bytes):
    """(marker, offset of its body, body length) of every marker segment of
    the main and tile-part headers."""
    out, at = [], (0 if data[:4] == b"\xff\x4f\xff\x51" else data.index(b"jp2c") + 4) + 2
    while at + 4 <= len(data):
        marker, length = struct.unpack_from(">HH", data, at)
        if marker == 0xFFD9:
            break
        out.append((marker, at + 4, length - 2))
        if marker == 0xFF90:
            psot = struct.unpack_from(">I", data, at + 6)[0]
            j = at + 2 + length
            while struct.unpack_from(">H", data, j)[0] != 0xFF93:
                m, n = struct.unpack_from(">HH", data, j)
                out.append((m, j + 4, n - 2))
                j += 2 + n
            at = at + psot if psot else len(data)
            continue
        at += 2 + length
    return out


def _edit_offsets(data: bytes) -> dict:
    """The bytes the marker fuzz edits: Rsiz, each Ssiz, each XRsiz and
    YRsiz, the code-block style of each COD and COC, every byte of each QCD
    and QCC."""
    offs = {"rsiz": [], "ssiz": [], "subsampling": [], "cblksty": [], "quant": []}
    for marker, at, n in _segments(data):
        if marker == 0xFF51:
            offs["rsiz"] += [at, at + 1]
            count = struct.unpack_from(">H", data, at + 34)[0]
            offs["ssiz"] += [at + 36 + 3 * k for k in range(count)]
            offs["subsampling"] += [at + 37 + 3 * k + j for k in range(count) for j in (0, 1)]
        elif marker == 0xFF52:
            offs["cblksty"].append(at + 8)
        elif marker == 0xFF53:
            offs["cblksty"].append(at + 5)
        elif marker in (0xFF5C, 0xFF5D):
            offs["quant"] += list(range(at + (marker == 0xFF5D), at + n))
    return offs


def test_cut_files_agree_with_pillow():
    """Each fuzz file cut at 40 random points (seed 22): Pillow (OpenJPEG's
    strict mode) and the port both raise, or decode the same pixels."""
    rng = np.random.default_rng(22)
    bad = []
    for name, data in _fuzz_base().items():
        for cut in rng.integers(1, len(data), 40):
            if not _same(data[:int(cut)]):
                bad.append((name, int(cut)))
    assert not bad, f"{len(bad)} disagreements: {bad[:10]}"


def test_marker_edits_agree_with_pillow():
    """Random values (seed 22) in Rsiz, Ssiz (precision and sign), XRsiz
    and YRsiz (1 to 4), the code-block style byte (every bit but HTJ2K's,
    which :func:`test_refusals_are_named` pins) and the quantization bytes
    of the fuzz files: 70 edits a file, every disagreement counted."""
    rng = np.random.default_rng(22)
    bad, total = [], 0
    for name, data in _fuzz_base().items():
        offs = _edit_offsets(data)
        for k in range(70):
            field = ("rsiz", "ssiz", "subsampling", "cblksty", "quant")[k % 5]
            at = int(rng.choice(offs[field]))
            value = int(rng.integers(0, 256)) & (0xBF if field == "cblksty" else 0xFF)
            if field == "subsampling":
                value = int(rng.integers(1, 5))
            edited = data[:at] + bytes([value]) + data[at + 1:]
            total += 1
            if not _same(edited):
                bad.append((name, field, at, value))
    assert total == 420
    assert not bad, f"{len(bad)} disagreements: {bad[:10]}"


def test_packet_body_edits_are_counted():
    """One to three random bytes (seed 22) changed in the last tile-part's
    packet bodies, 40 edits a file: disagreements with Pillow are counted
    and reported (ROADMAP.md queue 3 lists each class found; none at this
    seed)."""
    rng = np.random.default_rng(22)
    bad = []
    for name, data in _fuzz_base().items():
        sod = data.rindex(b"\xff\x93") + 2
        for _ in range(40):
            edited = bytearray(data)
            for _ in range(int(rng.integers(1, 4))):
                edited[int(rng.integers(sod, len(data) - 2))] = int(rng.integers(0, 256))
            if not _same(bytes(edited)):
                bad.append(name)
    if bad:
        warnings.warn(f"JPEG 2000 packet-body fuzz: {len(bad)} of 240 edits disagree with "
                      f"Pillow ({sorted(set(bad))})")
