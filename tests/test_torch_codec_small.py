"""The port's codec on the small formats Pillow opens (``core/codec.py`` over
``csrc/host/raster.cc`` and ``bcn.cc``) against Pillow 12.1, which the JAX
package's ``core/imaging.py`` opens every upload with (``Image.open`` →
``ImageOps.exif_transpose`` → ``convert("RGB")``).

Each case must equal Pillow's bytes exactly: SUN (depths 1, 4, 8, 24 and
32, colour maps, rows padded to 16 bits, raw types and RLE), MSP (version 1
raw, version 2's row map and runs), XBM (the header on its first 512 bytes,
the hex bytes), XPM (P and RGB, any characters a pixel), ICNS (the size
``bestsize()`` picks, RLE24 with its mask, PNG members) and DDS (the first
surface: RGB by its masks, luminance, an 8-bit palette, DX10 RGBA, and the
blocks BC1-BC5, BC5S and BC7). The format is the one ``Image.open`` finds,
in its plugins' order. Files come from Pillow's ``save`` where it writes
the format, else from ``scripts/codec_fixtures.py``'s writers. Random
blocks of each BC kind, where every bit pattern is a block, are held to
Pillow's ``bcn`` decoder (BC6H's in ``tests/test_torch_codec_lab.py``);
damaged, cut and bomb files raise a
``ValueError`` naming the format where Pillow raises; a fuzz of each format
counts every disagreement.
"""

import functools
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
from codec_fixtures import (bc1_blocks, bc7_blocks, dds_file, icns_file,  # noqa: E402
                            icns_rle24, msp_file, scene, small_fixtures, sun_file, xbm_file,
                            xpm_file)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "codec")
SUN_MAGIC = b"\x59\xa6\x6a\x95"


def _pil(data: bytes) -> np.ndarray:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # an XPM's transparency expressed in bytes
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


def _save(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


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


def _set(data: bytes, at: int, patch: bytes) -> bytes:
    return data[:at] + patch + data[at + len(patch):]


def _sun_head(w, h, depth, ftype, plen=0, ptype=1) -> bytes:
    return struct.pack(">8I", 0x59A66A95, w, h, depth, 0, ftype, ptype if plen else 0, plen)


def _msp(words, body=b"") -> bytes:
    """An MSP header of the 16 ``words`` (the checksum word 12 set)."""
    words = list(words) + [0] * (16 - len(words))
    words[12] = 0
    words[12] = int(np.bitwise_xor.reduce(np.array(words)))
    return struct.pack("<16H", *words) + body


def _lins(w, h, rows) -> bytes:
    """An MSP version 2 file of ``rows``, each row's packet bytes."""
    head = _msp([*struct.unpack("<2H", b"LinS"), w, h, 1, 1, 1, 1, w, h])
    return head + struct.pack(f"<{h}H", *map(len, rows)) + b"".join(rows)


XBM_HEAD = b"#define t_width %d\n#define t_height %d\nstatic char t_bits[] = {\n"
DDS_RGB, DDS_LUM, DDS_PAL, DDS_FOURCC, DDS_ALPHA = 0x40, 0x20000, 0x20, 0x4, 0x1


# ---------------------------------------------------------------------------
# The cases: {format: {name: bytes}}
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _cases() -> dict:
    rng = np.random.default_rng(21)
    rgb = scene(23, 29, 3)
    rgb[5:12, 4:20] = rgb[5, 4]  # runs for the RLE codings
    gray = rgb[..., 0]
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    bits = gray > 100
    sun = {}
    for ft in (0, 1, 2, 3, 4, 5):
        for dep in ((1, 4, 8, 24, 32) if ft in (1, 2, 3) else (8, 24)):
            px = {1: bits, 4: gray >> 4, 8: gray, 24: rgb, 32: rgb}[dep]
            sun[f"type{ft}_depth{dep}"] = sun_file(px, dep, ft)
    for ft in (1, 2):
        sun[f"palette8_type{ft}"] = sun_file(gray >> 2, 8, ft, palette=pal[:64])
        sun[f"palette4_type{ft}"] = sun_file(gray >> 4, 4, ft, palette=pal[:16])
    sun.update({
        "palette_256": sun_file(gray, 8, 1, palette=pal),
        "palette_of_300": sun_file(gray, 8, 1, palette=np.tile(pal, (2, 1))[:300]),
        "palette_of_none": _sun_head(5, 3, 8, 1, plen=2) + b"\x01\x02" + bytes(range(18)),
        "palette_on_24_bits": sun_file(rgb, 24, 1, palette=pal[:8]),
        "palette_on_1_bit": sun_file(bits, 1, 1, palette=pal[:2]),
        "rle_0x80": sun_file(np.array([[0x80, 1, 0x80, 0x80, 3, 0x80, 0x80, 0x80, 9]], np.uint8),
                             8, 2),
        "rle_run_across_rows": _sun_head(5, 3, 8, 2) + b"\x80\x0b\x07\x01\x02\x80\x00",
        "rle_run_past_the_image": _sun_head(5, 2, 8, 2) + b"\x80\xff\x07",
        "rle_short": _sun_head(5, 3, 8, 2) + b"\x80\x05\x07\x01",
        "raw_last_row_unpadded": _sun_head(3, 2, 8, 1) + bytes([1, 2, 3, 4, 5, 6, 7]),
        "raw_short": _sun_head(3, 2, 8, 1) + bytes([1, 2, 3, 4, 5, 6]),
        "depth_16_unidentified": _sun_head(3, 2, 16, 1) + bytes(12),
        "type_6_unidentified": _sun_head(3, 2, 8, 6) + bytes(8),
    })
    msp = {"v1": msp_file(bits, 1), "v2": msp_file(bits, 2),
           "pillow_v1": _save(Image.fromarray(bits), "MSP"),
           "v2_noise": msp_file(rng.integers(0, 2, (17, 40)).astype(bool), 2)}
    msp.update({
        # an empty row is white; runs and literals need not fill their row
        "v2_rows_spill_and_blank": _lins(29, 4, [b"\x00\x07\x0f", b"", b"\x02\xaa\x55",
                                                  b"\x00\x02\x33\x01\x44"]),
        "v2_run_of_none": _lins(29, 2, [b"\x00\x00\x11\x00\x08\xf0", b"\x00\x04\xcc"]),
        "v2_literal_cut_by_its_row": _lins(29, 2, [b"\x09\x01\x02", b"\x00\x08\x0f"]),
        "v2_run_cut_by_its_row": _lins(29, 2, [b"\x00\x04\x0f\x00\x02", b"\x00\x04\x0f"]),
        "v2_not_enough_data": _lins(29, 2, [b"\x00\x04\x0f", b"\x00\x03\x0f"]),
        "v2_row_past_the_file": _lins(29, 2, [b"\x00\x04\x0f", b"\x00\x04\x0f"])[:-1],
        "v2_row_map_short": _msp([*struct.unpack("<2H", b"LinS"), 29, 9]) + bytes(5),
        "v1_short": msp_file(bits, 1)[:-3],
        "bad_checksum_unidentified": _set(msp_file(bits, 1), 24, b"\x01\x00"),
        "v2_extra_rows_data": _lins(29, 1, [b"\x00\x10\x0f"]),
    })
    xbm = {
        "writer": xbm_file(bits), "writer_hotspot": xbm_file(bits, (3, 4)),
        "pillow": _save(Image.fromarray(bits), "XBM"),
        "pillow_hotspot": _save(Image.fromarray(bits), "XBM", hotspot=(1, 2)),
        "one_digit_and_upper_case": XBM_HEAD % (8, 3) + b"0x1, 0XAb, 0xF, 0xaB};\n",
        "not_hex_reads_0": XBM_HEAD % (8, 3) + b"0xg1,0x,0x 2,0x7z};",
        "x_in_a_comment": b"  \n#define a_width 9\n#define a_height 2\n/* x1 */ s_bits[] = "
                          b"{ 0xff, 0x01, 0x80, 0x7f };",
        "crlf_and_last_bits": b"#define b_width 4\r\n#define b_height 2\r\n#define b_x_hot 1\r\n"
                              b"#define b_y_hot 1\r\nchar b_bits[] = {0x01};\nchar c_bits[] = "
                              b"{0x0f, 0x05};",
        "short": XBM_HEAD % (16, 3) + b"0x01, 0x02, 0x03",
        "header_past_512_unidentified": b"#define t_width 8\n" + b" " * 600
                                        + b"#define t_height 1\nt_bits[] = {0x01};",
    }
    idx32 = (gray >> 3).astype(np.int64)
    xpm = {
        "palette": xpm_file(idx32, pal[:32]),
        "palette_none_unused": xpm_file(idx32, pal[:32], transparent=True),
        "palette_no_pixels_comment": xpm_file(idx32, pal[:32], pixels_comment=False),
        "rgb_300_colours": xpm_file(rng.integers(0, 300, (9, 11)),
                                    rng.integers(0, 256, (300, 3)).astype(np.uint8)),
        "rgb_none_unused": xpm_file(rng.integers(0, 300, (9, 11)),
                                    rng.integers(0, 256, (300, 3)).astype(np.uint8),
                                    transparent=True),
        "three_chars": xpm_file(idx32, pal[:32], cpp=3),
        "nine_chars": xpm_file(idx32, pal[:32], cpp=9),
        "pillow_tests_style": (b'/* XPM */\nstatic char *x[] = {\n/* values */\n"4 2 3 1",\n'
                               b'" c None",\n".\tc #ff0000",\n"+ s a c #00FF00 s b",\n'
                               b'"..++",\n"+.+.",\n};\n'),
        "none_used": b'/* XPM */\n"2 1 2 1",\n"a c #102030",\n"b c None",\n"ab",\n',
        "colour_name": b'/* XPM */\n"2 1 2 1",\n"a c #102030",\n"b c red",\n"ab",\n',
        "48_bit_and_signed": b'/* XPM */\n"2 1 2 1",\n"a c #1234567890ab",\n"b c #-1",\n"ab",\n',
        "missing_colour": b'/* XPM */\n"2 1 2 1",\n"a c #102030",\n"b s x",\n"ab",\n',
        "c_without_colour_unidentified": b'/* XPM */\n"2 1 1 1",\n"a c",\n"aa",\n',
        "rows_of_any_length": b'/* XPM */\n"3 2 2 1",\n"a c #102030",\n"b c #405060",\n'
                              b'"abab",\n"ba"\n',
        "key_cut": b'/* XPM */\n"2 2 2 2",\n"aa c #102030",\n"bb c #405060",\n"aabbb"\n"aa"\n',
        "short": b'/* XPM */\n"2 2 1 1",\n"a c #102030",\n"aa",\n',
        "empty_value": b'/* XPM */\n"2  1 1",\n"a c #102030",\n"aa",\n',
        "no_values_unidentified": b"/* XPM */\nstatic char *x[] = {\n};\n",
    }
    small, s32, s48 = scene(16, 16, 4), scene(32, 32, 5), scene(48, 48, 6)
    sq = scene(128, 128, 7) // 16 * 16
    png16 = _save(Image.fromarray(small), "PNG")
    exif = Image.Exif()
    exif[0x0112] = 6
    icns = {
        "is32_s8mk": icns_file([(b"is32", icns_rle24(small)), (b"s8mk", bytes(256))]),
        "il32_l8mk": icns_file([(b"il32", icns_rle24(s32)), (b"l8mk", bytes(1024)),
                                (b"is32", icns_rle24(small))]),
        "ih32_h8mk": icns_file([(b"ih32", icns_rle24(s48)), (b"h8mk", bytes(48 * 48))]),
        "it32_t8mk": icns_file([(b"it32", bytes(4) + icns_rle24(sq)), (b"t8mk", bytes(1 << 14))]),
        "raw_rgb_member": icns_file([(b"is32", small.tobytes())]),
        "rgb_without_mask": icns_file([(b"il32", icns_rle24(s32))]),
        "png_icp4": icns_file([(b"icp4", png16)]),
        "png_ic07_over_it32": icns_file([(b"it32", bytes(4) + icns_rle24(sq)),
                                         (b"ic07", _save(Image.fromarray(sq[::-1]), "PNG"))]),
        "png_ic11_retina": icns_file([(b"ic11", _save(Image.fromarray(s32), "PNG")),
                                      (b"is32", icns_rle24(small))]),
        "png_smaller_than_its_slot": icns_file([(b"ic07", _save(Image.fromarray(s32), "PNG"))]),
        "png_of_no_slot_size": icns_file([(b"icp5", _save(Image.fromarray(scene(20, 16, 9)),
                                                           "PNG"))]),
        "png_of_a_smaller_slot_size": icns_file([(b"icp5", _save(Image.fromarray(small[:, :12]),
                                                                  "PNG"))]),
        "png_gray_palette": icns_file([(b"icp4", _save(Image.fromarray(small).quantize(7),
                                                        "PNG"))]),
        "png_orientation_dropped": icns_file([(b"icp4", _save(Image.fromarray(small), "PNG",
                                                               exif=exif))]),
        "later_member_wins": icns_file([(b"is32", icns_rle24(small[::-1])),
                                        (b"is32", icns_rle24(small))]),
        "mask_without_image": icns_file([(b"t8mk", bytes(1 << 14)), (b"is32", icns_rle24(small))]),
        "it32_prefix_not_zero": icns_file([(b"it32", b"\0\0\0\1" + icns_rle24(sq))]),
        "rle_channel_overruns": icns_file([(b"is32", b"\xff\x07" * 3 + icns_rle24(small))]),
        "rle_short": icns_file([(b"is32", icns_rle24(small)[:-9])]),
        "mask_short": icns_file([(b"is32", icns_rle24(small)), (b"s8mk", bytes(200))]),
        "unknown_member": icns_file([(b"icp4", b"GIF89a" + bytes(30))]),
        "pillow": _save(Image.fromarray(scene(64, 64, 8)), "ICNS"),
        "no_icons_unidentified": icns_file([(b"TOC ", bytes(8))]),
    }
    blocks = rng.integers(0, 256, 8 * 6 * 16, np.uint8).tobytes()  # 29 x 23 at 16 bytes
    masks = {"565": (16, (0xF800, 0x7E0, 0x1F, 0)), "888": (24, (0xFF0000, 0xFF00, 0xFF, 0)),
             "8888_alpha": (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
             "odd_masks": (16, (0b11, 0b1100, 0xFF00, 0)), "zero_mask": (16, (0, 0xFF, 0xF00, 0)),
             "bgr_24": (24, (0xFF, 0xFF00, 0xFF0000, 0)), "high_bit": (32, (0x80000000, 1, 6, 0))}
    dds = {}
    for fmt in ("DXT1", "DXT3", "DXT5", "BC2", "BC3", "BC5"):
        dds[f"pillow_{fmt}"] = _save(Image.fromarray(rgb), "DDS", pixel_format=fmt)
    for m in ("RGB", "RGBA", "L", "LA"):
        dds[f"pillow_{m}"] = _save(Image.fromarray(rgb).convert(m), "DDS")
    for name, (bc, mk) in masks.items():
        n = 29 * 23 * bc // 8
        dds[f"rgb_{name}"] = dds_file(29, 23, rng.integers(0, 256, n, np.uint8).tobytes(),
                                      DDS_RGB | (DDS_ALPHA if mk[3] else 0), bitcount=bc, masks=mk)
    dds.update({
        "rgb_short_reads_zeros": dds_file(29, 23, bytes(range(200)), DDS_RGB, bitcount=24,
                                          masks=masks["888"][1]),
        "rgb_bitcount_0": dds_file(5, 3, b"", DDS_RGB, bitcount=0, masks=masks["888"][1]),
        "rgb_bitcount_huge": dds_file(5, 3, bytes(range(40)), DDS_RGB, bitcount=1 << 20,
                                      masks=masks["888"][1]),
        "writer_bc1": dds_file(29, 23, bc1_blocks(rgb), DDS_FOURCC, b"DXT1"),
        "writer_bc7": dds_file(29, 23, bc7_blocks(rgb), DDS_FOURCC, dxgi=98),
        "luminance_8": dds_file(29, 23, gray.tobytes(), DDS_LUM, bitcount=8),
        "luminance_alpha_16": dds_file(29, 23, rng.integers(0, 256, 29 * 23 * 2,
                                                            np.uint8).tobytes(),
                                       DDS_LUM | DDS_ALPHA, bitcount=16),
        "luminance_16_without_alpha": dds_file(29, 23, bytes(29 * 23 * 2), DDS_LUM, bitcount=16),
        "palette": dds_file(29, 23, gray.tobytes(), DDS_PAL,
                            palette=rng.integers(0, 256, 1024, np.uint8).tobytes()),
        "palette_cut": dds_file(29, 23, b"", DDS_PAL, palette=bytes(300)),
        "mipmaps_after_the_first_surface": dds_file(29, 23, bc1_blocks(rgb) + bytes(99),
                                                    DDS_FOURCC, b"DXT1"),
        "blocks_short": dds_file(29, 23, blocks[:-1], DDS_FOURCC, dxgi=98),
        "header_size_100": _set(dds_file(4, 4, bytes(64), DDS_FOURCC, dxgi=98), 4, b"\x64"),
        "header_cut": dds_file(4, 4, b"", DDS_FOURCC, b"DXT1")[:90],
        "dx10_header_cut_unidentified": dds_file(4, 4, b"", DDS_FOURCC, b"DX10")[:130],
        "no_pixel_format": dds_file(4, 4, bytes(64), 0),
        "dxt2": dds_file(4, 4, bytes(64), DDS_FOURCC, b"DXT2"),
        "bc4_signed_fourcc": dds_file(4, 4, bytes(64), DDS_FOURCC, b"BC4S"),
        "zero_width_unidentified": dds_file(0, 4, bytes(64), DDS_FOURCC, b"DXT1"),
    })
    for dxgi in (27, 28, 29):
        dds[f"dx10_rgba_{dxgi}"] = dds_file(29, 23, rng.integers(0, 256, 29 * 23 * 4,
                                                                 np.uint8).tobytes(),
                                            DDS_FOURCC, dxgi=dxgi)
    for dxgi in (70, 71, 73, 74, 76, 77, 79, 80, 82, 83, 84, 97, 98, 99):
        dds[f"dx10_blocks_{dxgi}"] = dds_file(29, 23, blocks, DDS_FOURCC, dxgi=dxgi)
    for cc in (b"DXT1", b"DXT3", b"DXT5", b"BC4U", b"ATI1", b"BC5U", b"ATI2", b"BC5S"):
        dds[f"fourcc_{cc.decode()}"] = dds_file(29, 23, blocks, DDS_FOURCC, cc)
    for dxgi in (2, 72, 81, 87):
        dds[f"dx10_unimplemented_{dxgi}"] = dds_file(4, 4, bytes(64), DDS_FOURCC, dxgi=dxgi)
    return {"SUN": sun, "MSP": msp, "XBM": xbm, "XPM": xpm, "ICNS": icns, "DDS": dds}


CASE_IDS = [f"{fmt}-{name}" for fmt, cases in _cases().items() for name in cases]


def _case(case_id: str) -> bytes:
    fmt, name = case_id.split("-", 1)
    return _cases()[fmt][name]


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_formats_match_pillow(case_id):
    """Pillow's pixels, or a ValueError where Pillow raises; and the format
    ``Image.open`` names (none where no plugin takes the file)."""
    data = _case(case_id)
    want = _pil_or_none(data)
    if want is None:
        with pytest.raises(ValueError):
            codec.decode(data)
    else:
        got = codec.decode(data)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert _port_format(data) == _pil_format(data)


def test_only_the_cases_meant_to_fail_fail():
    """The cases above that Pillow refuses are the ones meant to be refused
    (by name where the file is only unidentified); every other case
    decodes."""
    refused = sorted(c for c in CASE_IDS if _pil_or_none(_case(c)) is None)
    assert refused == sorted([
        "SUN-palette_of_300", "SUN-palette_on_24_bits", "SUN-palette_on_1_bit",
        "SUN-rle_short", "SUN-raw_short", "SUN-depth_16_unidentified",
        "SUN-type_6_unidentified",
        "MSP-v2_run_cut_by_its_row", "MSP-v2_not_enough_data", "MSP-v2_row_past_the_file",
        "MSP-v2_row_map_short", "MSP-v1_short", "MSP-bad_checksum_unidentified",
        "XBM-short", "XBM-header_past_512_unidentified",
        "XPM-none_used", "XPM-colour_name", "XPM-missing_colour",
        "XPM-c_without_colour_unidentified", "XPM-key_cut", "XPM-short", "XPM-empty_value",
        "XPM-no_values_unidentified",
        "ICNS-png_of_no_slot_size", "ICNS-mask_without_image", "ICNS-it32_prefix_not_zero",
        "ICNS-rle_channel_overruns", "ICNS-rle_short", "ICNS-mask_short",
        "ICNS-unknown_member", "ICNS-no_icons_unidentified",
        "DDS-luminance_16_without_alpha", "DDS-palette_cut", "DDS-blocks_short",
        "DDS-header_size_100", "DDS-header_cut", "DDS-dx10_header_cut_unidentified",
        "DDS-no_pixel_format", "DDS-dxt2", "DDS-bc4_signed_fourcc",
        "DDS-zero_width_unidentified", "DDS-dx10_unimplemented_2", "DDS-dx10_unimplemented_72",
        "DDS-dx10_unimplemented_81", "DDS-dx10_unimplemented_87"]), refused


def test_icns_png_keeps_no_orientation():
    """An icon's PNG member with an EXIF orientation decodes unrotated (the
    icon copies none of its info), while the PNG alone is rotated."""
    exif = Image.Exif()
    exif[0x0112] = 6
    png = _save(Image.fromarray(scene(16, 16, 2)[:, ::-1]), "PNG", exif=exif)
    data = icns_file([(b"icp4", png)])
    np.testing.assert_array_equal(codec.decode(data), _pil(data))
    assert not np.array_equal(codec.decode(data), codec.decode(png))


# ---------------------------------------------------------------------------
# Random blocks of each BC kind, against Pillow's bcn decoder
# ---------------------------------------------------------------------------

# (name, FourCC or DXGI format, blocks): at least 1024 of each kind, 4096
# of BC7 (every mode, forced in turn, and the mode byte of no set bit)
BLOCK_KINDS = [("BC1", b"DXT1", 1024), ("BC2", b"DXT3", 1024), ("BC3", b"DXT5", 1024),
               ("BC4", b"ATI1", 1024), ("BC5", b"ATI2", 1024), ("BC5S", b"BC5S", 1024),
               ("BC7", 98, 4608)]


@pytest.mark.parametrize("kind,code,count", BLOCK_KINDS, ids=[k[0] for k in BLOCK_KINDS])
def test_random_blocks_match_pillow(kind, code, count):
    """``count`` random blocks at seed 21 in one 128-pixel-wide surface:
    each block's 16 pixels equal Pillow's, every disagreement counted."""
    rng = np.random.default_rng(21)
    size = 8 if kind in ("BC1", "BC4") else 16
    raw = rng.integers(0, 256, (count, size), np.uint8)
    if kind == "BC7":  # modes 0-7 and 8 (no mode bit) in turn
        mode = np.arange(count) % 9
        low = np.where(mode < 8, 1 << np.minimum(mode, 7), 0)
        raw[:, 0] = np.where(mode < 8, (raw[:, 0].astype(np.int64) << (mode + 1) | low) & 0xFF, 0)
    w, h = 128, count // 32 * 4
    data = dds_file(w, h, raw.tobytes(), DDS_FOURCC, *((code,) if isinstance(code, bytes)
                                                       else (b"\0" * 4, 0, (0,) * 4, code)))
    want, got = _pil(data), codec.decode(data)
    bad = (want != got).reshape(h // 4, 4, w // 4, 4, 3).any(axis=(1, 3, 4))
    assert not bad.any(), f"{int(bad.sum())} of {count} {kind} blocks disagree"
    if kind == "BC7":
        assert set(mode) == set(range(9))


def test_bc7_every_mode_is_reached():
    """Each mode's blocks differ from the no-mode block's opaque black,
    and a mode's block differs when one of its index bits changes."""
    rng = np.random.default_rng(21)
    for m in range(8):
        block = rng.integers(0, 256, 16, np.uint8)
        block[0] = (int(block[0]) << (m + 1) | 1 << m) & 0xFF
        other = block.copy()
        other[15] ^= 0x80  # the last index's top bit
        a, b = (codec.decode(dds_file(4, 4, x.tobytes(), DDS_FOURCC, dxgi=98)) for x in
                (block, other))
        np.testing.assert_array_equal(a, _pil(dds_file(4, 4, block.tobytes(), DDS_FOURCC,
                                                       dxgi=98)))
        assert not np.array_equal(a, b), m


# ---------------------------------------------------------------------------
# What the port keeps refused, by name
# ---------------------------------------------------------------------------


def test_kept_refusals_are_named():
    """BC6H (unsigned and signed), once refused here by name, decodes to
    Pillow's pixels (every mode: ``tests/test_torch_codec_lab.py``); BC6H's
    typeless format (DXGI 94), which Pillow does not implement, raises in
    both, the port naming DDS and the format. An ICNS JPEG 2000 member, once
    refused here too, decodes to Pillow's pixels
    (``test_icns_jpeg2000_member``)."""
    rng = np.random.default_rng(21)
    for dxgi in (95, 96):
        data = dds_file(8, 8, rng.integers(0, 256, 64, np.uint8).tobytes(), DDS_FOURCC, dxgi=dxgi)
        np.testing.assert_array_equal(codec.decode(data), _pil(data))
    data = dds_file(8, 8, rng.integers(0, 256, 64, np.uint8).tobytes(), DDS_FOURCC, dxgi=94)
    assert _pil_or_none(data) is None
    with pytest.raises(ValueError, match="unsupported DDS: DXGI format 94"):
        codec.decode(data)


def test_icns_jpeg2000_member():
    """The ICNS JPEG 2000 members the refusal above used to pin, a JP2 file
    and a raw codestream, decode as Pillow's IcnsImagePlugin reads them."""
    j2k = _save(Image.fromarray(scene(16, 16, 3)), "JPEG2000")
    for member in (j2k, _save(Image.fromarray(scene(16, 16, 3)), "JPEG2000", no_jp2=True)):
        data = icns_file([(b"icp4", member)])
        np.testing.assert_array_equal(codec.decode(data), _pil(data))


@pytest.mark.parametrize("dxgi", [2, 10, 24, 72, 75, 78, 81, 87, 88, 91])
def test_unimplemented_dxgi_formats_raise_as_pillow_raises(dxgi):
    """A DXGI format Pillow does not implement: both raise, the port naming
    DDS and the format."""
    data = dds_file(4, 4, bytes(64), DDS_FOURCC, dxgi=dxgi)
    assert _pil_or_none(data) is None
    with pytest.raises(ValueError, match=f"unsupported DDS: DXGI format {dxgi}"):
        codec.decode(data)


# ---------------------------------------------------------------------------
# Damaged files and the decompression-bomb limit
# ---------------------------------------------------------------------------


def _bombs() -> dict:
    big = 60000
    return {
        "SUN": _sun_head(big, big, 8, 1),
        "MSP": _msp([*struct.unpack("<2H", b"DanM"), 65535, 65535]),
        "XBM": XBM_HEAD % (big, big) + b"0x00",
        "XPM": b'/* XPM */\n"%d %d 1 1",\n"a c #000000",\n"a"\n' % (big, big),
        "DDS": dds_file(big, big, bytes(64), DDS_FOURCC, b"DXT1"),
    }


@pytest.mark.parametrize("fmt", sorted(_bombs()))
def test_bomb_headers_raise_before_allocating(fmt):
    """A header past Pillow's decompression-bomb limit raises naming the
    format before any of the image is allocated, where Pillow raises."""
    data = _bombs()[fmt]
    assert _pil_or_none(data) is None
    tracemalloc.start()
    with pytest.raises(ValueError, match=f"unsupported {fmt}: .*decompression-bomb"):
        codec.decode(data)
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    assert peak < 1 << 20


@pytest.mark.parametrize("fmt", ["SUN", "MSP", "XBM", "XPM", "ICNS", "DDS"])
def test_cut_files_fail_where_pillow_fails(fmt):
    """Each file cut at 8 points: where Pillow refuses the cut file the port
    raises a ValueError; where Pillow decodes it, the port gives its pixels."""
    for name, data in list(_cases()[fmt].items())[::3]:
        for cut in sorted({len(data) * k // 9 for k in range(1, 9)}):
            part = data[:cut]
            want = _pil_or_none(part)
            got = _port_or_none(part)
            assert (want is None) == (got is None), (name, cut)
            if want is not None:
                np.testing.assert_array_equal(got, want, err_msg=f"{name} cut at {cut}")


# ---------------------------------------------------------------------------
# A differential fuzz of each format
# ---------------------------------------------------------------------------

FUZZ = {"SUN": 1500, "MSP": 1500, "XBM": 1200, "XPM": 1200, "ICNS": 800, "DDS": 1000}


def _fuzz_files(fmt: str) -> list:
    """The format's cases, less the few large ones (Pillow's Python
    decoders of a 128² RLE24 icon or a 64² ICNS take milliseconds)."""
    skip = {"it32_t8mk", "png_ic07_over_it32", "pillow", "it32_prefix_not_zero"}
    return [d for k, d in _cases()[fmt].items() if k not in skip]


def _mutate(data: bytes, rng) -> bytes:
    """One to four edits: a byte set, up to 7 bytes dropped, or the tail cut."""
    b = bytearray(data)
    for _ in range(int(rng.choice([1, 1, 2, 4]))):
        op = rng.random()
        if op < 0.7:
            b[int(rng.integers(len(b)))] = int(rng.integers(256))
        elif op < 0.85:
            at = int(rng.integers(len(b)))
            del b[at:at + int(rng.integers(1, 8))]
        else:
            b = b[:int(rng.integers(1, len(b) + 1))]
        b = b or bytearray(b"\x00")
    return bytes(b)


@pytest.mark.parametrize("fmt", sorted(FUZZ))
def test_fuzz_agrees_with_pillow(fmt):
    """``FUZZ[fmt]`` random edits of the format's files at seed 21: Pillow
    and the port both fail, or give equal pixels. Every disagreement
    counts; none is excused."""
    rng = np.random.default_rng(21)
    files = _fuzz_files(fmt)
    disagreements = []
    for i in range(FUZZ[fmt]):
        data = _mutate(files[i % len(files)], rng)
        want, got = _pil_or_none(data), _port_or_none(data)
        if (want is None) != (got is None) or (
                want is not None and (want.shape != got.shape or not np.array_equal(want, got))):
            disagreements.append(i)
    assert disagreements == [], f"{len(disagreements)} of {FUZZ[fmt]}: {disagreements[:10]}"


# ---------------------------------------------------------------------------
# The committed fixtures, Pillow's plugin order, the JAX path
# ---------------------------------------------------------------------------


def test_fixtures_decode_and_open_as_pillow_opens_them():
    """This slice's committed fixtures decode to their manifest's hashes
    (the card host's check) and open as ``Image.open(...).format`` names."""
    import hashlib

    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    for name in small_fixtures():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        px = codec.decode(data)
        assert hashlib.sha256(px.tobytes()).hexdigest() == manifest[name]["sha256"], name
        assert _port_format(data) == _pil_format(data) is not None, name


def test_files_that_only_the_plugin_order_tells_apart():
    """An XBM header that does not match passes the file on (no later
    plugin takes it); a SUN, ICNS or DDS file whose _open fails goes on to
    TGA, which opens it where its header reads as a TGA's."""
    rgb = scene(6, 7, 1)
    from codec_fixtures import tga_file

    tga = tga_file(rgb, 2, 24)
    cases = {
        "xbm_without_height": (b"#define t_width 8\nstatic char t_bits[] = {0x01};\n", None),
        # the SUN magic over a TGA's id length, colour map type, image type
        # and colour map spec, with a depth of 0: SUN passes it on, TGA opens it
        "sun_depth_0_then_tga": (_set(tga, 0, SUN_MAGIC) + bytes(40), None),
    }
    for label, (data, fmt) in cases.items():
        assert _pil_format(data) == fmt, label
        assert _port_format(data) == fmt, label
        if fmt is None:
            with pytest.raises(ValueError, match="not a JPEG, PNG"):
                codec.decode(data)


def test_jax_bytes_to_pil_gives_the_same_arrays():
    """The JAX ``core/imaging.py::bytes_to_pil`` on one file of each format."""
    for fmt, cases in _cases().items():
        for name, data in list(cases.items())[:2]:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                want = np.asarray(jimaging.bytes_to_pil(data))
            np.testing.assert_array_equal(codec.decode(data), want, err_msg=f"{fmt} {name}")


def test_chip_script_decode_set_rows_match_pillow():
    """The 1024² files ``chip_smoke.py`` writes for this slice (without
    Pillow) decode as Pillow decodes them, here at 64²."""
    import chip_smoke

    rows = chip_smoke.small_decode_set(64)
    assert set(rows) == {"tiff_zstd_predictor", "sun_rle", "msp_v2", "xbm", "xpm", "icns_it32",
                         "dds_rgb", "dds_rgb24", "dds_bc1", "dds_bc7"}
    for name, (data, want) in rows.items():
        got = codec.decode(data)
        np.testing.assert_array_equal(got, _pil(data), err_msg=name)
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=name)
