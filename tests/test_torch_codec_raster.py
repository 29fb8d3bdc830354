"""The port's codec on the plain raster formats Pillow opens (``core/codec.py``
over ``csrc/host/raster.cc`` and ``bmp_gif.cc``) against Pillow 12.1, which
the JAX package's ``core/imaging.py`` opens every upload with
(``Image.open`` → ``ImageOps.exif_transpose`` → ``convert("RGB")``).

Each case must equal Pillow's bytes exactly: PBM, PGM, PPM and PFM (raw and
plain, every maxval kind, Pillow's private headers), DIB, ICO and CUR
(entry choice, PNG and DIB images, masks), TGA (every mode of its table,
colour maps, RLE, the four origins), PSD (the merged image of each colour
mode, raw and PackBits), QOI, PCX and DCX (each bits x planes Pillow reads,
padded lines, the VGA palette) and SGI (raw and RLE, 8 and 16 bits). The
format is the one ``Image.open`` finds, in its plugins' order. Files come
from Pillow's ``save`` where it writes the format, else from
``scripts/codec_fixtures.py``'s writers. Damaged and cut files raise a
``ValueError`` naming the format where Pillow raises; a fuzz of each format
counts every disagreement.
"""

import functools
import io
import json
import os
import struct
import sys

import numpy as np
import pytest
from PIL import Image, ImageOps

from qwen_image_edit_streamdiffusion_tpu.core import imaging as jimaging
from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
from codec_fixtures import (bmp_file, dcx_file, dds_file, dib_entry, icon_file,  # noqa: E402
                            pcx_file, ppm_file, psd_file, psd_resource, qoi_file, scene,
                            sgi_file, tga_file)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "codec")


def _pil(data: bytes) -> np.ndarray:
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
    """The format the port takes ``data`` for (the one it decodes, or the
    one it refuses by name); None where opening it raises."""
    try:
        return codec._open(data)[0]
    except codec._Refused as e:
        return e.format
    except ValueError:
        return None


# ---------------------------------------------------------------------------
# The cases: {format: {name: bytes}}
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _cases() -> dict:
    rng = np.random.default_rng(20)
    rgb = scene(23, 29, 3)
    rgb[5:12, 4:20] = rgb[5, 4]  # runs for the RLE codings
    gray = rgb[..., 0]
    idx = (rgb[..., 0] >> 3).astype(np.uint8)
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    rgba = np.concatenate([rgb, rng.integers(0, 256, rgb.shape[:2] + (1,), np.uint8)], -1)
    wide = rng.integers(0, 1001, (7, 5, 3))
    f32 = gray.astype(np.float32) * np.float32(1.7) - np.float32(60.5)
    ppm = {
        "P4": _save(Image.fromarray(gray > 100), "PPM"),
        "P5": _save(Image.fromarray(gray), "PPM"),
        "P6": _save(Image.fromarray(rgb), "PPM"),
        "P5_65535": _save(Image.fromarray(gray.astype(np.uint16) * 257).convert("I;16"), "PPM"),
        "Pf_big_endian": _save(Image.fromarray(f32), "PPM"),
        "Pf_little_endian": b"Pf\n5 7\n-2.5\n" + rng.normal(100, 140, (7, 5)).astype("<f4").tobytes(),
        "P1_plain": _save(Image.fromarray(gray > 100), "PPM", plain=True),
        "P2_plain": _save(Image.fromarray(gray), "PPM", plain=True),
        "P3_plain": _save(Image.fromarray(rgb), "PPM", plain=True),
        "P2_plain_65535": _save(Image.fromarray(gray.astype(np.uint16) * 300).convert("I;16"),
                                "PPM", plain=True),
        "P6_maxval_1000": ppm_file(wide.astype(np.uint16), maxval=1000),
        "P6_maxval_100": b"P6 5 7 100 " + np.minimum(wide, 120).astype(np.uint8).tobytes(),
        "P5_maxval_300": ppm_file(wide[..., 0].astype(np.uint16), maxval=300),
        "P5_maxval_15": b"P5\n#c\n5 7\n15\n" + (wide[..., 0] % 20).astype(np.uint8).tobytes(),
        "P3_maxval_300_writer": ppm_file(wide.astype(np.uint16) * 300 // 1000, 300, plain=True),
        "P0CMYK": b"P0CMYK 5 7 255\n" + rng.integers(0, 256, (7, 5, 4), np.uint8).tobytes(),
        "PyCMYK_maxval_77": b"PyCMYK 5 7 77\n" + rng.integers(0, 80, (7, 5, 4), np.uint8).tobytes(),
        "PyRGBA": b"PyRGBA 5 7 255\n" + rng.integers(0, 256, (7, 5, 4), np.uint8).tobytes(),
        "PyP": b"PyP 5 7 255\n" + rng.integers(0, 256, (7, 5), np.uint8).tobytes(),
        "P3_comments_signs_underscores": (b"P3\n# a\n2 2\n300\n1 2 3 #x\n 4 5 6\r7 8#y\n"
                                          b"9 10 11 +12 1_3\n"),
        "P1_comment_and_no_whitespace": b"P1\n3 2\n1 0 1\n0#c\n11\n",
        "P1_trailing_whitespace": b"P1\n3 2\n101\n011\n  \n",
        "header_comment_joins_a_token": b"P5 3#x\n1 1 255\n" + bytes(31),
        "P6_short": b"P6\n5 7\n255\n" + bytes(50),
    }
    planes = rgb.transpose(2, 0, 1)
    psd = {}
    for comp in (0, 1):
        full = np.zeros((256, 3), np.uint8)
        full[:32] = pal[:32]
        psd.update({
            f"rgb_c{comp}": psd_file(planes, 3, compression=comp),
            f"rgba_c{comp}": psd_file(rgba.transpose(2, 0, 1), 3, compression=comp),
            f"rgb_extra_channels_c{comp}": psd_file(planes, 3, compression=comp, extra_channels=2),
            f"gray_c{comp}": psd_file(gray[None], 1, compression=comp),
            f"duotone_c{comp}": psd_file(gray[None], 8, compression=comp, colors=b"duo" * 10),
            f"multichannel_c{comp}": psd_file(gray[None], 7, compression=comp),
            f"cmyk_c{comp}": psd_file(rgba.transpose(2, 0, 1), 4, compression=comp),
            f"bitmap_c{comp}": psd_file(gray[None] > 128, 0, bits=1, compression=comp),
            f"palette_c{comp}": psd_file(idx[None], 2, compression=comp, colors=full.T.tobytes()),
            f"palette_without_colours_c{comp}": psd_file(idx[None], 2, compression=comp),
        })
    psd["resources_and_layers"] = psd_file(
        planes, 3, resources=psd_resource(1005, b"x" * 16) + psd_resource(1039, b"icc!!", b"nm"),
        layers=struct.pack(">I", 0))
    psd["bits_16_unidentified"] = psd_file(planes, 3, bits=16, compression=0)
    tga = {}
    for it in (1, 9):
        for md in (16, 24, 32):
            for fe in (0, 3):
                tga[f"colormap_type{it}_map{md}_first{fe}"] = tga_file(
                    idx, it, 8, colormap=pal[:32], first_entry=fe, map_depth=md)
    for it in (2, 10):
        for dep in (16, 24, 32):
            for fl in (0, 0x10, 0x20, 0x30):
                tga[f"rgb_type{it}_depth{dep}_origin{fl:#x}"] = tga_file(
                    rgba if dep == 32 else rgb, it, dep, flags=fl)
    for it in (3, 11):
        tga[f"gray_type{it}"] = tga_file(gray, it, 8, flags=0)
        tga[f"gray_alpha_type{it}"] = tga_file(rgba[..., [0, 3]], it, 16, image_id=b"hello")
        tga[f"gray_with_colormap_type{it}"] = tga_file(gray, it, 8, colormap=pal[:40],
                                                       map_depth=16)
    tga["bilevel"] = tga_file(gray > 128, 3, 1)
    tga["bilevel_rle_never_full"] = tga_file(gray > 128, 11, 1)
    tga["rgb_with_colormap"] = tga_file(rgb, 2, 24, colormap=pal[:5])
    tga["empty_colormap"] = tga_file(idx, 1, 8, colormap=pal[:0])
    tga["colormap_of_300"] = tga_file(idx, 1, 8, colormap=np.tile(pal, (2, 1))[:300])
    for m in ("1", "L", "LA", "P", "RGB", "RGBA"):
        im = Image.fromarray(rgba, "RGBA").convert(m) if m != "P" else Image.fromarray(rgb).quantize(50)
        for rle in (False, True):
            tga[f"pillow_{m}_rle{int(rle)}"] = _save(im, "TGA", rle=rle)
    sq, small = scene(32, 32, 5), scene(16, 16, 6)
    png = _save(Image.fromarray(sq), "PNG")
    small_png = _save(Image.fromarray(small), "PNG")
    pal16 = pal[:16]
    ico = {
        "pillow_png": _save(Image.fromarray(sq), "ICO", sizes=[(16, 16), (32, 32)]),
        "pillow_bmp": _save(Image.fromarray(sq), "ICO", sizes=[(16, 16), (32, 32)],
                            bitmap_format="bmp"),
        "pillow_bmp_palette": _save(Image.fromarray(sq).quantize(16), "ICO",
                                    sizes=[(16, 16), (32, 32)], bitmap_format="bmp"),
        "mixed_largest_lowest_depth": icon_file([
            (16, 16, 0, 1, 32, dib_entry(np.concatenate([small, small[..., :1]], -1), 32)),
            (32, 32, 0, 1, 24, dib_entry(sq, 24, mask=sq[..., 0] > 128)),
            (32, 32, 16, 1, 4, dib_entry(sq[..., 1] >> 4, 4, palette=pal16)),
            (16, 16, 0, 1, 32, small_png)]),
        "png_first": icon_file([(32, 32, 0, 1, 32, png), (16, 16, 0, 1, 32, small_png)]),
        "width_0_is_256": icon_file([(16, 16, 0, 1, 32, small_png),
                                     (0, 0, 0, 1, 32, _save(Image.fromarray(scene(256, 256, 7)),
                                                            "PNG"))]),
        "colour_count_depth": icon_file([(32, 32, 0, 1, 0, dib_entry(sq, 24)),
                                         (32, 32, 16, 1, 0, dib_entry(sq[..., 2] >> 4, 4,
                                                                      palette=pal16))]),
        "8_bit": icon_file([(32, 32, 0, 1, 8, dib_entry(sq[..., 0] >> 2, 8, palette=pal))]),
        "1_bit": icon_file([(32, 32, 2, 1, 1, dib_entry(sq[..., 0] > 128, 1, palette=pal[:2]))]),
        "cursor": icon_file([(16, 16, 0, 3, 4, dib_entry(small, 24)),
                             (32, 32, 0, 5, 6, dib_entry(sq, 24))], kind=2),
        "cursor_32_bit": icon_file([(32, 32, 0, 5, 6, dib_entry(
            np.concatenate([sq, sq[..., :1]], -1), 32))], kind=2),
        "cursor_first_entry_kept": icon_file([(32, 32, 0, 3, 4, dib_entry(sq, 24)),
                                              (64, 16, 0, 5, 6, dib_entry(small, 24))], kind=2),
        "dib_24": bmp_file(rgb, 24)[14:],
        "dib_8": bmp_file(idx, 8, palette=pal[:40])[14:],
        "dib_rle8": bmp_file(idx, 8, palette=pal[:40], compression=1)[14:],
        "dib_core_header": bmp_file(rgb, 24, header=12)[14:],
        "pillow_dib": _save(Image.fromarray(rgb).quantize(30), "DIB"),
    }
    qoi = {"pillow_rgb": _save(Image.fromarray(rgb), "QOI"),
           "pillow_rgba": _save(Image.fromarray(rgba, "RGBA"), "QOI"),
           "writer_rgb": qoi_file(rgb), "writer_rgba": qoi_file(rgba)}
    pcx = {f"bits1_planes{p}": pcx_file(idx & ((1 << p) - 1), 1, p, palette=pal16,
                                        version=2 if p == 1 else 5) for p in (1, 2, 4)}
    linear = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    pcx.update({
        "planes4_width3": pcx_file(idx[:, :3] & 15, 1, 4, palette=pal16),
        "vga_palette": pcx_file(idx, 8, 1, vga_palette=pal),
        "vga_gray_palette_is_L": pcx_file(gray, 8, 1, vga_palette=linear),
        "no_palette_is_L": pcx_file(gray, 8, 1),
        "rgb": pcx_file(rgb, 8, 3),
        "rgb_odd_stride": pcx_file(rgb, 8, 3, stride=29),
        "rgb_stride_30": pcx_file(rgb, 8, 3, stride=30),
        "dcx_first_page": dcx_file([pcx_file(rgb, 8, 3), pcx_file(gray, 8, 1)]),
    })
    for m in ("1", "L", "P", "RGB"):
        im = Image.fromarray(rgb).convert(m) if m != "P" else Image.fromarray(rgb).quantize(50)
        pcx[f"pillow_{m}"] = _save(im, "PCX")
    sgi = {}
    for rle in (False, True):
        for name, px in (("gray", gray), ("rgb", rgb), ("rgba", rgba),
                         ("gray16", gray.astype(np.uint16) * 257 + 3),
                         ("rgb16", rgb.astype(np.uint16) * 200),
                         ("rgba16", rgba.astype(np.uint16) * 255)):
            sgi[f"{name}_rle{int(rle)}"] = sgi_file(px, rle)
    sgi["dimension_1"] = sgi_file(gray[:1], True, dimension=1)
    for m in ("L", "RGB", "RGBA"):
        for bpc in (1, 2):
            sgi[f"pillow_{m}_bpc{bpc}"] = _save(Image.fromarray(rgba, "RGBA").convert(m), "SGI",
                                                bpc=bpc)
    return {"PPM": ppm, "ICO": ico, "TGA": tga, "PSD": psd, "QOI": qoi, "PCX": pcx, "SGI": sgi}


CASE_IDS = [f"{fmt}-{name}" for fmt, cases in _cases().items() for name in cases]


def _case(case_id: str) -> bytes:
    fmt, name = case_id.split("-", 1)
    return _cases()[fmt][name]


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_formats_match_pillow(case_id):
    """Pillow's pixels, or a ValueError where Pillow raises; and the format
    ``Image.open`` names."""
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
    """The few cases above that Pillow refuses are the ones meant to be
    refused; every other case decodes."""
    refused = sorted(c for c in CASE_IDS if _pil_or_none(_case(c)) is None)
    assert refused == sorted([
        "PPM-P6_short", "PSD-bits_16_unidentified",
        "TGA-bilevel_rle_never_full", "TGA-colormap_of_300", "TGA-rgb_with_colormap",
        "TGA-colormap_type1_map32_first0", "TGA-colormap_type1_map32_first3",
        "TGA-colormap_type9_map32_first0", "TGA-colormap_type9_map32_first3",
        "TGA-pillow_1_rle1"]), refused


def test_lab_psd_is_refused_by_name():
    """A Lab PSD, once refused by name here, converts through the port's
    LittleCMS arithmetic to Pillow's pixels; a 16-bit PSD, which has no
    Pillow mode, stays refused."""
    lab = psd_file(scene(8, 9, 1).transpose(2, 0, 1), 9)
    np.testing.assert_array_equal(codec.decode(lab), _pil(lab))
    with pytest.raises(ValueError, match="unsupported image format"):
        codec.decode(psd_file(scene(8, 9, 1).transpose(2, 0, 1), 3, bits=16, compression=0))


def test_icon_png_keeps_no_orientation():
    """An icon's PNG image with an EXIF orientation decodes unrotated (the
    icon copies none of its info), while the PNG alone is rotated."""
    exif = Image.Exif()
    exif[0x0112] = 6
    png = _save(Image.fromarray(scene(16, 24, 2)), "PNG", exif=exif)
    ico = icon_file([(24, 16, 0, 1, 32, png)])
    np.testing.assert_array_equal(codec.decode(ico), _pil(ico))
    assert codec.decode(ico).shape == (16, 24, 3) and codec.decode(png).shape == (24, 16, 3)


# ---------------------------------------------------------------------------
# Where Pillow raises, and the decompression-bomb limit
# ---------------------------------------------------------------------------


def _set(data: bytes, at: int, patch: bytes) -> bytes:
    return data[:at] + patch + data[at + len(patch):]


def _hostile() -> dict:
    g = scene(6, 7, 1)[..., 0]
    tga_gray = tga_file(g, 11, 8)
    return {
        "PPM": [b"P6 5 7 0\n", b"P5 5 7 65536\n", b"P6 5 7 12345678901\n", b"P2 2 1 255\n1 256\n",
                b"P2 2 1 255\n1 00000000001\n", b"P2 2 1 255\n1 -1\n", b"P2 2 1 255\n1 x\n",
                b"Pf 2 2 0\n" + bytes(16), b"Pf 2 2 nan\n" + bytes(16), b"P1 3 1\n10x\n",
                b"P6 99999 99999 255\n"],
        "TGA": [tga_file(g, 11, 8)[:18] + bytes([0x87, 1]) * 10,  # a run across a row
                _set(tga_gray, 2, b"\x01"),  # colour-mapped without a colour map
                tga_file(g, 1, 8, colormap=np.zeros((4, 3)), map_depth=32),
                _set(tga_gray, 12, struct.pack("<HH", 65535, 65535))],
        "PSD": [_set(psd_file(g[None], 1, compression=0), 26 + 12, b"\x00\x02"),
                psd_file(np.zeros((2, 2, 2), np.uint8), 3),  # 2 channels for RGB
                _set(psd_file(g[None], 1, compression=0), 14, struct.pack(">II", 60000, 60000))],
        "SGI": [_set(sgi_file(g), 10, b"\x00\x02"), _set(sgi_file(g), 2, b"\x02"),
                _set(sgi_file(g), 512, b"\x00\x00\x01\x00"),
                _set(sgi_file(g), 6, struct.pack(">HH", 65535, 65535))],
        "PCX": [_set(pcx_file(g, 8, 1), 3, b"\x04"),
                _set(pcx_file(g, 8, 1), 8, struct.pack("<HH", 65534, 65534)),
                pcx_file(g, 8, 1)[:128] + bytes([0xFF, 7]) * 20],
        "QOI": [qoi_file(scene(6, 7, 1))[:30],
                b"qoif" + struct.pack(">II", 60000, 60000) + b"\x03\x00" + bytes(8)],
        "ICO": [icon_file([(32, 32, 0, 1, 24, dib_entry(scene(32, 32, 1), 24))])[:-40],
                icon_file([(16, 16, 0, 1, 32, dib_entry(scene(16, 16, 1), 24)[:-200])])],
    }


@pytest.mark.parametrize("fmt", sorted(_hostile()))
def test_damaged_files_raise_where_pillow_raises(fmt):
    """Bad maxvals, tokens and scales, runs past a row or line, colour maps
    Pillow cannot apply, unknown compressions and modes, rows outside the
    file, masks and data cut short, headers past the decompression-bomb
    limit (refused before anything is allocated): Pillow raises, and the
    port raises a ValueError naming the format."""
    for data in _hostile()[fmt]:
        assert _pil_or_none(data) is None, data[:40]
        with pytest.raises(ValueError, match=fmt if fmt != "ICO" else "ICO|CUR|DIB"):
            codec.decode(data)


@pytest.mark.parametrize("fmt", ["PPM", "ICO", "TGA", "PSD", "QOI", "PCX", "SGI"])
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

FUZZ = {"PPM": 2000, "ICO": 1500, "TGA": 3000, "PSD": 2000, "QOI": 1000, "PCX": 2000,
        "SGI": 2500}


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
    """``FUZZ[fmt]`` random edits of the format's files at seed 20: Pillow and
    the port both fail, or give equal pixels. Every disagreement counts;
    none is excused."""
    rng = np.random.default_rng(20)
    files = list(_cases()[fmt].values())
    disagreements = []
    for i in range(FUZZ[fmt]):
        data = _mutate(files[i % len(files)], rng)
        want, got = _pil_or_none(data), _port_or_none(data)
        if (want is None) != (got is None) or (
                want is not None and (want.shape != got.shape or not np.array_equal(want, got))):
            disagreements.append(i)
    assert disagreements == [], f"{len(disagreements)} of {FUZZ[fmt]}: {disagreements[:10]}"


# ---------------------------------------------------------------------------
# Pillow's plugin order
# ---------------------------------------------------------------------------


def _order_cases() -> dict:
    """Files that only the plugin order tells apart."""
    rgb = scene(9, 11, 4)
    tga_rgb = tga_file(rgb, 2, 24, image_id=b"0123456789")
    # a 10-byte image id and image type 2: PCX's _accept takes it, its
    # bounding box (xmax < xmin) fails its _open, and TGA opens it
    pcx_then_tga = _set(tga_rgb, 4, struct.pack("<HHHH", 5, 0, 1, 0))
    # a cursor with no entries: CUR's _open fails (TypeError), TGA opens it
    cur_then_tga = b"\0\0\2\0\0\0" + tga_file(rgb, 2, 24)[6:]
    # a TGA with "PCD_" 2048 bytes in: Pillow opens it as PhotoCD
    big = tga_file(scene(40, 40, 5), 2, 24)
    pcd = _set(big, 2048, b"PCD_")
    # a colour-mapped TGA with a 28-byte id is read by IPTC's _open first
    iptc_then_tga = tga_file((rgb[..., 0] >> 4), 1, 8, colormap=scene(4, 4, 1).reshape(16, 3),
                             image_id=bytes(28))
    return {
        "DIB": (bmp_file(rgb, 24)[14:], "DIB"),
        "PCX_open_fails_TGA_opens": (pcx_then_tga, "TGA"),
        "CUR_open_fails_TGA_opens": (cur_then_tga, "TGA"),
        "PCD_before_TGA": (pcd, "PCD"),
        "IPTC_open_fails_TGA_opens": (iptc_then_tga, "TGA"),
        "DDS": (_save(Image.fromarray(rgb), "DDS"), "DDS"),
        "XBM_after_TGA": (_save(Image.fromarray(rgb).convert("1"), "XBM"), "XBM"),
        # a BC6H surface (refused by name until the port decoded BC6H)
        "DDS_BC6H": (dds_file(11, 9, bytes(16 * 9), 4, dxgi=95), "DDS"),
        "JPEG2000": (_save(Image.fromarray(rgb), "JPEG2000"), "JPEG2000"),
        "IM": (_save(Image.fromarray(rgb), "IM"), "IM"),
        "SPIDER": (_save(Image.fromarray(rgb).convert("F"), "SPIDER"), "SPIDER"),
    }


def test_format_follows_pillows_plugin_order():
    """Every committed fixture, old and new, and the files above open as
    the format ``Image.open(...).format`` names, those the port decodes to
    Pillow's pixels, those Pillow cannot load (a PCD cut short) raising
    naming their format; a DDS of BC6H blocks opens as DDS and never
    reaches TGA; a file whose _open a plugin fails goes on to the next
    plugin."""
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        names = list(json.load(f))
    for name in names:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        assert _port_format(data) == _pil_format(data), name
    for label, (data, fmt) in _order_cases().items():
        assert _pil_format(data) == fmt, label
        assert _port_format(data) == fmt, label
        want = _pil_or_none(data)
        if want is None:
            with pytest.raises(ValueError, match=fmt):
                codec.decode(data)
        else:
            np.testing.assert_array_equal(codec.decode(data), want, err_msg=label)


def test_refused_formats_never_reach_a_later_decoder():
    """Each refused plugin ahead of TGA whose _accept takes a file names it:
    a file with its magic and TGA-valid bytes after is refused by name. Of
    the magics the port now decodes, the outcome is Pillow's: DDS's _open
    raises on the header (an OSError Image.open does not pass on), BLP's
    header reads past the decompression-bomb limit, FTEX's format count is
    not one (Pillow's assert), while ICNS, MSP and SUN pass the file on and
    no plugin takes it."""
    tail = tga_file(scene(4, 4, 1), 2, 24)[4:]
    for magic, fmt in ((b"BUFR", "BUFR"), (b"\x00\x00\x01\xb3", "MPEG")):
        with pytest.raises(ValueError, match=f"unsupported image format: {fmt}"):
            codec.decode(magic + tail)
    for magic, match in ((b"DDS ", "unsupported DDS: a header of"),
                         (b"BLP1", "unsupported BLP: .* decompression-bomb limit"),
                         (b"FTEX", "unsupported FTEX: .* formats, not one"),
                         (b"icns", "not a JPEG, PNG"), (b"DanM", "not a JPEG, PNG"),
                         (b"\x59\xa6\x6a\x95", "not a JPEG, PNG")):
        assert _pil_or_none(magic + tail) is None and _pil_format(magic + tail) is None
        with pytest.raises(ValueError, match=match):
            codec.decode(magic + tail)


# ---------------------------------------------------------------------------
# Plain PPM across the decoder's 1 MiB blocks; the JAX path
# ---------------------------------------------------------------------------


def test_plain_ppm_tokens_and_comments_across_blocks():
    """PpmPlainDecoder reads 1 MiB at a time: a token cut by the block's end
    is carried on, a comment crossing it is cut out of both, and a token
    over 10 characters at the end of a block raises even where the image
    is full before it."""
    head = b"P2\n300 300\n65535\n"
    body = bytearray(b" ".join(b"%d" % (i * 37 % 65536) for i in range(300 * 300)) + b"\n")
    block = 1 << 20
    cut = block - 3  # the token that holds this byte spans the block's end
    data = head + bytes(body)
    split = data[:cut] + b"#\n" + data[cut:]
    commented = data[:block - 4] + b" # a comment across the block's end\n" + data[block - 4:]
    for d in (data, split, commented):
        np.testing.assert_array_equal(codec.decode(d), _pil(d))
    short = b"P2\n3 3\n255\n" + b"1 " * 9 + b" " * (block - 40) + b"12345678901234567890"
    assert _pil_or_none(short) is None
    with pytest.raises(ValueError, match="PPM"):
        codec.decode(short)


def test_jax_bytes_to_pil_gives_the_same_arrays():
    """The JAX ``core/imaging.py::bytes_to_pil`` on one file of each format."""
    for fmt, cases in _cases().items():
        for name, data in list(cases.items())[:2]:
            want = _pil_or_none(data)
            if want is not None:
                np.testing.assert_array_equal(codec.decode(data),
                                              np.asarray(jimaging.bytes_to_pil(data)),
                                              err_msg=f"{fmt} {name}")


def test_psd_upload_of_the_chip_script_matches_pillow():
    """The PSD ``chip_smoke.py`` serves through /edit (written without
    Pillow) decodes to its source, as Pillow decodes it."""
    import chip_smoke

    rgb = scene(24, 40, 9)
    data = chip_smoke.psd_upload(rgb)
    np.testing.assert_array_equal(codec.decode(data), rgb)
    np.testing.assert_array_equal(_pil(data), rgb)
