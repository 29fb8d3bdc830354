"""The port's codec on the rare formats Pillow decodes (``core/codec.py`` over
``csrc/host/fli_pcd.cc`` and ``bcn.cc``) against Pillow 12.1, which the JAX
package's ``core/imaging.py`` opens every upload with (``Image.open`` →
``ImageOps.exif_transpose`` → ``convert("RGB")``).

Each case must equal Pillow's bytes exactly: XV thumbnails, Pixar's dumped
RGB, McIdas areas (L, I;16B, I;32B, a line prefix and bands), SPIDER (both
byte orders, a stack's first image), FITS (BITPIX 8, 16, 32, -32, -64 read
bottom-up with the mode as raw mode, GZIP_1 tiles), GIMP brushes (version 1
and 2, gray and RGBA), IM Tools, FTEX (DXT1 and raw), IM (every type of its
OPEN table that Pillow decodes, a ``Lut``'s palette, the bit decoder), BLP
(BLP1 JPEG and palette, BLP2 palette and DXT1/3/5 at widths 4n to 4n + 3),
FLI/FLC (the colour chunks, BRUN, COPY, LC, SS2, BLACK, PSTAMP), PhotoCD at
each orientation and IPTC records (raw, a band of RGB or CMYK, JPEG). Files
come from Pillow's ``save`` where it writes the format, else from
``scripts/codec_fixtures.py``'s writers. Where Pillow raises, the port raises
a ``ValueError`` naming the format; a fuzz of FLI, BLP, IM and FITS counts
every disagreement.
"""

import functools
import gzip
import io
import os
import struct
import subprocess
import sys
import time
import tracemalloc
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image, ImageOps

from qwen_image_edit_streamdiffusion_tpu.core import imaging as jimaging
from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
from codec_fixtures import (bc1_blocks, blp_file, fits_file, fli_brun, fli_chunk,  # noqa: E402
                            fli_file, fli_frame, fli_lc, fli_palette_chunk, fli_ss2, ftex_file,
                            gbr_file, im_file, imt_file, iptc_dataset, iptc_file, mcidas_file,
                            pcd_file, photo_ycc, pixar_file, scene, spider_file, xv_indices,
                            xvthumb_file)


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


def _save(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _pil_format(data: bytes):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fmt = Image.open(io.BytesIO(data)).format
        return fmt.upper()  # XVThumb's class names it so; Image.ID has XVTHUMB
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


def _jpeg(arr: np.ndarray, **kw) -> bytes:
    return _save(Image.fromarray(arr), "JPEG", quality=90, **kw)


def _fits_cards(cards, body: bytes = b"") -> bytes:
    """A FITS header unit of raw 80-byte cards, END and its padding."""
    head = b"".join(c.ljust(80) for c in cards) + b"END".ljust(80)
    return head + b" " * (-len(head) % 2880) + body


def _im_rows(planes: np.ndarray) -> bytes:
    """(H, W, planes) → an IM body of line-interleaved planes, bottom-up."""
    return np.ascontiguousarray(planes[::-1].transpose(0, 2, 1)).tobytes()


def _packed(v: np.ndarray, bits: int) -> bytes:
    """(H, W) samples of ``bits`` bits, most significant first, rows padded
    to bytes, bottom-up."""
    b = (v[::-1, :, None].astype(np.int64) >> np.arange(bits - 1, -1, -1)) & 1
    return np.packbits(b.reshape(v.shape[0], -1).astype(np.uint8), axis=1).tobytes()


def _lsb_bits(v: np.ndarray, bits: int) -> bytes:
    """(H, W) samples of ``bits`` bits as BitDecode's fill 3 reads them:
    least significant first, each row from a byte boundary, bottom-up."""
    out = b""
    for row in v[::-1].astype(np.int64):
        b = ((row[:, None] >> np.arange(bits)) & 1).reshape(-1).astype(np.uint8)
        out += np.packbits(b, bitorder="little").tobytes()
    return out


# ---------------------------------------------------------------------------
# The cases: {format: {name: bytes}}
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _cases() -> dict:
    rng = np.random.default_rng(24)
    rgb = scene(23, 30, 1)
    gray = rgb[..., 1]
    f32 = gray.astype(np.float32) * 1.7 - 40.25
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    ind = (gray >> 2).astype(np.uint8)

    idx = xv_indices(rgb)
    xv = {
        "thumbnail": xvthumb_file(idx),
        "no_comments": b"P7 332\n30 23 255\n" + idx.astype(np.uint8).tobytes(),
        "many_comments": xvthumb_file(idx, (b"#a", b"#b", b"# c d")),
        "size_of_two_tokens": b"P7 332 x\n#c\n  30\t23\n" + idx.astype(np.uint8).tobytes(),
        "short": xvthumb_file(idx)[:-5],
        "size_of_one_token": b"P7 332\n#c\n30\n" + bytes(90),
        "size_not_a_number": b"P7 332\n30 x23\n" + bytes(900),
        "comments_to_the_end_unidentified": b"P7 332\n#a\n#b\n",
        "width_0_unidentified": b"P7 332\n0 23 255\n" + bytes(100),
    }
    pixar = {
        "dumped_rgb": pixar_file(rgb),
        "extra_data": pixar_file(rgb) + bytes(50),
        "short": pixar_file(rgb)[:-1],
        "other_layout_unidentified": pixar_file(rgb, 15, 2),
    }
    mcidas = {
        "L": mcidas_file(gray),
        "L_prefix_and_bands": mcidas_file(gray, 1, prefix=7, bands=3),
        "I16B": mcidas_file(gray.astype(np.int64) * 3 - 100, 2),
        "I32B": mcidas_file(gray.astype(np.int64) * 5 - 300, 4, prefix=2),
        "offset_past_the_directory": mcidas_file(gray, offset=300),
        "short": mcidas_file(gray)[:-2],
        "stride_below_the_row": _set(mcidas_file(gray, prefix=4), 13 * 4, struct.pack(">i", 0)),
        "format_3_unidentified": _set(mcidas_file(gray), 10 * 4, struct.pack(">i", 3)),
        "directory_cut_unidentified": mcidas_file(gray)[:255],
    }
    spider = {
        "little_endian": spider_file(f32),
        "big_endian": spider_file(f32, big_endian=True),
        "pillow": _save(Image.fromarray(f32, "F"), "SPIDER"),
        "stack_first_image": spider_file(f32, stack=3),
        "nan_and_inf": spider_file(np.where(rng.random(f32.shape) < 0.2, np.nan,
                                            np.where(rng.random(f32.shape) < 0.2, np.inf, f32))
                                   .astype(np.float32)),
        "short": spider_file(f32)[:-3],
        "image_of_a_stack": _set(spider_file(f32), 26 * 4, struct.pack("<f", 2.0)),
        "inconsistent_stack_unidentified": _set(_set(spider_file(f32), 26 * 4,
                                                     struct.pack("<f", 2.0)), 23 * 4,
                                                struct.pack("<f", 1.0)),
        "volume_unidentified": _set(spider_file(f32), 4 * 4, struct.pack("<f", 3.0)),
    }
    g16 = gray.astype(np.int64) * 257 - 20000
    fits = {f"bitpix_{b}": fits_file(v, b) for b, v in (
        (8, gray), (16, g16), (32, g16 * 5), (-32, f32), (-64, f32.astype(np.float64)))}
    fits.update({f"gzip_{b}": fits_file(v, b, gzip_tile=True) for b, v in (
        (8, gray), (16, g16), (32, g16 * 3), (-32, f32))})
    head = [b"SIMPLE  =                    T", b"BITPIX  =                    8"]
    body = gray[::-1].tobytes()
    fits.update({
        "naxis_1": _fits_cards(head + [b"NAXIS   = 1", b"NAXIS1  = 23"], gray[:, 0].tobytes()),
        "naxis_3": _fits_cards(head + [b"NAXIS   = 3", b"NAXIS1  = 30", b"NAXIS2  = 23",
                                       b"NAXIS3  = 2"], body * 2),
        "bscale_bzero_comments": _fits_cards(
            head + [b"NAXIS   = 2 / two axes", b"NAXIS1  = 30", b"NAXIS2  =                   23",
                    b"BSCALE  = 2.0", b"BZERO   = 128", b"COMMENT  any text"], body),
        "image_extension": _fits_cards(head + [b"NAXIS   = 0", b"EXTEND  = T"])
        + _fits_cards([b"XTENSION= 'IMAGE   '", b"BITPIX  = 8", b"NAXIS   = 2", b"NAXIS1  = 30",
                       b"NAXIS2  = 23"], body),
        "data_shorter_than_a_card": _fits_cards(head + [b"NAXIS   = 2", b"NAXIS1  = 5",
                                                        b"NAXIS2  = 2"], bytes(range(10))),
        "short": fits_file(gray, 8)[:2880 + 30 * 23 - 1],
        "no_data_after_the_header": _fits_cards(head + [b"NAXIS   = 2", b"NAXIS1  = 30",
                                                        b"NAXIS2  = 23"]),
        "no_end": b"".join(c.ljust(80) for c in head + [b"NAXIS   = 0"]),
        "no_axes": _fits_cards(head + [b"NAXIS   = 0"], body),
        "naxis1_not_an_integer": _fits_cards(head + [b"NAXIS   = 2", b"NAXIS1  = 3.5",
                                                     b"NAXIS2  = 2"], body),
        "gzip_not_gzip": fits_file(gray, 8, gzip_tile=True)[:-2880] + b"\x1f\x8c" + bytes(2878),
        "bitpix_64_unidentified": fits_file(gray, 8).replace(b"=                    8",
                                                             b"=                   64", 1),
        "simple_false_unidentified": fits_file(gray, 8).replace(b"T", b"F", 1),
        "naxis_missing_unidentified": _fits_cards(head, body),
    })
    # the heap as gzip.decompress reads it: members joined, zeros between
    # them skipped, each member's header fields, CRC and length checked
    heap_at = fits.get("gzip_8").index(b"\x1f\x8b")
    words = gray[::-1].astype(">i4").tobytes()
    m1, m2 = gzip.compress(words[:1000], mtime=0), gzip.compress(words[1000:], mtime=0)
    # FEXTRA, FNAME, FCOMMENT and FHCRC (a CRC gzip.decompress does not check)
    fields = (b"\x1f\x8b\x08\x1e" + bytes(6) + b"\x02\x00ab" + b"name\x00" + b"note\x00"
              + b"\xff\xff" + zlib.compress(words, wbits=-15)
              + struct.pack("<II", zlib.crc32(words), len(words)))
    fits.update({f"gzip_{k}": fits["gzip_8"][:heap_at] + heap for k, heap in {
        "two_members": m1 + m2,
        "zeros_between_members": m1 + bytes(100) + m2 + bytes(3000),
        "member_past_the_image": m1 + m2 + gzip.compress(b"\x09" * 5000, mtime=0),
        "header_fields": fields,
        "second_member_bad_crc": m1 + _set(m2, len(m2) - 8, b"\x00\x00"),
        "second_member_bad_length": m1 + _set(m2, len(m2) - 4, b"\x00"),
        "second_member_cut": m1 + m2[:-3],
        "garbage_after_the_zeros": m1 + m2 + bytes(20) + b"\x01",
        "header_fields_cut": fields[:17],
        "method_not_deflate": _set(m1, 2, b"\x07") + m2,
    }.items()})
    rgba = np.concatenate([rgb, gray[..., None]], -1)
    gbr = {
        "v1_gray": gbr_file(gray, 1), "v2_gray": gbr_file(gray),
        "v2_rgba": gbr_file(rgba), "v1_rgba": gbr_file(rgba, 1, name=b""),
        "long_name": gbr_file(gray, name=b"x" * 300),
        "short": gbr_file(rgba)[:-1],
        "v2_header_below_28": _set(gbr_file(gray, name=b""), 0, struct.pack(">I", 24)),
        "bad_magic_unidentified": _set(gbr_file(gray), 20, b"PMIG"),
        "depth_3_unidentified": _set(gbr_file(gray), 16, struct.pack(">I", 3)),
        "width_0_unidentified": _set(gbr_file(gray), 8, struct.pack(">I", 0)),
    }
    imt = {
        "gray": imt_file(gray),
        "height_first": b"height 23\nwidth 30\npixel n8\n\x0c" + gray.tobytes(),
        "comments": b"* one\n* two\nwidth 30\n* c\nheight 23\npixel n8\n\x0c" + gray.tobytes(),
        "lone_star_ends_the_header_unidentified": b"width 30\n*\nheight 23\npixel n8\n\x0c"
                                                  + gray.tobytes(),
        "short": imt_file(gray)[:-1],
        "no_image_mark": b"width 30\nheight 23\npixel n8\n" + b"\n" + gray.tobytes(),
        "width_not_a_number": b"width 3x\nheight 23\npixel n8\n\x0c" + gray.tobytes(),
        "long_line_unidentified": b"width 30\n" + b"a" * 150 + b"\n\x0c",
        "no_pixel_line_unidentified": b"width 30\nheight 23\n\x0c" + gray.tobytes(),
    }
    ftex = {
        "dxt1": ftex_file(30, 23, bc1_blocks(rgb)),
        "dxt1_4n": ftex_file(28, 20, bc1_blocks(rgb[:20, :28])),
        "dxt1_random_blocks": ftex_file(30, 23, rng.integers(0, 256, 8 * 48, np.uint8).tobytes()),
        "raw_rgb": ftex_file(30, 23, rgb.tobytes(), 1),
        "size_negative": _set(ftex_file(30, 23, rgb.tobytes(), 1), 32, struct.pack("<i", -1)),
        "dxt1_short": ftex_file(30, 23, bc1_blocks(rgb)[:-1]),
        "raw_short": ftex_file(30, 23, rgb.tobytes()[:-1], 1),
        "two_formats": ftex_file(30, 23, rgb.tobytes(), 1, formats=2),
        "format_2": ftex_file(30, 23, rgb.tobytes(), 2),
        "header_cut_unidentified": ftex_file(30, 23, b"")[:30],
    }
    f_img = Image.fromarray(f32, "F")
    im = {f"pillow_{m}": _save(Image.fromarray(rgb).convert(m), "IM")
          for m in ("1", "L", "LA", "P", "I", "F", "RGB", "RGBA", "CMYK", "YCbCr")}
    im["pillow_PA"] = _save(Image.fromarray(rgb).convert("P").convert("PA"), "IM")
    im["pillow_F_values"] = _save(f_img, "IM")
    w, h = 30, 23
    g16s = (gray.astype(np.int64) * 300 - 30000)
    lut_gray = bytes(range(256)) * 3
    lut_curve = bytes(255 - i for i in range(256)) * 3
    im.update({
        "RGB3": im_file(b"RGB3", w, h, np.ascontiguousarray(rgb[::-1, :, [1, 0, 2]]
                                                           .transpose(2, 0, 1)).tobytes()),
        "RYB3": im_file(b"RYB3", w, h, np.ascontiguousarray(rgb[::-1].transpose(2, 0, 1))
                        .tobytes()),
        "B2": im_file(b"B2", w, h, _packed(ind & 3, 2)),
        "B4": im_file(b"B4", w, h, _packed(ind & 15, 4)),
        "B4_lut": im_file(b"B4", w, h, _packed(ind & 15, 4) + bytes(1000),
                          lut=pal.T.tobytes()),
        "B1": im_file(b"B1", w, h, _packed(gray > 100, 1)),
        "L_lut_colour": im_file(b"Greyscale", w, h, gray[::-1].tobytes(), lut=pal.T.tobytes()),
        "L_lut_gray_linear": im_file(b"Greyscale", w, h, gray[::-1].tobytes(), lut=lut_gray),
        "L_lut_gray_curve": im_file(b"Grayscale", w, h, gray[::-1].tobytes(), lut=lut_curve),
        "LA_lut_colour": im_file(b"LA", w, h, _im_rows(np.stack([gray, ind], -1)),
                                 lut=pal.T.tobytes()),
        "RGB_lut": im_file(b"RGB", w, h, _im_rows(rgb), lut=lut_curve),
        "X24": im_file(b"X 24", w, h, rgb[::-1].tobytes()),
        "RGBX": im_file(b"RGBX", w, h, _im_rows(rgba)),
        "YCC": im_file(b"YCC", w, h, _im_rows(rgb)),
        "L8": im_file(b"L 8", w, h, gray[::-1].tobytes()),
        "L8S": im_file(b"L*8S", w, h, (gray ^ 0x80)[::-1].tobytes()),
        "L16": im_file(b"L 16", w, h, g16.astype("<u2")[::-1].tobytes()),
        "L16L": im_file(b"L*16L", w, h, (gray.astype(np.int64) * 2).astype("<u2")[::-1]
                        .tobytes()),
        "L16B": im_file(b"L 16B", w, h, (gray.astype(np.int64) * 2).astype(">u2")[::-1]
                        .tobytes()),
        "L16S": im_file(b"L 16S", w, h, g16s.astype("<i2")[::-1].tobytes()),
        "L32": im_file(b"L*32", w, h, (gray.astype(np.int64) * 3).astype("<u4")[::-1].tobytes()),
        "L32S": im_file(b"L 32S", w, h, g16s.astype("<i4")[::-1].tobytes()),
        "L_32_S": im_file(b"L 32 S", w, h, (g16s * 99999).astype("<i4")[::-1].tobytes()),
        "L32F": im_file(b"L 32F", w, h, f32[::-1].astype("<f4").tobytes()),
        "L_32_F": im_file(b"L 32 F", w, h, (gray.astype(np.int64) * 2).astype("<u4")[::-1]
                          .tobytes()),
        "L_star_12": im_file(b"L*12", w, h, _lsb_bits(gray.astype(np.int64) * 9, 12)),
        "L_star_5": im_file(b"L*5", w, h, _lsb_bits(gray >> 3, 5)),
        "L_star_3_leftover_bits": im_file(b"L*3", w, h, bytes(rng.integers(0, 256, 400,
                                                                          np.uint8))),
        "L_star_31": im_file(b"L*31", w, h, bytes(rng.integers(0, 256, 4 * w * h, np.uint8))),
        "default_L_512": im_file(b"Greyscale", 512, 512, bytes(512 * 512)).replace(
            b"Image size (x*y): 512*512\r\n", b""),
        "crlf_reversed_and_name": b"Image type: L 8 image\n\rName: x\n\rImage size (x*y): 30*23"
                                  b"\n\r\x1a" + gray[::-1].tobytes(),
        "size_from_a_later_line": im_file(b"Greyscale", 10, 10, gray[::-1].tobytes(),
                                          lines=(b"Image size (x*y): 30*23",)),
        "mode_not_in_the_table": im_file(b"Greyscale", w, h, gray[::-1].tobytes()).replace(
            b"Image type: Greyscale image", b"Image type: L image        "),
        "mode_L_by_name": im_file(b"Greyscale", w, h, gray[::-1].tobytes()).replace(
            b"Image type: Greyscale image", b"Image type: L"),
        "mode_named_by_a_later_line": im_file(b"RGB", w, h, _im_rows(rgb),
                                              lines=(b"Image type: RGBX",)),
        "RLB": im_file(b"RLB", w, h, rgb[::-1].tobytes()),
        "PA_as_LA": im_file(b"PA", w, h, _im_rows(np.stack([gray, ind], -1))),
        "short": im_file(b"RGB", w, h, _im_rows(rgb))[:-1],
        "size_not_a_number": im_file(b"RGB", w, h, _im_rows(rgb)).replace(b"30*23", b"30*2x"),
        "size_three_numbers": im_file(b"RGB", w, h, _im_rows(rgb)).replace(b"30*23", b"30*23*1"),
        "size_of_floats": im_file(b"RGB", w, h, _im_rows(rgb)).replace(b"30*23", b"30.0*23"),
        "lut_short_unidentified": im_file(b"Greyscale", w, h, b"", lut=b"\x01" * 700),
        "size_one_number_unidentified": im_file(b"RGB", w, h, _im_rows(rgb)).replace(
            b"30*23", b"690  "),
        "no_known_key_unidentified": b"Foo: bar\r\n\x1a" + gray.tobytes(),
        "no_data_mark_unidentified": b"Image type: L image\r\nImage size (x*y): 2*2\r\n\x00",
        "line_over_100_unidentified": b"Image type: L image\r\nName: " + b"n" * 100 + b"\r\n\x1a",
    })
    blp = {
        "pillow_blp1": _save(Image.fromarray(rgb).quantize(200), "BLP", blp_version="BLP1"),
        "pillow_blp2": _save(Image.fromarray(rgb).quantize(200), "BLP"),
        "pillow_blp2_rgba": _save(Image.fromarray(rgba, "RGBA").quantize(64), "BLP"),
        "blp1_palette_5": blp_file(1, w, h, ind.tobytes(), palette=pal, encoding=5),
        "blp1_palette_4_alpha": blp_file(1, w, h, ind.tobytes(), palette=pal, encoding=4,
                                         alpha=8),
        "blp2_palette": blp_file(2, w, h, ind.tobytes(), palette=pal),
        "blp2_palette_alpha": blp_file(2, w, h, ind.tobytes() + b"\x07" * 9, palette=pal,
                                       alpha=8),
        "blp1_palette_short": blp_file(1, w, h, ind.tobytes()[:-1], palette=pal, encoding=5),
        "blp2_palette_mipmap_past_the_file": blp_file(2, w, h, ind.tobytes(), palette=pal)[:-1],
        "blp2_palette_cut": blp_file(2, w, h, b"", palette=pal)[:600],
        "blp1_encoding_3": blp_file(1, w, h, ind.tobytes(), palette=pal, encoding=3),
        "blp2_compression_0": blp_file(2, w, h, ind.tobytes(), palette=pal, compression=0),
        "blp2_encoding_3": blp_file(2, w, h, ind.tobytes(), palette=pal, encoding=3),
        "blp2_alpha_encoding_8": blp_file(2, w, h, bytes(400), encoding=2, alpha_encoding=8),
        "header_cut_unidentified": blp_file(2, w, h, b"")[:15],
        "width_0_unidentified": blp_file(2, 0, h, b""),
    }
    for wd in (28, 29, 30, 31):
        blocks = rng.integers(0, 256, ((wd + 3) // 4) * 6 * 16, np.uint8).tobytes()
        for ae, name in ((0, "dxt1"), (1, "dxt3"), (7, "dxt5")):
            for alpha in (0, 8):
                blp[f"blp2_{name}_alpha{alpha}_w{wd}"] = blp_file(
                    2, wd, h, blocks, encoding=2, alpha_encoding=ae, alpha=alpha)
    blp["blp2_dxt1_coded"] = blp_file(2, w, h, bc1_blocks(rgb), encoding=2)
    blp["blp2_dxt5_short"] = blp_file(2, w, h, bytes(8 * 16 * 6 - 1), encoding=2,
                                      alpha_encoding=7)
    exif = Image.Exif()
    exif[0x0112] = 6
    cmyk = _save(Image.fromarray(np.concatenate([rgb, gray[..., None] // 3], -1), "CMYK"),
                 "JPEG", quality=90)
    adobe = cmyk.index(b"Adobe") + 11
    for label, jpeg, size in (("rgb", _jpeg(rgb), (w, h)), ("gray", _jpeg(gray), (w, h)),
                              ("exif_orientation", _jpeg(rgb, exif=exif), (w, h)),
                              ("cmyk", cmyk, (w, h)),
                              ("ycck", cmyk[:adobe] + b"\x02" + cmyk[adobe + 1:], (w, h)),
                              ("narrower_than_its_jpeg", _jpeg(rgb), (w - 3, h)),
                              ("larger_than_its_jpeg", _jpeg(rgb), (w, h + 1))):
        sos = jpeg.index(b"\xff\xda")
        blp[f"blp1_jpeg_{label}"] = blp_file(1, *size, jpeg[sos:], compression=0,
                                             jpeg_header=jpeg[:sos], alpha=8 * (label == "rgb"))
    jpeg = _jpeg(rgb)
    sos = jpeg.index(b"\xff\xda")
    blp["blp1_jpeg_not_a_jpeg"] = blp_file(1, w, h, jpeg[sos:], compression=0,
                                           jpeg_header=b"\x00" + jpeg[1:sos])
    blp["blp1_jpeg_mipmap_before_the_header_end"] = _set(
        blp_file(1, w, h, jpeg[sos:], compression=0, jpeg_header=jpeg[:sos]), 28,
        struct.pack("<I", 0))

    ind2 = ind.copy()
    ind2[3:9, 4:20] = 7
    ind2[12, :] = 200
    ind2[20, 1::3] = 9
    even = ind[:, :30]
    fli = {
        "flc_palette_8bit_brun": fli_file([fli_frame(fli_palette_chunk(pal, 4), fli_brun(ind))],
                                          w, h),
        "fli_palette_6bit_brun": fli_file([fli_frame(fli_palette_chunk(pal >> 2, 11),
                                                     fli_brun(ind))], w, h, flc=False),
        "palette_packets_skip": fli_file([fli_frame(fli_chunk(
            4, struct.pack("<HBB", 2, 10, 3) + pal[:3].tobytes() + struct.pack("<BB", 5, 2)
            + pal[3:5].tobytes()), fli_brun(ind))], w, h),
        "gray_ramp_copy": fli_file([fli_frame(fli_chunk(16, ind.tobytes()))], w, h),
        "brun_then_lc": fli_file([fli_frame(fli_brun(ind), fli_lc(ind2, ind))], w, h),
        "copy_then_ss2": fli_file([fli_frame(fli_chunk(16, even.tobytes()),
                                             fli_ss2(ind2[:, :30], even))], 30, h),
        "ss2_odd_width_last_byte": fli_file([fli_frame(fli_chunk(16, ind[:, :29].tobytes()),
                                                       fli_chunk(7, struct.pack(
                                                           "<HHHBB", 1, 0x8000 | 77, 1, 2, 1)
                                                           + b"\x05\x06"))], 29, h),
        "black_and_pstamp": fli_file([fli_frame(fli_chunk(16, ind.tobytes()),
                                                fli_chunk(18, bytes(20)), fli_chunk(13, b""),
                                                fli_chunk(18, bytes(12)))], w, h),
        "two_frames": fli_file([fli_frame(fli_brun(ind)), fli_frame(fli_lc(ind2, ind))], w, h),
        "prefix_chunk": fli_file([fli_frame(fli_brun(ind))], w, h,
                                 prefix=struct.pack("<IH", 16, 0xF100) + bytes(10)),
        "unknown_chunk": fli_file([fli_frame(fli_chunk(99, bytes(10)))], w, h),
        "brun_line_short": fli_file([fli_frame(fli_chunk(15, b"\x01\x05\x07" * h))], w, h),
        "lc_past_the_image": fli_file([fli_frame(fli_chunk(12, struct.pack("<HH", 20, 9)
                                                           + b"\x00" * 9))], w, h),
        "chunk_past_its_frame": fli_file([fli_frame(_set(fli_brun(ind), 0,
                                                         struct.pack("<I", 99999)))], w, h),
        "last_chunk_under_10_bytes": fli_file([fli_frame(fli_chunk(16, ind.tobytes()),
                                                         fli_chunk(13, b""))], w, h),
        "copy_short_of_its_image": fli_file([fli_frame(fli_chunk(16, ind.tobytes()[:-40]))],
                                            w, h),
        # a frame of 26 bytes, so reads of 26 bytes: the COPY chunk is left
        # over and then read as a frame of its own size (past the file, or
        # reached and not a frame)
        **{f"copy_left_over_{size}_{pad}": fli_file([fli_frame(struct.pack("<IH", size, 16)
                                                               + bytes(4))], w, h) + bytes(pad)
           for size, pad in ((0xFFFFFFF0, 3000), (5001, 3), (5001, 6000), (9, 0), (9, 1))},
        "frame_cut": fli_file([fli_frame(fli_brun(ind))], w, h)[:-9],
        "no_frames_unidentified": _set(fli_file([fli_frame(fli_brun(ind))], w, h), 6,
                                       b"\x00\x00"),
        "reserved_bytes_unidentified": _set(fli_file([fli_frame(fli_brun(ind))], w, h), 50,
                                            b"\x01"),
        "palette_past_256_unidentified": fli_file([fli_frame(fli_chunk(
            4, struct.pack("<HBB", 1, 250, 10) + pal[:10].tobytes()), fli_brun(ind))], w, h),
    }

    y, cb, cr = photo_ycc(scene(512, 768, 2))
    rnd = [rng.integers(0, 256, s, np.uint8) for s in ((512, 768), (256, 384), (256, 384))]
    pcd = {f"orientation_{o}": pcd_file(y, cb, cr, o) for o in range(4)}
    pcd.update({
        "random_ycc": pcd_file(*rnd, orientation=1),
        "orientation_byte_high_bits": pcd_file(y, cb, cr, 0xF3),
        "short": pcd_file(y, cb, cr)[:-1],
        "header_cut_unidentified": pcd_file(y, cb, cr)[:2048 + 1538],
    })

    exif_jpeg = _jpeg(rgb, exif=exif)
    gray_jpeg = _jpeg(gray)
    raw = gray.tobytes()
    iptc = {
        "raw_L": iptc_file(w, h, raw),
        "raw_rgb_band_0": iptc_file(w, h, raw, 3, 1),
        "raw_rgb_band_3": iptc_file(w, h, raw, 3, 1, band=3),
        "raw_rgb_band_0_is_the_last": iptc_file(w, h, raw, 3, 1, band=0),
        "raw_cmyk_band_2": iptc_file(w, h, raw, 4, 1, band=2),
        "raw_image_in_two_records": iptc_file(w, h, raw[:300]) + iptc_dataset(8, 10, raw[300:]),
        "raw_extended_size": iptc_file(w, h, raw)[:-len(raw) - 5] + struct.pack(
            ">BBBBBI", 0x1C, 8, 10, 0x84, 0, len(raw)) + raw,
        # the standard's extended size (0x8004): Pillow reads its 0x80 as a size of 0
        "raw_standard_extended_size": iptc_file(w, h, raw)[:-len(raw) - 5] + struct.pack(
            ">BBBHI", 0x1C, 8, 10, 0x8004, len(raw)) + raw,
        "raw_size_of_6_bytes": iptc_dataset(3, 60, b"\x01\x00")
        + iptc_dataset(3, 20, struct.pack(">I", w))
        + iptc_dataset(3, 30, b"\x01\x00\x00\x00" + struct.pack(">H", h))
        + iptc_dataset(3, 120, b"\x01") + iptc_dataset(8, 10, raw),
        "jpeg_L": iptc_file(w, h, _jpeg(rgb), compression=5),
        "jpeg_exif_orientation_kept": iptc_file(w, h, exif_jpeg, compression=5),
        "jpeg_gray_band_of_rgb": iptc_file(w, h, gray_jpeg, 3, 1, compression=5, band=2),
        "jpeg_size_of_its_own": iptc_file(5, 5, _jpeg(rgb), compression=5),
        "jpeg_rgb_band_of_rgb": iptc_file(w, h, _jpeg(rgb), 3, 1, compression=5),
        # a record of another format: Image.open's decode of it (a TIFF's
        # load applies its orientation, a WebP's or PNG's EXIF is not read)
        "tiff_record_oriented": iptc_file(w, h, _save(Image.fromarray(rgb), "TIFF", exif=exif),
                                          compression=5),
        "webp_record_exif_kept": iptc_file(w, h, _save(Image.fromarray(rgb), "WEBP",
                                                       lossless=True, exif=exif), compression=5),
        "png_record_exif_kept": iptc_file(w, h, _save(Image.fromarray(rgb), "PNG", exif=exif),
                                          compression=5),
        "gif_record": iptc_file(w, h, _save(Image.fromarray(rgb).quantize(16), "GIF"),
                                compression=5),
        "raw_short": iptc_file(w, h, raw[:-1]),
        "band_past_the_bands": iptc_file(w, h, raw, 3, 1, band=5),
        "compression_2": iptc_file(w, h, raw, compression=2),
        "no_compression": iptc_dataset(3, 60, b"\x01\x00") + iptc_dataset(3, 20, b"\x1e")
        + iptc_dataset(3, 30, b"\x17") + iptc_dataset(8, 10, raw),
        "no_image_record": iptc_file(w, h, raw)[:-len(raw) - 5] + b"\x00" * 5,
        "garbage_after_the_image": iptc_file(w, h, raw) + b"\x1d\x08\x0a\x00\x00",
        "field_length_over_132": iptc_file(w, h, raw)[:-len(raw) - 5] + b"\x1c\x08\x0a\x85\x00",
        "layers_2_unidentified": iptc_file(w, h, raw, 2, 1),
        "no_layers_unidentified": iptc_dataset(3, 20, b"\x1e") + iptc_dataset(3, 30, b"\x17")
        + iptc_dataset(3, 120, b"\x01") + iptc_dataset(8, 10, raw),
        "empty_compression_unidentified": iptc_file(w, h, raw).replace(
            iptc_dataset(3, 120, b"\x01"), iptc_dataset(3, 120, b"")),
    }
    # a record as a band of RGB or CMYK: Image.merge takes an L record at
    # any band and one of mode 1 at the first; other modes raise
    records = {
        "png_gray": _save(Image.fromarray(gray), "PNG"),
        "png_bilevel": _save(Image.fromarray(gray > 99), "PNG"),
        "png_rgb": _save(Image.fromarray(rgb), "PNG"),
        "tiff_gray": _save(Image.fromarray(gray), "TIFF"),
        "bmp_gray": _save(Image.fromarray(gray), "BMP"),
        "bmp_bilevel": _save(Image.fromarray(gray > 99), "BMP"),
        "pbm": _save(Image.fromarray(gray > 99), "PPM"),
        "ppm_rgb": _save(Image.fromarray(rgb), "PPM"),
        "pgm_16": _save(Image.fromarray(gray.astype(np.uint16) * 200), "PPM"),
        "pfm": _save(Image.fromarray(f32), "PPM"),
        "gif": _save(Image.fromarray(rgb).quantize(16), "GIF"),
    }
    for name, record in records.items():
        for layers, band in ((3, 1), (3, 3), (4, 2)):
            if band == 1 and name in ("pgm_16", "pfm"):
                continue  # Pillow's merge crashes: test_divergences_that_stay
            if band == 1 and name == "gif":
                continue  # a palette image: test_divergences_that_stay
            iptc[f"{name}_band_{band}_of_{layers}"] = iptc_file(w, h, record, layers, 1,
                                                               compression=5, band=band)
    return {"XVTHUMB": xv, "PIXAR": pixar, "MCIDAS": mcidas, "SPIDER": spider, "FITS": fits,
            "GBR": gbr, "IMT": imt, "FTEX": ftex, "IM": im, "BLP": blp, "FLI": fli, "PCD": pcd,
            "IPTC": iptc}


CASE_IDS = [f"{fmt}-{name}" for fmt, cases in _cases().items() for name in cases]


def _case(case_id: str) -> bytes:
    fmt, name = case_id.split("-", 1)
    return _cases()[fmt][name]


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_formats_match_pillow(case_id):
    """Pillow's pixels, or a ValueError where Pillow raises: naming the
    format that opened the file, or the case's format where its ``_open``
    raised, or no format where no plugin takes the file (``_unidentified``);
    and the format ``Image.open`` names."""
    data = _case(case_id)
    want = _pil_or_none(data)
    fmt = _pil_format(data)
    if want is None:
        named = fmt or ("not a JPEG, PNG" if case_id.endswith("_unidentified")
                        else case_id.split("-")[0])
        with pytest.raises(ValueError, match=named):
            codec.decode(data)
    else:
        got = codec.decode(data)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert _port_format(data) == fmt


def test_only_the_cases_meant_to_fail_fail():
    """The cases above that Pillow refuses are the ones meant to be refused
    (``_unidentified`` where no plugin takes the file); every other case
    decodes."""
    refused = sorted(c for c in CASE_IDS if _pil_or_none(_case(c)) is None)
    assert refused == sorted([
        "XVTHUMB-short", "XVTHUMB-size_of_one_token", "XVTHUMB-size_not_a_number",
        "XVTHUMB-comments_to_the_end_unidentified", "XVTHUMB-width_0_unidentified",
        "PIXAR-short", "PIXAR-other_layout_unidentified",
        "MCIDAS-short", "MCIDAS-stride_below_the_row", "MCIDAS-format_3_unidentified",
        "MCIDAS-directory_cut_unidentified",
        "SPIDER-short", "SPIDER-image_of_a_stack", "SPIDER-inconsistent_stack_unidentified",
        "SPIDER-volume_unidentified",
        "FITS-gzip_-32", "FITS-short", "FITS-no_data_after_the_header", "FITS-no_end",
        "FITS-no_axes", "FITS-naxis1_not_an_integer", "FITS-gzip_not_gzip",
        "FITS-bitpix_64_unidentified", "FITS-simple_false_unidentified",
        "FITS-naxis_missing_unidentified", "FITS-gzip_second_member_bad_crc",
        "FITS-gzip_second_member_bad_length", "FITS-gzip_second_member_cut",
        "FITS-gzip_garbage_after_the_zeros", "FITS-gzip_header_fields_cut",
        "FITS-gzip_method_not_deflate",
        "GBR-short", "GBR-v2_header_below_28", "GBR-bad_magic_unidentified",
        "GBR-depth_3_unidentified", "GBR-width_0_unidentified",
        "IMT-short", "IMT-no_image_mark", "IMT-width_not_a_number",
        "IMT-lone_star_ends_the_header_unidentified", "IMT-long_line_unidentified",
        "IMT-no_pixel_line_unidentified",
        "FTEX-dxt1_short", "FTEX-raw_short", "FTEX-two_formats", "FTEX-format_2",
        "FTEX-header_cut_unidentified",
        "IM-mode_not_in_the_table", "IM-RLB", "IM-PA_as_LA", "IM-short", "IM-size_not_a_number",
        "IM-size_three_numbers", "IM-size_of_floats", "IM-lut_short_unidentified",
        "IM-size_one_number_unidentified", "IM-no_known_key_unidentified",
        "IM-no_data_mark_unidentified", "IM-line_over_100_unidentified",
        "BLP-blp1_palette_short", "BLP-blp2_palette_mipmap_past_the_file",
        "BLP-blp2_palette_cut", "BLP-blp1_encoding_3", "BLP-blp2_compression_0",
        "BLP-blp2_encoding_3", "BLP-blp2_alpha_encoding_8", "BLP-blp2_dxt5_short",
        "BLP-blp1_jpeg_larger_than_its_jpeg", "BLP-blp1_jpeg_not_a_jpeg",
        "BLP-header_cut_unidentified", "BLP-width_0_unidentified",
        "FLI-prefix_chunk", "FLI-unknown_chunk", "FLI-brun_line_short", "FLI-lc_past_the_image",
        "FLI-chunk_past_its_frame", "FLI-last_chunk_under_10_bytes",
        "FLI-copy_short_of_its_image", "FLI-frame_cut", "FLI-no_frames_unidentified",
        "FLI-reserved_bytes_unidentified", "FLI-palette_past_256_unidentified",
        "FLI-copy_left_over_4294967280_3000", "FLI-copy_left_over_5001_3",
        "FLI-copy_left_over_5001_6000", "FLI-copy_left_over_9_0", "FLI-copy_left_over_9_1",
        "PCD-short", "PCD-header_cut_unidentified",
        "IPTC-raw_standard_extended_size", "IPTC-jpeg_rgb_band_of_rgb", "IPTC-raw_short",
        "IPTC-band_past_the_bands", "IPTC-compression_2", "IPTC-no_compression",
        "IPTC-no_image_record", "IPTC-garbage_after_the_image", "IPTC-field_length_over_132",
        "IPTC-layers_2_unidentified", "IPTC-no_layers_unidentified",
        "IPTC-empty_compression_unidentified",
        "IPTC-png_bilevel_band_3_of_3", "IPTC-png_bilevel_band_2_of_4",
        "IPTC-png_rgb_band_1_of_3", "IPTC-png_rgb_band_3_of_3", "IPTC-png_rgb_band_2_of_4",
        "IPTC-bmp_bilevel_band_3_of_3", "IPTC-bmp_bilevel_band_2_of_4",
        "IPTC-pbm_band_3_of_3", "IPTC-pbm_band_2_of_4",
        "IPTC-ppm_rgb_band_1_of_3", "IPTC-ppm_rgb_band_3_of_3", "IPTC-ppm_rgb_band_2_of_4",
        "IPTC-pgm_16_band_3_of_3", "IPTC-pgm_16_band_2_of_4",
        "IPTC-pfm_band_3_of_3", "IPTC-pfm_band_2_of_4",
        "IPTC-gif_band_3_of_3", "IPTC-gif_band_2_of_4",
    ])


def test_photo_ycc_tables_on_every_value():
    """PhotoCD's YCC → RGB (``fli_pcd.cc``'s tables, UnpackYCC.c's) on every
    luma value against every value of each chroma, and on random triples
    (green adds both chroma tables)."""
    k = np.arange(256, dtype=np.uint8)
    y = np.tile(np.tile(k, 3)[:768], (512, 1))
    for c in (k, k[::-1]):
        rows = np.repeat(np.tile(c, 2)[:256, None], 384, 1)
        for cb, cr in ((rows, np.full_like(rows, 137)), (np.full_like(rows, 156), rows),
                       (rows, rows[::-1])):
            data = pcd_file(y, cb, cr)
            np.testing.assert_array_equal(codec.decode(data), _pil(data))


def test_kept_refusals_are_named():
    """What Pillow cannot decode here stays refused by name, ahead of TGA."""
    for data, fmt in ((b"BUFR" + bytes(40), "BUFR"), (b"GRIB\0\0\0\x01" + bytes(40), "GRIB"),
                      (b"\x89HDF\r\n\x1a\n" + bytes(40), "HDF5"),
                      (b"\x00\x00\x01\xb3" + bytes(40), "MPEG")):
        with pytest.raises(ValueError, match=f"unsupported image format: {fmt}"):
            codec.decode(data)
    assert {f for f, _, o in codec._FORMATS if getattr(o, "__qualname__", "").startswith(
        "_refused")} == {"BUFR", "EPS", "GRIB", "HDF5", "MPEG", "WMF"}


# ---------------------------------------------------------------------------
# A differential fuzz of FLI, BLP, IM and FITS
# ---------------------------------------------------------------------------

FUZZ = {"FLI": 900, "BLP": 900, "IM": 1200, "FITS": 900}
# the bytes an edit may land in: each format's header (and FLI's chunk heads)
_HEADER = {"FLI": 220, "BLP": 156, "IM": 512, "FITS": 2880}
_TEXT = b"0123456789 *,.:=-+/'TFLRGBIPAXYCMK\r\n\x1a\x00"


def _fuzz_files(fmt: str) -> list:
    """The format's decodable cases (not BLP1's JPEG: its mipmap would be
    libjpeg-turbo's, whose SIMD IDCT this process uses)."""
    return [d for k, d in _cases()[fmt].items()
            if _pil_or_none(d) is not None and "jpeg" not in k and len(d) < 60000]


def _mutate(data: bytes, fmt: str, rng) -> bytes:
    """One to three edits in the header (a random byte, or one a header's
    text uses), and a cut of the file one time in four."""
    b = bytearray(data)
    span = min(len(b), _HEADER[fmt])
    if fmt == "FITS":
        span = min(span, data.index(b"END     ") + 80)
    for _ in range(int(rng.integers(1, 4))):
        at = int(rng.integers(span))
        b[at] = int(rng.integers(256)) if rng.random() < 0.5 else _TEXT[int(rng.integers(
            len(_TEXT)))]
    if rng.random() < 0.25:
        b = b[:int(rng.integers(1, len(b) + 1))]
    return bytes(b)


@pytest.mark.parametrize("fmt", sorted(FUZZ))
def test_fuzz_agrees_with_pillow(fmt):
    """``FUZZ[fmt]`` header edits and cuts of the format's files at seed 24:
    Pillow and the port both fail, or give equal pixels. Every
    disagreement counts; none is excused."""
    rng = np.random.default_rng(24)
    files = _fuzz_files(fmt)
    disagreements = []
    for i in range(FUZZ[fmt]):
        data = _mutate(files[i % len(files)], fmt, rng)
        want, got = _pil_or_none(data), _port_or_none(data)
        if (want is None) != (got is None) or (
                want is not None and (want.shape != got.shape or not np.array_equal(want, got))):
            disagreements.append(i)
    assert disagreements == [], f"{len(disagreements)} of {FUZZ[fmt]}: {disagreements[:10]}"


def test_divergences_that_stay():
    """Readings Pillow has and the port refuses by name: an IPTC record of
    one band that is not L or 1 as the first band of RGB or CMYK
    (ImagingMerge takes a palette image's indices as the band) and a
    record of a format whose mode the port does not read (a GIF's). An IM
    image of mode LAB, once refused here, now converts to Pillow's pixels
    through the port's LittleCMS arithmetic. A 16-bit or float record as
    the first band is refused: there Pillow's merge crashes the process
    (run apart, so as not to crash this one)."""
    rgb = scene(12, 10, 3)
    gif = iptc_file(10, 12, _save(Image.fromarray(rgb).quantize(16), "GIF"), 3, 1,
                    compression=5, band=1)
    png_p = iptc_file(10, 12, _save(Image.fromarray(rgb).quantize(16), "PNG"), 4, 1,
                      compression=5, band=1)
    lab = im_file(b"Greyscale", 10, 12, rgb[..., 0].tobytes()).replace(
        b"Image type: Greyscale image", b"Image type: LAB")
    for data, fmt in ((gif, "IPTC"), (png_p, "IPTC")):
        assert _pil_or_none(data) is not None
        with pytest.raises(ValueError, match=f"unsupported {fmt}"):
            codec.decode(data)
    np.testing.assert_array_equal(codec.decode(lab), _pil(lab))
    pgm16 = iptc_file(10, 12, _save(Image.fromarray(rgb[..., 0].astype(np.uint16) * 200),
                                    "PPM"), 3, 1, compression=5, band=1)
    with pytest.raises(ValueError, match="unsupported IPTC: a PPM record of mode I"):
        codec.decode(pgm16)
    crash = subprocess.run([sys.executable, "-c", "import io, sys; from PIL import Image; "
                            "Image.open(io.BytesIO(sys.stdin.buffer.read())).load()"],
                           input=pgm16, capture_output=True)
    assert crash.returncode < 0  # killed by a signal


def test_fits_gzip_bomb_inflates_in_bounded_memory():
    """A one-pixel GZIP_1 FITS whose heap inflates to 64 MiB (four members
    of 16 MiB): the port checks every member as gzip.decompress does and
    keeps only the image's 4 bytes, under 4 MiB at its peak; Pillow's
    pixel."""
    data = fits_file(np.array([[7]], np.uint8), 8, gzip_tile=True)
    zeros = gzip.compress(bytes(16 << 20), compresslevel=1, mtime=0)
    bomb = data[:data.index(b"\x1f\x8b")] + gzip.compress(b"\0\0\0\x07" + bytes((16 << 20) - 4),
                                                         compresslevel=1, mtime=0) + zeros * 3
    tracemalloc.start()
    try:
        got = codec.decode(bomb)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 4 << 20, peak
    np.testing.assert_array_equal(got, _pil(bomb))
    np.testing.assert_array_equal(got, [[[7, 7, 7]]])


def test_fli_small_read_blocks_cost_linear_time():
    """A 26-byte first frame makes ImageFile.load read 26 bytes at a time;
    its COPY chunk, left over, is then read as a frame as long as the file
    (8 MiB here). The port reaches Pillow's end, the truncated frame, in
    one further decoder call: well under a second (joining the reads one
    by one, as Pillow does, copies terabytes)."""
    data = fli_file([fli_frame(struct.pack("<IH", 0xFFFFFFF0, 16) + bytes(4))], 30, 23)
    start = time.perf_counter()
    with pytest.raises(ValueError, match="truncated FLI"):
        codec.decode(data + bytes(8 << 20))
    assert time.perf_counter() - start < 2.0


def test_jax_bytes_to_pil_gives_the_same_arrays():
    """The JAX ``core/imaging.py::bytes_to_pil`` on the first two files of
    each format."""
    for fmt, cases in _cases().items():
        for name, data in list(cases.items())[:2]:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                want = np.asarray(jimaging.bytes_to_pil(data))
            np.testing.assert_array_equal(codec.decode(data), want, err_msg=f"{fmt} {name}")
