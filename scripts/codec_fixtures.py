"""Write the image codec's committed fixtures and their manifest.

    python scripts/codec_fixtures.py [--out tests/fixtures/codec]

The files are what the port's Pillow-free codec (``core/codec.py``) must
decode on a host without Pillow, as Pillow decodes them:

- ``prog_512_420.jpg``: 512², progressive, 4:2:0, quality 90 (Pillow);
- ``prog_1024.jpg`` and ``base_1024.jpg``: one 1024² image, progressive and
  baseline, 4:2:0, quality 90 (Pillow): the decode-time pair;
- ``adam7_rgb.png``: 8-bit RGB, Adam7-interlaced, a random filter a row;
- ``rgb16.png``: 16-bit RGB, not interlaced, a random filter a row.

Pillow writes neither interlaced nor 16-bit RGB PNG, so :func:`png_file`
writes both here with ``zlib``. ``manifest.json`` holds each file's shape and
the SHA-256 of Pillow's ``ImageOps.exif_transpose(...).convert("RGB")``
bytes. Run it where Pillow is installed; the images come from a numpy seed.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "fixtures", "codec")
# Adam7's passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _row_bytes(row: np.ndarray, depth: int) -> np.ndarray:
    """One row of samples (W, C) as its PNG bytes: big-endian at 16 bits,
    packed most significant bits first below 8."""
    if depth == 16:
        return np.frombuffer(row.astype(">u2").tobytes(), np.uint8)
    if depth == 8:
        return row.astype(np.uint8).reshape(-1)
    flat = row.reshape(-1).astype(np.uint16)
    per = 8 // depth
    flat = np.concatenate([flat, np.zeros(-len(flat) % per, np.uint16)]).reshape(-1, per)
    return (flat << np.arange(8 - depth, -1, -depth, dtype=np.uint16)).sum(-1).astype(np.uint8)


def _filtered(rows, bpp: int, rng) -> list:
    """Each row with a filter type drawn from ``rng`` (none, sub, up,
    average, Paeth) and its type byte in front."""
    out, prev = [], None
    for cur in rows:
        cur = cur.astype(np.int32)
        up = prev if prev is not None else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        f = int(rng.integers(0, 5))
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        out.append(bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    return out


def png_file(samples: np.ndarray, color_type: int, depth: int = 8, interlace: bool = False,
             palette: np.ndarray = None, trns: bytes = None, seed: int = 0) -> bytes:
    """A PNG of ``samples`` (H, W, C) at ``depth`` bits, Adam7-interlaced or
    not, each row (of each pass) filtered with a random filter type."""
    rng = np.random.default_rng(seed)
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    raw = []
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] and sub.shape[1]:  # a pass may be empty
            raw += _filtered([_row_bytes(r, depth) for r in sub], bpp, rng)
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color_type, 0, 0, int(interlace)))
    if palette is not None:
        data += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    return data + _chunk(b"IDAT", zlib.compress(b"".join(raw), 9)) + _chunk(b"IEND", b"")


def scene(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A smooth colour scene with a little noise (small files)."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0, 1, h)[:, None]
    x = np.linspace(0, 1, w)[None]
    a = np.stack([128 + 90 * np.sin(6 * x + 2 * y), 128 + 90 * np.cos(4 * y + 3 * x),
                  128 + 70 * np.sin(9 * x * y)], -1)
    return np.clip(a + rng.normal(0, 2, a.shape), 0, 255).astype(np.uint8)


def pil_rgb(data: bytes) -> np.ndarray:
    from PIL import Image, ImageOps

    return np.asarray(ImageOps.exif_transpose(Image.open(io.BytesIO(data))).convert("RGB"))


def fixtures() -> dict:
    """{file name: bytes}."""
    from PIL import Image

    def jpeg(arr, **kw):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", quality=90, subsampling=2, **kw)
        return buf.getvalue()

    big = scene(1024, 1024, 1)
    # the scene in the high bytes, noise in the low ones
    rgb16 = scene(72, 88, 3).astype(np.uint16) * 256 + np.random.default_rng(4).integers(
        0, 256, (72, 88, 3), np.uint16)
    return {
        "prog_512_420.jpg": jpeg(scene(512, 512, 0), progressive=True),
        "prog_1024.jpg": jpeg(big, progressive=True),
        "base_1024.jpg": jpeg(big),
        "adam7_rgb.png": png_file(scene(97, 131, 2), 2, interlace=True, seed=5),
        "rgb16.png": png_file(rgb16, 2, depth=16, seed=6),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    manifest = {}
    for name, data in fixtures().items():
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
        px = pil_rgb(data)
        manifest[name] = {"shape": list(px.shape), "bytes": len(data),
                          "sha256": hashlib.sha256(px.tobytes()).hexdigest()}
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    print(json.dumps(manifest, indent=1))


if __name__ == "__main__":
    main()
