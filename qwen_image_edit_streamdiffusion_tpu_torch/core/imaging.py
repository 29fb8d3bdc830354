"""Image geometry, resize, test images and PNG files without Pillow.

Counterpart of the parts of ``qwen_image_edit_streamdiffusion_tpu/core/imaging.py``
that the edit main path and the stream use. The JAX module imports PIL at its
top and resizes with LANCZOS (the VL encoder with BICUBIC, the stream's
similarity signature with BILINEAR on Pillow's integer luma); the port takes
uint8 numpy arrays and computes Pillow's own resampling (``ImagingResample``
of 8-bit images) in torch, so both packages give the same bytes; and the
JAX package's native Lanczos-3 (the stream's preview upscale) bit for bit,
and ``Image.blend`` (the engine's ``ref_image`` composite) bit for bit.
"""

from __future__ import annotations

import functools
import math
import struct
import zlib
from typing import Tuple

import numpy as np
import torch


def calculate_dimensions(target_area: int, aspect_ratio: float,
                         multiple: int = 32) -> Tuple[int, int]:
    """(width, height) with w*h ≈ target_area, w/h ≈ aspect_ratio, both
    rounded to a multiple of ``multiple`` (same rule as the JAX package)."""
    width = math.sqrt(target_area * aspect_ratio)
    height = width / aspect_ratio
    width = max(multiple, round(width / multiple) * multiple)
    height = max(multiple, round(height / multiple) * multiple)
    return int(width), int(height)


def as_uint8_array(img) -> np.ndarray:
    """(H, W, 3) uint8 array from an array or — only when the caller hands
    one over — a PIL image (no PIL import happens here)."""
    if type(img).__module__.startswith("PIL."):
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got "
                         f"{arr.dtype} {arr.shape}")
    return arr


# Pillow's resampling: the filters with their support at scale 1, and the
# weights' fixed-point precision (PRECISION_BITS = 32 - 8 - 2).
_PRECISION_BITS = 22


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    return _sinc(x) * _sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


def _bilinear(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


_FILTERS = {"lanczos": (_lanczos, 3.0), "bicubic": (_bicubic, 2.0),
            "bilinear": (_bilinear, 1.0)}


@functools.lru_cache(maxsize=16)
def _coeffs(in_size: int, out_size: int, filt: str):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``: for each
    output pixel j its window start, and its weights (out, ksize) normalised
    to sum 1 in double and rounded half away from zero to 22 fractional bits
    (integers, held exactly in float64; 0 past the window). The filter runs
    through ``math`` per tap, as Pillow calls libm; the rest is vectorised."""
    kernel, support = _FILTERS[filt]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ss = 1.0 / filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero; both bounds are clipped to the input
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    x = np.arange(ksize)
    valid = x[None, :] < xmax[:, None]
    arg = ((x[None, :] + xmin[:, None]) - center[:, None] + 0.5) * ss
    w = np.zeros((out_size, ksize))
    w[valid] = [kernel(a) for a in arg[valid].tolist()]
    total = np.cumsum(w, axis=1)[:, -1:]  # in order, as Pillow sums
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    w = w * (1 << _PRECISION_BITS)
    w = np.where(w < 0, np.trunc(w - 0.5), np.trunc(w + 0.5))
    return xmin, xmax, np.where(valid, w, 0.0)


@functools.lru_cache(maxsize=16)
def _weights(in_size: int, out_size: int, filt: str, device: str):
    """The coefficients as a dense (in, out) float64 matrix on ``device``,
    and its bands: (first output, end output, first input, end input) for
    blocks of 32 outputs, so a pass multiplies only the inputs a block
    reads."""
    xmin, xmax, w = _coeffs(in_size, out_size, filt)
    m = np.zeros((in_size, out_size))
    rows = xmin[:, None] + np.arange(w.shape[1])[None, :]
    cols = np.broadcast_to(np.arange(out_size)[:, None], w.shape)
    valid = np.arange(w.shape[1])[None, :] < xmax[:, None]
    m[rows[valid], cols[valid]] = w[valid]
    end = xmin + xmax
    bands = tuple((o, min(o + 32, out_size), int(xmin[o]),
                   int(end[o:o + 32].max()))
                  for o in range(0, out_size, 32))
    return torch.from_numpy(m).to(device), bands


def _resample_last(x: torch.Tensor, out_size: int, filt: str) -> torch.Tensor:
    """One pass along the last axis of a float64 image of uint8 values:
    Σ weight · pixel + 2^21, shifted right by 22 bits (floor) and clipped to
    [0, 255]. Every product and partial sum is an integer below 2^53, so the
    float64 products are exact in any order: Pillow's int32 arithmetic."""
    m, bands = _weights(x.shape[-1], out_size, filt, str(x.device))
    out = x.new_empty(x.shape[:-1] + (out_size,))
    for o0, o1, lo, hi in bands:
        out[..., o0:o1] = x[..., lo:hi] @ m[lo:hi, o0:o1]
    out.add_(1 << (_PRECISION_BITS - 1)).mul_(2.0 ** -_PRECISION_BITS)
    return out.floor_().clamp_(0, 255)


def resize(arr: np.ndarray, width: int, height: int,
           filter: str = "lanczos", device="cpu") -> np.ndarray:
    """Resize an (H, W, C) uint8 array as Pillow's ``Image.resize`` does with
    ``LANCZOS`` (``filter="lanczos"``), ``BICUBIC`` (``"bicubic"``) or
    ``BILINEAR`` (``"bilinear"``), bit for bit: the horizontal pass first,
    rounded and clipped to uint8 before the vertical pass, and a pass
    skipped where its size does not change.
    The products run on ``device`` (the pipeline's card, where a request's
    resizes take a few ms against several times that on the host); the
    result comes back as a numpy array. Returns the input itself when it
    already has the size."""
    if filter not in _FILTERS:
        raise ValueError(f"resize: filter must be one of {sorted(_FILTERS)}, "
                         f"got {filter!r}")
    if arr.shape[1] == width and arr.shape[0] == height:
        return arr
    x = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    x = x.permute(2, 0, 1).double()
    if arr.shape[1] != width:
        x = _resample_last(x, width, filter)
    if arr.shape[0] != height:
        x = _resample_last(x.transpose(1, 2), height, filter).transpose(1, 2)
    return x.permute(1, 2, 0).to(torch.uint8).contiguous().cpu().numpy()


@functools.lru_cache(maxsize=16)
def _native_taps(src: int, dst: int):
    """The JAX package's native ``resize_lanczos`` weights for one axis
    (``runtime/native/image_ops.cc``: centre (o + 0.5)·scale − 0.5, taps
    floor(centre ± support + 0.5) clipped to the input, Lanczos-3 in double
    normalised to sum 1): (first input, weights (dst, taps)), 0 past a
    window."""
    scale = src / dst
    fs = max(scale, 1.0)
    support = 3.0 * fs
    taps = int(math.ceil(support)) * 2 + 1
    start = np.zeros(dst, np.int64)
    w = np.zeros((dst, taps))
    for o in range(dst):
        center = (o + 0.5) * scale - 0.5
        lo = max(math.floor(center - support + 0.5), 0)
        hi = min(math.floor(center + support + 0.5), src - 1)
        row = [_lanczos_native((lo + i - center) / fs) for i in range(hi - lo + 1)]
        total = 0.0
        for v in row:  # in order, as the library sums
            total += v
        w[o, :len(row)] = [v / total for v in row] if total != 0.0 else row
        start[o] = lo
    return start, w


def _lanczos_native(x: float) -> float:
    x = abs(x)
    return 0.0 if x >= 3.0 else _sinc(x) * _sinc(x / 3.0)


def _native_pass(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """One pass of the native resize along the last axis of a float64
    tensor: Σ weight · value over the taps in order, in double."""
    start, w = _native_taps(x.shape[-1], out_size)
    idx = torch.from_numpy(np.minimum(start[:, None] + np.arange(w.shape[1]),
                                      x.shape[-1] - 1)).to(x.device)
    w = torch.from_numpy(w).to(x.device)
    acc = torch.zeros(x.shape[:-1] + (out_size,), dtype=torch.float64, device=x.device)
    for i in range(w.shape[1]):
        acc += w[:, i] * x[..., idx[:, i]]
    return acc


def resize_native(arr: np.ndarray, width: int, height: int, device="cpu") -> np.ndarray:
    """Resize an (H, W, C) uint8 array as the JAX package's native
    ``runtime/native_ops.resize_lanczos`` does (its stream's preview
    upscale), bit for bit: the horizontal pass in double, stored as f32; the
    vertical pass in double, rounded half away from zero and clipped. It
    differs from Pillow's LANCZOS (:func:`resize`) by a few codes. Runs on
    ``device``; returns the input itself when it already has the size."""
    if arr.shape[0] == height and arr.shape[1] == width:
        return arr
    x = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    x = x.permute(2, 0, 1).double()
    tmp = _native_pass(x, width).float().double()
    acc = _native_pass(tmp.transpose(1, 2), height).transpose(1, 2)
    whole = torch.trunc(acc)
    acc = whole + torch.where((acc - whole).abs() >= 0.5, torch.sign(acc), 0.0)
    return acc.clamp_(0, 255).permute(1, 2, 0).to(torch.uint8).contiguous().cpu().numpy()


def blend(a: np.ndarray, b: np.ndarray, ratio: float) -> np.ndarray:
    """Composite two uint8 images as ``PIL.Image.blend(a, b, ratio)`` does
    (libImaging/Blend.c): a + ratio·(b − a) in float32, truncated to uint8,
    clipped first when ``ratio`` lies outside [0, 1]. ``b`` is resized
    (LANCZOS) to ``a``'s size when they differ, as the JAX ``blend`` does."""
    if a.shape != b.shape:
        b = resize(b, a.shape[1], a.shape[0])
    a32 = a.astype(np.float32)
    alpha = np.float32(ratio)
    out = a32 + alpha * (b.astype(np.float32) - a32)
    if not 0.0 <= alpha <= 1.0:
        out = np.clip(out, 0.0, 255.0)
    return out.astype(np.uint8)


def luma(arr: np.ndarray) -> np.ndarray:
    """(H, W) uint8 luma of an (H, W, 3) uint8 image, as Pillow's
    ``convert("L")``: (19595·R + 38470·G + 7471·B + 2^15) >> 16."""
    a = arr.astype(np.int32)
    return ((a[..., 0] * 19595 + a[..., 1] * 38470 + a[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def luma_signature(arr: np.ndarray, size: int = 32) -> np.ndarray:
    """(size, size) uint8 signature of an image: Pillow's
    ``convert("L").resize((size, size), BILINEAR)``, on the host."""
    return resize(luma(arr)[..., None], size, size, "bilinear")[..., 0]


def make_test_image(width: int = 512, height: int = 512, kind: str = "gradient",
                    phase: float = 0.0) -> np.ndarray:
    """The JAX package's synthetic fixtures as (height, width, 3) uint8
    arrays: ``gray`` (Pillow's "gray", 128), ``gradient``, ``circle`` and the
    animated ``sine`` pattern (``phase`` steps it per frame)."""
    if kind == "gray":
        return np.full((height, width, 3), 128, np.uint8)
    y = np.linspace(0, 1, height)[:, None]
    x = np.linspace(0, 1, width)[None, :]
    full = lambda a: np.broadcast_to(a, (height, width))
    if kind == "gradient":
        img = np.stack([100 + 100 * full(y), 100 + 100 * full(x),
                        np.full((height, width), 150.0)], axis=-1)
    elif kind == "circle":
        img = np.stack([255 * full(y), 255 * full(x),
                        np.full((height, width), 128.0)], axis=-1)
        yy = (np.arange(height)[:, None] - height / 2) ** 2
        xx = (np.arange(width)[None, :] - width / 2) ** 2
        img[yy + xx < (min(width, height) / 5) ** 2] = [255.0, 32.0, 32.0]
    elif kind == "sine":
        t = float(phase)
        img = np.stack([127 + 127 * np.sin(full(x * width / 50) + t),
                        127 + 127 * np.sin(full(y * height / 50) + t),
                        127 + 127 * np.sin((x * width + y * height) / 70 + t)],
                       axis=-1)
    else:
        raise ValueError(f"unknown test image kind {kind!r}")
    return img.astype(np.uint8)


def write_png(path: str, arr: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG (zlib, no filter)."""
    arr = as_uint8_array(arr)
    h, w, _ = arr.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(arr).reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))
