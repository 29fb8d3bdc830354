"""Image geometry and resize without Pillow.

Counterpart of the parts of ``qwen_image_edit_streamdiffusion_tpu/core/imaging.py``
that the edit main path uses. The JAX module imports PIL at its top and
resizes with LANCZOS (and the VL encoder with BICUBIC); the port takes uint8
numpy arrays and computes Pillow's own resampling (``ImagingResample`` of
8-bit images) in torch on the host, so both packages give the same bytes.
"""

from __future__ import annotations

import functools
import math
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


_FILTERS = {"lanczos": (_lanczos, 3.0), "bicubic": (_bicubic, 2.0)}


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
    """Resize an (H, W, 3) uint8 array as Pillow's ``Image.resize`` does with
    ``LANCZOS`` (``filter="lanczos"``) or ``BICUBIC`` (``"bicubic"``), bit
    for bit: the horizontal pass first, rounded and clipped to uint8 before
    the vertical pass, and a pass skipped where its size does not change.
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
