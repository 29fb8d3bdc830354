"""RGB ↔ YCbCr 4:2:0, the ``transfer_format="yuv420"`` wire.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/ops/colorspace.py``:

- :func:`rgb_to_yuv420` / :func:`yuv420_to_rgb` run on the device in f32,
  with the JAX functions' operations in their order (BT.601 full-range
  matrix, 2×2 box-averaged chroma, nearest chroma upsample);
- :func:`pack_yuv420_host` / :func:`yuv420_to_rgb_host` run on the host in
  integer numpy with the fixed-point formulas and rounding of the JAX
  package's native library (``runtime/native/image_ops.cc``,
  ``qie_yuv420_pack`` / ``qie_yuv420_unpack``), which is what the JAX
  package runs wherever a compiler exists. Its Pillow fallback rounds
  differently (up to one code) and is not copied.

The packed layout is one uint8 buffer (..., H/2, W/2, 6): channels [0:4]
the 2×2 luma block, row-major, [4:6] Cb and Cr.
"""

from __future__ import annotations

import numpy as np
import torch


def rgb_to_yuv420(x32: torch.Tensor) -> torch.Tensor:
    """f32 RGB in [0, 255] (B, H, W, 3), H and W even → packed uint8
    (B, H/2, W/2, 6). Applies its own +0.5 rounding bias, so it takes the
    unrounded pixel values."""
    r, g, b = x32[..., 0], x32[..., 1], x32[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
    bsz, h, w = y.shape
    y_blk = y.reshape(bsz, h // 2, 2, w // 2, 2).permute(0, 1, 3, 2, 4)
    y_blk = y_blk.reshape(bsz, h // 2, w // 2, 4)
    c = torch.stack([cb, cr], dim=-1).reshape(bsz, h // 2, 2, w // 2, 2, 2)
    # the 2×2 mean as XLA reduces it: row-major, one add after another
    cbcr = (((c[:, :, 0, :, 0] + c[:, :, 0, :, 1]) + c[:, :, 1, :, 0])
            + c[:, :, 1, :, 1]) / 4.0
    packed = torch.cat([y_blk, cbcr], dim=-1)
    return (packed + 0.5).clamp(0.0, 255.0).to(torch.uint8)


def yuv420_to_rgb(packed: torch.Tensor) -> torch.Tensor:
    """Packed uint8 (B, H/2, W/2, 6) → f32 RGB (B, H, W, 3) in [0, 255],
    chroma nearest-upsampled: the upload direction's device half."""
    p = packed.float()
    bsz, h2, w2, _ = packed.shape
    y = p[..., :4].reshape(bsz, h2, w2, 2, 2).permute(0, 1, 3, 2, 4)
    y = y.reshape(bsz, 2 * h2, 2 * w2)

    def up(c):
        return c.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) - 128.0

    cb, cr = up(p[..., 4]), up(p[..., 5])
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)


def pack_yuv420_host(arr: np.ndarray) -> np.ndarray:
    """RGB uint8 (H, W, 3), H and W even → packed uint8 (H/2, W/2, 6), in
    the native library's 16-bit fixed point: luma rounded, each pixel's
    chroma clamped, then the 2×2 sum rounded by (s + 2) >> 2."""
    a = np.asarray(arr).astype(np.int32)
    h, w = a.shape[:2]
    r, g, b = a[..., 0], a[..., 1], a[..., 2]
    y = np.clip((19595 * r + 38470 * g + 7471 * b + 32768) >> 16, 0, 255)
    cb = np.clip(((-11056 * r - 21712 * g + 32768 * b + 32768) >> 16) + 128, 0, 255)
    cr = np.clip(((32768 * r - 27440 * g - 5328 * b + 32768) >> 16) + 128, 0, 255)
    y_blk = (y.reshape(h // 2, 2, w // 2, 2).transpose(0, 2, 1, 3)
             .reshape(h // 2, w // 2, 4))

    def avg(c):
        return (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]
                + 2) >> 2

    return np.concatenate([y_blk, avg(cb)[..., None], avg(cr)[..., None]],
                          axis=-1).astype(np.uint8)


def yuv420_to_rgb_host(packed: np.ndarray) -> np.ndarray:
    """Packed uint8 (H/2, W/2, 6) → RGB uint8 (H, W, 3), nearest chroma
    upsample, the native library's fixed-point inverse."""
    p = np.asarray(packed).astype(np.int32)
    h2, w2 = p.shape[:2]
    y = (p[..., :4].reshape(h2, w2, 2, 2).transpose(0, 2, 1, 3)
         .reshape(2 * h2, 2 * w2))
    cb, cr = p[..., 4] - 128, p[..., 5] - 128
    dr = (91881 * cr + 32768) >> 16
    dg = (22554 * cb + 46802 * cr + 32768) >> 16
    db = (116130 * cb + 32768) >> 16

    def up(d):
        return np.repeat(np.repeat(d, 2, axis=0), 2, axis=1)

    rgb = np.stack([y + up(dr), y - up(dg), y + up(db)], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)
