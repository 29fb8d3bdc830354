"""KL image VAE (AutoencoderKLQwenImage, Wan2.1-style, single-frame 2D).

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/models/vae.py``: NHWC
activations and HWIO conv weights, channel RMS norms in f32, 3 stride-2
downsamples with (0, 1) padding, nearest-2× upsample convs that halve
channels, a single-head attention mid-block, and per-channel latent
normalization. Stride-1 SAME 3×3 convs with C_in <= 128 run on K3 through
``models.common.conv2d``. The mid-block attention stays plain torch (the
JAX package runs it as an XLA einsum, not through its flash kernel).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from qwen_image_edit_streamdiffusion_tpu_torch.core.config import VAEConfig
from qwen_image_edit_streamdiffusion_tpu_torch.models.common import (
    Params,
    conv2d,
    conv2d_init,
    rms_norm,
    rms_norm_init,
)


def _channel_rms(p: Params, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(p, x, eps=1e-12)


def _resblock_init(gen, in_ch: int, out_ch: int, dtype, device) -> Params:
    p = {
        "norm1": rms_norm_init(in_ch, dtype, device),
        "conv1": conv2d_init(gen, in_ch, out_ch, 3, dtype, device),
        "norm2": rms_norm_init(out_ch, dtype, device),
        "conv2": conv2d_init(gen, out_ch, out_ch, 3, dtype, device),
    }
    if in_ch != out_ch:
        p["shortcut"] = conv2d_init(gen, in_ch, out_ch, 1, dtype, device)
    return p


def _resblock(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = conv2d(p["conv1"], F.silu(_channel_rms(p["norm1"], x)))
    h = conv2d(p["conv2"], F.silu(_channel_rms(p["norm2"], h)))
    if "shortcut" in p:
        x = conv2d(p["shortcut"], x)
    return x + h


def _attnblock_init(gen, ch: int, dtype, device) -> Params:
    return {
        "norm": rms_norm_init(ch, dtype, device),
        "qkv": conv2d_init(gen, ch, 3 * ch, 1, dtype, device),
        "proj": conv2d_init(gen, ch, ch, 1, dtype, device),
    }


def _attnblock(p: Params, x: torch.Tensor, q_chunk: int = 4096) -> torch.Tensor:
    """Single-head spatial self-attention, query-chunked so the f32 score
    matrix never exceeds q_chunk × HW."""
    b, h, w, c = x.shape
    n = h * w
    qkv = conv2d(p["qkv"], _channel_rms(p["norm"], x)).reshape(b, n, 3, c)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    kt = k.float().transpose(1, 2)
    scale = c ** -0.5
    outs = []
    for s0 in range(0, n, q_chunk):
        s = torch.matmul(q[:, s0:s0 + q_chunk].float(), kt) * scale
        a = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.matmul(a, v))
    out = torch.cat(outs, dim=1).reshape(b, h, w, c)
    return x + conv2d(p["proj"], out)


def _downsample(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Zero-pad (0,1)×(0,1) then 3×3 stride-2 VALID conv."""
    return conv2d(p, F.pad(x, (0, 0, 0, 1, 0, 1)), stride=2, padding="VALID")


def _upsample(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Nearest 2× then 3×3 conv halving channels."""
    x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return conv2d(p, x)


def _stage_dims(cfg: VAEConfig) -> Tuple[int, ...]:
    return tuple(cfg.base_channels * m for m in (1,) + tuple(cfg.channel_multipliers))


def init(gen: torch.Generator, cfg: VAEConfig, device="cpu") -> Params:
    dtype = getattr(torch, cfg.dtype)
    dims = _stage_dims(cfg)
    z = cfg.latent_channels
    nstages = len(cfg.channel_multipliers)

    def conv(i, o, k=3):
        return conv2d_init(gen, i, o, k, dtype, device)

    enc: Params = {"conv_in": conv(3, dims[0])}
    down = []
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        stage: Params = {"res": []}
        c = cin
        for _ in range(cfg.num_res_blocks):
            stage["res"].append(_resblock_init(gen, c, cout, dtype, device))
            c = cout
        if i != nstages - 1:
            stage["downsample"] = conv(cout, cout)
        down.append(stage)
    enc["down"] = down
    mid = dims[-1]
    enc["mid"] = {"res1": _resblock_init(gen, mid, mid, dtype, device),
                  "attn": _attnblock_init(gen, mid, dtype, device),
                  "res2": _resblock_init(gen, mid, mid, dtype, device)}
    enc["norm_out"] = rms_norm_init(mid, dtype, device)
    enc["conv_out"] = conv(mid, 2 * z)

    rdims = dims[::-1]
    dec: Params = {"conv_in": conv(z, rdims[0])}
    dec["mid"] = {"res1": _resblock_init(gen, rdims[0], rdims[0], dtype, device),
                  "attn": _attnblock_init(gen, rdims[0], dtype, device),
                  "res2": _resblock_init(gen, rdims[0], rdims[0], dtype, device)}
    up = []
    for i, (cin, cout) in enumerate(zip(rdims[:-1], rdims[1:])):
        stage = {"res": []}
        c = cin if i == 0 else cin // 2  # upsample convs halve channels
        for _ in range(cfg.num_res_blocks + 1):
            stage["res"].append(_resblock_init(gen, c, cout, dtype, device))
            c = cout
        if i != nstages - 1:
            stage["upsample"] = conv(cout, cout // 2)
        up.append(stage)
    dec["up"] = up
    dec["norm_out"] = rms_norm_init(rdims[-1], dtype, device)
    dec["conv_out"] = conv(rdims[-1], 3)

    return {"encoder": enc, "decoder": dec,
            "quant_conv": conv(2 * z, 2 * z, 1),
            "post_quant_conv": conv(z, z, 1)}


def encode_moments(params: Params, cfg: VAEConfig, images: torch.Tensor
                   ) -> torch.Tensor:
    """images NHWC in [-1, 1] → (B, H/8, W/8, 2z) posterior moments."""
    p = params["encoder"]
    x = conv2d(p["conv_in"], images)
    for stage in p["down"]:
        for rb in stage["res"]:
            x = _resblock(rb, x)
        if "downsample" in stage:
            x = _downsample(stage["downsample"], x)
    x = _resblock(p["mid"]["res1"], x)
    x = _attnblock(p["mid"]["attn"], x)
    x = _resblock(p["mid"]["res2"], x)
    x = conv2d(p["conv_out"], F.silu(_channel_rms(p["norm_out"], x)))
    return conv2d(params["quant_conv"], x)


def _stats(cfg: VAEConfig, z: torch.Tensor):
    """The latent mean and std in ``z``'s dtype on its device, uploaded once
    (a fresh upload would make the host wait for the card at every call)."""
    return _stats_on(tuple(cfg.latents_mean), tuple(cfg.latents_std), z.dtype,
                     str(z.device))


@functools.lru_cache(maxsize=8)
def _stats_on(mean, std, dtype, device):
    return (torch.tensor(mean, dtype=dtype, device=device),
            torch.tensor(std, dtype=dtype, device=device))


def encode(params: Params, cfg: VAEConfig, images: torch.Tensor) -> torch.Tensor:
    """Posterior-mode normalized latents (B, H/8, W/8, z)."""
    mu = encode_moments(params, cfg, images)[..., :cfg.latent_channels]
    mean, std = _stats(cfg, mu)
    return (mu - mean) / std


def decode(params: Params, cfg: VAEConfig, latents: torch.Tensor) -> torch.Tensor:
    """Normalized latents (B, h, w, z) → images NHWC in [-1, 1]."""
    mean, std = _stats(cfg, latents)
    z = conv2d(params["post_quant_conv"], latents * std + mean)
    p = params["decoder"]
    x = conv2d(p["conv_in"], z)
    x = _resblock(p["mid"]["res1"], x)
    x = _attnblock(p["mid"]["attn"], x)
    x = _resblock(p["mid"]["res2"], x)
    for stage in p["up"]:
        for rb in stage["res"]:
            x = _resblock(rb, x)
        if "upsample" in stage:
            x = _upsample(stage["upsample"], x)
    x = conv2d(p["conv_out"], F.silu(_channel_rms(p["norm_out"], x)))
    return x.clamp(-1.0, 1.0)
