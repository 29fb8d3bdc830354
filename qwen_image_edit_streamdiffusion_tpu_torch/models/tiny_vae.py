"""Tiny latent decoder and encoder — the TAESD-analog pair.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/models/tiny_vae.py``:

- decoder: conv_in → [nearest 2× upsample + conv, then residual
  relu→conv→relu→conv blocks] per stage → relu → conv_out → clip to [-1, 1];
  it reads the pipeline's normalized latents directly (the VAE's per-channel
  affine is learnt by its first conv);
- encoder: conv_in → [blocks, then relu → stride-2 SAME conv] per stage →
  relu → conv_out, writing normalized latents.

One uniform ``width`` of channels, NHWC activations and HWIO weights. Every
conv is ``F.conv2d`` (``use_kernel=False``), as the JAX chain opts out of its
Pallas conv (``use_pallas=False``) and runs on XLA. The stride-2 convs pad as
XLA's "SAME" does (0 before and 1 after on an even size;
``models.common.same_padding``).

Artifacts are flat ``.safetensors`` files with ``/``-joined nested keys
(``stages/0/blocks/1/conv2/w``), the JAX package's layout, so they cross
between the packages both ways; the config is inferred from the shapes, as
the JAX ``load`` / ``load_encoder`` infer it. They are written and read with
the port's own writer and reader (``models/lora.py::save_safetensors``,
``models/convert.py::load_safetensors``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from qwen_image_edit_streamdiffusion_tpu_torch.core.config import VAEConfig
from qwen_image_edit_streamdiffusion_tpu_torch.models.common import (
    Params,
    conv2d,
    conv2d_init,
    flatten,
    unflatten,
)


def _log2(n: int, what: str) -> int:
    k = n.bit_length() - 1
    if 1 << k != n:
        raise ValueError(f"{what} must be a power of 2, got {n}")
    return k


@dataclasses.dataclass(frozen=True)
class TinyDecoderConfig:
    """``spatial_upsample`` must match the paired VAE's ``spatial_downsample``."""

    latent_channels: int = 16
    width: int = 64
    blocks_per_stage: int = 2
    spatial_upsample: int = 8
    dtype: str = "bfloat16"

    @classmethod
    def from_vae(cls, vae_cfg: VAEConfig, width: int = 64,
                 blocks_per_stage: int = 2,
                 dtype: str | None = None) -> "TinyDecoderConfig":
        return cls(latent_channels=vae_cfg.latent_channels, width=width,
                   blocks_per_stage=blocks_per_stage,
                   spatial_upsample=vae_cfg.spatial_downsample,
                   dtype=dtype or vae_cfg.dtype)

    @property
    def num_upsamples(self) -> int:
        return _log2(self.spatial_upsample, "spatial_upsample")


@dataclasses.dataclass(frozen=True)
class TinyEncoderConfig:
    """``spatial_downsample`` must match the paired VAE's."""

    latent_channels: int = 16
    width: int = 64
    blocks_per_stage: int = 2
    spatial_downsample: int = 8
    dtype: str = "bfloat16"

    @classmethod
    def from_vae(cls, vae_cfg: VAEConfig, width: int = 64,
                 blocks_per_stage: int = 2,
                 dtype: str | None = None) -> "TinyEncoderConfig":
        return cls(latent_channels=vae_cfg.latent_channels, width=width,
                   blocks_per_stage=blocks_per_stage,
                   spatial_downsample=vae_cfg.spatial_downsample,
                   dtype=dtype or vae_cfg.dtype)

    @property
    def num_downsamples(self) -> int:
        return _log2(self.spatial_downsample, "spatial_downsample")


def _block_init(gen, width: int, dtype, device) -> Params:
    return {"conv1": conv2d_init(gen, width, width, 3, dtype, device),
            "conv2": conv2d_init(gen, width, width, 3, dtype, device)}


def _conv(p: Params, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    return conv2d(p, x, stride=stride, use_kernel=False)


def _block(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = _conv(p["conv1"], F.relu(x))
    h = _conv(p["conv2"], F.relu(h))
    return x + h


def init(gen, cfg: TinyDecoderConfig, device="cpu") -> Params:
    """Random decoder params (Kaiming-uniform, as every port init)."""
    dtype = getattr(torch, cfg.dtype)
    w = cfg.width
    stages = []
    for i in range(cfg.num_upsamples + 1):
        stage: Params = {}
        if i > 0:
            stage["up"] = conv2d_init(gen, w, w, 3, dtype, device)
        stage["blocks"] = [_block_init(gen, w, dtype, device)
                           for _ in range(cfg.blocks_per_stage)]
        stages.append(stage)
    return {"conv_in": conv2d_init(gen, cfg.latent_channels, w, 3, dtype, device),
            "stages": stages,
            "conv_out": conv2d_init(gen, w, 3, 3, dtype, device)}


def decode(params: Params, cfg: TinyDecoderConfig,
           latents: torch.Tensor) -> torch.Tensor:
    """Normalized latents (B, h, w, z) → images NHWC in [-1, 1], in the
    config's dtype (the contract of ``models.vae.decode``)."""
    x = _conv(params["conv_in"], latents.to(getattr(torch, cfg.dtype)))
    for stage in params["stages"]:
        if "up" in stage:
            x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            x = _conv(stage["up"], x)
        for blk in stage["blocks"]:
            x = _block(blk, x)
    x = _conv(params["conv_out"], F.relu(x))
    return x.clamp(-1.0, 1.0)


def encoder_init(gen, cfg: TinyEncoderConfig, device="cpu") -> Params:
    dtype = getattr(torch, cfg.dtype)
    w = cfg.width
    stages = []
    for i in range(cfg.num_downsamples + 1):
        stage: Params = {"blocks": [_block_init(gen, w, dtype, device)
                                    for _ in range(cfg.blocks_per_stage)]}
        if i < cfg.num_downsamples:
            stage["down"] = conv2d_init(gen, w, w, 3, dtype, device)
        stages.append(stage)
    return {"conv_in": conv2d_init(gen, 3, w, 3, dtype, device),
            "stages": stages,
            "conv_out": conv2d_init(gen, w, cfg.latent_channels, 3, dtype, device)}


def encode(params: Params, cfg: TinyEncoderConfig,
           images: torch.Tensor) -> torch.Tensor:
    """Images NHWC in [-1, 1] → normalized latents (B, h, w, z)."""
    x = _conv(params["conv_in"], images.to(getattr(torch, cfg.dtype)))
    for stage in params["stages"]:
        for blk in stage["blocks"]:
            x = _block(blk, x)
        if "down" in stage:
            x = _conv(stage["down"], F.relu(x), stride=2)
    return _conv(params["conv_out"], F.relu(x))


# ---------------------------------------------------------------------------
# Artifacts
# ---------------------------------------------------------------------------


def save(path: str, params: Params) -> None:
    """Write a decoder or encoder tree as one flat ``.safetensors`` file with
    ``/``-joined keys, each tensor in the dtype it has (bf16 for a serving
    artifact, f32 when the caller exported it so)."""
    from qwen_image_edit_streamdiffusion_tpu_torch.models.lora import save_safetensors

    save_safetensors(path, flatten(params, sep="/"))


def _load_tree(path: str, device) -> Params:
    from qwen_image_edit_streamdiffusion_tpu_torch.models.convert import load_safetensors

    return unflatten(dict(load_safetensors(path, device)), sep="/")


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def load(path: str, device="cpu") -> Tuple[Params, TinyDecoderConfig]:
    """A decoder artifact → (params on ``device``, its config from shapes)."""
    params = _load_tree(path, device)
    w_in = params["conv_in"]["w"]
    stages = params["stages"]
    cfg = TinyDecoderConfig(
        latent_channels=int(w_in.shape[2]), width=int(w_in.shape[3]),
        blocks_per_stage=len(stages[0]["blocks"]),
        spatial_upsample=1 << sum(1 for s in stages if "up" in s),
        dtype=_dtype_name(w_in))
    return params, cfg


def load_encoder(path: str, device="cpu") -> Tuple[Params, TinyEncoderConfig]:
    """An encoder artifact → (params, config); a decoder file (conv_in not
    reading 3 channels) is refused, as in the JAX package."""
    params = _load_tree(path, device)
    w_in = params["conv_in"]["w"]
    if int(w_in.shape[2]) != 3:
        raise ValueError(
            f"{path!r} is not a tiny ENCODER artifact: conv_in reads "
            f"{int(w_in.shape[2])} channels, expected 3 (RGB)")
    stages = params["stages"]
    cfg = TinyEncoderConfig(
        latent_channels=int(params["conv_out"]["w"].shape[3]),
        width=int(w_in.shape[3]),
        blocks_per_stage=len(stages[0]["blocks"]),
        spatial_downsample=1 << sum(1 for s in stages if "down" in s),
        dtype=_dtype_name(w_in))
    return params, cfg
