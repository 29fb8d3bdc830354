"""MMDiT diffusion transformer (QwenImageTransformer2DModel).

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/models/transformer.py``:
joint attention over [txt ⊕ img] per block (through ops.attention → K1),
per-stream AdaLN modulation with the (1 + scale) in f32, QK RMSNorm,
interleaved-pair 3D RoPE, and 2×2-packed 16-channel latents.
Sequences are (B, L, D); attention uses (B, H, L, D).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from qwen_image_edit_streamdiffusion_tpu_torch.core.config import ModelConfig
from qwen_image_edit_streamdiffusion_tpu_torch.core.meshes import SINGLE, Group
from qwen_image_edit_streamdiffusion_tpu_torch.models.common import (
    Params,
    column_input,
    gather_linear,
    gelu_tanh,
    layer_norm,
    linear,
    linear_init,
    rms_norm,
    rms_norm_init,
    row_linear,
    timestep_embedding,
)
from qwen_image_edit_streamdiffusion_tpu_torch.ops import rope as rope_ops
from qwen_image_edit_streamdiffusion_tpu_torch.ops.attention import attention


def pack_latents(latents: torch.Tensor) -> torch.Tensor:
    """(B, h, w, C) NHWC latents → (B, (h/2)(w/2), 4C) tokens, channel-major
    over the 2×2 patch."""
    b, h, w, c = latents.shape
    x = latents.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_latents(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, (h/2)(w/2), 4C) tokens → (B, h, w, C) NHWC latents."""
    b, n, d = tokens.shape
    c = d // 4
    x = tokens.reshape(b, h // 2, w // 2, c, 2, 2)
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h, w, c)


def _block_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    d = cfg.inner_dim

    def lin(i, o):
        return linear_init(gen, i, o, dtype, device)

    attn = {name: lin(d, d) for name in
            ("img_q", "img_k", "img_v", "txt_q", "txt_k", "txt_v")}
    for name in ("img_norm_q", "img_norm_k", "txt_norm_q", "txt_norm_k"):
        attn[name] = rms_norm_init(cfg.head_dim, dtype, device)
    attn["img_out"] = lin(d, d)
    attn["txt_out"] = lin(d, d)
    return {
        "img_mod": lin(d, 6 * d),
        "txt_mod": lin(d, 6 * d),
        "attn": attn,
        "img_mlp": {"fc1": lin(d, cfg.mlp_dim), "fc2": lin(cfg.mlp_dim, d)},
        "txt_mlp": {"fc1": lin(d, cfg.mlp_dim), "fc2": lin(cfg.mlp_dim, d)},
    }


def init(gen: torch.Generator, cfg: ModelConfig, device="cpu",
         block_hook=None) -> Params:
    """Random-init params on ``device`` in ``cfg.dtype`` (unfused q/k/v).
    ``block_hook(("blocks", str(i)), block)`` replaces each block as soon as
    it is drawn, before the next (a sharded build slices it there)."""
    hook = block_hook or (lambda prefix, blk: blk)
    dtype = getattr(torch, cfg.dtype)
    d = cfg.inner_dim
    return {
        "img_in": linear_init(gen, cfg.in_channels, d, dtype, device),
        "txt_norm": rms_norm_init(cfg.joint_dim, dtype, device),
        "txt_in": linear_init(gen, cfg.joint_dim, d, dtype, device),
        "time_mlp": {
            "fc1": linear_init(gen, cfg.time_freq_dim, d, dtype, device),
            "fc2": linear_init(gen, d, d, dtype, device),
        },
        "blocks": [hook(("blocks", str(i)), _block_init(gen, cfg, dtype, device))
                   for i in range(cfg.num_layers)],
        "norm_out": {"linear": linear_init(gen, d, 2 * d, dtype, device)},
        "proj_out": linear_init(gen, d, cfg.out_channels, dtype, device),
    }


class RopeTables(NamedTuple):
    img_cos: torch.Tensor  # (L_img, head_dim/2) f32
    img_sin: torch.Tensor
    txt_cos: torch.Tensor  # (L_txt, head_dim/2) f32
    txt_sin: torch.Tensor


def make_rope(cfg: ModelConfig, img_shapes: Sequence[Tuple[int, int, int]],
              txt_len: int, device="cpu") -> RopeTables:
    """The rope tables of a (img_shapes, txt_len) bucket on ``device``, built
    and uploaded once, then served from a small cache (the JAX package holds
    them as constants of each jitted graph): a repeated request or stream
    frame copies no table to the card. Callers never write to them."""
    return _rope_tables(tuple(cfg.axes_dims_rope), float(cfg.rope_theta),
                        tuple(tuple(s) for s in img_shapes), int(txt_len),
                        str(torch.device(device)))


@functools.lru_cache(maxsize=32)
def _rope_tables(axes_dim, theta, img_shapes, txt_len, device) -> RopeTables:
    ia = rope_ops.image_angles(img_shapes, axes_dim, theta)
    ta = rope_ops.text_angles(txt_len, img_shapes, axes_dim, theta)
    return RopeTables(*rope_ops.cos_sin(ia, device), *rope_ops.cos_sin(ta, device))


def _heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, L, H*D) → (B, H, L, D), contiguous."""
    b, l, hd = x.shape
    return x.reshape(b, l, n, hd // n).transpose(1, 2).contiguous()


def _unheads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def _modulate(x: torch.Tensor, mod: torch.Tensor, eps: float):
    """Affine-free LayerNorm then (1 + scale)·x + shift; returns (y, gate)."""
    shift, scale, gate = mod.chunk(3, dim=-1)
    y = layer_norm(x, eps)
    y = torch.addcmul(shift[:, None, :].to(y.dtype), y,
                      (1.0 + scale[:, None, :].float()).to(y.dtype))
    return y, gate[:, None, :]


def _joint_attention(p: Params, cfg: ModelConfig, img, txt, ropes: RopeTables,
                     txt_mask: Optional[torch.Tensor], use_flash: bool,
                     tp: Group = SINGLE):
    nh = cfg.num_heads // tp.size  # this rank's heads
    img, txt = column_input(img, tp), column_input(txt, tp)
    if "img_qkv" in p:  # fused projections (models.optimize.fuse_qkv)
        iq, ik, iv = (_heads(t, nh) for t in linear(p["img_qkv"], img).chunk(3, -1))
        tq, tk, tv = (_heads(t, nh) for t in linear(p["txt_qkv"], txt).chunk(3, -1))
    else:
        iq, ik, iv = (_heads(linear(p[n], img), nh)
                      for n in ("img_q", "img_k", "img_v"))
        tq, tk, tv = (_heads(linear(p[n], txt), nh)
                      for n in ("txt_q", "txt_k", "txt_v"))

    iq = rope_ops.apply_rope(rms_norm(p["img_norm_q"], iq, cfg.eps),
                             ropes.img_cos, ropes.img_sin)
    ik = rope_ops.apply_rope(rms_norm(p["img_norm_k"], ik, cfg.eps),
                             ropes.img_cos, ropes.img_sin)
    tq = rope_ops.apply_rope(rms_norm(p["txt_norm_q"], tq, cfg.eps),
                             ropes.txt_cos, ropes.txt_sin)
    tk = rope_ops.apply_rope(rms_norm(p["txt_norm_k"], tk, cfg.eps),
                             ropes.txt_cos, ropes.txt_sin)

    # joint sequence: text first, then image
    q = torch.cat([tq, iq], dim=2)
    k = torch.cat([tk, ik], dim=2)
    v = torch.cat([tv, iv], dim=2)
    del iq, ik, iv, tq, tk, tv

    kv_mask = None
    if txt_mask is not None:
        img_ones = torch.ones((img.shape[0], img.shape[1]), dtype=torch.bool,
                              device=img.device)
        kv_mask = torch.cat([txt_mask.bool(), img_ones], dim=1)

    # only the bucketed text prefix can hold padded keys
    out = _unheads(attention(q, k, v, kv_mask=kv_mask, use_flash=use_flash,
                             mask_len=txt.shape[1]))
    lt = txt.shape[1]
    return (row_linear(p["img_out"], out[:, lt:], tp),
            row_linear(p["txt_out"], out[:, :lt], tp))


def _block(p: Params, cfg: ModelConfig, img, txt, temb_act, ropes,
           txt_mask, use_flash: bool, tp: Group = SINGLE):
    img_mod1, img_mod2 = gather_linear(p["img_mod"], temb_act, tp).chunk(2, dim=-1)
    txt_mod1, txt_mod2 = gather_linear(p["txt_mod"], temb_act, tp).chunk(2, dim=-1)

    img_n, img_gate1 = _modulate(img, img_mod1, cfg.eps)
    txt_n, txt_gate1 = _modulate(txt, txt_mod1, cfg.eps)
    img_attn, txt_attn = _joint_attention(p["attn"], cfg, img_n, txt_n, ropes,
                                          txt_mask, use_flash, tp)
    img = torch.addcmul(img, img_gate1.to(img.dtype), img_attn)
    txt = torch.addcmul(txt, txt_gate1.to(txt.dtype), txt_attn)

    img_n, img_gate2 = _modulate(img, img_mod2, cfg.eps)
    txt_n, txt_gate2 = _modulate(txt, txt_mod2, cfg.eps)
    img_n, txt_n = column_input(img_n, tp), column_input(txt_n, tp)
    img = torch.addcmul(img, img_gate2.to(img.dtype), row_linear(
        p["img_mlp"]["fc2"], gelu_tanh(linear(p["img_mlp"]["fc1"], img_n)), tp))
    txt = torch.addcmul(txt, txt_gate2.to(txt.dtype), row_linear(
        p["txt_mlp"]["fc2"], gelu_tanh(linear(p["txt_mlp"]["fc1"], txt_n)), tp))
    return img, txt


def forward(params: Params, cfg: ModelConfig, img_tokens: torch.Tensor,
            txt_embeds: torch.Tensor, timesteps: torch.Tensor,
            ropes: RopeTables, txt_mask: Optional[torch.Tensor] = None,
            use_flash: bool = True, remat: bool = False,
            blocks_extra: Optional[Sequence] = None,
            block_map=None, tp: Group = SINGLE) -> torch.Tensor:
    """Velocity for every image token: (B, L_img, out_channels).

    remat=True checkpoints each block (``torch.utils.checkpoint``,
    non-reentrant): the backward keeps only the block-boundary residual
    streams and reruns the block. block_map(block_params, extra) derives a
    block's effective params from its entry of ``blocks_extra`` (LoRA
    adapters) inside the checkpointed region, so the merged weights are
    recomputed in the backward and never saved.

    tp: this rank's model group when the block leaves hold its slices
    (``parallel/sharding.py``): q/k/v, ``fc1`` and the modulations are
    column-parallel, ``img_out`` / ``txt_out`` / ``fc2`` row-parallel (one
    all-reduce each, the bias added after it), the modulation vectors
    all-gathered before they are chunked; attention runs on the rank's
    ``num_heads / tp`` heads. The top-level leaves are whole. Under
    autograd (a LoRA step) the inputs of the column-parallel linears sum
    their gradient over the group in the backward (``column_input``: four
    all-reduces a block, where they need a gradient) and the row-parallel
    sums pass theirs on unchanged."""
    img = linear(params["img_in"], img_tokens)
    txt = linear(params["txt_in"], rms_norm(params["txt_norm"], txt_embeds, cfg.eps))

    t_feat = timestep_embedding(timesteps, cfg.time_freq_dim, scale=1.0)
    temb = linear(params["time_mlp"]["fc2"],
                  F.silu(linear(params["time_mlp"]["fc1"], t_feat.to(img.dtype))))
    temb_act = F.silu(temb.float()).to(img.dtype)

    def apply(blk, extra, img, txt):
        if block_map is not None:
            blk = block_map(blk, extra)
        return _block(blk, cfg, img, txt, temb_act, ropes, txt_mask, use_flash, tp)

    extras = (blocks_extra if blocks_extra is not None
              else [None] * len(params["blocks"]))
    for blk, extra in zip(params["blocks"], extras):
        if remat:
            img, txt = checkpoint(apply, blk, extra, img, txt, use_reentrant=False)
        else:
            img, txt = apply(blk, extra, img, txt)

    # AdaLayerNormContinuous head: scale first, then shift
    scale, shift = linear(params["norm_out"]["linear"], temb_act).chunk(2, dim=-1)
    out = layer_norm(img, cfg.eps)
    out = out * (1.0 + scale[:, None, :]).to(out.dtype) + shift[:, None, :].to(out.dtype)
    return linear(params["proj_out"], out)
