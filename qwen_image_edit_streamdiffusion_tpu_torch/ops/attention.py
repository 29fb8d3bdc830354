"""Attention dispatch for the MMDiT joint stream.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/ops/attention.py``
without its TPU mesh wrappers. Layout (B, H, L, D).
"""

from __future__ import annotations

from typing import Optional

import torch

from qwen_image_edit_streamdiffusion_tpu_torch.ops import flash_attention

_NEG_INF = -1e30


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain attention with an f32 natural-base softmax, P cast to V's dtype
    before P·V: the JAX package's XLA ``reference_attention``, not a kernel's
    arithmetic (that is ``flash_attention.joint_attention_plain``). q, k, v
    (B, H, L, D); kv_mask (B, Lk) bool, True = attend."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask.bool()[:, None, None, :], _NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_mask: Optional[torch.Tensor] = None, use_flash: bool = True,
              mask_len: Optional[int] = None) -> torch.Tensor:
    """Joint-stream attention: when ``use_flash`` and the shape gate pass,
    the trainable flash attention (K7, then K8/K9 in the backward) if an
    input needs a gradient, else the K1 wrapper; the plain reference
    otherwise. On a CPU tensor each wrapper computes its plain version."""
    if use_flash and flash_attention.supported(q, k, v):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return flash_attention.flash_attention_auto(q, k, v, kv_mask, mask_len)
        return flash_attention.joint_attention(q, k, v, kv_mask, mask_len)
    return reference_attention(q, k, v, kv_mask)
