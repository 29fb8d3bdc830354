"""Attention dispatch for the MMDiT joint stream.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/ops/attention.py``
without its TPU mesh wrappers. Layout (B, H, L, D).
"""

from __future__ import annotations

from typing import Optional

import torch

from qwen_image_edit_streamdiffusion_tpu_torch.ops import flash_attention

reference_attention = flash_attention.joint_attention_plain


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
