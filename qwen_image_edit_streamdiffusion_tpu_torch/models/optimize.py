"""Load-time param-tree optimizations.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/models/optimize.py``:
:func:`fuse_qkv` concatenates each stream's q/k/v projections into one
(3D, D) linear per block, so a block runs 2 projection GEMMs instead of 6.
"""

from __future__ import annotations

from typing import Any

import torch


def _cat(ts) -> torch.Tensor:
    if ts[0].device.type == "meta":
        # a shape only: torch.cat's meta kernel would import torch._dynamo
        # (seconds, once a process) for a checkpoint's skeleton
        return torch.empty((sum(t.shape[0] for t in ts),) + tuple(ts[0].shape[1:]),
                           dtype=ts[0].dtype, device="meta")
    return torch.cat(ts, dim=0)


def fuse_three(a: dict, b: dict, c: dict) -> dict:
    out = {"weight": _cat([a["weight"], b["weight"], c["weight"]])}
    if "bias" in a:
        out["bias"] = _cat([a["bias"], b["bias"], c["bias"]])
    return out


def fuse_qkv(params: Any) -> Any:
    """Fuse the transformer's per-stream q/k/v projections IN PLACE (unlike
    the pure JAX version) and return ``params``: each block's q/k/v tensors
    are dropped as soon as their fused copy exists, so at the 20B size the
    peak holds one block's extra copy instead of a second set of all."""
    for blk in params["blocks"]:
        attn = blk["attn"]
        if "img_qkv" not in attn:
            attn["img_qkv"] = fuse_three(
                attn.pop("img_q"), attn.pop("img_k"), attn.pop("img_v"))
            attn["txt_qkv"] = fuse_three(
                attn.pop("txt_q"), attn.pop("txt_k"), attn.pop("txt_v"))
    return params
