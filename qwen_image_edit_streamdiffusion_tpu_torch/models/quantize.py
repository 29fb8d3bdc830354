"""Weight-only int8 / int4 quantization of the MMDiT and the VL encoder.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/models/quantize.py``: the
same leaves are swapped, ``{"weight", "bias"}`` for ``{"w_q", "scale",
"bias"}`` (int8) or ``{"w_q4", "scale4", "bias"}`` (int4), and
``common.linear`` dispatches on the keys, so the forward code is unchanged.
Under int4, a leaf whose in-dim is not a multiple of the group (the vision
tower's 3420-wide ``down``) takes the int8 rung instead of staying dense.

Unlike the pure JAX functions, the port quantizes IN PLACE and returns the
tree it was given: each leaf drops its dense weight as its quantized copy
lands, so at the 20B size the peak holds one extra leaf, not a second tree
(56.5 GB of bf16 weights and a 29 GB int8 copy do not fit one 80 GB card).
"""

from __future__ import annotations

from typing import Any, FrozenSet, Optional

import torch

from qwen_image_edit_streamdiffusion_tpu_torch.models.common import flatten
from qwen_image_edit_streamdiffusion_tpu_torch.ops.int8 import (
    INT4_GROUP,
    quantize_weight,
    quantize_weight_int4,
)

# Every block-level matmul of the MMDiT, the AdaLN modulation included.
# Embeddings, the output head and norms stay dense.
DEFAULT_QUANTIZE = frozenset({
    "img_q", "img_k", "img_v", "txt_q", "txt_k", "txt_v",
    "img_out", "txt_out", "fc1", "fc2", "img_mod", "txt_mod",
    "img_qkv", "txt_qkv",
})

# Conservative subset: the modulation projections stay dense.
NO_MODULATION_QUANTIZE = frozenset(DEFAULT_QUANTIZE - {"img_mod", "txt_mod"})

# VL encoder: LM attention + SwiGLU, vision attention + SwiGLU, the 2×2
# merger MLP. The embed table, patch embed and norms stay dense.
VL_QUANTIZE = frozenset({
    "q_proj", "k_proj", "v_proj", "o_proj", "gate", "up", "down",
    "qkv", "proj", "fc1", "fc2",
})


def quantize_leaf(d: dict, bits: int) -> None:
    """Swap the dense ``weight`` of one linear leaf for its int8, or int4,
    codes and scales, in place."""
    w = d.pop("weight")
    out, kin = w.shape
    int4 = bits == 4 and kin % INT4_GROUP == 0 and kin % 2 == 0
    if w.device.type == "meta":
        # shapes only (a checkpoint's skeleton): the ops' meta kernels would
        # import torch._dynamo, seconds once a process
        def meta(*shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")
        d.update({"w_q4": meta(out, kin // 2, dtype=torch.uint8),
                  "scale4": meta(out, kin // INT4_GROUP, dtype=torch.float32)} if int4 else
                 {"w_q": meta(out, kin, dtype=torch.int8),
                  "scale": meta(out, dtype=torch.float32)})
    elif int4:
        d.update(quantize_weight_int4(w))
    else:
        d["w_q"], d["scale"] = quantize_weight(w)


def _quantize_tree(node: Any, include: FrozenSet[str], bits: int,
                   name: str = "") -> None:
    """Swap, in place, every 2-D linear leaf whose key is in ``include``."""
    if isinstance(node, dict):
        w = node.get("weight")
        if w is not None and name in include and w.dim() == 2:
            quantize_leaf(node, bits)
            return
        for k, v in node.items():
            _quantize_tree(v, include, bits, k)
    elif isinstance(node, (list, tuple)):
        for v in node:
            _quantize_tree(v, include, bits, name)


def quantize_transformer(params: Any, include: FrozenSet[str] = DEFAULT_QUANTIZE,
                         bits: int = 8) -> Any:
    """int8 (default) or int4 block linears of the MMDiT, in place; the
    embeddings, time MLP, output norm and head stay dense."""
    _quantize_tree(params["blocks"], include, bits)
    return params


def quantize_vl(params: Any, include: FrozenSet[str] = VL_QUANTIZE,
                bits: int = 8) -> Any:
    """int8 or int4 linears of the Qwen2.5-VL tree ({"vision", "lm"}), in
    place."""
    _quantize_tree(params, include, bits)
    return params


def saved_bits(params: Any) -> Optional[int]:
    """4 or 8 when the tree already holds int4 / int8 leaves, else None
    (an int4 tree may hold int8 leaves where in-dim % 64 != 0)."""
    keys = {path.rsplit(".", 1)[-1] for path in flatten(params)}
    return 4 if "w_q4" in keys else (8 if "w_q" in keys else None)


def quantized_bytes(params: Any) -> int:
    return sum(t.numel() * t.element_size() for t in flatten(params).values())
