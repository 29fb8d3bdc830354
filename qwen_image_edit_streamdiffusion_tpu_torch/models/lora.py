"""LoRA loading and weight fusion.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/models/lora.py``: adapters
are fused into the dense weights before serving, so the forward never knows a
LoRA existed, and fusion comes before quantization.

Format: diffusers/peft keys ``transformer_blocks.{i}.<module>.lora_A.weight``
(r, in) / ``lora_B.weight`` (out, r), plus optional ``.alpha`` scalars; the
delta is scale · B · A with scale = alpha / r (1 without alpha). The port's
linears are (out, in), so the delta lands as it is; a q/k/v target of a block
whose projections were fused (``models/optimize.py::fuse_qkv``) lands in its
row block ``[slot·D, (slot+1)·D)`` of the (3D, D) weight.

Unlike the pure JAX function, :func:`fuse_lora` updates the tree IN PLACE,
leaf by leaf: at the 20B size a second copy of the MMDiT (41 GB) does not fit
the card beside the first.

Files are read and written without the ``safetensors`` package: a
``.safetensors`` file is a little-endian u64 header length, a JSON header and
the raw little-endian tensor bytes (:func:`save_safetensors`, which also
writes sharded directories with an index json, and
``models/convert.py::load_safetensors``, the port's one reader);
``.npz`` archives are read too.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# diffusers module path → the port's block-relative param path
BLOCK_MODULE_MAP: Dict[str, Tuple[str, ...]] = {
    "attn.to_q": ("attn", "img_q"),
    "attn.to_k": ("attn", "img_k"),
    "attn.to_v": ("attn", "img_v"),
    "attn.add_q_proj": ("attn", "txt_q"),
    "attn.add_k_proj": ("attn", "txt_k"),
    "attn.add_v_proj": ("attn", "txt_v"),
    "attn.to_out.0": ("attn", "img_out"),
    "attn.to_add_out": ("attn", "txt_out"),
    "img_mlp.net.0.proj": ("img_mlp", "fc1"),
    "img_mlp.net.2": ("img_mlp", "fc2"),
    "txt_mlp.net.0.proj": ("txt_mlp", "fc1"),
    "txt_mlp.net.2": ("txt_mlp", "fc2"),
    "img_mod.1": ("img_mod",),
    "txt_mod.1": ("txt_mod",),
}

# per-projection q/k/v name → (fused leaf, row slot) after fuse_qkv
FUSED_SLOT = {"img_q": ("img_qkv", 0), "img_k": ("img_qkv", 1),
              "img_v": ("img_qkv", 2), "txt_q": ("txt_qkv", 0),
              "txt_k": ("txt_qkv", 1), "txt_v": ("txt_qkv", 2)}

_BLOCK_RE = re.compile(
    r"^(?:diffusion_model\.|transformer\.)?transformer_blocks\.(\d+)\.(.+?)"
    r"\.(lora_A|lora_B|alpha|lora_A\.weight|lora_B\.weight)(?:\.weight)?$"
)


class LoRAEntry:
    __slots__ = ("a", "b", "alpha")

    def __init__(self):
        self.a: Optional[torch.Tensor] = None  # (r, in)
        self.b: Optional[torch.Tensor] = None  # (out, r)
        self.alpha: Optional[float] = None


def parse_lora_state_dict(tensors: Dict[str, Any]
                          ) -> Dict[Tuple[int, Tuple[str, ...]], LoRAEntry]:
    """Group flat keys into {(block index, param path): LoRAEntry}; every
    unknown key is reported in one error, so a format drift is loud."""
    entries: Dict[Tuple[int, Tuple[str, ...]], LoRAEntry] = {}
    unknown: List[str] = []
    for key, val in tensors.items():
        m = _BLOCK_RE.match(key)
        if not m or m.group(2) not in BLOCK_MODULE_MAP:
            unknown.append(key)
            continue
        e = entries.setdefault((int(m.group(1)), BLOCK_MODULE_MAP[m.group(2)]),
                               LoRAEntry())
        t = val if torch.is_tensor(val) else torch.from_numpy(np.array(val))
        kind = m.group(3).split(".")[0]
        if kind == "lora_A":
            e.a = t
        elif kind == "lora_B":
            e.b = t
        else:
            e.alpha = float(t)
    if unknown:
        raise ValueError(
            f"{len(unknown)} unrecognized LoRA keys, e.g. {unknown[:5]} — "
            "update models/lora.py:BLOCK_MODULE_MAP")
    return entries


def _dense_weight(leaf: dict, what: str) -> torch.Tensor:
    if "weight" not in leaf:
        raise ValueError(f"{what} requires dense weights — fuse before "
                         "quantize_transformer()")
    return leaf["weight"]


def fuse_lora(params: Any, tensors: Dict[str, Any], weight: float = 1.0) -> Any:
    """Fuse the LoRA deltas into the transformer's dense weights IN PLACE and
    return ``params``: w ← (w.f32 + weight · scale · B·A).to(w.dtype), the
    delta in f32 on the weight's device."""
    blocks = params["blocks"]
    for (idx, path), e in parse_lora_state_dict(tensors).items():
        if idx >= len(blocks):
            raise ValueError(f"LoRA targets block {idx} but model has "
                             f"{len(blocks)}")
        fuse_entry(blocks[idx], path, e, weight, idx)
    return params


def fuse_entry(block: Any, path: Tuple[str, ...], e: LoRAEntry, weight: float = 1.0,
               idx: int = -1) -> None:
    """Fuse one adapter pair into the linear at ``path`` of ``block`` (its
    q/k/v row block when the block's projections are fused), in place."""
    if e.a is None or e.b is None:
        raise ValueError(f"incomplete LoRA pair at block {idx} {path}")
    r = e.a.shape[0]
    scale = weight * ((e.alpha / r) if e.alpha is not None else 1.0)
    node, slot = block, None
    for p in path[:-1]:
        node = node[p]
    name = path[-1]
    if name not in node and name in FUSED_SLOT:
        name, slot = FUSED_SLOT[name]
    w = _dense_weight(node[name], "LoRA fusion")
    delta = (e.b.to(w.device, torch.float32) @ e.a.to(w.device, torch.float32)) * scale
    if slot is not None:
        d_out = delta.shape[0]
        if w.shape != (3 * d_out, delta.shape[1]):
            raise ValueError(f"LoRA delta {tuple(delta.shape)} vs fused "
                             f"weight {tuple(w.shape)}")
        w = w[slot * d_out:(slot + 1) * d_out]
    elif w.shape != delta.shape:
        raise ValueError(f"LoRA delta {tuple(delta.shape)} vs weight "
                         f"{tuple(w.shape)}")
    w.copy_((w.float() + delta).to(w.dtype))


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------

ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
             "I8": torch.int8, "U8": torch.uint8}
_ST_NAMES = {v: k for k, v in ST_DTYPES.items()}


def _host_tensor(name: str, val: Any) -> torch.Tensor:
    t = val if torch.is_tensor(val) else torch.from_numpy(np.asarray(val))
    if t.dtype not in _ST_NAMES:
        raise TypeError(f"{name}: no safetensors dtype for {t.dtype}")
    return t.detach()


def _write_file(path: str, tensors: Dict[str, torch.Tensor],
                metadata: Optional[Dict[str, str]]) -> None:
    """One .safetensors file, tensors in sorted key order; each is copied to
    the host as it is written."""
    header: Dict[str, Any] = {"__metadata__": dict(metadata)} if metadata else {}
    offset = 0
    names = sorted(tensors)
    for name in names:
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name in names:
            t = tensors[name].cpu().contiguous().reshape(-1)
            if t.numel():
                f.write(memoryview(t.view(torch.uint8).numpy()))


def save_safetensors(path: str, tensors: Dict[str, Any],
                     metadata: Optional[Dict[str, str]] = None,
                     max_shard_bytes: Optional[int] = None,
                     basename: str = "model") -> None:
    """Write ``tensors`` (torch tensors on any device, or numpy arrays) as a
    .safetensors file at ``path``: u64 header length, JSON header padded to
    8 bytes (with ``metadata`` as its ``__metadata__``), raw data. With
    ``max_shard_bytes``, ``path`` is a directory: the tensors, in their
    order, are cut into shards of at most that many bytes (a larger tensor
    alone), ``{basename}-0000i-of-0000n.safetensors``, named by the index
    ``{basename}.safetensors.index.json`` (HF's layout; its ``metadata``
    holds ``total_size`` and ``metadata``)."""
    tensors = {k: _host_tensor(k, v) for k, v in tensors.items()}
    if max_shard_bytes is None:
        _write_file(path, tensors, metadata)
        return
    shards: List[List[str]] = [[]]
    used = 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        if shards[-1] and used + n > max_shard_bytes:
            shards.append([])
            used = 0
        shards[-1].append(name)
        used += n
    os.makedirs(path, exist_ok=True)
    weight_map = {}
    for i, names in enumerate(shards):
        fn = f"{basename}-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        _write_file(os.path.join(path, fn), {k: tensors[k] for k in names}, metadata)
        weight_map.update({k: fn for k in names})
    total = sum(t.numel() * t.element_size() for t in tensors.values())
    with open(os.path.join(path, f"{basename}.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total, **(metadata or {})},
                   "weight_map": weight_map}, f, indent=1)


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors file (or shards, ``convert.shard_files``) into CPU
    tensors, through the port's reader ``models/convert.py::load_safetensors``."""
    from qwen_image_edit_streamdiffusion_tpu_torch.models import convert

    return dict(convert.load_safetensors(path, "cpu"))


def load_lora_weights(path: str) -> Dict[str, torch.Tensor]:
    """A LoRA file (.safetensors, or .npz) as {key: CPU tensor}."""
    if str(path).endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    return load_safetensors(path)
