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
the raw little-endian tensor bytes (:func:`save_safetensors`,
:func:`load_safetensors`); ``.npz`` archives are read too.
"""

from __future__ import annotations

import json
import re
import struct
from pathlib import Path
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
        if e.a is None or e.b is None:
            raise ValueError(f"incomplete LoRA pair at block {idx} {path}")
        if idx >= len(blocks):
            raise ValueError(f"LoRA targets block {idx} but model has "
                             f"{len(blocks)}")
        r = e.a.shape[0]
        scale = weight * ((e.alpha / r) if e.alpha is not None else 1.0)
        node, slot = blocks[idx], None
        for p in path[:-1]:
            node = node[p]
        name = path[-1]
        if name not in node and name in FUSED_SLOT:
            name, slot = FUSED_SLOT[name]
        w = _dense_weight(node[name], "LoRA fusion")
        delta = (e.b.to(w.device, torch.float32) @ e.a.to(w.device, torch.float32)
                 ) * scale
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
    return params


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
              "I8": torch.int8, "U8": torch.uint8}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def save_safetensors(path: str, tensors: Dict[str, Any]) -> None:
    """Write ``tensors`` (torch tensors or numpy arrays) as a .safetensors
    file: u64 header length, JSON header padded to 8 bytes, raw data."""
    header: Dict[str, Any] = {}
    blobs, offset = [], 0
    for name in sorted(tensors):
        val = tensors[name]
        t = (val if torch.is_tensor(val) else torch.from_numpy(np.asarray(val))
             ).detach().cpu().contiguous()
        if t.dtype not in _ST_NAMES:
            raise TypeError(f"{name}: no safetensors dtype for {t.dtype}")
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Read a .safetensors file into CPU tensors."""
    raw = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    body = bytearray(raw[8 + n:])
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise TypeError(f"{path}: {name} has dtype {info['dtype']}; the "
                            f"reader takes {sorted(_ST_DTYPES)}")
        dtype = _ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        flat = torch.frombuffer(body, dtype=torch.uint8, count=end - begin,
                                offset=begin) if end > begin else \
            torch.empty((0,), dtype=torch.uint8)
        out[name] = flat.clone().view(dtype).reshape(info["shape"])
    return out


def load_lora_weights(path: str) -> Dict[str, torch.Tensor]:
    """A LoRA file (.safetensors, or .npz) as {key: CPU tensor}."""
    if str(path).endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    return load_safetensors(path)
