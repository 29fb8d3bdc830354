"""Weight bridge: the JAX package's param trees → the port's params.

:func:`from_jax` takes a tree as ``transformer.init`` (unfused q/k/v),
``vae.init``, ``qwen_vl._init_all``, ``tiny_vae.init`` or
``tiny_vae.encoder_init`` of the JAX package returns it, with numpy leaves,
and returns the port's nested dict of tensors:

- a linear leaf ``{"w": (in, out), "b"}`` becomes ``{"weight": (out, in),
  "bias"}``;
- a conv leaf ``{"w": (kh, kw, in, out), "b"}`` keeps the HWIO layout the
  port's public conv functions take;
- an int8 leaf ``{"w_q": (in, out) int8, "scale": (out,), "b"}`` becomes
  ``{"w_q": (out, in) int8, "scale": (out,) f32, "bias"}``;
- an int4 leaf ``{"w_q4": (in/2, out) uint8, "scale4": (in/64, out), "b"}``
  becomes ``{"w_q4": (out, in/2) uint8, "scale4": (out, in/64) f32, "bias"}``:
  a transpose, so each byte keeps its (2j, 2j + 1) nibble pair along ``in``;
- every other array (norm scales, the VL embedding table) is copied.

Like the JAX package's ``models/convert.py``, the conversion is total: the
result is held against the port's own init (built on the meta device, so no
memory is touched; quantized as the tree is, with the JAX package's include
sets) and any missing or unused key, or any shape mismatch, raises with the
lists.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from qwen_image_edit_streamdiffusion_tpu_torch.core.config import (
    ModelConfig,
    VAEConfig,
    VLConfig,
)
from qwen_image_edit_streamdiffusion_tpu_torch.models import quantize
from qwen_image_edit_streamdiffusion_tpu_torch.models.common import flatten


def _tensor(a, dtype, device) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch twin in numpy
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)


# quantized leaf key → (port key, transpose, dtype or None for the model's)
_QUANT_KEYS = {
    "w_q": ("w_q", True, torch.int8),
    "scale": ("scale", False, torch.float32),
    "w_q4": ("w_q4", True, torch.uint8),
    "scale4": ("scale4", True, torch.float32),
    "b": ("bias", False, None),
}


def _convert(node: Any, dtype, device) -> Any:
    if isinstance(node, dict):
        if "w_q" in node or "w_q4" in node:
            out = {}
            for k, v in node.items():
                if k not in _QUANT_KEYS:  # left for the totality check
                    out[k] = _convert(v, dtype, device)
                    continue
                name, transpose, dt = _QUANT_KEYS[k]
                a = np.asarray(v)
                out[name] = _tensor(a.T if transpose else a, dt or dtype, device)
            return out
        w = node.get("w")
        if w is not None and set(node) <= {"w", "b"} and np.ndim(w) == 2:
            out = {"weight": _tensor(np.asarray(w).T, dtype, device)}
            if "b" in node:
                out["bias"] = _tensor(node["b"], dtype, device)
            return out
        return {k: _convert(v, dtype, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, dtype, device) for v in node]
    return _tensor(node, dtype, device)


def _skeleton(cfg, tree):
    """The port's init of ``cfg`` on the meta device, quantized as ``tree``
    is (with the JAX package's include sets). The model is picked by the
    config's class name, so the JAX package's twin configs (the tests hand
    those over) are taken as the port's own."""
    meta = torch.device("meta")
    bits = quantize.saved_bits(tree)
    kind = type(cfg).__name__
    if kind == ModelConfig.__name__:
        from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer
        skel = transformer.init(None, cfg, meta)
        return skel if bits is None else quantize.quantize_transformer(skel, bits=bits)
    if kind == VAEConfig.__name__:
        from qwen_image_edit_streamdiffusion_tpu_torch.models import vae
        return vae.init(None, cfg, meta)
    if kind == VLConfig.__name__:
        from qwen_image_edit_streamdiffusion_tpu_torch.models import qwen_vl
        skel = qwen_vl.init(None, cfg, meta)
        return skel if bits is None else quantize.quantize_vl(skel, bits=bits)
    if kind in ("TinyDecoderConfig", "TinyEncoderConfig"):
        from qwen_image_edit_streamdiffusion_tpu_torch.models import tiny_vae
        port_cfg = getattr(tiny_vae, kind)(**{
            f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
        init = tiny_vae.init if kind == "TinyDecoderConfig" else tiny_vae.encoder_init
        return init(None, port_cfg, meta)
    raise TypeError(f"from_jax: no model for config {kind}")


def from_jax(tree: Any, cfg, device="cpu") -> Dict[str, Any]:
    """JAX param tree (numpy leaves) for the model of ``cfg`` → the port's
    params on ``device`` in ``cfg.dtype`` (quantized codes and scales keep
    their int8 / uint8 / f32)."""
    dtype = getattr(torch, cfg.dtype)
    out = _convert(tree, dtype, device)
    got = {k: tuple(v.shape) for k, v in flatten(out).items()}
    want = {k: tuple(v.shape) for k, v in flatten(_skeleton(cfg, tree)).items()}
    missing = sorted(set(want) - set(got))
    unused = sorted(set(got) - set(want))
    bad = sorted(k for k in set(got) & set(want) if got[k] != want[k])
    if missing or unused or bad:
        raise ValueError(
            f"from_jax({type(cfg).__name__}): {len(missing)} missing "
            f"(e.g. {missing[:3]}), {len(unused)} unused (e.g. {unused[:3]}), "
            f"{len(bad)} of the wrong shape (e.g. "
            f"{[(k, got[k], want[k]) for k in bad[:3]]})")
    return out


def lora_from_jax(tree: Any, base_params: Any, cfg, device="cpu") -> Dict[str, Any]:
    """A JAX adapter tree (``training/lora_train.py::init_lora`` of the JAX
    package, numpy leaves ``a`` (in, r) and ``b`` (r, out)) → the port's
    adapters: the same layout, f32 tensors on ``device`` with
    ``requires_grad``. Total like :func:`from_jax`: the result is held
    against the port's ``init_lora(base_params, cfg)`` and any missing or
    unused key or wrong shape raises."""
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train

    out = {"blocks": [
        {k: _adapters(v, device) for k, v in blk.items()} for blk in tree["blocks"]]}
    skel = lora_train.init_lora(base_params, cfg, torch.Generator())
    got = {k: tuple(v.shape) for k, v in flatten(out).items()}
    want = {k: tuple(v.shape) for k, v in flatten(skel).items()}
    missing = sorted(set(want) - set(got))
    unused = sorted(set(got) - set(want))
    bad = sorted(k for k in set(got) & set(want) if got[k] != want[k])
    if missing or unused or bad:
        raise ValueError(
            f"lora_from_jax: {len(missing)} missing (e.g. {missing[:3]}), "
            f"{len(unused)} unused (e.g. {unused[:3]}), {len(bad)} of the "
            f"wrong shape (e.g. {[(k, got[k], want[k]) for k in bad[:3]]})")
    return out


def _adapters(node: Any, device) -> Any:
    if isinstance(node, dict):
        return {k: _adapters(v, device) for k, v in node.items()}
    return _tensor(node, torch.float32, device).requires_grad_()
