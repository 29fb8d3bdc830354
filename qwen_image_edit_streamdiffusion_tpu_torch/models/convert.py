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

The HF checkpoints (diffusers ``QwenImageTransformer2DModel`` and
``AutoencoderKLQwenImage``, transformers ``Qwen2_5_VL``) convert with the JAX
package's key maps into the port's layout:

- an HF linear weight is torch's (out, in), the port's layout: it is kept
  (the JAX ``_t_linear`` transposes);
- a conv (out, in, kh, kw), or a causal 3-D one (out, in, t, kh, kw) through
  its last temporal slice, becomes HWIO. (The JAX ``_t_conv2d`` permutes
  (2, 3, 0, 1), which reads (in, out, kh, kw): the layout of its own
  ``export_vae``, not a torch conv's.);
- a norm gamma, (C,), (C, 1, 1) or (C, 1, 1, 1), is flattened;
- the vision ``patch_embed`` Conv3d (d, 3, tp, p, p) becomes the port's
  bias-free (d, 3·tp·p²) linear weight.

``convert_*`` take an iterable of (key, tensor), such as
:func:`load_safetensors` yields: each tensor lands in the tree as it comes,
and ``on_module(tree, path)`` runs as soon as every key of a module has
arrived (``models/checkpoint.py`` fuses and quantizes there), so no second
copy of a model is held. :func:`load_safetensors` memory-maps one shard at a
time and yields its tensors already on the target device.
"""

from __future__ import annotations

import dataclasses
import json
import mmap
import os
import struct
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from qwen_image_edit_streamdiffusion_tpu_torch.core.config import (
    ModelConfig,
    VAEConfig,
    VLConfig,
)
from qwen_image_edit_streamdiffusion_tpu_torch.models import quantize
from qwen_image_edit_streamdiffusion_tpu_torch.models.common import flatten
from qwen_image_edit_streamdiffusion_tpu_torch.models.lora import BLOCK_MODULE_MAP, ST_DTYPES


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
    """The port's init of ``cfg`` on the meta device, q/k/v fused and
    quantized as ``tree`` is (with the JAX package's include sets). The
    model is picked by the config's class name, so the JAX package's twin
    configs (the tests hand those over) are taken as the port's own."""
    meta = torch.device("meta")
    bits = quantize.saved_bits(tree)
    kind = type(cfg).__name__
    if kind == ModelConfig.__name__:
        from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer
        from qwen_image_edit_streamdiffusion_tpu_torch.models.optimize import fuse_qkv
        skel = transformer.init(None, cfg, meta)
        if "img_qkv" in tree["blocks"][0]["attn"]:
            fuse_qkv(skel)
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


def check_total(tree: Any, like: Any, what: str) -> None:
    """Raise, with the lists, unless ``tree`` has exactly the leaves of
    ``like`` (e.g. a meta-device init) at their shapes."""
    got = {k: tuple(v.shape) for k, v in flatten(tree).items()}
    want = {k: tuple(v.shape) for k, v in flatten(like).items()}
    missing = sorted(set(want) - set(got))
    unused = sorted(set(got) - set(want))
    bad = sorted(k for k in set(got) & set(want) if got[k] != want[k])
    if missing or unused or bad:
        raise ValueError(
            f"{what}: {len(missing)} missing (e.g. {missing[:3]}), "
            f"{len(unused)} unused (e.g. {unused[:3]}), {len(bad)} of the "
            f"wrong shape (e.g. {[(k, got[k], want[k]) for k in bad[:3]]})")


def from_jax(tree: Any, cfg, device="cpu") -> Dict[str, Any]:
    """JAX param tree (numpy leaves) for the model of ``cfg`` → the port's
    params on ``device`` in ``cfg.dtype`` (quantized codes and scales keep
    their int8 / uint8 / f32)."""
    dtype = getattr(torch, cfg.dtype)
    out = _convert(tree, dtype, device)
    check_total(out, _skeleton(cfg, tree), f"from_jax({type(cfg).__name__})")
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


# ---------------------------------------------------------------------------
# HF checkpoints: key maps
# ---------------------------------------------------------------------------

KeyMap = Dict[str, Tuple[Tuple[Any, ...], str]]
Items = Union[Dict[str, torch.Tensor], Iterable[Tuple[str, torch.Tensor]]]
OnModule = Callable[[Any, Tuple[Any, ...]], None]

_TOP_LINEARS = {
    "img_in": ("img_in",),
    "txt_in": ("txt_in",),
    "time_text_embed.timestep_embedder.linear_1": ("time_mlp", "fc1"),
    "time_text_embed.timestep_embedder.linear_2": ("time_mlp", "fc2"),
    "norm_out.linear": ("norm_out", "linear"),
    "proj_out": ("proj_out",),
}

_BLOCK_NORMS = {
    "attn.norm_q": ("attn", "img_norm_q"),
    "attn.norm_k": ("attn", "img_norm_k"),
    "attn.norm_added_q": ("attn", "txt_norm_q"),
    "attn.norm_added_k": ("attn", "txt_norm_k"),
}


def transformer_key_map(cfg: ModelConfig) -> KeyMap:
    """{HF key: (port param path, kind)}, kind ∈ {linear_w, bias, norm}."""
    m: KeyMap = {}
    for tk, path in _TOP_LINEARS.items():
        m[f"{tk}.weight"] = (path + ("weight",), "linear_w")
        m[f"{tk}.bias"] = (path + ("bias",), "bias")
    m["txt_norm.weight"] = (("txt_norm", "scale"), "norm")
    for i in range(cfg.num_layers):
        pre = f"transformer_blocks.{i}."
        for tk, rel in BLOCK_MODULE_MAP.items():
            path = ("blocks", i) + tuple(rel)
            m[pre + tk + ".weight"] = (path + ("weight",), "linear_w")
            m[pre + tk + ".bias"] = (path + ("bias",), "bias")
        for tk, rel in _BLOCK_NORMS.items():
            m[pre + tk + ".weight"] = (("blocks", i) + tuple(rel) + ("scale",), "norm")
    return m


def vae_key_map(cfg: VAEConfig) -> KeyMap:
    """diffusers AutoencoderKLQwenImage names → the port's tree: encoder
    ``down_blocks`` and decoder ``up_blocks`` are flat lists interleaving
    residual blocks and resample convs, as ``vae.init`` orders them."""
    m: KeyMap = {}

    def conv(tk: str, path: Tuple):
        m[tk + ".weight"] = (path + ("w",), "conv")
        m[tk + ".bias"] = (path + ("b",), "bias")

    def norm(tk: str, path: Tuple):
        m[tk + ".gamma"] = (path + ("scale",), "norm")

    def resblock(tk: str, path: Tuple, has_shortcut: bool):
        norm(f"{tk}.norm1", path + ("norm1",))
        conv(f"{tk}.conv1", path + ("conv1",))
        norm(f"{tk}.norm2", path + ("norm2",))
        conv(f"{tk}.conv2", path + ("conv2",))
        if has_shortcut:
            conv(f"{tk}.conv_shortcut", path + ("shortcut",))

    def attn(tk: str, path: Tuple):
        norm(f"{tk}.norm", path + ("norm",))
        conv(f"{tk}.to_qkv", path + ("qkv",))
        conv(f"{tk}.proj", path + ("proj",))

    dims = tuple(cfg.base_channels * mm for mm in (1,) + tuple(cfg.channel_multipliers))
    last = len(cfg.channel_multipliers) - 1

    conv("encoder.conv_in", ("encoder", "conv_in"))
    flat = 0
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        c = cin
        for r in range(cfg.num_res_blocks):
            resblock(f"encoder.down_blocks.{flat}", ("encoder", "down", i, "res", r),
                     c != cout)
            c = cout
            flat += 1
        if i != last:
            conv(f"encoder.down_blocks.{flat}.resample.1", ("encoder", "down", i, "downsample"))
            flat += 1
    resblock("encoder.mid_block.resnets.0", ("encoder", "mid", "res1"), False)
    attn("encoder.mid_block.attentions.0", ("encoder", "mid", "attn"))
    resblock("encoder.mid_block.resnets.1", ("encoder", "mid", "res2"), False)
    norm("encoder.norm_out", ("encoder", "norm_out"))
    conv("encoder.conv_out", ("encoder", "conv_out"))

    conv("quant_conv", ("quant_conv",))
    conv("post_quant_conv", ("post_quant_conv",))

    rdims = dims[::-1]
    conv("decoder.conv_in", ("decoder", "conv_in"))
    resblock("decoder.mid_block.resnets.0", ("decoder", "mid", "res1"), False)
    attn("decoder.mid_block.attentions.0", ("decoder", "mid", "attn"))
    resblock("decoder.mid_block.resnets.1", ("decoder", "mid", "res2"), False)
    flat = 0
    for i, (cin, cout) in enumerate(zip(rdims[:-1], rdims[1:])):
        c = cin if i == 0 else cin // 2
        for r in range(cfg.num_res_blocks + 1):
            resblock(f"decoder.up_blocks.{flat}", ("decoder", "up", i, "res", r), c != cout)
            c = cout
            flat += 1
        if i != last:
            conv(f"decoder.up_blocks.{flat}.resample.1", ("decoder", "up", i, "upsample"))
            flat += 1
    norm("decoder.norm_out", ("decoder", "norm_out"))
    conv("decoder.conv_out", ("decoder", "conv_out"))
    return m


def vl_key_map(cfg: VLConfig) -> KeyMap:
    """HF Qwen2_5_VL names (``visual.*`` / ``model.*`` once
    :func:`normalize_vl_key` has stripped the outer prefixes) → the port's
    tree."""
    m: KeyMap = {}

    def lin(tk: str, path: Tuple, bias: bool):
        m[tk + ".weight"] = (path + ("weight",), "linear_w")
        if bias:
            m[tk + ".bias"] = (path + ("bias",), "bias")

    m["visual.patch_embed.proj.weight"] = (("vision", "patch_embed", "weight"), "patch")
    for i in range(cfg.vision_depth):
        pre, p = f"visual.blocks.{i}.", ("vision", "blocks", i)
        m[pre + "norm1.weight"] = (p + ("norm1", "scale"), "norm")
        lin(pre + "attn.qkv", p + ("qkv",), True)
        lin(pre + "attn.proj", p + ("proj",), True)
        m[pre + "norm2.weight"] = (p + ("norm2", "scale"), "norm")
        lin(pre + "mlp.gate_proj", p + ("mlp", "gate"), True)
        lin(pre + "mlp.up_proj", p + ("mlp", "up"), True)
        lin(pre + "mlp.down_proj", p + ("mlp", "down"), True)
    m["visual.merger.ln_q.weight"] = (("vision", "merger", "ln_q", "scale"), "norm")
    lin("visual.merger.mlp.0", ("vision", "merger", "fc1"), True)
    lin("visual.merger.mlp.2", ("vision", "merger", "fc2"), True)

    m["model.embed_tokens.weight"] = (("lm", "embed"), "embed")
    for i in range(cfg.num_layers):
        pre, p = f"model.layers.{i}.", ("lm", "blocks", i)
        m[pre + "input_layernorm.weight"] = (p + ("input_norm", "scale"), "norm")
        lin(pre + "self_attn.q_proj", p + ("q_proj",), True)
        lin(pre + "self_attn.k_proj", p + ("k_proj",), True)
        lin(pre + "self_attn.v_proj", p + ("v_proj",), True)
        lin(pre + "self_attn.o_proj", p + ("o_proj",), False)
        m[pre + "post_attention_layernorm.weight"] = (p + ("post_norm", "scale"), "norm")
        lin(pre + "mlp.gate_proj", p + ("mlp", "gate"), False)
        lin(pre + "mlp.up_proj", p + ("mlp", "up"), False)
        lin(pre + "mlp.down_proj", p + ("mlp", "down"), False)
    m["model.norm.weight"] = (("lm", "norm", "scale"), "norm")
    return m


_VL_PREFIXES = (("model.visual.", "visual."),
                ("model.language_model.", "model."),
                ("language_model.model.", "model."))


def normalize_vl_key(key: str) -> Optional[str]:
    """A VL key without its transformers-version-dependent outer prefix;
    None for the LM head (only hidden states are used)."""
    if key.startswith("lm_head."):
        return None
    for pre, rep in _VL_PREFIXES:
        if key.startswith(pre):
            return rep + key[len(pre):]
    return key


def normalize_vl_keys(state: Dict[str, Any]) -> Dict[str, Any]:
    """:func:`normalize_vl_key` over a dict (the JAX ``normalize_vl_keys``)."""
    out = {}
    for k, v in state.items():
        k2 = normalize_vl_key(k)
        if k2 is not None:
            out[k2] = v
    return out


# ---------------------------------------------------------------------------
# HF checkpoints: converters and exporters
# ---------------------------------------------------------------------------


def _t_conv2d(w: torch.Tensor) -> torch.Tensor:
    if w.dim() == 5:  # causal 3-D: the final temporal slice
        w = w[:, :, -1]
    return w.permute(2, 3, 1, 0).contiguous()


# kind → HF layout to the port's
_TO_PORT = {
    "linear_w": lambda w: w,
    "bias": lambda w: w,
    "embed": lambda w: w,
    "norm": lambda w: w.reshape(w.shape[0]),
    "conv": _t_conv2d,
    "patch": lambda w: w.reshape(w.shape[0], -1),
}


def _empty_like(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _empty_like(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_empty_like(v) for v in node]
    return None


def node_at(tree: Any, path: Tuple) -> Any:
    for p in path:
        tree = tree[p]
    return tree


def _items(state: Items) -> Iterable[Tuple[str, torch.Tensor]]:
    return state.items() if isinstance(state, dict) else state


def _convert_hf(state: Items, key_map: KeyMap, like: Any, what: str, dtype,
                on_module: Optional[OnModule] = None,
                rename: Callable[[str], Optional[str]] = lambda k: k) -> Any:
    """Put each (key, tensor) of ``state`` into a tree shaped as ``like`` (the
    port's meta init), in its layout and ``dtype``, on the tensor's device;
    call ``on_module(tree, module path)`` once every key of a module has
    arrived. Raises, with the lists, on missing, unused, duplicate or
    misshapen keys."""
    want = flatten(like)
    tree = _empty_like(like)
    pending: Dict[Tuple, int] = {}
    for path, _ in key_map.values():
        pending[path[:-1]] = pending.get(path[:-1], 0) + 1
    seen, unused, bad = set(), [], []
    for key, t in _items(state):
        key = rename(key)
        if key is None:
            continue
        if key not in key_map or key in seen:
            unused.append(key)
            continue
        path, kind = key_map[key]
        t = _TO_PORT[kind](t).to(dtype)
        shape = tuple(want[".".join(map(str, path))].shape)
        if tuple(t.shape) != shape:
            bad.append((key, tuple(t.shape), shape))
            continue
        node_at(tree, path[:-1])[path[-1]] = t
        seen.add(key)
        module = path[:-1]
        pending[module] -= 1
        if pending[module] == 0 and on_module is not None:
            on_module(tree, module)
    missing = sorted(set(key_map) - seen - {k for k, *_ in bad})
    if missing or unused or bad:
        raise ValueError(
            f"{what} checkpoint mismatch: {len(missing)} missing {missing[:8]}, "
            f"{len(unused)} unused or repeated {sorted(unused)[:8]}, {len(bad)} of the "
            f"wrong shape (key, got, want) {sorted(bad)[:4]}")
    return tree


def convert_transformer(state: Items, cfg: ModelConfig, dtype=None,
                        on_module: Optional[OnModule] = None) -> Dict:
    """HF ``QwenImageTransformer2DModel`` tensors → the port's MMDiT tree
    (unfused q/k/v) in ``dtype`` (``cfg.dtype``)."""
    from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer

    return _convert_hf(state, transformer_key_map(cfg),
                       transformer.init(None, cfg, torch.device("meta")), "transformer",
                       dtype or getattr(torch, cfg.dtype), on_module)


def convert_vae(state: Items, cfg: VAEConfig, dtype=None,
                on_module: Optional[OnModule] = None) -> Dict:
    """HF ``AutoencoderKLQwenImage`` tensors → the port's VAE tree."""
    from qwen_image_edit_streamdiffusion_tpu_torch.models import vae

    return _convert_hf(state, vae_key_map(cfg), vae.init(None, cfg, torch.device("meta")),
                       "VAE", dtype or getattr(torch, cfg.dtype), on_module)


def convert_vl(state: Items, cfg: VLConfig, dtype=None,
               on_module: Optional[OnModule] = None) -> Dict:
    """HF Qwen2.5-VL tensors (any of the three outer prefixes; the LM head
    dropped) → the port's ``{"vision", "lm"}`` tree."""
    from qwen_image_edit_streamdiffusion_tpu_torch.models import qwen_vl

    return _convert_hf(state, vl_key_map(cfg), qwen_vl.init(None, cfg, torch.device("meta")),
                       "VL", dtype or getattr(torch, cfg.dtype), on_module,
                       rename=normalize_vl_key)


# kind → the port's layout back to HF's
_TO_HF = {
    "linear_w": lambda w, cfg: w,
    "bias": lambda w, cfg: w,
    "embed": lambda w, cfg: w,
    "norm": lambda w, cfg: w,
    "conv": lambda w, cfg: w.permute(3, 2, 0, 1).contiguous(),
    "patch": lambda w, cfg: w.reshape(w.shape[0], 3, cfg.temporal_patch_size,
                                      cfg.patch_size, cfg.patch_size),
}


def _export(params: Any, key_map: KeyMap, cfg) -> Dict[str, torch.Tensor]:
    return {tk: _TO_HF[kind](node_at(params, path), cfg) for tk, (path, kind) in key_map.items()}


def export_transformer(params: Dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`convert_transformer` (unfused, unquantized params),
    in the params' dtype and device, in the key map's order."""
    return _export(params, transformer_key_map(cfg), cfg)


def export_vae(params: Dict, cfg: VAEConfig) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`convert_vae`: convs back to (out, in, kh, kw)."""
    return _export(params, vae_key_map(cfg), cfg)


def export_vl(params: Dict, cfg: VLConfig) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`convert_vl`, under the ``visual.`` / ``model.``
    prefixes."""
    return _export(params, vl_key_map(cfg), cfg)


# ---------------------------------------------------------------------------
# safetensors reading
# ---------------------------------------------------------------------------

INDEX_NAMES = ("diffusion_pytorch_model.safetensors.index.json",
               "model.safetensors.index.json")


def shard_files(path: str) -> List[str]:
    """The .safetensors files of ``path``: the file itself; or, for a
    directory, the shards its index json names (diffusers' basename, then
    transformers'), else every .safetensors file in it, sorted."""
    if not os.path.isdir(path):
        return [path]
    for name in INDEX_NAMES:
        idx = os.path.join(path, name)
        if os.path.exists(idx):
            with open(idx) as f:
                files = sorted(set(json.load(f)["weight_map"].values()))
            return [os.path.join(path, fn) for fn in files]
    files = sorted(fn for fn in os.listdir(path) if fn.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors file in {path!r}")
    return [os.path.join(path, fn) for fn in files]


def read_header(path: str) -> Tuple[Dict[str, Any], int]:
    """(JSON header, byte offset of the data) of a .safetensors file; the
    header's ``__metadata__`` is kept."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: not a .safetensors file")
        (n,) = struct.unpack("<Q", head)
        return json.loads(f.read(n)), 8 + n


def _read_file(path: str, device, mapped: bool = False
               ) -> Iterator[Tuple[str, torch.Tensor]]:
    header, start = read_header(path)
    entries = sorted(((k, v) for k, v in header.items() if k != "__metadata__"),
                     key=lambda kv: kv[1]["data_offsets"][0])
    size = os.path.getsize(path)
    for name, info in entries:
        if info["dtype"] not in ST_DTYPES:
            raise TypeError(f"{path}: {name} has dtype {info['dtype']}; the reader "
                            f"takes {sorted(ST_DTYPES)}")
        begin, end = info["data_offsets"]
        dtype = ST_DTYPES[info["dtype"]]
        numel = int(np.prod(info["shape"], dtype=np.int64))
        if end - begin != numel * dtype.itemsize or start + end > size:
            raise ValueError(f"{path}: {name}'s data_offsets {info['data_offsets']} "
                             f"do not fit its {info['dtype']} {info['shape']}")
    if not entries or size == start:
        for name, info in entries:
            yield name, torch.empty(info["shape"], dtype=ST_DTYPES[info["dtype"]],
                                    device=device)
        return
    page = mmap.PAGESIZE
    with open(path, "rb") as f:
        # a private mapping: writable for torch.frombuffer, never written
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    if mapped:
        # host views of the mapping, read only where a slice of them is
        # copied; the views keep the mapping open
        for name, info in entries:
            begin, end = info["data_offsets"]
            dtype = ST_DTYPES[info["dtype"]]
            if end == begin:
                yield name, torch.empty(info["shape"], dtype=dtype)
                continue
            yield name, torch.frombuffer(
                mm, dtype=dtype, count=(end - begin) // dtype.itemsize,
                offset=start + begin).reshape(info["shape"])
        return
    try:
        for name, info in entries:
            begin, end = info["data_offsets"]
            dtype = ST_DTYPES[info["dtype"]]
            if end == begin:
                yield name, torch.empty(info["shape"], dtype=dtype, device=device)
                continue
            view = torch.frombuffer(mm, dtype=dtype, count=(end - begin) // dtype.itemsize,
                                    offset=start + begin)
            out = view.reshape(info["shape"]).to(device, copy=True)
            del view
            # the copy is made: drop the tensor's pages from this process
            lo = (start + begin) // page * page
            mm.madvise(mmap.MADV_DONTNEED, lo, start + end - lo)
            yield name, out
    finally:
        mm.close()


def load_safetensors(path: str, device="cpu", mapped: bool = False
                     ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(key, tensor) of every tensor of a .safetensors file, an index json's
    shards or a directory of shards (:func:`shard_files`), one at a time,
    copied onto ``device`` in its stored dtype (F32, F16, BF16, I8, U8).
    Each shard is memory-mapped while it is read, and each tensor's pages
    are released once it is copied, so the host holds one tensor's bytes,
    not a shard's. ``mapped``: host views of the mapped files instead,
    nothing copied (a sharded load copies each rank's slices of them)."""
    for fn in shard_files(path):
        yield from _read_file(fn, device, mapped)
