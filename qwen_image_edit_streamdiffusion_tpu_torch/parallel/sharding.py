"""Sharding rules: tensor parallelism over ``model``, the VL encoder over as
many ranks as its heads allow.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/parallel/sharding.py``,
with the same rules, read as explicit slices instead of GSPMD annotations:
each rank holds its slice of each sharded leaf, and the forward code calls
the collectives (``models/common.py::row_linear`` / ``gather_linear``).

- Column-parallel leaves (:data:`COL_PARALLEL`, :data:`VL_COL`) split their
  output features: dim 0 of ``weight`` / ``w_q`` / ``w_q4`` / ``scale4``
  (the port's (out, in) layout) and their ``bias`` / ``scale`` with it.
- Row-parallel leaves (:data:`ROW_PARALLEL`, :data:`VL_ROW`) split their input
  features, dim 1; ``bias`` and the int8 per-output ``scale`` stay whole (the
  bias is added once, after the all-reduce). An int8 ``w_q`` slice whose
  width is not a multiple of 16 (the vision ``down``, 3420 wide) gets zero
  columns up to one when it is sliced: K6's wgmma body takes 16-byte rows,
  and zero codes add nothing (``ops/int8.py::int8_linear_row``).
- A fused q/k/v leaf (``img_qkv``, ``txt_qkv``, the vision ``qkv``) splits
  each third, so a rank holds the q, k and v of its own heads.
- The VL ``embed`` table (vocab, hidden) splits its hidden dim.
- Only the MMDiT's block leaves are sharded; its embeddings, time MLP and
  head stay whole. Every VL leaf follows the rules.

A spec is ``None`` (whole) or ``(dim, axes)``: ``dim`` split into equal
parts over the mesh axes ``axes`` (cfg-first), rank = its index in the
group of those axes. Where a dimension does not divide, :func:`fit_axes`
takes the fallback ladder of the JAX ``_fit_axes``: the largest suffix of
the axes whose product divides it, else whole.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch

from qwen_image_edit_streamdiffusion_tpu_torch.core.meshes import (
    CFG_AXIS,
    MODEL_AXIS,
    SINGLE,
    Group,
    Mesh,
)

COL_PARALLEL = frozenset({"img_q", "img_k", "img_v", "txt_q", "txt_k", "txt_v",
                          "img_qkv", "txt_qkv", "fc1", "img_mod", "txt_mod"})
ROW_PARALLEL = frozenset({"img_out", "txt_out", "fc2"})
VL_COL = frozenset({"q_proj", "k_proj", "v_proj", "gate", "up", "qkv", "fc1",
                    "patch_embed"})
VL_ROW = frozenset({"o_proj", "down", "proj", "fc2"})
FUSED = frozenset({"img_qkv", "txt_qkv", "qkv"})

WEIGHTS = ("weight", "w_q", "w_q4", "scale4")
VECTORS = ("bias", "scale")

Spec = Optional[Tuple[int, Tuple[str, ...]]]


def has_axis(mesh: Optional[Mesh], name: str) -> bool:
    return mesh is not None and name in mesh.axis_names and mesh.shape[name] > 1


def fit_axes(axes: Sequence[str], dim: Optional[int],
             sizes: Optional[Dict[str, int]]) -> Optional[Tuple[str, ...]]:
    """The largest suffix of ``axes`` whose product divides ``dim`` (None:
    replicate), the JAX ``_fit_axes``. Without a dim or sizes the axes are
    returned as they are (structure-only specs)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if dim is None or sizes is None:
        return axes
    for start in range(len(axes)):
        prod = 1
        for a in axes[start:]:
            prod *= sizes[a]
        if dim % prod == 0:
            return axes[start:]
    return None


def _leaf_spec(names: Sequence[str], shape, axes, sizes, col, row) -> Spec:
    leaf = names[-1] if names else ""
    owner = names[-2] if len(names) >= 2 else ""

    def spec(dim: int) -> Spec:
        n = None if shape is None else shape[dim]
        if n is not None and owner in FUSED and dim == 0:
            n //= 3  # each third splits on its own
        fitted = fit_axes(axes, n, sizes)
        return None if not fitted else (dim, fitted)

    if leaf == "embed" and col is VL_COL:
        return spec(1)
    if owner in col:
        if leaf in WEIGHTS or leaf in VECTORS:
            return spec(0)
    if owner in row:
        if leaf in WEIGHTS:
            return spec(1)
    return None


def _walk(tree: Any, path: Tuple[str, ...] = (), skip_blocks: bool = False
          ) -> Iterator[Tuple[Tuple[str, ...], Any, Any, Any]]:
    """(path, leaf, parent, key) of every tensor of a nested dict / list;
    ``skip_blocks``: not below a ``blocks`` key."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, list) else ())
    for k, v in items:
        if skip_blocks and k == "blocks":
            continue
        p = path + (str(k),)
        if isinstance(v, (dict, list)):
            yield from _walk(v, p, skip_blocks)
        else:
            yield p, v, tree, k


def _map(tree: Any, fn: Callable) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, lambda p, x, k=k: fn((str(k),) + p, x)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, lambda p, x, i=i: fn((str(i),) + p, x)) for i, v in enumerate(tree)]
    return fn((), tree)


def _in_block(path: Sequence[str]) -> bool:
    return any(p.isdigit() for p in path)


def transformer_leaf_spec(path: Sequence[str], shape=None, sizes=None) -> Spec:
    """The spec of the MMDiT leaf at ``path`` (its keys, e.g. ``("blocks",
    "0", "attn", "img_q", "weight")``)."""
    if not _in_block(path):
        return None
    return _leaf_spec(path, shape, (MODEL_AXIS,), sizes, COL_PARALLEL, ROW_PARALLEL)


def vl_leaf_spec(path: Sequence[str], axes: Sequence[str], shape=None,
                 sizes=None) -> Spec:
    """The spec of the VL leaf at ``path`` when the encoder shards over
    ``axes`` (:func:`vl_axes`)."""
    if not axes:
        return None
    return _leaf_spec(path, shape, tuple(axes), sizes, VL_COL, VL_ROW)


def transformer_param_specs(params: Any, sizes: Optional[Dict[str, int]] = None):
    """Spec tree matching the MMDiT param tree; ``sizes`` ({axis: extent},
    ``mesh.shape``) enables the even-tiling ladder."""
    return _map(params, lambda p, x: transformer_leaf_spec(p, getattr(x, "shape", None), sizes))


def vl_param_specs(params: Any, axes: Sequence[str] = (CFG_AXIS, MODEL_AXIS),
                   sizes: Optional[Dict[str, int]] = None):
    """Spec tree matching a VL param tree ({"vision", "lm"}) sharded over
    ``axes``."""
    return _map(params, lambda p, x: vl_leaf_spec(p, axes, getattr(x, "shape", None), sizes))


def vl_axes(mesh: Mesh, cfg) -> Tuple[str, ...]:
    """The axes the VL encoder shards over: every axis of the mesh with
    extent > 1 where the q, kv and vision heads all divide their product
    (the JAX encoder shards over every axis), else ``model`` alone where
    they divide it, else none. The head-level form of the ladder: a rank
    must hold whole heads."""
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.vision_heads)
    every = tuple(a for a in mesh.axis_names if mesh.shape[a] > 1)
    for axes in (every, (MODEL_AXIS,)):
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        if axes and n > 1 and all(h % n == 0 for h in heads):
            return axes
    return ()


def site_group(mesh: Optional[Mesh], axes: Sequence[str], dim: int) -> Group:
    """The group that a sharded dimension of size ``dim`` splits over: the
    ladder's fit of ``axes``, the group the specs slice that leaf over."""
    if mesh is None or not axes:
        return SINGLE
    return mesh.group(fit_axes(axes, dim, mesh.shape) or ())


def check_heads(num_heads: int, mesh: Optional[Mesh]) -> None:
    """The MMDiT refuses a model axis that does not divide its heads: a rank
    holds whole heads (the JAX package falls back to unsharded XLA
    attention there, a path without a kernel)."""
    if mesh is not None and num_heads % mesh.model:
        raise ValueError(f"the model axis ({mesh.model}) does not divide the "
                         f"MMDiT's {num_heads} heads")


def slice_part(t: torch.Tensor, spec: Spec, mesh: Optional[Mesh], fused: bool = False
               ) -> torch.Tensor:
    """This rank's part of the full leaf ``t`` under ``spec`` — a view of
    ``t`` (a fused q/k/v leaf: the three parts concatenated, a new tensor).
    Along dim 0 of a contiguous tensor the view is one contiguous range (per
    third for a fused leaf)."""
    if spec is None:
        return t
    dim, axes = spec
    group = mesh.group(axes)
    if group.size == 1:
        return t
    n = t.shape[dim]
    if fused and dim == 0:
        third = n // 3
        k = third // group.size
        return torch.cat([t.narrow(0, j * third + group.rank * k, k)
                          for j in range(3)], dim=0)
    k = n // group.size
    return t.narrow(dim, group.rank * k, k)


def pad_codes(w_q: torch.Tensor) -> torch.Tensor:
    """An int8 (out, in) slice with zero input columns up to a multiple of
    16 (itself where ``in`` is one)."""
    pad = -w_q.shape[1] % 16
    return torch.nn.functional.pad(w_q, (0, pad)) if pad else w_q


def _owner(path: Sequence[str]) -> str:
    return path[-2] if len(path) >= 2 else ""


def shard_leaves(params: Any, mesh: Optional[Mesh], spec_of: Callable, device=None,
                 prefix: Tuple[str, ...] = (), skip_blocks: bool = False) -> Any:
    """Replace, in place and one leaf at a time, every leaf of ``params``
    by this rank's part (on ``device``, a copy; by default the leaf's own
    device), so that a full leaf is freed as its part lands. ``spec_of(path,
    shape)`` gives a leaf's spec, ``path`` starting with ``prefix`` (the
    keys of ``params`` in its whole tree). A leaf may be a host view of a
    mapped file: only its part is read. ``skip_blocks``: leave the subtrees
    under ``blocks`` keys alone."""
    for path, leaf, parent, key in list(_walk(params, prefix, skip_blocks)):
        spec = spec_of(path, tuple(leaf.shape))
        part = slice_part(leaf, spec, mesh, fused=_owner(path) in FUSED)
        if key == "w_q" and spec is not None and spec[0] == 1 and part is not leaf:
            part = pad_codes(part)
        dev = leaf.device if device is None else torch.device(device)
        parent[key] = part.to(dev, copy=True).contiguous() if (
            part is not leaf or leaf.device != dev) else leaf
    return params


def shard_transformer_params(params: Any, mesh: Mesh, device=None) -> Any:
    """The MMDiT tree sliced to this rank's parts, in place (see
    :func:`shard_leaves`)."""
    sizes = mesh.shape
    return shard_leaves(params, mesh,
                        lambda p, s: transformer_leaf_spec(p, s, sizes), device)


def shard_vl_params(params: Any, mesh: Mesh, cfg, device=None) -> Any:
    """The VL tree sliced to this rank's parts over :func:`vl_axes`, in
    place."""
    axes, sizes = vl_axes(mesh, cfg), mesh.shape
    return shard_leaves(params, mesh,
                        lambda p, s: vl_leaf_spec(p, axes, s, sizes), device)


def to_device(tree: Any, device, skip_blocks: bool = False) -> Any:
    """Every leaf of ``tree`` copied onto ``device``, in place."""
    dev = torch.device(device)
    for _, leaf, parent, key in list(_walk(tree, (), skip_blocks)):
        if leaf.device != dev:
            parent[key] = leaf.to(dev, copy=True)
    return tree


def shard_module(node: Any, prefix: Tuple[str, ...], mesh: Optional[Mesh],
                 spec_of: Callable, device, transform: Optional[Callable] = None,
                 skip_blocks: bool = False) -> Any:
    """One module of a build (a block, or with ``skip_blocks`` the leaves
    outside the blocks), in place. With ``transform`` (LoRA fusion, q/k/v
    fusion, quantization: what needs the whole leaf) it is copied whole onto
    ``device`` (None: where it lies), transformed, then sliced; without,
    each leaf is sliced where it lies and only the slice is copied. A rank's
    peak is then its slices plus one module. Without a mesh (``spec_of``
    gives None) nothing is sliced."""
    if transform is not None:
        if device is not None:
            to_device(node, device, skip_blocks)
        transform(node)
    return shard_leaves(node, mesh, spec_of, device, prefix, skip_blocks)
