"""Shared functional building blocks.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/models/common.py``. Models
are plain functions over nested dicts of tensors, as in the JAX package, with
two leaf kinds:

- linear: ``{"weight": (out, in), "bias": (out,)}`` — torch's ``nn.Linear``
  layout (the JAX package stores ``w`` as (in, out); ``models/convert.py``
  transposes), or its int8 / int4 form from ``models/quantize.py``
  (``{"w_q", "scale", "bias"}`` / ``{"w_q4", "scale4", "bias"}``, layouts in
  ``ops/int8.py``);
- conv: ``{"w": (kh, kw, in, out) HWIO, "b": (out,)}`` — the JAX layout, on
  NHWC activations.

Every parameter is created on its device, in its dtype, from an explicit
generator, with the JAX package's init distributions (Kaiming-uniform).
Norms, softmax and modulation accumulate in f32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from qwen_image_edit_streamdiffusion_tpu_torch.core.meshes import SINGLE, Group
from qwen_image_edit_streamdiffusion_tpu_torch.ops import int8 as int8_ops

Params = Dict[str, Any]


def uniform(shape, scale: float, dtype, device, gen) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype, device=device)
    if t.device.type != "meta":
        t.uniform_(-scale, scale, generator=gen)
    return t


def linear_init(gen, in_dim: int, out_dim: int, dtype, device,
                bias: bool = True) -> Params:
    """Kaiming-uniform (torch nn.Linear default), weight (out, in)."""
    scale = (1.0 / in_dim) ** 0.5
    p = {"weight": uniform((out_dim, in_dim), scale, dtype, device, gen)}
    if bias:
        p["bias"] = uniform((out_dim,), scale, dtype, device, gen)
    return p


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Dispatch on the leaf's keys, as the JAX ``common.linear`` does: an
    int8 leaf runs K5 → K6, an int4 leaf dequantizes, the rest ``F.linear``."""
    if "w_q" in p:
        return int8_ops.int8_linear(x, p)
    if "w_q4" in p:
        return int8_ops.int4_linear(x, p)
    return F.linear(x, p["weight"], p.get("bias"))


def row_linear(p: Params, x: torch.Tensor, group: Group = SINGLE) -> torch.Tensor:
    """A row-parallel linear (``parallel/sharding.py``) over ``group``: x
    holds this rank's slice of the input features and ``p`` the matching
    slice of the weight's input dim. The partial products are summed over
    the group (``distributed.reduce_from``: under autograd its backward
    passes the whole gradient on to each rank's slice) and the bias is
    added once, after the sum (the JAX row rule keeps the bias whole and
    psums the partial products before it). An int8 leaf sums exact int32
    products (``ops/int8.py::int8_linear_row``). A group of one rank is
    :func:`linear`."""
    if group.size == 1:
        return linear(p, x)
    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed

    if "w_q" in p:
        return int8_ops.int8_linear_row(x, p, group)
    if "w_q4" in p:
        y = int8_ops.int4_linear(x, p, group)
    else:
        y = F.linear(x, p["weight"])
    y = distributed.reduce_from(y, group)
    b = p.get("bias")
    return y if b is None else y + b.to(y.dtype)


def column_input(x: torch.Tensor, group: Group = SINGLE) -> torch.Tensor:
    """The whole input of column-parallel linears over ``group``: ``x``
    itself, whose gradient (where it needs one) each rank's linears give
    only their output slice's share of, so the backward sums it over the
    group (``distributed.copy_to``)."""
    if group.size == 1:
        return x
    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed

    return distributed.copy_to(x, group)


def gather_linear(p: Params, x: torch.Tensor, group: Group = SINGLE) -> torch.Tensor:
    """A column-parallel linear whose output is needed whole (the
    modulation vectors, the vision patch embedding): this rank's output
    features, all-gathered along the last dim in rank order.

    The gathered parts carry no gradient. That is right where it is called:
    nothing trained lies upstream of the MMDiT's ``temb_act`` or inside the
    VL encoder. A product that needs a gradient (a LoRA on ``img_mod`` /
    ``txt_mod`` under a mesh) raises instead of training on a wrong one."""
    if group.size == 1:
        return linear(p, x)
    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed

    y = linear(p, x)
    if torch.is_grad_enabled() and y.requires_grad:
        raise NotImplementedError(
            "gather_linear under a mesh carries no gradient: a column-parallel "
            "product that needs one (a LoRA target on the modulations) cannot "
            "train under tensor parallelism")
    return distributed.all_gather(y, group, dim=-1)


def rms_norm_init(dim: int, dtype, device) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rms_norm(p: Optional[Params], x: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm in f32 (torch's fused norm on an f32 copy), output cast back
    to the input dtype."""
    scale = p["scale"].float() if p is not None else None
    return F.rms_norm(x.float(), (x.shape[-1],), scale, eps).to(x.dtype)


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Affine-free LayerNorm in f32 (torch's fused norm on an f32 copy)."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """gelu with the tanh approximation (``jax.nn.gelu``'s default)."""
    return F.gelu(x, approximate="tanh")


def conv2d_init(gen, in_ch: int, out_ch: int, kernel: int, dtype, device
                ) -> Params:
    scale = (1.0 / (in_ch * kernel * kernel)) ** 0.5
    return {"w": uniform((kernel, kernel, in_ch, out_ch), scale, dtype, device, gen),
            "b": uniform((out_ch,), scale, dtype, device, gen)}


def same_padding(size: int, k: int, stride: int):
    """(before, after) padding of XLA's "SAME" along one axis: the output
    has ceil(size / stride) positions and the odd pad goes after. A 3×3
    stride-2 conv on an even size pads 0 before and 1 after."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(p: Params, x: torch.Tensor, stride: int = 1,
           padding: str = "SAME", use_kernel: bool = True) -> torch.Tensor:
    """NHWC conv with HWIO weights. Convs that pass the K3 gate (stride-1
    SAME 3×3, C_in <= 128, C_in % 8 == 0) go through ops.conv.conv3x3, as
    the JAX package routes them to its Pallas kernel; the rest go to
    ``F.conv2d``, as JAX leaves them to XLA. ``use_kernel=False`` opts a
    call site out, as the JAX ``use_pallas=False`` does (the tiny VAE
    pair)."""
    from qwen_image_edit_streamdiffusion_tpu_torch.ops import conv as conv_ops

    w = p["w"].to(x.dtype)
    b = p["b"].to(x.dtype)
    if use_kernel and conv_ops.supported(x, w, stride, padding):
        return conv_ops.conv3x3(x, w, b)
    k = w.shape[0]
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME" and stride == 1:
        pad = k // 2
    elif padding == "SAME":
        (t, bo), (le, ri) = (same_padding(n, k, stride) for n in x.shape[1:3])
        xc, pad = F.pad(xc, (le, ri, t, bo)), 0
    elif padding == "VALID":
        pad = 0
    else:
        raise ValueError(f"unknown padding {padding!r}")
    y = F.conv2d(xc, w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last),
                 b, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1).contiguous()


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                       scale: float = 1000.0) -> torch.Tensor:
    """Sinusoidal features (B,) → (B, dim), cos first, in f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    args = scale * t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def flatten(tree: Any, prefix: str = "", sep: str = ".") -> Dict[str, Any]:
    """{path: leaf} of a nested dict / list tree, the keys joined by ``sep``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-len(sep)]: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{k}{sep}", sep))
    return out


def unflatten(flat: Dict[str, Any], sep: str = ".") -> Params:
    """Inverse of :func:`flatten`: {"a.0.b": leaf} → nested dicts and lists
    (a digit part is a list index), as the JAX ``_load_tree`` builds them."""
    root: Params = {}
    for key, leaf in flat.items():
        parts = key.split(sep)
        node: Any = root
        for i, part in enumerate(parts):
            last = i == len(parts) - 1
            nxt: Any = leaf if last else ([] if parts[i + 1].isdigit() else {})
            if isinstance(node, list):
                idx = int(part)
                while len(node) <= idx:
                    node.append(None)
                if node[idx] is None:
                    node[idx] = nxt
                node = node[idx]
            else:
                if last and part in node:
                    raise ValueError(f"duplicate key {key!r}")
                node = node.setdefault(part, nxt)
    return root


def param_count(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_count(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(param_count(v) for v in tree)
    return tree.numel()
