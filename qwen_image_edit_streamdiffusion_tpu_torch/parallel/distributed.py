"""Process-group set-up and the collectives that the model code calls.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/parallel/distributed.py``.
The JAX package runs one SPMD program per host and lets XLA place the
collectives; the port runs one process per rank (``torchrun``, or
``torch.multiprocessing`` spawn) and calls them itself:

- :func:`initialize` sets up ``torch.distributed`` from torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``) or from explicit arguments, and is a no-op for a world of
  one, as the JAX ``initialize`` is off-pod;
- :func:`global_mesh` builds the (cfg × model) mesh over that world;
- :func:`all_reduce`, :func:`all_gather` and :func:`broadcast_object` are what
  the forward code and the serving loop call, on a ``core.meshes.Group``.
  A group of one rank returns its input untouched;
- :func:`reduce_from` and :func:`copy_to` are the conjugate pair of
  Megatron-style tensor parallelism under autograd: the sum over the model
  group of a row-parallel linear's partial products (identity in the
  backward), and the identity in front of the column-parallel linears
  whose backward sums the input's gradient over the group (each rank holds
  only its own heads' share of it). The backward all-reduces count under
  ``all_reduce_bwd`` in :data:`STATS`, the train step's one adapter
  gradient reduction under ``grad_reduce``.

The backend is the caller's choice and nothing switches it: ``nccl`` by
default on CUDA, ``gloo`` on the CPU, or on CUDA where several ranks share
one card (NCCL refuses two ranks on one device; gloo stages CUDA tensors
through host memory and takes their bf16, f32 and int32 sums and maxima,
``all_gather`` and object broadcasts, as ``chip_smoke.py``'s phases ``tp``
and ``mesh`` use them on one H100). A rank's device is explicit:
``cuda:LOCAL_RANK`` by default; nothing moves a rank to the CPU.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, NamedTuple, Optional

import torch

from qwen_image_edit_streamdiffusion_tpu_torch.core import meshes
from qwen_image_edit_streamdiffusion_tpu_torch.core.meshes import DEFAULT_TIMEOUT, Group

# calls and bytes since the last reset, one entry per collective (a plain
# count: what chip_smoke.py and PERF.md read per forward)
STATS: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "broadcast": 0,
                         "all_reduce_bytes": 0, "all_gather_bytes": 0,
                         "all_reduce_bwd": 0, "all_reduce_bwd_bytes": 0,
                         "grad_reduce": 0, "grad_reduce_bytes": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


class World(NamedTuple):
    rank: int
    world_size: int
    local_rank: int
    device: torch.device


def initialize(backend: Optional[str] = None, device=None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT,
               init_method: Optional[str] = None, rank: Optional[int] = None,
               world_size: Optional[int] = None) -> World:
    """Initialise the default process group, once a process, and return
    (rank, world size, local rank, this rank's device).

    ``rank`` / ``world_size`` default to torchrun's ``RANK`` /
    ``WORLD_SIZE`` (a process without them is a world of one: nothing is
    initialised), ``init_method`` to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``). ``device`` defaults to ``cuda:LOCAL_RANK``;
    ``backend`` to ``nccl`` for a CUDA device and ``gloo`` for the CPU.
    ``timeout`` bounds every collective of the group, so a desync between
    ranks raises instead of hanging."""
    import torch.distributed as dist

    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    device = torch.device(device if device is not None else f"cuda:{local_rank}")
    if world_size > 1 and not dist.is_initialized():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        if backend == "nccl":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size, timeout=timeout)
    return World(rank, world_size, local_rank, device)


def global_mesh(cfg_axis: int = 1, model_axis: Optional[int] = None,
                timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> meshes.Mesh:
    """(cfg × model) mesh over every rank of the world; ``model`` innermost."""
    return meshes.make_mesh(cfg_axis=cfg_axis, model_axis=model_axis,
                            timeout=timeout)


def shutdown() -> None:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def all_reduce(t: torch.Tensor, group: Group, op: str = "sum",
               key: str = "all_reduce") -> torch.Tensor:
    """Sum (or ``op="max"``) ``t`` over ``group``, in place; returns ``t``.
    Counted in :data:`STATS` under ``key`` (calls) and ``key + "_bytes"``."""
    if group.size == 1:
        return t
    import torch.distributed as dist

    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=group.pg)
    STATS[key] += 1
    STATS[key + "_bytes"] += t.numel() * t.element_size()
    return t


class _ReduceFrom(torch.autograd.Function):
    """All-reduce sum in the forward, identity in the backward."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.mark_dirty(t)
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyTo(torch.autograd.Function):
    """Identity in the forward, all-reduce sum of the gradient in the
    backward."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group, key="all_reduce_bwd"), None


def _grad_path(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def reduce_from(t: torch.Tensor, group: Group) -> torch.Tensor:
    """``t`` (a row-parallel linear's partial product) summed over
    ``group``, in place: an autograd node whose backward passes the
    gradient on unchanged (every rank then holds the whole gradient of the
    sum) where ``t`` needs a gradient, else the plain all-reduce."""
    if group.size == 1:
        return t
    if _grad_path(t):
        return _ReduceFrom.apply(t, group)
    return all_reduce(t, group)


def copy_to(t: torch.Tensor, group: Group) -> torch.Tensor:
    """``t`` (the whole input of column-parallel linears) as it is, with a
    backward that sums its gradient over ``group``: each rank's linears
    give only their own output slice's share of it. Only where ``t`` needs
    a gradient; elsewhere (serving, a teacher under ``no_grad``, a first
    block whose input nothing upstream trains) ``t`` itself."""
    if group.size == 1 or not _grad_path(t):
        return t
    return _CopyTo.apply(t, group)


def barrier(group: Group) -> None:
    """Wait until every rank of ``group`` has reached this call."""
    if group.size == 1:
        return
    import torch.distributed as dist

    dist.barrier(group=group.pg)


def all_gather(t: torch.Tensor, group: Group, dim: int = -1) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in the group's rank
    order (the inverse of slicing ``dim`` into equal parts)."""
    if group.size == 1:
        return t
    import torch.distributed as dist

    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(group.size)]
    dist.all_gather(parts, t, group=group.pg)
    STATS["all_gather"] += 1
    STATS["all_gather_bytes"] += t.numel() * t.element_size() * group.size
    return torch.cat(parts, dim=dim)


def broadcast_object(obj: Any, group: Group, src: int = 0) -> Any:
    """``obj`` of the group's rank ``src`` on every rank of the group."""
    if group.size == 1:
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group.pg, src),
                               group=group.pg)
    STATS["broadcast"] += 1
    return box[0]
