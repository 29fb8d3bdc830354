"""The (cfg × model) mesh of ``torch.distributed`` ranks.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/core/meshes.py``, with the
same axes and layout:

- ``model`` — Megatron-style tensor parallelism of the MMDiT (and of the VL
  encoder where its heads allow): each rank holds a slice of the block
  weights, and the forward calls its collectives over the rank's model group;
- ``cfg`` — the positive and negative rows of ``cfg_mode="parallel"``, or
  the rows of a cond-only multi-row call, split over the cfg groups.

``model`` is the inner axis: rank = c · model + m. The model group of a rank
is the ranks with its c, its cfg group the ranks with its m. Where JAX
annotates arrays and lets XLA place the collectives, the port's forward code
calls them itself (``parallel/distributed.py``) on these groups.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any, ClassVar, Dict, List, Optional, Sequence, Tuple

CFG_AXIS = "cfg"
MODEL_AXIS = "model"
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


@dataclass(frozen=True)
class Group:
    """One axis group of this rank: its process group (None for a group of
    one rank), its size and this rank's index in it."""

    pg: Any
    size: int
    rank: int


SINGLE = Group(None, 1, 0)


@dataclass(frozen=True)
class Mesh:
    """A (cfg, model) mesh seen from one rank: the axis sizes, this rank's
    coordinates (c, m) and its groups."""

    cfg: int
    model: int
    c: int
    m: int
    model_group: Group
    cfg_group: Group
    world_group: Group

    axis_names: ClassVar[Tuple[str, str]] = (CFG_AXIS, MODEL_AXIS)

    @property
    def shape(self) -> Dict[str, int]:
        return {CFG_AXIS: self.cfg, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.cfg * self.model

    def group(self, axes: Sequence[str]) -> Group:
        """The group that spans ``axes`` (cfg-first, as the specs name them):
        both axes → the world, one → that axis's group, none → this rank."""
        axes = tuple(a for a in axes if self.shape[a] > 1)
        if len(axes) == 2:
            return self.world_group
        if axes == (MODEL_AXIS,):
            return self.model_group
        if axes == (CFG_AXIS,):
            return self.cfg_group
        return SINGLE


def layout(cfg_axis: int, model_axis: int
           ) -> Tuple[List[List[int]], List[List[int]]]:
    """(model groups, cfg groups) of a cfg × model world as rank lists: rank
    = c · model + m, so the model groups are the rows of the JAX
    ``make_mesh`` grid and the cfg groups its columns."""
    model_groups = [[c * model_axis + m for m in range(model_axis)]
                    for c in range(cfg_axis)]
    cfg_groups = [[c * model_axis + m for c in range(cfg_axis)]
                  for m in range(model_axis)]
    return model_groups, cfg_groups


def single_device_mesh() -> Mesh:
    return Mesh(1, 1, 0, 0, SINGLE, SINGLE, SINGLE)


def make_mesh(cfg_axis: int = 1, model_axis: Optional[int] = None,
              timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """The (cfg, model) mesh over the world that ``torch.distributed`` was
    initialised with (``parallel/distributed.py::initialize``; an
    uninitialised process is a world of one). ``model_axis`` None takes the
    ranks left after ``cfg_axis``. Raises where cfg × model differs from the
    world size. Every rank must call it, in the same order as every other
    collective setup: it creates the model and cfg groups with
    ``new_group``, each with ``timeout``, so that a rank left waiting by a
    desync fails instead of hanging."""
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if live else 1
    if model_axis is None:
        if world % cfg_axis:
            raise ValueError(f"{world} ranks not divisible by cfg={cfg_axis}")
        model_axis = world // cfg_axis
    if cfg_axis < 1 or model_axis < 1 or cfg_axis * model_axis != world:
        raise ValueError(f"mesh {cfg_axis}x{model_axis} needs "
                         f"{cfg_axis * model_axis} ranks, the world has {world}")
    if world == 1:
        return single_device_mesh()
    rank = dist.get_rank()
    c, m = divmod(rank, model_axis)

    def groups(rank_lists):
        mine = SINGLE
        for ranks in rank_lists:
            if len(ranks) == 1:
                continue
            pg = dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                mine = Group(pg, len(ranks), ranks.index(rank))
        return mine

    model_lists, cfg_lists = layout(cfg_axis, model_axis)
    model_group = groups(model_lists)
    cfg_group = groups(cfg_lists)
    world_group = Group(dist.group.WORLD, world, rank)
    return Mesh(cfg_axis, model_axis, c, m, model_group, cfg_group, world_group)
