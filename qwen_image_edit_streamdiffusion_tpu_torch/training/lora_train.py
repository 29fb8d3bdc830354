"""LoRA fine-tuning of the edit transformer.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/training/lora_train.py``:
a flow-matching LoRA fine-tune whose adapters export in the diffusers/peft key
layout that ``models/lora.py::fuse_lora`` consumes, so train → save → fuse →
serve needs no format glue.

- **Frozen base, trainable adapters.** Per target linear ``a`` (in, r) and
  ``b`` (r, out) in f32, the JAX layout, so a JAX adapter tree crosses with a
  copy (``models/convert.py::lora_from_jax``). The effective weight
  w + scale·(a·b)ᵀ is merged per block inside the checkpointed block
  (``transformer.forward``'s ``block_map``, ``remat``), so it is recomputed in
  the backward and never saved.
- **Flash attention under autograd.** With ``use_flash`` the joint attention
  of every block runs K7 in the forward and K8, K9 in the backward
  (``ops/flash_attention.py::FlashAttentionTrainable``); with ``remat`` the
  forward runs twice a step.
- **Objective**: x_σ = (1−σ)·x₀ + σ·ε, target v = ε − x₀, σ logit-normal then
  pushed through the serving scheduler's exponential shift.
- **Optimizer**: a global-norm clip with ``optax.clip_by_global_norm``'s
  formula (no epsilon on the norm, unlike ``clip_grad_norm_``), then
  ``torch.optim.AdamW`` (eps 1e-8). Sigmas and noise come from the port's
  named ``torch.Generator`` streams, not ``jax.random``.
- **Under a (cfg × model) mesh** (a pipeline built with ``mesh=``), as the
  JAX ``build_step`` shards it: the frozen base stays tensor-parallel over
  ``model`` (the forward's collectives are autograd nodes:
  ``parallel/distributed.py::reduce_from`` / ``copy_to``), the batch rows
  split over the ``cfg`` groups where they divide (else every group runs
  every row), and the adapters are whole on every rank: drawn at the whole
  linears' shapes, each rank merging its slice of the delta
  (:func:`merge_block`). After the backward one flat all-reduce over the
  world takes each adapter gradient's sum over ``model`` (a sharded leaf's
  ranks hold partials or disjoint slices; a whole leaf's is taken once)
  and its mean over ``cfg``, with the loss; every rank then clips and
  steps on the same numbers, so the adapters stay the same on every rank.
  Sigmas and noise are drawn for the whole batch on every rank, and each
  cfg group takes its rows, so a world's step is one process's step on
  the same batch. Files are written by world rank 0.

CLI (one synthetic edit pair, a few steps)::

    python -m qwen_image_edit_streamdiffusion_tpu_torch.training.lora_train \\
        --preset tiny --device cpu
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from qwen_image_edit_streamdiffusion_tpu_torch.core import imaging
from qwen_image_edit_streamdiffusion_tpu_torch.core.config import (
    ModelConfig,
    SchedulerConfig,
)
from qwen_image_edit_streamdiffusion_tpu_torch.core.meshes import SINGLE, Group, Mesh
from qwen_image_edit_streamdiffusion_tpu_torch.core.rng import stream
from qwen_image_edit_streamdiffusion_tpu_torch.models import scheduler as sched
from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm
from qwen_image_edit_streamdiffusion_tpu_torch.models.lora import (
    BLOCK_MODULE_MAP,
    FUSED_SLOT,
    save_safetensors,
)
from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed, sharding

Params = Any

# Default adapter targets: every attention projection (the Lightning LoRA's
# target set), as diffusers module names.
DEFAULT_TARGETS: Tuple[str, ...] = (
    "attn.to_q", "attn.to_k", "attn.to_v", "attn.to_out.0",
    "attn.add_q_proj", "attn.add_k_proj", "attn.add_v_proj",
    "attn.to_add_out",
)
MLP_TARGETS: Tuple[str, ...] = (
    "img_mlp.net.0.proj", "img_mlp.net.2",
    "txt_mlp.net.0.proj", "txt_mlp.net.2",
)

_PATH_TO_MODULE = {v: k for k, v in BLOCK_MODULE_MAP.items()}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """LoRA fine-tune hyperparameters (the JAX package's)."""

    rank: int = 16
    alpha: float = 16.0  # fused scale = alpha / rank (peft convention)
    targets: Tuple[str, ...] = DEFAULT_TARGETS
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    grad_clip: float = 1.0  # global-norm clip; 0 disables
    timestep_mean: float = 0.0
    timestep_std: float = 1.0
    shift_timesteps: bool = True
    remat: bool = True  # checkpoint each block (with its LoRA merge)
    seed: int = 0


# ---------------------------------------------------------------------------
# Adapters
# ---------------------------------------------------------------------------


def _target_paths(targets: Sequence[str]) -> List[Tuple[str, ...]]:
    for t in targets:
        if t not in BLOCK_MODULE_MAP:
            raise ValueError(f"unknown LoRA target {t!r}; known: "
                             f"{sorted(BLOCK_MODULE_MAP)}")
    return [BLOCK_MODULE_MAP[t] for t in targets]


def _resolve_target(block: dict, path: Tuple[str, ...]):
    """→ (leaf, row slot or None, d_in, d_out) of the linear a target lands
    in; a q/k/v target of a fused block lands in its row slot."""
    def dense_w(leaf):
        if "weight" not in leaf:
            raise ValueError(
                "LoRA training requires dense weights — quantized "
                "(int8/int4) base params cannot be adapter-trained; train "
                "on bf16, then quantize the fused result")
        return leaf["weight"]

    node = block
    for p in path:
        if p not in node:
            if p in FUSED_SLOT and FUSED_SLOT[p][0] in node:
                name, slot = FUSED_SLOT[p]
                d3, d_in = dense_w(node[name]).shape
                return node[name], slot, d_in, d3 // 3
            raise ValueError(f"param path {path} missing at {p!r}")
        node = node[p]
    d_out, d_in = dense_w(node).shape
    return node, None, d_in, d_out


def init_lora(params: Params, cfg: TrainConfig, gen: torch.Generator,
              tp: Group = SINGLE) -> Params:
    """Zero-effect adapters mirroring ``params['blocks']``: ``a`` (in, r) ~
    N(0, 1/in), ``b`` (r, out) zeros, both f32 with ``requires_grad``, on the
    base weights' device (drawn from ``gen``, a CPU generator, so the same
    seed gives the same adapters on every device). Under a model group
    ``tp`` the blocks hold this rank's slices; every adapter takes the whole
    linear's shape (the slice's, times ``tp.size`` on the dim that
    :func:`adapter_spec` splits), so the ranks and one process draw the same
    adapters. A mesh's pipeline splits every such leaf: ``tp.size`` divides
    the heads (``sharding.check_heads``), so it divides every width."""
    paths = _target_paths(cfg.targets)
    blocks = []
    for blk in params["blocks"]:
        lb: dict = {}
        for path in paths:
            leaf, _, d_in, d_out = _resolve_target(blk, path)
            spec = adapter_spec(path, d_in * tp.size, d_out * tp.size, tp)
            if spec is not None and spec[0] == 0:
                d_out *= tp.size
            elif spec is not None:
                d_in *= tp.size
            dev = leaf["weight"].device
            node = lb
            for p in path[:-1]:
                node = node.setdefault(p, {})
            a = torch.randn((d_in, cfg.rank), generator=gen) / math.sqrt(d_in)
            node[path[-1]] = {
                "a": a.to(dev).requires_grad_(),
                "b": torch.zeros((cfg.rank, d_out), device=dev,
                                 requires_grad=True),
            }
        blocks.append(lb)
    return {"blocks": blocks}


def _is_lora_leaf(node) -> bool:
    return (isinstance(node, dict) and set(node) == {"a", "b"}
            and torch.is_tensor(node["a"]))


def _adapter_paths(lora: Params) -> List[Tuple[str, ...]]:
    """The block-relative path of every adapter pair, in the order of
    :func:`lora_leaves` (block, then sorted keys)."""
    out: List[Tuple[str, ...]] = []

    def walk(node, path):
        for k in sorted(node):
            sub = node[k]
            if _is_lora_leaf(sub):
                out.append(path + (k,))
            else:
                walk(sub, path + (k,))

    for blk in lora["blocks"]:
        walk(blk, ())
    return out


def lora_leaves(lora: Params) -> List[torch.Tensor]:
    """Every adapter tensor, in a fixed order (block, target, a then b)."""
    out: List[torch.Tensor] = []

    def walk(node):
        for k in sorted(node):
            sub = node[k]
            if _is_lora_leaf(sub):
                out.extend((sub["a"], sub["b"]))
            else:
                walk(sub)

    for blk in lora["blocks"]:
        walk(blk)
    return out


def adapter_spec(path: Tuple[str, ...], d_in: int, d_out: int,
                 tp: Group) -> sharding.Spec:
    """The spec (``parallel/sharding.py``) of the base leaf that the adapter
    at the block-relative ``path`` lands in, over a model group of
    ``tp.size`` ranks: dim 0 for a column-parallel leaf, 1 for a
    row-parallel one, None for a leaf left whole."""
    if tp.size == 1:
        return None
    return sharding.transformer_leaf_spec(("blocks", "0") + tuple(path) + ("weight",),
                                          (d_out, d_in), {"cfg": 1, "model": tp.size})


def _delta(a: torch.Tensor, b: torch.Tensor, scale: float, spec: sharding.Spec,
           tp: Group) -> torch.Tensor:
    """This rank's part of scale·(a·b)ᵀ (out, in): a column leaf's output
    rows (a·b[:, out_slice])ᵀ, a row leaf's input columns (a[in_slice]·b)ᵀ,
    a whole leaf the whole delta."""
    if spec is None:
        return ((a @ b) * scale).t()
    if spec[0] == 0:
        n = b.shape[1] // tp.size
        return ((a @ b[:, tp.rank * n:(tp.rank + 1) * n]) * scale).t()
    n = a.shape[0] // tp.size
    return ((a[tp.rank * n:(tp.rank + 1) * n] @ b) * scale).t()


def merge_block(p_node: dict, l_node: dict, scale: float, tp: Group = SINGLE,
                path: Tuple[str, ...] = ()) -> dict:
    """One block's effective params, w + scale·(a·b)ᵀ in f32 cast to the
    base dtype (a fused q/k/v target lands in its row slot). Out of place and
    differentiable in the adapters; the base tree is not touched. Under a
    model group ``tp`` the block holds this rank's slices and each gets its
    slice of the whole adapter's delta (:func:`adapter_spec`)."""
    out = dict(p_node)
    for k, sub in l_node.items():
        if not _is_lora_leaf(sub):
            out[k] = merge_block(out[k], sub, scale, tp, path + (k,))
            continue
        a, b = sub["a"], sub["b"]
        delta = _delta(a, b, scale, adapter_spec(path + (k,), a.shape[0], b.shape[1], tp),
                       tp)  # (out, in)
        name, slot = k, None
        if k not in out and k in FUSED_SLOT:
            name, slot = FUSED_SLOT[k]
        leaf = dict(out[name])
        w = leaf["weight"]
        w32 = w.float()
        if slot is None:
            w32 = w32 + delta
        else:
            d = delta.shape[0]
            w32 = torch.slice_scatter(w32, w32[slot * d:(slot + 1) * d] + delta,
                                      dim=0, start=slot * d, end=(slot + 1) * d)
        leaf["weight"] = w32.to(w.dtype)
        out[name] = leaf
    return out


def apply_lora(params: Params, lora: Params, scale: float) -> Params:
    """The whole tree with adapters merged, out of place (export and
    equivalence checks; the train step merges per block)."""
    out = dict(params)
    out["blocks"] = [merge_block(pb, lb, scale)
                     for pb, lb in zip(params["blocks"], lora["blocks"])]
    return out


# ---------------------------------------------------------------------------
# Objective
# ---------------------------------------------------------------------------


def sample_sigmas(gen: torch.Generator, batch: int, cfg: TrainConfig,
                  image_seq_len: int, sched_cfg: SchedulerConfig) -> torch.Tensor:
    """Per-row training sigmas (CPU, f32): logit-normal in (0, 1), then the
    serving scheduler's resolution-dependent exponential shift."""
    u = torch.randn((batch,), generator=gen, dtype=torch.float32)
    t = torch.sigmoid(cfg.timestep_mean + cfg.timestep_std * u)
    t = t.clamp(1e-5, 1.0 - 1e-5)
    if cfg.shift_timesteps:
        t = sched._time_shift_exponential(
            sched.compute_mu(image_seq_len, sched_cfg), t)
    return t


def flow_match_loss(base_params: Params, lora: Params, scale: float,
                    model_cfg: ModelConfig, x0_tokens: torch.Tensor,
                    cond_tokens: torch.Tensor, txt: torch.Tensor,
                    txt_mask: torch.Tensor, sigmas: torch.Tensor,
                    noise: torch.Tensor, ropes: tfm.RopeTables,
                    use_flash: bool = False, remat: bool = True,
                    tp: Group = SINGLE) -> torch.Tensor:
    """MSE between predicted and true velocity (v = ε − x₀) on the target
    tokens; condition tokens ride along in the sequence, their predictions
    discarded, as in the serving forward. ``tp``: the model group whose
    slices ``base_params`` holds."""
    l_img = x0_tokens.shape[1]
    s = sigmas.float()[:, None, None]
    x0 = x0_tokens.float()
    eps = noise.float()
    x_t = ((1.0 - s) * x0 + s * eps).to(x0_tokens.dtype)
    inp = torch.cat([x_t, cond_tokens.to(x_t.dtype)], dim=1)
    v = tfm.forward(base_params, model_cfg, inp, txt, sigmas.float() * 1000.0,
                    ropes, txt_mask=txt_mask, use_flash=use_flash, remat=remat,
                    blocks_extra=lora["blocks"],
                    block_map=lambda blk, lb: merge_block(blk, lb, scale, tp), tp=tp)
    v = v[:, :l_img].float()
    return torch.mean(torch.square(v - (eps - x0)))


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: when the global L2 norm g is
    at least ``max_norm``, every gradient becomes (t / g) · max_norm.
    Returns g."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    if norm >= max_norm:
        for g in grads:
            g.div_(norm).mul_(max_norm)
    return norm


def live_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh``, or None for a mesh of one rank."""
    return mesh if mesh is not None and mesh.size > 1 else None


def group_rows(mesh: Optional[Mesh], *tensors):
    """This cfg group's rows of each whole-batch tensor (dim 0), where the
    cfg groups divide the rows (the JAX ``dp``); else the tensors whole,
    every group running every row."""
    if mesh is None or mesh.cfg == 1:
        return tensors
    rows = tensors[0].shape[0]
    if rows % mesh.cfg:
        return tensors
    n = rows // mesh.cfg
    c = mesh.cfg_group.rank
    return tuple(t[c * n:(c + 1) * n] for t in tensors)


def reduce_grads(mesh: Optional[Mesh], lora: Params, leaves: Sequence[torch.Tensor],
                 loss: torch.Tensor) -> torch.Tensor:
    """After the backward under ``mesh``: every adapter gradient summed over
    ``model`` where its base leaf is sharded (the ranks hold partial sums or
    disjoint slices of it), taken once where the leaf is whole, and averaged
    over ``cfg`` (right whether the rows split or every group ran them all),
    in one flat f32 all-reduce over the world that carries the loss too.
    Returns the whole batch's loss, the same on every rank. Gradients that
    autograd did not reach count as zeros. No mesh: ``loss``."""
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if mesh is None:
        return loss
    tp = mesh.model_group
    parts = []
    for path, (a, b) in zip(_adapter_paths(lora), zip(leaves[0::2], leaves[1::2])):
        whole = adapter_spec(path, a.shape[0], b.shape[1], tp) is None
        for p in (a, b):
            g = p.grad.float().reshape(-1)
            parts.append(g / mesh.model if whole else g)
    parts.append((loss.detach().float() / mesh.model).reshape(1))
    flat = torch.cat(parts)
    distributed.all_reduce(flat, mesh.world_group, key="grad_reduce")
    flat.div_(mesh.cfg)
    offset = 0
    for p in leaves:
        n = p.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n
    return flat[offset]


def build_step(model_cfg: ModelConfig, cfg: TrainConfig,
               optimizer: torch.optim.Optimizer,
               img_shapes: Tuple[Tuple[int, int, int], ...], txt_len: int,
               device, use_flash: bool = False, mesh: Optional[Mesh] = None):
    """The train step of one geometry bucket:

    step(base, lora, x0, cond, txt, txt_mask, sigmas, noise) -> loss

    loss and adapter gradients (autograd, the flash kernels' backward where
    they run), the global-norm clip, then one ``optimizer`` update. Under
    ``mesh`` the arguments are the whole batch: each cfg group takes its
    rows (:func:`group_rows`), the base holds this rank's slices, and the
    gradients and loss are reduced over the world (:func:`reduce_grads`)
    before the clip."""
    ropes = tfm.make_rope(model_cfg, img_shapes, txt_len, device)
    scale = cfg.alpha / cfg.rank
    mesh = live_mesh(mesh)
    tp = mesh.model_group if mesh is not None else SINGLE

    def step(base, lora, x0, cond, txt, txt_mask, sigmas, noise):
        leaves = lora_leaves(lora)
        optimizer.zero_grad(set_to_none=True)
        x0, cond, txt, txt_mask, sigmas, noise = group_rows(
            mesh, x0, cond, txt, txt_mask, sigmas, noise)
        loss = flow_match_loss(base, lora, scale, model_cfg, x0, cond, txt,
                               txt_mask, sigmas.to(device), noise.to(device),
                               ropes, use_flash=use_flash, remat=cfg.remat, tp=tp)
        loss.backward()
        loss = reduce_grads(mesh, lora, leaves, loss)
        apply_update(optimizer, leaves, cfg.grad_clip)
        return loss.detach()

    return step


def apply_update(optimizer: torch.optim.Optimizer,
                 leaves: Sequence[torch.Tensor], grad_clip: float) -> None:
    """After the backward: a zero gradient for every adapter autograd did
    not reach (e.g. the last block's txt_out, whose output is unused), the
    global-norm clip (0 disables), then one ``optimizer`` step."""
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if grad_clip:
        clip_by_global_norm_([p.grad for p in leaves], grad_clip)
    optimizer.step()


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


class LoRATrainer:
    """Geometry-bucketed LoRA train steps over a frozen base.

    Usage::

        trainer = LoRATrainer.from_pipeline(pipe, TrainConfig(rank=16))
        batch = build_batch(pipe, items)
        for _ in range(steps):
            loss = trainer.step(batch)
        save_lora(path, trainer.lora, trainer.cfg)

    The saved file fuses into serving with ``models.lora.fuse_lora`` or
    ``EditPipeline.from_weights(..., lora_path=path)``.
    """

    def __init__(self, base_params: Params, model_cfg: ModelConfig,
                 sched_cfg: SchedulerConfig, cfg: TrainConfig,
                 use_flash: bool = False, mesh: Optional[Mesh] = None):
        self.base_params = base_params
        self.model_cfg = model_cfg
        self.sched_cfg = sched_cfg
        self.cfg = cfg
        self.use_flash = use_flash
        self.mesh = live_mesh(mesh)
        self.device = base_params["img_in"]["weight"].device
        self.lora = init_lora(base_params, cfg, stream(cfg.seed, "lora"),
                              self.mesh.model_group if self.mesh is not None else SINGLE)
        self.opt = torch.optim.AdamW(
            lora_leaves(self.lora), lr=cfg.learning_rate,
            betas=(cfg.b1, cfg.b2), eps=1e-8, weight_decay=cfg.weight_decay)
        self._gen = stream(cfg.seed, "train")  # sigmas and noise, on the CPU
        self._steps: Dict[Tuple, Any] = {}
        self.steps = 0

    @classmethod
    def from_pipeline(cls, pipe, cfg: TrainConfig) -> "LoRATrainer":
        """A trainer on the pipeline's base; under its mesh (every rank of
        the world making the same calls) the step runs tensor- and
        row-parallel as the module docstring says."""
        return cls(pipe.tfm_params, pipe.preset.model, pipe.preset.scheduler,
                   cfg, use_flash=pipe.config.use_flash_attention,
                   mesh=getattr(pipe, "mesh", None))

    def _step_fn(self, img_shapes, txt_len: int):
        key = (img_shapes, txt_len)
        if key not in self._steps:
            self._steps[key] = build_step(self.model_cfg, self.cfg, self.opt,
                                          img_shapes, txt_len, self.device,
                                          self.use_flash, self.mesh)
        return self._steps[key]

    def draw(self, batch: Dict[str, Any]):
        """(sigmas, noise) of the next step from the trainer's generator."""
        x0 = batch["x0_tokens"]
        f, h, w = batch["img_shapes"][0]
        sigmas = sample_sigmas(self._gen, x0.shape[0], self.cfg, f * h * w,
                               self.sched_cfg)
        noise = torch.randn(tuple(x0.shape), generator=self._gen,
                            dtype=torch.float32)
        return sigmas, noise

    def step(self, batch: Dict[str, Any], sigmas: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> float:
        """One optimizer step on a :func:`build_batch` dict; sigmas and noise
        are drawn from the trainer's generator unless given (for the whole
        batch, on every rank of a mesh). Returns the whole batch's loss (a
        host sync)."""
        if sigmas is None or noise is None:
            sigmas, noise = self.draw(batch)
        fn = self._step_fn(tuple(batch["img_shapes"]), int(batch["txt"].shape[1]))
        loss = fn(self.base_params, self.lora, batch["x0_tokens"],
                  batch["cond_tokens"], batch["txt"], batch["txt_mask"],
                  sigmas, noise)
        self.steps += 1
        return float(loss)


# ---------------------------------------------------------------------------
# Batch construction from an EditPipeline
# ---------------------------------------------------------------------------


def build_batch(pipe, items: Sequence[Dict[str, Any]],
                height: Optional[int] = None,
                width: Optional[int] = None) -> Dict[str, Any]:
    """A train batch from (condition image(s), prompt, target image) items
    through the pipeline's own encoders and caches, so what is trained is
    what is served.

    items: [{"image": array or [arrays], "prompt": str, "target": array,
             "negative_prompt": str (optional)}, ...], images (H, W, 3)
    uint8. All items share one geometry bucket. Any item with a
    ``negative_prompt`` adds ``neg_txt``/``neg_mask`` rows (items without
    one take " "). Encodes run under ``torch.no_grad`` (not inference mode)
    and every tensor out of the caches is cloned: an inference-mode tensor
    saved for backward would raise."""
    want_neg = any("negative_prompt" in it for it in items)
    enc_reqs, metas = [], []
    with torch.no_grad():
        for it in items:
            image = it["image"]
            images = list(image) if isinstance(image, (list, tuple)) else [image]
            images = [imaging.as_uint8_array(i) for i in images]
            out_h, out_w, vae_images, vl_images = pipe._prepare_images(
                images, it.get("height", height), it.get("width", width))
            enc_reqs.append((it["prompt"], vl_images))
            if want_neg:
                enc_reqs.append((it.get("negative_prompt", " "), vl_images))
            metas.append((it, out_h, out_w, vae_images))
        all_embs = pipe.prompt_cache.encode_many(enc_reqs)
        embs = all_embs[0::2] if want_neg else all_embs
        neg_embs = all_embs[1::2] if want_neg else []
        l_txt = max(e.embeds.shape[0] for e in list(embs) + list(neg_embs))

        def emb_row(emb):
            e = torch.zeros((l_txt, emb.embeds.shape[1]), dtype=pipe._mdt,
                            device=pipe.device)
            m = torch.zeros((l_txt,), dtype=torch.bool, device=pipe.device)
            n = emb.embeds.shape[0]
            e[:n] = torch.as_tensor(emb.embeds).to(pipe.device, pipe._mdt)
            m[:n] = torch.as_tensor(emb.mask).to(pipe.device)
            return e[None], m[None]

        rows: Dict[str, List[torch.Tensor]] = {
            k: [] for k in ("x0_tokens", "cond_tokens", "txt", "txt_mask",
                            "neg_txt", "neg_mask")}
        geom = None
        for i, (it, out_h, out_w, vae_images) in enumerate(metas):
            cond, cond_shapes = pipe.latent_cache.get_or_encode(
                vae_images, pipe.encode_condition_latents)
            tgt = imaging.resize(imaging.as_uint8_array(it["target"]), out_w, out_h,
                                  "lanczos", pipe.device)
            x0, x0_shapes = pipe.encode_condition_latents([tgt])
            g = (tuple(x0_shapes), tuple(cond_shapes))
            if geom is None:
                geom = g
            elif g != geom:
                raise ValueError(
                    f"mixed geometry in batch: {g} vs {geom} — bucket items "
                    "by (output size, condition count) like the server does")
            rows["x0_tokens"].append(x0.clone())
            rows["cond_tokens"].append(cond.clone())
            e, m = emb_row(embs[i])
            rows["txt"].append(e)
            rows["txt_mask"].append(m)
            if want_neg:
                e, m = emb_row(neg_embs[i])
                rows["neg_txt"].append(e)
                rows["neg_mask"].append(m)

    x0_shapes, cond_shapes = geom
    out = {k: torch.cat(v, dim=0) for k, v in rows.items() if v}
    out["img_shapes"] = tuple(list(x0_shapes) + list(cond_shapes))
    return out


# ---------------------------------------------------------------------------
# Export, files, train state
# ---------------------------------------------------------------------------


def export_lora_state_dict(lora: Params, cfg: TrainConfig
                           ) -> Dict[str, np.ndarray]:
    """Adapters → the flat diffusers dict ``models.lora.fuse_lora`` reads:
    ``transformer_blocks.{i}.{module}.lora_A.weight`` (r, in), ``lora_B.weight``
    (out, r) and ``.alpha`` (0-d), f32 numpy."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, path, idx):
        for k, sub in node.items():
            if _is_lora_leaf(sub):
                base = f"transformer_blocks.{idx}.{_PATH_TO_MODULE[path + (k,)]}"
                out[f"{base}.lora_A.weight"] = (
                    sub["a"].detach().float().cpu().numpy().T.copy())
                out[f"{base}.lora_B.weight"] = (
                    sub["b"].detach().float().cpu().numpy().T.copy())
                out[f"{base}.alpha"] = np.asarray(cfg.alpha, np.float32)
            else:
                walk(sub, path + (k,), idx)

    for i, blk in enumerate(lora["blocks"]):
        walk(blk, (), i)
    return out


def _on_rank0(mesh: Optional[Mesh], write) -> None:
    """``write()`` on world rank 0 of ``mesh`` while the other ranks wait
    at a barrier (one process: just ``write()``)."""
    mesh = live_mesh(mesh)
    if mesh is None:
        write()
        return
    if mesh.world_group.rank == 0:
        write()
    distributed.barrier(mesh.world_group)


def save_lora(path: str, lora: Params, cfg: TrainConfig,
              mesh: Optional[Mesh] = None) -> None:
    """Write the adapters as .safetensors (``.npz`` when the path says so),
    readable by ``models.lora.load_lora_weights`` and by diffusers/peft.
    Under ``mesh`` (whole adapters on every rank) world rank 0 writes."""
    def write():
        sd = export_lora_state_dict(lora, cfg)
        if str(path).endswith(".npz"):
            np.savez(path, **sd)
        else:
            save_safetensors(path, sd)

    _on_rank0(mesh, write)


def save_train_state(path: str, trainer: LoRATrainer) -> None:
    """``torch.save`` of the training state: adapters, AdamW moments, the
    sigma/noise generator and the step count (the frozen base is the serving
    checkpoint and is not saved). Under the trainer's mesh world rank 0
    writes it; the adapters and moments are whole, so the file restores
    into a world of any shape or into one process."""
    _on_rank0(trainer.mesh, lambda: torch.save(
        {"lora": [t.detach().cpu() for t in lora_leaves(trainer.lora)],
         "opt": trainer.opt.state_dict(),
         "rng": trainer._gen.get_state(),
         "step": trainer.steps}, path))


def restore_train_state(path: str, trainer: LoRATrainer) -> LoRATrainer:
    """Load a :func:`save_train_state` file into a trainer built on the same
    base and TrainConfig: bit-identical adapters, moments and generator
    (on every rank of a mesh, each reading the file)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    leaves = lora_leaves(trainer.lora)
    if len(leaves) != len(state["lora"]):
        raise ValueError(f"train state holds {len(state['lora'])} adapter "
                         f"tensors, the trainer {len(leaves)}")
    with torch.no_grad():
        for t, saved in zip(leaves, state["lora"]):
            t.copy_(saved)
    trainer.opt.load_state_dict(state["opt"])
    trainer._gen.set_state(state["rng"])
    trainer.steps = int(state["step"])
    return trainer


# ---------------------------------------------------------------------------
# CLI: overfit one synthetic edit pair
# ---------------------------------------------------------------------------


def _test_image(size: int, kind: str) -> np.ndarray:
    """The JAX package's gradient / circle fixtures, in numpy."""
    y = np.linspace(0, 1, size)[:, None]
    x = np.linspace(0, 1, size)[None, :]
    full = lambda a: np.broadcast_to(a, (size, size))
    if kind == "gradient":
        img = np.stack([100 + 100 * full(y), 100 + 100 * full(x),
                        np.full((size, size), 150.0)], axis=-1)
    else:
        img = np.stack([255 * full(y), 255 * full(x),
                        np.full((size, size), 128.0)], axis=-1)
        yy = (np.arange(size)[:, None] - size / 2) ** 2
        xx = (np.arange(size)[None, :] - size / 2) ** 2
        img[yy + xx < (size / 5) ** 2] = [255.0, 32.0, 32.0]
    return np.clip(img, 0, 255).astype(np.uint8)


def main(argv=None):
    import argparse
    import os
    import time

    from qwen_image_edit_streamdiffusion_tpu_torch.core.config import StreamConfig
    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.edit_pipeline import (
        EditPipeline,
    )

    ap = argparse.ArgumentParser(
        description="LoRA fine-tune demo: overfit one synthetic edit pair")
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=128,
                    help="image side (condition, target and output)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--save", default=None, help="write LoRA .safetensors")
    ap.add_argument("--state", default=None,
                    help="train-state file: resumed from if it exists, "
                    "saved to after the run")
    args = ap.parse_args(argv)

    area = args.size * args.size
    config = StreamConfig(model_preset=args.preset, width=args.size,
                          height=args.size, vae_image_area=area,
                          vl_image_area=area)
    pipe = EditPipeline.create(args.preset, config, seed=0, device=args.device)
    cfg = TrainConfig(rank=args.rank, alpha=float(args.rank),
                      learning_rate=args.lr)
    trainer = LoRATrainer.from_pipeline(pipe, cfg)
    if args.state and os.path.exists(args.state):
        trainer = restore_train_state(args.state, trainer)
        print(f"resumed from {args.state} at step {trainer.steps}")

    items = [{"image": _test_image(args.size, "gradient"),
              "prompt": "draw a circle",
              "target": _test_image(args.size, "circle")}
             for _ in range(args.batch)]
    batch = build_batch(pipe, items)
    losses = []
    for i in range(args.steps):
        t0 = time.time()
        losses.append(trainer.step(batch))
        print(f"step {i:3d}  loss {losses[-1]:.5f}  {time.time() - t0:.2f}s",
              flush=True)
    print(f"loss first→last: {losses[0]:.5f} → {losses[-1]:.5f}")
    if args.save:
        save_lora(args.save, trainer.lora, cfg)
        print(f"saved {args.save}")
    if args.state:
        save_train_state(args.state, trainer)
        print(f"train state → {args.state} (step {trainer.steps})")


if __name__ == "__main__":
    main()
