"""Progressive step distillation: train a few-step, Lightning-style LoRA.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/training/distill.py``:
progressive distillation (Salimans & Ho 2022) adapted to flow matching. A
frozen teacher (the base model) integrates two Euler half-steps across an
interval of the student's few-step serving schedule, and a LoRA student
learns the one velocity that lands at the same end point:

    x_t at σ_i of the student's own ``make_schedule`` grid (the serving
    sigmas, with the resolution-dependent shift and the terminal stretch)
    teacher: x_m = x_t + (σ_m − σ_i)·v(x_t);  x_e = x_m + (σ_e − σ_m)·v(x_m)
    target:  v* = (x_e − x_t) / (σ_e − σ_i)          (no gradient)
    loss:    mean((v_student(x_t, σ_i) − v*)²)

- **The teacher** runs its forwards under ``torch.no_grad`` (not inference
  mode: the student reuses x_t, and an inference tensor saved for backward
  raises), so with ``use_flash`` its attention is K1 and it keeps no
  activations. Eager PyTorch runs it before the student, so the JAX
  package's scheduling barrier has no counterpart.
- **The student** is the LoRA train step (``training/lora_train.py``): the
  adapters merged per block inside the checkpointed block, K7 forward and
  K8/K9 backward, the global-norm clip and AdamW.
- **Guided distillation** (``teacher_cfg_scale > 1``): the teacher velocity
  is the norm-rescaled CFG combination g = v_neg + s·(v − v_neg), scaled by
  ‖v‖ / max(‖g‖, 1e-6) along the channels in f32, read from the
  ``neg_txt`` / ``neg_mask`` rows of :func:`~.lora_train.build_batch` (the
  positive rows again when the batch has none), so the student serves
  CFG-free.

- **Under a (cfg × model) mesh** the step is the LoRA step's
  (``lora_train.py``): the rows split over ``cfg`` where they divide, the
  teacher's forwards run the serving tensor-parallel path under
  ``no_grad`` (K1 at the rank's heads), its guidance is combined on whole
  velocities (the head's output is whole on every rank after the
  row-parallel sums), and the adapter gradients are reduced over the world
  before the clip. The intervals and ε are drawn for the whole batch on
  every rank.

The artifact is an ordinary LoRA file (``save_lora``), served with
``EditPipeline.from_weights(..., lora_path=...)`` at
``num_inference_steps = student_steps``. The intervals and ε come from the
trainer's named CPU generator (``core/rng.py``), not ``jax.random``.

CLI (one synthetic edit pair, a few steps)::

    python -m qwen_image_edit_streamdiffusion_tpu_torch.training.distill \\
        --preset tiny --device cpu
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from qwen_image_edit_streamdiffusion_tpu_torch.core.config import (
    ModelConfig,
    SchedulerConfig,
)
from qwen_image_edit_streamdiffusion_tpu_torch.core.meshes import SINGLE, Group, Mesh
from qwen_image_edit_streamdiffusion_tpu_torch.models import scheduler as sched
from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm
from qwen_image_edit_streamdiffusion_tpu_torch.training.lora_train import (
    LoRATrainer,
    Params,
    TrainConfig,
    apply_update,
    group_rows,
    live_mesh,
    lora_leaves,
    merge_block,
    reduce_grads,
)


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """Progressive-distillation hyperparameters on top of TrainConfig."""

    train: TrainConfig = TrainConfig()
    student_steps: int = 2  # the serving step count being distilled
    # teacher CFG: 0 or 1 disables; > 1 reads the batch's neg_txt / neg_mask
    teacher_cfg_scale: float = 0.0

    @property
    def guided(self) -> bool:
        return bool(self.teacher_cfg_scale) and self.teacher_cfg_scale > 1.0


def _model_v(params: Params, model_cfg: ModelConfig, x_t: torch.Tensor,
             cond: torch.Tensor, txt: torch.Tensor, txt_mask: torch.Tensor,
             t: torch.Tensor, ropes: tfm.RopeTables, use_flash: bool,
             remat: bool = False, lora_blocks=None, scale: float = 1.0,
             tp: Group = SINGLE) -> torch.Tensor:
    """Velocity on the target tokens in f32; the condition tokens ride
    along and their predictions are dropped, as in the serving forward.
    ``tp``: the model group whose slices ``params`` holds."""
    l_img = x_t.shape[1]
    inp = torch.cat([x_t, cond.to(x_t.dtype)], dim=1)
    kw: Dict[str, Any] = {}
    if lora_blocks is not None:
        kw = dict(blocks_extra=lora_blocks,
                  block_map=lambda blk, lb: merge_block(blk, lb, scale, tp))
    v = tfm.forward(params, model_cfg, inp, txt, t, ropes, txt_mask=txt_mask,
                    use_flash=use_flash, remat=remat, tp=tp, **kw)
    return v[:, :l_img].float()


def teacher_velocity(base: Params, model_cfg: ModelConfig, dcfg: DistillConfig,
                     x_t, cond, txt, txt_mask, neg_txt, neg_mask, t, ropes,
                     use_flash: bool, tp: Group = SINGLE) -> torch.Tensor:
    """The frozen teacher's velocity (f32): plain, or guided by the negative
    rows and norm-rescaled (the norm floored at 1e-6), on whole velocities."""
    v = _model_v(base, model_cfg, x_t, cond, txt, txt_mask, t, ropes, use_flash,
                 tp=tp)
    if not dcfg.guided:
        return v
    v_neg = _model_v(base, model_cfg, x_t, cond, neg_txt, neg_mask, t, ropes,
                     use_flash, tp=tp)
    g = v_neg + dcfg.teacher_cfg_scale * (v - v_neg)
    norm_v = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    norm_g = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    return g * (norm_v / norm_g.clamp_min(1e-6))


def distill_target(base: Params, model_cfg: ModelConfig, dcfg: DistillConfig,
                   x0, cond, txt, txt_mask, neg_txt, neg_mask,
                   sig_t: torch.Tensor, sig_e: torch.Tensor, eps: torch.Tensor,
                   ropes: tfm.RopeTables, num_train_timesteps: int,
                   use_flash: bool = False, tp: Group = SINGLE
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_t in the model dtype, v* in f32) for per-row interval ends σ_i =
    ``sig_t`` → σ_e = ``sig_e`` (B,) and noise ``eps``: the teacher's two
    Euler half-steps, gradient-free."""
    with torch.no_grad():
        s_t = sig_t.float()[:, None, None]
        s_e = sig_e.float()[:, None, None]
        s_m = 0.5 * (s_t + s_e)
        x_t = (1.0 - s_t) * x0.float() + s_t * eps.float()
        mdt = getattr(torch, model_cfg.dtype)
        teacher = lambda x, s: teacher_velocity(
            base, model_cfg, dcfg, x.to(mdt), cond, txt, txt_mask, neg_txt,
            neg_mask, s[:, 0, 0] * num_train_timesteps, ropes, use_flash, tp)
        x_m = x_t + (s_m - s_t) * teacher(x_t, s_t)
        x_e = x_m + (s_e - s_m) * teacher(x_m, s_m)
        return x_t.to(mdt), (x_e - x_t) / (s_e - s_t)


def distill_loss(base: Params, lora: Params, scale: float,
                 model_cfg: ModelConfig, dcfg: DistillConfig,
                 x0, cond, txt, txt_mask, neg_txt, neg_mask,
                 sig_t: torch.Tensor, sig_e: torch.Tensor, eps: torch.Tensor,
                 ropes: tfm.RopeTables, num_train_timesteps: int = 1000,
                 use_flash: bool = False, remat: bool = True, tp: Group = SINGLE
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, v*): the student's squared error against the teacher's
    two-half-step velocity at (x_t, σ_i); differentiable in ``lora``."""
    x_t, v_star = distill_target(base, model_cfg, dcfg, x0, cond, txt, txt_mask,
                                 neg_txt, neg_mask, sig_t, sig_e, eps, ropes,
                                 num_train_timesteps, use_flash, tp)
    v_s = _model_v(base, model_cfg, x_t, cond, txt, txt_mask,
                   sig_t.float() * num_train_timesteps, ropes, use_flash,
                   remat=remat, lora_blocks=lora["blocks"], scale=scale, tp=tp)
    return torch.mean(torch.square(v_s - v_star)), v_star


def build_distill_step(model_cfg: ModelConfig, sched_cfg: SchedulerConfig,
                       dcfg: DistillConfig, optimizer: torch.optim.Optimizer,
                       img_shapes: Tuple[Tuple[int, int, int], ...],
                       txt_len: int, device, use_flash: bool = False,
                       mesh: Optional[Mesh] = None):
    """The distillation step of one geometry bucket:

    step(base, lora, x0, cond, txt, txt_mask, neg_txt, neg_mask, intervals,
         eps) -> loss

    ``intervals`` (B,) int: each row's interval of the student schedule;
    ``eps`` the noise of x_t. Loss and adapter gradients, then the LoRA
    step's clip and optimizer update. ``neg_txt`` / ``neg_mask`` are read
    only when ``dcfg`` is guided. Under ``mesh`` the arguments are the
    whole batch, as in ``lora_train.build_step``."""
    cfg = dcfg.train
    mesh = live_mesh(mesh)
    tp = mesh.model_group if mesh is not None else SINGLE
    ropes = tfm.make_rope(model_cfg, img_shapes, txt_len, device)
    scale = cfg.alpha / cfg.rank
    f, h0, w0 = img_shapes[0]
    sigmas = sched.make_schedule(dcfg.student_steps, f * h0 * w0, sched_cfg).sigmas

    def step(base, lora, x0, cond, txt, txt_mask, neg_txt, neg_mask,
             intervals, eps):
        leaves = lora_leaves(lora)
        optimizer.zero_grad(set_to_none=True)
        i = torch.as_tensor(intervals, dtype=torch.long).cpu()
        x0, cond, txt, txt_mask, neg_txt, neg_mask, i, eps = group_rows(
            mesh, x0, cond, txt, txt_mask, neg_txt, neg_mask, i, eps)
        loss, _ = distill_loss(
            base, lora, scale, model_cfg, dcfg, x0, cond, txt, txt_mask,
            neg_txt, neg_mask, sigmas[i].to(device), sigmas[i + 1].to(device),
            eps.to(device), ropes, sched_cfg.num_train_timesteps,
            use_flash=use_flash, remat=cfg.remat, tp=tp)
        loss.backward()
        loss = reduce_grads(mesh, lora, leaves, loss)
        apply_update(optimizer, leaves, cfg.grad_clip)
        return loss.detach()

    return step


class DistillTrainer(LoRATrainer):
    """A :class:`~.lora_train.LoRATrainer` whose step optimizes the
    progressive-distillation objective: the same adapters, optimizer,
    export and train-state files. ``dcfg`` is read at every step (the step
    functions are cached per geometry bucket and ``dcfg``), so a caller may
    switch e.g. ``teacher_cfg_scale`` between steps."""

    def __init__(self, base_params: Params, model_cfg: ModelConfig,
                 sched_cfg: SchedulerConfig, dcfg: DistillConfig,
                 use_flash: bool = False, mesh: Optional[Mesh] = None):
        super().__init__(base_params, model_cfg, sched_cfg, dcfg.train,
                         use_flash=use_flash, mesh=mesh)
        self.dcfg = dcfg

    @classmethod
    def from_pipeline(cls, pipe, dcfg: DistillConfig) -> "DistillTrainer":
        return cls(pipe.tfm_params, pipe.preset.model, pipe.preset.scheduler,
                   dcfg, use_flash=pipe.config.use_flash_attention,
                   mesh=getattr(pipe, "mesh", None))

    def _step_fn(self, img_shapes, txt_len: int):
        key = (img_shapes, txt_len, self.dcfg)
        if key not in self._steps:
            self._steps[key] = build_distill_step(
                self.model_cfg, self.sched_cfg, self.dcfg, self.opt,
                img_shapes, txt_len, self.device, self.use_flash, self.mesh)
        return self._steps[key]

    def draw(self, batch: Dict[str, Any]):
        """(intervals, eps) of the next step from the trainer's generator."""
        x0 = batch["x0_tokens"]
        intervals = torch.randint(0, self.dcfg.student_steps, (x0.shape[0],),
                                  generator=self._gen)
        eps = torch.randn(tuple(x0.shape), generator=self._gen,
                          dtype=torch.float32)
        return intervals, eps

    def step(self, batch: Dict[str, Any],
             intervals: Optional[torch.Tensor] = None,
             eps: Optional[torch.Tensor] = None) -> float:
        """One optimizer step on a :func:`~.lora_train.build_batch` dict;
        intervals and ε are drawn from the trainer's generator unless given.
        Returns the loss (a host sync)."""
        if intervals is None or eps is None:
            intervals, eps = self.draw(batch)
        fn = self._step_fn(tuple(batch["img_shapes"]), int(batch["txt"].shape[1]))
        loss = fn(self.base_params, self.lora, batch["x0_tokens"],
                  batch["cond_tokens"], batch["txt"], batch["txt_mask"],
                  batch.get("neg_txt", batch["txt"]),
                  batch.get("neg_mask", batch["txt_mask"]), intervals, eps)
        self.steps += 1
        return float(loss)


def main(argv=None):
    import argparse
    import time

    from qwen_image_edit_streamdiffusion_tpu_torch.core.config import StreamConfig
    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.edit_pipeline import (
        EditPipeline,
    )
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    ap = argparse.ArgumentParser(
        description="Distill a few-step Lightning-style LoRA from the base "
                    "model (progressive distillation demo)")
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=128,
                    help="image side (condition, target and output)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--student-steps", type=int, default=2)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--cfg-scale", type=float, default=0.0,
                    help=">1 distills norm-rescaled teacher guidance (negative "
                    "prompt \"\") into the student, which serves CFG-free")
    ap.add_argument("--save", default=None, help="write LoRA .safetensors")
    args = ap.parse_args(argv)

    area = args.size * args.size
    config = StreamConfig(model_preset=args.preset, width=args.size,
                          height=args.size, vae_image_area=area,
                          vl_image_area=area)
    pipe = EditPipeline.create(args.preset, config, seed=0, device=args.device)
    dcfg = DistillConfig(
        train=TrainConfig(rank=args.rank, alpha=float(args.rank),
                          learning_rate=args.lr),
        student_steps=args.student_steps, teacher_cfg_scale=args.cfg_scale)
    trainer = DistillTrainer.from_pipeline(pipe, dcfg)
    items = []
    for _ in range(args.batch):
        it = {"image": lt._test_image(args.size, "gradient"),
              "prompt": "draw a circle",
              "target": lt._test_image(args.size, "circle")}
        if dcfg.guided:
            it["negative_prompt"] = ""
        items.append(it)
    batch = lt.build_batch(pipe, items)
    losses = []
    for i in range(args.steps):
        t0 = time.time()
        losses.append(trainer.step(batch))
        print(f"step {i:3d}  loss {losses[-1]:.5f}  {time.time() - t0:.2f}s",
              flush=True)
    print(f"loss first→last: {losses[0]:.5f} → {losses[-1]:.5f}")
    if args.save:
        lt.save_lora(args.save, trainer.lora, dcfg.train)
        print(f"saved {args.save} — serve with num_inference_steps="
              f"{args.student_steps}")


if __name__ == "__main__":
    main()
