"""How far apart sound bf16 computations of phase tp_train's steps lie, and
how far wrong ones land, by the measures ``chip_smoke.py`` reads: each
adapter gradient's rel-L2 against the one-card step (the worst of them is
held to a limit), and all gradients' rel-L2 as one vector.

On one card (the flagship at full width and depth in bf16, the batch,
adapters and draws of phase tp_train: 1 row of 1024²), each step of
``chip_smoke.train_plan`` is taken from the same state as

- ``plain``, the reference, and ``again``, the same computation repeated;
- ``rows2`` / ``rows4`` / ``rows8``: each row-parallel sum of the MMDiT
  (``img_out``, ``txt_out``, ``fc2``) taken in 2, 4 or 8 parts, each part's
  product rounded to bf16, the parts summed in bf16, as a world of that many
  ranks rounds it (:class:`RowSumRounding`).

One LoRA step is also profiled, and its device seconds read both from the
raw Kineto events (``chip_smoke.device_events``) and from ``key_averages``.

Then a world of 2 ranks (mesh 1 × 2, gloo on the card, as phase tp_train)
takes the LoRA warm-up and the distill steps, each held to every one-card
computation above:

- ``tp``: as phase tp_train takes them;
- ``drop_copy`` (negative control): ``distributed.copy_to``, the backward
  all-reduce of the column-parallel inputs, made the identity;
- ``no_grad_reduce`` (negative control): the adapter gradients left
  unreduced over ``model``.

Run from the repository root on a machine with one card:

    python3 scripts/tp_train_tolerance.py

One JSON record a line; the first and last lines give the card and its
power limit.
"""

import gc
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

REF_PATH = os.path.join(ROOT, "build", "tp_train_tolerance", "refs.pt")
VARIANTS = ("again", "rows2", "rows4", "rows8", "plain")  # plain last: it advances
WORLD_STEPS = ("warmup", "unguided", "guided")
# the last step of each trainer may end on a control: nothing follows it
CONTROLS = {"warmup": ("tp", "drop_copy", "no_grad_reduce"), "unguided": ("tp",),
            "guided": ("tp", "drop_copy", "no_grad_reduce")}


class RowSumRounding:
    """One card rounding each row-parallel sum of the MMDiT as a world of
    ``parts`` ranks rounds it: the product over each rank's slice of the
    input features in the model dtype, the parts summed in it, then the bias
    (``row_linear`` under a model group of ``parts``, without its
    collective)."""

    def __init__(self, parts: int):
        self.parts = parts

    def __enter__(self):
        import torch.nn.functional as F

        from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm

        self.real = real = tfm.row_linear
        n = self.parts

        def row_linear(p, x, group=None):
            if group is not None and group.size > 1:
                return real(p, x, group)
            k = x.shape[-1] // n
            w = p["weight"]
            y = F.linear(x[..., :k], w[:, :k])
            for r in range(1, n):
                y = y + F.linear(x[..., r * k:(r + 1) * k], w[:, r * k:(r + 1) * k])
            b = p.get("bias")
            return y if b is None else y + b.to(y.dtype)

        tfm.row_linear = row_linear
        return self

    def __exit__(self, *exc):
        from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm

        tfm.row_linear = self.real


class Control:
    """A negative control of the world's step (module docstring), or none
    for ``tp``."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed

        self.saved = (distributed.copy_to, distributed.all_reduce)
        real = distributed.all_reduce
        if self.name == "drop_copy":
            distributed.copy_to = lambda t, group: t
        elif self.name == "no_grad_reduce":
            distributed.all_reduce = lambda t, group, op="sum", key="all_reduce": (
                t if key == "grad_reduce" else real(t, group, op, key))
        return self

    def __exit__(self, *exc):
        from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed

        distributed.copy_to, distributed.all_reduce = self.saved


def snapshot(trainer):
    """A trainer's adapters, optimizer moments, generator and step count."""
    import copy

    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    return ([t.detach().clone() for t in lt.lora_leaves(trainer.lora)],
            copy.deepcopy(trainer.opt.state_dict()), trainer._gen.get_state(), trainer.steps)


def restore(trainer, snap) -> None:
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    leaves, opt, rng, steps = snap
    with torch.no_grad():
        for t, saved in zip(lt.lora_leaves(trainer.lora), leaves):
            t.copy_(saved)
    trainer.opt.load_state_dict(opt)
    trainer._gen.set_state(rng)
    trainer.steps = steps


def host_grads(trainer) -> list:
    import torch

    return [g.detach().to(torch.bfloat16).cpu() for g in cs.step_grads(trainer)]


def reading(loss, grads, ref, names) -> dict:
    rec = cs.grade_grads(loss, grads, ref)
    return {k: rec[k] for k in ("loss_rel", "grad_rel_l2_max", "grad_rel_l2_median",
                                "grad_rel_l2_whole")} | {
        "worst": cs.worst_grads(grads, ref, names)}


def key_averages_sums(prof) -> dict:
    """{kernel name: (device seconds, calls)} from ``key_averages``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return {e.key: (e.self_device_time_total / 1e6, e.count)
            for e in prof.key_averages() if e.device_type == cuda}


def compare_readers(trainer, batch) -> dict:
    """One step under torch.profiler (the trainer restored after it), its
    device events read both ways."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    snap = snapshot(trainer)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.step(batch)
        torch.cuda.synchronize()
    restore(trainer, snap)
    t0 = time.time()
    raw, span = cs.device_events(prof)
    raw_s = time.time() - t0
    t0 = time.time()
    avg = key_averages_sums(prof)
    avg_s = time.time() - t0
    names = set(raw) | set(avg)
    diff = max(abs(raw.get(n, (0.0, 0))[0] - avg.get(n, (0.0, 0))[0]) for n in names)
    return {"raw_events_busy_s": sum(t for t, _ in raw.values()),
            "key_averages_busy_s": sum(t for t, _ in avg.values()),
            "raw_events_calls": sum(c for _, c in raw.values()),
            "key_averages_calls": sum(c for _, c in avg.values()),
            "kernel_names": [len(raw), len(avg)],
            "names_only_in_one": len(names ^ (set(raw) & set(avg))),
            "max_abs_diff_s_per_name": diff,
            "calls_equal_per_name": all(raw.get(n, (0, 0))[1] == avg.get(n, (0, 0))[1]
                                        for n in names),
            "span_s": span, "read_s": {"raw_events": raw_s, "key_averages": avg_s}}


def one_card() -> None:
    """The one-card computations of every step; those of WORLD_STEPS saved
    for the ranks."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    pipe = cs.create_pipeline("bf16")
    batch = lt.build_batch(pipe, cs.train_items(1, cs.TP_TRAIN_IMAGE))
    refs = {"batch": cs.host_batch(batch), "steps": {}}

    def hook(kind, name, trainer, batch):
        if name == "step0":
            cs.emit({"phase": "profile_readers", "step": name, **compare_readers(trainer, batch)})
        snap = snapshot(trainer)
        runs = {}
        for v in VARIANTS:
            if v != VARIANTS[0]:
                restore(trainer, snap)
            t0 = time.time()
            if v.startswith("rows"):
                with RowSumRounding(int(v[4:])):
                    loss = trainer.step(batch)
            else:
                loss = trainer.step(batch)
            runs[v] = {"loss": loss, "grads": host_grads(trainer)}
            cs.emit({"phase": "one_card_step", "step": name, "variant": v, "loss": loss,
                     "seconds": time.time() - t0})
        del snap
        names = cs.leaf_names(trainer.lora)
        order = ("plain",) + VARIANTS[:-1]
        for i, a in enumerate(order):
            for b in order[i + 1:]:
                cs.emit({"phase": "sound_pair", "step": name, "kind": kind, "pair": [b, a],
                         **reading(runs[b]["loss"], runs[b]["grads"], runs[a], names)})
        if name in WORLD_STEPS:
            refs["steps"][name] = runs

    cs.train_plan(pipe, batch, hook)
    os.makedirs(os.path.dirname(REF_PATH), exist_ok=True)
    torch.save(refs, REF_PATH)
    del pipe, batch, refs
    gc.collect()
    torch.cuda.empty_cache()


def rank_tolerance(mesh, _refs) -> dict:
    """The world's steps (module docstring) on one rank, each under each of
    its CONTROLS from the same state, held to every one-card computation."""
    import dataclasses

    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels
    from qwen_image_edit_streamdiffusion_tpu_torch.training import distill as dt
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    label = f"tolerance rank{mesh.world_group.rank}"
    config = cs.tp_config(model_axis=2).replace(model_preset="qwen-image-edit-2509")
    pipe = cs.rank_create(label, "qwen-image-edit-2509", config, mesh)
    saved = torch.load(REF_PATH, map_location="cpu", weights_only=True, mmap=True)
    batch = {k: v.to(cs.RANK_DEVICE) if torch.is_tensor(v) else v
             for k, v in saved["batch"].items()}

    def run(kind, name, trainer):
        names = cs.leaf_names(trainer.lora)
        snap = snapshot(trainer)
        for i, control in enumerate(CONTROLS[name]):
            if i:
                restore(trainer, snap)
            t0 = time.time()
            with Control(control):
                loss = trainer.step(batch)
            torch.cuda.synchronize()
            grads = [g.detach().float().cpu() for g in cs.step_grads(trainer)]
            for v, ref in saved["steps"][name].items():
                cs.emit({"phase": "world_step", "path": label, "step": name, "kind": kind,
                         "control": control, "against": v, "seconds": time.time() - t0,
                         **reading(loss, grads, ref, names)})

    cfg = lt.TrainConfig(rank=cs.TRAIN_RANK, alpha=16.0, remat=True)
    trainer = lt.LoRATrainer.from_pipeline(pipe, cfg)
    cs.seeded_b(trainer)
    run("lora", "warmup", trainer)
    del trainer
    gc.collect()
    dcfg = dt.DistillConfig(train=cfg, student_steps=cs.STEPS)
    trainer = dt.DistillTrainer.from_pipeline(pipe, dcfg)
    cs.seeded_b(trainer)
    run("distill", "unguided", trainer)
    trainer.dcfg = dataclasses.replace(dcfg, teacher_cfg_scale=cs.CFG_SCALE)
    run("distill", "guided", trainer)
    return dict(kernels.LAUNCHES)


cs.RANK_PHASES["tolerance"] = rank_tolerance
cs.WORLD_SHAPES["tolerance"] = (1, 2)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tp_train_tolerance: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

    kernels.library()
    t0 = time.time()
    one_card()
    cs.emit({"phase": "one_card", "seconds": time.time() - t0})
    t0 = time.time()
    cs.run_world("tolerance", 2, {})
    cs.emit({"phase": "world", "seconds": time.time() - t0})
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
