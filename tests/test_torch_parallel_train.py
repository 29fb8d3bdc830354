"""The port's multi-rank training and streaming in spawned ``gloo`` worlds on
the CPU, against the JAX package and against the port's own one-process
runs.

One world of 2 ranks (mesh 1 × 2) and one of 4 (mesh 2 × 2) are spawned per
module at `tiny` in f32, each running all its scenarios in one go while the
parent computes the references; each test reads its part of the ranks'
records. The ranks import the port alone (JAX is imported only inside the
parent's functions).

- (a) the LoRA step (``LoRATrainer``, remat, attention and MLP targets,
  every adapter with ``b`` non-zero): TP 2, and on 2 × 2 with its 2 rows
  split over ``cfg`` and with 1 row that every cfg group runs: the loss and
  every reduced adapter gradient against ``jax.value_and_grad`` of the JAX
  ``flow_match_loss`` on the JAX mesh of the same shape, and against the
  port's one-process step (loss within 1e-5 relative, each gradient within
  1e-4 of its tensor's largest element: ``tests/test_torch_lora.py``'s
  limits);
- (b) the distill step (``DistillTrainer``), unguided and guided, on TP 2
  and on 2 × 2 with its 2 rows (their intervals and ε) split over ``cfg``:
  the loss and every reduced adapter gradient against the jitted JAX
  ``build_distill_step`` on the JAX mesh of the same shape (its key's draws
  rebuilt and injected into the port, its optimizer keeping the gradients
  as its state), and against the port's one-process step, with the same
  limits;
- (c) the adapters bit-identical on every rank after two steps, and the
  second step held to one process's too;
- (d) a train state saved by the world restores into one process, and one
  saved by one process restores into the world, bit for bit;
- (e) ``train_loop`` on an ``EditPipeline`` built under the mesh, resumed
  from its state file, equals the unbroken run;
- (f) negative controls, each failing the limits: the backward all-reduce
  of the column-parallel inputs dropped; a whole leaf's gradient summed
  over ``model`` (instead of taken once); the gradients summed over ``cfg``
  (instead of averaged);
- (g) the realtime stream on the mesh (keyframe, temporal frames submitted
  pipelined, a guided session, two sessions as one batched dispatch)
  against the JAX stream with the JAX draws injected (atol 2e-4, rtol
  1e-3);
- (h) the engine's stream sessions over a ``LockstepPipeline``: rank 0 with
  the similarity filter (its skips never reach rank 1), pipelined and
  sequential frames, against the one-process engine; then the server's
  websocket ``/stream`` on rank 0 while rank 1 follows, against the
  one-process server, and the closed socket's session ended on both ranks.
"""

import dataclasses
import json
import os
import tempfile
import threading
import time
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from qwen_image_edit_streamdiffusion_tpu_torch.core.config import StreamConfig, get_preset

SIZE = 64
RANK = 4
TARGETS = ("attn.to_q", "attn.to_k", "attn.to_v", "attn.to_out.0",
           "attn.add_q_proj", "attn.add_k_proj", "attn.add_v_proj", "attn.to_add_out",
           "img_mlp.net.0.proj", "img_mlp.net.2", "txt_mlp.net.0.proj", "txt_mlp.net.2")
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
ATOL, RTOL = 2e-4, 1e-3
CFG_SCALE = 4.0
PROMPT = "oil painting style"
NEG = "blurry"
WORLD_TIMEOUT = 300  # seconds a world may take, spawn to last record
STUDENT_STEPS = 2
DISTILL_KEY = 11  # its draws take both intervals of the 2-step schedule


def _preset_f32():
    p = get_preset("tiny")
    return dataclasses.replace(p, model=dataclasses.replace(p.model, dtype="float32"),
                               vl=dataclasses.replace(p.vl, dtype="float32"))


def _tcfg():
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    return lt.TrainConfig(rank=RANK, alpha=8.0, targets=TARGETS, remat=True,
                          grad_clip=0.0, learning_rate=1e-3)


def _dcfg(guided: bool):
    from qwen_image_edit_streamdiffusion_tpu_torch.training import distill as dt

    return dt.DistillConfig(train=_tcfg(), student_steps=STUDENT_STEPS,
                            teacher_cfg_scale=CFG_SCALE if guided else 0.0)


def _batch(rows: int, seed: int = 5):
    """A train batch of ``rows`` rows: 16 target and 16 condition tokens, 8
    text tokens (the last row's mask shorter), a different negative text."""
    cfg = _preset_f32().model
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((rows, 16, cfg.in_channels)).astype(np.float32)
    cond = rng.standard_normal((rows, 16, cfg.in_channels)).astype(np.float32)
    txt = rng.standard_normal((rows, 8, cfg.joint_dim)).astype(np.float32)
    mask = np.ones((rows, 8), bool)
    mask[-1, 5:] = False
    neg = rng.standard_normal(txt.shape).astype(np.float32)
    neg_mask = np.ones((rows, 8), bool)
    neg_mask[0, 6:] = False
    return {"x0_tokens": x0, "cond_tokens": cond, "txt": txt, "txt_mask": mask,
            "neg_txt": neg, "neg_mask": neg_mask,
            "img_shapes": ((1, 4, 4), (1, 4, 4))}


def _draws(rows: int, seed: int):
    """Per-row sigmas, noise, distill intervals and ε of one step (a
    distill step in a payload takes the JAX step's draws instead:
    :func:`_jax_distill_draws`)."""
    rng = np.random.default_rng(100 + seed)
    cfg = _preset_f32().model
    shape = (rows, 16, cfg.in_channels)
    return {"sigmas": rng.uniform(0.1, 0.9, rows).astype(np.float32),
            "noise": rng.standard_normal(shape).astype(np.float32),
            "intervals": rng.integers(0, 2, rows), "eps": rng.standard_normal(shape).astype(
                np.float32)}


def _tensors(batch):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Rank side (and the parent's one-process runs): the port only
# ---------------------------------------------------------------------------


def _trainer(payload, mesh, kind: str = "lora", guided: bool = False):
    """A trainer on the bridged `tiny` base (this rank's slices under
    ``mesh``) whose adapters are the payload's whole adapters."""
    from qwen_image_edit_streamdiffusion_tpu_torch.models.convert import (
        from_jax,
        lora_from_jax,
    )
    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import sharding
    from qwen_image_edit_streamdiffusion_tpu_torch.training import distill as dt
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    preset = _preset_f32()
    base = from_jax(payload["tfm"], preset.model)
    adapters = lt.lora_leaves(lora_from_jax(payload["lora"], base, _tcfg()))
    if mesh is not None:
        base = sharding.shard_transformer_params(base, mesh)
    if kind == "lora":
        trainer = lt.LoRATrainer(base, preset.model, preset.scheduler, _tcfg(), mesh=mesh)
    else:
        trainer = dt.DistillTrainer(base, preset.model, preset.scheduler, _dcfg(guided),
                                    mesh=mesh)
    with torch.no_grad():
        for t, want in zip(lt.lora_leaves(trainer.lora), adapters):
            t.copy_(want)
    return trainer


def _step(trainer, kind: str, rows: int, seed: int, draws=None):
    """One step on the batch of ``rows`` with ``draws``, by default those of
    ``seed``: (loss, the reduced gradients, the adapters after the
    update)."""
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    batch, d = _tensors(_batch(rows)), draws or _draws(rows, seed)
    if kind == "lora":
        loss = trainer.step(batch, torch.from_numpy(d["sigmas"]), torch.from_numpy(d["noise"]))
    else:
        loss = trainer.step(batch, torch.from_numpy(d["intervals"]), torch.from_numpy(d["eps"]))
    leaves = lt.lora_leaves(trainer.lora)
    return (loss, [p.grad.detach().clone().numpy() for p in leaves],
            [p.detach().clone().numpy() for p in leaves])


def _case(payload, mesh, kind="lora", rows=2, guided=False, steps=1):
    """``steps`` steps of a fresh trainer; a distill step on the payload's
    JAX draws for its rows."""
    trainer = _trainer(payload, mesh, kind, guided)
    draws = payload["distill_draws"][rows] if kind == "distill" else None
    return [_step(trainer, kind, rows, s, draws) for s in range(steps)], trainer


def _train_world(mesh, payload, cases):
    """Every named case (kind, rows, guided, steps) on this rank."""
    return {name: _case(payload, mesh, *args)[0] for name, args in cases.items()}


def _drop_copy(mesh, payload):
    """The LoRA step with ``copy_to`` (the backward all-reduce of the
    column-parallel inputs) replaced by the identity."""
    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed

    real = distributed.copy_to
    distributed.copy_to = lambda t, group: t
    try:
        return _case(payload, mesh)[0]
    finally:
        distributed.copy_to = real


def _sum_over_cfg(mesh, payload, rows):
    """The LoRA step with the gradients and loss summed over ``cfg``."""
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    real = lt.reduce_grads

    def summed(mesh, lora, leaves, loss):
        loss = real(mesh, lora, leaves, loss)
        for p in leaves:
            p.grad.mul_(mesh.cfg)
        return loss * mesh.cfg

    lt.reduce_grads = summed
    try:
        return _case(payload, mesh, rows=rows)[0]
    finally:
        lt.reduce_grads = real


def _whole_leaf(mesh):
    """``reduce_grads`` on an adapter whose base leaf is whole at this model
    size (5 output features do not split over 2 ranks): every rank holds the
    same gradient, which the reduction takes once; with the leaf read as
    sharded it is summed over ``model``."""
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    def run():
        gen = torch.Generator().manual_seed(0)
        a = torch.randn(6, 2, generator=gen).requires_grad_()
        b = torch.randn(2, 5, generator=gen).requires_grad_()
        lora = {"blocks": [{"attn": {"img_q": {"a": a, "b": b}}}]}
        a.grad, b.grad = torch.randn(6, 2, generator=gen), torch.randn(2, 5, generator=gen)
        want = [a.grad.clone().numpy(), b.grad.clone().numpy()]
        loss = lt.reduce_grads(mesh, lora, [a, b], torch.tensor(0.5))
        return {"want": want, "got": [a.grad.numpy(), b.grad.numpy()], "loss": float(loss),
                "spec": lt.adapter_spec(("attn", "img_q"), 6, 5, mesh.model_group)}

    out = {"whole": run()}
    real = lt.adapter_spec
    lt.adapter_spec = lambda path, d_in, d_out, tp: (0, ("model",))
    try:
        out["summed"] = run()
    finally:
        lt.adapter_spec = real
    return out


def _states(mesh, payload):
    """Two LoRA steps, then the world's state file (world rank 0 writes it);
    then a fresh world trainer restored from the one-process state file of
    step 1, and its step 2."""
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    steps, trainer = _case(payload, mesh, steps=2)
    lt.save_train_state(payload["world_state"], trainer)
    saved_here = os.path.isfile(payload["world_state"])
    back = lt.restore_train_state(payload["one_state"], _trainer(payload, mesh))
    restored = [p.detach().clone().numpy() for p in lt.lora_leaves(back.lora)]
    return {"adapters": steps[-1][2], "saved_here": saved_here, "restored": restored,
            "restored_steps": back.steps, "step2": _step(back, "lora", 2, 1)}


def _train_loop(mesh, payload):
    """``train_loop`` on a mesh-built `tiny` pipeline over the payload's
    manifest: to step 2 with a state file, a second trainer resumed to step
    3, the first continued to step 3."""
    import contextlib
    import io

    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.edit_pipeline import (
        EditPipeline,
    )
    from qwen_image_edit_streamdiffusion_tpu_torch.training import data
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    config = StreamConfig(width=SIZE, height=SIZE, vae_image_area=SIZE * SIZE,
                          vl_image_area=32 * 32, num_inference_steps=2, model_preset="tiny",
                          mesh_model_axis=mesh.model, mesh_cfg_axis=mesh.cfg)
    pipe = EditPipeline.create(_preset_f32(), config, seed=0, device="cpu", mesh=mesh)
    dataset = data.EditDataset.from_manifest(payload["manifest"])
    state = payload["loop_state"]
    loader = lambda: data.BatchLoader(pipe, dataset, 2, seed=1)  # noqa: E731
    cfg = lt.TrainConfig(rank=RANK, alpha=8.0, targets=TARGETS, learning_rate=1e-3)
    first, resumed = lt.LoRATrainer.from_pipeline(pipe, cfg), lt.LoRATrainer.from_pipeline(
        pipe, cfg)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        data.train_loop(first, loader(), 2, log_every=1, state_path=state, save_every=1)
        data.train_loop(resumed, loader(), 3, log_every=1, state_path=state)
        data.train_loop(first, loader(), 3)
    return {"printed": out.getvalue().splitlines(), "steps": [first.steps, resumed.steps],
            "equal": all(torch.equal(a, b) for a, b in zip(lt.lora_leaves(first.lora),
                                                           lt.lora_leaves(resumed.lora))),
            "adapters": [p.detach().numpy().copy() for p in lt.lora_leaves(first.lora)]}


def _stream_config(mesh_shape=(1, 1), **kw):
    base = dict(width=SIZE, height=SIZE, vae_image_area=SIZE * SIZE, vl_image_area=32 * 32,
                num_inference_steps=2, keyframe_interval=3, model_preset="tiny",
                cfg_mode="none", fuse_qkv=False, mesh_cfg_axis=mesh_shape[0],
                mesh_model_axis=mesh_shape[1])
    base.update(kw)
    return StreamConfig(**base)


def _stream_pipe(trees, mesh, mesh_shape=(1, 1), **kw):
    from qwen_image_edit_streamdiffusion_tpu_torch.models.convert import from_jax
    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.edit_pipeline import (
        EditPipeline,
    )

    preset = _preset_f32()
    return EditPipeline.from_weights(
        preset, _stream_config(mesh_shape, **kw), from_jax(trees[0], preset.model),
        from_jax(trees[1], preset.vae), from_jax(trees[2], preset.vl), device="cpu",
        mesh=mesh)


def stream_frames(n: int = 3):
    rng = np.random.default_rng(21)
    return [rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8) for _ in range(n)]


def _stream_world(mesh, payload):
    """(g): the stream driven alike on every rank, the JAX draws injected."""
    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import stream

    pipe = _stream_pipe(payload["trees"], mesh, (mesh.cfg, mesh.model))
    table = payload["noise"]

    def session(**kw):
        rt = stream.RealtimePipeline(pipe=dataclasses.replace(
            pipe, config=pipe.config.replace(**kw)))
        rt._frame_noise = lambda kind, shape, i: tuple(
            torch.from_numpy(a) for a in table[(kind, tuple(shape), i)])
        return rt

    f = stream_frames()
    out = {}
    rt = session()
    rt.precompute_conditions(PROMPT)
    h0 = rt.submit_frame(f[0])
    lat = [rt.prev_latent.numpy().copy()]
    h1 = rt.submit_frame(f[1])
    lat.append(rt.prev_latent.numpy().copy())
    rt._collect(h0)
    rt._collect(h1)
    out["pixels"] = rt.process_frame(f[2])
    lat.append(rt.prev_latent.numpy().copy())
    out["plain"] = lat

    guided = session(true_cfg_scale=CFG_SCALE)
    guided.precompute_conditions(PROMPT, negative_prompt=NEG)
    out["guided"] = []
    for fr in f[:2]:
        guided.process_frame(fr)
        out["guided"].append(guided.prev_latent.numpy().copy())

    a, b = session(), session()
    a.precompute_conditions(PROMPT)
    b.precompute_conditions("watercolor")
    out["batched"] = []
    for fr in f[:2]:
        handles = stream.submit_frames_batched([a, b], [fr, f[2]])
        a._collect(handles[0])
        out["batched"].append([a.prev_latent.numpy().copy(), b.prev_latent.numpy().copy()])

    ssf = session(similarity_filter=True)
    ssf.precompute_conditions(PROMPT)
    out["ssf"] = []
    for fr in (f[0], f[0], f[1]):
        ssf.process_frame(fr)
        out["ssf"].append(ssf.prev_latent.numpy().copy())
    out["ssf_skipped"] = ssf.skipped_frames
    return out


def engine_requests():
    """(h)'s requests: a sequential session with the similarity filter on
    (repeated frames), then a pipelined one."""
    f = stream_frames()
    seq = [{"image": fr, "prompt": PROMPT, "stream_session": "seq", "raw_response": True}
           for fr in (f[0], f[0], f[0], f[1], f[1])]
    piped = [{"image": fr, "prompt": PROMPT, "stream_session": "piped",
              "stream_pipeline": True, "raw_response": True} for fr in f]
    return seq + piped


def run_engine(engine):
    out = []
    for req in engine_requests():
        resp = engine.edit(dict(req))
        out.append((resp["image"], resp["frame"], resp["keyframe"], resp.get("lag")))
    return out


def ws_exchange(host: str, port: int, frames, quality: int = 90):
    """One websocket session: a config, then each frame sent and its reply
    read; the socket closed. Returns [(meta, the frame the server encoded,
    its JPEG bytes)]."""
    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec
    from qwen_image_edit_streamdiffusion_tpu_torch.serving.ws import WSClient

    encoded = []
    real = codec.encode_jpeg
    codec.encode_jpeg = lambda arr, q=90: encoded.append(arr.copy()) or real(arr, q)
    c = WSClient(host, port)
    try:
        assert c.recv()["status"] == "ready"
        c.send_config(prompt=PROMPT, pipeline=False)
        assert c.recv()["status"] == "ok"
        out = []
        for fr in frames:
            c.send_image(fr, quality)
            meta, jpeg = c.recv()
            out.append((meta, encoded[-1], jpeg))
        return out
    finally:
        c.close()
        codec.encode_jpeg = real


def _engine(pipe, lockstep_group=None):
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime.engine import (
        InferenceEngine,
        LockstepPipeline,
    )

    if lockstep_group is not None:
        pipe = LockstepPipeline(pipe, lockstep_group)
    return InferenceEngine(pipeline=pipe, input_size=SIZE, default_steps=2)


def _engine_world(mesh, payload):
    """(h): rank 0 serves the engine's stream sessions, then the websocket;
    rank 1 follows, its mirrors reported."""
    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import engine as eng_mod
    from qwen_image_edit_streamdiffusion_tpu_torch.serving.server import make_server

    pipe = _stream_pipe(payload["trees"], mesh, (1, 2), similarity_filter=True)
    group = mesh.world_group
    if group.rank > 0:
        mirrors = []
        real = eng_mod._StreamMirror
        eng_mod._StreamMirror = lambda p: mirrors.append(real(p)) or mirrors[-1]
        try:
            calls = eng_mod.follow(pipe, group)
        finally:
            eng_mod._StreamMirror = real
        m = mirrors[0]
        return {"calls": calls, "sessions": sorted(m.sessions), "pending": len(m.pending),
                "dispatches": m.dispatches}
    engine = _engine(pipe, group)
    distributed.reset_stats()
    out = {"engine": run_engine(engine)}
    out["skipped"] = engine._sessions["seq"].skipped_frames
    for sid in ("seq", "piped"):
        engine.end_session(sid)
    srv = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        out["ws"] = ws_exchange("127.0.0.1", srv.server_address[1], stream_frames())
        deadline = time.time() + 60
        while any(k.startswith("ws-") for k in engine._sessions) and time.time() < deadline:
            time.sleep(0.05)
        out["sessions_after_close"] = sorted(engine._sessions)
    finally:
        srv.shutdown()
        srv.server_close()
        engine.pipeline.shutdown()
    out["broadcasts"] = distributed.STATS["broadcast"]
    return out


def _world2(mesh, payload):
    out = {"rank": mesh.world_group.rank}
    out["train"] = _train_world(mesh, payload, {
        "tp": ("lora", 2, False, 2), "distill": ("distill", 2, False, 1),
        "distill_guided": ("distill", 2, True, 1)})
    out["drop_copy"] = _drop_copy(mesh, payload)
    out["whole_leaf"] = _whole_leaf(mesh)
    out["states"] = _states(mesh, payload)
    out["train_loop"] = _train_loop(mesh, payload)
    out["stream"] = _stream_world(mesh, payload)
    out["engine"] = _engine_world(mesh, payload)  # last: it ends with a shutdown
    return out


WORLD4_CASES = {"split": ("lora", 2, False, 1), "replicated": ("lora", 1, False, 1),
                "distill_split": ("distill", 2, False, 1),
                "distill_guided_split": ("distill", 2, True, 1)}


def _world4(mesh, payload):
    out = {"rank": mesh.world_group.rank}
    out["train"] = _train_world(mesh, payload, WORLD4_CASES)
    out["sum_over_cfg"] = _sum_over_cfg(mesh, payload, 2)
    return out


SCENARIOS = {"world2": _world2, "world4": _world4}


def _rank_main(rank, world, init_file, queue, scenario, mesh_shape, payload):
    torch.set_num_threads(1)
    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed

    try:
        distributed.initialize("gloo", "cpu", init_method=f"file://{init_file}",
                               rank=rank, world_size=world)
        mesh = distributed.global_mesh(*mesh_shape)
        result = SCENARIOS[scenario](mesh, payload)
        import sys

        result["jax_loaded"] = [m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jaxlib", "optax")]
        queue.put((rank, result))
    except Exception:  # reported to the parent, which fails the test
        queue.put((rank, traceback.format_exc()))
    finally:
        distributed.shutdown()


class World:
    """A spawned world of ranks running one scenario; :meth:`results` waits
    for every rank's record."""

    def __init__(self, scenario, mesh_shape, payload):
        ctx = mp.get_context("spawn")
        self.queue = ctx.Queue()
        self.n = mesh_shape[0] * mesh_shape[1]
        fd, init_file = tempfile.mkstemp(prefix="qie_world_")
        os.close(fd)
        os.unlink(init_file)  # the FileStore creates it
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(r, self.n, init_file, self.queue, scenario,
                                        mesh_shape, payload))
                      for r in range(self.n)]
        for p in self.procs:
            p.start()

    def results(self):
        try:
            got = dict(self.queue.get(timeout=WORLD_TIMEOUT) for _ in range(self.n))
        finally:
            for p in self.procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
        errors = {r: v for r, v in got.items() if isinstance(v, str)}
        assert not errors, "\n".join(f"rank {r}:\n{v}" for r, v in errors.items())
        return [got[r] for r in range(self.n)]


# ---------------------------------------------------------------------------
# Parent side: the references
# ---------------------------------------------------------------------------


def _trees():
    import jax

    from qwen_image_edit_streamdiffusion_tpu.models import qwen_vl as jvl
    from qwen_image_edit_streamdiffusion_tpu.models import transformer as jtfm
    from qwen_image_edit_streamdiffusion_tpu.models import vae as jvae
    from qwen_image_edit_streamdiffusion_tpu.training import lora_train as jlt

    from test_torch_pipeline import _numpy_tree

    p = _preset_f32()
    trees = (_numpy_tree(jtfm.init, p.model, 0), _numpy_tree(jvae.init, p.vae, 1),
             _numpy_tree(jvl._init_all, p.vl, 2))
    jcfg = jlt.TrainConfig(rank=RANK, alpha=8.0, targets=TARGETS)
    rng = np.random.default_rng(3)
    lora = jax.tree_util.tree_map(
        lambda leaf: (rng.standard_normal(leaf.shape) * 0.02).astype(np.float32),
        jlt.init_lora(trees[0], jcfg, jax.random.PRNGKey(0)))
    return trees, lora


def _jax_grads(tfm_tree, lora_tree, rows: int, mesh_shape):
    """Loss and adapter gradients of the JAX ``flow_match_loss`` under
    ``jax.value_and_grad`` on the JAX (cfg × model) mesh over the forced
    host devices, the rows constrained over ``cfg`` where they divide, the
    draws of step 0; the gradients as the port's ``lora_leaves``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from qwen_image_edit_streamdiffusion_tpu.core.meshes import make_mesh
    from qwen_image_edit_streamdiffusion_tpu.models import transformer as jtfm
    from qwen_image_edit_streamdiffusion_tpu.training import lora_train as jlt
    from qwen_image_edit_streamdiffusion_tpu_torch.models.convert import (
        from_jax,
        lora_from_jax,
    )
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    cfg = _preset_f32().model
    mesh = make_mesh(*mesh_shape)
    b, d = _batch(rows), _draws(rows, 0)
    dp = mesh_shape[0] > 1 and rows % mesh_shape[0] == 0
    rows_of = lambda x: (jax.lax.with_sharding_constraint(  # noqa: E731
        x, NamedSharding(mesh, P("cfg"))) if dp else x)
    ropes = jtfm.make_rope(cfg, b["img_shapes"], 8)
    args = [jnp.asarray(b[k]) for k in ("x0_tokens", "cond_tokens", "txt", "txt_mask")]
    args += [jnp.asarray(d["sigmas"]), jnp.asarray(d["noise"])]

    def fn(lo, x0, cond, txt, mask, sigmas, noise):
        x0, cond, txt, mask, sigmas, noise = (rows_of(x) for x in (x0, cond, txt, mask,
                                                                   sigmas, noise))
        return jlt.flow_match_loss(tfm_tree, lo, 8.0 / RANK, cfg, x0, cond, txt, mask,
                                   sigmas, noise, ropes, mesh=mesh, remat=False)

    with mesh:
        v, g = jax.jit(jax.value_and_grad(fn))(
            jax.tree_util.tree_map(jnp.asarray, lora_tree), *args)
    base = from_jax(tfm_tree, cfg)
    grads = lt.lora_leaves(lora_from_jax(jax.tree_util.tree_map(np.asarray, g), base,
                                         _tcfg()))
    return float(v), [t.detach().numpy() for t in grads]


def _jax_distill_draws(rows: int) -> dict:
    """The intervals and ε that the JAX ``build_distill_step`` draws from
    ``PRNGKey(DISTILL_KEY)`` for ``rows`` rows (as it splits the key)."""
    import jax
    import jax.numpy as jnp

    k_i, k_eps = jax.random.split(jax.random.PRNGKey(DISTILL_KEY))
    shape = (rows, 16, _preset_f32().model.in_channels)
    return {"intervals": np.array(jax.random.randint(k_i, (rows,), 0, STUDENT_STEPS)),
            "eps": np.array(jax.random.normal(k_eps, shape, jnp.float32))}


def _jax_distill(tfm_tree, lora_tree, rows: int, mesh_shape, guided: bool):
    """Loss and adapter gradients of one jitted JAX ``build_distill_step``
    on the JAX (cfg × model) mesh, key ``DISTILL_KEY``: its optimizer
    returns zero updates and keeps the gradients as its state, which the
    step returns; the gradients as the port's ``lora_leaves``."""
    import jax
    import jax.numpy as jnp
    import optax

    from qwen_image_edit_streamdiffusion_tpu.core import config as jconfig
    from qwen_image_edit_streamdiffusion_tpu.core.meshes import make_mesh
    from qwen_image_edit_streamdiffusion_tpu.training import distill as jdt
    from qwen_image_edit_streamdiffusion_tpu.training import lora_train as jlt
    from qwen_image_edit_streamdiffusion_tpu_torch.models.convert import (
        from_jax,
        lora_from_jax,
    )
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    keep = optax.GradientTransformation(zeros, lambda g, state, params=None: (zeros(g), g))
    cfg = _preset_f32().model
    dcfg = jdt.DistillConfig(train=jlt.TrainConfig(rank=RANK, alpha=8.0, targets=TARGETS,
                                                   remat=False),
                             student_steps=STUDENT_STEPS,
                             teacher_cfg_scale=CFG_SCALE if guided else 0.0)
    b = _batch(rows)
    mesh = make_mesh(*mesh_shape)
    step = jdt.build_distill_step(cfg, jconfig.get_preset("tiny").scheduler, dcfg, keep,
                                  b["img_shapes"], 8, rows, mesh=mesh)
    lora = jax.tree_util.tree_map(jnp.asarray, lora_tree)
    args = [jnp.asarray(b[k]) for k in ("x0_tokens", "cond_tokens", "txt", "txt_mask",
                                         "neg_txt", "neg_mask")]
    with mesh:
        _, g, loss = jax.jit(step)(jax.tree_util.tree_map(jnp.asarray, tfm_tree), lora,
                                   keep.init(lora), *args, jax.random.PRNGKey(DISTILL_KEY))
    base = from_jax(tfm_tree, cfg)
    grads = lt.lora_leaves(lora_from_jax(jax.tree_util.tree_map(np.asarray, g), base,
                                         _tcfg()))
    return float(loss), [t.detach().numpy() for t in grads]


def _write_manifest(root):
    from qwen_image_edit_streamdiffusion_tpu_torch.core import imaging

    rng = np.random.default_rng(4)
    lines = []
    for i in range(3):
        for name in (f"in{i}.png", f"out{i}.png"):
            imaging.write_png(os.path.join(root, name),
                              rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8))
        item = {"image": f"in{i}.png", "target": f"out{i}.png", "prompt": f"edit {i}"}
        if i == 1:
            item["negative_prompt"] = "worse"
        lines.append(json.dumps(item))
    path = os.path.join(root, "manifest.jsonl")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _stream_noise(seed: int):
    """The JAX stream's draws for every (kind, shape, frame index) the
    world's sessions take."""
    from test_torch_stream import jax_frame_noise

    z = _preset_f32().vae.latent_channels
    noise = jax_frame_noise(seed)
    shape = (1, SIZE // 8, SIZE // 8, z)
    return {(kind, shape, i): tuple(t.numpy() for t in noise(kind, shape, i))
            for kind in ("key", "temporal") for i in range(3)}


def _jax_stream_refs(trees):
    """(g) on the JAX stream: the same sessions and frames."""
    from PIL import Image

    import test_torch_stream as tstr
    from qwen_image_edit_streamdiffusion_tpu.pipeline import stream as jstream

    jpipe, _ = tstr.build_stream_pair(f32=True)
    f = [Image.fromarray(x) for x in stream_frames()]
    refs = {}

    def session(**kw):
        rt = jstream.RealtimePipeline(pipe=dataclasses.replace(
            jpipe, config=jpipe.config.replace(**kw)))
        return rt

    rt = session()
    rt.precompute_conditions(PROMPT)
    lat = []
    for fr in f:
        rt.process_frame(fr)
        lat.append(np.asarray(rt.prev_latent, np.float32))
    refs["plain"] = lat
    g = session(true_cfg_scale=CFG_SCALE)
    g.precompute_conditions(PROMPT, negative_prompt=NEG)
    refs["guided"] = []
    for fr in f[:2]:
        g.process_frame(fr)
        refs["guided"].append(np.asarray(g.prev_latent, np.float32))
    a, b = session(), session()
    a.precompute_conditions(PROMPT)
    b.precompute_conditions("watercolor")
    refs["batched"] = []
    for fr in f[:2]:
        hs = jstream.submit_frames_batched([a, b], [fr, f[2]])
        a._collect(hs[0])
        refs["batched"].append([np.asarray(a.prev_latent, np.float32),
                                np.asarray(b.prev_latent, np.float32)])
    ssf = session(similarity_filter=True)
    ssf.precompute_conditions(PROMPT)
    refs["ssf"] = []
    for fr in (f[0], f[0], f[1]):
        ssf.process_frame(fr)
        refs["ssf"].append(np.asarray(ssf.prev_latent, np.float32))
    refs["ssf_skipped"] = ssf.skipped_frames
    return refs, trees_equal(jpipe, trees)


def trees_equal(jpipe, trees) -> bool:
    """The JAX stream pipeline holds the world's trees."""
    import jax

    a = jax.tree_util.tree_leaves(jpipe.tfm_params)
    b = jax.tree_util.tree_leaves(trees[0])
    return all(np.array_equal(np.asarray(x), y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_world"))
    trees, lora = _trees()
    payload = {"tfm": trees[0], "lora": lora, "trees": trees,
               "world_state": os.path.join(root, "world_state.pt"),
               "one_state": os.path.join(root, "one_state.pt"),
               "loop_state": os.path.join(root, "loop_state.pt"),
               "manifest": _write_manifest(root),
               "noise": _stream_noise(_stream_config().seed),
               "distill_draws": {2: _jax_distill_draws(2)}}
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    one = _trainer(payload, None)
    _step(one, "lora", 2, 0)
    lt.save_train_state(payload["one_state"], one)
    world = World("world2", (1, 2), payload)

    refs = {"jax_tp": _jax_grads(trees[0], lora, 2, (1, 2)),
            "jax_distill": _jax_distill(trees[0], lora, 2, (1, 2), False),
            "jax_distill_guided": _jax_distill(trees[0], lora, 2, (1, 2), True)}
    refs["one"] = _train_world(None, payload, {
        "tp": ("lora", 2, False, 2), "distill": ("distill", 2, False, 1),
        "distill_guided": ("distill", 2, True, 1)})
    refs["stream"], refs["stream_trees_equal"] = _jax_stream_refs(trees)
    pipe = _stream_pipe(trees, None, similarity_filter=True)
    engine = _engine(pipe)
    refs["engine"] = run_engine(engine)
    refs["skipped"] = engine._sessions["seq"].skipped_frames
    from qwen_image_edit_streamdiffusion_tpu_torch.serving.server import make_server

    srv = make_server(_engine(_stream_pipe(trees, None, similarity_filter=True)),
                      "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        refs["ws"] = ws_exchange("127.0.0.1", srv.server_address[1], stream_frames())
    finally:
        srv.shutdown()
        srv.server_close()
    return world.results(), refs, payload


@pytest.fixture(scope="module")
def world4():
    trees, lora = _trees()
    payload = {"tfm": trees[0], "lora": lora, "distill_draws": {2: _jax_distill_draws(2)}}
    world = World("world4", (2, 2), payload)
    refs = {"jax_split": _jax_grads(trees[0], lora, 2, (2, 2)),
            "jax_replicated": _jax_grads(trees[0], lora, 1, (2, 2)),
            "jax_distill_split": _jax_distill(trees[0], lora, 2, (2, 2), False),
            "jax_distill_guided_split": _jax_distill(trees[0], lora, 2, (2, 2), True)}
    refs["one"] = _train_world(None, payload, WORLD4_CASES)
    return world.results(), refs


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


def _held(loss, grads, want_loss, want_grads):
    """The limits of ``tests/test_torch_lora.py``: loss within 1e-5
    relative, each gradient within 1e-4 of its tensor's largest element."""
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss), (loss, want_loss)
    assert len(grads) == len(want_grads)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * max(np.abs(w).max(), 1e-12))


def test_ranks_import_no_jax(world2, world4):
    for rec in world2[0] + world4[0]:
        assert rec["jax_loaded"] == []


def test_tp_lora_step_matches_jax_and_one_process(world2):
    ranks, refs, _ = world2
    jloss, jgrads = refs["jax_tp"]
    for rec in ranks:
        loss, grads, _ = rec["train"]["tp"][0]
        _held(loss, grads, jloss, jgrads)
        _held(loss, grads, *refs["one"]["tp"][0][:2])
        # b drawn non-zero: every factor has a gradient but those of the
        # last block's text queries and text outputs, which nothing reads
        nonzero = [bool(np.abs(g).max() > 0) for g in grads]
        assert nonzero == [bool(np.abs(w).max() > 0) for w in jgrads]
        assert sum(nonzero) >= len(grads) - 8  # q, out, fc1, fc2: a and b


@pytest.mark.parametrize("rows,case", [(2, "split"), (1, "replicated")])
def test_mesh_lora_step_matches_jax_and_one_process(world4, rows, case):
    """2 × 2: the rows split over cfg (2 rows), or every cfg group running
    the one row; the same numbers on every rank."""
    ranks, refs = world4
    jloss, jgrads = refs[f"jax_{case}"]
    for rec in ranks:
        loss, grads, adapters = rec["train"][case][0]
        _held(loss, grads, jloss, jgrads)
        _held(loss, grads, *refs["one"][case][0][:2])
        for a, b in zip(adapters, ranks[0]["train"][case][0][2]):
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("case", ["distill", "distill_guided"])
def test_tp_distill_step_matches_jax_and_one_process(world2, case):
    """TP 2, the JAX step's draws (both intervals of the schedule)."""
    ranks, refs, payload = world2
    assert set(payload["distill_draws"][2]["intervals"].tolist()) == {0, 1}
    for rec in ranks:
        _held(*rec["train"][case][0][:2], *refs[f"jax_{case}"])
        _held(*rec["train"][case][0][:2], *refs["one"][case][0][:2])


@pytest.mark.parametrize("case", ["distill_split", "distill_guided_split"])
def test_mesh_distill_step_matches_jax_and_one_process(world4, case):
    """2 × 2: the 2 rows, their intervals and ε, split over cfg; the same
    numbers on every rank."""
    ranks, refs = world4
    for rec in ranks:
        loss, grads, adapters = rec["train"][case][0]
        _held(loss, grads, *refs[f"jax_{case}"])
        _held(loss, grads, *refs["one"][case][0][:2])
        for a, b in zip(adapters, ranks[0]["train"][case][0][2]):
            assert a.tobytes() == b.tobytes()


def test_adapters_identical_on_every_rank_after_two_steps(world2):
    """Bit for bit across the ranks; the second step's loss and gradients
    held to one process's, and the adapters within a few Adam updates' worth
    of f32 rounding (a near-zero gradient's sign can differ)."""
    ranks, refs, _ = world2
    one = refs["one"]["tp"]
    for rec in ranks:
        steps = rec["train"]["tp"]
        for a, b in zip(steps[1][2], ranks[0]["train"]["tp"][1][2]):
            assert a.tobytes() == b.tobytes()
        _held(*steps[1][:2], *one[1][:2])
        bad = sum(int(np.sum(np.abs(a - b) > 1e-6)) for a, b in zip(steps[1][2], one[1][2]))
        total = sum(a.size for a in one[1][2])
        assert bad <= max(2, total // 1000), (bad, total)


def test_train_state_crosses_between_world_and_one_process(world2):
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    ranks, refs, payload = world2
    assert [rec["states"]["saved_here"] for rec in ranks] == [True, True]
    one = lt.restore_train_state(payload["world_state"], _trainer(payload, None))
    assert one.steps == 2
    for got, want in zip(lt.lora_leaves(one.lora), ranks[0]["states"]["adapters"]):
        assert got.detach().numpy().tobytes() == want.tobytes()
    # and back: the one-process state of step 1 restored into the world
    want = [p.detach().numpy() for p in lt.lora_leaves(
        lt.restore_train_state(payload["one_state"], _trainer(payload, None)).lora)]
    for rec in ranks:
        assert rec["states"]["restored_steps"] == 1
        for a, b in zip(rec["states"]["restored"], want):
            assert a.tobytes() == b.tobytes()
        _held(*rec["states"]["step2"][:2], *refs["one"]["tp"][1][:2])


def test_train_loop_resumed_in_a_world_equals_unbroken(world2):
    ranks, _, payload = world2
    for rec in ranks:
        loop = rec["train_loop"]
        assert loop["steps"] == [3, 3] and loop["equal"]
        assert f"resumed from {payload['loop_state']} at step 2" in loop["printed"]
    for a, b in zip(ranks[0]["train_loop"]["adapters"], ranks[1]["train_loop"]["adapters"]):
        assert a.tobytes() == b.tobytes()


def test_negative_control_dropped_backward_all_reduce(world2):
    ranks, refs, _ = world2
    for rec in ranks:
        with pytest.raises(AssertionError):
            _held(*rec["drop_copy"][0][:2], *refs["jax_tp"])


def test_negative_control_whole_leaf_summed_over_model(world2):
    ranks, _, _ = world2
    for rec in ranks:
        whole, summed = rec["whole_leaf"]["whole"], rec["whole_leaf"]["summed"]
        assert whole["spec"] is None
        _held(whole["loss"], whole["got"], 0.5, whole["want"])
        with pytest.raises(AssertionError):
            _held(summed["loss"], summed["got"], 0.5, summed["want"])


def test_negative_control_sum_over_cfg(world4):
    ranks, refs = world4
    for rec in ranks:
        with pytest.raises(AssertionError):
            _held(*rec["sum_over_cfg"][0][:2], *refs["jax_split"])


@pytest.mark.parametrize("part", ["plain", "guided", "batched", "ssf"])
def test_stream_on_the_mesh_matches_jax(world2, part):
    """Keyframe and temporal frames (submitted pipelined, then sequential),
    a guided session, two sessions as one dispatch and a session whose
    similarity filter skips a repeated frame: every frame's latent against
    the JAX stream's, the skips the same."""
    ranks, refs, _ = world2
    assert refs["stream_trees_equal"] and refs["stream"]["ssf_skipped"] == 1
    for rec in ranks:
        assert rec["stream"]["ssf_skipped"] == 1
    for rec in ranks:
        got, want = rec["stream"][part], refs["stream"][part]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=ATOL, rtol=RTOL)


def test_engine_stream_sessions_follow_rank0(world2):
    """The lockstep engine's frames (the similarity filter's skips decided
    on rank 0 alone) equal the one-process engine's within one code, with
    the same frame counts, keyframes and lags; rank 1 made every call that
    rank 0 broadcast and holds no session or frame after the ends."""
    ranks, refs, _ = world2
    lead, follower = ranks[0]["engine"], ranks[1]["engine"]
    assert lead["skipped"] == refs["skipped"] > 0
    for (img, *meta), (want, *want_meta) in zip(lead["engine"], refs["engine"]):
        assert meta == want_meta
        assert np.abs(img.astype(int) - want.astype(int)).max() <= 1
    assert follower["calls"] == lead["broadcasts"] - 1  # the shutdown message
    processed = len(engine_requests()) - refs["skipped"] + len(stream_frames())
    assert follower["dispatches"] == processed
    assert follower["sessions"] == [] and follower["pending"] == 0


def test_websocket_session_on_rank0_matches_one_process(world2):
    ranks, refs, _ = world2
    lead = ranks[0]["engine"]
    assert lead["sessions_after_close"] == []
    meta = lambda frames: [{k: v for k, v in m.items() if k not in ("elapsed", "stream_session")}  # noqa: E731
                           for m, _, _ in frames]
    assert meta(lead["ws"]) == meta(refs["ws"]) and len(lead["ws"]) == len(stream_frames())
    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

    # each frame the server encoded within one code of one process's (the
    # engine test's limit; the f32 sums of the two ranks round otherwise),
    # and the JPEG sent that frame's encoding
    for (_, got, jpeg), (_, want, _) in zip(lead["ws"], refs["ws"]):
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        assert jpeg == codec.encode_jpeg(got, 90)
