"""The port's sharded path in spawned ``gloo`` worlds on the CPU, against the
JAX package and against the port's own one-process runs.

One world of 2 ranks (mesh 1 × 2) and one of 4 (mesh 2 × 2) are spawned per
module, each running all its scenarios in one go while the parent computes
the JAX references; each test reads its part of the ranks' records. The
ranks take the JAX trees as numpy (``convert.from_jax``) and import the
port alone: JAX is imported only inside the parent's functions.

- (a) the `tiny` f32 MMDiT forward at TP 2 against the JAX forward (atol
  2e-4, rtol 1e-3, ``tests/test_sharding.py``'s limits);
- (b) the int8 and int4 TP forwards against the JAX quantized forwards,
  and the row-parallel int8 codes against the one-device codes (equal);
- (c) the VL encode sharded over the world against the JAX encode;
- (d) ``EditPipeline`` on the 2 × 2 mesh: ``parallel`` and ``batched``
  against the JAX one-device ``sequential``, ``rcfg`` / ``rcfg-self``
  against the JAX one-device runs, ``edit_many`` and
  ``num_images_per_prompt=2`` (atol 2e-4, rtol 1e-3);
- (e) ``from_checkpoint`` under the mesh: every leaf equals the slice of
  the full tree, and a rank copies only its slices from the files;
- (f) the server: rank 0 answers ``/edit`` while rank 1 follows, the same
  JPEG bytes as the one-process engine, a hit in lockstep;
- (g) negative controls: a swapped shard or a dropped all-reduce fails (a);
- a follower whose call raises fails its rank, and rank 0's call fails at
  once in the collective it left.
"""

import dataclasses
import json
import os
import tempfile
import threading
import traceback
import urllib.request

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from qwen_image_edit_streamdiffusion_tpu_torch.core.config import StreamConfig, get_preset
from qwen_image_edit_streamdiffusion_tpu_torch.models.common import flatten

SIZE = 64
PROMPT = "make it a watercolor painting"
NEG = "bad"
CFG_SCALE = 4.0
ATOL, RTOL = 2e-4, 1e-3
WORLD_TIMEOUT = 240  # seconds a world may take, spawn to last record


def _preset_f32():
    p = get_preset("tiny")
    return dataclasses.replace(p, model=dataclasses.replace(p.model, dtype="float32"),
                               vl=dataclasses.replace(p.vl, dtype="float32"))


def _config(mesh_shape=(1, 1), **kw):
    return StreamConfig(width=SIZE, height=SIZE, vae_image_area=SIZE * SIZE,
                        vl_image_area=56 * 56, num_inference_steps=2,
                        model_preset="tiny", mesh_cfg_axis=mesh_shape[0],
                        mesh_model_axis=mesh_shape[1], **kw)


def _image(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (SIZE, SIZE, 3), np.uint8)


def _tfm_inputs(cfg):
    rng = np.random.default_rng(2)
    img_shapes = ((1, 4, 4), (1, 4, 4))
    x = rng.standard_normal((1, 32, cfg.in_channels)).astype(np.float32)
    txt = rng.standard_normal((1, 16, cfg.joint_dim)).astype(np.float32)
    mask = np.ones((1, 16), bool)
    mask[:, 11:] = False
    return img_shapes, x, txt, mask, np.asarray([500.0], np.float32)


# ---------------------------------------------------------------------------
# Rank side: the port only
# ---------------------------------------------------------------------------


def _forward(params, cfg, inputs, tp):
    from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm

    img_shapes, x, txt, mask, t = inputs
    with torch.no_grad():
        return tfm.forward(params, cfg, torch.from_numpy(x), torch.from_numpy(txt),
                           torch.from_numpy(t), tfm.make_rope(cfg, img_shapes, 16),
                           txt_mask=torch.from_numpy(mask), tp=tp).numpy()


def _sharded_tfm(tree, cfg, mesh):
    from qwen_image_edit_streamdiffusion_tpu_torch.models.convert import from_jax
    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import sharding

    return sharding.shard_transformer_params(from_jax(tree, cfg), mesh)


def _code_spy(mesh, seen):
    """Wrap K5's given-scale entry: each call's codes and scale held against
    the one-device quantizer of the whole row (the ranks' slices gathered)."""
    from qwen_image_edit_streamdiffusion_tpu_torch.ops import int8 as int8_ops
    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed

    inner = int8_ops.quantize_rows_given

    def spy(x, scale):
        codes = inner(x, scale)
        g = mesh.model_group
        k = seen["k"].pop(0)  # the slice's width before its zero padding
        whole = distributed.all_gather(x[:, :k].contiguous(), g, dim=-1)
        want_codes, want_scale = int8_ops.quantize_rows_plain(whole)
        seen["equal"].append(bool(torch.equal(want_scale, scale)) and bool(torch.equal(
            codes[:, :k], want_codes[:, g.rank * k:(g.rank + 1) * k])))
        return codes

    def row(x, p, group):
        seen["k"].append(x.shape[-1])
        return row_inner(x, p, group)

    row_inner = int8_ops.int8_linear_row
    return spy, row


def _world2(mesh, payload):
    from qwen_image_edit_streamdiffusion_tpu_torch.core.meshes import SINGLE
    from qwen_image_edit_streamdiffusion_tpu_torch.models import qwen_vl
    from qwen_image_edit_streamdiffusion_tpu_torch.models.convert import from_jax
    from qwen_image_edit_streamdiffusion_tpu_torch.ops import int8 as int8_ops
    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed, sharding

    preset = _preset_f32()
    cfg, tp = preset.model, mesh.model_group
    inputs = payload["inputs"]
    out = {"rank": mesh.world_group.rank}
    out["tp"] = _forward(_sharded_tfm(payload["tfm"], cfg, mesh), cfg, inputs, tp)

    for bits in (8, 4):
        params = _sharded_tfm(payload[f"tfm_q{bits}"], cfg, mesh)
        seen = {"k": [], "equal": []}
        spy, row = _code_spy(mesh, seen)
        saved = int8_ops.quantize_rows_given, int8_ops.int8_linear_row
        int8_ops.quantize_rows_given, int8_ops.int8_linear_row = spy, row
        try:
            out[f"tp_q{bits}"] = _forward(params, cfg, inputs, tp)
        finally:
            int8_ops.quantize_rows_given, int8_ops.int8_linear_row = saved
        out[f"codes_q{bits}"] = seen["equal"]
        one = from_jax(payload[f"tfm_q{bits}"], cfg)
        out[f"one_q{bits}"] = _forward(one, cfg, inputs, SINGLE)

    vl_params = sharding.shard_vl_params(from_jax(payload["vl"], preset.vl), mesh, preset.vl)
    enc = qwen_vl.QwenVLEncoder(preset.vl, vl_params, device="cpu",
                                max_len=preset.vl.max_text_len, mesh=mesh)
    emb = enc.encode(PROMPT, [payload["vl_image"]])
    out["vl"] = (emb.embeds.numpy(), np.asarray(emb.mask))
    out["vl_q_rows"] = vl_params["lm"]["blocks"][0]["q_proj"]["weight"].shape[0]

    # (g) a rank holding the other rank's q heads, then one all-reduce missing
    params = _sharded_tfm(payload["tfm"], cfg, mesh)
    swapped = _sharded_tfm(payload["tfm"], cfg, mesh)
    other = mesh.model_group.rank ^ 1
    full = from_jax(payload["tfm"], cfg)
    for blk, fblk in zip(swapped["blocks"], full["blocks"]):
        for name in ("weight", "bias"):
            t = fblk["attn"]["img_q"][name]
            n = t.shape[0] // 2
            blk["attn"]["img_q"][name] = t[other * n:(other + 1) * n].clone()
    out["swapped"] = _forward(swapped, cfg, inputs, tp)
    real = distributed.all_reduce
    calls = []

    def drop_first(t, group, op="sum"):
        calls.append(1)
        return t if len(calls) == 1 else real(t, group, op)

    distributed.all_reduce = drop_first
    try:
        out["dropped"] = _forward(params, cfg, inputs, tp)
    finally:
        distributed.all_reduce = real
    out["stats"] = dict(distributed.STATS)
    out["ckpt"] = _world2_checkpoints(mesh, payload["ckpt"])
    out["server"] = _world2_server(mesh, payload["server"])
    out["fault"] = _world2_fault(mesh)  # last: it ends the process group
    return out


def _world2_checkpoints(mesh, dirs):
    """Every variant loaded through ``from_checkpoint`` under the mesh: the
    rank's leaves against the slices of the full tree; the bytes it copied
    (each ``slice_part``'s result) against the bytes it holds; whole blocks
    copied (``to_device``) only where it quantizes at load."""
    from qwen_image_edit_streamdiffusion_tpu_torch.models import checkpoint as ckpt
    from qwen_image_edit_streamdiffusion_tpu_torch.models import quantize
    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import sharding
    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.edit_pipeline import (
        EditPipeline,
    )

    preset = get_preset("tiny")
    results = {}
    real_slice, real_to = sharding.slice_part, sharding.to_device
    for name, (tdir, quant) in dirs["transformer"].items():
        copied, modules = [], []

        def slice_spy(t, spec, m, fused=False):
            part = real_slice(t, spec, m, fused)
            copied.append(part.numel() * part.element_size())
            return part

        def to_spy(tree, device, skip_blocks=False):
            modules.append(sum(t.numel() * t.element_size()
                               for t in flatten(tree).values()))
            return real_to(tree, device, skip_blocks)

        sharding.slice_part, sharding.to_device = slice_spy, to_spy
        try:
            pipe = EditPipeline.from_checkpoint(
                tdir, dirs["vae"], preset=preset, vl_path=dirs["vl"], device="cpu",
                config=_config((1, 2), **quant), mesh=mesh)
        finally:
            sharding.slice_part, sharding.to_device = real_slice, real_to
        full = ckpt.load(tdir, "cpu", preset, "transformer")
        if quant:
            quantize.quantize_transformer(full, bits=8)
        diff, held = 0.0, 0
        sizes = mesh.shape
        for key, leaf in flatten(full).items():
            path = tuple(key.split("."))
            want = real_slice(leaf, sharding.transformer_leaf_spec(path, tuple(leaf.shape), sizes),
                              mesh, fused=path[-2] in sharding.FUSED)
            got = flatten(pipe.tfm_params)[key]
            diff = max(diff, float((got.double() - want.double()).abs().max()))
        vl_full = ckpt.load(dirs["vl"], "cpu", preset, "vl")
        axes = sharding.vl_axes(mesh, preset.vl)
        got_vl = flatten(pipe.encoder.params)
        for key, leaf in flatten(vl_full).items():
            path = tuple(key.split("."))
            want = real_slice(leaf, sharding.vl_leaf_spec(path, axes, tuple(leaf.shape), sizes),
                              mesh, fused=path[-2] in sharding.FUSED)
            diff = max(diff, float((got_vl[key].double() - want.double()).abs().max()))
        for tree in (pipe.tfm_params, pipe.encoder.params):
            held += sum(t.numel() * t.element_size() for t in flatten(tree).values())
        whole = sum(t.numel() * t.element_size()
                    for tree in (full, vl_full) for t in flatten(tree).values())
        results[name] = {"diff": diff, "copied": sum(copied), "held": held,
                         "whole": whole, "modules": modules,
                         "blocks": len(full["blocks"])}
    return results


def _world2_server(mesh, payload):
    """Rank 0: the engine behind the HTTP server, a miss and a hit posted to
    it. Rank 1: the follower loop. Each reports its cache decisions."""
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime.engine import (
        InferenceEngine,
        follow,
    )
    from qwen_image_edit_streamdiffusion_tpu_torch.serving.server import make_server

    preset = _preset_f32()
    config = _config((1, 2))
    if mesh.world_group.rank > 0:
        pipe = InferenceEngine.build_pipeline(preset, config, seed=0, device="cpu",
                                              mesh=mesh)
        calls = follow(pipe, mesh.world_group)
        return {"calls": calls, "prompt": pipe.prompt_cache.stats(),
                "latent": pipe.latent_cache.stats()}
    engine = InferenceEngine.create(preset, config=config, seed=0, warmup_runs=0,
                                    input_size=SIZE, device="cpu", mesh=mesh)
    srv = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/edit"
    images = []
    try:
        for _ in range(2):
            req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                images.append(json.loads(resp.read())["image"])
    finally:
        srv.shutdown()
        srv.server_close()
        engine.pipeline.shutdown()
    return {"images": images, "prompt": engine.pipeline.prompt_cache.stats(),
            "latent": engine.pipeline.latent_cache.stats()}


def _world2_fault(mesh):
    """Rank 1's followed call raises between two collectives of the call.
    Rank 1: ``follow`` raises it, and the rank ends its process group as
    the server's follower does. Rank 0: its call fails in the collective
    that rank 1 left (at once, not at the group's timeout), and the
    pipeline refuses the next call."""
    import time

    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime.engine import (
        LockstepPipeline,
        follow,
    )

    group, rank = mesh.world_group, mesh.world_group.rank

    class Pipe:
        def __call__(self):
            distributed.all_reduce(torch.ones(4), group)
            if rank == 1:
                raise RuntimeError("injected fault")
            distributed.all_reduce(torch.ones(4), group)

    t0 = time.time()
    errors = []
    if rank == 1:
        try:
            follow(Pipe(), group)
        except RuntimeError as e:
            errors.append(str(e))
        finally:
            distributed.shutdown()
        return {"errors": errors, "seconds": time.time() - t0}
    pipe = LockstepPipeline(Pipe(), group)
    for _ in range(2):
        try:
            pipe()
        except RuntimeError as e:
            errors.append(str(e))
    return {"errors": errors, "seconds": time.time() - t0}


def _world4(mesh, payload):
    from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm
    from qwen_image_edit_streamdiffusion_tpu_torch.models.convert import from_jax
    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.edit_pipeline import (
        EditPipeline,
    )

    preset = _preset_f32()
    trees = payload["trees"]
    pipe = EditPipeline.from_weights(
        preset, _config((2, 2), cfg_mode="parallel"), from_jax(trees[0], preset.model),
        from_jax(trees[1], preset.vae), from_jax(trees[2], preset.vl), device="cpu",
        mesh=mesh)
    table = payload["noise"]
    pipe._noise = lambda shape, seed: torch.from_numpy(table[(tuple(shape), seed)])
    rows = []
    real = tfm.forward

    def spy(params, cfg, img_tokens, *a, **kw):
        rows.append(img_tokens.shape[0])
        return real(params, cfg, img_tokens, *a, **kw)

    tfm.forward = spy
    out = {"rank": mesh.world_group.rank, "c": mesh.c, "m": mesh.m,
           "model_rank": mesh.model_group.rank, "cfg_rank": mesh.cfg_group.rank}
    img = payload["image"]
    try:
        for mode in ("parallel", "batched", "rcfg", "rcfg-self"):
            pipe.config = pipe.config.replace(cfg_mode=mode)
            rows.clear()
            res = pipe(img, PROMPT, negative_prompt=NEG, true_cfg_scale=CFG_SCALE,
                       seed=42)
            out[mode] = (res.latents.numpy(), list(rows))
        pipe.config = pipe.config.replace(cfg_mode="parallel")
        rows.clear()
        many = pipe.edit_many(payload["items"], true_cfg_scale=CFG_SCALE)
        out["edit_many"] = ([r.latents.numpy() for r in many], list(rows))
        rows.clear()
        res = pipe(img, PROMPT, num_images_per_prompt=2, seed=7)
        out["num_images"] = (res.latents.numpy(), list(rows))
    finally:
        tfm.forward = real
    out["vl_q_rows"] = pipe.encoder.params["lm"]["blocks"][0]["q_proj"]["weight"].shape[0]
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
# Parent side: the JAX references
# ---------------------------------------------------------------------------


def _numpy_trees():
    from test_torch_pipeline import _numpy_tree

    from qwen_image_edit_streamdiffusion_tpu.models import qwen_vl as jvl
    from qwen_image_edit_streamdiffusion_tpu.models import transformer as jtfm
    from qwen_image_edit_streamdiffusion_tpu.models import vae as jvae

    p = _preset_f32()
    return (_numpy_tree(jtfm.init, p.model, 0), _numpy_tree(jvae.init, p.vae, 1),
            _numpy_tree(jvl._init_all, p.vl, 2))


def _jax_forward(tree, inputs):
    import jax
    import jax.numpy as jnp

    from qwen_image_edit_streamdiffusion_tpu.models import transformer as jtfm

    cfg = _preset_f32().model
    img_shapes, x, txt, mask, t = inputs
    fwd = jax.jit(jtfm.forward, static_argnums=1, static_argnames="use_flash")
    return np.asarray(fwd(tree, cfg, jnp.asarray(x), jnp.asarray(txt), jnp.asarray(t),
                          jtfm.make_rope(cfg, img_shapes, 16),
                          txt_mask=jnp.asarray(mask), use_flash=False), np.float32)


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _write_checkpoints(root):
    """The port's checkpoints of `tiny`: bf16, fused-q/k/v int8, int4, and a
    bf16 tree quantized at load; the VAE and the VL."""
    from qwen_image_edit_streamdiffusion_tpu_torch.core.rng import stream
    from qwen_image_edit_streamdiffusion_tpu_torch.models import checkpoint as ckpt
    from qwen_image_edit_streamdiffusion_tpu_torch.models import qwen_vl, quantize, vae
    from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm
    from qwen_image_edit_streamdiffusion_tpu_torch.models.optimize import fuse_qkv

    preset = get_preset("tiny")

    def tree():
        return tfm.init(stream(0, "transformer"), preset.model)

    variants = {"bf16": tree(), "int8_fused": quantize.quantize_transformer(
        fuse_qkv(tree()), bits=8), "int4": quantize.quantize_transformer(tree(), bits=4)}
    dirs = {}
    for name, params in variants.items():
        d = os.path.join(root, name)
        ckpt.save(d, params, {"component": "transformer", "preset": "tiny"})
        dirs[name] = (d, {})
    dirs["bf16_int8_at_load"] = (dirs["bf16"][0], {"use_int8": True})
    vdir, ldir = os.path.join(root, "vae"), os.path.join(root, "vl")
    ckpt.save(vdir, vae.init(stream(0, "vae"), preset.vae),
              {"component": "vae", "preset": "tiny"})
    ckpt.save(ldir, qwen_vl.init(stream(0, "vl"), preset.vl),
              {"component": "vl", "preset": "tiny"})
    return {"transformer": dirs, "vae": vdir, "vl": ldir}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The world of 2 with its payload, then the parent's references."""
    import jax

    from qwen_image_edit_streamdiffusion_tpu.models import qwen_vl as jvl
    from qwen_image_edit_streamdiffusion_tpu.models.quantize import quantize_transformer
    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime.engine import InferenceEngine

    trees = _numpy_trees()
    inputs = _tfm_inputs(_preset_f32().model)
    q = {bits: _np_tree(quantize_transformer(trees[0], bits=bits)) for bits in (8, 4)}
    vl_image = np.random.default_rng(11).integers(0, 256, (50, 90, 3)).astype(np.uint8)
    request = {"image": codec.to_base64_jpeg(_image(3)), "prompt": PROMPT,
               "steps": 2, "seed": 42}
    payload = {"tfm": trees[0], "tfm_q8": q[8], "tfm_q4": q[4], "inputs": inputs,
               "vl": trees[2], "vl_image": vl_image, "server": request,
               "ckpt": _write_checkpoints(str(tmp_path_factory.mktemp("ckpt")))}
    world = World("world2", (1, 2), payload)

    refs = {"tp": _jax_forward(trees[0], inputs),
            "q8": _jax_forward(q[8], inputs), "q4": _jax_forward(q[4], inputs)}
    preset = _preset_f32()
    jenc = jvl.QwenVLEncoder(preset.vl, params=jax.tree_util.tree_map(
        jax.numpy.asarray, trees[2]), max_len=preset.vl.max_text_len)
    want = jenc.encode(PROMPT, [vl_image])
    refs["vl"] = (np.asarray(want.embeds, np.float32), np.asarray(want.mask))
    engine = InferenceEngine.create(preset, config=_config(), seed=0, warmup_runs=0,
                                    input_size=SIZE, device="cpu")
    refs["server"] = engine.edit(dict(request))["image"]
    return world.results(), refs


def _jax_pipeline(trees, mode):
    import jax

    from qwen_image_edit_streamdiffusion_tpu.core.config import StreamConfig as JConfig
    from qwen_image_edit_streamdiffusion_tpu.core.config import get_preset as jget_preset
    from qwen_image_edit_streamdiffusion_tpu.models import qwen_vl as jvl
    from qwen_image_edit_streamdiffusion_tpu.pipeline import cache as jcache
    from qwen_image_edit_streamdiffusion_tpu.pipeline import edit_pipeline as jep

    p = jget_preset("tiny")
    preset = dataclasses.replace(p, model=dataclasses.replace(p.model, dtype="float32"),
                                 vl=dataclasses.replace(p.vl, dtype="float32"))
    cast = lambda t: jax.tree_util.tree_map(jax.numpy.asarray, t)  # noqa: E731
    enc = jvl.QwenVLEncoder(preset.vl, params=cast(trees[2]), max_len=preset.vl.max_text_len)
    config = JConfig(width=SIZE, height=SIZE, vae_image_area=SIZE * SIZE,
                     vl_image_area=56 * 56, num_inference_steps=2, cfg_mode=mode,
                     model_preset="tiny", fuse_qkv=False)
    return jep.EditPipeline(preset=preset, config=config, tfm_params=cast(trees[0]),
                            vae_params=cast(trees[1]), encoder=enc,
                            prompt_cache=jcache.PromptCache(enc),
                            latent_cache=jcache.LatentCache())


@pytest.fixture(scope="module")
def world4():
    from PIL import Image

    from qwen_image_edit_streamdiffusion_tpu.core.rng import key_from_seed
    from qwen_image_edit_streamdiffusion_tpu.core.rng import stream as jax_stream

    trees = _numpy_trees()
    jpipe = _jax_pipeline(trees, "sequential")
    z = _preset_f32().vae.latent_channels
    lat = SIZE // 8
    items = [{"image": _image(5), "prompt": "warm colors", "negative_prompt": NEG, "seed": 5},
             {"image": _image(9), "prompt": "cold colors", "negative_prompt": "worse",
              "seed": 9}]
    noise = {}
    for n, seed in ((1, 42), (1, 5), (1, 9), (2, 7)):
        shape = (n, lat, lat, z)
        x = jpipe._noise_fn(shape)(jax_stream(key_from_seed(seed), "latents"))
        noise[(shape, seed)] = np.array(x, np.float32)
    img = _image(1)
    world = World("world4", (2, 2), {"trees": trees, "noise": noise, "image": img,
                                    "items": items})

    def lat_of(mode, **kw):
        jpipe.config = jpipe.config.replace(cfg_mode=mode)
        return np.asarray(jpipe(Image.fromarray(kw.pop("image", img)), kw.pop("prompt", PROMPT),
                                **kw).latents, np.float32)

    refs = {"sequential": lat_of("sequential", negative_prompt=NEG,
                                 true_cfg_scale=CFG_SCALE, seed=42)}
    for mode in ("rcfg", "rcfg-self"):
        refs[mode] = lat_of(mode, negative_prompt=NEG, true_cfg_scale=CFG_SCALE, seed=42)
    refs["edit_many"] = [lat_of("sequential", image=it["image"], prompt=it["prompt"],
                                negative_prompt=it["negative_prompt"],
                                true_cfg_scale=CFG_SCALE, seed=it["seed"]) for it in items]
    refs["num_images"] = lat_of("none", num_images_per_prompt=2, seed=7)
    return world.results(), refs


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL)


def test_ranks_import_no_jax(world2, world4):
    for rec in world2[0] + world4[0]:
        assert rec["jax_loaded"] == []


def test_tp_forward_matches_jax(world2):
    ranks, refs = world2
    for rec in ranks:
        _close(rec["tp"], refs["tp"])
    # a forward of 2 blocks: img_out, txt_out and both fc2 all-reduce, the
    # two modulations all-gather, per block
    assert ranks[0]["stats"]["all_gather"] >= 4


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_tp_forward_matches_jax(world2, bits):
    """Within one bf16 ulp of the JAX quantized forward (f32 here): the
    row-parallel int8 linear changes no code, so only f32 sum order
    differs. The TP forward also equals the port's one-process quantized
    forward within f32 rounding."""
    ranks, refs = world2
    want = refs[f"q{bits}"]
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    for rec in ranks:
        got = rec[f"tp_q{bits}"]
        assert np.all(np.abs(got - want) <= np.maximum(ulp, 1e-6 * np.abs(want).max()))
        _close(got, rec[f"one_q{bits}"])


def test_row_parallel_int8_codes_equal_one_device(world2):
    """Every row-parallel int8 linear of the int8 forward (img_out, txt_out,
    fc2 of both blocks) quantized its slice with the whole row's scale and
    wrote the one-device codes; the int4 rung takes no int8 row path."""
    ranks, _ = world2
    for rec in ranks:
        assert rec["codes_q8"] and all(rec["codes_q8"]), rec["codes_q8"]
        assert len(rec["codes_q8"]) == 2 * 4
        assert rec["codes_q4"] == []


def test_vl_encode_sharded_matches_jax(world2):
    """The port's existing VL limit (``tests/test_torch_models.py``):
    |got − want| <= 1e-4 · (|want| + max|want|), and the mask equal."""
    ranks, refs = world2
    want, want_mask = refs["vl"]
    for rec in ranks:
        got, mask = rec["vl"]
        np.testing.assert_array_equal(mask, want_mask)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
        assert rec["vl_q_rows"] == _preset_f32().vl.hidden_size // 2


@pytest.mark.parametrize("control", ["swapped", "dropped"])
def test_negative_controls_fail_the_tp_limit(world2, control):
    ranks, refs = world2
    for rec in ranks:
        with pytest.raises(AssertionError):
            _close(rec[control], refs["tp"])


@pytest.mark.parametrize("variant", ["bf16", "int8_fused", "int4", "bf16_int8_at_load"])
def test_from_checkpoint_reads_each_ranks_slices(world2, variant):
    ranks, _ = world2
    for rec in ranks:
        r = rec["ckpt"][variant]
        assert r["diff"] == 0.0
        # every byte copied out of the files is a byte this rank holds...
        if variant == "bf16_int8_at_load":
            # ...or one block at a time, copied whole to be quantized
            assert len(r["modules"]) == r["blocks"]
            assert r["copied"] >= r["held"]
        else:
            assert r["modules"] == []
            assert r["copied"] == r["held"]
        assert r["held"] < 0.75 * r["whole"]


def test_server_rank0_answers_while_rank1_follows(world2):
    ranks, refs = world2
    lead, follower = ranks[0]["server"], ranks[1]["server"]
    assert lead["images"][0] == refs["server"]
    assert lead["images"][1] == refs["server"]
    assert follower["calls"] == 2
    # a miss then a hit, in lockstep
    assert lead["prompt"] == follower["prompt"] and lead["latent"] == follower["latent"]
    assert lead["prompt"]["hits"] == 1 and lead["latent"]["hits"] == 1


def test_follower_fault_fails_every_rank(world2):
    ranks, _ = world2
    follower, lead = ranks[1]["fault"], ranks[0]["fault"]
    assert follower["errors"] == ["injected fault"]
    assert len(lead["errors"]) == 2
    assert "out of step" in lead["errors"][1]
    assert lead["seconds"] < 60  # the group's timeout is 600 s


def test_mesh_layout_of_the_world(world4):
    ranks, _ = world4
    for rec in ranks:
        assert (rec["c"], rec["m"]) == divmod(rec["rank"], 2)
        assert rec["model_rank"] == rec["m"] and rec["cfg_rank"] == rec["c"]
        # tiny's 2 kv heads do not divide the world of 4: the VL shards over
        # the model axis
        assert rec["vl_q_rows"] == _preset_f32().vl.hidden_size // 2


@pytest.mark.parametrize("mode", ["parallel", "batched"])
def test_guided_modes_on_the_mesh_match_jax_sequential(world4, mode):
    """``parallel`` splits the pair over the cfg groups (one row a rank's
    forward), ``batched`` runs it whole (two rows)."""
    ranks, refs = world4
    for rec in ranks:
        lat, rows = rec[mode]
        _close(lat, refs["sequential"])
        assert rows == ([1, 1] if mode == "parallel" else [2, 2])


@pytest.mark.parametrize("mode", ["rcfg", "rcfg-self"])
def test_rcfg_modes_under_tp_match_jax(world4, mode):
    ranks, refs = world4
    for rec in ranks:
        _close(rec[mode][0], refs[mode])


def test_edit_many_on_the_mesh(world4):
    ranks, refs = world4
    for rec in ranks:
        lats, rows = rec["edit_many"]
        for got, want in zip(lats, refs["edit_many"]):
            _close(got, want)
        assert rows == [2, 2]  # 2 items × (pos, neg) = 4 rows over 2 cfg groups


def test_num_images_rows_split_over_cfg(world4):
    ranks, refs = world4
    for rec in ranks:
        lat, rows = rec["num_images"]
        _close(lat, refs["num_images"])
        assert rows == [1, 1]  # the JAX dp_rows: 2 rows over 2 cfg groups
