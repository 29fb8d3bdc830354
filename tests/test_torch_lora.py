"""The port's LoRA path against the JAX package's: fusion, adapters, the
flow-matching loss and its gradients, the optimizer update, export and files,
the trainer, ``from_weights(lora_path=...)``, and the port's independence from
the JAX package. JAX-layout `tiny` trees are filled with numpy and bridged
with ``convert.from_jax`` / ``convert.lora_from_jax``; sigmas and noise are
injected into both sides (the two packages draw other random numbers)."""

import ast
import dataclasses
import inspect
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_pipeline as tp
from qwen_image_edit_streamdiffusion_tpu.core import config as jconfig
from qwen_image_edit_streamdiffusion_tpu.core.rng import key_from_seed
from qwen_image_edit_streamdiffusion_tpu.core.rng import stream as jax_stream
from qwen_image_edit_streamdiffusion_tpu.models import lora as jlora
from qwen_image_edit_streamdiffusion_tpu.models import optimize as jopt
from qwen_image_edit_streamdiffusion_tpu.models import text_encoder as jtext
from qwen_image_edit_streamdiffusion_tpu.models import transformer as jtfm
from qwen_image_edit_streamdiffusion_tpu.models import vae as jvae
from qwen_image_edit_streamdiffusion_tpu.models import qwen_vl as jvl
from qwen_image_edit_streamdiffusion_tpu.training import lora_train as jlt
from qwen_image_edit_streamdiffusion_tpu_torch.core import config as tconfig
from qwen_image_edit_streamdiffusion_tpu_torch.models import lora
from qwen_image_edit_streamdiffusion_tpu_torch.models import quantize
from qwen_image_edit_streamdiffusion_tpu_torch.models import qwen_vl
from qwen_image_edit_streamdiffusion_tpu_torch.models import text_encoder
from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm
from qwen_image_edit_streamdiffusion_tpu_torch.models.common import flatten
from qwen_image_edit_streamdiffusion_tpu_torch.models.convert import (
    from_jax,
    lora_from_jax,
)
from qwen_image_edit_streamdiffusion_tpu_torch.models.optimize import fuse_qkv
from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import edit_pipeline as tep
from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "qwen_image_edit_streamdiffusion_tpu_torch"
GOLDENS = dict(np.load(os.path.join(ROOT, "tests", "goldens", "tiny_goldens.npz")))
TINY = jconfig.get_preset("tiny")
M32 = dataclasses.replace(TINY.model, dtype="float32")
ALL_TARGETS = tuple(lora.BLOCK_MODULE_MAP)
TCFG = lt.TrainConfig(rank=4, alpha=8.0, targets=ALL_TARGETS, remat=False)
JTCFG = jlt.TrainConfig(rank=4, alpha=8.0, targets=ALL_TARGETS, remat=False)


def _jax_lora(jparams, jcfg, seed, scale=0.02):
    """The JAX init_lora tree with every leaf refilled from numpy (b is zero
    at init, which would hide the delta), as numpy."""
    tree = jlt.init_lora(jparams, jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda l: (rng.standard_normal(l.shape) * scale).astype(np.float32), tree)


def _port_vs_jax_tree(port, jtree):
    """Every port leaf against its JAX leaf: weight = wᵀ, bias = b."""
    jflat = {k: np.asarray(v, np.float32) for k, v in flatten(jtree).items()}
    got = flatten(port)
    assert len(got) == len(jflat)
    for k, v in got.items():
        if k.endswith(".weight"):
            want = jflat[k[:-len("weight")] + "w"].T
        elif k.endswith(".bias"):
            want = jflat[k[:-len("bias")] + "b"]
        else:
            want = jflat[k]
        np.testing.assert_allclose(v.float().numpy(), want, rtol=1e-6, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("qkv_fused", [False, True])
def test_fuse_lora_matches_jax(qkv_fused):
    """(e) fuse_lora on bridged f32 `tiny` weights against the JAX fuse_lora
    on every target module, unfused and after fuse_qkv (a q/k/v delta lands
    in its row slot of the port's (3D, D) weight): f32, 1e-6."""
    jparams = tp._numpy_tree(jtfm.init, M32, 0)
    sd = jlt.export_lora_state_dict(_jax_lora(jparams, JTCFG, 1), JTCFG)
    jtree = jax.tree_util.tree_map(jnp.asarray, jparams)
    if qkv_fused:
        jtree = jopt.fuse_qkv(jtree)
    want = jlora.fuse_lora(jtree, sd)
    params = from_jax(jparams, M32)
    if qkv_fused:
        params = fuse_qkv(params)
    got = lora.fuse_lora(params, sd)
    assert got is params  # in place
    _port_vs_jax_tree(got, want)


def test_fuse_lora_refuses_quantized_leaves():
    params = quantize.quantize_transformer(from_jax(tp._numpy_tree(jtfm.init, M32, 0), M32))
    sd = {"transformer_blocks.0.attn.to_q.lora_A.weight": np.zeros((2, 64), np.float32),
          "transformer_blocks.0.attn.to_q.lora_B.weight": np.zeros((64, 2), np.float32)}
    with pytest.raises(ValueError, match="fuse before quantize"):
        lora.fuse_lora(params, sd)


def test_fused_velocity_golden():
    """(e) the golden ``lora.fused_velocity``, by the protocol of
    ``benchmarks/verify_parity.py``: the preset's bf16 weights from the JAX
    init, rank-2 alpha-4 adapters refilled from numpy seed 11, exported and
    fused by the port, one forward; the golden tolerance 3e-2."""
    key = key_from_seed(0)
    cfg = TINY.model
    jparams = jtfm.init_jit(jax_stream(key, "transformer"), cfg)
    lcfg = jlt.TrainConfig(rank=2, alpha=4.0, seed=0)
    jl = jlt.init_lora(jparams, lcfg, jax_stream(key, "lora"))
    leaves, treedef = jax.tree_util.tree_flatten(jl)
    rng = np.random.default_rng(11)
    jl = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(rng.standard_normal(l.shape) * 0.02, l.dtype)
                  for l in leaves])
    params = from_jax(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                             jparams), cfg)
    lora.fuse_lora(params, jlt.export_lora_state_dict(jl, lcfg))
    img_shapes = ((1, 4, 4), (1, 4, 4))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 32, cfg.in_channels)).astype(np.float32)).bfloat16()
    txt = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 16, cfg.joint_dim)).astype(np.float32)).bfloat16()
    got = tfm.forward(params, cfg, x, txt, torch.tensor([500.0]),
                      tfm.make_rope(cfg, img_shapes, 16), use_flash=False)
    np.testing.assert_allclose(got.float().numpy(), GOLDENS["lora.fused_velocity"],
                               atol=3e-2, rtol=3e-2)


def _tfm_inputs(cfg, b=2):
    rng = np.random.default_rng(5)
    img_shapes = ((1, 4, 4), (1, 4, 4))
    x0 = rng.standard_normal((b, 16, cfg.in_channels)).astype(np.float32)
    cond = rng.standard_normal((b, 16, cfg.in_channels)).astype(np.float32)
    txt = rng.standard_normal((b, 8, cfg.joint_dim)).astype(np.float32)
    mask = np.ones((b, 8), bool)
    mask[-1, 5:] = False
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    sigmas = np.asarray([0.3, 0.8][:b], np.float32)
    return img_shapes, x0, cond, txt, mask, sigmas, noise


def test_init_lora_is_identity_at_step_zero():
    """(f) b = 0 at init: the merged tree's bf16 forward equals the base
    forward bit for bit, at the preset's bf16."""
    cfg = TINY.model
    params = fuse_qkv(from_jax(tp._numpy_tree(jtfm.init, cfg, 0), cfg))
    lo = lt.init_lora(params, lt.TrainConfig(rank=4), torch.Generator().manual_seed(0))
    img_shapes, x0, _, txt, mask, _, _ = _tfm_inputs(cfg, 1)
    args = (torch.from_numpy(x0).bfloat16(), torch.from_numpy(txt).bfloat16(),
            torch.tensor([500.0]), tfm.make_rope(cfg, ((1, 4, 4),), 8))
    with torch.no_grad():
        base = tfm.forward(params, cfg, *args, use_flash=False)
        merged = tfm.forward(lt.apply_lora(params, lo, 1.0), cfg, *args, use_flash=False)
    assert torch.equal(base, merged)


def _port_loss(params, lo, inputs, remat):
    img_shapes, x0, cond, txt, mask, sigmas, noise = inputs
    loss = lt.flow_match_loss(
        params, lo, TCFG.alpha / TCFG.rank, M32, torch.from_numpy(x0),
        torch.from_numpy(cond), torch.from_numpy(txt), torch.from_numpy(mask),
        torch.from_numpy(sigmas), torch.from_numpy(noise),
        tfm.make_rope(M32, img_shapes, 8), remat=remat)
    grads = torch.autograd.grad(loss, lt.lora_leaves(lo), allow_unused=True)
    return loss.item(), [torch.zeros_like(p) if g is None else g
                         for p, g in zip(lt.lora_leaves(lo), grads)]


@pytest.mark.parametrize("qkv_fused", [False, True])
def test_flow_match_loss_and_grads_match_jax(qkv_fused):
    """(g) loss and every adapter gradient against ``jax.value_and_grad`` of
    the JAX flow_match_loss, bridged f32 `tiny` weights and adapters, the
    same sigmas and noise: loss within 1e-5 relative, gradients within 1e-4
    of their tensor's max (f32 sums in other orders). With fused q/k/v the
    port's adapters land in row slots; the JAX side stays unfused."""
    jparams = tp._numpy_tree(jtfm.init, M32, 0)
    jl = _jax_lora(jparams, JTCFG, 3)
    inputs = _tfm_inputs(M32)
    img_shapes, x0, cond, txt, mask, sigmas, noise = inputs
    jfn = lambda lo: jlt.flow_match_loss(
        jparams, lo, JTCFG.alpha / JTCFG.rank, M32, jnp.asarray(x0), jnp.asarray(cond),
        jnp.asarray(txt), jnp.asarray(mask), jnp.asarray(sigmas), jnp.asarray(noise),
        jtfm.make_rope(M32, img_shapes, 8), remat=False)
    jv, jg = jax.jit(jax.value_and_grad(jfn))(jax.tree_util.tree_map(jnp.asarray, jl))

    params = from_jax(jparams, M32)
    if qkv_fused:
        params = fuse_qkv(params)
    lo = lora_from_jax(jl, params, TCFG)
    v, grads = _port_loss(params, lo, inputs, remat=False)
    assert abs(v - float(jv)) <= 1e-5 * abs(float(jv))
    want = lt.lora_leaves(lora_from_jax(jax.tree_util.tree_map(np.asarray, jg),
                                        params, TCFG))
    for g, w in zip(grads, want):
        w = w.detach()
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * max(w.abs().max().item(), 1e-12))


def test_remat_matches_no_remat():
    """(g) remat=True (checkpointed blocks with the LoRA merge inside)
    gives the same loss and adapter gradients as remat=False: the same ops
    rerun, so within 1e-6 relative."""
    params = from_jax(tp._numpy_tree(jtfm.init, M32, 0), M32)
    lo = lora_from_jax(_jax_lora(tp._numpy_tree(jtfm.init, M32, 0), JTCFG, 4),
                       params, TCFG)
    inputs = _tfm_inputs(M32)
    v0, g0 = _port_loss(params, lo, inputs, remat=False)
    v1, g1 = _port_loss(params, lo, inputs, remat=True)
    assert abs(v0 - v1) <= 1e-6 * abs(v0)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("edit", ["missing", "unused", "shape"])
def test_lora_from_jax_is_total(edit):
    jparams = tp._numpy_tree(jtfm.init, M32, 0)
    params = from_jax(jparams, M32)
    jl = _jax_lora(jparams, JTCFG, 5)
    attn = jl["blocks"][0]["attn"]
    if edit == "missing":
        del attn["img_q"]
    elif edit == "unused":
        attn["extra"] = {"a": np.zeros((4, 4), np.float32)}
    else:
        attn["img_q"]["b"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match=edit):
        lora_from_jax(jl, params, TCFG)


@pytest.fixture(scope="module")
def tiny_pipe():
    return tep.EditPipeline.create("tiny", tp._config(), seed=0, device="cpu")


def _items():
    return [{"image": lt._test_image(tp.SIZE, kind), "prompt": "draw a circle",
             "target": lt._test_image(tp.SIZE, "circle")}
            for kind in ("gradient", "circle")]


@pytest.fixture(scope="module")
def batch(tiny_pipe):
    return lt.build_batch(tiny_pipe, _items())


def test_trainer_update_matches_optax(tiny_pipe):
    """(h) the trainer's update — global-norm clip, then AdamW — against
    optax.chain(clip_by_global_norm, adamw) on the same gradients over two
    steps, weight decay on, gradients above the clip: within 1e-6 of the
    parameter scale (the two round the Adam denominator differently)."""
    import optax

    cfg = lt.TrainConfig(rank=4, alpha=4.0, learning_rate=1e-3, weight_decay=0.01,
                         grad_clip=0.5, targets=("attn.to_q", "img_mlp.net.2"))
    trainer = lt.LoRATrainer.from_pipeline(tiny_pipe, cfg)
    leaves = lt.lora_leaves(trainer.lora)
    rng = np.random.default_rng(6)
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in leaves]
             for _ in range(2)]
    params = [p.detach().numpy().copy() for p in leaves]
    opt = optax.chain(optax.clip_by_global_norm(cfg.grad_clip),
                      optax.adamw(cfg.learning_rate, b1=cfg.b1, b2=cfg.b2,
                                  weight_decay=cfg.weight_decay))
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    for g in grads:
        upd, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(leaves, g):
            p.grad = torch.from_numpy(x.copy())
        assert lt.clip_by_global_norm_([p.grad for p in leaves], cfg.grad_clip) > 0.5
        trainer.opt.step()
    for p, want in zip(leaves, jp):
        want = np.asarray(want)
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(want).max()))


TRAIN_CFG = lt.TrainConfig(rank=4, alpha=4.0, learning_rate=5e-3,
                           targets=("attn.to_q", "attn.to_v", "img_mlp.net.0.proj"),
                           remat=False)


def test_loss_decreases(tiny_pipe, batch):
    """(i) six steps on one batch with fixed sigmas and noise lower the
    flow-matching loss."""
    trainer = lt.LoRATrainer.from_pipeline(tiny_pipe, TRAIN_CFG)
    sigmas, noise = trainer.draw(batch)
    losses = [trainer.step(batch, sigmas, noise) for _ in range(6)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_export_and_files(tmp_path):
    """(j) export keys and values equal the JAX export_lora_state_dict; the
    port's .safetensors writer round-trips (bf16 included), safetensors.numpy
    reads its file, and its reader reads safetensors.numpy's files."""
    from safetensors.numpy import load_file, save_file

    jparams = tp._numpy_tree(jtfm.init, M32, 0)
    jl = _jax_lora(jparams, JTCFG, 7)
    want = jlt.export_lora_state_dict(jl, JTCFG)
    got = lt.export_lora_state_dict(lora_from_jax(jl, from_jax(jparams, M32), TCFG), TCFG)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == np.asarray(want[k]).shape
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)

    path = str(tmp_path / "port.safetensors")
    lora.save_safetensors(path, got)
    back = lora.load_lora_weights(path)
    assert sorted(back) == sorted(got)
    for k in got:
        np.testing.assert_array_equal(back[k].numpy(), got[k])
    theirs = load_file(path)
    for k in got:
        np.testing.assert_array_equal(theirs[k], got[k])

    mixed = {"f16": np.arange(6, dtype=np.float16).reshape(2, 3),
             "i8": np.asarray([-3, 4], np.int8), "u8": np.asarray([7], np.uint8),
             "f32": np.float32(2.5) * np.ones((3, 1, 2), np.float32)}
    save_file(mixed, str(tmp_path / "theirs.safetensors"))
    read = lora.load_safetensors(str(tmp_path / "theirs.safetensors"))
    for k, v in mixed.items():
        np.testing.assert_array_equal(read[k].numpy(), v)
    bf = {"w": torch.randn((5, 3), generator=torch.Generator().manual_seed(0)).bfloat16()}
    lora.save_safetensors(str(tmp_path / "bf16.safetensors"), bf)
    assert torch.equal(lora.load_safetensors(str(tmp_path / "bf16.safetensors"))["w"],
                       bf["w"])

    lt.save_lora(str(tmp_path / "a.npz"), lora_from_jax(jl, from_jax(jparams, M32), TCFG),
                 TCFG)
    npz = lora.load_lora_weights(str(tmp_path / "a.npz"))
    for k in got:
        np.testing.assert_array_equal(npz[k].numpy(), got[k])


def test_quantized_base_refused(tiny_pipe):
    """(k) adapters need dense weights."""
    params = quantize.quantize_transformer(
        from_jax(tp._numpy_tree(jtfm.init, M32, 0), M32))
    with pytest.raises(ValueError, match="dense weights"):
        lt.init_lora(params, TRAIN_CFG, torch.Generator())


def test_resume_is_bit_exact(tmp_path, tiny_pipe, batch):
    """(l) 2 steps → save → 2 steps equals restore into a fresh trainer → 2
    steps: adapters, AdamW moments and the sigma/noise generator."""
    path = str(tmp_path / "state.pt")
    a = lt.LoRATrainer.from_pipeline(tiny_pipe, TRAIN_CFG)
    for _ in range(2):
        a.step(batch)
    lt.save_train_state(path, a)
    for _ in range(2):
        a.step(batch)
    b = lt.restore_train_state(path, lt.LoRATrainer.from_pipeline(tiny_pipe, TRAIN_CFG))
    assert b.steps == 2
    for _ in range(2):
        b.step(batch)
    for x, y in zip(lt.lora_leaves(a.lora), lt.lora_leaves(b.lora)):
        assert torch.equal(x, y)


def test_from_weights_lora_path_matches_jax(tmp_path, monkeypatch):
    """(m) ``from_weights(lora_path=...)`` on `tiny` f32 (LoRA fused, then
    q/k/v fused) against the JAX pipeline on params fused by the JAX
    fuse_lora: test_torch_pipeline.py's f32 tolerances, latents within 1e-3
    max-abs and pixels within 1 code."""
    from PIL import Image

    preset = tp._preset(True)
    trees = (tp._numpy_tree(jtfm.init, preset.model, 0),
             tp._numpy_tree(jvae.init, preset.vae, 1),
             tp._numpy_tree(jvl._init_all, preset.vl, 2))
    jcfg = jlt.TrainConfig(rank=4, alpha=4.0)
    sd = jlt.export_lora_state_dict(_jax_lora(trees[0], jcfg, 8, 0.05), jcfg)
    path = str(tmp_path / "adapter.safetensors")
    lora.save_safetensors(path, sd)
    fused = jlora.fuse_lora(jax.tree_util.tree_map(jnp.asarray, trees[0]), sd)
    jpipe, _, _ = tp._jax_pipeline(
        preset, (jax.tree_util.tree_map(np.asarray, fused), trees[1], trees[2]))
    img = tp._images(1)[0]
    jres = jpipe(Image.fromarray(img), tp.PROMPT, num_inference_steps=2, seed=42)
    zh = tp.SIZE // 8
    x0 = jpipe._noise_fn((1, zh, zh, preset.vae.latent_channels))(
        jax_stream(key_from_seed(42), "latents"))

    tpipe = tep.EditPipeline.from_weights(
        preset, tp._config(), from_jax(trees[0], preset.model),
        from_jax(trees[1], preset.vae), from_jax(trees[2], preset.vl),
        device="cpu", lora_path=path)
    assert "img_qkv" in tpipe.tfm_params["blocks"][0]["attn"]
    monkeypatch.setattr(tpipe, "_noise",
                        lambda shape, seed: torch.from_numpy(np.array(x0, np.float32)))
    tres = tpipe(img, tp.PROMPT, num_inference_steps=2, seed=42)
    jl_ = np.asarray(jres.latents, np.float32)
    assert np.abs(tres.latents.numpy() - jl_).max() < 1e-3
    assert np.abs(tres.images[0].astype(np.int32)
                  - np.asarray(jres.images[0]).astype(np.int32)).max() <= 1

    qtree = quantize.quantize_transformer(from_jax(trees[0], preset.model))
    with pytest.raises(ValueError, match="quantized checkpoint"):
        tep.EditPipeline.from_weights(
            preset, tp._config(), qtree, from_jax(trees[1], preset.vae),
            from_jax(trees[2], preset.vl), device="cpu", lora_path=path)


# the card host has none of these: the port reads tokenizer.json itself
FORBIDDEN = ("jax", "jaxlib", "optax", "PIL", "transformers", "tokenizers", "regex",
             "qwen_image_edit_streamdiffusion_tpu")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_port_imports_nothing_of_jax_by_ast():
    """(n) no module of the port, and not chip_smoke.py, imports jax, optax,
    PIL, transformers, tokenizers, regex or the JAX package (at any depth of
    the file)."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, PKG)):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(open(f).read(), f)):
            if isinstance(node, ast.Import):
                bad += [(f, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.level == 0 and _forbidden(node.module):
                    bad.append((f, node.module))
    assert len(files) > 20 and not bad, bad


def test_port_runs_with_jax_blocked():
    """(n) a fresh process whose import system refuses jax, optax, PIL and
    the JAX package runs a `tiny` CPU edit, one `tiny` LoRA train step, one
    distillation step and one tiny-decoder step."""
    code = f"""
import importlib.abc, sys
FORBIDDEN = {FORBIDDEN!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
import numpy as np, torch
torch.set_num_threads(2)
from {PKG}.core.config import StreamConfig
from {PKG}.pipeline.edit_pipeline import EditPipeline
from {PKG}.training import lora_train as lt
cfg = StreamConfig(width=64, height=64, vae_image_area=64 * 64,
                   vl_image_area=64 * 64, num_inference_steps=1,
                   cfg_mode="none", model_preset="tiny")
p = EditPipeline.create("tiny", cfg, seed=0, device="cpu")
r = p(np.zeros((64, 64, 3), np.uint8), "edit it")
assert r.images[0].shape == (64, 64, 3)
t = lt.LoRATrainer.from_pipeline(p, lt.TrainConfig(rank=2, alpha=2.0))
b = lt.build_batch(p, [{{"image": lt._test_image(64, "gradient"),
                        "prompt": "draw", "target": lt._test_image(64, "circle")}}])
assert np.isfinite(t.step(b))
from {PKG}.training import distill, tiny_vae
d = distill.DistillTrainer.from_pipeline(p, distill.DistillConfig(
    train=lt.TrainConfig(rank=2, alpha=2.0)))
assert np.isfinite(d.step(b)) and d.steps == 1
tt = tiny_vae.TinyVAETrainer.from_pipeline(p, tiny_vae.TinyVAETrainConfig(width=8))
assert np.isfinite(tt.step(tiny_vae.build_decoder_batch(
    p, tiny_vae._synthetic_images(32, 2))))
bad = [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_presets_of_both_packages_are_equal():
    """(o) the port's copy of the config module: every preset equal field by
    field, the StreamConfig defaults too, and the configs frozen (hashable,
    as JAX's static arguments need); StubEncoder gives the same embeddings."""
    assert sorted(tconfig.PRESETS) == sorted(jconfig.PRESETS)
    for name in jconfig.PRESETS:
        assert (dataclasses.asdict(tconfig.get_preset(name))
                == dataclasses.asdict(jconfig.get_preset(name))), name
        hash(tconfig.get_preset(name))
    assert dataclasses.asdict(tconfig.StreamConfig()) == dataclasses.asdict(
        jconfig.StreamConfig())
    vl = TINY.vl
    img = np.random.default_rng(9).integers(0, 256, (32, 32, 3), np.uint8)
    a = text_encoder.StubEncoder.from_config(vl).encode("make it blue", [img])
    b = jtext.StubEncoder.from_config(vl).encode("make it blue", [img])
    np.testing.assert_array_equal(a.embeds, b.embeds)
    np.testing.assert_array_equal(a.mask, b.mask)


def test_entry_points_default_to_the_card():
    """(p) the public constructors run on CUDA unless the caller asks."""
    sig = inspect.signature
    assert sig(tep.EditPipeline.from_weights).parameters["device"].default == "cuda"
    assert sig(tep.EditPipeline.create).parameters["device"].default == "cuda"
    assert sig(qwen_vl.QwenVLEncoder).parameters["device"].default == "cuda"
