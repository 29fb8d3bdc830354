"""The port's progressive distillation (``training/distill.py``) against the
JAX package's: the teacher's two-half-step target v* (plain and guided), the
loss and adapter gradients, the clip + AdamW update, the trainer, and the
distilled adapter served at ``student_steps``.

JAX-layout `tiny` trees are filled with numpy and bridged with
``convert.from_jax`` / ``convert.lora_from_jax``. The two packages draw other
random numbers, so the JAX step's draws (``jax.random.split`` of the step's
key, then ``randint`` for the intervals and ``normal`` for ε, as the JAX
``build_distill_step`` draws them) are rebuilt here and injected into the
port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_lora as tl
import test_torch_pipeline as tp
from qwen_image_edit_streamdiffusion_tpu.core import config as jconfig
from qwen_image_edit_streamdiffusion_tpu.models import scheduler as jsched
from qwen_image_edit_streamdiffusion_tpu.models import transformer as jtfm
from qwen_image_edit_streamdiffusion_tpu.training import distill as jdt
from qwen_image_edit_streamdiffusion_tpu.training import lora_train as jlt
from qwen_image_edit_streamdiffusion_tpu_torch.core import config as tconfig
from qwen_image_edit_streamdiffusion_tpu_torch.models import scheduler as sched
from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm
from qwen_image_edit_streamdiffusion_tpu_torch.models.convert import (
    from_jax,
    lora_from_jax,
)
from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import edit_pipeline as tep
from qwen_image_edit_streamdiffusion_tpu_torch.training import distill as dt
from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

torch.set_num_threads(2)

M32 = tl.M32
SCHED = jconfig.get_preset("tiny").scheduler
TSCHED = tconfig.get_preset("tiny").scheduler
STEPS = 2       # student_steps
SCALE = 4.0     # teacher_cfg_scale of the guided cases
JCFG = jlt.TrainConfig(rank=4, alpha=8.0, targets=tl.ALL_TARGETS, remat=False,
                       learning_rate=1e-3, weight_decay=0.01, grad_clip=0.05)
TCFG = lt.TrainConfig(rank=4, alpha=8.0, targets=tl.ALL_TARGETS, remat=False,
                      learning_rate=1e-3, weight_decay=0.01, grad_clip=0.05)


def _dcfgs(guided: bool):
    s = SCALE if guided else 0.0
    return (jdt.DistillConfig(train=JCFG, student_steps=STEPS, teacher_cfg_scale=s),
            dt.DistillConfig(train=TCFG, student_steps=STEPS, teacher_cfg_scale=s))


@pytest.fixture(scope="module")
def trees():
    jparams = tp._numpy_tree(jtfm.init, M32, 0)
    return jparams, tl._jax_lora(jparams, JCFG, 3)


def _inputs():
    """Two rows: x0, cond (16 tokens each), text and a different negative
    text (8 tokens, the last row's masks shorter)."""
    img_shapes, x0, cond, txt, mask, _, _ = tl._tfm_inputs(M32)
    rng = np.random.default_rng(8)
    neg = rng.standard_normal(txt.shape).astype(np.float32)
    neg_mask = np.ones_like(mask)
    neg_mask[0, 6:] = False
    return img_shapes, x0, cond, txt, mask, neg, neg_mask


def _jax_draws(key, batch, shape):
    """The JAX step's intervals and ε for ``key``."""
    k_i, k_eps = jax.random.split(key)
    i = jax.random.randint(k_i, (batch,), 0, STEPS)
    eps = jax.random.normal(k_eps, shape, jnp.float32)
    return np.array(i), np.array(eps)


def _jax_target(jparams, jdcfg, inputs, i, eps):
    """v* the JAX way: ``_model_v`` and ``scheduler.euler_step`` composed as
    the JAX step composes them (its guided combination included)."""
    img_shapes, x0, cond, txt, mask, neg, neg_mask = inputs
    ropes = jtfm.make_rope(M32, img_shapes, txt.shape[1])
    sig = jsched.make_schedule(STEPS, 16, SCHED).sigmas
    sig_t, sig_e = sig[i], sig[i + 1]
    sig_m = 0.5 * (sig_t + sig_e)
    st = sig_t[:, None, None]
    x_t = (1.0 - st) * jnp.asarray(x0) + st * jnp.asarray(eps)

    def teacher(x, s):
        v = jdt._model_v(jparams, M32, x, jnp.asarray(cond), jnp.asarray(txt),
                         jnp.asarray(mask), s * SCHED.num_train_timesteps, ropes,
                         False, None)
        if not jdcfg.teacher_cfg_scale > 1.0:
            return v
        v_neg = jdt._model_v(jparams, M32, x, jnp.asarray(cond), jnp.asarray(neg),
                             jnp.asarray(neg_mask), s * SCHED.num_train_timesteps,
                             ropes, False, None)
        g = v_neg + jdcfg.teacher_cfg_scale * (v - v_neg)
        norm_v = jnp.linalg.norm(v, axis=-1, keepdims=True)
        norm_g = jnp.linalg.norm(g, axis=-1, keepdims=True)
        return g * (norm_v / jnp.maximum(norm_g, 1e-6))

    x_m = jsched.euler_step(x_t, teacher(x_t, sig_t), sig_t[:, None, None],
                            sig_m[:, None, None])
    x_e = jsched.euler_step(x_m, teacher(x_m, sig_m), sig_m[:, None, None],
                            sig_e[:, None, None])
    return (x_e - x_t) / (sig_e - sig_t)[:, None, None]


def _port_sigmas(i):
    sig = sched.make_schedule(STEPS, 16, TSCHED).sigmas
    i = torch.as_tensor(i, dtype=torch.long)
    return sig[i], sig[i + 1]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _port_loss(params, lo, dcfg, inputs, i, eps):
    img_shapes, x0, cond, txt, mask, neg, neg_mask = inputs
    sig_t, sig_e = _port_sigmas(i)
    return dt.distill_loss(
        params, lo, TCFG.alpha / TCFG.rank, M32, dcfg, *_t(x0, cond, txt, mask, neg,
                                                           neg_mask),
        sig_t, sig_e, torch.from_numpy(eps), tfm.make_rope(M32, img_shapes, 8),
        TSCHED.num_train_timesteps, remat=False)


@pytest.mark.parametrize("guided", [False, True])
def test_target_loss_and_grads_match_jax(trees, guided):
    """v* (guided: real negatives, other text and mask) within 1e-4 relative
    of the JAX composition; the loss within 1e-4 relative and every adapter
    gradient within 1e-4 of its tensor's max against ``jax.value_and_grad``
    of the student's loss on the JAX v*, all in f32."""
    jparams, jl = trees
    jdcfg, dcfg = _dcfgs(guided)
    inputs = _inputs()
    img_shapes, x0, cond, txt, mask, _, _ = inputs
    i, eps = _jax_draws(jax.random.PRNGKey(11), 2, x0.shape)
    assert len(set(i.tolist())) == 2  # both intervals of the schedule
    v_star_j = _jax_target(jparams, jdcfg, inputs, i, eps)

    sig = jsched.make_schedule(STEPS, 16, SCHED).sigmas[i]
    st = sig[:, None, None]
    x_t = ((1.0 - st) * jnp.asarray(x0) + st * jnp.asarray(eps)).astype(jnp.float32)
    ropes = jtfm.make_rope(M32, img_shapes, 8)
    scale = JCFG.alpha / JCFG.rank

    def jloss(lo):
        v = jdt._model_v(jparams, M32, x_t, jnp.asarray(cond), jnp.asarray(txt),
                         jnp.asarray(mask), sig * SCHED.num_train_timesteps, ropes,
                         False, None, lora_blocks=lo["blocks"], scale=scale)
        return jnp.mean(jnp.square(v - v_star_j))

    jv, jg = jax.jit(jax.value_and_grad(jloss))(jax.tree_util.tree_map(jnp.asarray, jl))

    params = from_jax(jparams, M32)
    lo = lora_from_jax(jl, params, TCFG)
    loss, v_star = _port_loss(params, lo, dcfg, inputs, i, eps)
    assert not v_star.requires_grad
    want = np.asarray(v_star_j)
    err = np.abs(v_star.numpy() - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err
    assert abs(loss.item() - float(jv)) <= 1e-4 * abs(float(jv))
    grads = torch.autograd.grad(loss, lt.lora_leaves(lo), allow_unused=True)
    want = lt.lora_leaves(lora_from_jax(jax.tree_util.tree_map(np.asarray, jg),
                                        params, TCFG))
    for p, g, w in zip(lt.lora_leaves(lo), grads, want):
        g = torch.zeros_like(p) if g is None else g
        w = w.detach()
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * max(w.abs().max().item(), 1e-12))


@pytest.mark.parametrize("guided", [False, True])
def test_step_matches_jitted_jax_step(trees, guided):
    """One step of the port's ``build_distill_step`` against the jitted JAX
    ``build_distill_step`` on the same key's draws: the loss within 1e-4
    relative; the adapters after the clip + AdamW update within 1e-6 of the
    parameter scale of ``optax.chain(clip_by_global_norm, adamw)`` applied
    to the port's own gradients (the JAX step's gradients differ in f32
    rounding, and Adam's first step takes the sign of each)."""
    jparams, jl = trees
    jdcfg, dcfg = _dcfgs(guided)
    inputs = _inputs()
    img_shapes, x0, cond, txt, mask, neg, neg_mask = inputs
    key = jax.random.PRNGKey(5)
    opt = optax.chain(optax.clip_by_global_norm(JCFG.grad_clip),
                      optax.adamw(JCFG.learning_rate, b1=JCFG.b1, b2=JCFG.b2,
                                  weight_decay=JCFG.weight_decay))
    jl_j = jax.tree_util.tree_map(jnp.asarray, jl)
    jstep = jax.jit(jdt.build_distill_step(M32, SCHED, jdcfg, opt, img_shapes, 8, 2))
    _, _, jloss = jstep(jax.tree_util.tree_map(jnp.asarray, jparams), jl_j,
                        opt.init(jl_j), *[jnp.asarray(a) for a in
                                          (x0, cond, txt, mask, neg, neg_mask)], key)
    i, eps = _jax_draws(key, 2, x0.shape)

    params = from_jax(jparams, M32)
    lo = lora_from_jax(jl, params, TCFG)
    leaves = lt.lora_leaves(lo)
    loss, _ = _port_loss(params, lo, dcfg, inputs, i, eps)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [np.zeros(p.shape, np.float32) if g is None else g.numpy()
             for p, g in zip(leaves, grads)]
    p0 = [jnp.asarray(p.detach().numpy()) for p in leaves]
    upd, _ = opt.update([jnp.asarray(g) for g in grads], opt.init(p0), p0)
    want = optax.apply_updates(p0, upd)

    optimizer = torch.optim.AdamW(leaves, lr=TCFG.learning_rate,
                                  betas=(TCFG.b1, TCFG.b2), eps=1e-8,
                                  weight_decay=TCFG.weight_decay)
    step = dt.build_distill_step(M32, TSCHED, dcfg, optimizer, img_shapes, 8, "cpu")
    got = step(params, lo, *_t(x0, cond, txt, mask, neg, neg_mask),
               torch.from_numpy(i), torch.from_numpy(eps))
    assert abs(got.item() - float(jloss)) <= 1e-4 * abs(float(jloss))
    assert abs(got.item() - loss.item()) <= 1e-6 * abs(loss.item())
    for p, w in zip(leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(w).max()))


def test_teacher_is_two_half_steps_and_guidance_by_the_positive_is_none(trees):
    """v* = (v(x_t, σ_i) + v(x_m, σ_m)) / 2 with x_m the half step (σ_m is
    the interval's midpoint), within f32 rounding; a guided teacher whose
    negative rows are the positive ones gives the unguided v* bit for bit;
    with real negatives it differs."""
    jparams, _ = trees
    params = from_jax(jparams, M32)
    inputs = _inputs()
    img_shapes, x0, cond, txt, mask, neg, neg_mask = inputs
    i, eps = np.asarray([1, 0]), np.random.default_rng(4).standard_normal(
        x0.shape).astype(np.float32)
    sig_t, sig_e = _port_sigmas(i)
    ropes = tfm.make_rope(M32, img_shapes, 8)
    _, dcfg = _dcfgs(False)
    _, gcfg = _dcfgs(True)
    args = _t(x0, cond, txt, mask)

    def target(cfg, n, nm):
        return dt.distill_target(params, M32, cfg, *args, n, nm, sig_t, sig_e,
                                 torch.from_numpy(eps), ropes,
                                 TSCHED.num_train_timesteps)[1]

    plain = target(dcfg, args[2], args[3])
    assert torch.equal(target(gcfg, args[2], args[3]), plain)
    assert not torch.allclose(target(gcfg, *_t(neg, neg_mask)), plain, atol=1e-3)

    s_t, s_e = sig_t[:, None, None], sig_e[:, None, None]
    s_m = 0.5 * (s_t + s_e)
    x_t = (1 - s_t) * args[0] + s_t * torch.from_numpy(eps)
    with torch.no_grad():
        v = lambda x, s: dt._model_v(params, M32, x, args[1], args[2], args[3],
                                     s[:, 0, 0] * 1000, ropes, False)
        v1 = v(x_t, s_t)
        v2 = v(x_t + (s_m - s_t) * v1, s_m)
    torch.testing.assert_close(plain, 0.5 * (v1 + v2), rtol=0,
                               atol=1e-5 * (v1.abs().max().item() + 1.0))


@pytest.fixture(scope="module")
def tiny_pipe():
    return tep.EditPipeline.create("tiny", tp._config(), seed=0, device="cpu")


DISTILL = dt.DistillConfig(
    train=lt.TrainConfig(rank=4, alpha=4.0, learning_rate=5e-3, remat=False,
                         targets=("attn.to_q", "attn.to_v", "img_mlp.net.0.proj")),
    student_steps=STEPS)


def test_trainer_loss_falls_and_adapter_serves(tmp_path, tiny_pipe):
    """Six trainer steps on one batch with fixed intervals and ε lower the
    loss (remat on: K7 twice a block on the card); the trainer counts its
    steps; ``dcfg`` switches per step (a guided step reads the negative
    rows). The distilled adapter, saved with ``save_lora``, serves through
    ``from_weights(lora_path=...)`` at ``student_steps``: the same latents
    (1e-5) as the pipeline built on the trainer's merged params, and not the
    base pipeline's."""
    items = [{"image": lt._test_image(tp.SIZE, kind), "prompt": "draw a circle",
              "target": lt._test_image(tp.SIZE, "circle"), "negative_prompt": ""}
             for kind in ("gradient", "circle")]
    batch = lt.build_batch(tiny_pipe, items)
    trainer = dt.DistillTrainer.from_pipeline(tiny_pipe, dataclasses.replace(
        DISTILL, train=dataclasses.replace(DISTILL.train, remat=True)))
    intervals, eps = trainer.draw(batch)
    losses = [trainer.step(batch, intervals, eps) for _ in range(6)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    trainer.dcfg = dataclasses.replace(trainer.dcfg, teacher_cfg_scale=SCALE)
    assert np.isfinite(trainer.step(batch))
    assert trainer.steps == 7 and len(trainer._steps) == 2

    path = str(tmp_path / "distilled.safetensors")
    lt.save_lora(path, trainer.lora, trainer.cfg)
    img = lt._test_image(tp.SIZE, "gradient")
    preset = tep.get_preset("tiny")

    def serve(params, lora_path=None):
        pipe = tep.EditPipeline.from_weights(
            preset, tp._config(), params, tiny_pipe.vae_params,
            tiny_pipe.encoder.params, device="cpu", lora_path=lora_path)
        return pipe(img, tp.PROMPT, num_inference_steps=STEPS, seed=3).latents

    base = tiny_pipe.tfm_params
    with torch.no_grad():
        want = serve(_copy(lt.apply_lora(base, trainer.lora,
                                         trainer.cfg.alpha / trainer.cfg.rank)))
    got = serve(_copy(base), path)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())
    assert not torch.allclose(got, serve(_copy(base)), atol=1e-4)


def _copy(tree):
    """A detached copy (``from_weights`` fuses in place)."""
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree.detach().clone()
