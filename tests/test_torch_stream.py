"""The port's realtime stream (``pipeline/stream.py``) against the JAX stream
at `tiny`: keyframe and temporal frames through both pipelines.

One JAX and one port pipeline per module, on the same numpy trees bridged
with ``convert.from_jax``; the port's ``_frame_noise`` draws the JAX stream's
noise (``frame_key(stream(seed, "temporal"), i)``, split for a temporal
frame), so both sides re-noise the same latents. f32: each frame's
``prev_latent`` within 1e-3 max-abs of the JAX one and its pixels within one
code (``test_slice_matches_jax_f32``'s limits), in every guidance mode at 1
and 2 steps, sequential and pipelined; bf16: rel-L2 3e-2. Also
``scale_noise`` / ``euler_step`` bit for bit. The helpers here are shared
with ``test_torch_stream_ops.py``.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import test_torch_pipeline as tp
from qwen_image_edit_streamdiffusion_tpu.core.config import StreamConfig
from qwen_image_edit_streamdiffusion_tpu.core.rng import (
    frame_key,
    key_from_seed,
    split_keys,
)
from qwen_image_edit_streamdiffusion_tpu.core.rng import stream as jax_stream
from qwen_image_edit_streamdiffusion_tpu.models import qwen_vl as jvl
from qwen_image_edit_streamdiffusion_tpu.models import scheduler as jsched
from qwen_image_edit_streamdiffusion_tpu.models import tiny_vae as jtv
from qwen_image_edit_streamdiffusion_tpu.models import transformer as jtfm
from qwen_image_edit_streamdiffusion_tpu.models import vae as jvae
from qwen_image_edit_streamdiffusion_tpu.pipeline import cache as jcache
from qwen_image_edit_streamdiffusion_tpu.pipeline import edit_pipeline as jep
from qwen_image_edit_streamdiffusion_tpu.pipeline import stream as jstream
from qwen_image_edit_streamdiffusion_tpu_torch.core import imaging
from qwen_image_edit_streamdiffusion_tpu_torch.models import scheduler as sched
from qwen_image_edit_streamdiffusion_tpu_torch.models import tiny_vae as tv
from qwen_image_edit_streamdiffusion_tpu_torch.models.convert import from_jax
from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import edit_pipeline as tep
from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import stream as tstream
from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

torch.set_num_threads(2)

SIZE = 64
PROMPT = "oil painting style"
NEG = "blurry"


def stream_config(**kw):
    base = dict(width=SIZE, height=SIZE, vae_image_area=SIZE * SIZE,
                vl_image_area=32 * 32, num_inference_steps=2, keyframe_interval=3,
                model_preset="tiny", cfg_mode="none", fuse_qkv=False)
    base.update(kw)
    return StreamConfig(**base)


def jax_frame_noise(seed: int):
    """A stand-in for the port's ``_frame_noise``: the JAX stream's draws of
    frame ``i`` (one normal for a keyframe; the two of the split key for a
    temporal frame, jitter then ε)."""
    def noise(kind, shape, frame_index):
        key = frame_key(jax_stream(key_from_seed(seed), "temporal"), frame_index)
        keys = (key,) if kind == "key" else split_keys(key)
        return tuple(torch.from_numpy(np.array(jax.random.normal(k, tuple(shape),
                                                                 jnp.float32)))
                     for k in keys)
    return noise


def _tiny_pair_trees(preset):
    dcfg = jtv.TinyDecoderConfig.from_vae(preset.vae, width=16)
    ecfg = jtv.TinyEncoderConfig.from_vae(preset.vae, width=16)
    return ((tp._numpy_tree(jtv.init, dcfg, 5), dcfg),
            (tp._numpy_tree(jtv.encoder_init, ecfg, 6), ecfg))


def build_stream_pair(f32: bool = True, tiny_pair: bool = False, **config):
    """(JAX EditPipeline, port EditPipeline) on the same numpy trees and
    config; with ``tiny_pair`` both also hold the same tiny decoder and
    encoder (and the config selects them)."""
    preset = tp._preset(f32)
    trees = (tp._numpy_tree(jtfm.init, preset.model, 0),
             tp._numpy_tree(jvae.init, preset.vae, 1),
             tp._numpy_tree(jvl._init_all, preset.vl, 2))
    if tiny_pair:
        config = {**config, "decoder": "tiny", "encoder": "tiny"}
    cfg = stream_config(**config)
    cast = lambda t, d: jax.tree_util.tree_map(lambda a: jnp.asarray(a, d), t)
    jenc = jvl.QwenVLEncoder(preset.vl, params=cast(trees[2], preset.vl.dtype),
                             max_len=preset.vl.max_text_len)
    jpipe = jep.EditPipeline(
        preset=preset, config=cfg, tfm_params=cast(trees[0], preset.model.dtype),
        vae_params=cast(trees[1], preset.vae.dtype), encoder=jenc,
        prompt_cache=jcache.PromptCache(jenc), latent_cache=jcache.LatentCache())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random tiny pair, replaced below
        tpipe = tep.EditPipeline.from_weights(
            preset, cfg, from_jax(trees[0], preset.model), from_jax(trees[1], preset.vae),
            from_jax(trees[2], preset.vl), device="cpu")
    if tiny_pair:
        (dtree, dcfg), (etree, ecfg) = _tiny_pair_trees(preset)
        jpipe.tiny_vae = (cast(dtree, dcfg.dtype), dcfg)
        jpipe.tiny_encoder = (cast(etree, ecfg.dtype), ecfg)
        tpipe.tiny_vae = (from_jax(dtree, dcfg),
                          tv.TinyDecoderConfig(**dataclasses.asdict(dcfg)))
        tpipe.tiny_encoder = (from_jax(etree, ecfg),
                              tv.TinyEncoderConfig(**dataclasses.asdict(ecfg)))
    return jpipe, tpipe


def sessions(jpipe, tpipe, prompt=PROMPT, negative_prompt=None):
    """A JAX and a port stream session on the pipelines, prompts frozen, the
    port drawing the JAX noise."""
    jrt = jstream.RealtimePipeline(pipe=jpipe)
    trt = tstream.RealtimePipeline(pipe=tpipe)
    trt._frame_noise = jax_frame_noise(tpipe.config.seed)
    for rt in (jrt, trt):
        rt.precompute_conditions(prompt, negative_prompt=negative_prompt)
    return jrt, trt


def set_config(jpipe, tpipe, **kw):
    """Switch both live pipelines' config; drop the JAX stream's fused
    graphs, whose cache key does not carry ``cfg_mode``."""
    for p in (jpipe, tpipe):
        p.config = p.config.replace(**kw)
    for key in [k for k in jpipe._jit_cache if k[0].startswith("stream_fused")]:
        del jpipe._jit_cache[key]


def frames(n: int, size: int = SIZE):
    """n distinct noisy frames (different per index)."""
    rng = np.random.default_rng(size)
    base = imaging.make_test_image(size, size, "sine")
    return [np.clip(base.astype(np.int32) + rng.integers(-40, 40, base.shape), 0,
                    255).astype(np.uint8) for _ in range(n)]


def jax_frame(jrt, arr, pipelined=False):
    if pipelined:
        return np.asarray(jrt._collect(jrt.submit_frame(Image.fromarray(arr))))
    return np.asarray(jrt.process_frame(Image.fromarray(arr)))


def assert_f32_close(jrt, trt, jout, tout):
    jl = np.asarray(jrt.prev_latent, np.float32)
    tl = trt.prev_latent.float().numpy()
    assert tl.shape == jl.shape and np.isfinite(tl).all()
    assert np.abs(tl - jl).max() < 1e-3
    assert tout.dtype == np.uint8 and tout.shape == jout.shape
    assert np.abs(tout.astype(np.int32) - jout.astype(np.int32)).max() <= 1


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def f32_pair():
    return build_stream_pair(True)


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scale_noise_and_euler_step_bit_exact(dtype):
    """The forward process and the Euler update against the JAX functions,
    bit for bit, at every σ of the JAX 4-step schedule (f32 math, cast
    back)."""
    rng = np.random.default_rng(3)
    x, e = (rng.standard_normal((2, 16, 64)).astype(np.float32) for _ in range(2))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx, je = jnp.asarray(x, jdt), jnp.asarray(e, jdt)
    tx, te = torch.from_numpy(x).to(dtype), torch.from_numpy(e).to(dtype)
    jsig = jsched.make_schedule(4, 1024).sigmas
    tsig = torch.from_numpy(np.asarray(jsig))  # the same σ on both sides
    for i in range(4):
        want = np.asarray(jsched.scale_noise(jx, je, jsig[i]), np.float32)
        got = sched.scale_noise(tx, te, tsig[i])
        assert got.dtype == dtype and np.array_equal(got.float().numpy(), want)
        want = np.asarray(jsched.euler_step(jx, je, jsig[i], jsig[i + 1]), np.float32)
        got = sched.euler_step(tx, te, tsig[i], tsig[i + 1])
        assert got.dtype == dtype and np.array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("mode", ["none", "batched", "rcfg", "rcfg-self"])
def test_frames_match_jax_f32(f32_pair, mode, steps):
    """A keyframe then two temporal frames (different inputs, prompts frozen)
    in ``mode`` (``none``: no negative prompt; else guided at scale 4)."""
    jpipe, tpipe = f32_pair
    set_config(jpipe, tpipe, cfg_mode="batched" if mode == "none" else mode,
               num_inference_steps=steps)
    jrt, trt = sessions(jpipe, tpipe, negative_prompt=None if mode == "none" else NEG)
    before = dict(kernels.LAUNCHES)
    for i, arr in enumerate(frames(3)):
        jout = jax_frame(jrt, arr)
        tout = trt.process_frame(arr)
        assert trt.is_keyframe == jrt.is_keyframe == (i == 0)
        assert_f32_close(jrt, trt, jout, tout)
    assert kernels.LAUNCHES == before  # CPU tensors never reach a kernel


def test_sequential_and_parallel_run_batched(f32_pair, monkeypatch):
    """A guided stream frame runs batched CFG in ``sequential`` and
    ``parallel`` mode too (the JAX fused graph's rule): same latents as
    ``batched``, one two-row forward a step."""
    jpipe, tpipe = f32_pair
    modes = []
    real = tpipe._denoise
    monkeypatch.setattr(tpipe, "_denoise", lambda *a, **kw: modes.append(a[6]) or real(*a, **kw))
    outs = {}
    for mode in ("batched", "sequential", "parallel"):
        set_config(jpipe, tpipe, cfg_mode=mode, num_inference_steps=2)
        _, trt = sessions(jpipe, tpipe, negative_prompt=NEG)
        trt.process_frame(frames(1)[0])
        outs[mode] = trt.prev_latent
    assert modes == ["batched"] * 3
    assert torch.equal(outs["sequential"], outs["batched"])
    assert torch.equal(outs["parallel"], outs["batched"])


def test_pipelined_frames_match_jax_f32(f32_pair):
    """submit_frame / _collect, several frames in flight, as the JAX
    pipelined path: the same latents and pixels as the JAX stream."""
    jpipe, tpipe = f32_pair
    set_config(jpipe, tpipe, cfg_mode="batched", num_inference_steps=2)
    jrt, trt = sessions(jpipe, tpipe)
    arrs = frames(3)
    jh = [jrt.submit_frame(Image.fromarray(a)) for a in arrs]
    th = [trt.submit_frame(a) for a in arrs]
    for j, t in zip(jh, th):
        jout, tout = np.asarray(jrt._collect(j)), trt._collect(t)
        assert np.abs(tout.astype(np.int32) - jout.astype(np.int32)).max() <= 1
    assert_f32_close(jrt, trt, jout, tout)


def test_off_size_frames_match_jax_f32(f32_pair):
    """Frames larger than the output: both sides resize them (Pillow's
    LANCZOS, the port's copy on the host) before the encode."""
    jpipe, tpipe = f32_pair
    set_config(jpipe, tpipe, cfg_mode="batched", num_inference_steps=2)
    jrt, trt = sessions(jpipe, tpipe)
    for arr in frames(2, SIZE + 24):
        jout = jax_frame(jrt, arr)
        assert_f32_close(jrt, trt, jout, trt.process_frame(arr))


@pytest.mark.parametrize("mode", ["none", "rcfg-self"])
def test_frames_match_jax_bf16(mode):
    """The preset's bf16 model: a keyframe and a temporal frame, latents and
    pixels within rel-L2 3e-2 of the JAX stream's."""
    jpipe, tpipe = build_stream_pair(False, cfg_mode=mode if mode != "none" else "batched")
    jrt, trt = sessions(jpipe, tpipe, negative_prompt=None if mode == "none" else NEG)
    for arr in frames(2):
        jout = jax_frame(jrt, arr)
        tout = trt.process_frame(arr)
        assert rel_l2(trt.prev_latent.float().numpy(), np.asarray(jrt.prev_latent,
                                                                  np.float32)) < 3e-2
        assert rel_l2(tout, jout) < 3e-2
