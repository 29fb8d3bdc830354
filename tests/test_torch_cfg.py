"""The port's guided edits against the JAX pipeline at `tiny`: every
``cfg_mode``, the rcfg-self → rcfg fallback, and positive and negative
prompts in different text buckets (the padding path).

One JAX pipeline and one port pipeline per module, on the same numpy trees
bridged with ``convert.from_jax``, the port drawing the JAX noise; the mode is
switched on both live pipelines with ``config.replace(cfg_mode=...)``. f32:
final latents within 1e-3 max-abs and pixels within one code, as
``test_slice_matches_jax_f32``; bf16: rel-L2 3e-2, as the cond-only bf16
slice.
"""

import warnings

import numpy as np
import pytest
import torch
from PIL import Image

import test_torch_pipeline as tp
from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import edit_pipeline as tep
from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

torch.set_num_threads(2)

NEG = "blurry, low quality"
# sixty words: the negative's embedding lands in the next 64-token bucket
LONG_NEG = " ".join(f"word{i}" for i in range(60))
SCALE = 4.0


@pytest.fixture(scope="module")
def f32_pair():
    return tp.build_pair(True)


def _edit(jpipe, tpipe, mode, img, negative_prompt=NEG, **kw):
    """The same guided edit through both pipelines in ``mode``."""
    for p in (jpipe, tpipe):
        p.config = p.config.replace(cfg_mode=mode)
    jres = jpipe(Image.fromarray(img), tp.PROMPT, negative_prompt=negative_prompt,
                 true_cfg_scale=SCALE, num_inference_steps=2, seed=42, **kw)
    before = dict(kernels.LAUNCHES)
    tres = tpipe(img, tp.PROMPT, negative_prompt=negative_prompt,
                 true_cfg_scale=SCALE, num_inference_steps=2, seed=42, **kw)
    assert kernels.LAUNCHES == before  # CPU tensors never reach a kernel
    return jres, tres


def _assert_f32_close(jres, tres):
    jl = np.asarray(jres.latents, np.float32)
    tl = tres.latents.numpy()
    assert tl.shape == jl.shape and np.isfinite(tl).all()
    assert np.abs(tl - jl).max() < 1e-3
    for jimg, timg in zip(jres.images, tres.images):
        assert timg.dtype == np.uint8
        assert np.abs(timg.astype(np.int32) - np.asarray(jimg).astype(np.int32)).max() <= 1


@pytest.mark.parametrize("mode", ["none", "sequential", "batched", "parallel",
                                  "rcfg", "rcfg-self"])
def test_cfg_mode_matches_jax_f32(f32_pair, mode):
    """Each mode of the JAX ``_denoise_fn`` (``parallel`` without a cfg mesh
    axis is ``batched`` in both), a 2-step guided edit at scale 4."""
    jpipe, tpipe = f32_pair
    jres, tres = _edit(jpipe, tpipe, mode, tp._images(1)[0])
    _assert_f32_close(jres, tres)


def test_guidance_changes_the_edit(f32_pair):
    """Guided and cond-only outputs differ (the negative branch is used),
    and a scale of 1 is cond-only, as the upstream ``do_true_cfg``."""
    _, tpipe = f32_pair
    img = tp._images(1)[0]
    tpipe.config = tpipe.config.replace(cfg_mode="batched")
    guided = tpipe(img, tp.PROMPT, negative_prompt=NEG, true_cfg_scale=SCALE,
                   num_inference_steps=2, seed=42)
    plain = tpipe(img, tp.PROMPT, num_inference_steps=2, seed=42)
    one = tpipe(img, tp.PROMPT, negative_prompt=NEG, true_cfg_scale=1.0,
                num_inference_steps=2, seed=42)
    assert torch.abs(guided.latents - plain.latents).max() > 1e-3
    torch.testing.assert_close(one.latents, plain.latents, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["batched", "sequential"])
def test_prompts_in_different_text_buckets_match_jax(f32_pair, mode):
    """A negative prompt whose embedding lands in a longer 64-token bucket:
    the positive text is padded with zero rows and a False mask to it, so
    the two rows carry different masks."""
    jpipe, tpipe = f32_pair
    img = tp._images(1)[0]
    vl = tpipe._prepare_images([img], None, None)[3]
    pos, neg = tpipe.prompt_cache.encode_many([(tp.PROMPT, vl), (LONG_NEG, vl)])
    assert pos.embeds.shape[0] < neg.embeds.shape[0]  # different buckets
    jres, tres = _edit(jpipe, tpipe, mode, img, negative_prompt=LONG_NEG)
    _assert_f32_close(jres, tres)


def test_rcfg_self_falls_back_to_rcfg_like_jax(f32_pair):
    """A 224×160 condition under a 224² target: no anchor on the target
    grid, so both packages warn and run rcfg."""
    jpipe, tpipe = f32_pair
    img = np.random.default_rng(5).integers(0, 256, (224, 160, 3), np.uint8)
    with pytest.warns(UserWarning, match="onetime-negative rcfg"):
        jres, tres = _edit(jpipe, tpipe, "rcfg-self", img)
    _assert_f32_close(jres, tres)


def test_rcfg_self_runs_no_negative_forward(f32_pair, monkeypatch):
    """rcfg-self costs a cond-only edit's forwards (one a step, one row);
    rcfg one batched pair first, then one row a step; sequential two a
    step; batched one two-row forward a step."""
    _, tpipe = f32_pair
    rows = []
    real = tep.tfm.forward

    def counting(params, cfg, img, *a, **kw):
        rows.append(img.shape[0])
        return real(params, cfg, img, *a, **kw)

    monkeypatch.setattr(tep.tfm, "forward", counting)
    img = tp._images(1)[0]
    want = {"rcfg-self": [1, 1], "rcfg": [2, 1], "sequential": [1, 1, 1, 1],
            "batched": [2, 2], "none": [1, 1]}
    for mode, expect in want.items():
        rows.clear()
        tpipe.config = tpipe.config.replace(cfg_mode=mode)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            tpipe(img, tp.PROMPT, negative_prompt=NEG, true_cfg_scale=SCALE,
                  num_inference_steps=2, seed=42)
        assert rows == expect, mode


def test_unknown_cfg_mode_raises(f32_pair):
    _, tpipe = f32_pair
    tpipe.config = tpipe.config.replace(cfg_mode="bogus")
    try:
        with pytest.raises(ValueError, match="unknown cfg_mode"):
            tpipe(tp._images(1)[0], tp.PROMPT, negative_prompt=NEG,
                  true_cfg_scale=SCALE, num_inference_steps=2, seed=42)
    finally:
        tpipe.config = tpipe.config.replace(cfg_mode="batched")


def test_batched_cfg_matches_jax_bf16():
    """The preset's own dtypes (bf16 MMDiT and VL): final latents within
    rel-L2 3e-2, the cond-only bf16 slice's limit."""
    jpipe, tpipe = tp.build_pair(False)
    jres, tres = _edit(jpipe, tpipe, "batched", tp._images(1)[0])
    rel = tp._rel_l2(jres, tres)
    assert rel < 3e-2, rel


def test_warmup_serves_cond_only_then_guided(f32_pair, monkeypatch):
    """``warmup(cfg=True)``: the cond-only request ``runs`` times on a gray
    image, then the server's ``use_cfg`` request (negative prompt "") and
    one more cond-only call, as the JAX ``warmup``."""
    _, tpipe = f32_pair
    tpipe.config = tpipe.config.replace(cfg_mode="batched")
    calls = []
    real = tep.EditPipeline.__call__

    def spy(self, image, prompt, negative_prompt=None, **kw):
        calls.append((image.shape, int(image.min()), int(image.max()), negative_prompt))
        return real(self, image, prompt, negative_prompt=negative_prompt, **kw)

    monkeypatch.setattr(tep.EditPipeline, "__call__", spy)
    seconds = tpipe.warmup(steps=1, runs=2, cfg=True)
    gray = ((tp.SIZE, tp.SIZE, 3), 128, 128)
    assert calls == [gray + (None,), gray + (None,), gray + ("",), gray + (None,)]
    assert seconds > 0
