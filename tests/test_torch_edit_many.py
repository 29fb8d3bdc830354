"""Batched requests against the JAX package at `tiny`: the VL encoder's wave
(``encode_many``: shared and batched vision, batched LM rows),
``num_images_per_prompt`` and ``edit_many``.

Weights are numpy trees bridged with ``convert.from_jax`` (f32, held at 1e-4
relative like the module parity of ``test_torch_models.py``, or, end to end,
latents within 1e-3 max-abs and pixels within one code, as
``test_slice_matches_jax_f32``). The golden ``vl.hidden_many`` takes the
preset's bf16 and the JAX init's own weights, at the golden tolerance 3e-2
(``verify_parity``).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import test_torch_pipeline as tp
from qwen_image_edit_streamdiffusion_tpu.core.config import get_preset
from qwen_image_edit_streamdiffusion_tpu.models import qwen_vl as jvl
from qwen_image_edit_streamdiffusion_tpu_torch.models import qwen_vl as vl
from qwen_image_edit_streamdiffusion_tpu_torch.models.convert import from_jax
from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import edit_pipeline as tep

torch.set_num_threads(2)

GOLDENS = dict(np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                    "tiny_goldens.npz")))
VL32 = dataclasses.replace(get_preset("tiny").vl, dtype="float32")
NEG = "blurry, low quality"


def _close(got, want, rel=1e-4):
    got = np.asarray(torch.as_tensor(got).float(), np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()))


def test_hidden_many_golden():
    """``vl.hidden_many``: two requests on one image, one batched LM call,
    as ``verify_parity`` computes it (the JAX init's seed-0 weights, bf16,
    max_len 64)."""
    cfg = get_preset("tiny").vl
    jparams = jvl.init_jit(jax.random.PRNGKey(0), cfg)
    params = from_jax(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                             jparams), cfg)
    enc = vl.QwenVLEncoder(cfg, params, device="cpu", max_len=64)
    vimg = np.random.default_rng(8).integers(0, 255, (64, 64, 3)).astype(np.uint8)
    embs = enc.encode_many([("make it a watercolor painting", (vimg,)),
                            ("replace the sky with stars", (vimg,))])
    got = np.stack([e.embeds.float().numpy() for e in embs])
    np.testing.assert_allclose(got, GOLDENS["vl.hidden_many"], atol=3e-2, rtol=3e-2)


@pytest.fixture(scope="module")
def vl_pair():
    jparams = tp._numpy_tree(jvl._init_all, VL32, 3)
    jenc = jvl.QwenVLEncoder(VL32, params=jparams, max_len=VL32.max_text_len)
    enc = vl.QwenVLEncoder(VL32, from_jax(jparams, VL32), device="cpu",
                           max_len=VL32.max_text_len)
    return jenc, enc


def test_encode_many_wave_matches_jax(vl_pair, monkeypatch):
    """A 4-request wave: two distinct images of one grid (one batched vision
    call of 2 images), a third request sharing the first image and a fourth
    whose 80-word prompt lands in the next 128-token LM bucket. All four
    share their vision starts, so they run as one batched LM call, padded
    to the longest bucket (the JAX package runs the fourth alone). Row for
    row against the JAX ``encode_many``, and each row equal to its own
    one-request encode."""
    jenc, enc = vl_pair
    rng = np.random.default_rng(4)
    a, b = (rng.integers(0, 256, (60, 80, 3), np.uint8) for _ in range(2))
    long = " ".join(f"w{i}" for i in range(80))
    wave = [("make it a watercolor painting", [a]), ("replace the sky", [b]),
            ("add a red hat to the person in the picture", [a]), (long, [a])]
    calls = {"vision": [], "lm": []}
    real_v, real_lm = vl.vision_forward, vl.lm_forward

    def vision(params, cfg, patches, gh, gw):
        calls["vision"].append(tuple(patches.shape[:-1]))
        return real_v(params, cfg, patches, gh, gw)

    def lm(params, cfg, emb, *args, **kw):
        calls["lm"].append(tuple(emb.shape[:2]))
        return real_lm(params, cfg, emb, *args, **kw)

    monkeypatch.setattr(vl, "vision_forward", vision)
    monkeypatch.setattr(vl, "lm_forward", lm)
    got = enc.encode_many(wave)
    assert len(calls["vision"]) == 1 and calls["vision"][0][0] == 2
    assert calls["lm"] == [(4, 256)]
    want = jenc.encode_many(wave)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.mask, np.asarray(w.mask))
        _close(g.embeds, w.embeds)
    monkeypatch.undo()
    for g, (prompt, imgs) in zip(got, wave):
        _close(g.embeds, enc.encode(prompt, imgs).embeds, rel=1e-5)


def test_batched_vision_matches_one_by_one(vl_pair):
    """Two images of one grid through ``vision_forward`` at B = 2 equal each
    image alone."""
    _, enc = vl_pair
    rng = np.random.default_rng(9)
    imgs = [rng.integers(0, 256, (112, 84, 3), np.uint8) for _ in range(2)]
    patches = torch.stack([vl.patches_from_image(torch.from_numpy(i), VL32, 8, 6)
                           for i in imgs])
    both = vl.vision_forward(enc.params["vision"], VL32, patches, 8, 6)
    for row in range(2):
        _close(both[row], vl.vision_forward(enc.params["vision"], VL32,
                                            patches[row], 8, 6), rel=1e-5)


@pytest.fixture(scope="module")
def f32_pair():
    return tp.build_pair(True)


def _assert_results_close(jress, tress):
    assert len(jress) == len(tress)
    for jres, tres in zip(jress, tress):
        jl = np.asarray(jres.latents, np.float32)
        assert tres.latents.shape == jl.shape
        assert np.abs(tres.latents.numpy() - jl).max() < 1e-3
        assert len(tres.images) == len(jres.images)
        for jimg, timg in zip(jres.images, tres.images):
            assert timg.shape == (tp.SIZE, tp.SIZE, 3) and timg.dtype == np.uint8
            diff = timg.astype(np.int32) - np.asarray(jimg).astype(np.int32)
            assert np.abs(diff).max() <= 1


@pytest.mark.parametrize("mode", ["rcfg-self", "batched"])
def test_num_images_per_prompt_matches_jax(f32_pair, mode):
    """Two variations of one guided edit in one denoise call (per-row
    noise, shared conditioning), through ``edit_many`` in both packages."""
    jpipe, tpipe = f32_pair
    for p in (jpipe, tpipe):
        p.config = p.config.replace(cfg_mode=mode)
    img = tp._images(1)[0]
    kw = dict(negative_prompt=NEG, true_cfg_scale=4.0, num_inference_steps=2,
              seed=7, num_images_per_prompt=2)
    jres = jpipe(Image.fromarray(img), tp.PROMPT, **kw)
    tres = tpipe(img, tp.PROMPT, **kw)
    assert len(tres.images) == 2
    assert not np.array_equal(tres.images[0], tres.images[1])
    _assert_results_close([jres], [tres])


def test_edit_many_matches_jax(f32_pair, monkeypatch):
    """Two items with distinct images under batched CFG (4 forward rows):
    one prompt-encode wave, one batched condition encode of both images,
    one denoise, one decode, results split per item."""
    jpipe, tpipe = f32_pair
    for p in (jpipe, tpipe):
        p.config = p.config.replace(cfg_mode="batched")
    rng = np.random.default_rng(11)
    imgs = [rng.integers(0, 256, (tp.SIZE + 24, tp.SIZE + 24, 3), np.uint8)
            for _ in range(2)]
    items = [{"image": imgs[0], "prompt": tp.PROMPT, "negative_prompt": NEG,
              "seed": 3},
             {"image": [imgs[1]], "prompt": "replace the sky with stars",
              "negative_prompt": NEG, "seed": 4}]
    batches = []
    real = tpipe._encode_pixels
    monkeypatch.setattr(tpipe, "_encode_pixels",
                        lambda arrays: batches.append(len(arrays)) or real(arrays))
    tress = tpipe.edit_many(items, num_inference_steps=2)
    assert batches == [2]
    jitems = [{**it, "image": [Image.fromarray(i) for i in tep._images_of(it["image"])]}
              for it in items]
    jress = jpipe.edit_many(jitems, num_inference_steps=2)
    _assert_results_close(jress, tress)
    # a repeat hits the latent cache: no encode at all
    tpipe.edit_many(items, num_inference_steps=2)
    assert batches == [2]


def test_edit_many_refuses_mixed_geometry(f32_pair):
    _, tpipe = f32_pair
    img = tp._images(1)[0]
    items = [{"image": img, "prompt": tp.PROMPT, "negative_prompt": NEG},
             {"image": img, "prompt": tp.PROMPT}]
    with pytest.raises(ValueError, match="CFG-ness"):
        tpipe.edit_many(items, num_inference_steps=2, true_cfg_scale=4.0)
