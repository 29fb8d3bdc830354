"""The port's tiny VAE pair (``models/tiny_vae.py``) and its conv path against
the JAX package.

- goldens ``tiny_vae.decoded`` / ``tiny_vae.encoded`` (the JAX init's seed-0
  weights, f32, the golden tolerance 3e-2);
- f32 parity on numpy trees at even and odd sizes (1e-4 relative, as the
  module parity of ``test_torch_models.py``);
- the trained artifacts read by the port's own loader against the JAX
  ``load`` / ``load_encoder``: the same config, the same bf16 weights, and
  outputs on the same input within TINY_ULPS bf16 ulps of max|ref| (both run
  a chain of bf16 convs whose f32 sums round to bf16 at every layer, in
  other orders);
- the stride-2 SAME conv against ``jax.lax.conv_general_dilated`` (XLA pads
  0 before and 1 after on an even size);
- the pipeline: random init with the JAX warning, the loaders and their
  checks, the full-VAE fallback, and a tiny-decoder edit against JAX's.
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import test_torch_pipeline as tp
from qwen_image_edit_streamdiffusion_tpu.core.config import get_preset
from qwen_image_edit_streamdiffusion_tpu.core.rng import key_from_seed
from qwen_image_edit_streamdiffusion_tpu.core.rng import stream as jax_stream
from qwen_image_edit_streamdiffusion_tpu.models import tiny_vae as jtv
from qwen_image_edit_streamdiffusion_tpu_torch.models import tiny_vae as tv
from qwen_image_edit_streamdiffusion_tpu_torch.models.common import conv2d
from qwen_image_edit_streamdiffusion_tpu_torch.models.convert import from_jax
from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import edit_pipeline as tep

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = dict(np.load(os.path.join(ROOT, "tests", "goldens", "tiny_goldens.npz")))
DECODER = os.path.join(ROOT, "artifacts", "tiny_decoder_bench-2b.safetensors")
ENCODER = os.path.join(ROOT, "artifacts", "tiny_encoder_bench-2b.safetensors")
VAE = get_preset("tiny").vae  # f32
TINY_ULPS = 4  # measured: 2 ulps, decoder and encoder


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, rel=1e-4):
    got = np.asarray(torch.as_tensor(got).float(), np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()))


def test_tiny_goldens():
    """``verify_parity``'s tiny pair: the JAX init of stream "tiny_vae" /
    "tiny_enc" from seed 0, bridged, on its seeded inputs."""
    key = key_from_seed(0)
    dcfg = jtv.TinyDecoderConfig.from_vae(VAE)
    ecfg = jtv.TinyEncoderConfig.from_vae(VAE)
    dparams = from_jax(_np(jtv.init(jax_stream(key, "tiny_vae"), dcfg)), dcfg)
    eparams = from_jax(_np(jtv.encoder_init(jax_stream(key, "tiny_enc"), ecfg)), ecfg)
    z = torch.from_numpy(_rng(7).standard_normal((1, 4, 4, 16)).astype(np.float32))
    img = torch.from_numpy(_rng(6).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32))
    tol = dict(atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(tv.decode(dparams, tv.TinyDecoderConfig.from_vae(VAE), z),
                               GOLDENS["tiny_vae.decoded"], **tol)
    np.testing.assert_allclose(tv.encode(eparams, tv.TinyEncoderConfig.from_vae(VAE), img),
                               GOLDENS["tiny_vae.encoded"], **tol)


@pytest.mark.parametrize("hw", [(4, 4), (5, 7)])
def test_decoder_matches_jax_f32(hw):
    cfg = jtv.TinyDecoderConfig.from_vae(VAE, width=16)
    jparams = tp._numpy_tree(jtv.init, cfg, 5)
    z = _rng(8).standard_normal((2, *hw, 16)).astype(np.float32)
    want = jax.jit(jtv.decode, static_argnums=1)(jparams, cfg, jnp.asarray(z))
    got = tv.decode(from_jax(jparams, cfg), tv.TinyDecoderConfig(**dataclasses.asdict(cfg)),
                    torch.from_numpy(z))
    _close(got, want)


@pytest.mark.parametrize("hw", [(32, 32), (36, 44), (30, 26)])
def test_encoder_matches_jax_f32(hw):
    """Even and odd sizes at every stride-2 stage (44 → 22 → 11 → 6)."""
    cfg = jtv.TinyEncoderConfig.from_vae(VAE, width=16)
    jparams = tp._numpy_tree(jtv.encoder_init, cfg, 6)
    img = _rng(9).uniform(-1, 1, (2, *hw, 3)).astype(np.float32)
    want = jax.jit(jtv.encode, static_argnums=1)(jparams, cfg, jnp.asarray(img))
    got = tv.encode(from_jax(jparams, cfg), tv.TinyEncoderConfig(**dataclasses.asdict(cfg)),
                    torch.from_numpy(img))
    _close(got, want)


@pytest.mark.parametrize("size", [8, 9, 15, 16])
@pytest.mark.parametrize("k", [1, 3])
def test_stride2_same_conv_matches_xla(size, k):
    x = _rng(size).standard_normal((1, size, size + 1, 8)).astype(np.float32)
    w = _rng(k).standard_normal((k, k, 8, 4)).astype(np.float32) * 0.3
    b = _rng(2).standard_normal((4,)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    got = conv2d({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                 torch.from_numpy(x), stride=2)
    _close(got, want, rel=1e-5)


def _ulps_limit(ref) -> float:
    return TINY_ULPS * 2.0 ** (math.floor(math.log2(float(np.abs(ref).max()))) - 7)


@pytest.mark.parametrize("which", ["decoder", "encoder"])
def test_artifacts_load_and_match_jax(which):
    """The repo's trained bf16 artifacts (42 tensors each) through both
    loaders: configs and weights equal, outputs within TINY_ULPS bf16 ulps
    at max|ref|."""
    if which == "decoder":
        jparams, jcfg = jtv.load(DECODER)
        params, cfg = tv.load(DECODER)
        x = _rng(10).standard_normal((1, 8, 6, 16)).astype(np.float32)
        want = np.asarray(jax.jit(jtv.decode, static_argnums=1)(
            jparams, jcfg, jnp.asarray(x)), np.float32)
        got = tv.decode(params, cfg, torch.from_numpy(x)).float().numpy()
    else:
        jparams, jcfg = jtv.load_encoder(ENCODER)
        params, cfg = tv.load_encoder(ENCODER)
        x = _rng(11).uniform(-1, 1, (1, 64, 48, 3)).astype(np.float32)
        want = np.asarray(jax.jit(jtv.encode, static_argnums=1)(
            jparams, jcfg, jnp.asarray(x)), np.float32)
        got = tv.encode(params, cfg, torch.from_numpy(x)).float().numpy()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    flat_j = {jax.tree_util.keystr(p): np.asarray(a, np.float32)
              for p, a in jax.tree_util.tree_leaves_with_path(jparams)}
    flat_t = {jax.tree_util.keystr(p): a.float().numpy()
              for p, a in jax.tree_util.tree_leaves_with_path(params)}
    assert len(flat_t) == 42 and flat_t.keys() == flat_j.keys()
    for k in flat_j:
        np.testing.assert_array_equal(flat_t[k], flat_j[k])
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= _ulps_limit(want)


def test_encoder_loader_refuses_a_decoder():
    with pytest.raises(ValueError, match="not a tiny ENCODER"):
        tv.load_encoder(DECODER)


@pytest.mark.parametrize("edit", ["missing", "unused", "shape"])
def test_from_jax_rejects_mismatched_tiny_trees(edit):
    cfg = jtv.TinyDecoderConfig.from_vae(VAE, width=16)
    jparams = tp._numpy_tree(jtv.init, cfg, 5)
    stage = jparams["stages"][1]
    if edit == "missing":
        del stage["up"]
    elif edit == "unused":
        stage["extra"] = {"w": np.zeros((3, 3, 16, 16), np.float32)}
    else:
        stage["up"]["b"] = np.zeros((3,), np.float32)
    with pytest.raises(ValueError, match=edit):
        from_jax(jparams, cfg)


def test_pipeline_tiny_options():
    """decoder="tiny" without an artifact: random init with the JAX warning;
    the loaders switch the config and check the latent grid; a tiny decoder
    config with none loaded decodes with the full VAE, warning."""
    with pytest.warns(UserWarning, match="random-init tiny decoder"):
        p = tep.EditPipeline.create("tiny", tp._config(decoder="tiny"), seed=0,
                                    device="cpu")
    assert p.tiny_vae is not None and p.tiny_vae[1].width == 64
    with pytest.warns(UserWarning, match="random-init tiny encoder"):
        q = tep.EditPipeline.create("tiny", tp._config(encoder="tiny"), seed=0,
                                    device="cpu")
    assert q.tiny_encoder is not None and q.tiny_vae is None
    q.load_tiny_decoder(DECODER)
    q.load_tiny_encoder(ENCODER)
    assert (q.config.decoder, q.config.encoder) == ("tiny", "tiny")
    out = q(tp._images(1)[0], tp.PROMPT, num_inference_steps=1)
    assert out.images[0].shape == (tp.SIZE, tp.SIZE, 3)
    q.tiny_vae = None
    with pytest.warns(UserWarning, match="falling back to the full VAE"):
        q(tp._images(1)[0], tp.PROMPT, num_inference_steps=1)
    bad = dataclasses.replace(q.preset, vae=dataclasses.replace(q.preset.vae,
                                                                latent_channels=8))
    q.preset = bad
    with pytest.raises(ValueError, match="latent grid"):
        q.load_tiny_decoder(DECODER)


def test_tiny_decoder_edit_matches_jax():
    """A tiny-preset edit decoded by the trained tiny decoder (bf16) in both
    packages, f32 MMDiT, VL and VAE: the latents within 1e-3 as the f32
    slice, pixels within 2 codes (the tiny decoder's bf16 chain)."""
    jpipe, tpipe = tp.build_pair(True)
    jparams, jcfg = jtv.load(DECODER)
    jpipe.tiny_vae = (jparams, jcfg)
    jpipe.config = jpipe.config.replace(decoder="tiny")
    tpipe.load_tiny_decoder(DECODER)
    img = tp._images(1)[0]
    jres = jpipe(Image.fromarray(img), tp.PROMPT, num_inference_steps=2, seed=42)
    tres = tpipe(img, tp.PROMPT, num_inference_steps=2, seed=42)
    assert np.abs(tres.latents.numpy() - np.asarray(jres.latents)).max() < 1e-3
    diff = tres.images[0].astype(np.int32) - np.asarray(jres.images[0]).astype(np.int32)
    assert np.abs(diff).max() <= 2
