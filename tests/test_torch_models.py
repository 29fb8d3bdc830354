"""The port's models against their JAX twins on the same weights.

JAX-layout `tiny` param trees are bridged with ``convert.from_jax``. Module
parity runs in f32 (the preset's dtypes replaced) at 1e-4 relative: the same
algorithm in f32 on the CPU, summed in other orders. To keep the file fast the
parity trees are filled with numpy (Kaiming-uniform scales) in the structure
``jax.eval_shape`` gives for the JAX init, and the JAX forwards are jitted.
The checked-in transformer golden (the preset's own bf16, the JAX init's own
weights) is held at the repo's golden tolerance (3e-2, ``verify_parity``).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_image_edit_streamdiffusion_tpu.core.config import get_preset
from qwen_image_edit_streamdiffusion_tpu.core.rng import key_from_seed
from qwen_image_edit_streamdiffusion_tpu.core.rng import stream as jax_stream
from qwen_image_edit_streamdiffusion_tpu.models import qwen_vl as jvl
from qwen_image_edit_streamdiffusion_tpu.models import transformer as jtfm
from qwen_image_edit_streamdiffusion_tpu.models import vae as jvae
from qwen_image_edit_streamdiffusion_tpu_torch.models import qwen_vl as vl
from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm
from qwen_image_edit_streamdiffusion_tpu_torch.models import vae
from qwen_image_edit_streamdiffusion_tpu_torch.models.convert import from_jax
from qwen_image_edit_streamdiffusion_tpu_torch.models.optimize import fuse_qkv

torch.set_num_threads(2)

GOLDENS = dict(np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                    "tiny_goldens.npz")))
TINY = get_preset("tiny")
M32 = dataclasses.replace(TINY.model, dtype="float32")
VL32 = dataclasses.replace(TINY.vl, dtype="float32")


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _numpy_tree(init_fn, cfg, seed=0):
    """A tree shaped like ``init_fn(key, cfg)``, filled from numpy: weights
    uniform in ±1/sqrt(fan_in), 1-D leaves (biases, norm scales) around 1 ±
    0.1 for norms and ±0.1 for biases."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: init_fn(jax.random.PRNGKey(0), cfg))

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        if len(leaf.shape) == 1:
            base = 1.0 if name == "scale" else 0.0
            return (base + rng.uniform(-0.1, 0.1, leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return rng.uniform(-1, 1, leaf.shape).astype(np.float32) * fan_in ** -0.5

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, rel=1e-4):
    """|got − want| <= rel · (|want| + max|want|), elementwise."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# Transformer
# ---------------------------------------------------------------------------


def _tfm_inputs(cfg):
    img_shapes = ((1, 4, 4), (1, 4, 4))
    x = _rng(2).standard_normal((1, 32, cfg.in_channels)).astype(np.float32)
    txt = _rng(3).standard_normal((1, 16, cfg.joint_dim)).astype(np.float32)
    mask = np.ones((1, 16), bool)
    mask[:, 11:] = False
    return img_shapes, x, txt, mask


@pytest.mark.parametrize("fused", [False, True])
def test_transformer_forward_matches_jax(fused):
    jparams = _numpy_tree(jtfm.init, M32)
    img_shapes, x, txt, mask = _tfm_inputs(M32)
    t = np.asarray([500.0], np.float32)
    fwd = jax.jit(jtfm.forward, static_argnums=1, static_argnames="use_flash")
    want = fwd(jparams, M32, jnp.asarray(x), jnp.asarray(txt), jnp.asarray(t),
               jtfm.make_rope(M32, img_shapes, 16), txt_mask=jnp.asarray(mask),
               use_flash=False)
    params = from_jax(jparams, M32)
    if fused:
        params = fuse_qkv(params)
        assert "img_qkv" in params["blocks"][0]["attn"]
    got = tfm.forward(params, M32, torch.from_numpy(x), torch.from_numpy(txt),
                      torch.from_numpy(t), tfm.make_rope(M32, img_shapes, 16),
                      txt_mask=torch.from_numpy(mask), use_flash=True)
    _close(got, want)


def test_transformer_velocity_golden():
    """The preset's bf16 transformer on the golden's seeded weights/inputs."""
    cfg = TINY.model
    jparams = jtfm.init_jit(jax_stream(key_from_seed(0), "transformer"), cfg)
    img_shapes = ((1, 4, 4), (1, 4, 4))
    x = torch.from_numpy(_rng(2).standard_normal((1, 32, cfg.in_channels))
                         .astype(np.float32)).bfloat16()
    txt = torch.from_numpy(_rng(3).standard_normal((1, 16, cfg.joint_dim))
                           .astype(np.float32)).bfloat16()
    got = tfm.forward(from_jax(_np(jparams), cfg), cfg, x, txt,
                      torch.tensor([500.0]), tfm.make_rope(cfg, img_shapes, 16),
                      use_flash=False)
    np.testing.assert_allclose(got.float().numpy(), GOLDENS["transformer.velocity"],
                               atol=3e-2, rtol=3e-2)


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vae_params():
    jparams = _numpy_tree(jvae.init, TINY.vae)
    return jparams, from_jax(jparams, TINY.vae)


_VAE_ENCODE = jax.jit(jvae.encode_moments, static_argnums=1)
_VAE_DECODE = jax.jit(jvae.decode, static_argnums=1)


def test_vae_encode_decode_match_jax(vae_params):
    jparams, params = vae_params
    cfg = TINY.vae  # f32
    img = _rng(6).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    z = _rng(7).standard_normal((1, 4, 4, cfg.latent_channels)).astype(np.float32)
    want = np.asarray(_VAE_ENCODE(jparams, cfg, jnp.asarray(img)))
    _close(vae.encode_moments(params, cfg, torch.from_numpy(img)), want)
    # posterior mode, normalized with the per-channel latent statistics
    mu = want[..., :cfg.latent_channels]
    _close(vae.encode(params, cfg, torch.from_numpy(img)),
           (mu - np.asarray(cfg.latents_mean)) / np.asarray(cfg.latents_std))
    _close(vae.decode(params, cfg, torch.from_numpy(z)),
           _VAE_DECODE(jparams, cfg, jnp.asarray(z)))


def test_vae_at_edit_shape_matches_jax(vae_params):
    """A 64×48 image exercises the chunked mid-block attention boundary and
    non-square grids."""
    jparams, params = vae_params
    cfg = TINY.vae
    img = _rng(8).uniform(-1, 1, (1, 64, 48, 3)).astype(np.float32)
    _close(vae.encode_moments(params, cfg, torch.from_numpy(img)),
           _VAE_ENCODE(jparams, cfg, jnp.asarray(img)))


# ---------------------------------------------------------------------------
# Qwen2.5-VL
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vl_params():
    jparams = _numpy_tree(jvl._init_all, VL32)
    return jparams, from_jax(jparams, VL32)


def test_vision_forward_matches_jax(vl_params):
    jparams, params = vl_params
    img = _rng(9).integers(0, 256, (112, 84, 3)).astype(np.uint8)
    gh, gw = 8, 6  # 112/14, 84/14; windows of 8 patches: ragged edge windows
    jpatch = jvl.patches_from_image(jnp.asarray(img), VL32, gh, gw)
    want = jax.jit(jvl.vision_forward, static_argnums=(1, 3, 4))(
        jparams["vision"], VL32, jpatch, gh, gw)
    patches = vl.patches_from_image(torch.from_numpy(img), VL32, gh, gw)
    _close(vl.vision_forward(params["vision"], VL32, patches, gh, gw), want)


def test_lm_forward_matches_jax(vl_params):
    jparams, params = vl_params
    l = 40
    emb = _rng(10).standard_normal((l, VL32.hidden_size)).astype(np.float32)
    pos = np.stack([np.arange(l)] * 3)
    cos, sin = vl._mrope_tables(VL32, pos)
    mask = np.arange(l) < 33  # suffix padding
    lm = jax.jit(jvl.lm_forward, static_argnums=1, static_argnames="use_flash")
    want = lm(jparams["lm"], VL32, jnp.asarray(emb), jnp.asarray(cos),
              jnp.asarray(sin), jnp.asarray(mask), use_flash=False)
    got = vl.lm_forward(params["lm"], VL32, torch.from_numpy(emb),
                        torch.from_numpy(cos), torch.from_numpy(sin),
                        torch.from_numpy(mask), use_flash=True)
    _close(got[:33], np.asarray(want)[:33])


def test_encode_matches_jax(vl_params):
    """Chat template, bucketing, vision splice, LM and the prefix drop: the
    embeddings and mask of one request with an image off the VL grid, so
    both sides run the smart-resize (BICUBIC)."""
    jparams, params = vl_params
    img = _rng(11).integers(0, 256, (50, 90, 3)).astype(np.uint8)
    jenc = jvl.QwenVLEncoder(VL32, params=jparams, max_len=VL32.max_text_len)
    enc = vl.QwenVLEncoder(VL32, params, device="cpu", max_len=VL32.max_text_len)
    want = jenc.encode("make it a watercolor painting", [img])
    got = enc.encode("make it a watercolor painting", [img])
    np.testing.assert_array_equal(got.mask, np.asarray(want.mask))
    _close(got.embeds, want.embeds)
    many = enc.encode_many([("make it a watercolor painting", [img]),
                            ("replace the sky with stars", [img])])
    torch.testing.assert_close(many[0].embeds, got.embeds)
    assert many[1].embeds.shape[1] == VL32.hidden_size


# ---------------------------------------------------------------------------
# Bridge
# ---------------------------------------------------------------------------


def test_from_jax_layouts():
    jparams = _numpy_tree(jtfm.init, M32)
    params = from_jax(jparams, M32)
    w = jparams["blocks"][0]["attn"]["img_q"]["w"]
    np.testing.assert_array_equal(
        params["blocks"][0]["attn"]["img_q"]["weight"].numpy(), w.T)
    jv = _numpy_tree(jvae.init, TINY.vae)
    v = from_jax(jv, TINY.vae)
    np.testing.assert_array_equal(v["encoder"]["conv_in"]["w"].numpy(),
                                  jv["encoder"]["conv_in"]["w"])  # HWIO kept


@pytest.mark.parametrize("edit", ["missing", "unused", "shape"])
def test_from_jax_rejects_mismatched_trees(edit):
    jparams = _numpy_tree(jtfm.init, M32)
    blk = jparams["blocks"][0]
    if edit == "missing":
        del blk["img_mod"]
    elif edit == "unused":
        blk["extra"] = {"w": np.zeros((4, 4), np.float32)}
    else:
        blk["img_mod"]["b"] = np.zeros((3,), np.float32)
    with pytest.raises(ValueError, match=edit):
        from_jax(jparams, M32)
