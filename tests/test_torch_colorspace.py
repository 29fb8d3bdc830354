"""The port's yuv420 wire (``ops/colorspace.py``) against the JAX package.

- the device conversions in f32 against the JAX functions: the packed uint8
  bytes exactly; the unpacked f32 RGB exactly against eager JAX and within
  1e-4 of the jitted function (XLA's CPU backend contracts its products
  into FMAs);
- the host pack and unpack against the JAX package's native library, byte
  for byte (the comparison skips, saying so, where that library cannot be
  built), and within one code of its Pillow fallback, whose rounding
  differs;
- a ``transfer_format="yuv420"`` edit at `tiny` against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import test_torch_pipeline as tp
from qwen_image_edit_streamdiffusion_tpu.ops import colorspace as jcs
from qwen_image_edit_streamdiffusion_tpu.runtime import native_ops
from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm
from qwen_image_edit_streamdiffusion_tpu_torch.ops import colorspace as cs

torch.set_num_threads(2)


def _rgb_images():
    """A noisy image, a smooth gradient and saturated corners."""
    rng = np.random.default_rng(0)
    noisy = rng.integers(0, 256, (64, 96, 3), np.uint8)
    y, x = np.mgrid[0:48, 0:80]
    grad = np.stack([y * 5, x * 3, 255 - x * 3], -1).clip(0, 255).astype(np.uint8)
    sat = np.zeros((16, 16, 3), np.uint8)
    sat[::2, ::3] = 255
    sat[1::2, :, 2] = 255
    return {"noisy": noisy, "gradient": grad, "saturated": sat}


IMAGES = _rgb_images()


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 64, 96), (1, 30, 18)])
def test_rgb_to_yuv420_matches_jax(shape):
    """Unrounded pixel values, as the decode feeds them, a little outside
    [0, 255] too: the packed bytes equal the eager and the jitted JAX."""
    x = np.random.default_rng(1).uniform(-5, 260, shape + (3,)).astype(np.float32)
    got = cs.rgb_to_yuv420(torch.from_numpy(x)).numpy()
    assert got.dtype == np.uint8 and got.shape == (shape[0], shape[1] // 2, shape[2] // 2, 6)
    for fn in (jcs.rgb_to_yuv420, jax.jit(jcs.rgb_to_yuv420)):
        np.testing.assert_array_equal(got, np.asarray(fn(jnp.asarray(x))))


def test_yuv420_to_rgb_matches_jax():
    p = np.random.default_rng(2).integers(0, 256, (2, 32, 48, 6), np.uint8)
    got = cs.yuv420_to_rgb(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcs.yuv420_to_rgb(jnp.asarray(p))))
    jitted = np.asarray(jax.jit(jcs.yuv420_to_rgb)(jnp.asarray(p)))
    assert np.abs(got - jitted).max() <= 1e-4


def _native_or_skip():
    if native_ops.yuv420_pack(np.zeros((2, 2, 3), np.uint8)) is None:
        pytest.skip("the JAX package's native library cannot be built here, so "
                    "the byte comparison with it is skipped")


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_host_pack_and_unpack_match_native(name):
    _native_or_skip()
    img = IMAGES[name]
    packed = cs.pack_yuv420_host(img)
    np.testing.assert_array_equal(packed, native_ops.yuv420_pack(img))
    np.testing.assert_array_equal(cs.yuv420_to_rgb_host(packed),
                                  native_ops.yuv420_unpack(packed))
    rand = np.random.default_rng(3).integers(0, 256, packed.shape, np.uint8)
    np.testing.assert_array_equal(cs.yuv420_to_rgb_host(rand),
                                  native_ops.yuv420_unpack(rand))


def _pillow_pack(arr):
    """The JAX package's Pillow fallback of ``pack_yuv420_host``."""
    ycc = np.asarray(Image.fromarray(arr).convert("YCbCr"))
    h, w = ycc.shape[:2]
    y_blk = (ycc[..., 0].reshape(h // 2, 2, w // 2, 2).transpose(0, 2, 1, 3)
             .reshape(h // 2, w // 2, 4))
    c = ycc[..., 1:].astype(np.uint16)
    cavg = ((c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2] + c[1::2, 1::2] + 2)
            >> 2).astype(np.uint8)
    return np.concatenate([y_blk, cavg], axis=-1)


def _pillow_unpack(packed):
    """The JAX package's Pillow fallback of ``yuv420_to_rgb_image``."""
    h2, w2, _ = packed.shape
    y = packed[..., :4].reshape(h2, w2, 2, 2).transpose(0, 2, 1, 3).reshape(2 * h2, 2 * w2)
    up = np.repeat(np.repeat(packed[..., 4:], 2, axis=0), 2, axis=1)
    ycc = np.concatenate([y[..., None], up], axis=-1)
    return np.asarray(Image.fromarray(ycc, mode="YCbCr").convert("RGB"))


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_host_conversions_within_one_code_of_pillow(name):
    img = IMAGES[name]
    packed = cs.pack_yuv420_host(img)
    assert np.abs(packed.astype(int) - _pillow_pack(img).astype(int)).max() <= 1
    back = cs.yuv420_to_rgb_host(packed)
    assert back.shape == img.shape and back.dtype == np.uint8
    assert np.abs(back.astype(int) - _pillow_unpack(packed).astype(int)).max() <= 1


def test_device_and_host_agree():
    """The device unpack of a host pack, rounded, is within one code of the
    host unpack (float and fixed point round differently)."""
    img = IMAGES["noisy"]
    packed = cs.pack_yuv420_host(img)
    dev = cs.yuv420_to_rgb(torch.from_numpy(packed)[None])[0].numpy()
    host = cs.yuv420_to_rgb_host(packed).astype(np.float32)
    assert np.abs(np.floor(dev + 0.5) - host).max() <= 1


@pytest.mark.parametrize("mode", ["none", "batched"])
def test_yuv420_edit_matches_jax(mode):
    """An f32 tiny-preset edit with ``transfer_format="yuv420"`` on both
    sides (4:2:0 upload, packed decode, host unpack); the JAX side unpacks
    with its native library where it is built. Latents within 1e-3 as the
    f32 slice. The packed decode of the same latents within one code (XLA
    contracts the pixel epilogue's x·0.5 + 0.5 into an FMA, which moves a
    few packed values across a rounding boundary), so the unpacked pixels
    within two (one chroma code moves R or B by 1.402 or 1.772)."""
    jpipe, tpipe = tp.build_pair(True)
    for p in (jpipe, tpipe):
        p.config = p.config.replace(transfer_format="yuv420", cfg_mode=mode)
    img = tp._images(1)[0]
    neg = "blurry" if mode != "none" else None
    jres = jpipe(Image.fromarray(img), tp.PROMPT, negative_prompt=neg,
                 num_inference_steps=2, seed=42)
    tres = tpipe(img, tp.PROMPT, negative_prompt=neg, num_inference_steps=2, seed=42)
    assert np.abs(tres.latents.numpy() - np.asarray(jres.latents)).max() < 1e-3
    assert tres.images[0].shape == (tp.SIZE, tp.SIZE, 3)
    diff = tres.images[0].astype(np.int32) - np.asarray(jres.images[0]).astype(np.int32)
    assert np.abs(diff).max() <= 2
    zh = tp.SIZE // 8
    tokens = tfm.pack_latents(torch.from_numpy(np.array(jres.latents, np.float32)))
    jpacked = jpipe._vae_decode_fn((zh, zh))(jpipe._decode_params,
                                             jnp.asarray(tokens.numpy()))[0]
    tpacked = tpipe._decode(tokens, zh, zh)[0].numpy()
    assert tpacked.shape == (1, zh * 4, zh * 4, 6)
    assert np.abs(tpacked.astype(int) - np.asarray(jpacked).astype(int)).max() <= 1
    # the condition upload is the 4:2:0 round trip of the VAE image
    vae_img = tpipe._prepare_images([img], None, None)[2][0]
    up = tpipe._upload([vae_img])[0]
    packed = torch.from_numpy(cs.pack_yuv420_host(vae_img))[None]
    assert torch.equal(up, cs.yuv420_to_rgb(packed)[0])
    assert not torch.equal(up, torch.from_numpy(vae_img).float())
