"""The port's edit main path against the JAX pipeline, end to end at `tiny`.

Both pipelines get the same weights (JAX-layout trees filled from numpy,
bridged to the port with ``convert.from_jax``), the same initial noise (the
JAX ``x0`` injected into the port), and images off their target sizes, so
both sides resize (the JAX package with Pillow, the port with its own copy of
Pillow's resampling: the same bytes).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from qwen_image_edit_streamdiffusion_tpu.core.config import StreamConfig, get_preset
from qwen_image_edit_streamdiffusion_tpu.core.rng import key_from_seed
from qwen_image_edit_streamdiffusion_tpu.core.rng import stream as jax_stream
from qwen_image_edit_streamdiffusion_tpu.models import quantize as jquant
from qwen_image_edit_streamdiffusion_tpu.models import qwen_vl as jvl
from qwen_image_edit_streamdiffusion_tpu.models import transformer as jtfm
from qwen_image_edit_streamdiffusion_tpu.models import vae as jvae
from qwen_image_edit_streamdiffusion_tpu.pipeline import cache as jcache
from qwen_image_edit_streamdiffusion_tpu.pipeline import edit_pipeline as jep
from qwen_image_edit_streamdiffusion_tpu_torch.models.convert import from_jax
from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import edit_pipeline as tep
from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

torch.set_num_threads(2)

SIZE = 224  # a multiple of 32 (calculate_dimensions) and of 28 (VL patch·merge)
PROMPT = "make it a watercolor painting"


def _preset(f32: bool):
    p = get_preset("tiny")
    if f32:
        p = dataclasses.replace(
            p, model=dataclasses.replace(p.model, dtype="float32"),
            vl=dataclasses.replace(p.vl, dtype="float32"))
    return p


def _config(**kw):
    return StreamConfig(width=SIZE, height=SIZE, vae_image_area=SIZE * SIZE,
                        vl_image_area=SIZE * SIZE, num_inference_steps=2,
                        cfg_mode="none", model_preset="tiny", **kw)


def _numpy_tree(init_fn, cfg, seed):
    """A tree shaped like the JAX ``init_fn(key, cfg)``, filled from numpy:
    weights uniform in ±1/sqrt(fan_in), norm scales 1 ± 0.1, biases ±0.1
    (skips the JAX init's multi-second compile)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: init_fn(jax.random.PRNGKey(0), cfg))

    def fill(path, leaf):
        if len(leaf.shape) == 1:
            base = 1.0 if getattr(path[-1], "key", "") == "scale" else 0.0
            return (base + rng.uniform(-0.1, 0.1, leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return rng.uniform(-1, 1, leaf.shape).astype(np.float32) * fan_in ** -0.5

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_pipeline(preset, trees, quant_bits=None):
    """The JAX pipeline on the trees in the preset's dtypes; with quant_bits,
    its transformer and VL trees quantized by the JAX package (unfused, as a
    pre-quantized checkpoint is served)."""
    tfm_np, vae_np, vl_np = trees
    cast = lambda t, d: jax.tree_util.tree_map(lambda a: jax.numpy.asarray(a, d), t)
    tfm_p, vl_p = cast(tfm_np, preset.model.dtype), cast(vl_np, preset.vl.dtype)
    if quant_bits:
        tfm_p = jquant.quantize_transformer(tfm_p, bits=quant_bits)
        vl_p = jquant.quantize_vl(vl_p, bits=quant_bits)
    enc = jvl.QwenVLEncoder(preset.vl, params=vl_p, max_len=preset.vl.max_text_len)
    pipe = jep.EditPipeline(
        preset=preset, config=_config(fuse_qkv=False), tfm_params=tfm_p,
        vae_params=cast(vae_np, preset.vae.dtype), encoder=enc,
        prompt_cache=jcache.PromptCache(enc), latent_cache=jcache.LatentCache())
    return pipe, tfm_p, vl_p


def jax_noise(jpipe, dtype):
    """A stand-in for the port's ``_noise``: the JAX pipeline's noise for the
    same shape and seed, in the port's model dtype."""
    def noise(shape, seed):
        x = jpipe._noise_fn(tuple(shape))(jax_stream(key_from_seed(seed), "latents"))
        return torch.from_numpy(np.array(x, np.float32)).to(dtype)
    return noise


def build_pair(f32: bool, **port_config):
    """The JAX pipeline and the port's (on the CPU) on the same numpy
    trees, the port drawing the JAX noise. Returns (jpipe, tpipe)."""
    preset = _preset(f32)
    trees = (_numpy_tree(jtfm.init, preset.model, 0),
             _numpy_tree(jvae.init, preset.vae, 1),
             _numpy_tree(jvl._init_all, preset.vl, 2))
    jpipe = _jax_pipeline(preset, trees)[0]
    tpipe = tep.EditPipeline.from_weights(
        preset, _config(**port_config), from_jax(trees[0], preset.model),
        from_jax(trees[1], preset.vae), from_jax(trees[2], preset.vl),
        device="cpu")
    tpipe._noise = jax_noise(jpipe, getattr(torch, preset.model.dtype))
    return jpipe, tpipe


def _images(n: int):
    """n noisy images 40 pixels larger than SIZE², resized to it (LANCZOS)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (SIZE + 40, SIZE + 40, 3), np.uint8)
            for _ in range(n)]


def _run_both(f32: bool, monkeypatch, n_images: int = 1, bridge_bits=None,
              **port_config):
    """Both pipelines on one request. bridge_bits: the JAX side quantizes and
    the port takes its quantized trees through ``from_jax``; port_config:
    StreamConfig options of the port (e.g. use_int4, which makes the port
    fuse and quantize the dense trees itself)."""
    preset = _preset(f32)
    trees = (_numpy_tree(jtfm.init, preset.model, 0),
             _numpy_tree(jvae.init, preset.vae, 1),
             _numpy_tree(jvl._init_all, preset.vl, 2))
    jax_bits = bridge_bits or (4 if port_config.get("use_int4") else None)
    jpipe, jtfm_p, jvl_p = _jax_pipeline(preset, trees, jax_bits)
    imgs = _images(n_images)
    jres = jpipe([Image.fromarray(i) for i in imgs], PROMPT, num_inference_steps=2,
                 seed=42)
    zh = SIZE // 8
    x0 = jpipe._noise_fn((1, zh, zh, preset.vae.latent_channels))(
        jax_stream(key_from_seed(42), "latents"))

    tfm_tree, vl_tree = trees[0], trees[2]
    if bridge_bits:
        to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
        tfm_tree, vl_tree = to_np(jtfm_p), to_np(jvl_p)
    tpipe = tep.EditPipeline.from_weights(
        preset, _config(**port_config),
        from_jax(tfm_tree, preset.model), from_jax(trees[1], preset.vae),
        from_jax(vl_tree, preset.vl), device="cpu")
    mdt = getattr(torch, preset.model.dtype)
    monkeypatch.setattr(
        tpipe, "_noise",
        lambda shape, seed: torch.from_numpy(np.array(x0, np.float32)).to(mdt))
    before = dict(kernels.LAUNCHES)
    tres = tpipe(imgs if n_images > 1 else imgs[0], PROMPT, num_inference_steps=2,
                 seed=42)
    assert kernels.LAUNCHES == before  # CPU tensors never reach a kernel
    return jres, tres, tpipe


def _rel_l2(jres, tres):
    jl = np.asarray(jres.latents, np.float32)
    tl = tres.latents.float().numpy()
    assert tl.shape == jl.shape and np.isfinite(tl).all()
    return np.linalg.norm(tl - jl) / np.linalg.norm(jl)


def test_slice_matches_jax_f32(monkeypatch):
    """f32 end to end: same algorithm, CPU sums in other orders → final
    latents within 1e-3 max-abs and pixels within 1 code."""
    jres, tres, _ = _run_both(True, monkeypatch)
    jl = np.asarray(jres.latents, np.float32)
    tl = tres.latents.numpy()
    assert tl.shape == jl.shape and np.isfinite(tl).all()
    assert np.abs(tl - jl).max() < 1e-3
    jpx = np.asarray(jres.images[0]).astype(np.int32)
    tpx = tres.images[0].astype(np.int32)
    assert tpx.shape == (SIZE, SIZE, 3) and tres.images[0].dtype == np.uint8
    assert np.abs(tpx - jpx).max() <= 1


def test_slice_matches_jax_bf16(monkeypatch):
    """The preset's own dtypes (bf16 MMDiT and VL, f32 VAE): bf16 rounds at
    other places in the two frameworks, so the final latents are held to a
    relative L2 error of 3e-2."""
    jres, tres, _ = _run_both(False, monkeypatch)
    rel = _rel_l2(jres, tres)
    assert rel < 3e-2, rel


def test_two_image_slice_matches_jax_f32(monkeypatch):
    """Two condition images (the 2509 multi-image edit): both in the VL
    prompt, both VAE-encoded into the joint sequence. f32, held as the
    one-image f32 slice: latents within 1e-3 max-abs, pixels within 1 code."""
    jres, tres, _ = _run_both(True, monkeypatch, n_images=2)
    jl = np.asarray(jres.latents, np.float32)
    assert np.abs(tres.latents.numpy() - jl).max() < 1e-3
    jpx = np.asarray(jres.images[0]).astype(np.int32)
    assert np.abs(tres.images[0].astype(np.int32) - jpx).max() <= 1


def test_int8_slice_matches_jax(monkeypatch):
    """use_int8 + use_int8_vl on the JAX package's quantized trees, bridged
    with from_jax, in f32: the codes and scales are the same, but a sum taken
    in another order can move one activation across a rounding boundary and
    change one int8 code, a step of 1/127 of its row's absmax. Final latents
    within rel-L2 1e-3 (measured 1.7e-7: no code moved at this size)."""
    jres, tres, tpipe = _run_both(True, monkeypatch, bridge_bits=8,
                                  use_int8=True, use_int8_vl=True)
    assert "w_q" in tpipe.tfm_params["blocks"][0]["attn"]["img_q"]
    assert "w_q" in tpipe.encoder.params["lm"]["blocks"][0]["q_proj"]
    rel = _rel_l2(jres, tres)
    assert rel < 1e-3, rel


def test_int4_slice_matches_jax(monkeypatch):
    """use_int4 + use_int4_vl: the port fuses q/k/v and quantizes the dense
    trees itself, the JAX side quantizes its unfused trees. Per-channel
    scales make the fused and the separate leaves equal, and the int4 path
    is dequantize + a dense product, so in f32 only sum order differs, and
    the leaves that fall back to int8 (in-dim % 64 != 0) may flip a code as
    above. Final latents within rel-L2 1e-3."""
    jres, tres, tpipe = _run_both(True, monkeypatch, use_int4=True, use_int4_vl=True)
    assert "w_q4" in tpipe.tfm_params["blocks"][0]["attn"]["img_qkv"]
    rel = _rel_l2(jres, tres)
    assert rel < 1e-3, rel


def test_port_imports_neither_jax_nor_pil():
    """The port, imported and run at `tiny` in a fresh process (a cond-only
    edit, a batched-CFG edit, a yuv420 edit and the tiny decoder's artifact
    loaded and served), loads neither jax, optax nor PIL, nor any module of
    the JAX package."""
    code = (
        "import sys, warnings, numpy as np\n"
        "from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import edit_pipeline as ep\n"
        "from qwen_image_edit_streamdiffusion_tpu_torch.core.config import StreamConfig\n"
        "import torch; torch.set_num_threads(2)\n"
        "cfg = StreamConfig(width=64, height=64, vae_image_area=64*64,\n"
        "                   vl_image_area=64*64, num_inference_steps=1,\n"
        "                   cfg_mode='batched', model_preset='tiny')\n"
        "p = ep.EditPipeline.create('tiny', cfg, seed=0, device='cpu')\n"
        "img = np.zeros((64, 64, 3), np.uint8)\n"
        "r = p(img, 'edit it')\n"
        "assert r.images[0].shape == (64, 64, 3)\n"
        "r = p(img, 'edit it', negative_prompt='', true_cfg_scale=4.0)\n"
        "assert r.images[0].shape == (64, 64, 3)\n"
        "p.config = p.config.replace(transfer_format='yuv420')\n"
        "r = p(img + 9, 'edit it', negative_prompt='', true_cfg_scale=4.0)\n"
        "assert r.images[0].shape == (64, 64, 3)\n"
        "p.load_tiny_decoder('artifacts/tiny_decoder_bench-2b.safetensors')\n"
        "r = p(img, 'edit it')\n"
        "assert r.images[0].shape == (64, 64, 3) and p.config.decoder == 'tiny'\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'optax', 'PIL', 'qwen_image_edit_streamdiffusion_tpu')]\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.fixture(scope="module")
def tiny_pipe():
    return tep.EditPipeline.create("tiny", _config(), seed=0, device="cpu")


@pytest.mark.parametrize("kwargs", [{"mesh_cfg_axis": 2}])
def test_unported_config_options_raise(kwargs):
    """A config asking for a mesh runs only on the ranks of a world that
    size, each passing its mesh (tests/test_torch_parallel_world.py); a
    process given none is refused."""
    with pytest.raises(ValueError, match="mesh="):
        tep.EditPipeline.create("tiny", _config(**kwargs), seed=0, device="cpu")


def test_cache_hit_skips_both_encodes(tiny_pipe):
    """A repeated (image, prompt) hits the prompt and latent caches and
    gives the same output."""
    img = np.random.default_rng(1).integers(0, 256, (SIZE, SIZE, 3), np.uint8)
    a = tiny_pipe(img, PROMPT, seed=7)
    hits = (tiny_pipe.prompt_cache.stats()["hits"],
            tiny_pipe.latent_cache.stats()["hits"])
    b = tiny_pipe(img, PROMPT, seed=7)
    assert tiny_pipe.prompt_cache.stats()["hits"] == hits[0] + 1
    assert tiny_pipe.latent_cache.stats()["hits"] == hits[1] + 1
    np.testing.assert_array_equal(a.images[0], b.images[0])
