"""The port's tiny VAE trainers (``training/tiny_vae.py``) against the JAX
package's, for the decoder and the encoder: the full-VAE batch targets, one
Adam step (loss, gradients, update), ``eval_psnr``, the artifacts crossing
between the packages both ways, the synthetic images, the ``--data`` resize
and the CLI on the CPU. Also the refusal of a tensor that needs a gradient by
the kernels without a backward (K2, K3, K5, K6), which needs no card.

The full VAE is the `tiny` preset's (f32), its JAX-layout tree filled with
numpy and bridged with ``convert.from_jax``; the tiny trees start from the
JAX trainer's init, copied into the port's."""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import test_torch_pipeline as tp
from qwen_image_edit_streamdiffusion_tpu.core.config import get_preset
from qwen_image_edit_streamdiffusion_tpu.models import tiny_vae as jtv
from qwen_image_edit_streamdiffusion_tpu.models import vae as jvae
from qwen_image_edit_streamdiffusion_tpu.training import tiny_vae as jtt
from qwen_image_edit_streamdiffusion_tpu_torch.core import codec, imaging
from qwen_image_edit_streamdiffusion_tpu_torch.core.config import get_preset as tget_preset
from qwen_image_edit_streamdiffusion_tpu_torch.models import tiny_vae as tv
from qwen_image_edit_streamdiffusion_tpu_torch.models.common import flatten
from qwen_image_edit_streamdiffusion_tpu_torch.models.convert import from_jax
from qwen_image_edit_streamdiffusion_tpu_torch.ops import conv, flash_attention, int8
from qwen_image_edit_streamdiffusion_tpu_torch.training import tiny_vae as tt

torch.set_num_threads(2)

PRESET = get_preset("tiny")  # its VAE is f32
TPRESET = tget_preset("tiny")
SIZE = 48
CFG = jtt.TinyVAETrainConfig(width=16, blocks_per_stage=1)
TCFG = tt.TinyVAETrainConfig(width=16, blocks_per_stage=1)
KINDS = ("decoder", "encoder")


@pytest.fixture(scope="module")
def pipes():
    """Stand-ins for the two pipelines with the attributes the batch
    functions and ``from_pipeline`` read: the same VAE weights."""
    vae_np = tp._numpy_tree(jvae.init, PRESET.vae, 1)
    jpipe = types.SimpleNamespace(
        vae_params=jax.tree_util.tree_map(jnp.asarray, vae_np), preset=PRESET,
        _jit_cache={})
    tpipe = types.SimpleNamespace(vae_params=from_jax(vae_np, TPRESET.vae),
                                  preset=TPRESET, device=torch.device("cpu"))
    return jpipe, tpipe


def _images(n=4):
    return tt._synthetic_images(SIZE, n, seed=1)


def _trainers(pipes, kind):
    """The JAX trainer and the port's, the port's tree set to the JAX init."""
    jpipe, tpipe = pipes
    jcls, tcls = ((jtt.TinyVAETrainer, tt.TinyVAETrainer) if kind == "decoder"
                  else (jtt.TinyEncoderTrainer, tt.TinyEncoderTrainer))
    jt = jcls.from_pipeline(jpipe, CFG, seed=0)
    t = tcls.from_pipeline(tpipe, TCFG, seed=0)
    want = flatten(jax.tree_util.tree_map(np.array, jt.params))
    got = flatten(t.params)
    assert sorted(got) == sorted(want)
    with torch.no_grad():
        for k, v in got.items():
            v.copy_(torch.from_numpy(want[k]))
    return jt, t


def _batches(pipes, kind):
    jpipe, tpipe = pipes
    imgs = _images()
    if kind == "decoder":
        jb = jtt.build_decoder_batch(jpipe, [Image.fromarray(i) for i in imgs])
        tb = tt.build_decoder_batch(tpipe, imgs)
    else:
        jb = jtt.build_encoder_batch(jpipe, [Image.fromarray(i) for i in imgs])
        tb = tt.build_encoder_batch(tpipe, imgs)
    return jb, tb


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def test_synthetic_images_equal_jax():
    """The same tinted test images, byte for byte (every kind, two seeds)."""
    for seed in (0, 3):
        got = tt._synthetic_images(SIZE, 7, seed)
        want = jtt._synthetic_images(SIZE, 7, seed)
        assert len(got) == len(want) == 7
        for g, w in zip(got, want):
            assert g.dtype == np.uint8
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("kind", KINDS)
def test_batch_targets_match_jax(pipes, kind):
    """The full VAE's targets (encode, and decode for the decoder) against
    the JAX batch functions' in f32: 1e-4 of max|ref|; the encoder's input
    pixels within 1e-6."""
    jb, tb = _batches(pipes, kind)
    assert sorted(jb) == sorted(tb)
    for k in jb:
        _close(tb[k], jb[k], 1e-6 if k == "pixels_in" else 1e-4)


def _jax_loss(jt, kind, batch):
    """The JAX trainer's loss as its jitted step computes it."""
    l1w = jt.cfg.l1_weight
    if kind == "decoder":
        out = lambda p: jtv.decode(p, jt.tcfg, batch["latents"])
        target = batch["pixels"]
    else:
        out = lambda p: jtv.encode(p, jt.ecfg, batch["pixels_in"])
        target = batch["latents"]

    def loss(p):
        err = out(p).astype(jnp.float32) - target
        return jnp.mean(err * err) + l1w * jnp.mean(jnp.abs(err))

    return loss


@pytest.mark.parametrize("kind", KINDS)
def test_adam_step_matches_optax(pipes, kind):
    """One step on the same batch: the loss within 1e-5 relative of the JAX
    trainer's step; the gradients within 1e-4 of each tensor's max against
    ``jax.grad``; the parameters after the step within 1e-6 of the
    parameter scale of ``optax.adam`` applied to the port's gradients (the
    first Adam step takes each gradient's sign, which f32 rounding decides
    where a gradient is near zero); ``eval_psnr`` within 1e-3 dB of the JAX
    trainer's before and after."""
    jt, t = _trainers(pipes, kind)
    jb, _ = _batches(pipes, kind)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    assert abs(t.eval_psnr(tb) - jt.eval_psnr(jb)) <= 1e-3

    jgrads = jax.grad(_jax_loss(jt, kind, jb))(jt.params)
    leaves = flatten(t.params)
    loss = t.loss(tb)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    for k, w in flatten(jax.tree_util.tree_map(np.asarray, jgrads)).items():
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-12), err_msg=k)
    p0 = {k: jnp.asarray(v.detach().numpy()) for k, v in leaves.items()}
    opt = optax.adam(CFG.learning_rate, b1=CFG.b1, b2=CFG.b2)
    upd, _ = opt.update({k: jnp.asarray(g.numpy()) for k, g in grads.items()},
                        opt.init(p0), p0)
    want = optax.apply_updates(p0, upd)

    jloss = jt.step(jb)
    got = t.step(tb)
    assert abs(got - jloss) <= 1e-5 * abs(jloss)
    assert abs(got - loss.item()) <= 1e-6 * abs(loss.item())
    for k, v in leaves.items():
        w = np.asarray(want[k])
        np.testing.assert_allclose(v.detach().numpy(), w, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(w).max()), err_msg=k)
    stepped = flatten(jax.tree_util.tree_map(np.array, jt.params))
    with torch.no_grad():  # the JAX trainer's stepped tree
        for k, v in leaves.items():
            v.copy_(torch.from_numpy(stepped[k]))
    assert abs(t.eval_psnr(tb) - jt.eval_psnr(jb)) <= 1e-3


@pytest.mark.parametrize("kind", KINDS)
def test_artifacts_cross_both_ways(tmp_path, pipes, kind):
    """The port's ``save`` (bf16, and f32 on request) is read by the JAX
    ``load`` / ``load_encoder`` and the JAX ``save`` by the port's loaders:
    the same keys, configs and values bit for bit; the loss falls over a
    few port steps, and the saved tree is the trained one."""
    jt, t = _trainers(pipes, kind)
    _, tb = _batches(pipes, kind)
    losses = [t.step(tb) for _ in range(4)]
    assert losses[-1] < losses[0], losses
    jload, tload = ((jtv.load, tv.load) if kind == "decoder"
                    else (jtv.load_encoder, tv.load_encoder))
    for dtype in ("bfloat16", "float32"):
        path = str(tmp_path / f"port_{dtype}.safetensors")
        t.save(path, dtype)
        jparams, jcfg = jload(path)
        params, cfg = tload(path)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.dtype == dtype and cfg.width == TCFG.width
        want = flatten(t.export(dtype))
        for tree in (params, jax.tree_util.tree_map(np.asarray, jparams)):
            got = flatten(tree)
            assert sorted(got) == sorted(want)
            for k, w in want.items():
                g = got[k].float() if torch.is_tensor(got[k]) else \
                    torch.from_numpy(np.array(got[k], np.float32))
                assert torch.equal(g, w.float()), k
    path = str(tmp_path / "jax.safetensors")
    jt.save(path)
    jparams, jcfg = jload(path)
    params, cfg = tload(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.dtype == "bfloat16"
    want = flatten(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams))
    for k, v in flatten(params).items():
        np.testing.assert_array_equal(v.float().numpy(), want[k], err_msg=k)


def _write_images(root):
    """A PNG and a JPEG at two odd sizes, one with an EXIF-free layout under
    a subdirectory; returns the paths in sorted order."""
    os.makedirs(os.path.join(root, "sub"))
    rng = np.random.default_rng(2)
    a = rng.integers(0, 256, (37, 53, 3), np.uint8)
    b = imaging.make_test_image(70, 45, "circle")
    imaging.write_png(os.path.join(root, "a.png"), a)
    with open(os.path.join(root, "sub", "b.jpg"), "wb") as f:
        f.write(codec.encode_jpeg(b, 90))
    return [os.path.join(root, "a.png"), os.path.join(root, "sub", "b.jpg")]


def test_data_images_resize_as_pillow(tmp_path):
    """``--data``: the files found recursively in sorted order, decoded and
    resized to size² equal to Pillow's ``open(p).convert("RGB").resize``
    (its default, BICUBIC) byte for byte."""
    paths = _write_images(str(tmp_path))
    got = tt._read_images(str(tmp_path), SIZE)
    assert len(got) == len(paths)
    for g, p in zip(got, paths):
        want = np.asarray(Image.open(p).convert("RGB").resize((SIZE, SIZE)))
        np.testing.assert_array_equal(g, want)
    with pytest.raises(SystemExit, match="no images"):
        tt._read_images(str(tmp_path / "sub" / "none"), SIZE)


@pytest.mark.parametrize("kind", KINDS)
def test_cli_on_the_cpu(tmp_path, capsys, kind):
    """The CLI at `tiny` on the CPU (``--device cpu``), on synthetic images
    (decoder) or on files (``--data``, encoder): it steps, evaluates and
    saves an artifact its loader reads."""
    path = str(tmp_path / f"{kind}.safetensors")
    argv = ["--preset", "tiny", "--device", "cpu", "--size", "32", "--steps", "2",
            "--batch", "2", "--width", "16", "--blocks", "1", "--eval-every", "1",
            "--save", path]
    if kind == "encoder":
        _write_images(str(tmp_path / "data"))
        argv += ["--encoder", "--data", str(tmp_path / "data")]
    tt.main(argv)
    out = capsys.readouterr().out
    assert "PSNR(tiny, full)" in out and f"saved {path}" in out
    _, cfg = (tv.load if kind == "decoder" else tv.load_encoder)(path)
    assert cfg.width == 16 and cfg.dtype == "bfloat16"


def _meta(shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


GUARDED = {
    "conv3x3": lambda g: conv.conv3x3(_meta((1, 8, 8, 8), grad=g),
                                      _meta((3, 3, 8, 8)), _meta((8,))),
    "causal": lambda g: flash_attention.causal_attention(
        _meta((1, 2, 64, 128), grad=g), _meta((1, 2, 64, 128)),
        _meta((1, 2, 64, 128))),
    "quantize_rows": lambda g: int8.quantize_rows(_meta((4, 64), grad=g)),
    "int8_matmul": lambda g: int8.int8_matmul(
        _meta((4, 64), torch.int8), _meta((4, 1), torch.float32, grad=g),
        _meta((8, 64), torch.int8), _meta((8,), torch.float32)),
}


@pytest.mark.parametrize("name", sorted(GUARDED))
def test_kernels_without_backward_refuse_a_gradient(name):
    """K3 (and K2, K5, K6) on a non-CPU tensor that needs a gradient raise
    before any launch, instead of returning a result with no autograd
    graph; under ``torch.no_grad`` the guard passes (and a meta tensor is
    then refused as an unsupported device)."""
    with pytest.raises(RuntimeError, match="no backward"):
        GUARDED[name](True)
    with torch.no_grad(), pytest.raises(RuntimeError, match="unsupported device"):
        GUARDED[name](True)
