"""Distil the tiny VAE pair from the full VAE (the TAESD loop).

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/training/tiny_vae.py``.
No tiny autoencoder exists for Qwen-Image's latent space, so the pair is made
from the base model itself:

- **decoder** (:class:`TinyVAETrainer`): z = full_encode(image), target =
  full_decode(z); loss = MSE(tiny_decode(z), target) + λ·L1. The target is
  the full decoder's output, what the full path would have shown, so
  PSNR(tiny, full) is the serving-quality metric;
- **encoder** (:class:`TinyEncoderTrainer`): target = the full encoder's
  normalized posterior mode; loss = MSE(tiny_encode(image), target) + λ·L1.
  Its PSNR decodes both latent sets through the same full decoder, so it
  isolates the encoder's error.

The targets come from the full VAE under ``torch.no_grad`` (its convs are K3
on the card); the tiny chain runs ``F.conv2d`` (``models/tiny_vae.py``),
differentiable. Parameters and Adam (``torch.optim.Adam``, eps 1e-8, the
``optax.adam`` the JAX package uses) are f32; artifacts are saved in the
serving dtype and load with ``EditPipeline.load_tiny_decoder`` /
``load_tiny_encoder`` or the JAX ``tiny_vae.load`` / ``load_encoder``.
Images are (H, W, 3) uint8 arrays, not PIL images.

CLI::

    python -m qwen_image_edit_streamdiffusion_tpu_torch.training.tiny_vae \\
        --preset tiny --size 64 --steps 4 --device cpu [--encoder] [--save F]
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from qwen_image_edit_streamdiffusion_tpu_torch.core import imaging
from qwen_image_edit_streamdiffusion_tpu_torch.core.rng import stream
from qwen_image_edit_streamdiffusion_tpu_torch.models import tiny_vae as tv
from qwen_image_edit_streamdiffusion_tpu_torch.models import vae as vae_mod
from qwen_image_edit_streamdiffusion_tpu_torch.models.common import (
    Params,
    flatten,
    unflatten,
)


@dataclasses.dataclass(frozen=True)
class TinyVAETrainConfig:
    width: int = 64
    blocks_per_stage: int = 2
    learning_rate: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    l1_weight: float = 0.1  # sharpens edges against pure MSE
    save_dtype: str = "bfloat16"


def _psnr(y: torch.Tensor, ref: torch.Tensor) -> float:
    """PSNR in dB over the [-1, 1] pixel range (peak-to-peak 2)."""
    mse = torch.mean(torch.square(y - ref)).clamp_min(1e-12)
    return float(10.0 * torch.log10(4.0 / mse))


class _TinyTrainer:
    """Adam over a tiny tree (f32, ``requires_grad``) against frozen
    full-VAE targets; subclasses give the tree and the loss."""

    def __init__(self, vae_params: Params, vae_cfg, cfg: TinyVAETrainConfig,
                 params: Params):
        self.cfg = cfg
        self.vae_params = vae_params
        self.vae_cfg = vae_cfg
        self.params = params
        self._leaves = [t.requires_grad_() for t in flatten(params).values()]
        self.opt = torch.optim.Adam(self._leaves, lr=cfg.learning_rate,
                                    betas=(cfg.b1, cfg.b2), eps=1e-8)

    def _out(self, params: Params, batch: Dict[str, Any]) -> torch.Tensor:
        raise NotImplementedError

    def _target(self, batch: Dict[str, Any]) -> torch.Tensor:
        raise NotImplementedError

    def loss(self, batch: Dict[str, Any]) -> torch.Tensor:
        """MSE + λ·L1 of the tiny output against its target (differentiable
        in the tiny params)."""
        err = self._out(self.params, batch).float() - self._target(batch)
        return (torch.mean(err * err)
                + self.cfg.l1_weight * torch.mean(torch.abs(err)))

    def step(self, batch: Dict[str, Any]) -> float:
        """One Adam step; returns the loss (a host sync)."""
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss(batch)
        loss.backward()
        self.opt.step()
        return float(loss.detach())

    def export(self, dtype: Optional[str] = None) -> Params:
        """The tree in the serving dtype (what :meth:`save` writes)."""
        dt = getattr(torch, dtype or self.cfg.save_dtype)
        return unflatten({k: v.detach().to(dt)
                          for k, v in flatten(self.params).items()})

    def save(self, path: str, dtype: Optional[str] = None) -> None:
        tv.save(path, self.export(dtype))


def _device(vae_params: Params) -> torch.device:
    return next(iter(flatten(vae_params).values())).device


class TinyVAETrainer(_TinyTrainer):
    """The tiny decoder against the full decoder's output; batches from
    :func:`build_decoder_batch`."""

    def __init__(self, vae_params: Params, vae_cfg, cfg: TinyVAETrainConfig,
                 seed: int = 0):
        self.tcfg = tv.TinyDecoderConfig.from_vae(
            vae_cfg, width=cfg.width, blocks_per_stage=cfg.blocks_per_stage,
            dtype="float32")
        dev = _device(vae_params)
        super().__init__(vae_params, vae_cfg, cfg, tv.init(
            stream(seed, "tiny_vae", dev), self.tcfg, dev))

    @classmethod
    def from_pipeline(cls, pipe, cfg: Optional[TinyVAETrainConfig] = None,
                      seed: int = 0) -> "TinyVAETrainer":
        return cls(pipe.vae_params, pipe.preset.vae,
                   cfg or TinyVAETrainConfig(), seed=seed)

    def _out(self, params, batch):
        return tv.decode(params, self.tcfg, batch["latents"])

    def _target(self, batch):
        return batch["pixels"]

    def eval_psnr(self, batch: Dict[str, Any]) -> float:
        """PSNR of tiny(z) against the full decoder's output."""
        with torch.no_grad():
            return _psnr(self._out(self.params, batch).float(), batch["pixels"])


class TinyEncoderTrainer(_TinyTrainer):
    """The tiny encoder against the full encoder's latents; batches from
    :func:`build_encoder_batch`."""

    def __init__(self, vae_params: Params, vae_cfg, cfg: TinyVAETrainConfig,
                 seed: int = 0):
        self.ecfg = tv.TinyEncoderConfig.from_vae(
            vae_cfg, width=cfg.width, blocks_per_stage=cfg.blocks_per_stage,
            dtype="float32")
        dev = _device(vae_params)
        super().__init__(vae_params, vae_cfg, cfg, tv.encoder_init(
            stream(seed, "tiny_enc", dev), self.ecfg, dev))

    @classmethod
    def from_pipeline(cls, pipe, cfg: Optional[TinyVAETrainConfig] = None,
                      seed: int = 0) -> "TinyEncoderTrainer":
        return cls(pipe.vae_params, pipe.preset.vae,
                   cfg or TinyVAETrainConfig(), seed=seed)

    def _out(self, params, batch):
        return tv.encode(params, self.ecfg, batch["pixels_in"])

    def _target(self, batch):
        return batch["latents"]

    def eval_psnr(self, batch: Dict[str, Any]) -> float:
        """PSNR of full_decode(tiny_encode(image)) against
        full_decode(full_encode(image)): one full decoder for both."""
        vdt = getattr(torch, self.vae_cfg.dtype)
        with torch.no_grad():
            z = self._out(self.params, batch).float()
            y = vae_mod.decode(self.vae_params, self.vae_cfg, z.to(vdt)).float()
            ref = vae_mod.decode(self.vae_params, self.vae_cfg,
                                 batch["latents"].to(vdt)).float()
            return _psnr(y, ref)


def _pixels(pipe, images: Sequence[np.ndarray]) -> torch.Tensor:
    """Same-size uint8 images → f32 (B, H, W, 3) in [-1, 1] on the
    pipeline's device."""
    arr = np.stack([imaging.as_uint8_array(im) for im in images])
    return torch.from_numpy(arr).to(pipe.device).float() / 127.5 - 1.0


def build_encoder_batch(pipe, images: Sequence[np.ndarray]) -> Dict[str, Any]:
    """uint8 images of one size → {pixels_in, latents}: the pixels in [-1, 1]
    (f32, the tiny encoder's input) and the full encoder's normalized
    posterior mode (f32), the target."""
    vdt = getattr(torch, pipe.preset.vae.dtype)
    with torch.no_grad():
        img = _pixels(pipe, images)
        z = vae_mod.encode(pipe.vae_params, pipe.preset.vae, img.to(vdt))
        return {"pixels_in": img, "latents": z.float()}


def build_decoder_batch(pipe, images: Sequence[np.ndarray]) -> Dict[str, Any]:
    """uint8 images of one size → {latents, pixels}: z = the full encode
    (posterior mode) and the full decoder's output (f32), the target."""
    vdt = getattr(torch, pipe.preset.vae.dtype)
    with torch.no_grad():
        img = _pixels(pipe, images).to(vdt)
        z = vae_mod.encode(pipe.vae_params, pipe.preset.vae, img)
        y = vae_mod.decode(pipe.vae_params, pipe.preset.vae, z.to(vdt))
        return {"latents": z.float(), "pixels": y.float()}


def _synthetic_images(size: int, n: int, seed: int = 0) -> List[np.ndarray]:
    """Training images when no dataset is given: the test-image family with
    a random tint each, as (size, size, 3) uint8 arrays (a mechanism demo;
    distil against real photos for a production artifact)."""
    rng = np.random.default_rng(seed)
    kinds = ["gradient", "circle", "sine"]
    out = []
    for i in range(n):
        base = imaging.make_test_image(size, size, kinds[i % len(kinds)]
                                       ).astype(np.int32)
        tint = rng.integers(0, 64, (3,), np.int32)
        out.append(np.clip(base + tint[None, None, :], 0, 255).astype(np.uint8))
    return out


def _read_images(root: str, size: int) -> List[np.ndarray]:
    """Every .png / .jpg / .jpeg under ``root`` (recursive, sorted), decoded
    (EXIF-transposed RGB) and resized to size² as Pillow's default
    ``Image.resize`` (BICUBIC) does."""
    import glob

    from qwen_image_edit_streamdiffusion_tpu_torch.training.data import read_image

    paths = sorted(p for ext in ("png", "jpg", "jpeg")
                   for p in glob.glob(f"{root}/**/*.{ext}", recursive=True))
    if not paths:
        raise SystemExit(f"no images under {root!r}")
    return [imaging.resize(read_image(p), size, size, "bicubic") for p in paths]


def main(argv=None):
    import argparse
    import time

    from qwen_image_edit_streamdiffusion_tpu_torch.core.config import StreamConfig
    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.edit_pipeline import (
        EditPipeline,
    )

    ap = argparse.ArgumentParser(
        description="Distil the tiny VAE decoder (or, with --encoder, the "
                    "encoder) from the full VAE")
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--encoder", action="store_true",
                    help="distil the tiny ENCODER (pixels → latents); serve "
                    "with StreamConfig(encoder='tiny')")
    ap.add_argument("--data", default=None,
                    help="directory of training images (png/jpg); default: "
                    "synthetic test images")
    ap.add_argument("--save", default=None,
                    help="write the distilled artifact (.safetensors)")
    ap.add_argument("--save-dtype", default="bfloat16")
    ap.add_argument("--eval-every", type=int, default=50)
    args = ap.parse_args(argv)

    pipe = EditPipeline.create(
        args.preset, StreamConfig(model_preset=args.preset, use_vl_encoder=False),
        seed=0, device=args.device)
    cfg = TinyVAETrainConfig(width=args.width, blocks_per_stage=args.blocks,
                             learning_rate=args.lr, save_dtype=args.save_dtype)
    if args.encoder:
        trainer = TinyEncoderTrainer.from_pipeline(pipe, cfg)
        build_batch = build_encoder_batch
    else:
        trainer = TinyVAETrainer.from_pipeline(pipe, cfg)
        build_batch = build_decoder_batch
    if args.data:
        imgs = _read_images(args.data, args.size)
    else:
        imgs = _synthetic_images(args.size, max(args.batch * 8, 16))

    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.steps):
        pick = rng.choice(len(imgs), size=args.batch, replace=False)
        batch = build_batch(pipe, [imgs[j] for j in pick])
        loss = trainer.step(batch)
        if i == 0:
            print(f"step 1: {time.time() - t0:.1f}s  loss {loss:.5f}")
        if args.eval_every and (i + 1) % args.eval_every == 0:
            print(f"step {i + 1}: loss {loss:.5f}  PSNR(tiny, full) "
                  f"{trainer.eval_psnr(batch):.2f} dB")
    if args.save:
        trainer.save(args.save)
        print(f"saved {args.save} ({'encoder' if args.encoder else 'decoder'}, "
              f"width {args.width}, {args.save_dtype})")


if __name__ == "__main__":
    main()
