"""End-to-end image-edit pipeline — the cond-only edit main path.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/pipeline/edit_pipeline.py``:

  prepare images → Qwen2.5-VL prompt encode → VAE-encode the condition image
  → flow-matching denoise loop (MMDiT + Euler) → VAE decode → uint8 pixels

with the JAX package's prompt and latent caches in front of the two encodes.
PyTorch runs eagerly, so each stage is a plain call on ``self.device``.

This slice runs ``cfg_mode="none"`` with ``transfer_format="rgb"`` and the full
decoder, with one or more condition images, in bf16 or on the int8 / int4
weight rungs (``use_int8``, ``use_int8_vl``, ``use_int4``, ``use_int4_vl``),
with a LoRA fused at construction (``from_weights(lora_path=...)``).
The other CFG modes, yuv420, the tiny VAE pair, ``edit_many`` and
``num_images_per_prompt > 1`` raise ``NotImplementedError`` naming their
ROADMAP item. Images come in as (H, W, 3) uint8 arrays (a PIL
image is accepted and converted, but PIL is never imported here) and go out
as uint8 arrays.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from qwen_image_edit_streamdiffusion_tpu_torch.core import imaging
from qwen_image_edit_streamdiffusion_tpu_torch.core.config import (
    Preset,
    StreamConfig,
    get_preset,
)
from qwen_image_edit_streamdiffusion_tpu_torch.core.rng import stream
from qwen_image_edit_streamdiffusion_tpu_torch.models import lora, quantize, qwen_vl
from qwen_image_edit_streamdiffusion_tpu_torch.models import scheduler as sched
from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm
from qwen_image_edit_streamdiffusion_tpu_torch.models import vae as vae_mod
from qwen_image_edit_streamdiffusion_tpu_torch.models.optimize import fuse_qkv
from qwen_image_edit_streamdiffusion_tpu_torch.models.text_encoder import (
    PromptEncoder,
    StubEncoder,
)
from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.cache import (
    LatentCache,
    PromptCache,
)


def combine_cfg(pos: torch.Tensor, neg: torch.Tensor, scale) -> torch.Tensor:
    """True-CFG combine with cond-norm rescaling, in f32."""
    pos32, neg32 = pos.float(), neg.float()
    comb = neg32 + scale * (pos32 - neg32)
    cond_norm = torch.linalg.vector_norm(pos32, dim=-1, keepdim=True)
    comb_norm = torch.linalg.vector_norm(comb, dim=-1, keepdim=True)
    return (comb * (cond_norm / comb_norm.clamp_min(1e-12))).to(pos.dtype)


def rcfg_self_negative(x: torch.Tensor, anchor: torch.Tensor, sigma,
                       out_dtype=None) -> torch.Tensor:
    """rcfg-self virtual negative velocity v_neg = (x_t − z_a)/σ_t, σ floored
    at 1e-3, in f32."""
    sig = torch.as_tensor(sigma, dtype=torch.float32).clamp_min(1e-3)
    neg = (x.float() - anchor.float()) / sig
    return neg.to(out_dtype if out_dtype is not None else x.dtype)


class EditResult(NamedTuple):
    images: List[np.ndarray]  # (H, W, 3) uint8 each
    latents: torch.Tensor     # final normalized latents (B, h, w, z), f32
    elapsed: float


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to the PyTorch package yet "
        f"(ROADMAP.md queue 1, {item})")


def check_config(config: StreamConfig) -> None:
    """Refuse, at construction, the options this slice does not run."""
    if config.transfer_format != "rgb":
        _not_ported("transfer_format='yuv420'", "the stream (item 4)")
    if config.decoder != "full" or config.encoder != "full":
        _not_ported("the tiny VAE pair", "item 3")
    if config.mesh_cfg_axis != 1 or config.mesh_model_axis != 1:
        _not_ported("multi-device meshes", "multi-GPU (item 7)")


def _quantized(params, want: Optional[int], saved: Optional[int], fn, what: str):
    """Quantize ``params`` in place to ``want`` bits unless the tree is
    already quantized; a saved rung other than the one requested is served
    with a warning, as in the JAX package."""
    if want is None:
        return params
    if saved is None:
        return fn(params, bits=want)
    if saved != want:
        warnings.warn(f"config requests int{want} {what} but the weights are "
                      f"pre-quantized int{saved}; serving the saved rung",
                      stacklevel=3)
    return params


def prepare_transformer(params, config: StreamConfig):
    """Fuse q/k/v (unless the tree is pre-quantized: its leaves stay in their
    saved layout), then quantize — the JAX package's order."""
    saved = quantize.saved_bits(params)
    if config.fuse_qkv and saved is None:
        params = fuse_qkv(params)
    want = 4 if config.use_int4 else (8 if config.use_int8 else None)
    return _quantized(params, want, saved, quantize.quantize_transformer,
                      "transformer")


def prepare_vl(params, config: StreamConfig):
    want = 4 if config.use_int4_vl else (8 if config.use_int8_vl else None)
    return _quantized(params, want, quantize.saved_bits(params),
                      quantize.quantize_vl, "VL")


@dataclass
class EditPipeline:
    """Holds the params of the three models, the encoder and the caches."""

    preset: Preset
    config: StreamConfig
    tfm_params: Any
    vae_params: Any
    encoder: PromptEncoder
    device: torch.device
    prompt_cache: PromptCache
    latent_cache: LatentCache

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    @classmethod
    def create(cls, preset: str | Preset = "qwen-image-edit-2509",
               config: Optional[StreamConfig] = None, seed: int = 0,
               device="cuda") -> "EditPipeline":
        """Random-init construction: every parameter is made on ``device``
        in its preset dtype from the seed's named generator streams."""
        if isinstance(preset, str):
            preset = get_preset(preset)
        config = config or StreamConfig(model_preset=preset.name)
        device = torch.device(device)
        vl_params = None
        if config.use_vl_encoder:
            vl_params = qwen_vl.init(stream(seed, "vl", device), preset.vl, device)
        return cls.from_weights(
            preset, config,
            tfm.init(stream(seed, "transformer", device), preset.model, device),
            vae_mod.init(stream(seed, "vae", device), preset.vae, device),
            vl_params, device)

    @classmethod
    def from_weights(cls, preset: Preset, config: StreamConfig, tfm_params,
                     vae_params, vl_params=None, device="cuda",
                     lora_path: Optional[str] = None) -> "EditPipeline":
        """Construction from existing port params (e.g. ``convert.from_jax``):
        the LoRA at ``lora_path`` (``.safetensors`` or ``.npz``) fused into
        the dense transformer weights IN PLACE, then q/k/v fused when
        ``config.fuse_qkv``, then the transformer and the VL params quantized
        IN PLACE on the requested rungs — the JAX ``from_checkpoint`` order."""
        check_config(config)
        device = torch.device(device)
        if lora_path:
            if quantize.saved_bits(tfm_params) is not None:
                raise ValueError(
                    "LoRA cannot be fused into a quantized checkpoint — fuse "
                    "it into the dense weights, then quantize them "
                    "(StreamConfig use_int8 / use_int4)")
            lora.fuse_lora(tfm_params, lora.load_lora_weights(lora_path))
        tfm_params = prepare_transformer(tfm_params, config)
        if config.use_vl_encoder:
            encoder = qwen_vl.QwenVLEncoder(
                preset.vl, prepare_vl(vl_params, config), device=device,
                max_len=preset.vl.max_text_len,
                use_flash=config.use_flash_attention)
        else:
            encoder = StubEncoder.from_config(preset.vl)
        return cls(preset=preset, config=config, tfm_params=tfm_params,
                   vae_params=vae_params, encoder=encoder, device=device,
                   prompt_cache=PromptCache(encoder), latent_cache=LatentCache())

    @property
    def _mdt(self) -> torch.dtype:
        return getattr(torch, self.preset.model.dtype)

    # ------------------------------------------------------------------
    # Stages
    # ------------------------------------------------------------------

    def _prepare_images(self, images: Sequence[np.ndarray],
                        height: Optional[int], width: Optional[int]):
        """Output defaults to area-1024² at the first image's aspect; VAE
        condition images area-1024²; VL condition images area-384²."""
        first = images[0]
        aspect = first.shape[1] / first.shape[0]
        cw, ch = imaging.calculate_dimensions(self.config.vae_image_area, aspect)
        out_w = width or self.config.width or cw
        out_h = height or self.config.height or ch
        vae_images, vl_images = [], []
        for img in images:
            a = img.shape[1] / img.shape[0]
            vw, vh = imaging.calculate_dimensions(self.config.vae_image_area, a)
            vae_images.append(imaging.resize(img, vw, vh, "lanczos",
                                             self.device))
            lw, lh = imaging.calculate_dimensions(self.config.vl_image_area, a)
            vl_images.append(imaging.resize(img, lw, lh, "lanczos",
                                            self.device))
        return out_h, out_w, vae_images, vl_images

    def encode_condition_latents(self, vae_images: List[np.ndarray]):
        """VAE-encode condition images (posterior mode) → packed tokens in
        the model dtype + their (1, h/2, w/2) rope shapes."""
        vdt = getattr(torch, self.preset.vae.dtype)
        tokens, shapes = [], []
        for arr in vae_images:
            x = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)[None]
            img = x.float() / 127.5 - 1.0
            z = vae_mod.encode(self.vae_params, self.preset.vae, img.to(vdt))
            tokens.append(tfm.pack_latents(z.float()).to(self._mdt))
            zh, zw = arr.shape[0] // 8, arr.shape[1] // 8
            shapes.append((1, zh // 2, zw // 2))
        return torch.cat(tokens, dim=1), shapes

    def _noise(self, shape: Tuple[int, ...], seed: int) -> torch.Tensor:
        """Seeded packed-noise tokens from the "latents" stream."""
        noise = torch.randn(shape, generator=stream(seed, "latents", self.device),
                            dtype=torch.float32, device=self.device)
        return tfm.pack_latents(noise).to(self._mdt)

    def _denoise(self, x, cond_tokens, txt, mask, img_shapes, steps: int):
        """Cond-only flow-matching loop: MMDiT velocity over [target ⊕
        condition] tokens, Euler step on the target tokens, in f32."""
        mcfg = self.preset.model
        l_target = img_shapes[0][0] * img_shapes[0][1] * img_shapes[0][2]
        schedule = sched.make_schedule(steps, l_target, self.preset.scheduler)
        ropes = tfm.make_rope(mcfg, img_shapes, txt.shape[1], self.device)
        for i in range(steps):
            t = torch.full((x.shape[0],), float(schedule.timesteps[i]),
                           dtype=torch.float32, device=self.device)
            v = tfm.forward(self.tfm_params, mcfg, torch.cat([x, cond_tokens], 1),
                            txt, t, ropes, txt_mask=mask,
                            use_flash=self.config.use_flash_attention)
            x = sched.euler_step(x, v[:, :l_target], schedule.sigmas[i],
                                 schedule.sigmas[i + 1])
        return x

    def _decode(self, tokens: torch.Tensor, zh: int, zw: int):
        """Packed tokens → (uint8 NHWC pixels, f32 latents): unpack, VAE
        decode, then clip, (x·0.5+0.5)·255, +0.5, uint8 — in f32."""
        z = tfm.unpack_latents(tokens.float(), zh, zw)
        vdt = getattr(torch, self.preset.vae.dtype)
        x32 = vae_mod.decode(self.vae_params, self.preset.vae, z.to(vdt)).float()
        x32 = ((x32 * 0.5 + 0.5) * 255.0).clamp(0.0, 255.0)
        return (x32 + 0.5).clamp(0.0, 255.0).to(torch.uint8), z

    # ------------------------------------------------------------------
    # Main entry
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def __call__(self, image, prompt: str, negative_prompt: Optional[str] = None,
                 num_inference_steps: Optional[int] = None,
                 guidance_scale: float = 1.0,  # embedded guidance; no-op
                 true_cfg_scale: Optional[float] = None,
                 seed: Optional[int] = None, height: Optional[int] = None,
                 width: Optional[int] = None,
                 num_images_per_prompt: int = 1) -> EditResult:
        t_start = time.time()
        if isinstance(image, (list, tuple)):
            images = [imaging.as_uint8_array(i) for i in image]
        else:
            images = [imaging.as_uint8_array(image)]
        if num_images_per_prompt > 1:
            _not_ported("num_images_per_prompt > 1", "with edit_many (item 6)")
        steps = num_inference_steps or self.config.num_inference_steps
        cfg_scale = (true_cfg_scale if true_cfg_scale is not None
                     else self.config.true_cfg_scale)
        seed = self.config.seed if seed is None else seed
        if negative_prompt is not None and cfg_scale > 1.0:
            _not_ported(f"true CFG (cfg_mode={self.config.cfg_mode!r})",
                        "rcfg-self and the other cfg modes (item 2)")

        out_h, out_w, vae_images, vl_images = self._prepare_images(
            images, height, width)

        emb = self.prompt_cache.encode(prompt, vl_images)
        txt = torch.as_tensor(emb.embeds).to(self.device, self._mdt)[None]
        mask = torch.as_tensor(emb.mask).to(self.device)[None]

        cond_tokens, cond_shapes = self.latent_cache.get_or_encode(
            vae_images, self.encode_condition_latents)

        zh, zw = out_h // 8, out_w // 8
        x0 = self._noise((1, zh, zw, self.preset.vae.latent_channels), seed)
        img_shapes = tuple([(1, zh // 2, zw // 2)] + list(cond_shapes))
        final = self._denoise(x0, cond_tokens, txt, mask, img_shapes, steps)

        pixels, latents = self._decode(final, zh, zw)
        host = pixels.cpu().numpy()
        return EditResult(images=[host[i] for i in range(host.shape[0])],
                          latents=latents, elapsed=time.time() - t_start)

    def edit_many(self, items, num_inference_steps=None, true_cfg_scale=None):
        _not_ported("edit_many", "serving through InferenceEngine (item 6)")
