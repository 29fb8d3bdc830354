"""End-to-end image-edit pipeline — the cond-only edit main path.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/pipeline/edit_pipeline.py``:

  prepare images → Qwen2.5-VL prompt encode → VAE-encode the condition image
  → flow-matching denoise loop (MMDiT + Euler) → VAE decode → uint8 pixels

with the JAX package's prompt and latent caches in front of the two encodes.
PyTorch runs eagerly, so each stage is a plain call on ``self.device``.

It runs every ``cfg_mode`` of the JAX ``_denoise_fn`` (``parallel``, with no
``cfg`` mesh axis, is exactly ``batched``, as the JAX package degrades it),
the guided call (positive and negative prompts encoded
as one wave), ``num_images_per_prompt`` and :meth:`EditPipeline.edit_many`
(several requests in one denoise call), ``transfer_format="yuv420"`` (4:2:0
upload and download, ``ops/colorspace.py``) and the tiny VAE pair
(``models/tiny_vae.py``; the tiny decoder serves the output, the tiny encoder
the stream's temporal frames), in bf16 or on the int8 / int4 weight rungs,
with a LoRA fused at construction, from random weights (``create``), the
port's params (``from_weights``) or converted checkpoints
(``from_checkpoint``, ``models/checkpoint.py``). ``_denoise`` also runs the
tail of a schedule (``start_step``), as ``pipeline/stream.py`` needs it.

Under a (cfg × model) mesh (``mesh=``, ``core/meshes.py``; one process a
rank, every rank making the same calls in the same order) each rank holds
its slices of the MMDiT and the VL encoder (``parallel/sharding.py``; q/k/v
stay unfused, as in JAX) and the whole VAE: every leaf is built or read
whole, LoRA-fused, quantized and sliced one block at a time, so a rank never
holds the whole model. The MMDiT runs tensor-parallel over the model group;
``cfg_mode="parallel"`` runs the positive rows on cfg group 0 and the
negative rows on group 1, and a cond-only (or rcfg) call of several rows
splits its rows over the cfg groups, as the JAX ``dp_rows`` does. The
stream (``pipeline/stream.py``) and the trainers (``training/``) run on the
same mesh. ``cfg_mode``,
``transfer_format`` and ``decoder`` are read from ``config`` on every call.
Rows are not padded to the JAX package's {1, 2, 4, 8, 16} buckets, which bound
XLA compiles; eager PyTorch has none, and rows are independent.

Images come in as (H, W, 3) uint8 arrays (a PIL image is accepted and
converted, but PIL is never imported here) and go out as uint8 arrays. Host
arrays reach the card through pinned memory with ``non_blocking=True``, the
schedule's σ enter each step as host scalars and the rope tables of a bucket
are uploaded once (``models/transformer.py::make_rope``), so the host queues
a denoise without waiting for the card.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from qwen_image_edit_streamdiffusion_tpu_torch.core import imaging
from qwen_image_edit_streamdiffusion_tpu_torch.core.config import (
    Preset,
    StreamConfig,
    get_preset,
)
from qwen_image_edit_streamdiffusion_tpu_torch.core.meshes import SINGLE, Mesh
from qwen_image_edit_streamdiffusion_tpu_torch.core.rng import stream
from qwen_image_edit_streamdiffusion_tpu_torch.models import (
    lora,
    quantize,
    qwen_vl,
    tiny_vae,
)
from qwen_image_edit_streamdiffusion_tpu_torch.models import scheduler as sched
from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm
from qwen_image_edit_streamdiffusion_tpu_torch.models import vae as vae_mod
from qwen_image_edit_streamdiffusion_tpu_torch.models.optimize import fuse_qkv
from qwen_image_edit_streamdiffusion_tpu_torch.models.tokenizer import files_in
from qwen_image_edit_streamdiffusion_tpu_torch.models.text_encoder import (
    PromptEncoder,
    StubEncoder,
)
from qwen_image_edit_streamdiffusion_tpu_torch.ops import colorspace
from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed, sharding
from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.cache import (
    LatentCache,
    PromptCache,
    image_fingerprint,
)

CFG_MODES = ("none", "sequential", "batched", "parallel", "rcfg", "rcfg-self")


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


def check_config(config: StreamConfig, mesh: Optional[Mesh] = None) -> None:
    """Refuse, at construction, a config whose mesh axes differ from the
    mesh given (none given: a mesh of one rank)."""
    want = (config.mesh_cfg_axis, config.mesh_model_axis)
    have = (mesh.cfg, mesh.model) if mesh is not None else (1, 1)
    if want != have:
        raise ValueError(
            f"config asks for a {want[0]}x{want[1]} (cfg x model) mesh but the "
            f"mesh given is {have[0]}x{have[1]}: pass mesh= "
            "(parallel/distributed.py::global_mesh) from every rank of a "
            "torch.distributed world of that size")


def _check_tiny_cfg(tcfg, vae_cfg, path: str) -> None:
    if (tcfg.latent_channels != vae_cfg.latent_channels
            or tcfg.spatial_upsample != vae_cfg.spatial_downsample):
        raise ValueError(
            f"tiny decoder {path!r} reads a ({tcfg.latent_channels}ch, "
            f"{tcfg.spatial_upsample}x) latent grid but the preset's VAE "
            f"produces ({vae_cfg.latent_channels}ch, "
            f"{vae_cfg.spatial_downsample}x)")


def _check_tiny_enc_cfg(ecfg, vae_cfg, path: str) -> None:
    if (ecfg.latent_channels != vae_cfg.latent_channels
            or ecfg.spatial_downsample != vae_cfg.spatial_downsample):
        raise ValueError(
            f"tiny encoder {path!r} writes a ({ecfg.latent_channels}ch, "
            f"{ecfg.spatial_downsample}x) latent grid but the preset's VAE "
            f"uses ({vae_cfg.latent_channels}ch, "
            f"{vae_cfg.spatial_downsample}x)")


def _init_tiny_decoder(preset: Preset, config: StreamConfig,
                       path: Optional[str], seed: int, device):
    """(params, TinyDecoderConfig) for ``config.decoder="tiny"`` or a path:
    the artifact when given, else a random init with the JAX warning (an
    untrained tiny decoder outputs noise)."""
    if config.decoder != "tiny" and not path:
        return None
    if path:
        params, tcfg = tiny_vae.load(path, device)
        _check_tiny_cfg(tcfg, preset.vae, path)
        return params, tcfg
    warnings.warn(
        "decoder='tiny' without a trained artifact: random-init tiny "
        "decoder (output is noise; distill one with "
        "training/tiny_vae.py or pass tiny_decoder_path)")
    tcfg = tiny_vae.TinyDecoderConfig.from_vae(preset.vae)
    return tiny_vae.init(stream(seed, "tiny_vae", device), tcfg, device), tcfg


def _init_tiny_encoder(preset: Preset, config: StreamConfig,
                       path: Optional[str], seed: int, device):
    """(params, TinyEncoderConfig) for ``config.encoder="tiny"`` or a path,
    with the decoder's load-or-warn policy."""
    if config.encoder != "tiny" and not path:
        return None
    if path:
        params, ecfg = tiny_vae.load_encoder(path, device)
        _check_tiny_enc_cfg(ecfg, preset.vae, path)
        return params, ecfg
    warnings.warn(
        "encoder='tiny' without a trained artifact: random-init tiny "
        "encoder (conditioning latents are noise; distill one with "
        "training/tiny_vae.py --encoder or pass tiny_encoder_path)")
    ecfg = tiny_vae.TinyEncoderConfig.from_vae(preset.vae)
    return (tiny_vae.encoder_init(stream(seed, "tiny_vae_enc", device), ecfg,
                                  device), ecfg)


def _live(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh``, or None for a mesh of one rank."""
    return mesh if mesh is not None and mesh.size > 1 else None


def _pad_rows(a: torch.Tensor, length: int) -> torch.Tensor:
    """Pad dim 1 of ``a`` to ``length`` with zeros (False for a mask)."""
    if a.shape[1] == length:
        return a
    pad = a.new_zeros((a.shape[0], length - a.shape[1]) + tuple(a.shape[2:]))
    return torch.cat([a, pad], dim=1)


def to_device(x, device: torch.device) -> torch.Tensor:
    """``x`` (a numpy array or a tensor) on ``device``. A host array bound for
    a card is staged through pinned memory and copied with
    ``non_blocking=True``, so the host does not wait for the card's queue to
    drain (a copy from pageable memory would)."""
    t = torch.as_tensor(x)
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _images_of(image) -> List[np.ndarray]:
    if isinstance(image, (list, tuple)):
        return [imaging.as_uint8_array(i) for i in image]
    return [imaging.as_uint8_array(image)]


def _warn_saved_rung(want: Optional[int], saved: Optional[int], what: str) -> None:
    """A saved rung other than the one requested is served with a warning,
    as in the JAX package."""
    if want is not None and saved is not None and saved != want:
        warnings.warn(f"config requests int{want} {what} but the weights are "
                      f"pre-quantized int{saved}; serving the saved rung",
                      stacklevel=4)


def prepare_transformer(params, config: StreamConfig):
    """Fuse q/k/v (unless the tree is pre-quantized: its leaves stay in their
    saved layout), then quantize — the JAX package's order; in place, one
    block at a time (:class:`_Build` on one rank)."""
    saved = quantize.saved_bits(params)
    _warn_saved_rung(_rung(config, False), saved, "transformer")
    return _Build(None, config, None, None, saved_tfm=saved).transformer(params)


def prepare_vl(params, config: StreamConfig):
    """Quantize the VL tree on its requested rung, in place (a pre-quantized
    tree serves its saved rung)."""
    saved = quantize.saved_bits(params)
    _warn_saved_rung(_rung(config, True), saved, "VL")
    return _Build(None, config, None, None, saved_vl=saved).vl(params)


def _rung(config: StreamConfig, vl: bool) -> Optional[int]:
    if vl:
        return 4 if config.use_int4_vl else (8 if config.use_int8_vl else None)
    return 4 if config.use_int4 else (8 if config.use_int8 else None)


class _Build:
    """The build of the MMDiT and VL trees, one block at a time
    (``parallel/sharding.py::shard_module``): each block is LoRA-fused,
    q/k/v-fused (one rank, ``config.fuse_qkv``; under a mesh q/k/v stay
    unfused, as in JAX) and quantized whole where that is asked — the JAX
    ``from_checkpoint`` order, so the codes and scales are the one-device
    ones — then, under a mesh, sliced to this rank's parts on ``device``.
    The leaves outside the blocks take the same steps last. On one rank
    nothing is sliced and a leaf already on ``device`` stays where it is.
    Used as the inits' ``block_hook`` (:meth:`EditPipeline.create`: the
    whole bf16 tree never exists when a rung is asked, and a rank never
    holds more than its slices and one block) or over a whole tree, host
    views of a checkpoint's files included (:meth:`EditPipeline.from_weights`).
    ``preset`` is read for a LoRA's block count and the mesh's VL axes."""

    def __init__(self, preset: Optional[Preset], config: StreamConfig,
                 mesh: Optional[Mesh], device, lora_entries=None, saved_tfm=None,
                 saved_vl=None):
        self.mesh = mesh
        self.device = None if device is None else torch.device(device)
        self.entries = lora_entries or {}
        for idx, path in self.entries:
            if idx >= preset.model.num_layers:
                raise ValueError(f"LoRA targets block {idx} but model has "
                                 f"{preset.model.num_layers}")
        self.bits = _rung(config, False) if saved_tfm is None else None
        self.bits_vl = _rung(config, True) if saved_vl is None else None
        self.fuse = mesh is None and config.fuse_qkv and saved_tfm is None
        if mesh is None:
            self.tfm_spec = self.vl_spec = lambda p, shape: None
        else:
            sizes = mesh.shape
            vl_axes = sharding.vl_axes(mesh, preset.vl)
            self.tfm_spec = lambda p, shape: sharding.transformer_leaf_spec(p, shape, sizes)
            self.vl_spec = lambda p, shape: sharding.vl_leaf_spec(p, vl_axes, shape, sizes)

    def tfm_block(self, prefix, blk):
        idx = int(prefix[-1])
        mine = [(path, e) for (i, path), e in self.entries.items() if i == idx]

        def transform(node):
            for path, e in mine:
                lora.fuse_entry(node, path, e, 1.0, idx)
            if self.fuse:
                fuse_qkv({"blocks": [node]})
            if self.bits:
                quantize.quantize_transformer({"blocks": [node]}, bits=self.bits)

        return sharding.shard_module(blk, prefix, self.mesh, self.tfm_spec, self.device,
                                     transform if mine or self.fuse or self.bits else None)

    def vl_block(self, prefix, blk):
        return sharding.shard_module(
            blk, prefix, self.mesh, self.vl_spec, self.device,
            (lambda node: quantize.quantize_vl(node, bits=self.bits_vl))
            if self.bits_vl else None)

    def tfm_top(self, params):
        """The top-level MMDiT leaves: whole (quantization and LoRA touch
        only the blocks), on ``device``."""
        return sharding.shard_module(params, (), self.mesh, self.tfm_spec, self.device,
                                     skip_blocks=True)

    def vl_top(self, params):
        def transform(node):
            quantize.quantize_vl({k: {n: v for n, v in part.items() if n != "blocks"}
                                  for k, part in node.items()}, bits=self.bits_vl)

        return sharding.shard_module(params, (), self.mesh, self.vl_spec, self.device,
                                     transform if self.bits_vl else None,
                                     skip_blocks=True)

    def transformer(self, params):
        for i, blk in enumerate(params["blocks"]):
            self.tfm_block(("blocks", str(i)), blk)
        return self.tfm_top(params)

    def vl(self, params):
        for part in ("vision", "lm"):
            for i, blk in enumerate(params[part]["blocks"]):
                self.vl_block((part, "blocks", str(i)), blk)
        return self.vl_top(params)


@dataclass
class EditPipeline:
    """Holds the params of the three models (and of the tiny VAE pair when
    loaded), the encoder and the caches."""

    preset: Preset
    config: StreamConfig
    tfm_params: Any
    vae_params: Any
    encoder: PromptEncoder
    device: torch.device
    prompt_cache: PromptCache
    latent_cache: LatentCache
    # (params, TinyDecoderConfig): serves the output when config.decoder="tiny"
    tiny_vae: Optional[Tuple[Any, Any]] = None
    # (params, TinyEncoderConfig): the stream's temporal frames only; edit
    # conditioning keeps the full VAE, as in the JAX package
    tiny_encoder: Optional[Tuple[Any, Any]] = None
    # the (cfg × model) mesh whose slices the MMDiT and VL trees hold (None:
    # one rank)
    mesh: Optional[Mesh] = None

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    @classmethod
    def create(cls, preset: str | Preset = "qwen-image-edit-2509",
               config: Optional[StreamConfig] = None, seed: int = 0,
               device="cuda", tiny_decoder_path: Optional[str] = None,
               tiny_encoder_path: Optional[str] = None,
               encoder: Optional[PromptEncoder] = None,
               mesh: Optional[Mesh] = None) -> "EditPipeline":
        """Random-init construction: every parameter is made on ``device``
        in its preset dtype from the seed's named generator streams. A tiny
        decoder (encoder) path loads that artifact and implies
        ``decoder="tiny"`` (``encoder="tiny"``). ``encoder`` replaces the
        prompt encoder (the VL encoder is then not made). Each block is
        fused and quantized as ``config`` asks as soon as it is drawn
        (:class:`_Build`), so the whole bf16 tree never exists when a rung
        is asked. Under ``mesh`` every rank draws every leaf in the same
        order (so the full tree is the one-rank tree) and keeps its slices
        of each block as it is drawn: a rank never holds the whole model."""
        if isinstance(preset, str):
            preset = get_preset(preset)
        config = config or StreamConfig(model_preset=preset.name)
        device = torch.device(device)
        mesh = _live(mesh)
        check_config(config, mesh)
        sharding.check_heads(preset.model.num_heads, mesh)
        build = _Build(preset, config, mesh, device)
        vl_params = None
        if config.use_vl_encoder and encoder is None:
            vl_params = build.vl_top(qwen_vl.init(stream(seed, "vl", device), preset.vl,
                                                  device, block_hook=build.vl_block))
        tfm_params = build.tfm_top(tfm.init(stream(seed, "transformer", device),
                                            preset.model, device,
                                            block_hook=build.tfm_block))
        return cls._assemble(preset, config, tfm_params,
                             vae_mod.init(stream(seed, "vae", device), preset.vae, device),
                             vl_params, device, tiny_decoder_path, tiny_encoder_path,
                             seed, encoder, mesh)

    @classmethod
    def from_weights(cls, preset: Preset, config: StreamConfig, tfm_params,
                     vae_params, vl_params=None, device="cuda",
                     lora_path: Optional[str] = None,
                     tiny_decoder_path: Optional[str] = None,
                     tiny_encoder_path: Optional[str] = None,
                     seed: int = 0,
                     encoder: Optional[PromptEncoder] = None,
                     mesh: Optional[Mesh] = None,
                     vl_seed: Optional[int] = None) -> "EditPipeline":
        """Construction from existing port params (e.g. ``convert.from_jax``):
        the LoRA at ``lora_path`` (``.safetensors`` or ``.npz``) fused into
        the dense transformer weights IN PLACE, then q/k/v fused when
        ``config.fuse_qkv``, then the transformer and the VL params quantized
        IN PLACE on the requested rungs — the JAX ``from_checkpoint`` order;
        then the tiny decoder and encoder, loaded or random-init from
        ``seed``. ``encoder``, when given, is the prompt encoder (as the JAX
        ``create`` takes one); else the VL encoder on ``vl_params`` (without
        them, ``vl_seed`` draws its random init, as :meth:`create` draws
        it), or the stub when ``config.use_vl_encoder`` is off.

        The trees (whole, on any device, or host views of a checkpoint's
        files) are prepared one block at a time (:class:`_Build`) and land
        on ``device``. Under ``mesh`` each block is then sliced to this
        rank's parts, q/k/v stay unfused (as in JAX) and the VAE stays
        whole."""
        mesh = _live(mesh)
        check_config(config, mesh)
        device = torch.device(device)
        saved = quantize.saved_bits(tfm_params)
        entries = None
        if lora_path:
            if saved is not None:
                raise ValueError(
                    "LoRA cannot be fused into a quantized checkpoint — fuse "
                    "it into the dense weights, then quantize them "
                    "(StreamConfig use_int8 / use_int4)")
            entries = lora.parse_lora_state_dict(lora.load_lora_weights(lora_path))
        sharding.check_heads(preset.model.num_heads, mesh)
        use_vl = encoder is None and config.use_vl_encoder
        saved_vl = quantize.saved_bits(vl_params) if use_vl and vl_params is not None else None
        _warn_saved_rung(_rung(config, False), saved, "transformer")
        if use_vl:
            _warn_saved_rung(_rung(config, True), saved_vl, "VL")
        build = _Build(preset, config, mesh, device, entries, saved, saved_vl)
        tfm_params = build.transformer(tfm_params)
        if use_vl and vl_params is not None:
            vl_params = build.vl(vl_params)
        elif use_vl and vl_seed is not None:
            vl_params = build.vl_top(qwen_vl.init(
                stream(vl_seed, "vl", device), preset.vl, device,
                block_hook=build.vl_block))
        return cls._assemble(preset, config, tfm_params, vae_params, vl_params, device,
                             tiny_decoder_path, tiny_encoder_path, seed, encoder, mesh)

    @classmethod
    def _assemble(cls, preset, config, tfm_params, vae_params, vl_params, device,
                  tiny_decoder_path, tiny_encoder_path, seed, encoder, mesh):
        """The pipeline around prepared trees: the prompt encoder, the tiny
        pair, the caches."""
        if encoder is None and config.use_vl_encoder:
            encoder = qwen_vl.QwenVLEncoder(
                preset.vl, vl_params, device=device,
                max_len=preset.vl.max_text_len,
                use_flash=config.use_flash_attention, mesh=mesh)
        elif encoder is None:
            encoder = StubEncoder.from_config(preset.vl)
        tiny = _init_tiny_decoder(preset, config, tiny_decoder_path, seed, device)
        if tiny is not None and config.decoder != "tiny":
            config = config.replace(decoder="tiny")
        tiny_enc = _init_tiny_encoder(preset, config, tiny_encoder_path, seed,
                                      device)
        if tiny_enc is not None and config.encoder != "tiny":
            config = config.replace(encoder="tiny")
        return cls(preset=preset, config=config, tfm_params=tfm_params,
                   vae_params=vae_params, encoder=encoder, device=device,
                   prompt_cache=PromptCache(encoder), latent_cache=LatentCache(),
                   tiny_vae=tiny, tiny_encoder=tiny_enc, mesh=mesh)

    @classmethod
    def from_checkpoint(cls, transformer_path: str, vae_path: str,
                        preset: str | Preset = "qwen-image-edit-2509",
                        config: Optional[StreamConfig] = None,
                        vl_path: Optional[str] = None,
                        lora_path: Optional[str] = None, device="cuda",
                        tiny_decoder_path: Optional[str] = None,
                        tiny_encoder_path: Optional[str] = None,
                        mesh: Optional[Mesh] = None) -> "EditPipeline":
        """Construction from the port's converted checkpoints
        (``models/checkpoint.py convert``: LoRA fused → q/k/v fused →
        int8/int4, each optional). The rung and the q/k/v layout are read
        from each checkpoint's metadata (held against its keys; a mismatch
        raises) and every tensor is read straight onto ``device``: a
        pre-quantized transformer never exists in bf16 here. Then
        :meth:`from_weights` fuses the LoRA at ``lora_path`` (refused on a
        quantized checkpoint), fuses q/k/v and quantizes as ``config`` asks
        (a rung other than the saved one is served with a warning). Without
        ``vl_path`` the VL encoder is random from seed 0, as the JAX
        ``from_checkpoint`` makes it. Prompts are encoded by the checkpoint's
        own tokenizer where ``vl_path`` holds a ``tokenizer.json`` or
        ``vocab.json`` + ``merges.txt`` (``qwen_vl.load_hf_tokenizer``:
        ``convert --component vl`` copies them there), else by ``SimpleTokenizer``'s hashed ids; it prints which.
        (The JAX ``from_checkpoint`` always takes ``SimpleTokenizer``.)

        Under ``mesh`` the MMDiT and VL files are mapped, not read: each
        rank copies only its slices of each leaf (a column-parallel slice
        is a contiguous byte range of the file), or, where a block is
        LoRA-fused or quantized here, that block whole first
        (:meth:`from_weights`)."""
        from qwen_image_edit_streamdiffusion_tpu_torch.models import checkpoint as ckpt

        if isinstance(preset, str):
            preset = get_preset(preset)
        config = config or StreamConfig(model_preset=preset.name)
        mesh = _live(mesh)
        check_config(config, mesh)
        device = torch.device(device)
        mapped = mesh is not None
        _, bits, _ = ckpt.layout(transformer_path, "transformer")
        if lora_path and bits:
            raise ValueError(
                "LoRA cannot be fused into a quantized checkpoint — fuse at "
                "conversion time instead: models.checkpoint convert --lora ... "
                "--quantize ...")
        if vl_path and not config.use_vl_encoder:
            raise ValueError("vl_path is given but config.use_vl_encoder is off")
        tfm_params = ckpt.load(transformer_path, device, preset, "transformer",
                               mapped=mapped)
        vae_params = ckpt.load(vae_path, device, preset, "vae")
        vl_params = tokenizer = None
        if vl_path:
            kind = files_in(vl_path)
            if kind:
                tokenizer = qwen_vl.load_hf_tokenizer(vl_path)
                names = "tokenizer.json" if kind == "json" else "vocab.json + merges.txt"
                print(f"[from_checkpoint] prompts are tokenized by {names} in {vl_path} "
                      f"({len(tokenizer)} ids)")
            else:
                print(f"[from_checkpoint] no tokenizer.json or vocab.json + merges.txt in "
                      f"{vl_path}: prompts get SimpleTokenizer's hashed ids")
            vl_params = ckpt.load(vl_path, device, preset, "vl", mapped=mapped)
        pipe = cls.from_weights(preset, config, tfm_params, vae_params, vl_params, device,
                                lora_path=lora_path, tiny_decoder_path=tiny_decoder_path,
                                tiny_encoder_path=tiny_encoder_path, seed=0, mesh=mesh,
                                vl_seed=0)
        if tokenizer is not None:
            pipe.encoder.tokenizer = tokenizer
        return pipe

    def load_tiny_decoder(self, path: str) -> None:
        """Load a distilled tiny decoder and switch the output decode to it
        (``config.decoder="tiny"``)."""
        params, tcfg = tiny_vae.load(path, self.device)
        _check_tiny_cfg(tcfg, self.preset.vae, path)
        self.tiny_vae = (params, tcfg)
        self.config = self.config.replace(decoder="tiny")

    def load_tiny_encoder(self, path: str) -> None:
        """Load a distilled tiny encoder (``config.encoder="tiny"``: the
        stream's temporal frames; edit conditioning keeps the full VAE)."""
        params, ecfg = tiny_vae.load_encoder(path, self.device)
        _check_tiny_enc_cfg(ecfg, self.preset.vae, path)
        self.tiny_encoder = (params, ecfg)
        self.config = self.config.replace(encoder="tiny")

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

    def _upload(self, arrays: Sequence[np.ndarray]) -> torch.Tensor:
        """Same-size uint8 images → f32 RGB (B, H, W, 3) in [0, 255] on the
        device: uint8 as they are, or with ``transfer_format="yuv420"`` packed
        4:2:0 on the host (native formulas) and converted back on the
        device, as the JAX encode graph takes them."""
        if self.config.transfer_format == "yuv420":
            packed = np.stack([colorspace.pack_yuv420_host(a) for a in arrays])
            return colorspace.yuv420_to_rgb(to_device(packed, self.device))
        x = np.stack([np.ascontiguousarray(a) for a in arrays])
        return to_device(x, self.device).float()

    def _encode_params_for(self, stream_kind: str):
        """The encode's params for a stream frame (``"key"`` or
        ``"temporal"``): the tiny encoder's on temporal frames when
        ``config.encoder="tiny"`` and one is loaded, else the full VAE's
        (keyframes and edits re-anchor at exact quality)."""
        if (stream_kind == "temporal" and self.config.encoder == "tiny"
                and self.tiny_encoder is not None):
            return self.tiny_encoder[0]
        return self.vae_params

    def _encode_pixels(self, arrays: Sequence[np.ndarray], kind: str = "full",
                       params=None) -> torch.Tensor:
        """One batched encode of same-size images → packed tokens (B, L, C) in
        the model dtype: the full VAE (posterior mode), or with
        ``kind="tiny"`` the tiny encoder (``params``: its tree, as
        :meth:`_encode_params_for` gives it)."""
        img = self._upload(arrays) / 127.5 - 1.0
        if kind == "tiny":
            z = tiny_vae.encode(self.tiny_encoder[0] if params is None else params,
                                self.tiny_encoder[1], img)
        else:
            vdt = getattr(torch, self.preset.vae.dtype)
            z = vae_mod.encode(self.vae_params if params is None else params,
                               self.preset.vae, img.to(vdt))
        return tfm.pack_latents(z.float()).to(self._mdt)

    @staticmethod
    def _cond_shapes(arrays: Sequence[np.ndarray]):
        return [(1, (a.shape[0] // 8) // 2, (a.shape[1] // 8) // 2) for a in arrays]

    def encode_condition_latents(self, vae_images: List[np.ndarray]):
        """VAE-encode condition images → packed tokens in the model dtype,
        concatenated along the sequence, + their (1, h/2, w/2) rope shapes."""
        tokens = [self._encode_pixels([arr]) for arr in vae_images]
        return torch.cat(tokens, dim=1), self._cond_shapes(vae_images)

    def _encode_conditions_many(self, waves: List[List[np.ndarray]]):
        """Condition latents of several items' ``vae_images``: a latent-cache
        probe per item, then the misses' images deduplicated by content hash
        and encoded in one batched VAE call per resolution. One
        (cond_tokens, cond_shapes) per item, as
        :meth:`encode_condition_latents` gives it."""
        out: List[Any] = [self.latent_cache.lookup(imgs) for imgs in waves]
        misses = [i for i, hit in enumerate(out) if hit is None]
        uniq: Dict[str, np.ndarray] = {}
        for i in misses:
            for arr in waves[i]:
                uniq.setdefault(image_fingerprint(arr), arr)
        by_hw: Dict[Tuple[int, int], List[str]] = {}
        for fp, arr in uniq.items():
            by_hw.setdefault(tuple(arr.shape[:2]), []).append(fp)
        tok_by_fp: Dict[str, torch.Tensor] = {}
        for fps in by_hw.values():
            toks = self._encode_pixels([uniq[fp] for fp in fps])
            for r, fp in enumerate(fps):
                tok_by_fp[fp] = toks[r:r + 1]
        for i in misses:
            toks = [tok_by_fp[image_fingerprint(a)] for a in waves[i]]
            out[i] = (torch.cat(toks, dim=1), self._cond_shapes(waves[i]))
            self.latent_cache.store(waves[i], out[i])
        return out

    def _text_rows(self, emb) -> Tuple[torch.Tensor, torch.Tensor]:
        """A prompt embedding → (1, L, D) model-dtype text, (1, L) mask."""
        txt = to_device(emb.embeds, self.device).to(self._mdt)[None]
        return txt, to_device(emb.mask, self.device)[None]

    def _noise(self, shape: Tuple[int, ...], seed: int) -> torch.Tensor:
        """Seeded packed-noise tokens from the "latents" stream."""
        noise = torch.randn(shape, generator=stream(seed, "latents", self.device),
                            dtype=torch.float32, device=self.device)
        return tfm.pack_latents(noise).to(self._mdt)

    def _denoise(self, x, cond_tokens, txt, mask, img_shapes, steps: int,
                 cfg_mode: str = "none", neg_txt=None, neg_mask=None,
                 cfg_scale: float = 1.0, start_step: int = 0):
        """The flow-matching loop of the JAX ``_denoise_fn``: MMDiT velocity
        over [target ⊕ condition] tokens, guided by ``cfg_mode``, Euler step
        on the target tokens in f32, over steps ``start_step`` .. ``steps`` − 1
        of the ``steps``-step schedule (the stream's temporal frames run its
        tail).

        - ``none``: one forward a step;
        - ``sequential``: the positive and the negative forward;
        - ``batched``: one forward over [x, x] with the positive and the
          negative text rows;
        - ``parallel``: ``batched`` with the pair's rows split over the
          mesh's cfg groups (group 0 the positive rows, group 1 the
          negative ones, with a cfg axis of 2) and the velocities
          all-gathered; without a cfg axis (or where the rows do not
          divide) it is exactly ``batched``;
        - ``rcfg``: the first step run (``start_step``) one batched pair,
          whose residual v_pos − v_neg (f32) then stands in for the
          negative: one forward more than the steps run;
        - ``rcfg-self``: no negative forward; the virtual negative
          (x − anchor)/σ points at the first condition image's latents. It
          takes ``rcfg`` with the JAX warning when that grid differs from
          the target's.

        Under a mesh the MMDiT runs tensor-parallel over the model group,
        and a ``none`` / ``rcfg`` / ``rcfg-self`` call of several rows that
        the cfg groups divide splits its rows over them (the JAX
        ``dp_rows``; ``rcfg``'s first-step pair of the local rows), the
        latents all-gathered after the loop. Rows that do not divide run on
        every cfg group, as the unconstrained JAX graph runs them."""
        if cfg_mode not in CFG_MODES:
            raise ValueError(f"unknown cfg_mode {cfg_mode!r}")
        if cfg_mode == "rcfg-self" and (len(img_shapes) < 2
                                        or img_shapes[1] != img_shapes[0]):
            warnings.warn(
                "rcfg-self needs the first condition latent grid "
                f"{tuple(img_shapes[1:2])} to match the target grid "
                f"{img_shapes[0]} for the virtual-negative anchor; "
                "using onetime-negative rcfg instead")
            cfg_mode = "rcfg"
        mesh = self.mesh
        tp = mesh.model_group if mesh is not None else SINGLE
        cg = mesh.cfg_group if mesh is not None else SINGLE
        rows = x.shape[0]
        if cfg_mode == "parallel" and not (sharding.has_axis(mesh, "cfg")
                                           and 2 * rows % cg.size == 0):
            cfg_mode = "batched"
        dp_rows = (cfg_mode in ("none", "rcfg", "rcfg-self") and rows > 1
                   and cg.size > 1 and rows % cg.size == 0)
        if dp_rows:
            n = rows // cg.size
            x, cond_tokens, txt, mask, neg_txt, neg_mask = (
                a[cg.rank * n:(cg.rank + 1) * n]
                for a in (x, cond_tokens, txt, mask, neg_txt, neg_mask))
        mcfg = self.preset.model
        l_target = img_shapes[0][0] * img_shapes[0][1] * img_shapes[0][2]
        schedule = sched.make_schedule(steps, l_target, self.preset.scheduler)
        sigmas = schedule.sigmas
        ropes = tfm.make_rope(mcfg, img_shapes, txt.shape[1], self.device)

        def velocity(i, x, cond, txt, mask):
            t = torch.full((x.shape[0],), float(schedule.timesteps[i]),
                           dtype=torch.float32, device=self.device)
            v = tfm.forward(self.tfm_params, mcfg, torch.cat([x, cond], 1), txt,
                            t, ropes, txt_mask=mask,
                            use_flash=self.config.use_flash_attention, tp=tp)
            return v[:, :l_target]

        def velocity_split(i, x, cond, txt, mask):
            """The pair's rows split over the cfg groups, then gathered."""
            n = x.shape[0] // cg.size
            part = slice(cg.rank * n, (cg.rank + 1) * n)
            v = velocity(i, x[part], cond[part], txt[part], mask[part])
            return distributed.all_gather(v, cg, dim=0)

        def pair(a, b):
            return torch.cat([a, b], dim=0)

        if cfg_mode in ("batched", "parallel", "rcfg"):
            cond2, txt2, mask2 = (pair(cond_tokens, cond_tokens),
                                  pair(txt, neg_txt), pair(mask, neg_mask))
        if cfg_mode == "rcfg-self":
            anchor = cond_tokens[:, :l_target].float()
        delta = None
        for i in range(start_step, steps):
            if cfg_mode == "none":
                v = velocity(i, x, cond_tokens, txt, mask)
            else:
                if cfg_mode == "parallel":
                    pos, neg = velocity_split(i, pair(x, x), cond2, txt2,
                                              mask2).chunk(2)
                elif cfg_mode == "batched" or (cfg_mode == "rcfg" and i == start_step):
                    pos, neg = velocity(i, pair(x, x), cond2, txt2, mask2).chunk(2)
                    if cfg_mode == "rcfg":
                        delta = pos.float() - neg.float()
                elif cfg_mode == "sequential":
                    pos = velocity(i, x, cond_tokens, txt, mask)
                    neg = velocity(i, x, cond_tokens, neg_txt, neg_mask)
                else:
                    pos = velocity(i, x, cond_tokens, txt, mask)
                    if cfg_mode == "rcfg":
                        neg = (pos.float() - delta).to(pos.dtype)
                    else:
                        neg = rcfg_self_negative(x, anchor, sigmas[i], pos.dtype)
                v = combine_cfg(pos, neg, cfg_scale)
            x = sched.euler_step(x, v, sigmas[i], sigmas[i + 1])
        if dp_rows:
            x = distributed.all_gather(x, cg, dim=0)
        return x

    def _decode(self, tokens: torch.Tensor, zh: int, zw: int):
        """Packed tokens → (pixels on the device, f32 latents): unpack, decode
        (the tiny decoder when ``config.decoder="tiny"`` and one is loaded,
        else the full VAE, with the JAX warning when none is), then clip and
        (x·0.5+0.5)·255 in f32; the pixels are uint8 RGB (+0.5, truncated)
        or, with ``transfer_format="yuv420"``, the packed 4:2:0 buffer
        (B, H/2, W/2, 6) from the unrounded values."""
        z = tfm.unpack_latents(tokens.float(), zh, zw)
        tiny = None
        if self.config.decoder == "tiny":
            if self.tiny_vae is None:
                warnings.warn(
                    "config.decoder='tiny' but no tiny decoder is loaded "
                    "(load_tiny_decoder / create with decoder='tiny'); "
                    "falling back to the full VAE decoder")
            else:
                tiny = self.tiny_vae
        if tiny is not None:
            x = tiny_vae.decode(tiny[0], tiny[1], z)
        else:
            vdt = getattr(torch, self.preset.vae.dtype)
            x = vae_mod.decode(self.vae_params, self.preset.vae, z.to(vdt))
        x32 = ((x.float() * 0.5 + 0.5) * 255.0).clamp(0.0, 255.0)
        if self.config.transfer_format == "yuv420":
            return colorspace.rgb_to_yuv420(x32), z
        return (x32 + 0.5).clamp(0.0, 255.0).to(torch.uint8), z

    def _fetch_images(self, pixels: torch.Tensor) -> List[np.ndarray]:
        """The decode's pixels → host (H, W, 3) uint8 arrays; a packed 4:2:0
        buffer is unpacked on the host (native formulas)."""
        host = pixels.cpu().numpy()
        if self.config.transfer_format == "yuv420":
            return [colorspace.yuv420_to_rgb_host(p) for p in host]
        return [host[i] for i in range(host.shape[0])]

    # ------------------------------------------------------------------
    # Entry points
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def __call__(self, image, prompt: str, negative_prompt: Optional[str] = None,
                 num_inference_steps: Optional[int] = None,
                 guidance_scale: float = 1.0,  # embedded guidance; no-op
                 true_cfg_scale: Optional[float] = None,
                 seed: Optional[int] = None, height: Optional[int] = None,
                 width: Optional[int] = None,
                 num_images_per_prompt: int = 1) -> EditResult:
        """One edit. True CFG runs when a negative prompt is given and the
        scale exceeds 1 (the upstream ``do_true_cfg``), in
        ``config.cfg_mode``; the positive and negative prompts are encoded
        as one wave, the shorter text padded with zero rows and False mask.
        ``num_images_per_prompt`` > 1 goes through :meth:`edit_many`: N
        variations (per-row noise) in one denoise call."""
        t_start = time.time()
        images = _images_of(image)
        n_out = max(1, int(num_images_per_prompt))
        if n_out > 1:
            return self.edit_many(
                [{"image": images, "prompt": prompt,
                  "negative_prompt": negative_prompt, "seed": seed,
                  "num_images": n_out, "height": height, "width": width}],
                num_inference_steps=num_inference_steps,
                true_cfg_scale=true_cfg_scale)[0]
        steps = num_inference_steps or self.config.num_inference_steps
        cfg_scale = (true_cfg_scale if true_cfg_scale is not None
                     else self.config.true_cfg_scale)
        seed = self.config.seed if seed is None else seed
        do_cfg = negative_prompt is not None and cfg_scale > 1.0
        cfg_mode = self.config.cfg_mode if do_cfg else "none"

        out_h, out_w, vae_images, vl_images = self._prepare_images(
            images, height, width)

        if do_cfg:
            emb, neg = self.prompt_cache.encode_many(
                [(prompt, vl_images), (negative_prompt, vl_images)])
        else:
            emb = self.prompt_cache.encode(prompt, vl_images)
        txt, mask = self._text_rows(emb)
        neg_txt, neg_mask = self._text_rows(neg) if do_cfg else (txt, mask)
        length = max(txt.shape[1], neg_txt.shape[1])
        txt, mask, neg_txt, neg_mask = (_pad_rows(a, length) for a in
                                        (txt, mask, neg_txt, neg_mask))

        cond_tokens, cond_shapes = self.latent_cache.get_or_encode(
            vae_images, self.encode_condition_latents)

        zh, zw = out_h // 8, out_w // 8
        x0 = self._noise((1, zh, zw, self.preset.vae.latent_channels), seed)
        img_shapes = tuple([(1, zh // 2, zw // 2)] + list(cond_shapes))
        final = self._denoise(x0, cond_tokens, txt, mask, img_shapes, steps,
                              cfg_mode, neg_txt, neg_mask, cfg_scale)
        pixels, latents = self._decode(final, zh, zw)
        return EditResult(images=self._fetch_images(pixels), latents=latents,
                          elapsed=time.time() - t_start)

    @torch.inference_mode()
    def edit_many(self, items: Sequence[Dict[str, Any]],
                  num_inference_steps: Optional[int] = None,
                  true_cfg_scale: Optional[float] = None) -> List[EditResult]:
        """Several edit requests in ONE denoise call, as the JAX
        ``edit_many``: one prompt-encode wave for every item's positive (and
        negative) prompt, one batched VAE encode per resolution for the
        latent-cache misses, per-item seeded noise, conditioning tiled per
        ``num_images``, one shared text length, one decode; results split
        per item. Items are dicts with ``image`` (an image or a list),
        ``prompt`` and optional ``negative_prompt`` / ``seed`` /
        ``num_images`` / ``height`` / ``width``; they must share output
        size, condition geometry and CFG-ness (else ``ValueError``)."""
        t_start = time.time()
        steps = num_inference_steps or self.config.num_inference_steps
        cfg_scale = (true_cfg_scale if true_cfg_scale is not None
                     else self.config.true_cfg_scale)

        metas, enc_reqs = [], []
        for it in items:
            negative_prompt = it.get("negative_prompt")
            do_cfg = negative_prompt is not None and cfg_scale > 1.0
            out_h, out_w, vae_images, vl_images = self._prepare_images(
                _images_of(it["image"]), it.get("height"), it.get("width"))
            pos_i = len(enc_reqs)
            enc_reqs.append((it["prompt"], vl_images))
            neg_i = None
            if do_cfg:
                neg_i = len(enc_reqs)
                enc_reqs.append((negative_prompt, vl_images))
            metas.append((it, do_cfg, out_h, out_w, vae_images, pos_i, neg_i))

        embs = self.prompt_cache.encode_many(enc_reqs)
        conds = self._encode_conditions_many([m[4] for m in metas])

        prepped, geom = [], None
        for (it, do_cfg, out_h, out_w, _, pos_i, neg_i), cond in zip(metas, conds):
            cond_tokens, cond_shapes = cond
            txt, mask = self._text_rows(embs[pos_i])
            neg_txt, neg_mask = (self._text_rows(embs[neg_i]) if do_cfg
                                 else (txt, mask))
            g = (out_h, out_w, tuple(cond_shapes), do_cfg)
            if geom is None:
                geom = g
            elif g != geom:
                raise ValueError(
                    "edit_many items must share output size, condition "
                    f"geometry and CFG-ness: {g} != {geom}")
            prepped.append((txt, mask, neg_txt, neg_mask, cond_tokens,
                            it.get("seed"), max(1, int(it.get("num_images", 1)))))

        out_h, out_w, cond_shapes, do_cfg = geom
        cfg_mode = self.config.cfg_mode if do_cfg else "none"
        zh, zw = out_h // 8, out_w // 8
        length = max(max(p[0].shape[1], p[2].shape[1]) for p in prepped)
        rows: Dict[str, List[torch.Tensor]] = {
            k: [] for k in ("x0", "cond", "txt", "mask", "ntxt", "nmask")}
        for txt, mask, neg_txt, neg_mask, cond_tokens, seed, n_i in prepped:
            seed = self.config.seed if seed is None else seed
            rows["x0"].append(self._noise(
                (n_i, zh, zw, self.preset.vae.latent_channels), seed))
            for key, a in (("cond", cond_tokens), ("txt", txt), ("mask", mask),
                           ("ntxt", neg_txt), ("nmask", neg_mask)):
                a = a if key == "cond" else _pad_rows(a, length)
                rows[key].append(a.repeat((n_i,) + (1,) * (a.dim() - 1)))
        cat = {k: torch.cat(v, dim=0) for k, v in rows.items()}

        img_shapes = tuple([(1, zh // 2, zw // 2)] + list(cond_shapes))
        final = self._denoise(cat["x0"], cat["cond"], cat["txt"], cat["mask"],
                              img_shapes, steps, cfg_mode, cat["ntxt"],
                              cat["nmask"], cfg_scale)
        pixels, latents = self._decode(final, zh, zw)
        images = self._fetch_images(pixels)
        elapsed = time.time() - t_start
        results, row = [], 0
        for *_, n_i in prepped:
            results.append(EditResult(images=images[row:row + n_i],
                                      latents=latents[row:row + n_i],
                                      elapsed=elapsed))
            row += n_i
        return results

    def warmup(self, height: Optional[int] = None, width: Optional[int] = None,
               steps: Optional[int] = None, runs: int = 1,
               cfg: bool = False) -> float:
        """Serve the standard request on a gray image (the reference warms up
        with a gray 512² image); ``cfg=True`` also serves the guided variant
        with the server's ``use_cfg`` convention (an empty negative prompt)
        and one more cond-only call, as the JAX ``warmup`` does. Returns the
        wall seconds."""
        h = height or self.config.height or 512
        w = width or self.config.width or 512
        dummy = np.full((h, w, 3), 128, np.uint8)  # Pillow's "gray"
        t0 = time.time()
        n_steps = steps or self.config.num_inference_steps
        prompt = "Transform into oil painting style"
        for _ in range(max(1, runs)):
            self(dummy, prompt, num_inference_steps=n_steps)
        if cfg:
            self(dummy, prompt, negative_prompt="", num_inference_steps=n_steps)
            self(dummy, prompt, num_inference_steps=n_steps)
        return time.time() - t0
