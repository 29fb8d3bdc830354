"""Qwen2.5-VL prompt/vision encoder.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/models/qwen_vl.py``:

- vision tower: 14×14 patch embed (temporal patch 2, frame duplicated),
  RMSNorm → attention with 2D rotate-half RoPE → SwiGLU blocks, windowed
  attention except at ``fullatt_block_indexes``, 2×2 merger MLP (gelu tanh).
  Its attention has head_dim 80 and stays plain torch, as XLA runs it in JAX;
- language model: GQA decoder with M-RoPE sections; its causal attention
  goes through K2 (ops.flash_attention.causal_attention) when the shape
  gate passes;
- :class:`QwenVLEncoder`: chat template, 128-token bucket, the template
  prefix dropped from the hidden states, 64-token output bucket + mask; a
  wave of requests shares its vision work and batches its LM rows
  (``encode_many``).

Under a mesh (``QwenVLEncoder(mesh=...)``) the encoder holds its slices of
the leaves over the axes ``parallel/sharding.py::vl_axes`` picks (every axis
where the q, kv and vision heads divide, else ``model``, else none) and
runs on its own heads: q/k/v, the SwiGLU gate/up, the merger's ``fc1`` and
the patch embed are column-parallel (the patch embed all-gathered),
``o_proj``, ``down``, the vision ``proj`` and the merger's ``fc2``
row-parallel, and the embed table's hidden dim is all-gathered after the
lookup. :func:`vl_groups` gives each site's group.

The chat template and position tables below are pure Python/numpy, copied
verbatim from the JAX module (which imports jax and cannot be reused);
:func:`load_hf_tokenizer` reads the checkpoint's ``tokenizer.json`` with
``models/tokenizer.py``.
"""

from __future__ import annotations

import hashlib
import math
import re
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from qwen_image_edit_streamdiffusion_tpu_torch.core import imaging
from qwen_image_edit_streamdiffusion_tpu_torch.core.config import VLConfig
from qwen_image_edit_streamdiffusion_tpu_torch.core.meshes import SINGLE, Group, Mesh
from qwen_image_edit_streamdiffusion_tpu_torch.models.common import (
    Params,
    gather_linear,
    gelu_tanh,
    linear,
    linear_init,
    rms_norm,
    rms_norm_init,
    row_linear,
)
from qwen_image_edit_streamdiffusion_tpu_torch.models.text_encoder import (
    SYSTEM_PROMPT,
    PromptEmbedding,
)
from qwen_image_edit_streamdiffusion_tpu_torch.ops import flash_attention as fa
from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed
from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.cache import image_fingerprint

_NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def _swiglu(p: Params, x: torch.Tensor, group: Group = SINGLE) -> torch.Tensor:
    return row_linear(p["down"], F.silu(linear(p["gate"], x)) * linear(p["up"], x),
                      group)


def vl_groups(cfg: VLConfig, mesh: Optional[Mesh]) -> Dict[str, Group]:
    """The group of each sharded site of the encoder under ``mesh`` (all of
    one rank without a mesh): the fit of :func:`sharding.vl_axes` to the
    dimension that the site splits, as its leaves' specs slice it."""
    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import sharding

    axes = sharding.vl_axes(mesh, cfg) if mesh is not None else ()

    def g(dim: int) -> Group:
        return sharding.site_group(mesh, axes, dim)

    return {"lm_attn": g(cfg.hidden_size), "lm_mlp": g(cfg.intermediate_size),
            "vis_attn": g(cfg.vision_hidden), "vis_mlp": g(cfg.vision_intermediate),
            "merger": g(cfg.vision_hidden * cfg.spatial_merge_size ** 2)}


_ONE_RANK = {k: SINGLE for k in ("lm_attn", "lm_mlp", "vis_attn", "vis_mlp", "merger")}


def _swiglu_init(gen, dim: int, hidden: int, dtype, device, bias: bool = False
                 ) -> Params:
    return {"gate": linear_init(gen, dim, hidden, dtype, device, bias=bias),
            "up": linear_init(gen, dim, hidden, dtype, device, bias=bias),
            "down": linear_init(gen, hidden, dim, dtype, device, bias=bias)}


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def _apply_rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """HF rotate-half convention in f32: cos/sin already repeated to head_dim."""
    x32 = x.float()
    return (x32 * cos + _rotate_half(x32) * sin).to(x.dtype)


# ---------------------------------------------------------------------------
# Vision tower
# ---------------------------------------------------------------------------


def vision_init(gen, cfg: VLConfig, device="cpu", block_hook=None) -> Params:
    dtype = getattr(torch, cfg.dtype)
    d = cfg.vision_hidden
    patch_in = 3 * cfg.temporal_patch_size * cfg.patch_size * cfg.patch_size
    hook = block_hook or (lambda prefix, blk: blk)
    blocks = []
    for i in range(cfg.vision_depth):
        blocks.append(hook(("vision", "blocks", str(i)), {
            "norm1": rms_norm_init(d, dtype, device),
            "qkv": linear_init(gen, d, 3 * d, dtype, device),
            "proj": linear_init(gen, d, d, dtype, device),
            "norm2": rms_norm_init(d, dtype, device),
            "mlp": _swiglu_init(gen, d, cfg.vision_intermediate, dtype, device,
                                bias=True),
        }))
    merge_dim = d * cfg.spatial_merge_size ** 2
    return {
        "patch_embed": linear_init(gen, patch_in, d, dtype, device, bias=False),
        "blocks": blocks,
        "merger": {
            "ln_q": rms_norm_init(d, dtype, device),
            "fc1": linear_init(gen, merge_dim, merge_dim, dtype, device),
            "fc2": linear_init(gen, merge_dim, cfg.vision_out_dim, dtype, device),
        },
    }


def _vision_rope(cfg: VLConfig, gh: int, gw: int) -> Tuple[np.ndarray, np.ndarray]:
    """2D rotary tables for the (gh, gw) patch grid (L, head_dim)."""
    head_dim = cfg.vision_hidden // cfg.vision_heads
    quarter = head_dim // 4
    inv = 1.0 / (10000.0 ** (np.arange(quarter, dtype=np.float64) / quarter))
    hs = np.repeat(np.arange(gh), gw).astype(np.float64)
    ws = np.tile(np.arange(gw), gh).astype(np.float64)
    ang = np.concatenate([np.outer(hs, inv), np.outer(ws, inv)], axis=-1)
    ang = np.concatenate([ang, ang], axis=-1)  # (L, head_dim)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _window_partition(cfg: VLConfig, gh: int, gw: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(perm, win_ids_sorted): a stable window-major token order and each
    sorted token's window id; edge windows may be ragged."""
    wp = cfg.window_size // cfg.patch_size  # patches per window side
    r = np.repeat(np.arange(gh), gw)
    c = np.tile(np.arange(gw), gh)
    nww = -(-gw // wp)  # ceil: ragged edge windows allowed
    win = (r // wp) * nww + (c // wp)
    perm = np.argsort(win, kind="stable")
    return perm, win[perm]


def _plain_attention(q, k, v, key_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q/k/v (..., L, hd) → softmax attention with f32 scores; key_mask
    broadcasts against the (..., Lq, Lk) scores (True = attend)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if key_mask is not None:
        s = s.masked_fill(~key_mask, _NEG_INF)
    return torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)


def vision_forward(params: Params, cfg: VLConfig, patches: torch.Tensor,
                   gh: int, gw: int, groups: Optional[Dict[str, Group]] = None
                   ) -> torch.Tensor:
    """patches (gh·gw, 3·tp·p²), row-major grid, or (B, gh·gw, 3·tp·p²) for
    B images of one grid (the JAX ``_vision_fn_batched``'s vmap) → merged
    vision tokens (gh·gw/4, vision_out_dim), or (B, …). Windows are padded
    to the longest and padded key slots are masked (the static form of HF's
    varlen window attention). ``groups``: :func:`vl_groups` of the mesh
    whose slices ``params`` holds."""
    if patches.dim() == 2:
        return vision_forward(params, cfg, patches[None], gh, gw, groups)[0]
    groups = groups or _ONE_RANK
    ga = groups["vis_attn"]
    hd = cfg.vision_hidden // cfg.vision_heads
    nh = cfg.vision_heads // ga.size  # this rank's heads
    da = nh * hd
    dev = patches.device
    bsz = patches.shape[0]
    x = gather_linear(params["patch_embed"], patches, ga)  # (B, L, d)
    l = gh * gw

    cos_np, sin_np = _vision_rope(cfg, gh, gw)
    perm, win_ids = _window_partition(cfg, gh, gw)
    inv_perm = torch.from_numpy(np.argsort(perm)).to(dev)
    x = x[:, torch.from_numpy(perm).to(dev)]
    cos_t = torch.from_numpy(cos_np[perm]).to(dev)[:, None]  # (L, 1, hd)
    sin_t = torch.from_numpy(sin_np[perm]).to(dev)[:, None]

    counts = np.bincount(win_ids)
    nw, wmax = counts.size, int(counts.max())
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(l) - np.repeat(starts, counts)
    idx_np = np.zeros((nw, wmax), np.int64)
    valid_np = np.zeros((nw, wmax), bool)
    idx_np[win_ids, slot] = np.arange(l)
    valid_np[win_ids, slot] = True
    idx = torch.from_numpy(idx_np).to(dev)
    key_mask = torch.from_numpy(valid_np).to(dev)[:, None, None, :]
    flat = torch.from_numpy(win_ids * wmax + slot).to(dev)

    for i, blk in enumerate(params["blocks"]):
        h = rms_norm(blk["norm1"], x, cfg.rms_eps)
        qkv = linear(blk["qkv"], h).reshape(bsz, l, 3, nh, hd)
        q = _apply_rope_half(qkv[:, :, 0], cos_t, sin_t)  # (B, L, nh, hd)
        k = _apply_rope_half(qkv[:, :, 1], cos_t, sin_t)
        v = qkv[:, :, 2]
        if i in cfg.fullatt_block_indexes:
            o = _plain_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), None)  # (B, nh, L, hd)
            o = o.transpose(1, 2).reshape(bsz, l, da)
        else:
            qw, kw, vw = (t[:, idx].transpose(2, 3) for t in (q, k, v))
            o = _plain_attention(qw, kw, vw, key_mask)  # (B, nw, nh, wmax, hd)
            o = o.transpose(2, 3).reshape(bsz, nw * wmax, da)[:, flat]
        x = x + row_linear(blk["proj"], o, ga)
        x = x + _swiglu(blk["mlp"], rms_norm(blk["norm2"], x, cfg.rms_eps),
                        groups["vis_mlp"])

    x = x[:, inv_perm]  # back to row-major grid order
    m = cfg.spatial_merge_size
    d = cfg.vision_hidden
    x = rms_norm(params["merger"]["ln_q"], x, cfg.rms_eps)
    x = x.reshape(bsz, gh // m, m, gw // m, m, d).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(bsz, (gh // m) * (gw // m), m * m * d)
    return row_linear(params["merger"]["fc2"],
                      gelu_tanh(linear(params["merger"]["fc1"], x)),
                      groups["merger"])


# ---------------------------------------------------------------------------
# Language model
# ---------------------------------------------------------------------------


def lm_init(gen, cfg: VLConfig, device="cpu", block_hook=None) -> Params:
    dtype = getattr(torch, cfg.dtype)
    hook = block_hook or (lambda prefix, blk: blk)
    d = cfg.hidden_size
    kv_dim = cfg.num_kv_heads * (d // cfg.num_heads)
    embed = torch.empty((cfg.vocab_size, d), dtype=dtype, device=device)
    if embed.device.type != "meta":
        embed.normal_(0.0, 0.02, generator=gen)
    blocks = []
    for i in range(cfg.num_layers):
        blocks.append(hook(("lm", "blocks", str(i)), {
            "input_norm": rms_norm_init(d, dtype, device),
            "q_proj": linear_init(gen, d, d, dtype, device),
            "k_proj": linear_init(gen, d, kv_dim, dtype, device),
            "v_proj": linear_init(gen, d, kv_dim, dtype, device),
            "o_proj": linear_init(gen, d, d, dtype, device, bias=False),
            "post_norm": rms_norm_init(d, dtype, device),
            "mlp": _swiglu_init(gen, d, cfg.intermediate_size, dtype, device),
        }))
    return {"embed": embed, "blocks": blocks, "norm": rms_norm_init(d, dtype, device)}


def init(gen, cfg: VLConfig, device="cpu", block_hook=None) -> Params:
    """Counterpart of the JAX ``_init_all``: {"vision", "lm"}.
    ``block_hook(("vision" | "lm", "blocks", str(i)), block)`` replaces each
    block as soon as it is drawn."""
    return {"vision": vision_init(gen, cfg, device, block_hook),
            "lm": lm_init(gen, cfg, device, block_hook)}


def _mrope_tables(cfg: VLConfig, pos: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """pos: (3, L) int (t, h, w) positions → (L, head_dim) cos/sin using the
    mrope section layout (first s0 freqs from t, next s1 from h, s2 from w)."""
    hd = cfg.hidden_size // cfg.num_heads
    half = hd // 2
    inv = 1.0 / (cfg.rope_theta ** (np.arange(half, dtype=np.float64) / half))
    ang3 = pos[:, :, None].astype(np.float64) * inv[None, None, :]
    sec = np.concatenate([
        np.full(s, i) for i, s in enumerate(cfg.mrope_sections)
    ]).astype(np.int64)
    ang = np.take_along_axis(
        ang3.transpose(1, 2, 0), sec[None, :, None], axis=2
    )[:, :, 0]  # (L, half)
    ang = np.concatenate([ang, ang], axis=-1)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _lm_attention(q, k, v, attn_mask: Optional[torch.Tensor],
                  use_flash: bool) -> torch.Tensor:
    """Causal GQA: q (B, H, L, D), k/v (B, Hkv, L, D) → (B, H, L, D), one
    launch for every row. K2 takes no mask: each row's padding is a suffix,
    so its padded keys sit above the diagonal of each of its real rows. The
    other path is the JAX package's grouped-head XLA attention (f32
    natural-base softmax, P cast to V's dtype), with the (B, L) attn_mask
    applied per row as there."""
    if use_flash and fa.supported(q, k, v):
        return fa.causal_attention(q, k, v)
    b, nh, l, hd = q.shape
    nkv = k.shape[1]
    keep = torch.ones((l, l), dtype=torch.bool, device=q.device).tril()[None]
    if attn_mask is not None:
        keep = keep & attn_mask.bool()[:, None, :]
    qg = q.reshape(b, nkv, nh // nkv, l, hd)
    s = torch.matmul(qg.float(), k.float()[:, :, None].transpose(-1, -2)) * hd ** -0.5
    s = s.masked_fill(~keep[:, None, None], -1e30)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p, v[:, :, None]).reshape(b, nh, l, hd)


def lm_forward(params: Params, cfg: VLConfig, input_embeds: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor,
               attn_mask: Optional[torch.Tensor] = None,
               use_flash: bool = True,
               groups: Optional[Dict[str, Group]] = None) -> torch.Tensor:
    """Causal decoder → final hidden states: one sequence (L, hidden) with
    cos/sin (L, head_dim) and attn_mask (L,), or B rows (B, L, hidden) with
    (B, L, head_dim) and (B, L) (the JAX ``_lm_fn_batched``'s vmap).
    ``groups``: :func:`vl_groups` of the mesh whose slices ``params`` holds
    (this rank's q and kv heads; the head dim is the global one)."""
    if input_embeds.dim() == 2:
        mask = None if attn_mask is None else attn_mask[None]
        return lm_forward(params, cfg, input_embeds[None], cos[None], sin[None],
                          mask, use_flash, groups)[0]
    groups = groups or _ONE_RANK
    ga = groups["lm_attn"]
    d = cfg.hidden_size
    hd = d // cfg.num_heads
    nh, nkv = cfg.num_heads // ga.size, cfg.num_kv_heads // ga.size
    b, l = input_embeds.shape[:2]
    cos_b, sin_b = cos[:, None], sin[:, None]

    def heads(t, n):
        return t.reshape(b, l, n, hd).transpose(1, 2)

    x = input_embeds
    for blk in params["blocks"]:
        h = rms_norm(blk["input_norm"], x, cfg.rms_eps)
        q = _apply_rope_half(heads(linear(blk["q_proj"], h), nh), cos_b, sin_b)
        k = _apply_rope_half(heads(linear(blk["k_proj"], h), nkv), cos_b, sin_b)
        v = heads(linear(blk["v_proj"], h), nkv).contiguous()
        o = _lm_attention(q.contiguous(), k.contiguous(), v, attn_mask, use_flash)
        x = x + row_linear(blk["o_proj"], o.transpose(1, 2).reshape(b, l, nh * hd), ga)
        x = x + _swiglu(blk["mlp"], rms_norm(blk["post_norm"], x, cfg.rms_eps),
                        groups["lm_mlp"])
    return rms_norm(params["norm"], x, cfg.rms_eps)


# ---------------------------------------------------------------------------
# Tokenizer + chat template (verbatim from the JAX module)
# ---------------------------------------------------------------------------

IM_START = 151644
IM_END = 151645
IMAGE_PAD = 151655
VISION_START = 151652
VISION_END = 151653

_SPECIAL_IDS = {
    "<|im_start|>": IM_START,
    "<|im_end|>": IM_END,
    "<|image_pad|>": IMAGE_PAD,
    "<|vision_start|>": VISION_START,
    "<|vision_end|>": VISION_END,
}

TEMPLATE_PREFIX = (
    "<|im_start|>system\n" + SYSTEM_PROMPT + "<|im_end|>\n<|im_start|>user\n"
)
TEMPLATE_SUFFIX = "<|im_end|>\n<|im_start|>assistant\n"
IMG_LABEL = "Picture {}: "


def _tokenize(tok, text: str) -> List[int]:
    """Tokenize text that may contain <|...|> special markers."""
    try:
        return list(tok.encode(text, add_special_tokens=False))
    except TypeError:
        pass  # SimpleTokenizer
    ids: List[int] = []
    for part in re.split(r"(<\|\w+\|>)", text):
        if part in _SPECIAL_IDS:
            ids.append(_SPECIAL_IDS[part])
        elif part.strip():
            ids.extend(tok.encode(part))
    return ids


def build_chat_ids(
    tok, prompt: str, n_merged_per_image: Sequence[int],
    drop_idx: Optional[int] = None,
) -> Tuple[List[int], List[int], int]:
    """(ids, vision_starts, drop_len) of the upstream edit-plus template."""
    pre_ids = _tokenize(tok, TEMPLATE_PREFIX)
    drop_len = drop_idx if drop_idx is not None else len(pre_ids)
    ids: List[int] = list(pre_ids)
    vision_starts: List[int] = []
    for i, n_merged in enumerate(n_merged_per_image):
        label_ids = _tokenize(tok, IMG_LABEL.format(i + 1))
        vision_starts.append(len(ids) + len(label_ids) + 1)
        ids += (label_ids + [VISION_START] + [IMAGE_PAD] * n_merged
                + [VISION_END])
    ids += _tokenize(tok, prompt) + _tokenize(tok, TEMPLATE_SUFFIX)
    return ids, vision_starts, drop_len


class SimpleTokenizer:
    """Deterministic hashed tokenizer fallback (ids matter only with real
    weights, which ship with their own tokenizer)."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> List[int]:
        out = []
        for tok in text.split():
            h = int.from_bytes(
                hashlib.sha256(tok.encode()).digest()[:4], "little"
            )
            out.append(h % min(self.vocab_size, 151000))
        return out


def load_hf_tokenizer(path: str):
    """The checkpoint's tokenizer in the directory ``path``: its
    ``tokenizer.json``, or its ``vocab.json`` + ``merges.txt``, read by
    ``models/tokenizer.py`` (the JAX package's
    ``AutoTokenizer.from_pretrained(path)`` for a Qwen2 tokenizer, without
    ``transformers``)."""
    from qwen_image_edit_streamdiffusion_tpu_torch.models.tokenizer import Tokenizer

    return Tokenizer.from_dir(path)


def smart_resize_hw(h: int, w: int, factor: int, min_pixels: int,
                    max_pixels: int) -> Tuple[int, int]:
    """Qwen2.5-VL image sizing rule: round to ``factor`` multiples, keep
    area within bounds, preserve aspect."""
    nh = max(factor, round(h / factor) * factor)
    nw = max(factor, round(w / factor) * factor)
    if nh * nw > max_pixels:
        beta = math.sqrt(h * w / max_pixels)
        nh = max(factor, math.floor(h / beta / factor) * factor)
        nw = max(factor, math.floor(w / beta / factor) * factor)
    elif nh * nw < min_pixels:
        beta = math.sqrt(min_pixels / (h * w))
        nh = math.ceil(h * beta / factor) * factor
        nw = math.ceil(w * beta / factor) * factor
    return nh, nw


IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def resize_for_vl(img: np.ndarray, cfg: VLConfig,
                  device="cpu") -> Tuple[np.ndarray, int, int]:
    """Smart-resize (Pillow's BICUBIC, as the JAX package resizes here,
    computed on ``device``; skipped when the size matches) → ((nh, nw, 3)
    uint8, gh, gw)."""
    p = cfg.patch_size
    factor = p * cfg.spatial_merge_size
    h, w = img.shape[:2]
    nh, nw = smart_resize_hw(h, w, factor, min_pixels=factor * factor * 4,
                             max_pixels=factor * factor * 1280)
    return imaging.resize(img, nw, nh, "bicubic", device), nh // p, nw // p


def patches_from_image(arr: torch.Tensor, cfg: VLConfig, gh: int, gw: int,
                       dtype=None) -> torch.Tensor:
    """(nh, nw, 3) uint8 → (gh·gw, 3·tp·p²) normalized patch matrix (CLIP
    mean/std, temporal frame duplicated)."""
    p = cfg.patch_size
    tp = cfg.temporal_patch_size
    mean = torch.tensor(IMAGE_MEAN, dtype=torch.float32, device=arr.device)
    std = torch.tensor(IMAGE_STD, dtype=torch.float32, device=arr.device)
    x = (arr.float() / 255.0 - mean) / std
    x = x.reshape(gh, p, gw, p, 3).permute(0, 2, 4, 1, 3).reshape(gh * gw, 3, p, p)
    x = x[:, :, None].expand(gh * gw, 3, tp, p, p)
    out = x.reshape(gh * gw, 3 * tp * p * p)
    return out.to(dtype) if dtype is not None else out


def _positions_from_ids(cfg: VLConfig, ids: List[int],
                        grids: List[Tuple[int, int]]) -> np.ndarray:
    """(3, L) M-RoPE positions; IMAGE_PAD runs take grid positions."""
    ts: List[int] = []
    hs: List[int] = []
    ws: List[int] = []
    pos = 0
    i = 0
    g = 0
    n = len(ids)
    while i < n:
        if ids[i] == IMAGE_PAD:
            gh, gw = grids[g]
            mh = gh // cfg.spatial_merge_size
            mw = gw // cfg.spatial_merge_size
            for r in range(mh):
                for c in range(mw):
                    ts.append(pos); hs.append(pos + r); ws.append(pos + c)
            pos += max(mh, mw)
            i += mh * mw
            g += 1
        else:
            ts.append(pos); hs.append(pos); ws.append(pos)
            pos += 1
            i += 1
    return np.stack([np.asarray(ts), np.asarray(hs), np.asarray(ws)])


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


class QwenVLEncoder:
    """PromptEncoder backed by the Qwen2.5-VL port."""

    def __init__(self, cfg: VLConfig, params: Params, device="cuda",
                 tokenizer=None, max_len: int = 256,
                 drop_idx: Optional[int] = None, use_flash: bool = True,
                 mesh: Optional[Mesh] = None):
        """``mesh``: the mesh whose slices ``params`` holds
        (``parallel/sharding.py::shard_vl_params``); every rank of it must
        make the same calls."""
        self.cfg = cfg
        self.groups = vl_groups(cfg, mesh)
        # the forwards' keyword under a mesh (a one-rank call keeps its
        # one-rank signature)
        self._tp = {} if mesh is None else {"groups": self.groups}
        self.joint_dim = cfg.hidden_size
        self.max_len = max_len
        self.drop_idx = drop_idx
        self.use_flash = use_flash
        self.device = torch.device(device)
        self.params = params
        self.tokenizer = tokenizer or SimpleTokenizer(cfg.vocab_size)

    def encode(self, prompt: str, images: Sequence[np.ndarray] = ()
               ) -> PromptEmbedding:
        return self.encode_many([(prompt, tuple(images))])[0]

    @torch.no_grad()
    def encode_many(self, requests: Sequence[Tuple[str, Sequence[np.ndarray]]]
                    ) -> List[PromptEmbedding]:
        """Encode a wave of (prompt, images) requests, coalescing device work
        as the JAX ``encode_many`` does: identical images (by content hash)
        run the vision tower once, distinct images of one grid run as one
        batch, and requests with the same vision starts and shapes run as
        one batched LM call, K2 once a layer for all its rows. Two
        divergences, neither of which changes a real row (the LM is causal
        and every row's padding is a suffix): the rows of a call are padded
        to its longest 128-token bucket, where the JAX key also splits by
        bucket (so a CFG pair whose prompts straddle a bucket edge, such as
        258 and 253 tokens, reads the LM's weights once, not twice); and
        rows are not padded to the JAX {2, 4, 8, 16} row buckets, which
        bound XLA compiles (eager PyTorch has none)."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)

        uniq: Dict[str, Tuple[np.ndarray, int, int]] = {}
        req_fps: List[List[str]] = []
        for _, images in requests:
            fps = []
            for img in images:
                a = np.asarray(img)
                fp = image_fingerprint(a)
                if fp not in uniq:
                    uniq[fp] = resize_for_vl(a, cfg, self.device)
                fps.append(fp)
            req_fps.append(fps)

        by_grid: Dict[Tuple[int, int], List[str]] = {}
        for fp, (_, gh, gw) in uniq.items():
            by_grid.setdefault((gh, gw), []).append(fp)
        vision: Dict[str, torch.Tensor] = {}
        for (gh, gw), fps in by_grid.items():
            patches = torch.stack([patches_from_image(
                torch.from_numpy(np.ascontiguousarray(uniq[fp][0])).to(self.device),
                cfg, gh, gw, dtype) for fp in fps])
            out = vision_forward(self.params["vision"], cfg, patches, gh, gw, **self._tp)
            for i, fp in enumerate(fps):
                vision[fp] = out[i]

        recs = [self._lm_record(prompt, [vision[fp] for fp in fps],
                                [uniq[fp][1:] for fp in fps])
                for (prompt, _), fps in zip(requests, req_fps)]
        groups: Dict[Tuple, List[int]] = {}
        for i, r in enumerate(recs):
            groups.setdefault(r["key"], []).append(i)
        hidden: Dict[int, torch.Tensor] = {}
        for (starts, _), idxs in groups.items():
            out = self._lm_rows([recs[i] for i in idxs], starts)
            for row, i in enumerate(idxs):
                hidden[i] = out[row]
        return [self._finalize_hidden(hidden[i], r["drop"], r["n_real"])
                for i, r in enumerate(recs)]

    def _lm_record(self, prompt: str, vts: List[torch.Tensor],
                   grids: List[Tuple[int, int]]) -> dict:
        """One request's chat ids and M-RoPE positions (unpadded), vision
        tokens and its LM batching key: (vision starts, vision shapes)."""
        ids, vision_starts, drop_len = build_chat_ids(
            self.tokenizer, prompt, [int(vt.shape[0]) for vt in vts],
            drop_idx=self.drop_idx)
        return {"key": (tuple(vision_starts), tuple(tuple(vt.shape) for vt in vts)),
                "ids": ids, "pos": _positions_from_ids(self.cfg, ids, grids),
                "vts": vts, "drop": drop_len, "n_real": len(ids)}

    def _lm_rows(self, recs: List[dict], starts: Tuple[int, ...]) -> torch.Tensor:
        """One batched LM call over requests of one key → (B, L, hidden):
        every row padded at the end to the group's longest 128-token bucket
        (positions continue past the last real token, mask False)."""
        lm = self.params["lm"]
        dev = self.device
        bucket = 128
        l = max(max(bucket, -(-r["n_real"] // bucket) * bucket) for r in recs)
        ids = np.zeros((len(recs), l), np.int64)
        mask = np.zeros((len(recs), l), bool)
        cos, sin = [], []
        for row, r in enumerate(recs):
            n_real = r["n_real"]
            ids[row, :n_real] = np.asarray(r["ids"], np.int64)
            mask[row, :n_real] = True
            pos = r["pos"]
            if l > n_real:
                pos = np.concatenate(
                    [pos, pos[:, -1:] + np.arange(1, l - n_real + 1)[None, :]], axis=1)
            c, s_ = _mrope_tables(self.cfg, pos)
            cos.append(c)
            sin.append(s_)
        # clamp (as jnp.take mode="clip") — the tiny test vocab does not
        # cover the special ids
        ids_t = torch.from_numpy(ids).to(dev)
        emb = lm["embed"][ids_t.clamp(0, lm["embed"].shape[0] - 1)]
        # a hidden-sharded table: the rank's columns of each row, gathered
        emb = distributed.all_gather(emb, self.groups["lm_attn"], dim=-1)
        for row, r in enumerate(recs):
            for s0, vt in zip(starts, r["vts"]):
                emb[row, s0:s0 + vt.shape[0]] = vt.to(emb.dtype)
        return lm_forward(lm, self.cfg, emb, torch.from_numpy(np.stack(cos)).to(dev),
                          torch.from_numpy(np.stack(sin)).to(dev),
                          torch.from_numpy(mask).to(dev), use_flash=self.use_flash,
                          **self._tp)

    def _finalize_hidden(self, hidden: torch.Tensor, drop_len: int,
                         n_real: int) -> PromptEmbedding:
        n = n_real - drop_len
        if n > self.max_len:
            warnings.warn(
                f"prompt conditioning truncated {n} → {self.max_len} "
                "tokens (vision spans + instruction exceed max_len)",
                stacklevel=2)
            n = self.max_len
        # 64-token output bucket, capped at max_len
        l_out = min(self.max_len, max(64, -(-n // 64) * 64))
        embeds = torch.zeros((l_out, hidden.shape[1]), dtype=torch.float32,
                             device=hidden.device)
        embeds[:n] = hidden[drop_len:drop_len + n].float()
        mask = np.zeros((l_out,), bool)
        mask[:n] = True
        return PromptEmbedding(embeds=embeds, mask=mask)
