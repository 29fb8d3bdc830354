"""Flash attention: joint-stream (K1, and K4's streaming role) and causal GQA (K2).

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/ops/flash_attention.py``.
Its Pallas kernels ``_flash_kernel``, ``_flash_kernel_hbm`` and
``_flash_kernel_causal`` become one CUDA kernel, ``csrc/flash_attention.cu``,
templated on causality. On Hopper K/V always stream from HBM through shared
memory, so the JAX package's resident/streaming switch (``fits_resident``, a
VMEM budget) has no counterpart: the non-causal instance takes any Lk and GQA
(H % Hkv == 0), as ``_flash_kernel_hbm`` does. A joint launch whose K/V per
head exceed that budget is counted under ``flash_joint_stream`` instead of
``flash_joint``, so a run shows which role the kernel played.

Each wrapper takes the plain PyTorch version only for tensors on the CPU. A
CUDA tensor launches the kernel or the call raises; there is no fallback.
Layout is (B, H, L, D) throughout, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

_NEG_INF = -1e30
HEAD_DIM = 128
RESIDENT_KV_BYTES = 6 * 1024 * 1024  # the JAX fits_resident budget per head


def streams_kv(k: torch.Tensor) -> bool:
    """True where the JAX package would pick its HBM-streaming kernel (K4):
    K and V of one (batch, head) exceed 6 MiB."""
    return 2 * k.shape[2] * k.shape[3] * k.element_size() > RESIDENT_KV_BYTES


def supported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Shape/type gate, decided before any launch: the kernel takes bf16 with
    head_dim 128 (the JAX gate asks head_dim % 128 == 0; every model of the
    repo that passes it has head_dim 128)."""
    return (q.shape[-1] == HEAD_DIM and q.dtype == torch.bfloat16
            and k.dtype == q.dtype and v.dtype == q.dtype)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------


def _gqa_attention_plain(q, k, v, keep: Optional[torch.Tensor]) -> torch.Tensor:
    """Exact softmax attention with f32 scores and softmax; P is cast to V's
    dtype before P·V. q (B, H, Lq, D), k/v (B, Hkv, Lk, D) with H % Hkv ==
    0: q head h reads kv head h // (H // Hkv). keep (True = attend)
    broadcasts against the (B, Hkv, H/Hkv, Lq, Lk) scores."""
    b, nh, lq, hd = q.shape
    nkv = k.shape[1]
    qg = q.reshape(b, nkv, nh // nkv, lq, hd).float()
    s = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2)) * hd ** -0.5
    if keep is not None:
        s = s.masked_fill(~keep, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p, v[:, :, None]).reshape(b, nh, lq, hd)


def joint_attention_plain(q, k, v, kv_mask: Optional[torch.Tensor] = None,
                          mask_len: Optional[int] = None) -> torch.Tensor:
    """Joint GQA attention (H % Hkv == 0); kv_mask (B, Lk) bool, True =
    attend. mask_len only bounds where the kernel looks for masked keys; the
    plain version applies the whole mask, which is the same whenever the
    mask is True past it."""
    keep = None if kv_mask is None else kv_mask.bool()[:, None, None, None, :]
    return _gqa_attention_plain(q, k, v, keep)


def causal_attention_plain(q, k, v, attn_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Causal GQA attention: q (B, H, L, D), k/v (B, Hkv, L, D). attn_mask
    (L,) bool marks real keys."""
    l = q.shape[2]
    keep = torch.ones((l, l), dtype=torch.bool, device=q.device).tril()
    if attn_mask is not None:
        keep = keep & attn_mask.bool()[None, :]
    return _gqa_attention_plain(q, k, v, keep)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda(q, k, v):
    if q.device.type != "cuda":
        raise RuntimeError(f"flash attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash attention: {name} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash attention: {name} must be bfloat16, got {t.dtype}")
        if t.dim() != 4 or t.shape[-1] != HEAD_DIM:
            raise ValueError(f"flash attention: {name} must be (B, H, L, 128), "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash attention: {name} must be contiguous "
                             "and 16-byte aligned")
    if k.shape != v.shape or k.shape[0] != q.shape[0]:
        raise ValueError(f"flash attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.shape[0] * q.shape[1] > 65535:  # grid.y = batch × heads
        raise ValueError(f"flash attention: {q.shape[0]} × {q.shape[1]} "
                         "batch × heads too large")


def _launch(q, k, v, mask, mask_len: int, causal: bool) -> torch.Tensor:
    lib = kernels.library()
    b, h, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = lib.qie_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        b, h, hkv, lq, lk, mask_len, d ** -0.5, int(causal),
        kernels.current_stream_handle(q.device))
    kernels.check(err, "flash attention")
    return out


def joint_attention(q, k, v, kv_mask: Optional[torch.Tensor] = None,
                    mask_len: Optional[int] = None) -> torch.Tensor:
    """K1 / K4: q (B, H, Lq, 128), k/v (B, Hkv, Lk, 128) bf16 with H % Hkv
    == 0; kv_mask (B, Lk) bool. mask_len: static bound on the key prefix that
    can hold masked keys (the bucketed text prefix); None = every key block
    may be masked."""
    if q.device.type == "cpu":
        return joint_attention_plain(q, k, v, kv_mask, mask_len)
    _check_cuda(q, k, v)
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"joint flash attention takes H % Hkv == 0, got "
                         f"{q.shape[1]} and {k.shape[1]}")
    mask = None
    bound = 0
    if kv_mask is not None:
        if kv_mask.shape != (q.shape[0], k.shape[2]):
            raise ValueError(f"kv_mask must be (B, Lk), got {tuple(kv_mask.shape)}")
        mask = kv_mask.to(device=q.device, dtype=torch.uint8).contiguous()
        bound = k.shape[2] if mask_len is None else int(mask_len)
    out = _launch(q, k, v, mask, bound, causal=False)
    kernels.LAUNCHES["flash_joint_stream" if streams_kv(k) else "flash_joint"] += 1
    return out


def causal_attention(q, k, v) -> torch.Tensor:
    """K2: causal GQA, q (B, H, L, 128), k/v (B, Hkv, L, 128) bf16, H % Hkv
    == 0. Takes no mask: padding must be a suffix, and every padded key
    column then lies above the diagonal of every real row."""
    if q.device.type == "cpu":
        return causal_attention_plain(q, k, v)
    _check_cuda(q, k, v)
    if q.shape[1] % k.shape[1] != 0 or q.shape[2] != k.shape[2]:
        raise ValueError("causal flash attention takes H % Hkv == 0, Lq == Lk")
    out = _launch(q, k, v, None, 0, causal=True)
    kernels.LAUNCHES["flash_causal"] += 1
    return out
