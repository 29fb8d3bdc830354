"""Flash attention: joint-stream (K1, and K4's streaming role), causal GQA
(K2), and the trainable joint attention (K7 forward + LSE, K8 dQ, K9 dK/dV).

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/ops/flash_attention.py``.
Its Pallas kernels ``_flash_kernel``, ``_flash_kernel_hbm``,
``_flash_kernel_fwd_lse`` and ``_flash_kernel_causal`` become one Hopper
kernel on wgmma and TMA, ``csrc/flash_fwd_sm90.cu``, templated on the LSE
store and on the causal select;
``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel`` become the two kernels
of ``csrc/flash_attention_bwd.cu`` (on the forward's wgmma/TMA skeleton,
deterministic: no atomics), behind :class:`FlashAttentionTrainable`
(the JAX ``custom_vjp``). On Hopper K/V always stream from HBM through shared
memory, so the JAX package's resident/streaming switch (``fits_resident``, a
VMEM budget) has no counterpart: the non-causal instance takes any Lk and GQA
(H % Hkv == 0), as ``_flash_kernel_hbm`` does. A joint launch whose K/V per
head exceed that budget is counted under ``flash_joint_stream`` instead of
``flash_joint``, so a run shows which role the kernel played.

The plain versions of the forward kernels share one function that follows the
Pallas kernels' arithmetic (bf16 Q_pre, base-2 scores, P = exp2 of the
bf16-rounded argument, rounded to bf16); the XLA reference of the JAX package
(natural-base f32 softmax) is ``ops/attention.py::reference_attention``.
Each wrapper takes the plain PyTorch version only for tensors on the CPU. A
CUDA tensor launches the kernel or the call raises; there is no fallback.
Layout is (B, H, L, D) throughout, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
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


def qscale(d: int) -> float:
    """The q prescale d^-1/2 · log2(e) as the kernels compute it: the f32
    product of the two f32 factors (equal to fl(d^-1/2 · log2 e) at d = 128)."""
    return float(torch.tensor(d ** -0.5, dtype=torch.float32)
                 * torch.tensor(_LOG2E, dtype=torch.float32))


def prescale_q(q: torch.Tensor) -> torch.Tensor:
    """Q_pre = (q.f32 · qscale).to(q.dtype), rounded exactly as the forward
    kernels round their Q tile, so the backward's recomputed P is the
    forward's bit for bit."""
    return (q.float() * qscale(q.shape[-1])).to(q.dtype)


def _flash_forward_plain(q, k, v, keep: Optional[torch.Tensor]):
    """The forward kernels' arithmetic (the Pallas kernels' rounding points):
    Q_pre = prescale_q(q); S2 = Q_pre · K^T in f32, dead keys at -1e30; m the
    row max; P = exp2(S2 − m rounded to V's dtype) rounded to V's dtype; l =
    Σ P in f32; O = (P · V) / max(l, 1e-30) in q's dtype; LSE2 = m + log2 l,
    or 1e30 where l = 0. q (B, H, Lq, D), k/v (B, Hkv, Lk, D) with H % Hkv ==
    0: q head h reads kv head h // (H // Hkv). keep (True = attend)
    broadcasts against the (B, Hkv, H/Hkv, Lq, Lk) scores. Returns (O,
    LSE2 (B·H, Lq) f32)."""
    b, nh, lq, hd = q.shape
    nkv = k.shape[1]
    qg = prescale_q(q).reshape(b, nkv, nh // nkv, lq, hd).float()
    s = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2))
    if keep is not None:
        s = s.masked_fill(~keep, _NEG_INF)
    m = s.amax(-1, keepdim=True).detach()  # O does not depend on m
    p = torch.exp2((s - m).to(v.dtype).float()).to(v.dtype).float()
    del s
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p, v.float()[:, :, None]) / l.clamp_min(1e-30)
    lse = torch.where(l > 0, m + torch.log2(l.clamp_min(1e-30)),
                      torch.full_like(l, 1e30))
    return o.reshape(b, nh, lq, hd).to(q.dtype), lse.reshape(b * nh, lq)


def joint_attention_plain(q, k, v, kv_mask: Optional[torch.Tensor] = None,
                          mask_len: Optional[int] = None) -> torch.Tensor:
    """Joint GQA attention (H % Hkv == 0); kv_mask (B, Lk) bool, True =
    attend. mask_len only bounds where the kernel looks for masked keys; the
    plain version applies the whole mask, which is the same whenever the
    mask is True past it."""
    keep = None if kv_mask is None else kv_mask.bool()[:, None, None, None, :]
    return _flash_forward_plain(q, k, v, keep)[0]


def causal_attention_plain(q, k, v, attn_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Causal GQA attention: q (B, H, L, D), k/v (B, Hkv, L, D). attn_mask
    (L,) bool marks real keys."""
    l = q.shape[2]
    keep = torch.ones((l, l), dtype=torch.bool, device=q.device).tril()
    if attn_mask is not None:
        keep = keep & attn_mask.bool()[None, :]
    return _flash_forward_plain(q, k, v, keep)[0]


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


def _launch_fwd(q, k, v, mask, mask_len: int, lse: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """K1 / K4 (lse None) or K7 (lse (B·H, Lq) f32, written) on
    ``csrc/flash_fwd_sm90.cu``."""
    b, h, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if lq == 0 or lk == 0:
        raise ValueError("flash attention: empty sequence")
    out = torch.empty_like(q)
    err = kernels.library().qie_flash_fwd_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        b, h, hkv, lq, lk, mask_len, d ** -0.5,
        kernels.current_stream_handle(q.device))
    kernels.check(err, "flash attention forward")
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise ValueError(
            f"joint flash attention has no backward: q {tuple(q.shape)}, k "
            f"{tuple(k.shape)} needs a gradient, and the trainable kernels "
            "take H == Hkv with K/V within the resident budget only")
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"joint flash attention takes H % Hkv == 0, got "
                         f"{q.shape[1]} and {k.shape[1]}")
    mask, bound = _mask_arg(q, k, kv_mask, mask_len)
    out = _launch_fwd(q, k, v, mask, bound, None)
    kernels.LAUNCHES["flash_joint_stream" if streams_kv(k) else "flash_joint"] += 1
    return out


def causal_block_q(q) -> int:
    """K2's query rows per CTA: 64 (one consumer warpgroup) while 128-row
    CTAs would leave SMs idle, else 128 (K1's two warpgroups)."""
    b, h, l, _ = q.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return 64 if b * h * -(-l // 128) < sms else 128


def causal_attention(q, k, v, block_q: Optional[int] = None) -> torch.Tensor:
    """K2: causal GQA, q (B, H, L, 128), k/v (B, Hkv, L, 128) bf16, H % Hkv
    == 0. Takes no mask: padding must be a suffix, and every padded key
    column then lies above the diagonal of every real row. ``block_q`` (64
    or 128 query rows per CTA) defaults to :func:`causal_block_q`."""
    if q.device.type == "cpu":
        return causal_attention_plain(q, k, v)
    kernels.refuse_grad("causal flash attention", q, k, v)
    _check_cuda(q, k, v)
    if q.shape[1] % k.shape[1] != 0 or q.shape[2] != k.shape[2]:
        raise ValueError("causal flash attention takes H % Hkv == 0, Lq == Lk")
    b, h, l, d = q.shape
    if l == 0:
        raise ValueError("causal flash attention: empty sequence")
    if block_q is None:
        block_q = causal_block_q(q)
    elif block_q not in (64, 128):
        raise ValueError(f"causal flash attention: block_q is 64 or 128, "
                         f"not {block_q}")
    out = torch.empty_like(q)
    err = kernels.library().qie_flash_causal_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
        k.shape[1], l, d ** -0.5, block_q,
        kernels.current_stream_handle(q.device))
    kernels.check(err, "causal flash attention")
    kernels.LAUNCHES["flash_causal"] += 1
    return out


# ---------------------------------------------------------------------------
# Trainable joint attention: K7 (forward + LSE), K8 (dQ), K9 (dK, dV)
# ---------------------------------------------------------------------------
#
# The forward keeps LSE2 = m + log2(l) per query row, in the base-2 domain of
# the prescaled scores S2 = Q_pre · K^T; the backward recomputes
# P = exp2(S2 − LSE2) blockwise, so no (L, L) matrix is ever stored. With
# dS = P ⊙ (dP − Δ), Δ = rowsum(dO ⊙ O):
#   dQ = (dS · scale).bf16 · K,  dK = (dS · ln2).bf16^T · Q_pre,
#   dV = P.bf16^T · dO.
# LSE is stored (B·H, Lq) f32, one value per row (the JAX package broadcasts
# it over 128 lanes, a TPU tiling artefact).


def _scores2(q_pre, k, kv_mask) -> torch.Tensor:
    """(B, H, Lq, Lk) f32 base-2 scores; masked keys at -1e30."""
    s = torch.matmul(q_pre.float(), k.float().transpose(-1, -2))
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask.bool()[:, None, None, :], _NEG_INF)
    return s


def flash_fwd_lse_plain(q, k, v, kv_mask: Optional[torch.Tensor] = None,
                        mask_len: Optional[int] = None):
    """K7's function: (O in q's dtype, LSE2 (B·H, Lq) f32), the plain
    forward of K1 with its row statistics; a row with l = 0 gets LSE2 =
    1e30."""
    keep = None if kv_mask is None else kv_mask.bool()[:, None, None, None, :]
    return _flash_forward_plain(q, k, v, keep)


def _bwd_p_ds(q_pre, k, v, do, lse, delta, kv_mask):
    b, h, lq, _ = q_pre.shape
    p = torch.exp2(_scores2(q_pre, k, kv_mask) - lse.reshape(b, h, lq, 1))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta.reshape(b, h, lq, 1))


def flash_bwd_dq_plain(q_pre, k, v, do, lse, delta,
                       kv_mask: Optional[torch.Tensor] = None,
                       mask_len: Optional[int] = None) -> torch.Tensor:
    """K8's function: dQ (B, H, Lq, D) f32 = (dS · scale).to(k.dtype) · K."""
    _, ds = _bwd_p_ds(q_pre, k, v, do, lse, delta, kv_mask)
    scale = q_pre.shape[-1] ** -0.5
    return torch.matmul((ds * scale).to(k.dtype).float(), k.float())


def flash_bwd_dkv_plain(q_pre, k, v, do, lse, delta,
                        kv_mask: Optional[torch.Tensor] = None,
                        mask_len: Optional[int] = None):
    """K9's function: (dK, dV) (B, H, Lk, D) f32, dK = (dS · ln2)^T · Q_pre
    and dV = P^T · dO with P and dS rounded to the inputs' dtype."""
    p, ds = _bwd_p_ds(q_pre, k, v, do, lse, delta, kv_mask)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul((ds * _LN2).to(q_pre.dtype).float().transpose(-1, -2),
                      q_pre.float())
    return dk, dv


def _check_train(q, k, v, extra):
    _check_cuda(q, k, v)
    if q.shape[1] != k.shape[1]:
        raise ValueError("trainable flash attention requires H == Hkv "
                         f"(GQA backward not implemented), got {q.shape[1]} "
                         f"and {k.shape[1]}")
    for name, t, shape, dtype in extra:
        if (t.device != q.device or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"flash attention: {name} must be a contiguous "
                             f"{dtype} {shape} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _mask_arg(q, k, kv_mask, mask_len):
    """(uint8 mask or None, mask_len bound) for a launch."""
    if kv_mask is None:
        return None, 0
    if kv_mask.shape != (q.shape[0], k.shape[2]):
        raise ValueError(f"kv_mask must be (B, Lk), got {tuple(kv_mask.shape)}")
    mask = kv_mask.to(device=q.device, dtype=torch.uint8).contiguous()
    return mask, (k.shape[2] if mask_len is None else int(mask_len))


def flash_fwd_lse(q, k, v, kv_mask: Optional[torch.Tensor] = None,
                  mask_len: Optional[int] = None):
    """K7: (O, LSE2) of the joint attention, q/k/v (B, H, L, 128) bf16 with
    H == Hkv; O bit-identical to K1's on the same inputs."""
    if q.device.type == "cpu":
        return flash_fwd_lse_plain(q, k, v, kv_mask, mask_len)
    _check_train(q, k, v, ())
    mask, bound = _mask_arg(q, k, kv_mask, mask_len)
    b, h, lq, _ = q.shape
    lse = torch.empty((b * h, lq), dtype=torch.float32, device=q.device)
    out = _launch_fwd(q, k, v, mask, bound, lse)
    kernels.LAUNCHES["flash_fwd_lse"] += 1
    return out, lse


def _bwd_extra(q, k, do, lse, delta):
    b, h, lq, d = q.shape
    return (("do", do, tuple(q.shape), q.dtype),
            ("lse", lse, (b * h, lq), torch.float32),
            ("delta", delta, (b * h, lq), torch.float32))


def flash_bwd_dq(q_pre, k, v, do, lse, delta,
                 kv_mask: Optional[torch.Tensor] = None,
                 mask_len: Optional[int] = None) -> torch.Tensor:
    """K8: dQ (B, H, Lq, 128) f32 from Q_pre (:func:`prescale_q`), K, V, dO
    (bf16) and LSE2, Δ (B·H, Lq) f32."""
    if q_pre.device.type == "cpu":
        return flash_bwd_dq_plain(q_pre, k, v, do, lse, delta, kv_mask, mask_len)
    _check_train(q_pre, k, v, _bwd_extra(q_pre, k, do, lse, delta))
    mask, bound = _mask_arg(q_pre, k, kv_mask, mask_len)
    b, h, lq, d = q_pre.shape
    dq = torch.empty(q_pre.shape, dtype=torch.float32, device=q_pre.device)
    err = kernels.library().qie_flash_bwd_dq_bf16(
        q_pre.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        mask.data_ptr() if mask is not None else None, dq.data_ptr(),
        b, h, lq, k.shape[2], bound, d ** -0.5,
        kernels.current_stream_handle(q_pre.device))
    kernels.check(err, "flash attention backward dQ")
    kernels.LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q_pre, k, v, do, lse, delta,
                  kv_mask: Optional[torch.Tensor] = None,
                  mask_len: Optional[int] = None):
    """K9: (dK, dV) (B, H, Lk, 128) f32, arguments as :func:`flash_bwd_dq`."""
    if q_pre.device.type == "cpu":
        return flash_bwd_dkv_plain(q_pre, k, v, do, lse, delta, kv_mask, mask_len)
    _check_train(q_pre, k, v, _bwd_extra(q_pre, k, do, lse, delta))
    mask, bound = _mask_arg(q_pre, k, kv_mask, mask_len)
    b, h, lq, _ = q_pre.shape
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    err = kernels.library().qie_flash_bwd_dkv_bf16(
        q_pre.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        mask.data_ptr() if mask is not None else None, dk.data_ptr(),
        dv.data_ptr(), b, h, lq, k.shape[2], bound,
        kernels.current_stream_handle(q_pre.device))
    kernels.check(err, "flash attention backward dK/dV")
    kernels.LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


class FlashAttentionTrainable(torch.autograd.Function):
    """The JAX ``_flash_diff`` custom VJP: forward K7, backward K8 then K9.
    On CPU tensors every piece is its plain version."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, mask_len):
        out, lse = flash_fwd_lse(q, k, v, kv_mask, mask_len)
        ctx.save_for_backward(q, k, v, out, lse, kv_mask)
        ctx.mask_len = mask_len
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kv_mask = ctx.saved_tensors
        do = do.contiguous()
        b, h, lq, _ = q.shape
        delta = (do.float() * out.float()).sum(-1).reshape(b * h, lq)
        q_pre = prescale_q(q)
        dq = flash_bwd_dq(q_pre, k, v, do, lse, delta, kv_mask, ctx.mask_len)
        dk, dv = flash_bwd_dkv(q_pre, k, v, do, lse, delta, kv_mask, ctx.mask_len)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def flash_attention_trainable(q, k, v, kv_mask: Optional[torch.Tensor] = None,
                              mask_len: Optional[int] = None) -> torch.Tensor:
    """Differentiable joint attention (H == Hkv): K7 forward, K8/K9 backward
    under autograd, no (L, L) matrix stored."""
    if q.shape[1] != k.shape[1]:
        raise ValueError("trainable flash attention requires H == Hkv "
                         "(GQA backward not implemented)")
    return FlashAttentionTrainable.apply(q, k, v, kv_mask, mask_len)


def flash_attention_auto(q, k, v, kv_mask: Optional[torch.Tensor] = None,
                         mask_len: Optional[int] = None) -> torch.Tensor:
    """The JAX dispatcher: the trainable function where K/V stay within the
    resident budget and H == Hkv (the MMDiT joint stream), the K1/K4 wrapper
    otherwise (which refuses a CUDA input that needs a gradient)."""
    if not streams_kv(k) and q.shape[1] == k.shape[1]:
        return flash_attention_trainable(q, k, v, kv_mask, mask_len)
    return joint_attention(q, k, v, kv_mask, mask_len)
