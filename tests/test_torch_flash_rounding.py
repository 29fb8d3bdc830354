"""The port's plain forward and backward attention in bf16 against the JAX
Pallas kernels in interpret mode (as ``tests/test_flash_attention.py`` runs
them, block 128), at inputs where the rounding points matter: q and k drawn at
3x unit scale, so the softmax is sharp and P spans many bf16 binades. The plain
forward follows the kernels' arithmetic (bf16 Q_pre, P = exp2 of the
bf16-rounded base-2 argument, rounded to bf16); a natural-base f32 softmax
misses them by two bf16 ulps of the output. The plain backward takes exp2 in
f32 and rounds P, dS · d^-½ and dS · ln2 to bf16 before its products, as
``_flash_bwd`` does. ``reference_attention`` keeps the JAX XLA reference's
arithmetic.

Tolerance: one bf16 ulp at the output's largest magnitude. The kernels take a
blockwise running max where the plain version takes the row's global max, so
their P can differ by rounding; that stays within half an ulp here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_image_edit_streamdiffusion_tpu.ops import attention as jatt
from qwen_image_edit_streamdiffusion_tpu.ops import flash_attention as jfa
from qwen_image_edit_streamdiffusion_tpu_torch.ops import attention as att
from qwen_image_edit_streamdiffusion_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)


def _arr(shape, seed, scale=1.0):
    """bf16-representable values (both frameworks start from the same bits)."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).bfloat16()


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _ulp_tol(ref: np.ndarray) -> float:
    """One bf16 ulp (8 significant bits) at max|ref|."""
    return float(2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7))


def _check(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= _ulp_tol(want), (err, _ulp_tol(want))


def _prefix_mask(b, lk, mask_len, n_real):
    m = np.ones((b, lk), bool)
    for i, n in enumerate(n_real):
        m[i, n:mask_len] = False
    return m


@pytest.mark.parametrize("b,h,hkv,lq,lk,stream", [
    (1, 2, 2, 640, 640, False),   # K1: the joint shape with a text prefix
    (2, 2, 2, 200, 330, False),   # ragged q and k blocks, two batch rows
    (1, 4, 2, 256, 384, True),    # K4's role: the streaming kernel, GQA
])
def test_joint_plain_matches_pallas_in_bf16(b, h, hkv, lq, lk, stream):
    mask_len = 128
    q, k, v = _arr((b, h, lq, 128), 1, 3.0), _arr((b, hkv, lk, 128), 2, 3.0), _arr(
        (b, hkv, lk, 128), 3)
    mask = _prefix_mask(b, lk, mask_len, (100, 37)[:b])
    want = jfa.flash_attention(_jnp(q), _jnp(k), _jnp(v), kv_mask=jnp.asarray(mask),
                               mask_len=mask_len, interpret=True, block_q=128,
                               block_k=128, stream=stream)
    got = fa.joint_attention(q, k, v, torch.from_numpy(mask), mask_len)
    assert got.dtype == torch.bfloat16
    _check(got, want)


@pytest.mark.parametrize("h,hkv,l", [(4, 2, 256), (2, 2, 384)])
def test_causal_plain_matches_pallas_in_bf16(h, hkv, l):
    q, k, v = _arr((1, h, l, 128), 4, 3.0), _arr((1, hkv, l, 128), 5, 3.0), _arr(
        (1, hkv, l, 128), 6)
    want = jfa.flash_attention(_jnp(q), _jnp(k), _jnp(v), causal=True, interpret=True,
                               block_q=128, block_k=128)
    _check(fa.causal_attention(q, k, v), want)


def test_fwd_lse_plain_matches_pallas_in_bf16():
    """K7's plain version: O within one bf16 ulp, LSE2 (f32, base 2) within
    1e-3 of max|LSE2| (the rounded P summed blockwise against globally)."""
    b, h, l, mask_len = 2, 2, 384, 256
    q, k, v = _arr((b, h, l, 128), 7, 3.0), _arr((b, h, l, 128), 8, 3.0), _arr(
        (b, h, l, 128), 9)
    mask = _prefix_mask(b, l, mask_len, (100, 37))
    o_j, lse_j = jfa._flash_fwd_lse(_jnp(q), _jnp(k), _jnp(v),
                                    jnp.asarray(mask.astype(np.float32)), mask_len,
                                    interpret=True)
    o, lse = fa.flash_fwd_lse(q, k, v, torch.from_numpy(mask), mask_len)
    _check(o, o_j)
    want = np.asarray(lse_j)[:, :l, 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=0,
                               atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("qk_scale", [1.0, 3.0])
@pytest.mark.parametrize("b,h,lq,lk,mask_len", [(1, 2, 256, 384, None),
                                                (2, 2, 200, 330, 256)])
def test_bwd_plain_matches_pallas_in_bf16(b, h, lq, lk, mask_len, qk_scale):
    """K8's and K9's plain versions against ``_flash_bwd`` in bf16, both fed
    the JAX ``_flash_fwd_lse`` O and LSE2 (lane 0): P = exp2(S2 − LSE2) in
    f32, dS = P ⊙ (dP − Δ), and the bf16 casts of dS · d^-½, dS · ln2 and P
    before the three products. dQ, dK and dV (f32 here, bf16 there) within
    one bf16 ulp at max|ref|: at unit scale and with q, k at 3x (sharp
    softmax), where f32 inputs would hide the casts."""
    q, k = _arr((b, h, lq, 128), 20, qk_scale), _arr((b, h, lk, 128), 21, qk_scale)
    v, g = _arr((b, h, lk, 128), 22), _arr((b, h, lq, 128), 23)
    keys = np.arange(lk)[None, :]
    mask = None if mask_len is None else (
        (keys < np.asarray([100, 37])[:b, None]) | (keys >= mask_len))
    maskf = jnp.asarray(np.ones((b, lk), np.float32) if mask is None
                        else mask.astype(np.float32))
    jl = 0 if mask_len is None else mask_len
    o_j, lse_j = jfa._flash_fwd_lse(_jnp(q), _jnp(k), _jnp(v), maskf, jl, interpret=True)
    dq_j, dk_j, dv_j = jfa._flash_bwd(_jnp(q), _jnp(k), _jnp(v), o_j, lse_j, _jnp(g),
                                      maskf, jl, interpret=True)
    o = torch.from_numpy(np.asarray(o_j, np.float32))
    lse = torch.from_numpy(np.asarray(lse_j)[:, :lq, 0].copy())
    delta = (g.float() * o).sum(-1).reshape(b * h, lq)
    tmask = None if mask is None else torch.from_numpy(mask)
    q_pre = fa.prescale_q(q)
    dq = fa.flash_bwd_dq(q_pre, k, v, g, lse, delta, tmask, mask_len)
    dk, dv = fa.flash_bwd_dkv(q_pre, k, v, g, lse, delta, tmask, mask_len)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        assert got.dtype == torch.float32
        _check(got, want)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 0.0)])
def test_reference_attention_matches_jax_reference(dtype, atol):
    """The XLA reference of both packages: f32 natural-base softmax, P cast
    to V's dtype. f32 within the JAX tests' 2e-5; in bf16 within one bf16
    ulp of max|ref| (the P · V sums run in another order)."""
    b, h, l = 2, 2, 200
    q, k, v = (_arr((b, h, l, 128), s, 3.0 if s < 12 else 1.0).to(dtype)
               for s in (10, 11, 12))
    mask = _prefix_mask(b, l, 64, (40, 20))
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jatt.reference_attention(*(jnp.asarray(t.float().numpy()).astype(jd)
                                      for t in (q, k, v)), kv_mask=jnp.asarray(mask))
    got = att.reference_attention(q, k, v, torch.from_numpy(mask))
    assert got.dtype == dtype
    want = np.asarray(want, np.float32)
    tol = atol or _ulp_tol(want)
    assert np.abs(got.float().numpy() - want).max() <= tol
