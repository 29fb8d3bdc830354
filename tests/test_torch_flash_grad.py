"""The port's trainable flash attention (K7 forward + LSE, K8 dQ, K9 dK/dV)
against the JAX custom VJP, whose Pallas kernels run in interpret mode here as
``tests/test_flash_grad.py`` runs them, and against autograd through the plain
attention. Inputs are made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_image_edit_streamdiffusion_tpu.ops import flash_attention as jfa
from qwen_image_edit_streamdiffusion_tpu_torch.ops import attention as att
from qwen_image_edit_streamdiffusion_tpu_torch.ops import flash_attention as fa
from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

torch.set_num_threads(2)


def _arr(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _mask(b, lk, mask_len):
    """test_flash_grad.py's padding mask: keys [n_valid, mask_len) dead."""
    nvalid = np.asarray([100, 37])[:b]
    keys = np.arange(lk)[None, :]
    return (keys < nvalid[:, None]) | (keys >= mask_len)


# (b, h, lq, lk, mask_len or None): test_flash_grad.py's two shapes
SHAPES = [(1, 2, 256, 384, None), (2, 2, 200, 330, 256)]


def _close(got, want, rel):
    """|got − want| <= rel · max|want| elementwise: f32 sums of the same
    terms taken in other orders, exp2 rounded differently."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("b,h,lq,lk,mask_len", SHAPES)
def test_plain_kernels_match_pallas(b, h, lq, lk, mask_len):
    """(a) plain K7, K8, K9 against ``_flash_fwd_lse`` and ``_flash_bwd`` in
    f32: O, LSE (JAX lane 0 of rows [:lq]), dQ, dK, dV within 1e-5 of
    max|ref| (measured ≤ 1e-6)."""
    q, k, v, g = (_arr((b, h, l, 128), s) for s, l in ((1, lq), (2, lk), (3, lk), (4, lq)))
    mask = None if mask_len is None else _mask(b, lk, mask_len)
    maskf = np.ones((b, lk), np.float32) if mask is None else mask.astype(np.float32)
    jl = 0 if mask_len is None else mask_len
    o_j, lse_j = jfa._flash_fwd_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(maskf), jl, interpret=True)
    dq_j, dk_j, dv_j = jfa._flash_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o_j, lse_j, jnp.asarray(g),
        jnp.asarray(maskf), jl, interpret=True)

    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    tmask = None if mask is None else torch.from_numpy(mask)
    o, lse = fa.flash_fwd_lse(tq, tk, tv, tmask, mask_len)
    _close(o, o_j, 1e-5)
    assert lse.shape == (b * h, lq) and lse.dtype == torch.float32
    _close(lse, np.asarray(lse_j)[:, :lq, 0], 1e-5)

    # the backward on the JAX forward's O and LSE, as _flash_bwd takes them
    o_in = torch.from_numpy(np.array(o_j))
    lse_in = torch.from_numpy(np.asarray(lse_j)[:, :lq, 0].copy())
    delta = (tg * o_in).sum(-1).reshape(b * h, lq)
    q_pre = fa.prescale_q(tq)
    dq = fa.flash_bwd_dq(q_pre, tk, tv, tg, lse_in, delta, tmask, mask_len)
    dk, dv = fa.flash_bwd_dkv(q_pre, tk, tv, tg, lse_in, delta, tmask, mask_len)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        assert got.dtype == torch.float32
        _close(got, want, 1e-5)


def _torch_grads(fn, q, k, v):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    loss = torch.sin(out.float()).sum()
    return loss.item(), torch.autograd.grad(loss, (q, k, v))


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-2), (torch.bfloat16, 3e-2)])
def test_autograd_function_matches_reference_and_jax(dtype, atol):
    """(b) the autograd Function's grads against autograd through
    ``joint_attention_plain`` and against the JAX
    ``flash_attention_trainable`` (interpret) grads, test_flash_grad.py's
    tolerances (atol 2e-2 f32 / 3e-2 bf16, rtol 5e-2, loss within 0.3)."""
    import jax

    q, k, v = (torch.from_numpy(_arr((1, 2, l, 128), s)).to(dtype)
               for s, l in ((5, 256), (6, 384), (7, 384)))
    vf, gf = _torch_grads(fa.flash_attention_trainable, q, k, v)
    vr, gr = _torch_grads(fa.joint_attention_plain, q, k, v)
    assert abs(vf - vr) < 0.3
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jd) for t in (q, k, v))
    loss = lambda a, b_, c: jnp.sum(jnp.sin(
        jfa.flash_attention_trainable(a, b_, c, interpret=True).astype(jnp.float32)))
    vj, gj = jax.value_and_grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    assert abs(vf - float(vj)) < 0.3
    for a, r, j in zip(gf, gr, gj):
        assert a.dtype == dtype
        np.testing.assert_allclose(a.float().numpy(), r.float().numpy(),
                                   atol=atol, rtol=5e-2)
        np.testing.assert_allclose(a.float().numpy(), np.asarray(j, np.float32),
                                   atol=atol, rtol=5e-2)


def test_masked_keys_get_exactly_zero_dk_dv():
    """(c) keys masked out (text padding below mask_len) get dK = dV = 0
    exactly, and dQ matches autograd through the plain masked attention
    (test_flash_grad.py's atol 2e-2, rtol 5e-2)."""
    b, h, lq, lk, mask_len = 2, 2, 200, 330, 256
    q, k, v = (torch.from_numpy(_arr((b, h, l, 128), s))
               for s, l in ((8, lq), (9, lk), (10, lk)))
    mask = torch.from_numpy(_mask(b, lk, mask_len))
    _, gf = _torch_grads(lambda *t: fa.flash_attention_trainable(*t, mask, mask_len),
                         q, k, v)
    _, gr = _torch_grads(lambda *t: fa.joint_attention_plain(*t, mask), q, k, v)
    for a, r in zip(gf, gr):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=2e-2, rtol=5e-2)
    dead = ~mask[:, None, :, None].expand(b, h, lk, 128)
    assert torch.count_nonzero(gf[1][dead]) == 0
    assert torch.count_nonzero(gf[2][dead]) == 0
    assert torch.count_nonzero(gf[1][~dead]) > 0


def test_gqa_rejected():
    """(d) the backward takes H == Hkv only, as the JAX wrapper."""
    q = torch.from_numpy(_arr((1, 4, 64, 128), 11))
    kv = torch.from_numpy(_arr((1, 2, 64, 128), 12))
    with pytest.raises(ValueError, match="H == Hkv"):
        fa.flash_attention_trainable(q, kv, kv)


def test_auto_routes_by_shape():
    """(d) flash_attention_auto: the trainable Function for H == Hkv within
    the resident budget, the K1/K4 wrapper (no custom backward) for GQA or
    for K/V past the budget; on the CPU nothing is launched."""
    before = dict(kernels.LAUNCHES)
    q = torch.from_numpy(_arr((1, 2, 64, 128), 13)).requires_grad_()
    out = fa.flash_attention_auto(q, q, q)
    assert type(out.grad_fn).__name__.startswith("FlashAttentionTrainable")
    q4 = torch.from_numpy(_arr((1, 4, 64, 128), 14)).requires_grad_()
    kv = torch.from_numpy(_arr((1, 2, 64, 128), 15))
    out = fa.flash_attention_auto(q4, kv, kv)
    assert out.shape == q4.shape
    assert not type(out.grad_fn).__name__.startswith("FlashAttentionTrainable")
    long_kv = torch.from_numpy(_arr((1, 2, 6200, 128), 16))  # f32: > 6 MiB
    assert fa.streams_kv(long_kv)
    out = fa.flash_attention_auto(q, long_kv, long_kv)
    assert not type(out.grad_fn).__name__.startswith("FlashAttentionTrainable")
    assert kernels.LAUNCHES == before


def test_attention_dispatch_trains_through_the_function():
    """ops.attention sends a bf16 input that needs a gradient to the
    trainable Function and one that does not to the K1 wrapper; both give
    the plain result on the CPU."""
    q = torch.from_numpy(_arr((1, 2, 96, 128), 17)).bfloat16()
    mask = torch.ones((1, 96), dtype=torch.bool)
    mask[:, 10:32] = False
    qg = q.clone().requires_grad_()
    a = att.attention(qg, qg, qg, mask, use_flash=True, mask_len=32)
    assert type(a.grad_fn).__name__.startswith("FlashAttentionTrainable")
    with torch.no_grad():
        b = att.attention(qg, qg, qg, mask, use_flash=True, mask_len=32)
    assert b.grad_fn is None
    torch.testing.assert_close(a.detach().float(), b.float(), atol=2e-2, rtol=0)
