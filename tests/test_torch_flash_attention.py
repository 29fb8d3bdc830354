"""The port's plain K1/K2 against the JAX Pallas kernels run in interpret mode
(as ``tests/test_flash_attention.py`` runs them), at head_dim 128, in f32 with
the JAX tests' own tolerance (atol 2e-5, rtol 1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_image_edit_streamdiffusion_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
)
from qwen_image_edit_streamdiffusion_tpu_torch.ops import attention as att
from qwen_image_edit_streamdiffusion_tpu_torch.ops import flash_attention as fa
from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=1e-4)


def _arr(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax(q, k, v, **kw):
    return np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                interpret=True, block_q=128, block_k=128, **kw))


@pytest.mark.parametrize("lq,lk,mask_len,pad", [
    (256, 384, 128, (40, 128)),   # masked text prefix bounded by mask_len
    (200, 300, 100, (60, 100)),   # tail padding of both q and k blocks
    (128, 640, None, None),       # no mask
])
def test_joint_plain_matches_pallas(lq, lk, mask_len, pad):
    b, h = 2, 2
    q, k, v = _arr((b, h, lq, 128), 1), _arr((b, h, lk, 128), 2), _arr((b, h, lk, 128), 3)
    mask = None
    if pad is not None:
        mask = np.ones((b, lk), bool)
        mask[0, pad[0]:pad[1]] = False
        mask[1, pad[0] // 2:pad[1]] = False
    want = _jax(q, k, v, kv_mask=None if mask is None else jnp.asarray(mask),
                mask_len=mask_len)
    tmask = None if mask is None else torch.from_numpy(mask)
    got = fa.joint_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), tmask, mask_len)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        fa.joint_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), tmask).numpy(), want, **TOL)


@pytest.mark.parametrize("h,hkv,lk", [(4, 2, 384), (6, 2, 300), (2, 2, 256)])
def test_joint_gqa_plain_matches_streaming_pallas(h, hkv, lk):
    """K4's role: the JAX streaming kernel (``_flash_kernel_hbm``, forced
    with stream=True) with kv_heads < heads and a text-prefix mask."""
    b, lq, mask_len = 2, 200, 128
    q, k, v = _arr((b, h, lq, 128), 12), _arr((b, hkv, lk, 128), 13), _arr((b, hkv, lk, 128), 14)
    mask = np.ones((b, lk), bool)
    mask[0, 70:mask_len] = False
    mask[1, 20:mask_len] = False
    want = _jax(q, k, v, kv_mask=jnp.asarray(mask), mask_len=mask_len, stream=True)
    got = fa.joint_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(mask), mask_len)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_stream_role_follows_the_jax_resident_budget():
    """flash_joint_stream counts where the JAX package would stream K/V:
    2 · Lk · D · 2 bytes > 6 MiB, i.e. Lk > 12288 at D = 128 in bf16."""
    kv = lambda lk: torch.empty((1, 24, lk, 128), dtype=torch.bfloat16, device="meta")
    assert not fa.streams_kv(kv(8448)) and not fa.streams_kv(kv(12288))
    assert fa.streams_kv(kv(12289)) and fa.streams_kv(kv(12736))


@pytest.mark.parametrize("h,hkv,l", [(4, 2, 256), (2, 2, 384), (8, 2, 300)])
def test_causal_plain_matches_pallas(h, hkv, l):
    q, k, v = _arr((1, h, l, 128), 4), _arr((1, hkv, l, 128), 5), _arr((1, hkv, l, 128), 6)
    want = _jax(q, k, v, causal=True)
    got = fa.causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_causal_suffix_padding_matches_pallas():
    """K2 takes no mask: on the real rows, the kernel over a suffix-padded
    sequence equals the plain version with the padding masked out."""
    n_real, l = 200, 256
    q, k, v = _arr((1, 4, l, 128), 7), _arr((1, 2, l, 128), 8), _arr((1, 2, l, 128), 9)
    want = _jax(q, k, v, causal=True)[:, :, :n_real]
    keep = torch.arange(l) < n_real
    got = fa.causal_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), keep)[:, :, :n_real]
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cpu_tensors_take_the_plain_version_without_launching():
    q = torch.from_numpy(_arr((1, 2, 64, 128), 10)).bfloat16()
    before = dict(kernels.LAUNCHES)
    out = fa.joint_attention(q, q, q)
    assert kernels.LAUNCHES == before
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


@pytest.mark.parametrize("d,dtype,ok", [(128, torch.bfloat16, True),
                                        (128, torch.float32, False),
                                        (80, torch.bfloat16, False),
                                        (256, torch.bfloat16, False)])
def test_supported_gate(d, dtype, ok):
    q = torch.zeros((1, 1, 8, d), dtype=dtype)
    assert fa.supported(q, q, q) is ok


def test_dispatch_routes_by_gate_and_flag(monkeypatch):
    """ops.attention: the K1 wrapper when use_flash and the gate pass, the
    XLA-style reference otherwise (the two compute different roundings in
    bf16, so the test checks which function ran); nothing launches on the
    CPU."""
    calls = []
    for mod, name in ((fa, "joint_attention"), (att, "reference_attention")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **kw:
                            calls.append(_n) or _fn(*a, **kw))
    q = torch.from_numpy(_arr((1, 2, 96, 128), 11)).bfloat16()
    mask = torch.ones((1, 96), dtype=torch.bool)
    mask[:, 10:32] = False
    before = dict(kernels.LAUNCHES)
    a = att.attention(q, q, q, mask, use_flash=True, mask_len=32)
    b = att.attention(q, q, q, mask, use_flash=False)
    c = att.attention(q.float(), q.float(), q.float(), mask, use_flash=True)
    assert calls == ["joint_attention", "reference_attention", "reference_attention"]
    assert kernels.LAUNCHES == before
    assert a.dtype == b.dtype == torch.bfloat16 and c.dtype == torch.float32
    torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=0)
