"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with the CUDA toolkit and skips elsewhere.
On the card run it without the JAX-side conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from qwen_image_edit_streamdiffusion_tpu_torch.ops import conv as conv_ops
from qwen_image_edit_streamdiffusion_tpu_torch.ops import flash_attention as fa
from qwen_image_edit_streamdiffusion_tpu_torch.ops import int8
from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, dev, dtype=torch.bfloat16):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(dev, dtype)


# bf16 inputs and outputs: the kernel and the plain version round P and the
# output at different places; 2e-2 absolute covers bf16 resolution at |o| < 2.
ATT_TOL = 2e-2


@pytest.mark.parametrize("lq,lk,mask_len", [(128, 128, None), (200, 328, 64),
                                            (256, 1000, 130)])
def test_joint_kernel_matches_plain(dev, lq, lk, mask_len):
    q = _randn((2, 3, lq, 128), 0, dev)
    k = _randn((2, 3, lk, 128), 1, dev)
    v = _randn((2, 3, lk, 128), 2, dev)
    mask = None
    if mask_len is not None:
        m = np.ones((2, lk), bool)
        m[0, mask_len // 2:mask_len] = False
        m[1, 5:mask_len] = False
        mask = torch.from_numpy(m).to(dev)
    before = kernels.LAUNCHES["flash_joint"]
    out = fa.joint_attention(q, k, v, mask, mask_len)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_joint"] == before + 1
    ref = fa.joint_attention_plain(q, k, v, mask, mask_len)
    err = (out.float() - ref.float()).abs().max().item()
    assert err < ATT_TOL, err


@pytest.mark.parametrize("h,hkv", [(24, 24), (28, 4)])
def test_joint_kernel_streams_long_gqa_sequences(dev, h, hkv):
    """K4's role at the two-image shape: Lk = 256 text + 3 × 4096 image
    tokens, text-prefix mask, counted as a streaming launch."""
    lk, txt_len = 12544, 256
    q = _randn((1, h, lk, 128), 9, dev)
    k = _randn((1, hkv, lk, 128), 10, dev)
    v = _randn((1, hkv, lk, 128), 11, dev)
    mask = torch.ones((1, lk), dtype=torch.bool, device=dev)
    mask[:, 200:txt_len] = False
    before = dict(kernels.LAUNCHES)
    out = fa.joint_attention(q, k, v, mask, txt_len)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_joint_stream"] == before["flash_joint_stream"] + 1
    assert kernels.LAUNCHES["flash_joint"] == before["flash_joint"]
    for hq in range(h):  # the plain version's f32 scores, one head at a time
        kv = slice(hq // (h // hkv), hq // (h // hkv) + 1)
        ref = fa.joint_attention_plain(q[:, hq:hq + 1], k[:, kv], v[:, kv], mask)
        err = (out[:, hq:hq + 1].float() - ref.float()).abs().max().item()
        assert err < ATT_TOL, (hq, err)


@pytest.mark.parametrize("h,hkv,l,n_real", [(4, 4, 128, 128), (28, 4, 384, 300),
                                            (8, 2, 200, 200)])
def test_causal_kernel_matches_plain(dev, h, hkv, l, n_real):
    q = _randn((1, h, l, 128), 3, dev)
    k = _randn((1, hkv, l, 128), 4, dev)
    v = _randn((1, hkv, l, 128), 5, dev)
    out = fa.causal_attention(q, k, v)
    mask = torch.arange(l, device=dev) < n_real
    ref = fa.causal_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    err = (out[:, :, :n_real].float() - ref[:, :, :n_real].float()).abs().max()
    assert err.item() < ATT_TOL, err.item()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("shape", [(1, 16, 128, 8, 16), (2, 33, 70, 48, 96),
                                   (1, 40, 64, 96, 3), (1, 17, 19, 16, 384),
                                   (1, 70, 21, 128, 40)])
def test_conv_kernel_matches_plain(dev, dtype, tol, shape):
    b, h, w, c, f = shape
    x = _randn((b, h, w, c), 6, dev, dtype)
    wt = (_randn((3, 3, c, f), 7, dev, torch.float32) * (9 * c) ** -0.5).to(dtype)
    bias = _randn((f,), 8, dev, dtype)
    before = kernels.LAUNCHES["conv3x3"]
    out = conv_ops.conv3x3(x, wt, bias)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv3x3"] == before + 1
    ref = conv_ops.conv3x3_plain(x.float(), wt.float(), bias.float())
    scale = max(1.0, ref.abs().max().item())
    err = (out.float() - ref).abs().max().item()
    assert err < tol * scale, err


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = _randn((1, 2, 64, 128), 0, dev)
    with pytest.raises(TypeError):
        fa.joint_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError):
        fa.joint_attention(q.transpose(2, 3), q, q)
    x = _randn((1, 8, 8, 12), 0, dev)
    with pytest.raises(ValueError):
        conv_ops.conv3x3(x, _randn((3, 3, 12, 4), 1, dev), _randn((4,), 2, dev))


# K5 and K6 are bit-identical to their plain versions (see csrc/int8_gemm.cu).


@pytest.mark.parametrize("k", [3072, 3420])
@pytest.mark.parametrize("m", [1, 17, 256])
def test_quantize_rows_kernel_is_bit_identical(dev, m, k):
    x = _randn((m, k), 12, dev)
    x[0, :5] = torch.tensor([0.5, 1.5, -2.5, 0.0, 3.0], dtype=torch.bfloat16)
    before = kernels.LAUNCHES["quantize_rows"]
    q, s = int8.quantize_rows(x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["quantize_rows"] == before + 1
    q_ref, s_ref = int8.quantize_rows_plain(x)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("k,n", [(3072, 264), (3420, 199)])
@pytest.mark.parametrize("m", [1, 17, 256])
def test_int8_gemm_kernel_is_bit_identical(dev, m, k, n, bias):
    xq, xs = int8.quantize_rows_plain(_randn((m, k), 13, dev))
    wq, ws = int8.quantize_weight(_randn((n, k), 14, dev) * 0.02)
    b = _randn((n,), 15, dev) * 0.1 if bias else None
    before = kernels.LAUNCHES["int8_gemm"]
    out = int8.int8_matmul(xq, xs, wq, ws, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["int8_gemm"] == before + 1
    assert torch.equal(out, int8.int8_matmul_plain(xq, xs, wq, ws, b))


def test_int8_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = _randn((4, 64), 16, dev)
    with pytest.raises(TypeError):
        int8.quantize_rows(x.float())
    with pytest.raises(ValueError):
        int8.quantize_rows(_randn((64, 4), 16, dev).t())
    xq, xs = int8.quantize_rows(x)
    wq, ws = int8.quantize_weight(_randn((8, 64), 17, dev))
    with pytest.raises(TypeError):
        int8.int8_matmul(xq.float(), xs, wq, ws)
    with pytest.raises(ValueError):
        int8.int8_matmul(xq, xs, wq.t().contiguous().t(), ws)
    with pytest.raises(ValueError):
        int8.int8_matmul(xq[:, :62].contiguous(), xs, wq[:, :62].contiguous(), ws)
