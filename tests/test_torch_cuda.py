"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with the CUDA toolkit and skips elsewhere.
On the card run it without the JAX-side conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import CONV_TOL, bwd_exp2_bf16_argument
from qwen_image_edit_streamdiffusion_tpu_torch.core import imaging
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


# The flash forward kernels and their plain versions round at the same points
# (bf16 Q_pre, exp2 argument, P and O); the kernels take a blockwise running
# max where the plain versions take the row's global max, so a few rounded
# exp2 arguments, and with them P, differ. The outputs stay within two bf16
# ulps (8 significant bits) at max|ref|, and LSE2 (f32, base 2) within LSE_TOL.
LSE_TOL = 2e-3


def _att_err(out, ref):
    """max|out - ref| and the tolerance: two bf16 ulps at max|ref|."""
    ref = ref.float()
    tol = 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 6)
    return (out.float() - ref).abs().max().item(), tol


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
    err, tol = _att_err(out, fa.joint_attention_plain(q, k, v, mask, mask_len))
    assert err <= tol, (err, tol)


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
    rep = h // hkv  # the plain version's f32 scores, one head at a time
    ref = torch.cat([fa.joint_attention_plain(q[:, hq:hq + 1], k[:, hq // rep:hq // rep + 1],
                                              v[:, hq // rep:hq // rep + 1], mask)
                     for hq in range(h)], dim=1)
    err, tol = _att_err(out, ref)
    assert err <= tol, (err, tol)


def _rule_mask(m: np.ndarray, lk: int, mask_len: int) -> np.ndarray:
    """The mask as the kernels read it (``mask_applies`` in mma_bf16.cuh): a
    key's entry counts where its 64-key group starts below mask_len or holds
    the ragged tail; elsewhere the key is valid."""
    g = np.arange(lk) & ~63
    applies = (g < mask_len) | (g + 64 > lk)
    return np.where(applies[None, :], m, True)


@pytest.mark.parametrize("lk", [128, 328, 4160])
@pytest.mark.parametrize("lq", [1, 64, 200, 1000])
def test_sm90_forward_tile_edges(dev, lq, lk):
    """The wgmma/TMA forward at the edges of its 128-row, 128-key tiles: a
    prefix mask whose mask_len is on no block boundary, masked keys in the
    ragged tail, B = 2 and GQA 28/4; every row equals the plain version."""
    b, h, hkv, mask_len = 2, 28, 4, 70
    q = _randn((b, h, lq, 128), 40, dev)
    k = _randn((b, hkv, lk, 128), 41, dev)
    v = _randn((b, hkv, lk, 128), 42, dev)
    m = np.ones((b, lk), bool)
    m[0, 30:mask_len] = False
    m[1, 3:mask_len] = False
    m[1, lk - 5:lk - 2] = False  # in the ragged tail's 64-key group
    mask = torch.from_numpy(m).to(dev)
    before = dict(kernels.LAUNCHES)
    out = fa.joint_attention(q, k, v, mask, mask_len)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_joint"] == before["flash_joint"] + 1
    ref = fa.joint_attention_plain(q, k, v, torch.from_numpy(_rule_mask(m, lk, mask_len)).to(dev))
    err, tol = _att_err(out, ref)
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("b,h,lq,lk,mask_len", [(1, 2, 1, 128, None), (2, 3, 1000, 4160, 70),
                                                (2, 2, 64, 330, 100)])
def test_sm90_lse_output_and_k7_equals_k1(dev, b, h, lq, lk, mask_len):
    q, k, v, _, mask = _train_inputs(dev, b, h, lq, lk, mask_len)
    out, lse = fa.flash_fwd_lse(q, k, v, mask, mask_len)
    torch.cuda.synchronize()
    assert torch.equal(out, fa.joint_attention(q, k, v, mask, mask_len))
    ref_o, ref_lse = fa.flash_fwd_lse_plain(q, k, v, mask, mask_len)
    err, tol = _att_err(out, ref_o)
    assert err <= tol, (err, tol)
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL


def test_mask_rule_is_one_rule_for_k7_k8_k9(dev):
    """mask_len = 100 (not a multiple of 64 or 128), Lk = 330: zeros below
    mask_len and in the tail group count, a zero at key 200 does not, in the
    forward and in both backward kernels alike; the keys the rule masks get
    exactly zero dK and dV, and O matches the plain version on the rule's
    mask."""
    b, h, lq, lk, mask_len = 2, 2, 200, 330, 100
    q, k, v, do, _ = _train_inputs(dev, b, h, lq, lk, None)
    m = np.ones((b, lk), bool)
    m[:, 90:100] = False
    m[:, 200] = False
    m[1, 325:328] = False
    mask = torch.from_numpy(m).to(dev)
    eff = torch.from_numpy(_rule_mask(m, lk, mask_len)).to(dev)
    out, lse = fa.flash_fwd_lse(q, k, v, mask, mask_len)
    err, tol = _att_err(out, fa.flash_fwd_lse_plain(q, k, v, eff)[0])
    assert err <= tol, (err, tol)
    delta = (do.float() * out.float()).sum(-1).reshape(b * h, lq)
    q_pre = fa.prescale_q(q)
    dk, dv = fa.flash_bwd_dkv(q_pre, k, v, do, lse, delta, mask, mask_len)
    dq = fa.flash_bwd_dq(q_pre, k, v, do, lse, delta, mask, mask_len)
    torch.cuda.synchronize()
    dead = ~eff[:, None, :, None].expand(b, h, lk, 128)
    assert torch.count_nonzero(dk[dead]) == 0 and torch.count_nonzero(dv[dead]) == 0
    assert torch.count_nonzero(dk[:, :, 200]) > 0  # outside the rule: a live key
    ref_dq = fa.flash_bwd_dq_plain(q_pre, k, v, do, lse, delta, eff)
    assert (dq - ref_dq).abs().max().item() < GRAD_TOL * ref_dq.abs().max().item()


# K2 on the causal instances of the sm90 forward (64- and 128-row CTAs):
# lengths off and on its 128-key tiles (and off 64), full or suffix-padded
# (real rows compared), 28 q on 4 kv heads, 8 on 2 and 4 on 4.
@pytest.mark.parametrize("block_q", [64, 128])
@pytest.mark.parametrize("h,hkv", [(28, 4), (8, 2), (4, 4)])
@pytest.mark.parametrize("l,n_real", [(1, 1), (7, 7), (64, 64), (127, 127), (128, 100),
                                      (129, 129), (200, 200), (384, 258), (383, 383),
                                      (511, 511), (640, 577), (1024, 1024), (1100, 1100)])
def test_causal_kernel_matches_plain(dev, h, hkv, l, n_real, block_q):
    q = _randn((1, h, l, 128), 3, dev)
    k = _randn((1, hkv, l, 128), 4, dev)
    v = _randn((1, hkv, l, 128), 5, dev)
    before = kernels.LAUNCHES["flash_causal"]
    out = fa.causal_attention(q, k, v, block_q)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_causal"] == before + 1
    ref = fa.causal_attention_plain(q, k, v, torch.arange(l, device=dev) < n_real)
    err, tol = _att_err(out[:, :, :n_real], ref[:, :, :n_real])
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("block_q", [64, 128])
def test_causal_kernel_is_deterministic(dev, block_q):
    """Two runs of K2 at the main path's bucket give the same bits, and the
    two tiles give the same bits: each row's key blocks are the same."""
    q = _randn((1, 28, 384, 128), 23, dev)
    k = _randn((1, 4, 384, 128), 24, dev)
    v = _randn((1, 4, 384, 128), 25, dev)
    a = fa.causal_attention(q, k, v, block_q)
    b = fa.causal_attention(q, k, v, block_q)
    other = fa.causal_attention(q, k, v, 192 - block_q)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a, other)


# K3 at every shape of the flagship VAE's mix, cut to a few tiles: (B, H, W,
# C_in, F). H and W off the 4 × 16 tile, B = 2; F = 3 (N = 8), 48, 96, 192
# (two 96-wide slices) and 384 (four); C_in 16, 48, 96, and 24 and 128 (K
# padded to 32; N = 48 beside 128-channel weights).
CONV_MIX = [(2, 37, 45, 96, 96), (1, 42, 33, 96, 48), (2, 19, 50, 48, 96),
            (2, 29, 70, 96, 3), (1, 20, 31, 96, 192), (2, 13, 18, 16, 384),
            (1, 9, 100, 24, 40), (1, 23, 21, 128, 96)]


@pytest.mark.parametrize("shape", CONV_MIX)
def test_conv_sm90_mix_shapes(dev, shape):
    """bf16 against the plain version in bf16 (cuDNN), within CONV_TOL (two
    bf16 ulps at max(1, max|ref|)); a rerun gives the same bits."""
    b, h, w, c, f = shape
    x = _randn((b, h, w, c), 30, dev)
    wt = (_randn((3, 3, c, f), 31, dev, torch.float32) * (9 * c) ** -0.5).to(torch.bfloat16)
    bias = _randn((f,), 32, dev) * 0.1
    before = kernels.LAUNCHES["conv3x3"]
    out = conv_ops.conv3x3(x, wt, bias)
    again = conv_ops.conv3x3(x, wt, bias)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv3x3"] == before + 2
    ref = conv_ops.conv3x3_plain(x, wt, bias).float()
    err = (out.float() - ref).abs().max().item()
    assert err <= CONV_TOL * max(1.0, ref.abs().max().item()), err
    assert torch.equal(out, again)


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



# The resize's size cases (core/imaging.py): on the card its float64 products
# give the host's bytes, which tests/test_torch_imaging.py holds to Pillow's.
RESIZE_CASES = [("lanczos", (1024, 1024), (384, 384)),
                ("lanczos", (768, 1024), (320, 448)),
                ("lanczos", (200, 300), (864, 1184)),
                ("bicubic", (384, 384), (392, 392)),
                ("bicubic", (384, 384), (224, 224))]


@pytest.mark.parametrize("filt,src,dst", RESIZE_CASES)
def test_resize_on_the_card_equals_the_host(dev, filt, src, dst):
    img = np.random.default_rng(40).integers(0, 256, src + (3,)).astype(np.uint8)
    host = imaging.resize(img, dst[1], dst[0], filt)
    card = imaging.resize(img, dst[1], dst[0], filt, dev)
    np.testing.assert_array_equal(card, host)

# Guided and batched edits run the kernels at more rows: K1 over a CFG pair
# (each row its own text mask) or 2N rows, K2 over the pos+neg LM rows (each
# row's padding its own suffix), K3 on a decode of N rows. Each row must
# equal that row launched alone, bit for bit.
@pytest.mark.parametrize("b", [2, 4])
def test_joint_kernel_rows_with_their_own_masks(dev, b):
    lk, txt_len = 1100, 320
    q = _randn((b, 4, lk, 128), 50, dev)
    k = _randn((b, 4, lk, 128), 51, dev)
    v = _randn((b, 4, lk, 128), 52, dev)
    m = np.ones((b, lk), bool)
    for row in range(b):
        m[row, 150 + 40 * row:txt_len] = False
    mask = torch.from_numpy(m).to(dev)
    out = fa.joint_attention(q, k, v, mask, txt_len)
    err, tol = _att_err(out, fa.joint_attention_plain(q, k, v, mask, txt_len))
    assert err <= tol, (err, tol)
    for row in range(b):
        one = fa.joint_attention(q[row:row + 1], k[row:row + 1], v[row:row + 1],
                                 mask[row:row + 1], txt_len)
        assert torch.equal(out[row:row + 1], one)


@pytest.mark.parametrize("block_q", [64, 128])
@pytest.mark.parametrize("b", [2, 4])
def test_causal_kernel_rows_with_their_own_suffix_padding(dev, b, block_q):
    l = 384
    q = _randn((b, 28, l, 128), 53, dev)
    k = _randn((b, 4, l, 128), 54, dev)
    v = _randn((b, 4, l, 128), 55, dev)
    out = fa.causal_attention(q, k, v, block_q)
    for row in range(b):
        n_real = 258 - 5 * row
        keep = torch.arange(l, device=dev) < n_real
        ref = fa.causal_attention_plain(q[row:row + 1], k[row:row + 1],
                                        v[row:row + 1], keep)
        err, tol = _att_err(out[row:row + 1, :, :n_real], ref[:, :, :n_real])
        assert err <= tol, (row, err, tol)
        one = fa.causal_attention(q[row:row + 1], k[row:row + 1], v[row:row + 1],
                                  block_q)
        assert torch.equal(out[row:row + 1], one)


# the tiny decoder's conv shapes (64 channels; 16 in at its first conv; 3
# out at its last), cut in size, at two rows
@pytest.mark.parametrize("shape", [(2, 40, 36, 64, 64), (2, 17, 21, 16, 64),
                                   (2, 33, 30, 64, 3), (2, 37, 45, 96, 96)])
def test_conv_kernel_rows(dev, shape):
    b, h, w, c, f = shape
    x = _randn((b, h, w, c), 56, dev)
    wt = (_randn((3, 3, c, f), 57, dev, torch.float32) * (9 * c) ** -0.5).to(torch.bfloat16)
    bias = _randn((f,), 58, dev) * 0.1
    out = conv_ops.conv3x3(x, wt, bias)
    ref = conv_ops.conv3x3_plain(x, wt, bias).float()
    assert (out.float() - ref).abs().max().item() <= CONV_TOL * max(1.0, ref.abs().max().item())
    for row in range(b):
        assert torch.equal(out[row:row + 1], conv_ops.conv3x3(x[row:row + 1], wt, bias))


def test_colorspace_on_the_card_equals_the_cpu(dev):
    """The yuv420 device conversions are elementwise f32 in a fixed order:
    the card gives the CPU's bytes and values."""
    from qwen_image_edit_streamdiffusion_tpu_torch.ops import colorspace as cs

    rng = np.random.default_rng(59)
    x = torch.from_numpy(rng.uniform(-5, 260, (2, 64, 96, 3)).astype(np.float32))
    assert torch.equal(cs.rgb_to_yuv420(x.to(dev)).cpu(), cs.rgb_to_yuv420(x))
    p = torch.from_numpy(rng.integers(0, 256, (2, 32, 48, 6), np.uint8))
    assert torch.equal(cs.yuv420_to_rgb(p.to(dev)).cpu(), cs.yuv420_to_rgb(p))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = _randn((1, 2, 64, 128), 0, dev)
    with pytest.raises(TypeError):
        fa.joint_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError):
        fa.joint_attention(q.transpose(2, 3), q, q)
    with pytest.raises(ValueError):  # H % Hkv != 0
        fa.joint_attention(_randn((1, 3, 64, 128), 0, dev), q, q)
    with pytest.raises(ValueError):  # a mask that is not (B, Lk)
        fa.joint_attention(q, q, q, torch.ones((1, 63), dtype=torch.bool, device=dev))
    with pytest.raises(ValueError):  # an empty sequence
        fa.joint_attention(q[:, :, :0].contiguous(), q, q)
    with pytest.raises(ValueError):  # K7 takes H == Hkv only
        fa.flash_fwd_lse(_randn((1, 4, 64, 128), 0, dev), q, q)
    with pytest.raises(ValueError):  # K2 takes 64- or 128-row CTAs
        fa.causal_attention(q, q, q, 96)
    x = _randn((1, 8, 8, 12), 0, dev)
    with pytest.raises(ValueError):
        conv_ops.conv3x3(x, _randn((3, 3, 12, 4), 1, dev), _randn((4,), 2, dev))


# K5 and K6 are bit-identical to their plain versions (see csrc/int8_gemm.cu).
# K5's K: every thread count a row can take (32 .. 1024 threads; 16-, 8- and
# 2-byte loads: K % 8, K % 4, odd K). K6: M from a GEMV to the vision tower's
# 784 rows, ragged N, K a multiple of 16 but not of 128 (1040: the last slab
# partly zero-filled by TMA), and K % 16 != 0 (3420: the mma.sync body).
K5_K = (30, 1000, 1280, 3072, 3420, 5120, 12288, 18944)
CARD_M = (1, 16, 17, 200, 384, 784)
CARD_KN = ((1040, 199), (1040, 264), (3072, 3420), (3420, 199))


@pytest.mark.parametrize("k", K5_K)
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


def _gemm_inputs(dev, m, k, n, bias, seed=13):
    xq, xs = int8.quantize_rows_plain(_randn((m, k), seed, dev))
    wq, ws = int8.quantize_weight(_randn((n, k), seed + 1, dev) * 0.02)
    b = _randn((n,), seed + 2, dev) * 0.1 if bias else None
    return xq, xs, wq, ws, b


def _check_gemm(xq, xs, wq, ws, b):
    before = kernels.LAUNCHES["int8_gemm"]
    out = int8.int8_matmul(xq, xs, wq, ws, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["int8_gemm"] == before + 1
    assert torch.equal(out, int8.int8_matmul_plain(xq, xs, wq, ws, b))
    return out


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("k,n", CARD_KN)
@pytest.mark.parametrize("m", CARD_M)
def test_int8_gemm_kernel_is_bit_identical(dev, m, k, n, bias):
    _check_gemm(*_gemm_inputs(dev, m, k, n, bias))


# A batched-CFG miss's int8 rows (the pair as one forward, pos+neg as one LM
# call): the modulation GEMV at M = 2, the text stream at 512, the LM at 768,
# the image stream at 16384.
CFG_INT8 = ((2, 3072, 18432), (512, 3072, 3072), (512, 12288, 3072),
            (768, 3584, 512), (768, 18944, 3584), (16384, 3072, 3072))


@pytest.mark.parametrize("m,k,n", CFG_INT8)
def test_int8_kernels_at_guided_rows_are_bit_identical(dev, m, k, n):
    x = _randn((m, k), 60, dev)
    q, s = int8.quantize_rows(x)
    q_ref, s_ref = int8.quantize_rows_plain(x)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    _check_gemm(*_gemm_inputs(dev, m, k, n, True, seed=61))


@pytest.mark.parametrize("m,k,n", [(384, 18944, 3584), (384, 3584, 512),
                                   (256, 12288, 3072)])
def test_int8_gemm_split_k_is_exact_and_deterministic(dev, m, k, n):
    """The path's lm_down, LM k/v and txt_fc2 take split-K: bit-identical to
    the plain version, and again on a rerun after another split launch."""
    assert int8.gemm_plan(m, n, k).splits > 1
    args = _gemm_inputs(dev, m, k, n, True)
    out = _check_gemm(*args)
    _check_gemm(*_gemm_inputs(dev, 256, 3072, 3072, False, seed=20))
    assert torch.equal(int8.int8_matmul(*args), out)


# The row-parallel entries at a TP-2 rank's shapes (parallel/sharding.py):
# (M, K of the rank's slice, N), the vision `down` slice padded to 1712.
ROW_INT8 = ((8192, 1536, 3072), (256, 6144, 3072), (384, 9472, 3584),
            (784, 1712, 1280), (196, 2560, 3584), (17, 1040, 199))


@pytest.mark.parametrize("m,k,n", ROW_INT8)
def test_row_parallel_int8_entries_are_bit_identical(dev, m, k, n):
    """K5's row scales alone equal the plain version's; K5 with a given row
    scale writes the plain version's codes (here the scale of a row twice
    as wide, as a rank's slice is quantized with the whole row's scale);
    K6's int32 entry writes the exact sums, split-K or not; K6's epilogue
    on the sums equals the plain one; each counts one launch of its
    kernel."""
    x = _randn((m, k), 70, dev)
    scale = int8.quantize_rows_plain(torch.cat([x, 2 * x], dim=1))[1]
    wq, ws = int8.quantize_weight(_randn((n, k), 71, dev) * 0.02)
    b = _randn((n,), 72, dev) * 0.1
    before = dict(kernels.LAUNCHES)
    own = int8.row_scales(x)
    q = int8.quantize_rows_given(x, scale)
    acc = int8.int8_matmul_acc(q, wq)
    out = int8.int8_epilogue(acc, scale, ws, b, torch.bfloat16)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["quantize_rows"] == before["quantize_rows"] + 2
    assert kernels.LAUNCHES["int8_gemm"] == before["int8_gemm"] + 2
    assert torch.equal(own, int8.row_scales_plain(x))
    assert torch.equal(q, int8.quantize_rows_given_plain(x, scale))
    assert acc.dtype == torch.int32
    assert torch.equal(acc, int8.int8_matmul_acc_plain(q, wq))
    assert torch.equal(out, int8.int8_epilogue_plain(acc, scale, ws, b, torch.bfloat16))
    assert torch.equal(int8.int8_epilogue(acc, scale, ws, None, torch.bfloat16),
                       int8.int8_epilogue_plain(acc, scale, ws, None, torch.bfloat16))


@pytest.mark.parametrize("k,parts", [(3072, 2), (3420, 2), (3420, 4), (12288, 2)])
def test_row_parallel_int8_linear_equals_one_device(dev, k, parts):
    """The ranks of a row-parallel int8 linear emulated on one card (the
    all-reduces as a MAX of the slices' scales and a sum of their int32
    products; the weight slices padded as the sharding pads them): the
    output equals the whole row's int8 linear bit for bit."""
    from types import SimpleNamespace

    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed, sharding

    m, n = 300, 1280
    x = _randn((m, k), 72, dev)
    wq, ws = int8.quantize_weight(_randn((n, k), 73, dev) * 0.02)
    b = _randn((n,), 74, dev) * 0.1
    want = int8.int8_linear(x, {"w_q": wq, "scale": ws, "bias": b})
    w = k // parts
    parts_x = [x[:, r * w:(r + 1) * w].contiguous() for r in range(parts)]
    scale = torch.stack([int8.row_scales_plain(p) for p in parts_x]).amax(0)
    assert torch.equal(scale, int8.row_scales_plain(x))
    sums = []
    real = distributed.all_reduce

    def fake_all_reduce(t, group, op="sum"):
        if op == "max":
            return t.copy_(scale)
        sums.append(t.clone())
        return t

    distributed.all_reduce = fake_all_reduce
    try:
        for r in range(parts):
            w_r = sharding.pad_codes(wq[:, r * w:(r + 1) * w]).contiguous()
            int8.int8_linear_row(parts_x[r], {"w_q": w_r, "scale": ws, "bias": b},
                                 SimpleNamespace(size=parts, rank=r))
    finally:
        distributed.all_reduce = real
    acc = torch.stack(sums).sum(0, dtype=torch.int32)
    assert torch.equal(int8.int8_epilogue(acc, scale, ws, b, torch.bfloat16), want)


def test_int8_gemm_split_k_launches_on_two_streams_do_not_mix(dev):
    """Split-K launches that overlap on two streams each keep their own
    partials and tile counters: every result stays bit-identical."""
    shapes = ((384, 18944, 3584), (256, 12288, 3072))
    inputs = [_gemm_inputs(dev, m, k, n, True, seed=30 + i)
              for i, (m, k, n) in enumerate(shapes)]
    refs = [int8.int8_matmul_plain(*args) for args in inputs]
    streams = [torch.cuda.Stream(dev) for _ in shapes]
    torch.cuda.synchronize(dev)
    outs = [[] for _ in shapes]
    for _ in range(8):
        for args, stream, got in zip(inputs, streams, outs):
            with torch.cuda.stream(stream):
                got.append(int8.int8_matmul(*args))
    torch.cuda.synchronize(dev)
    for ref, got in zip(refs, outs):
        for out in got:
            assert torch.equal(out, ref)


@pytest.mark.parametrize("m,n", [(384, 512), (256, 264)])
def test_int8_gemm_saturated_codes_at_the_widest_k(dev, m, n):
    """±127 codes at K = 18944: |acc| = 127² · 18944 ≈ 3.06e8, inside int32,
    through the split-K partial sums."""
    k = 18944
    xq = torch.full((m, k), 127, dtype=torch.int8, device=dev)
    xq[1::2] = -127
    wq = torch.full((n, k), 127, dtype=torch.int8, device=dev)
    wq[:, ::3] = -127
    xs = torch.full((m, 1), 1e-4, device=dev)
    ws = torch.full((n,), 1e-4, device=dev)
    _check_gemm(xq, xs, wq, ws, _randn((n,), 3, dev))


def test_int8_gemm_takes_the_mma_sync_body_where_k_is_not_16_aligned(dev):
    """K = 3420 (the vision tower's `down`): TMA cannot take the operands, so
    the plan gates it to the mma.sync body, which is still K6 and exact."""
    assert int8.gemm_plan(784, 1280, 3420).route == "mma_sync"
    assert int8.gemm_plan(784, 1280, 3424).route == "wgmma"
    _check_gemm(*_gemm_inputs(dev, 784, 3420, 1280, True))


def test_int8_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = _randn((4, 64), 16, dev)
    with pytest.raises(TypeError):
        int8.quantize_rows(x.float())
    with pytest.raises(ValueError):
        int8.quantize_rows(_randn((64, 4), 16, dev).t())
    with pytest.raises(ValueError):  # K5 holds a row in one CTA's registers
        int8.quantize_rows(_randn((2, 32776), 16, dev))
    xq, xs = int8.quantize_rows(x)
    wq, ws = int8.quantize_weight(_randn((8, 64), 17, dev))
    with pytest.raises(TypeError):
        int8.int8_matmul(xq.float(), xs, wq, ws)
    with pytest.raises(ValueError):
        int8.int8_matmul(xq, xs, wq.t().contiguous().t(), ws)
    with pytest.raises(ValueError):
        int8.int8_matmul(xq[:, :62].contiguous(), xs, wq[:, :62].contiguous(), ws)


def test_int8_gemm_refuses_a_misaligned_base(dev):
    """TMA needs a 16-byte aligned base: a view 4 bytes into its storage
    raises at K % 16 == 0 (it is not handed to the other body); the
    mma.sync body needs 4 bytes."""
    buf = torch.zeros(8 * 64 + 16, dtype=torch.int8, device=dev)
    xq = buf[4:4 + 8 * 64].view(8, 64)
    assert xq.is_contiguous() and xq.data_ptr() % 16
    xs = torch.ones((8, 1), device=dev)
    wq, ws = int8.quantize_weight(_randn((8, 64), 17, dev))
    with pytest.raises(ValueError, match="16-byte"):
        int8.int8_matmul(xq, xs, wq, ws)
    buf = torch.zeros(8 * 68 + 16, dtype=torch.int8, device=dev)
    xq = buf[2:2 + 8 * 68].view(8, 68)
    wq, ws = int8.quantize_weight(_randn((8, 68), 17, dev))
    with pytest.raises(ValueError, match="4-byte"):
        int8.int8_matmul(xq, xs, wq, ws)


# K7-K9: the trainable joint attention. K7's O is K1's bit for bit; the
# gradients are f32 sums of bf16 products, rounded at the same points as the
# plain versions but from an exp2 that differs in the last f32 bits, held to
# GRAD_TOL of their max. The kernels read about 1e-3; a backward that takes
# exp2 of the bf16-rounded argument reads 5e-3 to 1.2e-2, which the earlier
# limit of 1e-2 let through (test_grad_limit_catches_a_bf16_exp2_argument).
GRAD_TOL = 4e-3
# (b, h, lq, lk, mask_len): the edges of K8's 128-row and K9's 64-row query
# tiles and of both kernels' 128-key tiles (Lq = 1, Lq, Lk on no tile
# boundary, Lq < Lk and Lq > Lk, a key block holding one key), B = 2 with a
# different mask per row, mask_len on no block boundary
TRAIN_SHAPES = [(1, 2, 128, 128, None), (2, 3, 200, 328, 64), (1, 2, 256, 1000, 130),
                (2, 2, 1, 330, 100), (1, 3, 65, 129, None), (2, 2, 1000, 4160, 70),
                (2, 2, 4160, 1000, 100), (2, 1, 330, 70, 40)]


def _train_inputs(dev, b, h, lq, lk, mask_len):
    q, do = _randn((b, h, lq, 128), 20, dev), _randn((b, h, lq, 128), 23, dev)
    k, v = _randn((b, h, lk, 128), 21, dev), _randn((b, h, lk, 128), 22, dev)
    mask = None
    if mask_len is not None:
        m = np.ones((b, lk), bool)
        m[0, mask_len // 2:mask_len] = False
        m[-1, 5:mask_len] = False
        mask = torch.from_numpy(m).to(dev)
    return q, k, v, do, mask


@pytest.mark.parametrize("b,h,lq,lk,mask_len", TRAIN_SHAPES)
def test_fwd_lse_kernel_is_k1_plus_lse(dev, b, h, lq, lk, mask_len):
    q, k, v, _, mask = _train_inputs(dev, b, h, lq, lk, mask_len)
    before = kernels.LAUNCHES["flash_fwd_lse"]
    out, lse = fa.flash_fwd_lse(q, k, v, mask, mask_len)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_fwd_lse"] == before + 1
    assert torch.equal(out, fa.joint_attention(q, k, v, mask, mask_len))
    ref_o, ref_lse = fa.flash_fwd_lse_plain(q, k, v, mask, mask_len)
    err, tol = _att_err(out, ref_o)
    assert err <= tol, (err, tol)
    assert lse.shape == (b * h, lq)
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL


def _bwd_inputs(dev, b, h, lq, lk, mask_len):
    """(Q_pre, K, V, dO, LSE2, Δ, mask) as the autograd Function hands them
    to K8 and K9, from K7's O and LSE2."""
    q, k, v, do, mask = _train_inputs(dev, b, h, lq, lk, mask_len)
    out, lse = fa.flash_fwd_lse(q, k, v, mask, mask_len)
    delta = (do.float() * out.float()).sum(-1).reshape(b * h, lq)
    return fa.prescale_q(q), k, v, do, lse, delta, mask


@pytest.mark.parametrize("b,h,lq,lk,mask_len", TRAIN_SHAPES)
def test_bwd_kernels_match_plain(dev, b, h, lq, lk, mask_len):
    args = _bwd_inputs(dev, b, h, lq, lk, mask_len)
    before = dict(kernels.LAUNCHES)
    dq = fa.flash_bwd_dq(*args, mask_len)
    dk, dv = fa.flash_bwd_dkv(*args, mask_len)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert kernels.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    ref_dq = fa.flash_bwd_dq_plain(*args, mask_len)
    ref_dk, ref_dv = fa.flash_bwd_dkv_plain(*args, mask_len)
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == torch.float32
        err = (got - ref).abs().max().item()
        assert err < GRAD_TOL * ref.abs().max().item(), err
    mask = args[-1]
    if mask is not None:
        dead = ~mask[:, None, :, None].expand(b, h, lk, 128)
        assert torch.count_nonzero(dk[dead]) == 0 and torch.count_nonzero(dv[dead]) == 0


def test_grad_limit_catches_a_bf16_exp2_argument(dev):
    """GRAD_TOL passes the kernels and fails a backward whose P is exp2 of
    the bf16-rounded argument, in each of dQ, dK and dV."""
    args = _bwd_inputs(dev, 1, 2, 256, 1000, 130)
    got = (fa.flash_bwd_dq(*args, 130),) + fa.flash_bwd_dkv(*args, 130)
    ref = (fa.flash_bwd_dq_plain(*args),) + fa.flash_bwd_dkv_plain(*args)
    wrong = bwd_exp2_bf16_argument(*args)
    torch.cuda.synchronize()
    for g, r, w in zip(got, ref, wrong):
        tol = GRAD_TOL * r.abs().max().item()
        assert (g - r).abs().max().item() < tol
        assert (w - r).abs().max().item() > tol


def test_bwd_kernels_are_deterministic(dev):
    """No atomics: two launches on the same inputs give the same bits."""
    args = _bwd_inputs(dev, 2, 3, 1000, 4160, 70)
    first = (fa.flash_bwd_dq(*args, 70),) + fa.flash_bwd_dkv(*args, 70)
    second = (fa.flash_bwd_dq(*args, 70),) + fa.flash_bwd_dkv(*args, 70)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_trainable_function_matches_autograd_of_plain(dev):
    q, k, v, do, mask = _train_inputs(dev, 2, 3, 200, 328, 64)
    qs = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention_trainable(*qs, mask, 64)
    got = torch.autograd.grad(out, qs, do)
    qr = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(fa.joint_attention_plain(*qr, mask), qr, do)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        err = (g.float() - r.float()).abs().max().item()
        assert err < 3e-2 * max(1.0, r.float().abs().max().item()), err


def test_a_gradient_never_goes_through_k1(dev):
    """A CUDA input that needs a gradient at a shape the trainable kernels
    do not take raises instead of losing its gradient in K1."""
    q = _randn((1, 4, 64, 128), 24, dev).requires_grad_()
    kv = _randn((1, 2, 64, 128), 25, dev)
    with pytest.raises(ValueError, match="no backward"):
        fa.joint_attention(q, kv, kv)
    from qwen_image_edit_streamdiffusion_tpu_torch.ops import attention as att
    with pytest.raises(ValueError, match="no backward"):
        att.attention(q, kv, kv)


# ---------------------------------------------------------------------------
# The realtime stream on the card (pipeline/stream.py)
# ---------------------------------------------------------------------------


def _stream_session(dev, transfer_format="yuv420", **config):
    """A stream session on a `tiny` pipeline whose MMDiT takes head_dim 128,
    so its attention runs K1 (the tiny preset's 32 does not pass the gate):
    64², 2 steps, a keyframe every 3 frames, the yuv420 wire by default."""
    import dataclasses

    from qwen_image_edit_streamdiffusion_tpu_torch.core.config import (
        StreamConfig,
        get_preset,
    )
    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.edit_pipeline import (
        EditPipeline,
    )
    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.stream import RealtimePipeline

    tiny = get_preset("tiny")
    preset = dataclasses.replace(tiny, model=dataclasses.replace(
        tiny.model, head_dim=128, axes_dims_rope=(32, 48, 48)))
    cfg = StreamConfig(width=64, height=64, vae_image_area=64 * 64, vl_image_area=32 * 32,
                       num_inference_steps=2, keyframe_interval=3, model_preset="tiny",
                       transfer_format=transfer_format, **config)
    return RealtimePipeline(pipe=EditPipeline.create(preset, cfg, seed=0, device=dev))


def test_stream_submit_frame_issues_no_host_sync(dev):
    """After warm-up, a keyframe and a temporal ``submit_frame`` run under
    ``set_sync_debug_mode("error")`` (any host sync raises) and launch K1;
    only ``_collect`` waits."""
    from qwen_image_edit_streamdiffusion_tpu_torch.core import imaging as im

    rt = _stream_session(dev)
    rt.precompute_conditions("oil painting", negative_prompt="blurry")
    rt.warmup(runs=2)
    img = im.make_test_image(64, 64, "gradient")
    torch.cuda.synchronize()
    before = kernels.LAUNCHES["flash_joint"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        key = rt.submit_frame(img)
        temporal = rt.submit_frame(img)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.LAUNCHES["flash_joint"] - before == 2 * 2 + 2 * 1  # layers × forwards
    for h in (key, temporal):
        out = rt._collect(h)
        assert out.shape == (64, 64, 3) and out.dtype == np.uint8


def test_stream_batched_rows_equal_sessions_alone(dev):
    """Two sessions (their own prompts, seeds and keyframes), then one
    temporal frame: dispatched as one 2-row frame, each row's pixels (rgb)
    within one code of the session dispatching alone."""
    import dataclasses

    from qwen_image_edit_streamdiffusion_tpu_torch.core import imaging as im
    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.stream import (
        RealtimePipeline,
        submit_frames_batched,
    )

    base = _stream_session(dev, transfer_format="rgb")
    frames = [im.make_test_image(64, 64, k) for k in ("gray", "gradient", "circle")]

    def prime():
        pair = []
        for prompt, f, seed in (("oil painting", frames[0], 0),
                                ("watercolor sketch", frames[1], 7)):
            rt = RealtimePipeline(pipe=dataclasses.replace(
                base.pipe, config=base.pipe.config.replace(seed=seed)))
            rt.precompute_conditions(prompt)
            rt.process_frame(f)
            pair.append(rt)
        return pair

    ref = [rt.process_frame(frames[2]) for rt in prime()]
    pair = prime()
    handles = submit_frames_batched(pair, [frames[2]] * 2)
    for rt, h, r in zip(pair, handles, ref):
        got = rt._collect(h)
        assert np.abs(got.astype(np.int16) - r.astype(np.int16)).max() <= 1


def test_euler_step_and_cached_rope_equal_the_upload_path(dev):
    """``euler_step`` with σ as host scalars equals the former device copy of
    σ_next − σ bit for bit, and the cached rope tables equal a fresh upload
    (the second request of a bucket gets the same tensors)."""
    from qwen_image_edit_streamdiffusion_tpu_torch.core.config import get_preset
    from qwen_image_edit_streamdiffusion_tpu_torch.models import scheduler as sched
    from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm
    from qwen_image_edit_streamdiffusion_tpu_torch.ops import rope as rope_ops

    sig = sched.make_schedule(4, 4096).sigmas
    for dtype in (torch.float32, torch.bfloat16):
        x, v = _randn((2, 4096, 64), 30, dev, dtype), _randn((2, 4096, 64), 31, dev, dtype)
        for i in range(4):
            dt = (sig[i + 1].float() - sig[i].float()).to(dev)
            old = (x.float() + dt * v.float()).to(dtype)
            assert torch.equal(sched.euler_step(x, v, sig[i], sig[i + 1]), old)
    cfg = get_preset("qwen-image-edit-2509").model
    shapes = ((1, 32, 32), (1, 32, 32))
    tables = tfm.make_rope(cfg, shapes, 192, dev)
    assert tfm.make_rope(cfg, shapes, 192, dev) is tables
    ia = rope_ops.image_angles(shapes, cfg.axes_dims_rope, cfg.rope_theta)
    ta = rope_ops.text_angles(192, shapes, cfg.axes_dims_rope, cfg.rope_theta)
    for got, want in zip(tables, rope_ops.cos_sin(ia, dev) + rope_ops.cos_sin(ta, dev)):
        assert got.device.type == "cuda" and torch.equal(got, want)


@pytest.mark.parametrize("src,dst", [((32, 32), (64, 64)), ((256, 256), (512, 512)),
                                     ((100, 60), (37, 90))])
def test_native_resize_on_the_card_equals_the_host(dev, src, dst):
    """The stream's preview upscale (the JAX native library's Lanczos-3) on
    the card gives the host's bytes."""
    arr = np.random.default_rng(src[0]).integers(0, 256, (*src, 3), np.uint8)
    host = imaging.resize_native(arr, dst[1], dst[0])
    card = imaging.resize_native(arr, dst[1], dst[0], dev)
    assert np.array_equal(host, card)


# ---------------------------------------------------------------------------
# Multi-rank training on the card (training/lora_train.py under a mesh)
# ---------------------------------------------------------------------------


def _tp_train_step(mesh, device):
    """One rank-16 LoRA step (remat, b drawn non-zero, no clip) of a 2-block
    MMDiT at the flagship's widths on one 1024² row, on this rank's slices
    under ``mesh`` (None: the whole model). Returns (loss, the reduced
    gradients on the host, K7/K8/K9 launches)."""
    import dataclasses

    from qwen_image_edit_streamdiffusion_tpu_torch.core.config import (
        ModelConfig,
        SchedulerConfig,
    )
    from qwen_image_edit_streamdiffusion_tpu_torch.core.rng import stream
    from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm
    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import sharding
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    cfg = dataclasses.replace(ModelConfig(), num_layers=2)
    params = tfm.init(stream(0, "transformer", device), cfg, device)
    if mesh is not None:
        params = sharding.shard_transformer_params(params, mesh)
    trainer = lt.LoRATrainer(params, cfg, SchedulerConfig(),
                             lt.TrainConfig(rank=16, alpha=16.0, grad_clip=0.0),
                             use_flash=True, mesh=mesh)
    leaves = lt.lora_leaves(trainer.lora)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(1)
        for t in leaves[1::2]:
            t.copy_(torch.randn(t.shape, generator=gen) * 0.01)
    g = 64  # the 1024² latent grid, packed
    mask = np.zeros((1, 256), bool)
    mask[:, :208] = True
    batch = {"x0_tokens": _randn((1, g * g, cfg.in_channels), 40, device),
             "cond_tokens": _randn((1, g * g, cfg.in_channels), 41, device),
             "txt": _randn((1, 256, cfg.joint_dim), 42, device),
             "txt_mask": torch.from_numpy(mask).to(device),
             "img_shapes": ((1, g, g), (1, g, g))}
    noise = _randn((1, g * g, cfg.in_channels), 43, "cpu", torch.float32)
    before = dict(kernels.LAUNCHES)
    loss = trainer.step(batch, torch.tensor([0.6]), noise)
    launches = {k: kernels.LAUNCHES[k] - before[k]
                for k in ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")}
    return loss, [p.grad.float().cpu() for p in leaves], launches


def _tp_train_rank(rank, init_file, queue):
    import traceback

    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed

    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        distributed.initialize("gloo", "cuda:0", init_method=f"file://{init_file}",
                               rank=rank, world_size=2)
        loss, grads, launches = _tp_train_step(distributed.global_mesh(1, 2), "cuda:0")
        # numpy, not tensors: a tensor crosses the queue as a handle into
        # this process, which ends before the parent reads it
        queue.put((rank, (loss, [g.numpy() for g in grads], launches)))
    except Exception:
        queue.put((rank, traceback.format_exc()))
    finally:
        distributed.shutdown()


def test_tp_train_step_on_the_card_matches_one_process(dev):
    """Two ranks on cuda:0 joined by gloo (mesh 1 × 2): each rank's loss and
    every reduced adapter gradient within TRAIN_TOL (relative, rel-L2) of
    the one-process step's, the same on both ranks, K7 4 / K8 2 / K9 2 a
    rank."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    from chip_smoke import TRAIN_TOL

    kernels.library()  # built once here, loaded by the ranks
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    fd, init_file = tempfile.mkstemp(prefix="qie_world_")
    os.close(fd)
    os.unlink(init_file)
    procs = [ctx.Process(target=_tp_train_rank, args=(r, init_file, queue)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict(queue.get(timeout=600) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    errors = [v for v in got.values() if isinstance(v, str)]
    assert not errors, "\n".join(errors)
    want_loss, want, _ = _tp_train_step(None, dev)
    for rank in (0, 1):
        loss, grads, launches = got[rank]
        assert launches == {"flash_fwd_lse": 4, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
        assert abs(loss - want_loss) <= TRAIN_TOL * abs(want_loss)
        for a, w in zip(grads, want):
            a = torch.from_numpy(a)
            if w.norm() == 0:
                assert a.norm() == 0
            else:
                assert ((a - w).norm() / w.norm()).item() <= TRAIN_TOL
        for a, b in zip(grads, got[0][1]):
            assert np.array_equal(a, b)
