"""The port's int8 / int4 linears and quantizers against the JAX package.

Inputs are made with numpy and handed to both. The JAX Pallas kernels run in
interpret mode, as ``tests/test_int8.py`` runs them, at small shapes. Codes and
scales must be equal. A GEMM output may differ by one ulp of bf16, or in f32
by the rounding of one product: XLA's CPU backend contracts the epilogue's
"· w_scale + bias" into an FMA, the port never does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import INT8_LM, INT8_MIX, INT8_MMDIT, INT8_STREAM_MIX, INT8_VISION
from qwen_image_edit_streamdiffusion_tpu.core.config import get_preset
from qwen_image_edit_streamdiffusion_tpu.models import common as jcommon
from qwen_image_edit_streamdiffusion_tpu.models import qwen_vl as jvl
from qwen_image_edit_streamdiffusion_tpu.models import quantize as jquant
from qwen_image_edit_streamdiffusion_tpu.models import transformer as jtfm
from qwen_image_edit_streamdiffusion_tpu.ops import int8 as jint8
from qwen_image_edit_streamdiffusion_tpu_torch.models import common
from qwen_image_edit_streamdiffusion_tpu_torch.models import quantize
from qwen_image_edit_streamdiffusion_tpu_torch.models.convert import from_jax
from qwen_image_edit_streamdiffusion_tpu_torch.ops import int8
from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

torch.set_num_threads(2)

TINY = get_preset("tiny")
M32 = dataclasses.replace(TINY.model, dtype="float32")
# vision width 64 (int4 under bits=4) and MLP in-dim 40: not a multiple of
# the int4 group, so the `down` leaves take the int8 rung (the flagship's 3420)
VL_ODD = dataclasses.replace(TINY.vl, dtype="float32", vision_hidden=64,
                             vision_intermediate=40)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _arr(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _max_ulp(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest distance in units in the last place between two float
    tensors of one dtype (bf16 or f32)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    bits, view = (15, torch.int16) if got.dtype == torch.bfloat16 else (31, torch.int32)

    def ordered(t):
        i = t.contiguous().view(view).long()
        return torch.where(i < 0, -(i & ((1 << bits) - 1)), i)

    return int((ordered(got) - ordered(want)).abs().max())


def _jax_to_torch(x, dtype):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(dtype)


# ---------------------------------------------------------------------------
# Quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("kin,out", [(64, 48), (40, 7), (256, 256)])
def test_quantize_weight_matches_jax(dt, kin, out):
    jdt, tdt = DTYPES[dt]
    w = _arr((kin, out), 0, 0.05)
    w[:, 0] = 0.0  # an all-zero channel takes the 1e-8 floor
    jq = jint8.quantize_weight(jnp.asarray(w, jdt))
    w_q, scale = int8.quantize_weight(_jax_to_torch(jnp.asarray(w, jdt), tdt).t())
    assert w_q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(jq.w_q).T)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jq.scale))


@pytest.mark.parametrize("m,k", [(1, 64), (17, 40), (256, 256), (8, 12)])
def test_quantize_rows_plain_matches_pallas(m, k):
    x = _arr((m, k), 1)
    x[0, :] = 0.0  # a zero row
    jq, js = jint8.quantize_rows_pallas(jnp.asarray(x), interpret=True)
    before = dict(kernels.LAUNCHES)
    q, s = int8.quantize_rows(_t(x))  # CPU: the plain version, no launch
    assert kernels.LAUNCHES == before
    assert q.dtype == torch.int8 and tuple(s.shape) == (m, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    q2, s2 = int8.quantize_rows_plain(_t(x))
    torch.testing.assert_close(q2, q, rtol=0, atol=0)
    torch.testing.assert_close(s2, s, rtol=0, atol=0)


def test_quantize_rows_rounds_half_to_even():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]])
    q, s = int8.quantize_rows_plain(x)
    assert s.item() == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2]]


# ---------------------------------------------------------------------------
# The int8 GEMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(1, 64, 48), (5, 40, 24), (33, 200, 72)])
def test_int8_matmul_plain_matches_xla_with_bias(dt, m, k, n):
    jdt, tdt = DTYPES[dt]
    x = jnp.asarray(_arr((m, k), 2), jdt)
    w = jnp.asarray(_arr((k, n), 3, 0.05), jdt)
    b = jnp.asarray(_arr((n,), 4, 0.1), jdt)
    jq = jint8.quantize_weight(w)
    # jitted, as the JAX package runs it (see ops/int8.py of the port)
    want = jax.jit(jint8.int8_matmul_xla)(x, jint8.QuantizedLinear(jq.w_q, jq.scale, b))
    xq, xs = int8.quantize_rows_plain(_jax_to_torch(x, tdt))
    got = int8.int8_matmul_plain(xq, xs, torch.from_numpy(np.asarray(jq.w_q).T.copy()),
                                 torch.from_numpy(np.asarray(jq.scale)),
                                 _jax_to_torch(b, tdt), out_dtype=tdt)
    assert got.dtype == tdt
    want = _jax_to_torch(want, tdt)
    if tdt == torch.bfloat16:
        assert _max_ulp(got, want) <= 1
    else:  # XLA's CPU backend contracts "· w_scale + b" into one FMA
        prod = (got - _jax_to_torch(b, tdt)).abs()
        assert ((got - want).abs() <= 2.0 ** -23 * (prod + want.abs())).all()


@pytest.mark.parametrize("m,k,n", [(1, 64, 128), (7, 40, 24), (64, 256, 200)])
def test_int8_matmul_plain_matches_pallas_v2(m, k, n):
    """The Pallas GEMM takes no bias (int8_linear_v2 adds it after its
    cast), so it is compared without one."""
    x = jnp.asarray(_arr((m, k), 5), jnp.bfloat16)
    w = jnp.asarray(_arr((k, n), 6, 0.05), jnp.bfloat16)
    jq = jint8.quantize_weight(w)
    jxq, jxs = jint8.quantize_rows_pallas(x, interpret=True)
    want = jint8.int8_matmul_pallas_v2(jxq, jxs, jq.w_q, jq.scale, interpret=True,
                                       out_dtype=jnp.bfloat16)
    before = dict(kernels.LAUNCHES)
    got = int8.int8_matmul(torch.from_numpy(np.asarray(jxq)),
                           torch.from_numpy(np.asarray(jxs)),
                           torch.from_numpy(np.asarray(jq.w_q).T.copy()),
                           torch.from_numpy(np.asarray(jq.scale)))
    assert kernels.LAUNCHES == before
    assert _max_ulp(got, _jax_to_torch(want, torch.bfloat16)) <= 1


def test_int8_matmul_plain_is_exact_integer_product():
    """The float64 product of the codes equals the int64 one."""
    rng = np.random.default_rng(7)
    xq = torch.from_numpy(rng.integers(-127, 128, (3, 4096), np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (5, 4096), np.int8))
    ones = torch.ones(3, 1), torch.ones(5)
    got = int8.int8_matmul_plain(xq, ones[0], wq, ones[1], out_dtype=torch.float32)
    want = (xq.long() @ wq.long().t()).float()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K6's plan: which body runs and how a tile's K is split
# ---------------------------------------------------------------------------

# every int8 linear of a one-image flagship miss (chip_smoke.INT8_MIX) and of
# a 512² stream keyframe with its precompute (INT8_STREAM_MIX), and the
# shapes of the K6 card tests (tests/test_torch_cuda.py: M × (K, N), the
# full lm_down, saturated codes at K = 18944)
PATH_SHAPES = [(m, k, n) for _, m, k, n, _ in INT8_MIX + INT8_STREAM_MIX]
CARD_M = (1, 16, 17, 200, 384, 784)
CARD_KN = ((1040, 199), (1040, 264), (3072, 3420), (3420, 199))
CARD_SHAPES = ([(m, k, n) for m in CARD_M for k, n in CARD_KN]
               + [(384, 18944, 3584), (384, 18944, 512), (256, 3072, 3072)])


@pytest.mark.parametrize("m,k,n", sorted(set(PATH_SHAPES + CARD_SHAPES)))
def test_gemm_plan_covers_k_exactly(m, k, n):
    plan = int8.gemm_plan(m, n, k)
    assert plan.route == ("mma_sync" if k % 16 else "wgmma")
    slabs = -(-k // plan.slab)
    assert (slabs - 1) * plan.slab < k <= slabs * plan.slab
    # the byte ranges of K that the splits of a tile cover (the kernel's
    # kb0 = split · kb_per_split, kb1 = min(kb0 + kb_per_split, slabs))
    ranges = [(sp * plan.kb_per_split * plan.slab,
               min((sp + 1) * plan.kb_per_split, slabs) * plan.slab)
              for sp in range(plan.splits)]
    assert len(ranges) == plan.splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == slabs * plan.slab
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0  # contiguous, no overlap
    assert all(a1 > a0 for a0, a1 in ranges)  # no empty range
    tiles = -(-m // plan.block_m) * -(-n // plan.block_n)
    assert plan.tiles == tiles and 1 <= plan.grid <= min(plan.units, 132)
    if plan.route == "mma_sync":
        assert plan.splits == 1 and plan.grid == tiles
    else:
        assert (plan.block_m, plan.block_n, plan.slab) == (128, 256, 128)
        assert 1 <= plan.splits <= int8.MAX_SPLITS


def test_int8_mix_holds_every_linear_of_a_miss():
    """chip_smoke.INT8_MIX, which the plan tests above and the card's K6 mix
    walk, holds as many launches as an int8 miss makes (1558)."""
    assert sum(n for *_, n in INT8_MIX) == INT8_MMDIT + INT8_LM + INT8_VISION == 1558


def test_int8_stream_mix_holds_every_linear_of_a_stream_keyframe():
    """chip_smoke.INT8_STREAM_MIX holds as many launches as a 512² int8
    stream keyframe (two MMDiT forwards) and its precompute (the LM once)
    make (1396), at the stream's rows: 2048 image, 64 text, 128 LM."""
    assert sum(n for *_, n in INT8_STREAM_MIX) == INT8_MMDIT + INT8_LM == 1396
    assert {m for _, m, *_ in INT8_STREAM_MIX} == {2048, 64, 1, 128}


@pytest.mark.parametrize("m,k,n", [(8192, 3072, 9216), (8192, 3072, 3072),
                                   (8192, 3072, 12288), (8192, 12288, 3072)])
def test_gemm_plan_keeps_full_waves_whole(m, k, n):
    """The image stream's tiles fill every SM many times over: no split, a
    persistent CTA a SM."""
    plan = int8.gemm_plan(m, n, k)
    assert plan.splits == 1 and plan.grid == 132 and plan.units > 5 * 132


@pytest.mark.parametrize("m,k,n", [(384, 18944, 3584), (256, 12288, 3072),
                                   (384, 3584, 512)])
def test_gemm_plan_splits_tiles_that_leave_sms_idle(m, k, n):
    """lm_down (42 tiles), txt_fc2 (24) and the LM's k/v (6): K is split
    until the units cover most of the SMs or the reads of the partials cost
    more than they save."""
    plan = int8.gemm_plan(m, n, k)
    assert plan.tiles < 132 and plan.splits > 1
    assert plan.units <= 2 * 132


def test_gemm_plan_takes_the_card_sm_count():
    assert int8.gemm_plan(8192, 9216, 3072, sms=66).grid == 66
    assert int8.gemm_plan(384, 3584, 18944, sms=264).grid <= 264


# ---------------------------------------------------------------------------
# int4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_int4_quantize_dequantize_match_jax(dt):
    jdt, tdt = DTYPES[dt]
    w = jnp.asarray(_arr((192, 40), 8, 0.05), jdt)
    jp = jint8.quantize_weight_int4(w)
    p = int8.quantize_weight_int4(_jax_to_torch(w, tdt).t())
    assert p["w_q4"].dtype == torch.uint8 and tuple(p["w_q4"].shape) == (40, 96)
    np.testing.assert_array_equal(p["w_q4"].numpy(), np.asarray(jp["w_q4"]).T)
    np.testing.assert_array_equal(p["scale4"].numpy(), np.asarray(jp["scale4"]).T)
    want = jint8.dequantize_int4(jp["w_q4"], jp["scale4"], dtype=jdt)
    got = int8.dequantize_int4(p["w_q4"], p["scale4"], tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jnp.asarray(want, jnp.float32)).T)


def test_int4_linear_matches_jax():
    """f32: the same dequantized weight, summed in another order → 1e-5."""
    w = jnp.asarray(_arr((128, 24), 9, 0.05))
    b = jnp.asarray(_arr((24,), 10, 0.1))
    x = _arr((3, 5, 128), 11)
    jp = dict(jint8.quantize_weight_int4(w), b=b)
    want = jint8.int4_linear(jnp.asarray(x), jp)
    p = {"w_q4": torch.from_numpy(np.asarray(jp["w_q4"]).T.copy()),
         "scale4": torch.from_numpy(np.asarray(jp["scale4"]).T.copy()),
         "bias": _t(b)}
    got = int8.int4_linear(_t(x), p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_int4_rejects_ragged_groups():
    with pytest.raises(ValueError, match="group"):
        int8.quantize_weight_int4(torch.zeros(8, 100))


# ---------------------------------------------------------------------------
# common.linear dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_common_linear_dispatches_on_leaf_keys(bits):
    """Each leaf kind against the JAX common.linear on the same leaf."""
    jp = jcommon.linear_init(jax.random.PRNGKey(0), 128, 48, jnp.float32)
    if bits:
        jp = jquant._quantize_leaf_dict(jp, bits)
    x = _arr((2, 3, 128), 12)
    want = np.asarray(jcommon.linear(jp, jnp.asarray(x)))
    p = {}
    for k, v in jp.items():
        a = np.asarray(v)
        if k in ("w", "w_q", "w_q4", "scale4"):
            a = a.T.copy()
        p[{"w": "weight", "b": "bias"}.get(k, k)] = torch.from_numpy(a)
    got = common.linear(p, _t(x))
    if bits == 4:  # same dequantized weight, another sum order
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    elif bits == 8:  # see the module docstring
        assert _max_ulp(got, _t(want)) <= 1
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Tree quantization and the bridge
# ---------------------------------------------------------------------------


def _numpy_tree(init_fn, cfg, seed=0):
    """A tree shaped like ``init_fn(key, cfg)``, filled from numpy."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: init_fn(jax.random.PRNGKey(0), cfg))

    def fill(leaf):
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 1
        return (rng.uniform(-1, 1, leaf.shape) * fan_in ** -0.5).astype(np.float32)

    return jax.tree_util.tree_map(fill, shapes)


_PORT_KEY = {"w_q": "w_q", "scale": "scale", "w_q4": "w_q4", "scale4": "scale4",
             "b": "bias", "w": "weight"}

MODELS = {"transformer": (jtfm.init, M32, jquant.quantize_transformer,
                          quantize.quantize_transformer),
          "vl": (jvl._init_all, VL_ODD, jquant.quantize_vl, quantize.quantize_vl)}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("model", ["transformer", "vl"])
def test_quantize_tree_matches_jax(model, bits):
    """The same leaves take the same rung with the same codes and scales,
    the int4 → int8 case for a ragged in-dim included; the port's tree is
    quantized in place and keeps no dense weight in a quantized leaf."""
    init_fn, cfg, jfn, fn = MODELS[model]
    jtree = _numpy_tree(init_fn, cfg)
    want = common.flatten(jfn(jax.tree_util.tree_map(jnp.asarray, jtree), bits=bits))
    params = from_jax(jtree, cfg)
    blocks = params.get("blocks")
    out = fn(params, bits=bits)
    assert out is params and params.get("blocks") is blocks
    got = common.flatten(out)
    port_want = {}
    for path, leaf in want.items():
        *head, key = path.split(".")
        port_want[".".join(head + [_PORT_KEY.get(key, key)])] = leaf
    assert sorted(got) == sorted(port_want)
    quantized = {p.rsplit(".", 1)[0] for p in got if p.endswith((".w_q", ".w_q4"))}
    assert quantized and not {p + ".weight" for p in quantized} & set(got)
    for path in got:
        key = path.rsplit(".", 1)[1]
        if key in ("w_q", "scale", "w_q4", "scale4"):
            a = np.asarray(port_want[path])
            np.testing.assert_array_equal(got[path].numpy(),
                                          a if key == "scale" else a.T, err_msg=path)
    if model == "vl" and bits == 4:
        down = out["vision"]["blocks"][0]["mlp"]["down"]
        assert set(down) == {"w_q", "scale", "bias"}
        assert "w_q4" in out["vision"]["blocks"][0]["mlp"]["up"]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("model", ["transformer", "vl"])
def test_from_jax_takes_quantized_trees(model, bits):
    """A quantized JAX tree converts totally; its leaves keep their types."""
    init_fn, cfg, jfn, _ = MODELS[model]
    jq = jax.tree_util.tree_map(
        np.asarray, jfn(jax.tree_util.tree_map(jnp.asarray, _numpy_tree(init_fn, cfg)),
                        bits=bits))
    params = from_jax(jq, cfg)
    leaves = common.flatten(params)
    kinds = {p.rsplit(".", 1)[1]: t.dtype for p, t in leaves.items()}
    assert kinds.get("w_q" if bits == 8 else "w_q4") == (
        torch.int8 if bits == 8 else torch.uint8)
    assert quantize.saved_bits(params) == bits
    assert quantize.quantized_bytes(params) == sum(
        np.asarray(a).size * np.asarray(a).dtype.itemsize
        for a in jax.tree_util.tree_leaves(jq))


@pytest.mark.parametrize("edit", ["shape", "unused", "missing"])
def test_from_jax_rejects_mismatched_quantized_trees(edit):
    jq = jax.tree_util.tree_map(
        np.asarray, jquant.quantize_transformer(
            jax.tree_util.tree_map(jnp.asarray, _numpy_tree(jtfm.init, M32))))
    leaf = jq["blocks"][0]["attn"]["img_q"]
    if edit == "shape":
        leaf["scale"] = leaf["scale"][:-1]
    elif edit == "unused":
        leaf["extra"] = np.zeros((2,), np.float32)
    else:
        del leaf["scale"]
    with pytest.raises(ValueError, match=edit):
        from_jax(jq, M32)


def test_pipeline_fuses_then_quantizes_as_jax():
    """A dense tree with use_int8: q/k/v fused, then quantized — the same
    codes as the JAX package's quantize_transformer(fuse_qkv(tree))."""
    from qwen_image_edit_streamdiffusion_tpu.core.config import StreamConfig
    from qwen_image_edit_streamdiffusion_tpu.models.optimize import fuse_qkv as jfuse
    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import edit_pipeline as tep

    jtree = _numpy_tree(jtfm.init, M32)
    want = jquant.quantize_transformer(jfuse(jax.tree_util.tree_map(jnp.asarray, jtree)))
    got = tep.prepare_transformer(from_jax(jtree, M32), StreamConfig(use_int8=True))
    for name in ("img_qkv", "txt_qkv", "img_out"):
        leaf, jleaf = got["blocks"][1]["attn"][name], want["blocks"][1]["attn"][name]
        np.testing.assert_array_equal(leaf["w_q"].numpy(), np.asarray(jleaf["w_q"]).T)
        np.testing.assert_array_equal(leaf["scale"].numpy(), np.asarray(jleaf["scale"]))


def test_prequantized_tree_serves_its_saved_rung():
    """As in the JAX package: a tree saved at another rung than the one
    requested warns and is served as saved (not re-fused, not re-quantized)."""
    from qwen_image_edit_streamdiffusion_tpu.core.config import StreamConfig
    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import edit_pipeline as tep

    params = quantize.quantize_transformer(from_jax(_numpy_tree(jtfm.init, M32), M32))
    with pytest.warns(UserWarning, match="pre-quantized int8"):
        out = tep.prepare_transformer(params, StreamConfig(use_int4=True))
    assert out is params and quantize.saved_bits(out) == 8
    assert "w_q" in out["blocks"][0]["attn"]["img_q"]  # kept unfused
    vl = quantize.quantize_vl(from_jax(_numpy_tree(jvl._init_all, VL_ODD), VL_ODD), bits=4)
    with pytest.warns(UserWarning, match="pre-quantized int4"):
        assert tep.prepare_vl(vl, StreamConfig(use_int8_vl=True)) is vl
