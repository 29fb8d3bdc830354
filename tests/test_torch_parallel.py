"""The port's sharding rules and mesh layout against the JAX package's, in one
process (the spawned worlds are in ``test_torch_parallel_world.py``).

- Which leaf splits on which dim over which axes: the port's specs on its
  (out, in) trees, bridged with ``from_jax``, against the JAX
  ``transformer_param_specs`` / ``vl_param_specs`` on the (in, out) trees
  (``tests/test_sharding.py``), dense, int8 and int4, on three meshes.
- The fallback ladder (``fit_axes`` = the JAX ``_fit_axes``), the
  head-level VL rule, a fused q/k/v leaf split per third.
- The mesh layout (rank = c · model + m) against the JAX ``make_mesh`` grid;
  ``initialize`` off torchrun is a no-op; a mesh that does not match the
  world, a config that does not match the mesh, or heads that the model axis
  does not divide raise.
- The row-parallel int8 linear, its ranks emulated in one process: the
  codes and the output equal the one-device ones bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from qwen_image_edit_streamdiffusion_tpu.core import meshes as jmeshes
from qwen_image_edit_streamdiffusion_tpu.core.config import get_preset
from qwen_image_edit_streamdiffusion_tpu.models import qwen_vl as jvl
from qwen_image_edit_streamdiffusion_tpu.models import transformer as jtfm
from qwen_image_edit_streamdiffusion_tpu.models.quantize import (
    quantize_transformer as jquantize_transformer,
)
from qwen_image_edit_streamdiffusion_tpu.models.quantize import quantize_vl as jquantize_vl
from qwen_image_edit_streamdiffusion_tpu.parallel import sharding as jsharding
from qwen_image_edit_streamdiffusion_tpu_torch.core import meshes
from qwen_image_edit_streamdiffusion_tpu_torch.core.config import StreamConfig
from qwen_image_edit_streamdiffusion_tpu_torch.core.meshes import Group, Mesh
from qwen_image_edit_streamdiffusion_tpu_torch.models import quantize
from qwen_image_edit_streamdiffusion_tpu_torch.models.common import flatten
from qwen_image_edit_streamdiffusion_tpu_torch.models.convert import from_jax
from qwen_image_edit_streamdiffusion_tpu_torch.models.optimize import fuse_qkv
from qwen_image_edit_streamdiffusion_tpu_torch.ops import int8 as int8_ops
from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed, sharding
from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import edit_pipeline as tep

TINY = get_preset("tiny")
FLAGSHIP = get_preset("qwen-image-edit-2509")
MESHES = [(1, 2), (2, 2), (2, 4)]


def fake_mesh(cfg: int, model: int, rank: int = 0) -> Mesh:
    """A rank's view of a cfg × model mesh without process groups (enough
    for the slicing rules, which read sizes and coordinates only)."""
    c, m = divmod(rank, model)
    return Mesh(cfg, model, c, m, Group(None, model, m), Group(None, cfg, c),
                Group(None, cfg * model, rank))


def _numpy_tree(init_fn, cfg, seed=0):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: init_fn(jax.random.PRNGKey(0), cfg))

    def fill(path, leaf):
        if len(leaf.shape) == 1:
            return rng.uniform(0.9, 1.1, leaf.shape).astype(np.float32)
        return rng.uniform(-1, 1, leaf.shape).astype(np.float32) * leaf.shape[0] ** -0.5

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _trees(model: str, bits: int):
    """(JAX tree, port tree) of the tiny model, quantized by the JAX package
    when ``bits``."""
    cfg = dataclasses.replace(TINY.model if model == "transformer" else TINY.vl,
                              dtype="float32")
    jtree = _numpy_tree(jtfm.init if model == "transformer" else jvl._init_all, cfg)
    if bits:
        quant = jquantize_transformer if model == "transformer" else jquantize_vl
        jtree = jax.tree_util.tree_map(np.asarray, quant(jtree, bits=bits))
    return jtree, from_jax(jtree, cfg)


_JAX_NAMES = {"weight": "w", "bias": "b"}


def _jax_path(path):
    return tuple(path[:-1]) + (_JAX_NAMES.get(path[-1], path[-1]),)


def _jax_flat_specs(specs):
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        keys = tuple(str(getattr(p, "key", getattr(p, "idx", None))) for p in path)
        out[keys] = spec
    return out


def _flat_specs(tree, prefix=()):
    """{path: spec} of a port spec tree (its specs are tuples: leaves here)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat_specs(v, prefix + (str(k),)))
    return out


def _as_port(jspec, ndim: int, leaf: str):
    """A JAX PartitionSpec on the (in, out) layout → the port's (dim, axes)
    on its (out, in) layout (the embed table keeps its layout)."""
    parts = [p for p in tuple(jspec) + (None,) * (ndim - len(tuple(jspec)))]
    split = [(i, p) for i, p in enumerate(parts) if p is not None]
    if not split:
        return None
    (dim, axes), = split
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if ndim == 2 and leaf != "embed":
        dim = 1 - dim
    return dim, axes


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("model", ["transformer", "vl"])
def test_specs_match_jax(model, bits, mesh_shape):
    jtree, tree = _trees(model, bits)
    sizes = {"cfg": mesh_shape[0], "model": mesh_shape[1]}
    axes = tuple(a for a in ("cfg", "model") if sizes[a] > 1)
    if model == "transformer":
        jspecs = jsharding.transformer_param_specs(jtree, axis_sizes=sizes)
        specs = sharding.transformer_param_specs(tree, sizes)
    else:
        jspecs = jsharding.vl_param_specs(jtree, axes, axis_sizes=sizes)
        specs = sharding.vl_param_specs(tree, axes, sizes)
    want = _jax_flat_specs(jspecs)
    got = _flat_specs(specs)
    leaves = flatten(tree)
    assert len(got) == len(want) == len(leaves)
    sharded = 0
    for path, spec in got.items():
        jspec = want[_jax_path(path)]
        assert spec == _as_port(jspec, leaves[".".join(path)].dim(), path[-1]), path
        sharded += spec is not None
    assert sharded > 0


def test_transformer_spec_structure():
    """tests/test_sharding.py::test_param_specs_structure, on the port's
    layout: column-parallel split dim 0 (out), row-parallel dim 1 (in), the
    row bias whole, the top level whole."""
    _, tree = _trees("transformer", 0)
    specs = sharding.transformer_param_specs(tree)
    blk = specs["blocks"][0]
    assert blk["attn"]["img_q"]["weight"] == (0, ("model",))
    assert blk["attn"]["img_q"]["bias"] == (0, ("model",))
    assert blk["attn"]["img_out"]["weight"] == (1, ("model",))
    assert blk["attn"]["img_out"]["bias"] is None
    assert blk["img_mlp"]["fc1"]["weight"] == (0, ("model",))
    assert blk["img_mlp"]["fc2"]["weight"] == (1, ("model",))
    assert blk["img_mod"]["weight"] == (0, ("model",))
    assert blk["attn"]["img_norm_q"]["scale"] is None
    assert specs["img_in"]["weight"] is None
    assert specs["proj_out"]["weight"] is None
    assert specs["time_mlp"]["fc1"]["weight"] is None


def test_int4_row_scale_replicates_where_groups_do_not_divide():
    """tiny's 64-wide img_out has one int4 group a row: its scale4 stays
    whole while its codes split (the JAX guard), and the 256-wide fc2's
    four groups split with the codes."""
    _, tree = _trees("transformer", 4)
    sizes = {"cfg": 1, "model": 2}
    specs = sharding.transformer_param_specs(tree, sizes)["blocks"][0]
    assert specs["attn"]["img_out"]["w_q4"] == (1, ("model",))
    assert specs["attn"]["img_out"]["scale4"] is None
    assert specs["img_mlp"]["fc2"]["scale4"] == (1, ("model",))


@pytest.mark.parametrize("dim", [3584, 3420, 18944, 1280, 6, 7, 24, None])
@pytest.mark.parametrize("sizes", [{"cfg": 2, "model": 4}, {"cfg": 2, "model": 2},
                                   {"cfg": 1, "model": 2}, None])
def test_fit_axes_ladder_matches_jax(dim, sizes):
    want = jsharding._fit_axes(("cfg", "model"), dim, sizes)
    assert sharding.fit_axes(("cfg", "model"), dim, sizes) == want


def test_fit_axes_ladder_cases():
    """tests/test_sharding.py::test_vl_fit_axes_fallback_ladder."""
    sizes = {"cfg": 2, "model": 4}
    assert sharding.fit_axes(("cfg", "model"), 3584, sizes) == ("cfg", "model")
    assert sharding.fit_axes(("cfg", "model"), 3420, sizes) == ("model",)
    assert sharding.fit_axes(("cfg", "model"), 6, sizes) is None
    assert sharding.fit_axes(("cfg", "model"), None, sizes) == ("cfg", "model")


@pytest.mark.parametrize("preset,mesh_shape,want", [
    (FLAGSHIP, (1, 2), ("model",)),
    (FLAGSHIP, (2, 2), ("cfg", "model")),
    (FLAGSHIP, (1, 4), ("model",)),
    (FLAGSHIP, (2, 4), ("model",)),     # 28 q heads do not divide 8
    (TINY, (1, 2), ("model",)),
    (TINY, (2, 2), ("model",)),         # 2 kv heads do not divide 4
    (TINY, (1, 4), ()),                 # nor do they divide 4 alone
    (TINY, (2, 1), ("cfg",)),         # every axis of extent > 1
])
def test_vl_axes_head_rule(preset, mesh_shape, want):
    assert sharding.vl_axes(fake_mesh(*mesh_shape), preset.vl) == want


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("rank", [0, 1])
def test_fused_qkv_splits_per_third(bits, rank):
    """Slicing a fused q/k/v leaf gives this rank the q, k and v of its own
    heads: the fusion of its slices of q, k and v (a plain dim-0 split would
    give rank 0 all of q)."""
    _, tree = _trees("transformer", 0)
    mesh = fake_mesh(1, 2, rank)
    spec = lambda p, s: sharding.transformer_leaf_spec(p, s, mesh.shape)  # noqa: E731
    unfused = {k: {n: t.clone() for n, t in v.items()}
               for k, v in tree["blocks"][0]["attn"].items() if k in ("img_q", "img_k", "img_v")}
    fused = fuse_qkv({"blocks": [{"attn": {k: dict(v) for k, v in tree["blocks"][0]["attn"].items()}}]})
    if bits:
        quantize.quantize_transformer(fused, bits=bits)
        quantize.quantize_transformer({"blocks": [unfused]}, bits=bits)
    sharding.shard_leaves(fused, mesh, spec)
    sharding.shard_leaves({"blocks": [{"attn": unfused}]}, mesh, spec)
    got = fused["blocks"][0]["attn"]["img_qkv"]
    for name in got:
        want = torch.cat([unfused[k][name] for k in ("img_q", "img_k", "img_v")])
        torch.testing.assert_close(got[name], want, rtol=0, atol=0)
    key = "weight" if not bits else ("w_q" if bits == 8 else "w_q4")
    assert got[key].shape[0] == 3 * TINY.model.inner_dim // 2


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("rank", [0, 1])
def test_row_parallel_int8_slice_is_padded_once_to_16(parts, rank):
    """The vision ``down`` (3420 wide) over 2 or 4 ranks: its int8 ``w_q``
    slice gets zero columns up to a multiple of 16 when it is sliced, its
    ``scale`` stays whole, and a dense slice keeps its width."""
    mesh = fake_mesh(1, parts, rank)
    rng = np.random.default_rng(parts)
    w = torch.from_numpy(rng.standard_normal((8, 3420)).astype(np.float32))
    w_q, scale = int8_ops.quantize_weight(w)
    tree = {"vision": {"blocks": [{"mlp": {"down": {"w_q": w_q, "scale": scale}},
                                   "mlp2": {"down": {"weight": w.clone()}}}]}}
    spec = lambda p, s: sharding.vl_leaf_spec(p, ("model",), s, mesh.shape)  # noqa: E731
    sharding.shard_leaves(tree, mesh, spec)
    blk = tree["vision"]["blocks"][0]
    n = 3420 // parts
    got = blk["mlp"]["down"]["w_q"]
    assert got.shape == (8, -(-n // 16) * 16)
    assert torch.equal(got[:, :n], w_q[:, rank * n:(rank + 1) * n])
    assert not got[:, n:].any()
    assert torch.equal(blk["mlp"]["down"]["scale"], scale)
    assert blk["mlp2"]["down"]["weight"].shape == (8, n)


def test_slice_part_is_a_contiguous_range_along_dim0():
    t = torch.arange(24.0).reshape(6, 4)
    part = sharding.slice_part(t, (0, ("model",)), fake_mesh(1, 2, 1))
    assert part.is_contiguous() and part.data_ptr() == t[3:].data_ptr()
    torch.testing.assert_close(
        sharding.slice_part(t, (1, ("model",)), fake_mesh(1, 2, 1)), t[:, 2:])
    t = torch.arange(32.0).reshape(8, 4)
    torch.testing.assert_close(
        sharding.slice_part(t, (0, ("cfg", "model")), fake_mesh(2, 2, 2)), t[4:6])
    torch.testing.assert_close(
        sharding.slice_part(t, (0, ("cfg",)), fake_mesh(2, 2, 3)), t[4:])


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2), (2, 4), (4, 2), (8, 1)])
def test_layout_matches_jax_make_mesh(mesh_shape):
    """rank = c · model + m: the model groups are the rows of the JAX grid
    (device ids on the 8-device CPU platform), the cfg groups its columns."""
    cfg, model = mesh_shape
    grid = np.vectorize(lambda d: d.id)(np.asarray(
        jmeshes.make_mesh(cfg, model, devices=jax.devices()[:cfg * model]).devices))
    model_groups, cfg_groups = meshes.layout(cfg, model)
    assert model_groups == grid.tolist()
    assert cfg_groups == grid.T.tolist()
    for rank in range(cfg * model):
        m = fake_mesh(cfg, model, rank)
        assert grid[m.c, m.m] == rank


def test_initialize_is_a_noop_off_torchrun(monkeypatch):
    """tests/test_distributed.py::test_initialize_noop_single_host."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    world = distributed.initialize(device="cpu")
    assert world == distributed.World(0, 1, 0, torch.device("cpu"))
    assert not torch.distributed.is_initialized()
    mesh = distributed.global_mesh()
    assert (mesh.cfg, mesh.model, mesh.size) == (1, 1, 1)
    assert mesh.axis_names == ("cfg", "model")


@pytest.mark.parametrize("cfg,model", [(2, None), (1, 2), (2, 2), (3, 1)])
def test_mesh_that_does_not_match_the_world_raises(cfg, model):
    with pytest.raises(ValueError, match="ranks"):
        meshes.make_mesh(cfg, model)


def _config(cfg=1, model=1, **kw):
    return StreamConfig(width=64, height=64, vae_image_area=64 * 64,
                        vl_image_area=56 * 56, num_inference_steps=1,
                        model_preset="tiny", mesh_cfg_axis=cfg,
                        mesh_model_axis=model, **kw)


def test_heads_the_model_axis_does_not_divide_raise():
    with pytest.raises(ValueError, match="does not divide"):
        sharding.check_heads(TINY.model.num_heads, fake_mesh(1, 4))
    with pytest.raises(ValueError, match="does not divide the MMDiT's 2 heads"):
        tep.EditPipeline.create("tiny", _config(1, 4), device="cpu",
                                mesh=fake_mesh(1, 4))
    sharding.check_heads(FLAGSHIP.model.num_heads, fake_mesh(2, 4))


@pytest.mark.parametrize("cfg_axes,mesh_shape", [((2, 1), None), ((1, 1), (1, 2)),
                                                 ((1, 2), (2, 1))])
def test_config_that_does_not_match_the_mesh_raises(cfg_axes, mesh_shape):
    mesh = fake_mesh(*mesh_shape) if mesh_shape else None
    with pytest.raises(ValueError, match="mesh"):
        tep.check_config(_config(*cfg_axes), mesh)
    tep.check_config(_config(*(mesh_shape or (1, 1))), mesh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,parts", [(64, 2), (40, 4), (20, 2), (3420, 2), (3420, 4)])
def test_row_parallel_int8_equals_one_device(k, parts, dtype):
    """The ranks of a row-parallel int8 linear emulated in one process, with
    the plain K5/K6 entries the wrapper takes on the CPU: the shared row
    scale (the MAX of the slices' own row scales), the codes of each slice
    (zero columns up to K % 16 == 0, as the sharded weight holds them), the
    sum of the int32 partials and the epilogue equal the whole row's codes
    and output bit for bit. A local absmax alone gives other codes."""
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.standard_normal((7, k)).astype(np.float32)).to(dtype)
    x[3, 5] = 40.0  # one row's absmax sits on one slice
    w = torch.from_numpy(rng.standard_normal((24, k)).astype(np.float32))
    w_q, w_s = int8_ops.quantize_weight(w)
    bias = torch.from_numpy(rng.standard_normal(24).astype(np.float32)).to(dtype)
    x_q, x_s = int8_ops.quantize_rows(x)
    want = int8_ops.int8_matmul(x_q, x_s, w_q, w_s, bias, out_dtype=dtype)
    n = k // parts
    xs = [x[:, r * n:(r + 1) * n] for r in range(parts)]
    scale = torch.stack([int8_ops.row_scales(p.contiguous()) for p in xs]).amax(0)
    torch.testing.assert_close(scale, x_s, rtol=0, atol=0)
    acc = torch.zeros((7, 24), dtype=torch.int32)
    codes = []
    pad = -n % 16
    for r, p in enumerate(xs):
        q = int8_ops.quantize_rows_given(torch.nn.functional.pad(p, (0, pad)), scale)
        codes.append(q[:, :n])
        wr = sharding.pad_codes(w_q[:, r * n:(r + 1) * n])
        acc += int8_ops.int8_matmul_acc(q, wr)
    torch.testing.assert_close(torch.cat(codes, 1), x_q, rtol=0, atol=0)
    got = int8_ops.int8_epilogue(acc, scale, w_s, bias, dtype)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    local = int8_ops.quantize_rows(xs[0].contiguous())[0]
    assert not torch.equal(local, x_q[:, :n])


def test_tp_int8_mixes_hold_every_linear_of_a_tp2_miss():
    """``chip_smoke.py``'s row- and column-parallel int8 mixes hold as many
    launches as a TP-2 int8 miss makes a rank (2038 linears: 14 a block a
    forward, q/k/v unfused, and the VL's), and the row mix's counts are the
    row-parallel int8 leaves of the flagship's sharded trees: 4 a block a
    forward (:data:`ROW_REQUEST`), 2 an LM layer, 2 a vision block and the
    merger's ``fc2`` (:data:`ROW_MISS`)."""
    from chip_smoke import (
        INT8_LM,
        INT8_VISION,
        MMDIT_LAYERS,
        ROW_MISS,
        ROW_MIX,
        ROW_REQUEST,
        STEPS,
        TP_COL_MIX,
    )
    from qwen_image_edit_streamdiffusion_tpu_torch.core.config import get_preset as port_preset
    from qwen_image_edit_streamdiffusion_tpu_torch.models import checkpoint as ckpt

    total = sum(n for *_, n in ROW_MIX) + sum(n for *_, n in TP_COL_MIX)
    assert total == 14 * MMDIT_LAYERS * STEPS + INT8_LM + INT8_VISION == 2038
    preset, mesh = port_preset("qwen-image-edit-2509"), fake_mesh(1, 2)
    sizes, axes = mesh.shape, sharding.vl_axes(mesh, preset.vl)

    def rows(tree, spec):
        return sum(1 for key, t in flatten(tree).items() if key.endswith(".w_q")
                   and (spec(tuple(key.split(".")), tuple(t.shape)) or (None,))[0] == 1)

    tfm_rows = rows(ckpt.skeleton("transformer", preset, 8, False),
                    lambda p, s: sharding.transformer_leaf_spec(p, s, sizes))
    vl_rows = rows(ckpt.skeleton("vl", preset, 8, False),
                   lambda p, s: sharding.vl_leaf_spec(p, axes, s, sizes))
    assert tfm_rows * STEPS == ROW_REQUEST == 480
    assert vl_rows == ROW_MISS == 121
