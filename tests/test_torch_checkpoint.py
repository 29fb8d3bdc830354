"""The port's checkpoint path (``models/convert.py`` HF key maps and reader,
``models/checkpoint.py`` format and CLI, ``EditPipeline.from_checkpoint``,
the engine) against the JAX package's, at `tiny` on the CPU.

The HF-layout tree is the JAX ``benchmarks/rehearsal.py::
fabricate_hf_checkpoint``'s (sharded transformer and VL with both index
basenames, one VAE file), with its params drawn by numpy from a seed (the
JAX inits' shapes, through ``jax.eval_shape``: XLA's CPU compiles of the
inits take tens of seconds). Each port conversion must equal ``from_jax`` of
the JAX conversion of the same files bit for bit, except the VAE's convs:
the JAX ``_t_conv2d`` reads (in, out, kh, kw), its own export's layout, the
port a torch conv's (out, in, kh, kw), so the port reads the same file with
those two axes swapped.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke

from qwen_image_edit_streamdiffusion_tpu.benchmarks import rehearsal
from qwen_image_edit_streamdiffusion_tpu.core.config import get_preset as jax_preset
from qwen_image_edit_streamdiffusion_tpu.models import convert as jcv
from qwen_image_edit_streamdiffusion_tpu.models import qwen_vl as jqwen_vl
from qwen_image_edit_streamdiffusion_tpu.models import quantize as jquant
from qwen_image_edit_streamdiffusion_tpu.models import transformer as jtfm
from qwen_image_edit_streamdiffusion_tpu.models import vae as jvae
from qwen_image_edit_streamdiffusion_tpu.models.optimize import fuse_qkv as jfuse_qkv
from qwen_image_edit_streamdiffusion_tpu_torch.core import codec, imaging
from qwen_image_edit_streamdiffusion_tpu_torch.core.config import StreamConfig, get_preset
from qwen_image_edit_streamdiffusion_tpu_torch.core.rng import stream
from qwen_image_edit_streamdiffusion_tpu_torch.models import checkpoint as ckpt
from qwen_image_edit_streamdiffusion_tpu_torch.models import convert as cv
from qwen_image_edit_streamdiffusion_tpu_torch.models import lora, qwen_vl
from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm
from qwen_image_edit_streamdiffusion_tpu_torch.models import vae
from qwen_image_edit_streamdiffusion_tpu_torch.models.common import flatten
from qwen_image_edit_streamdiffusion_tpu_torch.models.optimize import fuse_qkv
from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.edit_pipeline import EditPipeline
from qwen_image_edit_streamdiffusion_tpu_torch.runtime.engine import InferenceEngine

torch.set_num_threads(2)

P = get_preset("tiny")
JP = jax_preset("tiny")
TINY = StreamConfig(width=64, height=64, vae_image_area=64 * 64, vl_image_area=32 * 32,
                    num_inference_steps=1, model_preset="tiny")


def _numpy_init(init, seed: int):
    """``init``'s tree shapes and dtypes (``jax.eval_shape``) filled from a
    numpy seed: 1-D leaves (norm scales, biases) 1 ± 0.1, the rest ± 0.05."""
    def fill(key, cfg):
        shapes = jax.eval_shape(lambda k: init(k, cfg), key)
        rng = np.random.default_rng(seed)

        def leaf(s):
            a = (rng.uniform(0.9, 1.1, s.shape) if len(s.shape) == 1
                 else rng.uniform(-0.05, 0.05, s.shape))
            return a.astype(np.float32).astype(s.dtype)
        return jax.tree_util.tree_map(leaf, shapes)
    return fill


def fabricate(dst: str) -> dict:
    """The JAX rehearsal's HF tree at `tiny` (numpy-drawn params), plus
    ``vae_torch``: its VAE file with each conv in torch's (out, in, kh, kw),
    the layout the port reads. The rehearsal's stand-in WordLevel tokenizer
    beside the VL shards is replaced by a full-size Qwen2-layout BPE one
    (``chip_smoke.write_qwen2_tokenizer``), the kind a real checkpoint ships.
    Returns {"transformer", "vae", "vae_torch", "vl": path}."""
    with pytest.MonkeyPatch.context() as mp:
        for i, (mod, name) in enumerate(((jtfm, "init"), (jvae, "init"),
                                         (jqwen_vl, "vision_init"), (jqwen_vl, "lm_init"))):
            mp.setattr(mod, name, _numpy_init(getattr(mod, name), 100 + i))
        dirs = rehearsal.fabricate_hf_checkpoint(dst, "tiny")
    chip_smoke.write_qwen2_tokenizer(dirs["vl"])
    state = dict(cv.load_safetensors(dirs["vae"]))
    dirs["vae_torch"] = os.path.join(dst, "vae_torch.safetensors")
    lora.save_safetensors(dirs["vae_torch"], {
        k: v.transpose(0, 1) if v.dim() == 4 else v for k, v in state.items()})
    return dirs


def jax_converted(kind: str, dirs: dict):
    """``from_jax`` of the JAX converter's tree of the same files."""
    conv, cfg = {"transformer": (jcv.convert_transformer, JP.model),
                 "vae": (jcv.convert_vae, JP.vae), "vl": (jcv.convert_vl, JP.vl)}[kind]
    with pytest.MonkeyPatch.context() as mp:  # the JAX skeletons, drawn fast
        mp.setattr(jvae, "init", _numpy_init(jvae.init, 0))
        mp.setattr(jqwen_vl, "vision_init", _numpy_init(jqwen_vl.vision_init, 0))
        mp.setattr(jqwen_vl, "lm_init", _numpy_init(jqwen_vl.lm_init, 0))
        tree = conv(jcv.load_safetensors(dirs[kind]), cfg)
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def hf(tmp_path_factory):
    return fabricate(str(tmp_path_factory.mktemp("hf")))


@pytest.fixture(scope="module")
def converted(hf, tmp_path_factory):
    """The CLI's deployment variants on the CPU: {name: checkpoint dir}."""
    out = tmp_path_factory.mktemp("port")
    runs = {"transformer": ("transformer", []),
            "transformer_int8_fq": ("transformer", ["--fuse-qkv", "--quantize", "int8"]),
            "transformer_int4": ("transformer", ["--quantize", "int4"]),
            "vae": ("vae_torch", []), "vl": ("vl", [])}
    dirs = {}
    for name, (src, extra) in runs.items():
        dirs[name] = str(out / name)
        ckpt.main(["convert", "--src", hf[src], "--component", name.split("_")[0],
                   "--preset", "tiny", "--out", dirs[name], "--device", "cpu", *extra])
    return dirs


def assert_same(got, want):
    fg, fw = flatten(got), flatten(want)
    assert sorted(fg) == sorted(fw), set(fg) ^ set(fw)
    for k in fg:
        assert fg[k].dtype == fw[k].dtype and torch.equal(fg[k], fw[k]), k


@pytest.mark.parametrize("kind", ["transformer", "vae", "vl"])
def test_conversion_equals_the_jax_package(hf, kind):
    src = hf["vae_torch" if kind == "vae" else kind]
    cfg = {"transformer": P.model, "vae": P.vae, "vl": P.vl}[kind]
    port = getattr(cv, f"convert_{kind}")(cv.load_safetensors(src), cfg)
    assert_same(port, cv.from_jax(jax_converted(kind, hf), cfg))


def test_jax_vae_layout_is_refused_as_misshapen(hf):
    """The JAX export's (in, out, kh, kw) convs: the non-square ones raise
    with their shapes, the whole list of mismatches at once."""
    with pytest.raises(ValueError, match=r"0 missing .* 14 of the wrong shape .*"
                       r"'decoder\.conv_out\.weight', \(3, 3, 3, 8\), \(3, 3, 8, 3\)"):
        cv.convert_vae(cv.load_safetensors(hf["vae"]), P.vae)


def _port_trees():
    return {"transformer": tfm.init(stream(1, "t"), P.model),
            "vae": vae.init(stream(1, "v"), P.vae),
            "vl": qwen_vl.init(stream(1, "l"), P.vl)}


@pytest.mark.parametrize("kind", ["transformer", "vae", "vl"])
def test_export_then_convert_round_trips(kind):
    cfg = {"transformer": P.model, "vae": P.vae, "vl": P.vl}[kind]
    tree = _port_trees()[kind]
    state = getattr(cv, f"export_{kind}")(tree, cfg)
    assert list(state) == list(getattr(cv, f"{kind}_key_map")(cfg))
    # as an iterable of pairs, as the reader yields them
    assert_same(getattr(cv, f"convert_{kind}")(iter(state.items()), cfg), tree)


def test_missing_and_unused_keys_raise_with_both_lists():
    state = cv.export_transformer(_port_trees()["transformer"], P.model)
    state.pop("transformer_blocks.1.attn.to_k.bias")
    state["transformer_blocks.9.attn.to_k.bias"] = torch.zeros(64)
    with pytest.raises(ValueError) as e:
        cv.convert_transformer(state, P.model)
    msg = str(e.value)
    assert "1 missing ['transformer_blocks.1.attn.to_k.bias']" in msg
    assert "1 unused or repeated ['transformer_blocks.9.attn.to_k.bias']" in msg


def test_causal_conv_takes_its_last_temporal_slice_and_norms_flatten():
    tree = _port_trees()["vae"]
    state = cv.export_vae(tree, P.vae)
    w = state["encoder.conv_in.weight"]  # (out, in, kh, kw)
    state["encoder.conv_in.weight"] = torch.stack([torch.full_like(w, 7.0), -w, w], dim=2)
    state["encoder.norm_out.gamma"] = state["encoder.norm_out.gamma"][:, None, None, None]
    state["decoder.norm_out.gamma"] = state["decoder.norm_out.gamma"][:, None, None]
    assert_same(cv.convert_vae(state, P.vae), tree)


def test_normalize_vl_keys_matches_the_jax_package():
    state = {"model.visual.blocks.0.norm1.weight": 1, "model.language_model.norm.weight": 2,
             "language_model.model.layers.0.mlp.up_proj.weight": 3,
             "lm_head.weight": 4, "visual.merger.ln_q.weight": 5,
             "model.embed_tokens.weight": 6}
    got = cv.normalize_vl_keys(state)
    assert got == jcv.normalize_vl_keys(state)
    assert sorted(got) == ["model.embed_tokens.weight", "model.layers.0.mlp.up_proj.weight",
                           "model.norm.weight", "visual.blocks.0.norm1.weight",
                           "visual.merger.ln_q.weight"]


def test_reader_resolves_both_index_names_a_plain_directory_and_bf16(tmp_path):
    gen = torch.Generator().manual_seed(3)
    tensors = {"odd": torch.arange(7, dtype=torch.uint8),  # later data off 2-byte alignment
               "w": torch.randn((5, 3), generator=gen).bfloat16(),
               "h": torch.randn((4,), generator=gen).half(),
               "i": torch.tensor([-3, 4], dtype=torch.int8),
               "f": torch.randn((2, 3, 2), generator=gen),
               "empty": torch.zeros((0, 3))}
    for base in ("diffusion_pytorch_model", "model"):
        d = tmp_path / base
        lora.save_safetensors(str(d), tensors, max_shard_bytes=40, basename=base)
        index = json.loads((d / f"{base}.safetensors.index.json").read_text())
        assert len(set(index["weight_map"].values())) >= 3
        assert len(cv.shard_files(str(d))) == len(set(index["weight_map"].values()))
        got = dict(cv.load_safetensors(str(d)))
        assert sorted(got) == sorted(tensors)
        for k, t in tensors.items():
            assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    (tmp_path / "model" / "model.safetensors.index.json").unlink()
    got = dict(cv.load_safetensors(str(tmp_path / "model")))  # no index: every shard
    assert all(torch.equal(got[k], t) for k, t in tensors.items())
    from safetensors.torch import load_file, save_file

    save_file(tensors, str(tmp_path / "theirs.safetensors"))
    got = dict(cv.load_safetensors(str(tmp_path / "theirs.safetensors")))
    assert all(torch.equal(got[k], t) for k, t in tensors.items())
    mine = load_file(str(tmp_path / "model" / "model-00001-of-00004.safetensors"))
    assert all(torch.equal(mine[k], tensors[k]) for k in mine)


def test_cli_variants_layout_and_the_jax_quantized_trees(hf, converted):
    want = {"transformer": (None, False), "transformer_int8_fq": (8, True),
            "transformer_int4": (4, False)}
    for name, (bits, fused) in want.items():
        assert ckpt.layout(converted[name], "transformer") == ("transformer", bits, fused)
        keys = ckpt.saved_keys(converted[name])
        assert ("img_qkv" in keys) == fused and ("w_q4" in keys) == (bits == 4)
        md = ckpt.metadata(converted[name])
        assert md["preset"] == "tiny" and md["rung"] == str(bits or "")
    assert ckpt.layout(converted["vl"]) == ("vl", None, False)
    with pytest.raises(ValueError, match="holds a vae checkpoint"):
        ckpt.layout(converted["vae"], "transformer")
    jt = jcv.convert_transformer(jcv.load_safetensors(hf["transformer"]), JP.model)
    for name, jtree in (("transformer", jt),
                        ("transformer_int8_fq", jquant.quantize_transformer(jfuse_qkv(jt), bits=8)),
                        ("transformer_int4", jquant.quantize_transformer(jt, bits=4))):
        assert_same(ckpt.load(converted[name], "cpu", P, "transformer"),
                    cv.from_jax(jax.tree_util.tree_map(np.asarray, jtree), P.model))
    assert_same(ckpt.load(converted["vl"], "cpu", P, "vl"),
                cv.from_jax(jax_converted("vl", hf), P.vl))


def _lora_file(path) -> str:
    gen = torch.Generator().manual_seed(5)
    d = P.model.inner_dim
    tensors = {}
    for blk, mod in ((0, "attn.to_q"), (1, "attn.add_v_proj"), (1, "img_mlp.net.2")):
        din = P.model.mlp_dim if mod == "img_mlp.net.2" else d
        tensors[f"transformer_blocks.{blk}.{mod}.lora_A.weight"] = torch.randn((4, din),
                                                                               generator=gen)
        tensors[f"transformer_blocks.{blk}.{mod}.lora_B.weight"] = torch.randn((d, 4),
                                                                               generator=gen)
        tensors[f"transformer_blocks.{blk}.{mod}.alpha"] = torch.tensor(2.0)
    lora.save_safetensors(str(path), tensors)
    return str(path)


def test_lora_in_the_cli_and_in_from_checkpoint(hf, converted, tmp_path):
    """--lora fuses each delta as its linear arrives, before the q/k/v fuse:
    the tree equals whole-tree fuse_lora then fuse_qkv. from_checkpoint's
    lora_path fuses into a bf16 checkpoint and refuses a quantized one."""
    adapter = _lora_file(tmp_path / "a.safetensors")
    out = str(tmp_path / "t_lora")
    ckpt.main(["convert", "--src", hf["transformer"], "--component", "transformer",
               "--preset", "tiny", "--out", out, "--device", "cpu", "--lora", adapter,
               "--fuse-qkv"])
    base = ckpt.load(converted["transformer"], "cpu", P, "transformer")
    want = fuse_qkv(lora.fuse_lora(base, lora.load_lora_weights(adapter)))
    assert_same(ckpt.load(out, "cpu", P, "transformer"), want)

    cfg = TINY.replace(fuse_qkv=False)
    pipe = EditPipeline.from_checkpoint(converted["transformer"], converted["vae"], "tiny", cfg,
                                        lora_path=adapter, device="cpu")
    want = lora.fuse_lora(ckpt.load(converted["transformer"], "cpu", P),
                          lora.load_lora_weights(adapter))
    assert_same(pipe.tfm_params, want)
    with pytest.raises(ValueError, match="quantized checkpoint"):
        EditPipeline.from_checkpoint(converted["transformer_int8_fq"], converted["vae"], "tiny",
                                     TINY, lora_path=adapter, device="cpu")


@pytest.mark.parametrize("rung", ["transformer", "transformer_int8_fq", "transformer_int4"])
def test_engine_serves_each_rung_from_checkpoints(converted, rung):
    quant = {"transformer": {}, "transformer_int8_fq": {"use_int8": True},
             "transformer_int4": {"use_int4": True}}[rung]
    eng = InferenceEngine.create("tiny", config=TINY.replace(**quant), warmup_runs=0,
                                 input_size=64, transformer_path=converted[rung],
                                 vae_path=converted["vae"], vl_path=converted["vl"],
                                 device="cpu")
    resp = eng.edit({"image": codec.to_base64_jpeg(imaging.make_test_image(64, 64, "gradient")),
                     "prompt": "checkpoint edit", "raw_response": True})
    arr = np.asarray(resp["image"])
    assert arr.shape == (64, 64, 3) and arr.dtype == np.uint8
    params = flatten(eng.pipeline.tfm_params)
    assert all(torch.isfinite(t.float()).all() for t in params.values())
    if rung == "transformer":
        # the served pipeline equals from_weights on the JAX-converted trees
        ref = EditPipeline.from_weights(
            P, TINY, ckpt.load(converted["transformer"], "cpu"),
            ckpt.load(converted["vae"], "cpu"), ckpt.load(converted["vl"], "cpu"), "cpu")
        # the checkpoint's tokenizer, which from_checkpoint takes from vl_path
        ref.encoder.tokenizer = qwen_vl.load_hf_tokenizer(converted["vl"])
        img = imaging.make_test_image(64, 64, "circle")
        a = eng.pipeline(img, "same request", num_inference_steps=1, seed=3)
        b = ref(img, "same request", num_inference_steps=1, seed=3)
        assert torch.isfinite(a.latents).all() and torch.equal(a.latents, b.latents)


def test_from_checkpoint_without_vl_path_draws_the_vl_from_seed_0(hf, converted):
    pipe = EditPipeline.from_checkpoint(converted["transformer"], converted["vae"], "tiny",
                                        TINY, device="cpu")
    assert_same(pipe.encoder.params, qwen_vl.init(stream(0, "vl"), P.vl))
    with pytest.raises(ValueError, match="not a checkpoint of"):
        EditPipeline.from_checkpoint(converted["transformer"], hf["vae_torch"], "tiny", TINY,
                                     device="cpu")


def test_vl_checkpoint_carries_its_tokenizer(hf, converted, tmp_path, capsys):
    """``convert --component vl`` copies tokenizer.json and
    tokenizer_config.json (from the shards' directory, or the diffusers
    layout's sibling ``tokenizer/``) and refuses one the port cannot read
    before converting; ``from_checkpoint`` encodes prompts with it, and
    with ``SimpleTokenizer`` only where the directory has none."""
    import shutil

    from qwen_image_edit_streamdiffusion_tpu_torch.models.tokenizer import Tokenizer

    present = [n for n in ckpt.TOKENIZER_FILES if os.path.isfile(os.path.join(hf["vl"], n))]
    assert present == ["tokenizer.json", "tokenizer_config.json"]
    for name in present:
        with open(os.path.join(hf["vl"], name), "rb") as a, \
                open(os.path.join(converted["vl"], name), "rb") as b:
            assert a.read() == b.read()
    pipe = EditPipeline.from_checkpoint(converted["transformer"], converted["vae"], "tiny",
                                        TINY, vl_path=converted["vl"], device="cpu")
    assert "tokenized by" in capsys.readouterr().out
    tok = pipe.encoder.tokenizer
    assert isinstance(tok, Tokenizer) and len(tok) == 151665
    want = qwen_vl.build_chat_ids(jqwen_vl.load_hf_tokenizer(converted["vl"]),
                                  "checkpoint edit", [4])
    assert qwen_vl.build_chat_ids(tok, "checkpoint edit", [4]) == want

    bare = tmp_path / "vl_bare"
    shutil.copytree(converted["vl"], bare)
    for name in present:
        os.remove(bare / name)
    pipe = EditPipeline.from_checkpoint(converted["transformer"], converted["vae"], "tiny",
                                        TINY, vl_path=str(bare), device="cpu")
    assert "SimpleTokenizer" in capsys.readouterr().out
    assert isinstance(pipe.encoder.tokenizer, qwen_vl.SimpleTokenizer)

    # the diffusers layout: text_encoder/ beside tokenizer/
    root = tmp_path / "diffusers"
    shutil.copytree(hf["vl"], root / "text_encoder",
                    ignore=shutil.ignore_patterns("tokenizer*.json"))
    shutil.copytree(hf["vl"], root / "tokenizer", ignore=shutil.ignore_patterns("*.safetensors*"))
    out = str(tmp_path / "vl_diffusers")
    ckpt.main(["convert", "--src", str(root / "text_encoder"), "--component", "vl",
               "--preset", "tiny", "--out", out, "--device", "cpu"])
    assert os.path.isfile(os.path.join(out, "tokenizer.json"))

    # the JAX rehearsal's stand-in (WordLevel) is refused before converting
    rehearsal._write_tokenizer(str(root / "tokenizer"))
    with pytest.raises(ValueError, match="model 'WordLevel'"):
        ckpt.main(["convert", "--src", str(root / "text_encoder"), "--component", "vl",
                   "--preset", "tiny", "--out", str(tmp_path / "refused"), "--device", "cpu"])
    assert not os.path.exists(tmp_path / "refused")


def test_vl_checkpoint_carries_slow_tokenizer_files(hf, converted, tmp_path, capsys):
    """A tokenizer given only as vocab.json + merges.txt (+ added_tokens.json,
    special_tokens_map.json, tokenizer_config.json), as
    ``save_pretrained(legacy_format=True)`` writes it, in the diffusers
    layout's sibling ``tokenizer/``: ``convert --component vl`` copies those
    files, and ``from_checkpoint`` encodes prompts with them as the JAX
    ``load_hf_tokenizer`` does on the same folder, not with SimpleTokenizer."""
    import shutil

    from transformers import AutoTokenizer

    from qwen_image_edit_streamdiffusion_tpu_torch.models.tokenizer import Tokenizer

    root = tmp_path / "diffusers"
    shutil.copytree(hf["vl"], root / "text_encoder",
                    ignore=shutil.ignore_patterns("tokenizer*.json"))
    AutoTokenizer.from_pretrained(hf["vl"]).save_pretrained(str(root / "tokenizer"),
                                                           legacy_format=True)
    slow = sorted(os.listdir(root / "tokenizer"))
    assert "tokenizer.json" not in slow and {"vocab.json", "merges.txt"} <= set(slow)
    out = str(tmp_path / "vl_slow")
    ckpt.main(["convert", "--src", str(root / "text_encoder"), "--component", "vl",
               "--preset", "tiny", "--out", out, "--device", "cpu"])
    assert "copied the tokenizer" in capsys.readouterr().out
    for name in slow:
        with open(root / "tokenizer" / name, "rb") as a, open(os.path.join(out, name), "rb") as b:
            assert a.read() == b.read(), name
    pipe = EditPipeline.from_checkpoint(converted["transformer"], converted["vae"], "tiny",
                                        TINY, vl_path=out, device="cpu")
    assert "tokenized by vocab.json + merges.txt" in capsys.readouterr().out
    tok = pipe.encoder.tokenizer
    assert isinstance(tok, Tokenizer) and len(tok) == 151665
    for prompt, merged in (("checkpoint edit", [4]), ("把天空换成星空 <tool_call>", [4, 5])):
        want = qwen_vl.build_chat_ids(jqwen_vl.load_hf_tokenizer(out), prompt, merged)
        assert qwen_vl.build_chat_ids(tok, prompt, merged) == want
        assert want != qwen_vl.build_chat_ids(qwen_vl.SimpleTokenizer(len(tok)), prompt, merged)


def test_vl_key_map_matches_transformers_qwen2_5_vl():
    """``vl_key_map`` is pinned to transformers' own Qwen2.5-VL class: a tiny
    ``Qwen2_5_VLForConditionalGeneration`` (2 + 2 layers, mrope 2/3/3) has,
    after ``normalize_vl_key``, exactly the map's names, and ``convert_vl``
    takes its state dict, each tensor where the map puts it."""
    import dataclasses

    tf = pytest.importorskip("transformers")
    cfg = dataclasses.replace(P.vl, hidden_size=64, num_heads=4, num_kv_heads=2,
                              intermediate_size=96, mrope_sections=(2, 3, 3),
                              vision_out_dim=64, dtype="float32")
    hf_cfg = tf.Qwen2_5_VLConfig(
        text_config=dict(hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_layers,
                         num_attention_heads=cfg.num_heads,
                         num_key_value_heads=cfg.num_kv_heads,
                         intermediate_size=cfg.intermediate_size, vocab_size=cfg.vocab_size,
                         rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_eps,
                         rope_scaling={"type": "mrope", "mrope_section": list(
                             cfg.mrope_sections)}),
        vision_config=dict(depth=cfg.vision_depth, hidden_size=cfg.vision_hidden,
                           num_heads=cfg.vision_heads, intermediate_size=cfg.vision_intermediate,
                           out_hidden_size=cfg.vision_out_dim, patch_size=cfg.patch_size,
                           temporal_patch_size=cfg.temporal_patch_size,
                           spatial_merge_size=cfg.spatial_merge_size, window_size=cfg.window_size,
                           fullatt_block_indexes=list(cfg.fullatt_block_indexes)))
    torch.manual_seed(0)
    model = tf.Qwen2_5_VLForConditionalGeneration(hf_cfg).eval()
    state = model.state_dict()
    names = {cv.normalize_vl_key(k) for k in state} - {None}
    key_map = cv.vl_key_map(cfg)
    assert names == set(key_map), sorted(names ^ set(key_map))[:8]
    assert len(names) == len(key_map) == 56
    params = cv.convert_vl(list(state.items()), cfg)
    for hf_key, (path, kind) in key_map.items():
        if kind in ("linear_w", "bias", "norm", "embed"):
            src = next(v for k, v in state.items() if cv.normalize_vl_key(k) == hf_key)
            assert torch.equal(cv.node_at(params, path), src), hf_key
