"""The port's realtime stream (``pipeline/stream.py``), the rest of its
surface: the JAX package's ``tests/test_stream_cache.py`` and
``tests/test_stream_batched.py`` (to the engine, which waits for the serving
slice) case for case, and the parts of the stream held to the JAX stream
besides its frames' math.

- the tiny pair on temporal frames only, the golden ``stream.temporal_frame``
  (3e-2), yuv420 and the hybrid-resolution preview against the JAX stream
  (f32: latents 1e-3, pixels one code), the preview upscale's bytes
  against the JAX ``_collect``'s native library;
- the similarity filter's decisions equal to the JAX stream's over a frame
  sequence, and its 32×32 signature equal to Pillow's
  ``convert("L").resize((32, 32), BILINEAR)``;
- ``submit_frames_batched``: rows equal to the sessions alone, against the
  JAX batched dispatch, one host fetch, mismatches refused;
- keyframe cadence, frozen conditions, the pos/neg bucket padding, the
  preview warn-once fallback, the headless camera loop, ``run_benchmark``'s
  PNG, the test images, and a stream run with jax, PIL and the JAX package
  blocked.
"""

import dataclasses
import os
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import test_torch_pipeline as tp
from qwen_image_edit_streamdiffusion_tpu.core import imaging as jimaging
from qwen_image_edit_streamdiffusion_tpu.core.config import StreamConfig, get_preset
from qwen_image_edit_streamdiffusion_tpu.core.rng import key_from_seed
from qwen_image_edit_streamdiffusion_tpu.core.rng import stream as jax_stream
from qwen_image_edit_streamdiffusion_tpu.models import qwen_vl as jvl
from qwen_image_edit_streamdiffusion_tpu.models import tiny_vae as jtv
from qwen_image_edit_streamdiffusion_tpu.models import transformer as jtfm
from qwen_image_edit_streamdiffusion_tpu.models import vae as jvae
from qwen_image_edit_streamdiffusion_tpu.pipeline import stream as jstream
from qwen_image_edit_streamdiffusion_tpu.runtime import native_ops
from qwen_image_edit_streamdiffusion_tpu_torch.core import imaging
from qwen_image_edit_streamdiffusion_tpu_torch.models import tiny_vae as tv
from qwen_image_edit_streamdiffusion_tpu_torch.models.convert import from_jax
from qwen_image_edit_streamdiffusion_tpu_torch.models.text_encoder import (
    PromptEmbedding,
    StubEncoder,
)
from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import edit_pipeline as tep
from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import stream as tstream
from test_torch_stream import (  # noqa: F401  (f32_pair: a module fixture here too)
    NEG,
    SIZE,
    _tiny_pair_trees,
    assert_f32_close,
    build_stream_pair,
    f32_pair,
    frames,
    jax_frame,
    jax_frame_noise,
    sessions,
    set_config,
    stream_config,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = dict(np.load(os.path.join(ROOT, "tests", "goldens", "tiny_goldens.npz")))
# the JAX tests' stream: 64², 2 steps, a keyframe every 3 frames
TINY_STREAM = stream_config(cfg_mode="batched", fuse_qkv=True)


@pytest.fixture(scope="module")
def port_pipe():
    """A random-init `tiny` port pipeline on the CPU (the JAX tests'
    ``EditPipeline.create("tiny", seed=0)``)."""
    return tep.EditPipeline.create("tiny", TINY_STREAM, seed=0, device="cpu")


def _session(pipe, **config):
    """A stream session on a shallow copy of ``pipe`` (its own config, the
    shared params), as the JAX engine makes them."""
    p = dataclasses.replace(pipe, config=pipe.config.replace(**config))
    return tstream.RealtimePipeline(pipe=p)


def _dummy_pipe(cfg):
    """An EditPipeline shell for the parts of the stream that need only a
    config and a device (fetch, upscale, the similarity filter)."""
    return tep.EditPipeline(preset=get_preset("tiny"), config=cfg, tfm_params=None,
                            vae_params=None, encoder=None, device=torch.device("cpu"),
                            prompt_cache=None, latent_cache=None)


def test_tiny_pair_frames_match_jax_f32():
    """``encoder="tiny"``, ``decoder="tiny"``: keyframes encode through the
    full VAE, temporal frames through the tiny encoder, both decode through
    the tiny decoder, on both sides (rcfg-self, the composed stream)."""
    jpipe, tpipe = build_stream_pair(True, tiny_pair=True, cfg_mode="rcfg-self")
    jrt, trt = sessions(jpipe, tpipe, negative_prompt=NEG)
    kinds = []
    real = tpipe._encode_pixels
    tpipe._encode_pixels = lambda arrays, kind="full", params=None: (
        kinds.append((kind, params is tpipe.tiny_encoder[0])) or real(arrays, kind, params))
    for arr in frames(3):
        jout = jax_frame(jrt, arr)
        assert_f32_close(jrt, trt, jout, trt.process_frame(arr))
    assert kinds == [("full", False), ("tiny", True), ("tiny", True)]


def test_tiny_encoder_on_temporal_frames_only():
    """As the JAX ``test_stream_temporal_frames_use_tiny_encoder``: with
    ``encoder="tiny"`` the keyframe equals a full-encoder stream's bit for
    bit and the temporal frame differs; an edit's condition stays on the
    full VAE."""
    _, tpipe = build_stream_pair(True)
    (_, _), (etree, ecfg) = _tiny_pair_trees(tp._preset(True))
    full = tstream.RealtimePipeline(pipe=tpipe)
    tiny_pipe = dataclasses.replace(
        tpipe, config=tpipe.config.replace(encoder="tiny"),
        tiny_encoder=(from_jax(etree, ecfg), tv.TinyEncoderConfig(**dataclasses.asdict(ecfg))))
    tiny = tstream.RealtimePipeline(pipe=tiny_pipe)
    for rt in (full, tiny):
        rt.precompute_conditions("stream")
    img = imaging.make_test_image(SIZE, SIZE, "gradient")
    np.testing.assert_array_equal(full.process_frame(img), tiny.process_frame(img))
    assert np.any(full.process_frame(img) != tiny.process_frame(img))
    assert tiny_pipe._encode_params_for("key") is tiny_pipe.vae_params
    assert tiny_pipe._encode_params_for("temporal") is tiny_pipe.tiny_encoder[0]
    used = []
    real = tiny_pipe._encode_pixels
    tiny_pipe._encode_pixels = lambda a, kind="full", params=None: (
        used.append(kind) or real(a, kind, params))
    tiny_pipe(img, "edit", num_inference_steps=1)
    assert used == ["full"]


def test_golden_temporal_frame():
    """``verify_parity``'s ``stream.temporal_frame``: the JAX ``create``'s
    seed-0 weights (bridged; the port fuses q/k/v itself), the random tiny
    pair of seed 0, rcfg-self, 64², frame 2 (a temporal frame through the
    tiny pair), within the golden compare limits 3e-2."""
    preset = get_preset("tiny")
    key = key_from_seed(0)
    np_tree = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)
    tfm_tree = np_tree(jtfm.init_jit(jax_stream(key, "transformer"), preset.model))
    vae_tree = np_tree(jvae.init_jit(jax_stream(key, "vae"), preset.vae))
    vl_tree = np_tree(jvl.init_jit(jax.random.PRNGKey(0), preset.vl))
    dcfg = jtv.TinyDecoderConfig.from_vae(preset.vae)
    ecfg = jtv.TinyEncoderConfig.from_vae(preset.vae)
    dtree = np_tree(jtv.init_jit(jax_stream(key, "tiny_vae"), dcfg))
    etree = np_tree(jtv.encoder_init_jit(jax_stream(key, "tiny_vae_enc"), ecfg))
    config = StreamConfig(width=64, height=64, vae_image_area=64 * 64,
                          vl_image_area=32 * 32, num_inference_steps=2,
                          cfg_mode="rcfg-self", model_preset="tiny")
    pipe = tep.EditPipeline.from_weights(
        preset, config, from_jax(tfm_tree, preset.model), from_jax(vae_tree, preset.vae),
        from_jax(vl_tree, preset.vl), device="cpu")
    pipe.tiny_vae = (from_jax(dtree, dcfg), tv.TinyDecoderConfig(**dataclasses.asdict(dcfg)))
    pipe.tiny_encoder = (from_jax(etree, ecfg),
                         tv.TinyEncoderConfig(**dataclasses.asdict(ecfg)))
    pipe.config = pipe.config.replace(decoder="tiny", encoder="tiny")
    rt = tstream.RealtimePipeline(pipe=pipe)
    rt._frame_noise = jax_frame_noise(config.seed)
    rt.precompute_conditions("golden stream", negative_prompt="blurry")
    frame = imaging.make_test_image(64, 64, "gradient")
    rt.process_frame(frame)
    got = rt.process_frame(frame).astype(np.float32) / 255.0
    np.testing.assert_allclose(got, GOLDENS["stream.temporal_frame"], atol=3e-2, rtol=3e-2)


def test_yuv420_frames_match_jax_and_rgb(f32_pair):
    """``transfer_format="yuv420"`` (4:2:0 upload and download): the port's
    frames against the JAX stream's, and luma close to the rgb stream's
    (the JAX ``test_stream_yuv420_transfer_roundtrip`` limit)."""
    jpipe, tpipe = f32_pair
    set_config(jpipe, tpipe, cfg_mode="batched", num_inference_steps=2,
               transfer_format="yuv420")
    try:
        jrt, trt = sessions(jpipe, tpipe)
        yuv = []
        for arr in frames(2):
            jout = jax_frame(jrt, arr)
            yuv.append(trt.process_frame(arr))
            assert_f32_close(jrt, trt, jout, yuv[-1])
    finally:
        set_config(jpipe, tpipe, transfer_format="rgb")
    _, trt = sessions(jpipe, tpipe)
    rgb = trt.process_frame(frames(1)[0]).astype(np.float32)
    luma = lambda a: 0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2]
    assert np.abs(luma(yuv[0].astype(np.float32)) - luma(rgb)).mean() < 8.0


def test_preview_stream_matches_jax():
    """``preview_scale=2``: the keyframe at 64² hands off its latent pooled
    2×2 (4×4 grid), temporal frames run at 32² and come back upscaled to
    64²; latents within 1e-3 and each frame within one code of the JAX
    stream (yuv420, as the JAX hybrid test)."""
    jpipe, tpipe = build_stream_pair(True, preview_scale=2, transfer_format="yuv420")
    jrt, trt = sessions(jpipe, tpipe)
    for i, arr in enumerate(frames(4)):
        jout = jax_frame(jrt, arr, pipelined=i % 2 == 1)
        tout = trt._collect(trt.submit_frame(arr)) if i % 2 else trt.process_frame(arr)
        assert tout.shape == (SIZE, SIZE, 3)
        assert tuple(trt.prev_latent.shape) == (1, 4, 4, 16)
        assert_f32_close(jrt, trt, jout, tout)
    assert trt.is_keyframe and trt.frame_count == 4


def test_preview_upscale_bytes_match_jax_collect():
    """A preview frame's upscale in ``_collect`` (``imaging.resize_native``
    on the pipeline's device) against the JAX ``_collect``'s native
    ``resize_lanczos``, byte for byte (it differs from Pillow's LANCZOS)."""
    assert native_ops.available()
    cfg = stream_config(preview_scale=2)
    trt = tstream.RealtimePipeline(pipe=_dummy_pipe(cfg))
    rng = np.random.default_rng(11)
    for h, w in ((32, 32), (32, 48)):
        small = rng.integers(0, 256, (1, h, w, 3), np.uint8)
        trt.pipe.config = cfg.replace(width=2 * w, height=2 * h)
        got = trt._collect(torch.from_numpy(small))
        assert np.array_equal(got, native_ops.resize_lanczos(small[0], 2 * h, 2 * w))


def test_stream_runs_with_jax_blocked():
    """A fresh process whose import system refuses jax, optax, PIL and the
    JAX package runs a `tiny` CPU stream: keyframe and temporal frames,
    submit/collect and a 2-session batched frame."""
    pkg = "qwen_image_edit_streamdiffusion_tpu_torch"
    code = f"""
import importlib.abc, sys
FORBIDDEN = ("jax", "jaxlib", "optax", "PIL", "qwen_image_edit_streamdiffusion_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
import dataclasses, numpy as np, torch
torch.set_num_threads(2)
from {pkg}.core.config import StreamConfig
from {pkg}.core import imaging
from {pkg}.pipeline.stream import RealtimePipeline, submit_frames_batched
cfg = StreamConfig(width=64, height=64, vae_image_area=64 * 64, vl_image_area=32 * 32,
                   num_inference_steps=2, keyframe_interval=3, model_preset="tiny")
rt = RealtimePipeline.create("tiny", config=cfg, seed=0, device="cpu")
rt.precompute_conditions("oil painting", negative_prompt="blurry")
img = imaging.make_test_image(64, 64, "gradient")
outs = [rt.process_frame(img), rt._collect(rt.submit_frame(img))]
assert all(o.shape == (64, 64, 3) and o.dtype == np.uint8 for o in outs)
a, b = (RealtimePipeline(pipe=dataclasses.replace(rt.pipe)) for _ in range(2))
for s in (a, b):
    s.precompute_conditions("watercolor")
    s.process_frame(img)
h = submit_frames_batched([a, b], [img, img])
assert a._collect(h[0]).shape == (64, 64, 3)
assert not any(m.split(".")[0] in FORBIDDEN for m in sys.modules)
print("ok")
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]


# ---------------------------------------------------------------------------
# the JAX tests/test_stream_cache.py, case for case
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rt(port_pipe):
    p = tstream.RealtimePipeline(pipe=port_pipe)
    p.precompute_conditions("oil painting style")
    return p


def test_keyframe_schedule(rt):
    frame = imaging.make_test_image(SIZE, SIZE, "gradient")
    flags = []
    for _ in range(5):
        rt.process_frame(frame)
        flags.append(rt.is_keyframe)
    assert flags == [True, False, False, True, False]  # interval 3
    assert rt.frame_count == 5
    stats = rt.get_stats()
    assert stats["fps"] > 0 and stats["frame_count"] == 5


def test_temporal_frames_produce_valid_images(rt):
    frame = imaging.make_test_image(SIZE, SIZE, "circle")
    for out in [rt.process_frame(frame) for _ in range(3)]:
        assert out.shape == (SIZE, SIZE, 3) and out.dtype == np.uint8


def test_temporal_latent_carried(rt):
    assert rt.prev_latent is not None
    assert tuple(rt.prev_latent.shape) == (1, 8, 8, 16)
    assert rt.prev_latent.dtype == torch.float32


def test_camera_loop_headless(rt, capsys):
    """No camera: the sine pattern, bounded frames, stats printed; pipelined
    and sequential terminate, and exactly ``max_frames`` frames are
    dispatched (no in-flight frame thrown away)."""
    rt.frame_count = 0
    rt.prev_latent = None
    rt.run_camera_loop(max_frames=3, pipelined=True)
    out = capsys.readouterr().out
    assert out.count("frame ") == 3 and "fps" in out
    assert rt.frame_count == 3
    rt.run_camera_loop(max_frames=2, pipelined=False)
    assert capsys.readouterr().out.count("frame ") == 2
    assert rt.frame_count == 5


def test_stream_cfg_with_mismatched_prompt_buckets():
    """Positive and negative embeddings of different lengths are padded to
    one (zero rows, False mask) so the guided frame stacks them."""
    class TwoBucketEncoder:
        joint_dim = 48

        def encode(self, prompt, images=()):
            n = 8 if len(prompt) < 20 else 16
            rng = np.random.default_rng(len(prompt))
            return PromptEmbedding(embeds=rng.standard_normal((n, 48)).astype(np.float32),
                                   mask=np.ones((n,), bool))

    p = tstream.RealtimePipeline.create("tiny", config=TINY_STREAM.replace(true_cfg_scale=4.0),
                                        seed=0, device="cpu", encoder=TwoBucketEncoder())
    p.precompute_conditions("short", negative_prompt="a much longer negative prompt text")
    assert p._frozen_txt.shape == p._frozen_neg_txt.shape == (1, 16, 48)
    assert p._frozen_mask[0, 8:].any().item() is False
    assert p._frozen_neg_mask.all().item() is True
    out = p.process_frame(imaging.make_test_image(SIZE, SIZE, "gradient"))
    assert out.shape == (SIZE, SIZE, 3)


def test_stream_freezes_prompt_conditions():
    """Conditions encoded once (one wave for the pos/neg pair), zero
    per-frame encodes."""
    calls = []

    class CountingEncoder(StubEncoder):
        def encode(self, prompt, images=()):
            calls.append(prompt)
            return super().encode(prompt, images)

    pipe = tep.EditPipeline.create("tiny", TINY_STREAM, seed=0, device="cpu",
                                   encoder=CountingEncoder(joint_dim=48, max_len=64))
    p = tstream.RealtimePipeline(pipe=pipe)
    p.precompute_conditions("stylize", negative_prompt="blurry")
    assert calls == ["stylize", "blurry"]
    frame = imaging.make_test_image(SIZE, SIZE, "gray")
    p.process_frame(frame)
    p._collect(p.submit_frame(frame))
    assert calls == ["stylize", "blurry"], f"per-frame encodes: {calls}"


def _guided_modes(pipe, monkeypatch):
    modes = []
    real = pipe._denoise
    monkeypatch.setattr(pipe, "_denoise", lambda *a, **kw: modes.append(a[6]) or real(*a, **kw))
    return modes


def test_stream_with_true_cfg(port_pipe, monkeypatch):
    """A negative prompt at scale 4: keyframe and temporal frames run
    batched CFG, and the output differs from the cond-only stream's."""
    p = _session(port_pipe)
    modes = _guided_modes(p.pipe, monkeypatch)
    p.precompute_conditions("oil painting", negative_prompt="blurry")
    frame = imaging.make_test_image(SIZE, SIZE, "gradient")
    outs = [p.process_frame(frame) for _ in range(4)]
    assert modes == ["batched"] * 4
    q = _session(port_pipe)
    q.precompute_conditions("oil painting")
    assert np.abs(outs[0].astype(np.int16) - q.process_frame(frame).astype(np.int16)).max() > 0


def test_stream_rcfg_self_runs_cond_only(port_pipe, monkeypatch):
    """rcfg-self frames (keyframe and temporal) run the residual mode with
    one-row forwards, never a batched pair, and guidance is live."""
    p = _session(port_pipe, cfg_mode="rcfg-self")
    modes = _guided_modes(p.pipe, monkeypatch)
    rows = []
    real_forward = tep.tfm.forward
    monkeypatch.setattr(tep.tfm, "forward",
                        lambda params, cfg, x, *a, **kw: rows.append(x.shape[0])
                        or real_forward(params, cfg, x, *a, **kw))
    p.precompute_conditions("oil painting", negative_prompt="blurry")
    frame = imaging.make_test_image(SIZE, SIZE, "gradient")
    out = p.process_frame(frame)
    p.process_frame(frame)
    assert modes == ["rcfg-self", "rcfg-self"]
    assert rows == [1, 1, 1]  # 2 steps on the keyframe, 1 on the temporal frame
    q = _session(port_pipe)
    q.precompute_conditions("oil painting")
    assert np.abs(out.astype(np.int16) - q.process_frame(frame).astype(np.int16)).max() > 0


def test_similarity_filter_skips_static_frames(port_pipe):
    p = _session(port_pipe, similarity_filter=True, similarity_threshold=0.98,
                 similarity_max_skip=3)
    p.precompute_conditions("oil painting")
    static = imaging.make_test_image(SIZE, SIZE, "gradient")
    outs = [p.process_frame(static) for _ in range(6)]
    assert p.skipped_frames >= 1 and p.frame_count >= 2
    assert p.frame_count + p.skipped_frames == 6
    assert p.get_stats()["skipped_frames"] == p.skipped_frames
    assert all(o is not None and o.shape == (SIZE, SIZE, 3) for o in outs)
    before = p.frame_count
    p.process_frame(imaging.make_test_image(SIZE, SIZE, "circle"))  # scene change
    assert p.frame_count == before + 1


def test_similarity_filter_pipelined_path(port_pipe):
    """submit_frame skips static frames too, handing back the last handle;
    every handle collects (the skipped ones from the cached host copy)."""
    p = _session(port_pipe, similarity_filter=True, similarity_max_skip=3)
    p.precompute_conditions("oil painting")
    static = imaging.make_test_image(SIZE, SIZE, "gradient")
    handles = [p.submit_frame(static) for _ in range(5)]
    assert p.skipped_frames >= 1 and p.frame_count + p.skipped_frames == 5
    assert any(h1 is h2 for h1, h2 in zip(handles, handles[1:]))
    for h in handles:
        assert p._collect(h).shape == (SIZE, SIZE, 3)


def test_similarity_filter_off_never_skips(rt):
    static = imaging.make_test_image(SIZE, SIZE, "gradient")
    before = rt.frame_count
    for _ in range(3):
        rt.process_frame(static)
    assert rt.frame_count == before + 3 and rt.skipped_frames == 0


def test_preview_scale_invalid_size_warns_once_and_disables(port_pipe):
    """width/height not divisible by 16·s: one warning, full resolution."""
    p = _session(port_pipe, width=48, height=48, vae_image_area=48 * 48, preview_scale=2)
    p.precompute_conditions("oil painting style")
    frame = imaging.make_test_image(48, 48, "gradient")
    with pytest.warns(UserWarning, match="preview_scale"):
        p.process_frame(frame)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = p.process_frame(frame)  # temporal, full resolution, no second warning
    assert out.shape == (48, 48, 3) and tuple(p.prev_latent.shape) == (1, 6, 6, 16)


def test_warmup_resets_the_stream(port_pipe):
    p = _session(port_pipe, similarity_filter=True)
    p.precompute_conditions("oil painting")
    p.warmup(runs=2)
    assert (p.frame_count, p.prev_latent, p.inference_times, p.skipped_frames) == (
        0, None, [], 0)
    assert p._ssf_sig is None and p._ssf_pixels is None


@pytest.mark.parametrize("pipelined", [True, False])
def test_run_benchmark_writes_png(port_pipe, tmp_path, pipelined):
    p = _session(port_pipe)
    p.precompute_conditions("oil painting")
    path = str(tmp_path / "out.png")
    assert p.run_benchmark(num_frames=3, pipelined=pipelined, output_path=path) > 0
    img = np.asarray(Image.open(path))
    assert img.shape == (SIZE, SIZE, 3) and img.dtype == np.uint8
    assert p.frame_count == 3


# ---------------------------------------------------------------------------
# the similarity filter against the JAX stream's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(64, 64), (480, 640), (75, 50)])
def test_ssf_signature_matches_pillow(hw):
    arr = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), np.uint8)
    want = np.asarray(Image.fromarray(arr).convert("L").resize((32, 32), Image.BILINEAR))
    got = imaging.luma_signature(arr)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_ssf_decisions_match_jax():
    """The same frame sequence (a static scene with sensor noise, drifts and
    cuts) through both filters: the same skip decision every frame, the
    seeded Bernoulli draws included."""
    cfg = stream_config(similarity_filter=True, similarity_threshold=0.98,
                        similarity_max_skip=4)
    rng = np.random.default_rng(5)
    base = imaging.make_test_image(SIZE, SIZE, "gradient").astype(np.int32)
    seq = []
    for i in range(60):
        if i in (20, 41):
            base = imaging.make_test_image(SIZE, SIZE, "sine", phase=i).astype(np.int32)
        seq.append(np.clip(base + rng.integers(-6 - i % 7, 7 + i % 7, base.shape),
                           0, 255).astype(np.uint8))
    jrt = jstream.RealtimePipeline(pipe=type("P", (), {"config": cfg})())
    trt = tstream.RealtimePipeline(pipe=_dummy_pipe(cfg))
    have = [i % 13 != 0 for i in range(60)]
    want = [jrt._ssf_should_skip(Image.fromarray(f), h) for f, h in zip(seq, have)]
    got = [trt._ssf_should_skip(f, h) for f, h in zip(seq, have)]
    assert got == want
    assert 5 < sum(want) < 55  # fractional probabilities: both outcomes occur


@pytest.mark.parametrize("kind", ["gray", "gradient", "circle", "sine"])
def test_make_test_image_matches_jax(kind):
    for w, h in ((64, 64), (37, 53)):
        want = np.asarray(jimaging.make_test_image(w, h, kind, phase=0.7))
        got = imaging.make_test_image(w, h, kind, phase=0.7)
        assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_write_png_reads_back(tmp_path):
    arr = np.random.default_rng(0).integers(0, 256, (23, 41, 3), np.uint8)
    path = str(tmp_path / "x.png")
    imaging.write_png(path, arr)
    assert np.array_equal(np.asarray(Image.open(path).convert("RGB")), arr)


# ---------------------------------------------------------------------------
# cross-session batching (the JAX tests/test_stream_batched.py:50-123)
# ---------------------------------------------------------------------------


BATCH_STREAM = TINY_STREAM.replace(num_inference_steps=1)


@pytest.fixture(scope="module")
def batch_pipe():
    return tep.EditPipeline.create("tiny", BATCH_STREAM, seed=0, device="cpu")


def _batch_frames():
    return [imaging.make_test_image(SIZE, SIZE, k) for k in ("gray", "gradient", "circle")]


def test_batched_rows_match_individual_sessions(batch_pipe):
    """Row r of a 2-session batched temporal frame equals session r
    dispatching alone (its frozen prompt, previous latent and frame
    noise)."""
    f_kf1, f_kf2, f_t = _batch_frames()

    def prime_pair():
        a, b = _session(batch_pipe), _session(batch_pipe)
        a.precompute_conditions("oil painting")
        b.precompute_conditions("watercolor sketch")
        a.process_frame(f_kf1)
        b.process_frame(f_kf2)
        return a, b

    ref_a, ref_b = prime_pair()
    out_a, out_b = ref_a.process_frame(f_t), ref_b.process_frame(f_t)
    bat_a, bat_b = prime_pair()
    handles = tstream.submit_frames_batched([bat_a, bat_b], [f_t, f_t])
    got_a, got_b = bat_a._collect(handles[0]), bat_b._collect(handles[1])
    d = lambda x, y: np.abs(x.astype(np.int16) - y.astype(np.int16)).max()
    assert d(got_a, out_a) <= 1 and d(got_b, out_b) <= 1
    assert d(got_a, got_b) > 1  # per-row conditioning is real
    assert bat_a.frame_count == ref_a.frame_count == 2
    assert not bat_a.is_keyframe and not bat_b.is_keyframe
    assert bat_a.prev_latent.shape == ref_a.prev_latent.shape


def test_batched_fetches_host_copy_once(batch_pipe, monkeypatch):
    a, b = _session(batch_pipe), _session(batch_pipe)
    for s, f in zip((a, b), _batch_frames()):
        s.precompute_conditions("style")
        s.process_frame(f)
    handles = tstream.submit_frames_batched([a, b], _batch_frames()[:2])
    bp = handles[0][0]
    assert isinstance(bp, tstream.BatchPixels) and handles[1][0] is bp
    calls = []
    real = tep.EditPipeline._fetch_images
    monkeypatch.setattr(tep.EditPipeline, "_fetch_images",
                        lambda self, px: calls.append(1) or real(self, px))
    img_a, img_b = a._collect(handles[0]), b._collect(handles[1])
    assert len(calls) == 1
    assert img_a.shape == img_b.shape == (SIZE, SIZE, 3)


def test_batched_kind_or_config_mismatch_raises(batch_pipe):
    """A keyframe row cannot share a dispatch with a temporal row, and
    sessions must agree on steps and geometry; preview sessions never
    batch."""
    a, b = _session(batch_pipe), _session(batch_pipe)
    a.precompute_conditions("style")
    b.precompute_conditions("style")
    a.process_frame(_batch_frames()[0])  # a: temporal next; b: keyframe next
    with pytest.raises(ValueError, match="incompatible"):
        tstream.submit_frames_batched([a, b], _batch_frames()[:2])
    b.process_frame(_batch_frames()[1])
    b.pipe.config = b.config.replace(num_inference_steps=2)
    with pytest.raises(ValueError, match="incompatible"):
        tstream.submit_frames_batched([a, b], _batch_frames()[:2])
    b.pipe.config = b.config.replace(num_inference_steps=1)
    for s in (a, b):
        s.pipe.config = s.config.replace(preview_scale=2)
    with pytest.raises(ValueError, match="preview_scale"):
        tstream.submit_frames_batched([a, b], _batch_frames()[:2])
    with pytest.raises(ValueError, match="one frame per session"):
        tstream.submit_frames_batched([a, b], _batch_frames()[:1])


def test_batched_matches_jax_batched(f32_pair):
    """Two sessions' keyframes, then one batched temporal frame, through the
    JAX ``submit_frames_batched`` and the port's: each row's latents within
    1e-3 and pixels within one code."""
    jpipe, tpipe = f32_pair
    set_config(jpipe, tpipe, cfg_mode="batched", num_inference_steps=2)
    arrs = frames(3)
    jrows, trows = [], []
    for prompt, arr in (("oil painting", arrs[0]), ("watercolor sketch", arrs[1])):
        jrt = jstream.RealtimePipeline(pipe=dataclasses.replace(jpipe))
        trt = _session(tpipe)
        trt._frame_noise = jax_frame_noise(tpipe.config.seed)
        for s in (jrt, trt):
            s.precompute_conditions(prompt)
        jax_frame(jrt, arr)
        trt.process_frame(arr)
        jrows.append(jrt)
        trows.append(trt)
    jh = jstream.submit_frames_batched(jrows, [Image.fromarray(arrs[2])] * 2)
    th = tstream.submit_frames_batched(trows, [arrs[2]] * 2)
    for jrt, trt, j, t in zip(jrows, trows, jh, th):
        assert_f32_close(jrt, trt, np.asarray(jrt._collect(j)), trt._collect(t))
