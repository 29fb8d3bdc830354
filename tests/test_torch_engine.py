"""The port's inference engine (``runtime/engine.py``) at `tiny` on the CPU.

The JAX engine's cases (``tests/test_engine_concurrency.py``, the engine
cases of ``tests/test_stream_batched.py``, the trace endpoints of
``tests/test_checkpoint_engine.py``) run against the port's engine, and the
port's engine is held to the JAX ``InferenceEngine`` on bridged weights
(``convert.from_jax``) with the JAX noise injected: the parsed request
inputs equal bit for bit (the JAX side decodes and resizes with Pillow, the
port with ``core/codec.py`` and ``core/imaging.py``), and the uint8 output of
a plain ``/edit``, a ``use_cfg`` one and three stream-session frames within
one code at f32 (``tests/test_torch_pipeline.py``'s limit).
"""

import base64
import dataclasses
import io
import os
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

import test_torch_pipeline as tp
from test_torch_stream import build_stream_pair, jax_frame_noise
from qwen_image_edit_streamdiffusion_tpu.runtime import engine as jengine
from qwen_image_edit_streamdiffusion_tpu_torch.core import codec, imaging
from qwen_image_edit_streamdiffusion_tpu_torch.core.config import StreamConfig
from qwen_image_edit_streamdiffusion_tpu_torch.core.rng import stream
from qwen_image_edit_streamdiffusion_tpu_torch.models import checkpoint
from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm
from qwen_image_edit_streamdiffusion_tpu_torch.models import vae
from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import stream as tstream
from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.edit_pipeline import EditPipeline
from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels
from qwen_image_edit_streamdiffusion_tpu_torch.runtime.engine import (
    EngineBusy,
    InferenceEngine,
    InvalidRequest,
)

torch.set_num_threads(2)

# the JAX engine tests' config: 64², 1 step
TINY_STREAM = StreamConfig(
    width=64, height=64, vae_image_area=64 * 64, vl_image_area=32 * 32,
    num_inference_steps=1, model_preset="tiny",
)
JOIN_S = 120  # bound on every thread join


@pytest.fixture(scope="module")
def tiny_pipe():
    return EditPipeline.create("tiny", config=TINY_STREAM, seed=0, device="cpu")


def _b64(kind: str) -> str:
    return codec.to_base64_jpeg(imaging.make_test_image(64, 64, kind))


def _join(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive(), "a request thread did not finish"


def _wait_queue(engine, n, tries=2000):
    for _ in range(tries):
        with engine._bq_lock:
            if len(engine._batch_queue) >= n:
                return True
        time.sleep(0.005)
    return False


def test_concurrent_edits_exactly_one_winner(tiny_pipe):
    engine = InferenceEngine(pipeline=tiny_pipe, input_size=64, default_steps=1)
    b64 = _b64("gray")
    engine.edit({"image": b64})

    n = 6
    barrier = threading.Barrier(n)
    results = []

    def worker():
        barrier.wait()
        try:
            engine.edit({"image": b64, "prompt": "race"})
            results.append("ok")
        except EngineBusy:
            results.append("busy")

    threads = [threading.Thread(target=worker) for _ in range(n)]
    for t in threads:
        t.start()
    _join(threads)
    assert results.count("ok") >= 1
    assert results.count("ok") + results.count("busy") == n
    assert engine.total_requests == 1 + results.count("ok")


def test_queue_mode_serializes_all(tiny_pipe):
    engine = InferenceEngine(pipeline=tiny_pipe, input_size=64, default_steps=1,
                             queue_requests=True)
    b64 = _b64("gray")
    engine.edit({"image": b64})
    results = []

    def worker():
        engine.edit({"image": b64})
        results.append("ok")

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    _join(threads)
    assert results.count("ok") == 4
    assert engine.total_requests == 5


def test_warmup_stream_runs_session_frames(monkeypatch):
    """warmup_stream serves a throwaway session's keyframe and temporal frame
    at startup (the JAX engine compiles both graphs there); a session's
    first requests then serve a keyframe, then a temporal frame."""
    kinds = []
    real = tstream.RealtimePipeline._run_frames

    def spy(self, kind, *a, **kw):
        kinds.append(kind)
        return real(self, kind, *a, **kw)

    monkeypatch.setattr(tstream.RealtimePipeline, "_run_frames", spy)
    engine = InferenceEngine.create("tiny", config=TINY_STREAM, warmup_runs=1,
                                    warmup_cfg=False, warmup_stream=True,
                                    input_size=64, device="cpu")
    assert kinds == ["key", "temporal"]
    b64 = _b64("gradient")
    flags = [engine.edit({"image": b64, "prompt": "warm session", "steps": 1,
                          "stream_session": "s1"})["keyframe"] for _ in range(2)]
    assert flags == [True, False]


def test_engine_create_input_size_env_and_checkpoints(monkeypatch, tmp_path):
    """The input size from the environment or the argument; checkpoint
    serving needs both the transformer and the VAE paths (the JAX message),
    and with both it serves from the port's converted checkpoints."""
    monkeypatch.setenv("QIE_INPUT_SIZE", "64")
    e1 = InferenceEngine.create("tiny", config=TINY_STREAM, warmup_runs=0,
                                warmup_cfg=False, device="cpu")
    assert e1.input_size == 64
    e2 = InferenceEngine.create("tiny", config=TINY_STREAM, warmup_runs=0,
                                warmup_cfg=False, input_size=128, device="cpu")
    assert e2.input_size == 128
    for kw in ({"transformer_path": "t"}, {"vae_path": "v"}, {"vl_path": "l"}):
        with pytest.raises(ValueError, match="needs BOTH transformer_path and vae_path"):
            InferenceEngine.create("tiny", config=TINY_STREAM, device="cpu", **kw)
    preset = e1.pipeline.preset
    paths = {}
    for name, params in (("transformer", tfm.init(stream(4, "t"), preset.model)),
                         ("vae", vae.init(stream(4, "v"), preset.vae))):
        paths[name] = str(tmp_path / name)
        checkpoint.save(paths[name], params, {"component": name, "preset": "tiny"})
    e3 = InferenceEngine.create("tiny", config=TINY_STREAM, warmup_runs=0, warmup_cfg=False,
                                transformer_path=paths["transformer"], vae_path=paths["vae"],
                                device="cpu")
    out = e3.edit({"image": _b64("circle"), "prompt": "from a checkpoint", "raw_response": True})
    assert np.asarray(out["image"]).shape == (64, 64, 3)
    assert torch.equal(e3.pipeline.vae_params["decoder"]["conv_out"]["w"],
                       checkpoint.load(paths["vae"], "cpu")["decoder"]["conv_out"]["w"])


def test_dynamic_batching_coalesces_concurrent_requests(tiny_pipe):
    """Requests queued behind a busy lock coalesce into one edit_many: 3
    single-row requests dispatch as an exact 2-row batch plus 1 alone."""
    engine = InferenceEngine(pipeline=tiny_pipe, input_size=64, default_steps=1,
                             dynamic_batch=4)
    imgs = [_b64(k) for k in ("gray", "gradient", "circle")]
    engine._lock.acquire()
    results = {}

    def worker(i):
        results[i] = engine.edit({"image": imgs[i], "prompt": f"style {i}", "seed": i})

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    assert _wait_queue(engine, 3)
    engine._lock.release()
    _join(threads)
    assert all(results[i]["status"] == "success" for i in range(3))
    assert sorted(results[i].get("batched_with", 1) for i in range(3)) == [1, 2, 2]
    assert engine.total_requests == 3
    arrs = [codec.decode_base64(results[i]["image"]).astype(np.int16) for i in range(3)]
    assert np.abs(arrs[0] - arrs[1]).max() > 0
    assert np.abs(arrs[1] - arrs[2]).max() > 0


class _OwnedLock:
    """The engine's device lock, recording which thread holds it."""

    def __init__(self):
        self._lock = threading.Lock()
        self.owner = None

    def acquire(self, blocking=True):
        got = self._lock.acquire(blocking)
        if got:
            self.owner = threading.get_ident()
        return got

    def release(self):
        self.owner = None
        self._lock.release()

    def locked(self):
        return self._lock.locked()


def test_response_jpeg_is_encoded_outside_the_lock(tiny_pipe, monkeypatch):
    """The q90 encode of every response runs in the request's thread after
    it released the device lock: plain, num_images, stream-session and
    dynamically batched requests (a pair, each member encoding its own)."""
    b64 = _b64("gray")
    encodes = []
    real = codec.to_base64_jpeg

    def spy(arr, quality=90):
        encodes.append(lock.owner == threading.get_ident())
        return real(arr, quality)

    monkeypatch.setattr(codec, "to_base64_jpeg", spy)
    engine = InferenceEngine(pipeline=tiny_pipe, input_size=64, default_steps=1)
    lock = engine._lock = _OwnedLock()
    engine.edit({"image": b64})
    two = engine.edit({"image": b64, "num_images": 2})
    assert len(two["images"]) == 1
    engine.edit({"image": b64, "stream_session": "s", "stream_pipeline": True})

    batched = InferenceEngine(pipeline=tiny_pipe, input_size=64, default_steps=1,
                              dynamic_batch=2)
    lock = batched._lock = _OwnedLock()
    lock.acquire()
    results = {}

    def worker(i):
        results[i] = batched.edit({"image": b64, "prompt": f"style {i}", "seed": i})

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    assert _wait_queue(batched, 2)
    lock.release()
    _join(threads)
    assert [results[i].get("batched_with") for i in range(2)] == [2, 2]
    assert len(encodes) == 6 and not any(encodes), encodes


def test_dynamic_batching_stream_frames_queue_not_429(tiny_pipe):
    engine = InferenceEngine(pipeline=tiny_pipe, input_size=64, default_steps=1,
                             dynamic_batch=4)
    b64 = _b64("gray")
    engine._lock.acquire()
    results = {}

    def worker():
        try:
            results["r"] = engine.edit({"image": b64, "stream_session": "s1", "steps": 1})
        except EngineBusy as exc:
            results["r"] = exc

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=0.3)
    assert t.is_alive(), "stream frame should be queued on the busy lock"
    engine._lock.release()
    _join([t])
    assert isinstance(results["r"], dict)
    assert results["r"]["status"] == "success"
    assert results["r"]["stream_session"] == "s1"


def test_dynamic_batching_incompatible_keys_split(tiny_pipe):
    engine = InferenceEngine(pipeline=tiny_pipe, input_size=64, default_steps=1,
                             dynamic_batch=4)
    b64 = _b64("gray")
    engine._lock.acquire()
    results = {}

    def worker(i, steps):
        results[i] = engine.edit({"image": b64, "steps": steps, "seed": i})

    threads = [threading.Thread(target=worker, args=(0, 1)),
               threading.Thread(target=worker, args=(1, 1)),
               threading.Thread(target=worker, args=(2, 2))]
    for t in threads:
        t.start()
    assert _wait_queue(engine, 3)
    engine._lock.release()
    _join(threads)
    assert results[0].get("batched_with") == 2
    assert results[1].get("batched_with") == 2
    assert "batched_with" not in results[2]
    assert engine.total_requests == 3


def _frames():
    return [imaging.make_test_image(64, 64, p) for p in ("gray", "gradient", "circle")]


def _queued_stream_pair(engine, requests):
    """Hold the lock while the requests enqueue, then release it: the first
    waker leads the whole queue. Returns the responses by key."""
    engine._lock.acquire()
    results = {}

    def worker(key, req):
        results[key] = engine.edit(req)

    ts = [threading.Thread(target=worker, args=kv) for kv in requests.items()]
    for t in ts:
        t.start()
    assert _wait_queue(engine, len(requests))
    engine._lock.release()
    _join(ts)
    return results


def test_engine_coalesces_sessions_and_matches_serial(tiny_pipe):
    """Two sessions' temporal frames queued behind a held lock run as one
    2-row dispatch (batched_with=2) and give the serial engine's images."""
    b64s = [codec.to_base64_jpeg(f) for f in _frames()]

    def run(dynamic):
        pipe = dataclasses.replace(tiny_pipe)
        engine = InferenceEngine(pipeline=pipe, input_size=64, default_steps=1,
                                 dynamic_batch=4 if dynamic else 0,
                                 queue_requests=not dynamic)
        out = {"a0": engine.edit({"image": b64s[0], "stream_session": "a", "steps": 1}),
               "b0": engine.edit({"image": b64s[1], "stream_session": "b", "steps": 1})}
        reqs = {sid: {"image": b64s[2], "stream_session": sid, "steps": 1}
                for sid in ("a", "b")}
        if dynamic:
            res = _queued_stream_pair(engine, reqs)
        else:
            res = {sid: engine.edit(r) for sid, r in reqs.items()}
        out["a1"], out["b1"] = res["a"], res["b"]
        return out

    serial, dyn = run(False), run(True)
    assert dyn["a1"].get("batched_with") == 2 and dyn["b1"].get("batched_with") == 2
    assert not dyn["a1"]["keyframe"] and dyn["a1"]["frame"] == 2
    for k in ("a1", "b1"):
        got = codec.decode_base64(dyn[k]["image"]).astype(np.float32)
        want = codec.decode_base64(serial[k]["image"]).astype(np.float32)
        assert np.abs(got - want).mean() < 2.0


def test_engine_batched_pipelined_lag_semantics(tiny_pipe):
    b64s = [codec.to_base64_jpeg(f) for f in _frames()]
    engine = InferenceEngine(pipeline=dataclasses.replace(tiny_pipe), input_size=64,
                             default_steps=1, dynamic_batch=4)
    for sid, b in (("a", b64s[0]), ("b", b64s[1])):
        r = engine.edit({"image": b, "stream_session": sid, "steps": 1,
                         "stream_pipeline": True})
        assert r["lag"] == 0 and r["keyframe"]
    res = _queued_stream_pair(engine, {
        sid: {"image": b64s[2], "stream_session": sid, "steps": 1, "stream_pipeline": True}
        for sid in ("a", "b")})
    for sid in ("a", "b"):
        r = res[sid]
        assert r["status"] == "success" and r["lag"] == 1
        assert r.get("batched_with") == 2
        assert engine._session_pending[sid] is not None


def test_same_session_frames_never_share_a_dispatch(tiny_pipe):
    b64s = [codec.to_base64_jpeg(f) for f in _frames()]
    engine = InferenceEngine(pipeline=dataclasses.replace(tiny_pipe), input_size=64,
                             default_steps=1, dynamic_batch=4)
    engine.edit({"image": b64s[0], "stream_session": "a", "steps": 1})
    engine._lock.acquire()
    results = []

    def worker(i):
        results.append(engine.edit({"image": b64s[i], "stream_session": "a", "steps": 1}))

    ts = [threading.Thread(target=worker, args=(i,)) for i in (1, 2)]
    for t in ts:
        t.start()
    assert _wait_queue(engine, 2)
    engine._lock.release()
    _join(ts)
    assert sorted(r["frame"] for r in results) == [2, 3]
    assert all("batched_with" not in r for r in results)


def test_engine_trace_endpoints(tmp_path):
    eng = InferenceEngine(pipeline=None)
    d = str(tmp_path / "trace")
    assert eng.start_trace(d)["status"] == "tracing"
    with pytest.raises(RuntimeError):
        eng.start_trace(d)
    torch.ones(8).sum()
    out = eng.stop_trace()
    assert out["status"] == "stopped" and os.path.isfile(out["trace"])
    with pytest.raises(RuntimeError):
        eng.stop_trace()
    assert os.path.isdir(d)


def test_health_reports_memory_only_on_a_card(tiny_pipe):
    engine = InferenceEngine(pipeline=tiny_pipe, input_size=64, default_steps=1)
    h = engine.health()
    assert h["status"] == "ok" and h["model_loaded"] and h["gpu_memory"] == "N/A"
    assert InferenceEngine(pipeline=None).health()["model_loaded"] is False


# ---------------------------------------------------------------------------
# parity with the JAX engine on bridged weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) on the same f32 numpy trees, guided edits
    in batched CFG, the port drawing the JAX noise for edits and frames."""
    jpipe, tpipe = build_stream_pair(True, cfg_mode="batched")
    tpipe._noise = tp.jax_noise(jpipe, torch.float32)
    je = jengine.InferenceEngine(pipeline=jpipe, input_size=64, default_steps=2)
    te = InferenceEngine(pipeline=tpipe, input_size=64, default_steps=2)
    return je, te


def _wire_image(h: int, w: int, seed: int) -> str:
    """A noisy off-size image, as a Pillow-made q90 base64 JPEG."""
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, (h, w, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=90)
    return base64.b64encode(buf.getvalue()).decode()


def test_parsed_requests_equal_jax(engines):
    je, te = engines
    img, ref = _wire_image(80, 72, 0), _wire_image(50, 90, 1)
    requests = [
        {"image": img, "prompt": "watercolor"},
        {"image": "data:image/jpeg;base64," + img, "use_cfg": True,
         "negative_prompt": "blurry", "cfg_scale": 3.0, "seed": 7, "num_images": 2},
        {"image": img, "ref_image": ref, "blend_ratio": 0.3},
        {"image": img, "ref_image": ref, "ref_mode": "condition", "steps": 1},
    ]
    for req in requests:
        j, t = je._parse_edit(dict(req)), te._parse_edit(dict(req))
        assert len(j["image"]) == len(t["image"])
        for ja, ta in zip(j["image"], t["image"]):
            np.testing.assert_array_equal(np.asarray(ja), ta)
        assert {k: v for k, v in j.items() if k != "image"} == \
            {k: v for k, v in t.items() if k != "image"}
    jimg, _ = je._parse_stream_request({"image": img, "ref_image": ref})
    timg, _ = te._parse_stream_request({"image": img, "ref_image": ref})
    np.testing.assert_array_equal(np.asarray(jimg), timg)
    with pytest.raises(InvalidRequest, match="ref_mode"):
        te._parse_edit({"image": img, "ref_image": ref, "ref_mode": "conditon"})


def _close(jout, tout):
    j = np.asarray(jout).astype(np.int32)
    assert tout.dtype == np.uint8 and tout.shape == j.shape
    assert np.abs(tout.astype(np.int32) - j).max() <= 1


@pytest.mark.parametrize("use_cfg", [False, True], ids=["cond", "cfg"])
def test_edit_matches_jax_engine(engines, use_cfg):
    je, te = engines
    req = {"image": _wire_image(80, 72, 2), "prompt": "oil painting", "use_cfg": use_cfg,
           "raw_response": True}
    before = dict(kernels.LAUNCHES)
    jr, tr = je.edit(dict(req)), te.edit(dict(req))
    assert kernels.LAUNCHES == before  # CPU tensors never reach a kernel
    assert set(jr) == set(tr) and tr["status"] == "success"
    _close(jr["image"], tr["image"])


def test_stream_session_matches_jax_engine(engines, monkeypatch):
    je, te = engines
    monkeypatch.setattr(tstream.RealtimePipeline, "_frame_noise",
                        lambda self, kind, shape, i: jax_frame_noise(self.config.seed)(
                            kind, shape, i))
    for i in range(3):
        req = {"image": _wire_image(64, 64, 10 + i), "prompt": "sketch",
               "stream_session": "cam", "raw_response": True}
        jr, tr = je.edit(dict(req)), te.edit(dict(req))
        assert (tr["frame"], tr["keyframe"]) == (jr["frame"], jr["keyframe"]) == (i + 1, i == 0)
        _close(jr["image"], tr["image"])
