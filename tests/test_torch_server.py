"""The port's HTTP server and websocket endpoint (``serving/server.py``,
``serving/ws.py``) on a live stdlib server over a `tiny` CPU pipeline.

Every case of the JAX package's ``tests/test_server.py`` and ``tests/test_ws.py``
runs against the port: endpoints, field names, status codes 200, 404, 422,
426, 429, 500 and 503, the stream session over HTTP and over the websocket,
the React frontend's websocket sequence, and the FastAPI factory under the
same stub. Then a fresh process that cannot import jax, PIL, cv2,
safetensors, orbax or the JAX package serves an ``/edit`` of a port-encoded
JPEG and decodes the reply, converts an HF-layout tree with the port's CLI
and serves an ``/edit`` from it through the server's CLI.
"""

import io
import json
import os
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from qwen_image_edit_streamdiffusion_tpu_torch.core import codec, imaging
from qwen_image_edit_streamdiffusion_tpu_torch.core.config import StreamConfig
from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.edit_pipeline import EditPipeline
from qwen_image_edit_streamdiffusion_tpu_torch.runtime.engine import (
    InferenceEngine,
    ModelNotLoaded,
)
from qwen_image_edit_streamdiffusion_tpu_torch.serving import ws
from qwen_image_edit_streamdiffusion_tpu_torch.serving.server import make_server

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_STREAM = StreamConfig(
    width=64, height=64, vae_image_area=64 * 64, vl_image_area=32 * 32,
    num_inference_steps=2, model_preset="tiny",
)


@pytest.fixture(scope="module")
def server_url():
    pipe = EditPipeline.create("tiny", config=TINY_STREAM, seed=0, device="cpu")
    engine = InferenceEngine(pipeline=pipe, input_size=64, default_steps=2)
    srv = make_server(engine, host="127.0.0.1", port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", engine
    srv.shutdown()
    srv.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=300) as r:
        return r.status, json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _b64(kind: str) -> str:
    return codec.to_base64_jpeg(imaging.make_test_image(64, 64, kind))


def test_root_endpoint(server_url):
    url, _ = server_url
    code, body = _get(url + "/")
    assert code == 200 and body["status"] == "running"
    assert "/edit" in body["endpoints"] and "/health" in body["endpoints"]


def test_health_endpoint(server_url):
    url, _ = server_url
    code, body = _get(url + "/health")
    assert code == 200 and body["status"] == "ok"
    assert body["model_loaded"] is True
    assert body["gpu_memory"] == "N/A"  # a CPU pipeline


def test_edit_roundtrip(server_url):
    url, _ = server_url
    code, body = _post(url + "/edit", {"image": _b64("circle"), "prompt": "oil painting",
                                       "steps": 2})
    assert code == 200, body
    assert body["status"] == "success" and body["elapsed"] > 0
    out = codec.decode_base64(body["image"])
    assert out.shape == (64, 64, 3) and out.dtype == np.uint8


def test_edit_with_composite(server_url):
    url, _ = server_url
    code, body = _post(url + "/edit", {"image": _b64("circle"), "ref_image": _b64("gradient"),
                                       "blend_ratio": 0.5, "prompt": "mix"})
    assert code == 200, body


def test_edit_with_cfg(server_url):
    url, _ = server_url
    code, body = _post(url + "/edit", {"image": _b64("gray"), "use_cfg": True})
    assert code == 200, body


def test_missing_image_field_422(server_url):
    url, _ = server_url
    code, _ = _post(url + "/edit", {"prompt": "x"})
    assert code == 422


def test_bad_base64_500(server_url):
    url, _ = server_url
    code, body = _post(url + "/edit", {"image": "!!!not-base64!!!"})
    assert code == 500 and "detail" in body


def test_unsupported_image_500(server_url):
    """An image the codec refuses (here a lossy AVIF: Pillow decodes it, the
    port names the feature it lacks) is the wrapped 500 an undecodable
    image is, with the format and the feature named."""
    import base64

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(imaging.make_test_image(64, 64, "circle")).save(buf, "AVIF", quality=90)
    url, _ = server_url
    code, body = _post(url + "/edit", {"image": base64.b64encode(buf.getvalue()).decode()})
    assert code == 500 and "AVIF" in body["detail"] and "lossy" in body["detail"]


def test_lossless_avif_edit_200(server_url):
    """A lossless AVIF upload (Pillow's quality 100) is decoded by the
    port's AV1 decoder and edited like any image."""
    import base64

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(imaging.make_test_image(64, 64, "circle")).save(buf, "AVIF", quality=100)
    url, _ = server_url
    code, body = _post(url + "/edit", {"image": base64.b64encode(buf.getvalue()).decode(),
                                       "steps": 2})
    assert code == 200, body
    assert codec.decode_base64(body["image"]).shape == (64, 64, 3)


def test_lab_tiff_edit_200(server_url):
    """A CIELab TIFF upload (Pillow's LAB mode saved as TIFF) is decoded
    through the port's LittleCMS arithmetic and edited like any image."""
    import base64

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(imaging.make_test_image(64, 64, "circle")).convert("LAB").save(buf, "TIFF")
    url, _ = server_url
    code, body = _post(url + "/edit", {"image": base64.b64encode(buf.getvalue()).decode(),
                                       "steps": 2})
    assert code == 200, body
    assert codec.decode_base64(body["image"]).shape == (64, 64, 3)


def test_unknown_ref_mode_422(server_url):
    url, _ = server_url
    img = _b64("gray")
    code, body = _post(url + "/edit", {"image": img, "ref_image": img, "ref_mode": "conditon"})
    assert code == 422 and "ref_mode" in body["detail"]


def test_busy_429(server_url):
    url, engine = server_url
    engine._lock.acquire()
    try:
        code, body = _post(url + "/edit", {"image": _b64("gray")})
        assert code == 429 and "busy" in body["detail"].lower()
    finally:
        engine._lock.release()


def test_model_not_loaded_503():
    engine = InferenceEngine(pipeline=None)
    with pytest.raises(ModelNotLoaded):
        engine.edit({"image": "x"})
    srv = make_server(engine, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        code, _ = _post(f"http://127.0.0.1:{srv.server_address[1]}/edit", {"image": "x"})
        assert code == 503
    finally:
        srv.shutdown()
        srv.server_close()


def test_unknown_route_404(server_url):
    url, _ = server_url
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nope", timeout=30)
    assert e.value.code == 404


def test_ui_served(server_url):
    url, _ = server_url
    with urllib.request.urlopen(url + "/ui", timeout=30) as r:
        html = r.read().decode()
        assert r.status == 200 and "/edit" in html and "webcam" in html.lower()


def test_cors_preflight_and_profile_routes(server_url):
    url, _ = server_url
    req = urllib.request.Request(url + "/edit", method="OPTIONS")
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 200 and r.headers["Access-Control-Allow-Origin"] == "*"
    code, _ = _post(url + "/profile/stop", {})
    assert code == 409  # no trace running
    code, body = _post(url + "/profile/start", {})
    assert code == 200 and body["status"] == "tracing"
    assert _post(url + "/profile/start", {})[0] == 409
    code, body = _post(url + "/profile/stop", {})
    assert code == 200 and os.path.isfile(body["trace"])


def _spy_denoise(monkeypatch, pipe):
    calls = []
    real = pipe._denoise

    def spy(x, cond, txt, mask, img_shapes, steps, cfg_mode="none", *a, **kw):
        calls.append((len(img_shapes), cfg_mode))
        return real(x, cond, txt, mask, img_shapes, steps, cfg_mode, *a, **kw)

    monkeypatch.setattr(pipe, "_denoise", spy)
    return calls


def test_warmup_runs_cfg_variant(monkeypatch):
    """Engine warmup serves the guided variant too (the JAX engine compiles
    both CFG buckets), so a first use_cfg request comes warm."""
    pipe = EditPipeline.create("tiny", config=TINY_STREAM, seed=0, device="cpu")
    calls = _spy_denoise(monkeypatch, pipe)
    InferenceEngine(pipeline=pipe, input_size=64, default_steps=1, warmup_cfg=True).warmup()
    assert {mode for _, mode in calls} == {"none", TINY_STREAM.cfg_mode}


def test_ref_mode_condition_two_image_edit(server_url, monkeypatch):
    url, engine = server_url
    calls = _spy_denoise(monkeypatch, engine.pipeline)
    code, body = _post(url + "/edit", {"image": _b64("circle"), "ref_image": _b64("gradient"),
                                       "ref_mode": "condition", "prompt": "apply the style",
                                       "steps": 1})
    assert code == 200 and body["status"] == "success"
    assert codec.decode_base64(body["image"]).shape == (64, 64, 3)
    assert calls == [(3, "none")]  # target + two condition grids


def test_stream_session_over_http(server_url):
    url, engine = server_url
    code, b1 = _post(url + "/edit", {"image": _b64("gradient"), "prompt": "watercolor",
                                     "stream_session": "cam-1"})
    assert code == 200, b1
    assert b1["stream_session"] == "cam-1" and b1["keyframe"] is True and b1["frame"] == 1
    assert codec.decode_base64(b1["image"]).shape == (64, 64, 3)
    code, b2 = _post(url + "/edit", {"image": _b64("circle"), "prompt": "watercolor",
                                     "stream_session": "cam-1"})
    assert code == 200 and b2["keyframe"] is False and b2["frame"] == 2
    assert "cam-1" in engine._sessions


def test_stream_session_prompt_switch_keeps_latent(server_url):
    url, engine = server_url
    img = _b64("gray")
    _post(url + "/edit", {"image": img, "prompt": "a", "stream_session": "cam-2"})
    sess = engine._sessions["cam-2"]
    assert sess.prev_latent is not None
    code, body = _post(url + "/edit", {"image": img, "prompt": "b", "stream_session": "cam-2"})
    assert code == 200 and body["frame"] == 2 and body["keyframe"] is False
    assert sess.prompt == "b"


def test_stream_session_lru_eviction(server_url):
    url, engine = server_url
    img = _b64("gray")
    engine.max_stream_sessions = 2
    engine._sessions.clear()
    try:
        for sid in ("s1", "s2", "s3"):
            assert _post(url + "/edit", {"image": img, "stream_session": sid})[0] == 200
        assert set(engine._sessions) == {"s2", "s3"}
    finally:
        engine.max_stream_sessions = 4


def test_stream_session_rejects_ref_mode_condition(server_url):
    url, _ = server_url
    img = _b64("gray")
    code, body = _post(url + "/edit", {"image": img, "ref_image": img,
                                       "ref_mode": "condition", "stream_session": "cam-3"})
    assert code == 422 and "stream_session" in body["detail"]


def test_stream_session_pipelined_lag(server_url):
    url, engine = server_url
    bodies = []
    for kind in ("gradient", "circle", "gray"):
        code, body = _post(url + "/edit", {"image": _b64(kind), "prompt": "sketch",
                                           "stream_session": "pipe-1",
                                           "stream_pipeline": True})
        assert code == 200, body
        bodies.append(body)
    assert [b["lag"] for b in bodies] == [0, 1, 1]
    assert [b["frame"] for b in bodies] == [1, 2, 3]
    assert bodies[1]["image"] == bodies[0]["image"]  # the prime frame, once more
    assert bodies[2]["image"] != bodies[1]["image"]
    code, body = _post(url + "/edit", {"image": _b64("gradient"), "prompt": "sketch",
                                       "stream_session": "pipe-1"})
    assert code == 200 and "lag" not in body
    assert engine._session_pending.get("pipe-1") is None


def test_edit_request_extensions_seed_negative_cfgscale(server_url):
    url, _ = server_url
    img = _b64("circle")

    def run(extra):
        code, body = _post(url + "/edit", {"image": img, "prompt": "sketch", **extra})
        assert code == 200, body
        return body["image"]

    a, b, c = run({"seed": 7}), run({"seed": 7}), run({"seed": 8})
    assert a == b and a != c
    run({"use_cfg": True, "negative_prompt": "blurry, low quality", "cfg_scale": 3.0})


def test_edit_num_images(server_url):
    url, _ = server_url
    img = _b64("circle")
    code, body = _post(url + "/edit", {"image": img, "prompt": "oil painting", "steps": 1,
                                       "num_images": 2})
    assert code == 200 and body["status"] == "success" and len(body["images"]) == 1
    a = codec.decode_base64(body["image"]).astype(np.int16)
    b = codec.decode_base64(body["images"][0]).astype(np.int16)
    assert np.abs(a - b).max() > 0
    code, single = _post(url + "/edit", {"image": img, "prompt": "oil painting", "steps": 1})
    assert code == 200 and "images" not in single


def test_dynamic_batch_over_http(server_url):
    url, engine = server_url
    engine.dynamic_batch = 4
    try:
        b64 = _b64("gradient")
        engine._lock.acquire()
        out = {}

        def post(i):
            out[i] = _post(url + "/edit", {"image": b64, "prompt": f"p{i}", "steps": 1,
                                           "seed": i})

        ths = [threading.Thread(target=post, args=(i,)) for i in range(2)]
        for t in ths:
            t.start()
        for _ in range(2000):
            with engine._bq_lock:
                if len(engine._batch_queue) == 2:
                    break
            time.sleep(0.005)
        engine._lock.release()
        for t in ths:
            t.join(timeout=120)
            assert not t.is_alive()
        for i in range(2):
            code, body = out[i]
            assert code == 200 and body["batched_with"] == 2
    finally:
        engine.dynamic_batch = 0


def test_fastapi_factory_contract(server_url, monkeypatch):
    """create_fastapi_app under a stub fastapi (pydantic is real): the
    routes run against the live engine, every response field fits the
    declared model, and a busy engine surfaces as HTTPException(429)."""
    import asyncio
    import types

    _, engine = server_url
    fastapi = types.ModuleType("fastapi")

    class FastAPI:
        def __init__(self, **k):
            self.routes, self.response_models = {}, {}

        def add_middleware(self, *a, **k):
            pass

        def get(self, path, **k):
            def deco(fn):
                self.routes[("GET", path)] = fn
                return fn
            return deco

        def post(self, path, response_model=None, **k):
            def deco(fn):
                self.routes[("POST", path)] = fn
                self.response_models[("POST", path)] = response_model
                return fn
            return deco

    class HTTPException(Exception):
        def __init__(self, status_code, detail=""):
            super().__init__(detail)
            self.status_code, self.detail = status_code, detail

    fastapi.FastAPI, fastapi.HTTPException = FastAPI, HTTPException
    mw = types.ModuleType("fastapi.middleware")
    cors = types.ModuleType("fastapi.middleware.cors")
    cors.CORSMiddleware = object
    mw.cors = cors
    fastapi.middleware = mw
    monkeypatch.setitem(sys.modules, "fastapi", fastapi)
    monkeypatch.setitem(sys.modules, "fastapi.middleware", mw)
    monkeypatch.setitem(sys.modules, "fastapi.middleware.cors", cors)

    from qwen_image_edit_streamdiffusion_tpu_torch.serving.server import create_fastapi_app

    app = create_fastapi_app(engine)
    assert asyncio.run(app.routes[("GET", "/")]())["status"] == "running"
    assert asyncio.run(app.routes[("GET", "/health")]())["model_loaded"]
    edit = app.routes[("POST", "/edit")]
    req_model, resp_model = app.edit_request_model, app.response_models[("POST", "/edit")]
    assert resp_model is app.edit_response_model
    img = _b64("circle")
    resp = asyncio.run(edit(req_model(image=img, prompt="stylize", steps=1, num_images=2)))
    assert not set(resp) - set(resp_model.model_fields)
    v = resp_model.model_validate(resp)
    assert v.status == "success" and v.images is not None and len(v.images) == 1
    engine._lock.acquire()
    try:
        with pytest.raises(HTTPException) as exc:
            asyncio.run(edit(req_model(image=img, prompt="x", steps=1)))
        assert exc.value.status_code == 429
    finally:
        engine._lock.release()


# ---------------------------------------------------------------------------
# websocket framing and handshake (no server)
# ---------------------------------------------------------------------------


def test_accept_key_rfc6455_vector():
    assert ws.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


@pytest.mark.parametrize("size", [5, 200, 70_000, 1 << 17])
def test_frame_roundtrip_masked_all_length_encodings(size):
    buf = io.BytesIO()
    payload = (bytes(range(256)) * ((size + 255) // 256))[:size]
    ws.write_frame(buf, ws.OP_BINARY, payload, mask=True)
    opcode, got, fin = ws.read_frame(io.BytesIO(buf.getvalue()))
    assert (opcode, fin) == (ws.OP_BINARY, True) and got == payload


def test_fragmented_message_reassembly_with_interleaved_ping():
    import socket

    sa, sb = socket.socketpair()
    rf, wf = sa.makefile("rb"), sb.makefile("wb")
    wf.write(struct.pack("!BB", 0x01, 3) + b"abc")   # TEXT, no FIN
    wf.write(struct.pack("!BB", 0x89, 2) + b"hi")    # PING
    wf.write(struct.pack("!BB", 0x80, 3) + b"def")   # CONT, FIN
    wf.flush()
    rf2, wf2 = sb.makefile("rb"), sa.makefile("wb")
    assert ws.read_message(rf, wf2) == (ws.OP_TEXT, b"abcdef")
    opcode, pong, _ = ws.read_frame(rf2)
    assert (opcode, pong) == (ws.OP_PONG, b"hi")
    sa.close()
    sb.close()


# ---------------------------------------------------------------------------
# websocket on the live server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ws_server(server_url):
    url, engine = server_url
    host, port = url[len("http://"):].split(":")
    return host, int(port), engine


def _frame(i: int) -> np.ndarray:
    img = imaging.make_test_image(64, 64, "gradient").copy()
    img[0, i % 64] = (255, 0, 0)
    return img


def _is_jpeg_of(data: bytes, shape) -> bool:
    return data[:3] == b"\xff\xd8\xff" and codec.decode(data).shape == shape


def test_stream_websocket_session_frames(ws_server):
    host, port, _ = ws_server
    c = ws.WSClient(host, port)
    assert c.recv()["status"] == "ready"
    c.send_config(prompt="make it noir", steps=2, pipeline=True)
    assert c.recv()["status"] == "ok"
    metas = []
    for i in range(3):
        c.send_image(_frame(i))
        meta, jpeg = c.recv()
        assert _is_jpeg_of(jpeg, (64, 64, 3)) and meta["status"] == "success"
        metas.append(meta)
    assert metas[0]["lag"] == 0 and metas[1]["lag"] == 1
    assert metas[0]["keyframe"] is True
    assert [m["frame"] for m in metas] == [1, 2, 3]
    assert metas[0]["stream_session"].startswith("ws-")
    c.close()


def test_stream_websocket_live_prompt_switch(ws_server):
    host, port, _ = ws_server
    c = ws.WSClient(host, port)
    c.recv()
    c.send_config(prompt="sketch style", pipeline=False)
    c.recv()
    c.send_image(_frame(0))
    assert c.recv()[0]["frame"] == 1
    c.send_config(prompt="oil painting style")
    assert c.recv()["status"] == "ok"
    c.send_image(_frame(1))
    meta, _ = c.recv()
    assert meta["frame"] == 2 and meta["keyframe"] is False
    c.close()


def test_stream_websocket_sessionless_edit_mode(ws_server):
    host, port, _ = ws_server
    c = ws.WSClient(host, port)
    c.recv()
    c.send_config(session=False, prompt="a painting")
    c.recv()
    c.send_image(codec.encode_jpeg(_frame(0)))  # raw bytes pass through
    meta, jpeg = c.recv()
    assert meta["status"] == "success" and "stream_session" not in meta
    assert _is_jpeg_of(jpeg, (64, 64, 3))
    c.close()


def test_stream_websocket_errors_keep_connection(ws_server):
    host, port, _ = ws_server
    c = ws.WSClient(host, port)
    c.recv()
    c.send_config(promt="typo")
    err = c.recv()
    assert err["status"] == "error" and err["code"] == 422
    ws.write_frame(c.wfile, ws.OP_BINARY, b"not an image", mask=True)
    err = c.recv()
    assert err["status"] == "error" and err["code"] == 422 and err["frame"] is True
    c.send_config(prompt="still alive", pipeline=False)
    assert c.recv()["status"] == "ok"
    c.send_image(_frame(1))
    assert c.recv()[0]["status"] == "success"
    c.close()


def test_react_frontend_wire_sequence(ws_server):
    """The React frontend's sequence: one config TEXT frame, two binary
    JPEG frames in flight before any read, replies parsed as the JS does
    ([4-byte big-endian meta length][meta JSON][jpeg]), a live config
    switch mid-stream."""
    host, port, _ = ws_server
    c = ws.WSClient(host, port)
    assert c.recv()["status"] == "ready"
    c.send_config(prompt="neon city", steps=2, use_cfg=False, pipeline=True)
    assert c.recv()["status"] == "ok"
    c.send_image(_frame(0))
    c.send_image(_frame(1))
    metas = []
    for _ in range(2):
        opcode, data = ws.read_message(c.rfile, c.wfile, mask_replies=True,
                                       write_lock=c._wlock)
        assert opcode == ws.OP_BINARY
        (n,) = struct.unpack("!I", data[:4])
        metas.append(json.loads(data[4:4 + n].decode()))
        assert _is_jpeg_of(data[4 + n:], (64, 64, 3))
    assert metas[0]["lag"] == 0 and metas[1]["lag"] == 1 and metas[0]["keyframe"] is True
    c.send_config(prompt="sketch style", steps=2, use_cfg=False)
    assert c.recv()["status"] == "ok"
    c.send_image(_frame(2))
    assert c.recv()[0]["frame"] == 3
    c.close()


def test_stream_endpoint_without_upgrade_is_426(ws_server):
    host, port, _ = ws_server
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://{host}:{port}/stream", timeout=60)
    assert e.value.code == 426
    assert "upgrade" in json.loads(e.value.read())["detail"].lower()


def test_raw_response_flag_not_exposed_via_http(ws_server):
    host, port, _ = ws_server
    code, resp = _post(f"http://{host}:{port}/edit",
                       {"image": codec.to_base64_jpeg(_frame(0)), "prompt": "x",
                        "raw_response": True})
    assert code == 200 and isinstance(resp["image"], str)
    assert _get(f"http://{host}:{port}/health")[0] == 200


# ---------------------------------------------------------------------------
# a closed socket's session teardown against the frames of other sockets
# ---------------------------------------------------------------------------


class _RefusalSpy:
    """The engine's device lock itself, setting ``refused`` when a claim
    that does not wait fails."""

    def __init__(self, lock):
        self.lock, self.refused = lock, threading.Event()

    def acquire(self, blocking=True):
        got = self.lock.acquire(blocking)
        if not got:
            self.refused.set()
        return got

    def release(self):
        self.lock.release()

    def locked(self):
        return self.lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


def _ws_client(host, port, **config):
    c = ws.WSClient(host, port, timeout=120)
    sid = c.recv()["session"]
    c.send_config(**config)
    assert c.recv()["status"] == "ok"
    return c, sid


def test_stream_websocket_teardown_never_refuses_another_frame(ws_server, monkeypatch):
    """A socket closes, and its session's teardown holds the device until a
    frame of a second socket has been refused the device lock once: the
    frame is served all the same (it waits the teardown out), and the closed
    socket's session is gone."""
    host, port, engine = ws_server
    c2, _ = _ws_client(host, port, prompt="sketch style", pipeline=False)
    c1, sid = _ws_client(host, port, prompt="make it noir")
    c1.send_image(_frame(0))
    assert c1.recv()[0]["status"] == "success" and sid in engine._sessions
    spy = _RefusalSpy(engine._lock)
    monkeypatch.setattr(engine, "_lock", spy)
    tearing, waited = threading.Event(), []
    drop = engine._drop_session

    def held_drop(s):
        if s == sid:
            tearing.set()
            waited.append(spy.refused.wait(60))
        drop(s)

    monkeypatch.setattr(engine, "_drop_session", held_drop)
    c1.close()
    assert tearing.wait(60)
    c2.send_image(_frame(1))
    reply = c2.recv()
    assert isinstance(reply, tuple), reply  # not the 429 error dict
    meta, jpeg = reply
    assert meta["status"] == "success" and _is_jpeg_of(jpeg, (64, 64, 3))
    assert waited == [True] and sid not in engine._sessions
    c2.close()


def test_stream_websocket_frame_overlapping_a_request_is_429(ws_server, monkeypatch):
    """With ``queue_requests`` False (the default) a frame that finds another
    request holding the device still gets 429, and the request is served."""
    host, port, engine = ws_server
    assert engine.queue_requests is False
    c1, _ = _ws_client(host, port, session=False, prompt="a painting")
    c2, _ = _ws_client(host, port, prompt="sketch style", pipeline=False)
    entered, go = threading.Event(), threading.Event()
    parse = engine._parse_edit

    def held_parse(request):
        entered.set()
        assert go.wait(60)
        return parse(request)

    monkeypatch.setattr(engine, "_parse_edit", held_parse)
    try:
        c1.send_image(_frame(0))
        assert entered.wait(60)
        c2.send_image(_frame(1))
        err = c2.recv()
    finally:
        go.set()
    assert err["status"] == "error" and err["code"] == 429 and err["frame"] is True
    assert c1.recv()[0]["status"] == "success"
    c1.close()
    c2.close()


def test_session_ended_while_a_request_holds_the_device(ws_server):
    """``end_session`` while a request holds the device returns at once and
    leaves the session to the holder, which drops it as it releases."""
    host, port, engine = ws_server
    c, sid = _ws_client(host, port, prompt="make it noir", pipeline=False)
    c.send_image(_frame(0))
    assert c.recv()[0]["status"] == "success"
    assert engine._acquire_device(False)
    try:
        ender = threading.Thread(target=engine.end_session, args=(sid,), daemon=True)
        ender.start()
        ender.join(30)
        assert not ender.is_alive()
        assert sid in engine._sessions
    finally:
        engine._release_device()
    assert sid not in engine._sessions
    c.close()


def test_teardowns_never_refuse_a_lone_request_under_stress():
    """16 threads end 50 sessions each (yielding while they hold the lock)
    while one thread claims and releases the device 2000 times without
    waiting, the switch interval at 1 µs: the lone request is never refused
    (no other request overlaps it), and every ended session is dropped,
    none left marked."""
    from types import SimpleNamespace

    engine = InferenceEngine(pipeline=None)
    engine._sessions.update({f"s{t}-{k}": SimpleNamespace(lockstep=None)
                             for t in range(16) for k in range(50)})
    drop = engine._drop_session

    def yielding_drop(sid):
        time.sleep(0)  # the other threads run while the teardown holds the lock
        drop(sid)

    engine._drop_session = yielding_drop
    refused = []

    def requests():
        for _ in range(2000):
            if engine._acquire_device(False):
                engine._release_device()
            else:
                refused.append(1)

    def teardowns(t):
        for k in range(50):
            engine.end_session(f"s{t}-{k}")

    threads = [threading.Thread(target=requests)] + [
        threading.Thread(target=teardowns, args=(t,)) for t in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not refused
    assert not engine._sessions and not engine._ended


# ---------------------------------------------------------------------------
# jax, PIL and cv2 blocked
# ---------------------------------------------------------------------------


def test_server_runs_with_jax_pil_cv2_blocked(tmp_path):
    """A fresh process whose import system refuses jax, PIL, cv2,
    safetensors, orbax, transformers, tokenizers, regex and the JAX package
    serves one /edit of a port-encoded JPEG and decodes the reply; then the
    port's CLI converts an HF-layout tiny tree (fabricated here, by this
    process, with a Qwen2-layout tokenizer.json beside the VL shards, which
    the conversion copies) and the server's CLI serves one /edit of a
    progressive JPEG (the committed fixture) from it with --transformer
    --vae --vl, its prompts tokenized by that file, then /edits of a lossy
    WebP with alpha, an interlaced GIF, an RLE8 BMP and a YCCK JPEG (the
    committed fixtures); a lone --transformer is refused."""
    from test_torch_checkpoint import fabricate

    hf = fabricate(str(tmp_path / "hf"))
    pkg = "qwen_image_edit_streamdiffusion_tpu_torch"
    code = f"""
import importlib.abc, json, socket, sys, threading, time, urllib.request
FORBIDDEN = ("jax", "jaxlib", "PIL", "cv2", "torchvision", "safetensors", "orbax",
             "transformers", "tokenizers", "regex", "qwen_image_edit_streamdiffusion_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
import torch
torch.set_num_threads(2)
from {pkg}.core import codec, imaging
from {pkg}.core.config import StreamConfig
from {pkg}.models import checkpoint
from {pkg}.runtime.engine import InferenceEngine
from {pkg}.serving.server import main, make_server
cfg = StreamConfig(width=64, height=64, vae_image_area=64 * 64, vl_image_area=32 * 32,
                   num_inference_steps=1, model_preset="tiny")
engine = InferenceEngine.create("tiny", config=cfg, warmup_runs=0, input_size=64,
                                device="cpu")
srv = make_server(engine, "127.0.0.1", 0)
threading.Thread(target=srv.serve_forever, daemon=True).start()
body = json.dumps({{"image": codec.to_base64_jpeg(imaging.make_test_image(80, 80, "circle")),
                   "prompt": "oil"}}).encode()
def edit(port, body=body):
    req = urllib.request.Request(f"http://127.0.0.1:{{port}}/edit", body,
                                 {{"Content-Type": "application/json"}})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        return codec.decode_base64(json.loads(r.read())["image"])
out = edit(srv.server_address[1])
assert out.shape == (64, 64, 3), out.shape
srv.shutdown()
try:
    main(["--transformer", "t.ckpt", "--device", "cpu"])
except SystemExit as e:
    assert e.code == 2
src = {json.dumps({"transformer": hf["transformer"], "vae": hf["vae_torch"], "vl": hf["vl"]})}
out_dir = {str(tmp_path / "port")!r}
flags = []
for comp, path in src.items():
    checkpoint.main(["convert", "--src", path, "--component", comp, "--preset", "tiny",
                     "--out", f"{{out_dir}}/{{comp}}", "--device", "cpu"])
    flags += [f"--{{comp}}", f"{{out_dir}}/{{comp}}"]
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
threading.Thread(target=main, daemon=True, args=([
    "--preset", "tiny", "--device", "cpu", "--no-warmup", "--host", "127.0.0.1",
    "--port", str(port), "--steps", "1", "--input-size", "64", *flags],)).start()
for _ in range(600):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{{port}}/health", timeout=5) as r:
            break
    except OSError:
        time.sleep(0.1)
import base64
with open("tests/fixtures/codec/prog_512_420.jpg", "rb") as f:
    progressive = f.read()
assert progressive[:2] == b"\\xff\\xd8" and b"\\xff\\xc2" in progressive
out = edit(port, json.dumps({{"image": base64.b64encode(progressive).decode(),
                              "prompt": "oil"}}).encode())
assert out.shape == (64, 64, 3), out.shape
for name in ("lossy_alpha.webp", "interlaced.gif", "rle8.bmp", "ycck.jpg"):
    with open("tests/fixtures/codec/" + name, "rb") as f:
        out = edit(port, json.dumps({{"image": base64.b64encode(f.read()).decode(),
                                      "prompt": "oil"}}).encode())
    assert out.shape == (64, 64, 3), (name, out.shape)
assert not any(m.split(".")[0] in FORBIDDEN for m in sys.modules)
print("ok")
"""
    env = dict(os.environ, QIE_SIZE="64")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]
    assert "needs both --transformer and --vae" in proc.stderr
    assert "saved vl" in proc.stdout and "copied the tokenizer" in proc.stdout
    assert "prompts are tokenized by" in proc.stdout and "151665 ids" in proc.stdout
