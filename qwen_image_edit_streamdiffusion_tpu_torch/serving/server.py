"""HTTP JSON API: the reference's wire, served by the port on one GPU or, under
torchrun, on several.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/serving/server.py``: the
same endpoints (``/``, ``/health``, ``/edit``, ``/stream`` (websocket,
``serving/ws.py``), ``/ui``, ``/profile/start``, ``/profile/stop``), request
and response fields, status codes (200, 404, 409, 422, 426, 429, 500, 503)
and CORS headers, so the reference's React frontend (``frontend/``) and
``examples/ws_client.py`` work against it unchanged. Built on the stdlib
``http.server``; ``create_fastapi_app`` gives the same routes where fastapi
is installed.

Run on the card:

    python -m qwen_image_edit_streamdiffusion_tpu_torch.serving.server \\
        [--port 8086] [--preset qwen-image-edit-2509] [--device cuda] \\
        [--transformer DIR --vae DIR [--vl DIR] [--lora FILE]]

or over N cards, the model tensor-parallel over all of them (a mesh of
cfg 1 × model N, as the JAX server shards over every local device):

    torchrun --nproc_per_node=N -m \\
        qwen_image_edit_streamdiffusion_tpu_torch.serving.server [--dist-backend nccl]

Each rank builds its slices of the pipeline on ``cuda:LOCAL_RANK``; rank 0
serves HTTP and the websocket and broadcasts each pipeline call and each
stream session's calls, the others follow them
(``runtime/engine.py::follow``; a websocket's session ends on every rank
when the socket closes). A call that raises on any rank ends that
rank's process group, so the others' collectives fail at once, and the
world stops (torchrun ends every rank when one fails): restart it.
``--dist-backend gloo`` lets several ranks
share one card (NCCL refuses that); ``--device cuda:0`` puts them there.

Environment: QIE_PRESET, QIE_STEPS, QIE_SIZE (output side), QIE_INPUT_SIZE,
QIE_CFG_MODE, QIE_DYNAMIC_BATCH, QIE_QUEUE=1 (queue instead of 429),
QIE_TRANSFER (yuv420 default, or rgb), QIE_WARMUP_STREAM, QIE_TINY_DECODER,
QIE_TINY_ENCODER, QIE_INT8, QIE_INT8_VL, QIE_INT4, QIE_INT4_VL, QIE_MAX_ROWS,
QIE_HTTP_LOG, QIE_CKPT_TRANSFORMER, QIE_CKPT_VAE, QIE_CKPT_VL, QIE_CKPT_LORA.
Without checkpoints the weights are random from seed 0; the checkpoints are
the port's converted format (``models/checkpoint.py convert``).
"""

from __future__ import annotations

import argparse
import json
import os
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from qwen_image_edit_streamdiffusion_tpu_torch.runtime.engine import (
    EngineBusy,
    InferenceEngine,
    InvalidRequest,
    ModelNotLoaded,
)

SERVER_NAME = "Qwen-Image-Edit-2509 API (GPU)"
CHECKPOINT_FLAGS = ("transformer", "vae", "vl", "lora")


class _Handler(BaseHTTPRequestHandler):
    engine: Optional[InferenceEngine] = None  # set by make_server
    protocol_version = "HTTP/1.1"

    # --- helpers -------------------------------------------------------

    def _send(self, code: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        # CORS: allow all, as the reference does
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Access-Control-Allow-Methods", "*")
        self.send_header("Access-Control-Allow-Headers", "*")
        self.end_headers()
        self.wfile.write(body)

    def _send_html(self, code: int, html: str) -> None:
        body = html.encode()
        self.send_response(code)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet by default
        if os.environ.get("QIE_HTTP_LOG"):
            super().log_message(fmt, *args)

    # --- routes --------------------------------------------------------

    def do_OPTIONS(self):  # CORS preflight
        self._send(200, {})

    def do_GET(self):
        if self.path == "/":
            self._send(200, {
                "name": SERVER_NAME,
                "endpoints": ["/health", "/edit", "/stream"],
                "status": "running",
            })
        elif self.path == "/health":
            self._send(200, self.engine.health())
        elif self.path in ("/ui", "/ui/"):
            from qwen_image_edit_streamdiffusion_tpu_torch.serving.webui import (
                INDEX_HTML,
            )

            self._send_html(200, INDEX_HTML)
        elif self.path == "/stream":
            from qwen_image_edit_streamdiffusion_tpu_torch.serving import ws

            if not ws.is_upgrade(self):
                self._send(426, {"detail": "websocket upgrade required "
                                           "(binary stream endpoint)"})
                return
            ws.handle_connection(self, self.engine)
        else:
            self._send(404, {"detail": "Not Found"})

    def do_POST(self):
        if self.path == "/profile/start" or self.path == "/profile/stop":
            try:
                if self.path.endswith("start"):
                    self._send(200, self.engine.start_trace())
                else:
                    self._send(200, self.engine.stop_trace())
            except RuntimeError as e:
                self._send(409, {"detail": str(e)})
            return
        if self.path != "/edit":
            self._send(404, {"detail": "Not Found"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            request = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            self._send(422, {"detail": f"invalid JSON body: {e}"})
            return
        if "image" not in request:
            self._send(422, {"detail": "field 'image' is required"})
            return
        # raw_response is the in-process transport flag (ws.py sets it to
        # skip base64); from untrusted JSON it would burn an inference only
        # to fail serializing the array
        request.pop("raw_response", None)
        try:
            self._send(200, self.engine.edit(request))
        except ModelNotLoaded as e:
            self._send(503, {"detail": str(e)})
        except EngineBusy as e:
            self._send(429, {"detail": str(e)})
        except InvalidRequest as e:  # request-field validation (ref_mode)
            self._send(422, {"detail": str(e)})
        except Exception as e:  # the reference's wrapped 500
            self._send(500, {"detail": str(e)})


def make_server(engine: InferenceEngine, host: str = "0.0.0.0",
                port: int = 8086) -> ThreadingHTTPServer:
    handler = type("Handler", (_Handler,), {"engine": engine})
    return ThreadingHTTPServer((host, port), handler)


def create_fastapi_app(engine: InferenceEngine):
    """A FastAPI app with the same routes, for deployments that have
    fastapi/uvicorn installed."""
    from fastapi import FastAPI, HTTPException
    from fastapi.middleware.cors import CORSMiddleware
    from pydantic import BaseModel

    app = FastAPI(title=SERVER_NAME)
    app.add_middleware(
        CORSMiddleware, allow_origins=["*"], allow_credentials=True,
        allow_methods=["*"], allow_headers=["*"],
    )

    class EditRequest(BaseModel):
        image: str
        prompt: str = "Transform into oil painting style"
        steps: int = 2
        ref_image: str | None = None
        blend_ratio: float = 0.5
        use_cfg: bool = False
        # "blend" (the reference) | "condition" (a second condition image)
        ref_mode: str = "blend"
        # temporal-latent streaming: requests sharing a session id reuse the
        # previous frame's latent (keyframes re-anchor)
        stream_session: str | None = None
        # with a session: submit this frame, return the previous one
        stream_pipeline: bool = False
        # extensions beyond the reference wire
        negative_prompt: str | None = None  # honoured only with use_cfg
        cfg_scale: float | None = None  # true_cfg_scale override
        seed: int = 42
        # N seed variations in one denoise call ("image" stays variation 0,
        # the extras arrive in "images")
        num_images: int = 1

    class EditResponse(BaseModel):
        image: str
        elapsed: float
        status: str
        images: list[str] | None = None
        batched_with: int | None = None
        stream_session: str | None = None
        keyframe: bool | None = None
        frame: int | None = None
        lag: int | None = None

    @app.get("/")
    async def root():
        return {"name": SERVER_NAME, "endpoints": ["/health", "/edit"],
                "status": "running"}

    @app.get("/health")
    async def health():
        return engine.health()

    @app.post("/edit", response_model=EditResponse)
    async def edit_image(request: EditRequest):
        import asyncio

        loop = asyncio.get_event_loop()
        try:
            return await loop.run_in_executor(
                None, engine.edit, request.model_dump()
            )
        except ModelNotLoaded as e:
            raise HTTPException(status_code=503, detail=str(e))
        except EngineBusy as e:
            raise HTTPException(status_code=429, detail=str(e))
        except InvalidRequest as e:
            raise HTTPException(status_code=422, detail=str(e))
        except Exception as e:
            raise HTTPException(status_code=500, detail=str(e))

    # exposed for schema-generating clients and the wire-contract test
    app.edit_request_model = EditRequest
    app.edit_response_model = EditResponse
    return app


def main(argv=None):
    ap = argparse.ArgumentParser(description=SERVER_NAME)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8086)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the pipeline (cuda, cuda:N or cpu)")
    ap.add_argument("--preset",
                    default=os.environ.get("QIE_PRESET",
                                           "qwen-image-edit-2509"))
    ap.add_argument("--steps", type=int,
                    default=int(os.environ.get("QIE_STEPS", "2")))
    # every request input is resized to input-size² while the output is
    # QIE_SIZE or area 1024²: the default request is a 512²-input edit
    ap.add_argument("--input-size", type=int,
                    default=int(os.environ.get("QIE_INPUT_SIZE", "512")))
    ap.add_argument("--cfg-mode",
                    choices=["none", "batched", "parallel", "sequential",
                             "rcfg", "rcfg-self"],
                    default=os.environ.get("QIE_CFG_MODE", "batched"),
                    help="how use_cfg=true requests run the negative branch")
    ap.add_argument("--dynamic-batch", type=int,
                    default=int(os.environ.get("QIE_DYNAMIC_BATCH", "0")),
                    help="max rows coalesced per denoise dispatch (0 = off: "
                         "concurrent requests get 429)")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--no-warmup-cfg", action="store_true",
                    help="skip the guided warm-up request")
    ap.add_argument("--warmup-stream", action="store_true",
                    default=os.environ.get("QIE_WARMUP_STREAM", "") == "1",
                    help="also warm a stream session at input_size²")
    for name in CHECKPOINT_FLAGS:
        ap.add_argument(f"--{name}",
                        default=os.environ.get(f"QIE_CKPT_{name.upper()}"),
                        help=f"{name} checkpoint: the port's converted format "
                             "(models/checkpoint.py convert); a LoRA .safetensors "
                             "for --lora. --transformer and --vae go together")
    ap.add_argument("--tiny-decoder",
                    default=os.environ.get("QIE_TINY_DECODER"),
                    help="distilled tiny output decoder artifact; implies "
                         "decoder='tiny'")
    ap.add_argument("--tiny-encoder",
                    default=os.environ.get("QIE_TINY_ENCODER"),
                    help="distilled tiny input encoder artifact (stream "
                         "temporal frames); implies encoder='tiny'")
    ap.add_argument("--int8", action="store_true",
                    default=os.environ.get("QIE_INT8", "") == "1")
    ap.add_argument("--int8-vl", action="store_true",
                    default=os.environ.get("QIE_INT8_VL", "") == "1")
    ap.add_argument("--int4", action="store_true",
                    default=os.environ.get("QIE_INT4", "") == "1")
    ap.add_argument("--int4-vl", action="store_true",
                    default=os.environ.get("QIE_INT4_VL", "") == "1")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                    help="torch.distributed backend under torchrun (default: "
                         "nccl on CUDA, gloo on the CPU)")
    args = ap.parse_args(argv)
    if any(getattr(args, n) for n in CHECKPOINT_FLAGS) and not (args.transformer
                                                                and args.vae):
        ap.error("serving a checkpoint needs both --transformer and --vae "
                 "(--vl and --lora optional)")

    from qwen_image_edit_streamdiffusion_tpu_torch.core.config import StreamConfig
    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime.engine import follow

    world = distributed.initialize(
        backend=args.dist_backend,
        device=None if args.device == "cuda" else args.device)
    mesh = None
    if world.world_size > 1:
        mesh = distributed.global_mesh(cfg_axis=1)

    size = os.environ.get("QIE_SIZE")
    config = StreamConfig(
        num_inference_steps=args.steps,
        model_preset=args.preset,
        width=int(size) if size else None,
        height=int(size) if size else None,
        # /edit delivers JPEG q90 4:2:0: ship 4:2:0 planes card → host,
        # half the transfer at the same wire fidelity
        transfer_format=os.environ.get("QIE_TRANSFER", "yuv420"),
        cfg_mode=args.cfg_mode,
        use_int8=args.int8, use_int8_vl=args.int8_vl,
        use_int4=args.int4, use_int4_vl=args.int4_vl,
        mesh_model_axis=world.world_size,
    )
    paths = dict(transformer_path=args.transformer, vae_path=args.vae,
                 vl_path=args.vl, lora_path=args.lora,
                 tiny_decoder_path=args.tiny_decoder,
                 tiny_encoder_path=args.tiny_encoder)
    print(f"Loading pipeline ({args.preset}) on {world.device}, rank "
          f"{world.rank} of {world.world_size}...", flush=True)
    if world.rank > 0:
        pipe = InferenceEngine.build_pipeline(args.preset, config, device=world.device,
                                              mesh=mesh, **paths)
        try:
            follow(pipe, mesh.world_group)
        finally:
            distributed.shutdown()
        return
    engine = InferenceEngine.create(
        args.preset, config=config,
        warmup_runs=0 if args.no_warmup else 1,
        warmup_cfg=False if args.no_warmup_cfg else None,
        warmup_stream=args.warmup_stream or None,
        input_size=args.input_size,
        dynamic_batch=args.dynamic_batch,
        device=world.device, mesh=mesh, **paths,
    )
    engine.queue_requests = os.environ.get("QIE_QUEUE", "") == "1"
    srv = make_server(engine, args.host, args.port)
    print(f"Ready. Serving on http://{args.host}:{srv.server_address[1]} "
          f"(endpoints: / /health /edit /stream; browser UI at /ui)", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
        if mesh is not None:
            engine.pipeline.shutdown()
            distributed.shutdown()


if __name__ == "__main__":
    main()
