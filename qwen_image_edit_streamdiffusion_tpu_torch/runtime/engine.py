"""Inference engine: request processing, single-flight concurrency, stats.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/runtime/engine.py``, with
the same names, request fields, response fields and errors, serving the port's
``EditPipeline`` and ``RealtimePipeline`` on one CUDA card (or the CPU):

- the busy check and the claim are one atomic ``Lock.acquire(blocking=False)``
  (the reference's ``is_processing`` check-then-act, made atomic); with
  ``queue_requests`` requests wait on the lock instead of getting 429;
- ``dynamic_batch`` > 1: cross-request batching, leader/follower over the
  lock (:meth:`InferenceEngine._edit_dynamic`), and cross-session batching of
  stream frames (:meth:`InferenceEngine._edit_stream_dynamic`);
- a ``stream_session`` id serves ``/edit`` through a per-session
  ``RealtimePipeline`` (LRU-bounded), ``stream_pipeline`` with lag-1
  overlap of the card's work with the wire.

The wire lives here and in ``serving/``; the pipelines take and give arrays.
A request's parse (base64 and JPEG/PNG decode in ``core/codec.py``, the
``ref_image`` blend and the input resize) runs on the host: device work
outside the lock would queue behind the leader's dispatch. Under dynamic
batching a request parses before it queues for the lock; a plain ``/edit``
parses under the lock, as the JAX engine does, so a busy server answers 429
without decoding. The response's JPEG encode runs after the lock is released
(the JAX engine encodes under it), so the card takes the next request while
the host encodes; a dynamic batch's members each encode their own image in
their own thread. Device work, the launch counters of ``runtime/kernels.py``
and the pipeline's caches are touched only while the lock is held.

Under a world of several ranks (``serving/server.py`` started by
``torchrun``) every rank holds the pipeline's slices: rank 0 runs this
engine and the HTTP server, and its pipeline is a :class:`LockstepPipeline`
that broadcasts each call that does device work to the other ranks, which
run :func:`follow`. The single-flight lock, the 429, the codec and the
trace stay on rank 0. Stream sessions run there too: each session of rank 0
has a :class:`SessionLink`, through which it broadcasts its prompt
encodes, its queued frames, its collects and its multi-session dispatches
(``pipeline/stream.py``), and each follower keeps a mirror of the session
(:class:`_StreamMirror`) that makes the same calls. The similarity filter
decides on rank 0 alone (a skipped frame is not sent), and the host fetch
and the preview upscale run there only; a follower waits for its copy of
a frame when rank 0 collects it, and drops it. An evicted session, or one
whose websocket closed (:meth:`InferenceEngine.end_session`), ends on
every rank. A closed socket's session ends under the device lock when it
is free, else as its holder releases it; a request that finds a teardown
holding the lock waits for it instead of getting 429.

Not ported: the JAX package's device watchdog (its dispatch deadline and
probe thread answer a wedged accelerator link), so there is no
``DeviceUnavailable``.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from qwen_image_edit_streamdiffusion_tpu_torch.core import codec, imaging
from qwen_image_edit_streamdiffusion_tpu_torch.core.config import StreamConfig

# where /profile/stop writes its Chrome trace unless a directory is given
TRACE_DIR = str(Path(__file__).resolve().parents[2] / "build" / "trace")


class EngineBusy(Exception):
    """Another request holds the card (HTTP 429)."""


class InvalidRequest(ValueError):
    """A request field failed validation (HTTP 422). Distinct from a bare
    ValueError, so decode errors keep the reference's wrapped-500 contract."""


class ModelNotLoaded(Exception):
    """Pipeline not constructed yet (HTTP 503)."""


class _Pending:
    """A parsed edit request waiting to be coalesced into a batched
    dispatch (dynamic batching; see InferenceEngine._edit_dynamic)."""

    __slots__ = ("item", "key", "start", "event", "result", "error")

    def __init__(self, item: Dict[str, Any], key: tuple, start: float):
        self.item = item
        self.key = key
        self.start = start
        self.event = threading.Event()
        self.result: Optional[Dict[str, Any]] = None
        self.error: Optional[BaseException] = None


@dataclass
class InferenceEngine:
    pipeline: Optional[Any] = None  # EditPipeline
    # every request's input is resized to input_size² before the pipeline
    # (the reference resizes to 512² whatever the output size)
    input_size: int = 512
    default_steps: int = 2
    # warm the guided variant too (the first use_cfg request's kernels and
    # allocations then come warm)
    warmup_cfg: bool = True
    # also prime a stream session (keyframe + temporal frame at input_size²)
    warmup_stream: bool = False
    # False (reference parity): concurrent requests get 429. True: requests
    # queue on the lock and run serially (QIE_QUEUE=1 in serving).
    queue_requests: bool = False
    # > 1: requests that arrive while the card is busy queue, and compatible
    # ones (same steps, CFG-ness, cfg scale, condition-image count) coalesce
    # into ONE denoise dispatch of up to this many rows when it frees; no
    # timer: the batching window is the previous dispatch. Implies queue
    # semantics. Server: --dynamic-batch / QIE_DYNAMIC_BATCH.
    dynamic_batch: int = 0
    # cap on the rows one request may dispatch (num_images; QIE_MAX_ROWS);
    # with dynamic batching on, min(max_rows, dynamic_batch)
    max_rows: int = 8
    _batch_queue: list = field(default_factory=list)
    _bq_lock: threading.Lock = field(default_factory=threading.Lock)
    # temporal-latent stream sessions (requests carrying `stream_session`),
    # LRU-evicted beyond this
    max_stream_sessions: int = 4
    _sessions: Dict[str, Any] = field(default_factory=dict)
    # per-session in-flight frame handle of stream_pipeline=true requests
    _session_pending: Dict[str, Any] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    # sessions ended while the device lock was held, not yet dropped; the
    # teardowns under way (each may hold the device lock) and those done
    _ended: set = field(default_factory=set)
    _teardown: threading.Condition = field(default_factory=threading.Condition)
    _tearing: int = 0
    _teardowns: int = 0
    total_requests: int = 0
    last_elapsed: Optional[float] = None

    # ------------------------------------------------------------------

    @classmethod
    def create(
        cls,
        preset: str = "qwen-image-edit-2509",
        config: Optional[StreamConfig] = None,
        seed: int = 0,
        warmup_runs: int = 1,
        warmup_cfg: Optional[bool] = None,
        warmup_stream: Optional[bool] = None,
        input_size: Optional[int] = None,
        dynamic_batch: Optional[int] = None,
        transformer_path: Optional[str] = None,
        vae_path: Optional[str] = None,
        vl_path: Optional[str] = None,
        lora_path: Optional[str] = None,
        device="cuda",
        mesh=None,
        **kw,
    ) -> "InferenceEngine":
        """Build the serving pipeline on ``device`` (:meth:`build_pipeline`),
        then warm it up. Under a ``mesh`` of several ranks this is rank 0's
        engine: its pipeline is a :class:`LockstepPipeline` over the world,
        and every other rank must have built its own with
        :meth:`build_pipeline` and run :func:`follow` (the warm-up is
        already a broadcast call)."""
        pipe = cls.build_pipeline(preset, config, seed, transformer_path, vae_path,
                                  vl_path, lora_path, device, mesh, **kw)
        if mesh is not None and mesh.size > 1:
            pipe = LockstepPipeline(pipe, mesh.world_group)
        if warmup_cfg is None:
            warmup_cfg = os.environ.get("QIE_WARMUP_CFG", "1") == "1"
        if warmup_stream is None:
            warmup_stream = os.environ.get("QIE_WARMUP_STREAM", "0") == "1"
        if input_size is None:
            input_size = int(os.environ.get("QIE_INPUT_SIZE", "512"))
        if dynamic_batch is None:
            dynamic_batch = int(os.environ.get("QIE_DYNAMIC_BATCH", "0"))
        eng = cls(pipeline=pipe,
                  default_steps=pipe.config.num_inference_steps,
                  warmup_cfg=warmup_cfg, warmup_stream=warmup_stream,
                  input_size=input_size, dynamic_batch=dynamic_batch,
                  max_rows=int(os.environ.get("QIE_MAX_ROWS", "8")))
        if warmup_runs:
            eng.warmup(runs=warmup_runs)
        return eng

    @staticmethod
    def build_pipeline(preset: str = "qwen-image-edit-2509",
                       config: Optional[StreamConfig] = None, seed: int = 0,
                       transformer_path: Optional[str] = None,
                       vae_path: Optional[str] = None,
                       vl_path: Optional[str] = None,
                       lora_path: Optional[str] = None, device="cuda", mesh=None,
                       **kw):
        """The serving pipeline: with ``transformer_path`` and ``vae_path``
        from converted checkpoints (``EditPipeline.from_checkpoint``;
        ``vl_path`` and ``lora_path`` optional), else with random weights
        from ``seed`` (``kw``: the tiny decoder and encoder paths, and
        ``EditPipeline.create``'s); this rank's slices under ``mesh``."""
        from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.edit_pipeline import (
            EditPipeline,
        )

        if transformer_path or vae_path or vl_path or lora_path:
            if not (transformer_path and vae_path):
                raise ValueError(
                    "checkpoint serving needs BOTH transformer_path and "
                    "vae_path (vl_path/lora_path optional)")
            return EditPipeline.from_checkpoint(
                transformer_path, vae_path, preset=preset, config=config,
                vl_path=vl_path, lora_path=lora_path, device=device, mesh=mesh, **kw)
        return EditPipeline.create(preset, config=config, seed=seed, device=device,
                                   mesh=mesh, **kw)

    def warmup(self, runs: int = 1) -> None:
        """Serve the standard request (and its guided variant when
        ``warmup_cfg``) on a gray input_size² image, then the multi-row
        batches and the stream when enabled; prints each phase's seconds."""
        if self.pipeline is None:
            raise ModelNotLoaded("no pipeline")
        t0 = time.monotonic()
        self.pipeline.warmup(height=self.input_size, width=self.input_size,
                             steps=self.default_steps, runs=runs,
                             cfg=self.warmup_cfg)
        print(f"[warmup] requests ({self.input_size}², "
              f"{self.default_steps} steps"
              f"{', +CFG' if self.warmup_cfg else ''}): "
              f"{time.monotonic() - t0:.1f}s")
        if self.dynamic_batch > 1:
            t0 = time.monotonic()
            self._warmup_row_buckets()
            print(f"[warmup] multi-row batches (≤{self.dynamic_batch}): "
                  f"{time.monotonic() - t0:.1f}s")
        if self.warmup_stream:
            t0 = time.monotonic()
            self._warmup_stream_graphs()
            print(f"[warmup] stream: {time.monotonic() - t0:.1f}s")

    def _warmup_row_buckets(self) -> None:
        """Serve the multi-row batches dynamic batching dispatches ({2, 4,
        ...} ≤ dynamic_batch, cond-only, and guided when warmup_cfg)."""
        s = self.input_size
        img = imaging.make_test_image(s, s, "gray")
        prompt = "Transform into oil painting style"
        b = 2
        while b <= self.dynamic_batch:
            t0 = time.monotonic()
            items = [{"image": img, "prompt": prompt, "seed": i}
                     for i in range(b)]
            self.pipeline.edit_many(items,
                                    num_inference_steps=self.default_steps)
            if self.warmup_cfg:
                cfg_items = [dict(it, negative_prompt="") for it in items]
                self.pipeline.edit_many(
                    cfg_items, num_inference_steps=self.default_steps)
            print(f"[warmup]   edit rows={b}: "
                  f"{time.monotonic() - t0:.1f}s")
            b *= 2

    def _new_session(self, sid: str, scfg: StreamConfig) -> Any:
        """A stream session on this engine's pipeline params and caches, with
        ``scfg``; under a :class:`LockstepPipeline`, linked to its mirrors."""
        from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.stream import (
            RealtimePipeline,
        )

        pipe, link = self.pipeline, None
        if isinstance(pipe, LockstepPipeline):
            pipe, link = pipe._pipe, SessionLink(pipe, sid)
        return RealtimePipeline(pipe=dataclasses.replace(pipe, config=scfg),
                                lockstep=link)

    def _drop_session(self, sid: str) -> None:
        """Forget a session (its in-flight frame too), on every rank."""
        sess = self._sessions.pop(sid, None)
        self._session_pending.pop(sid, None)
        if sess is not None and sess.lockstep is not None:
            sess.lockstep.end()

    def end_session(self, sid: str) -> None:
        """End the stream session ``sid`` (a closed websocket's) under the
        device lock, on every rank of a world: now if the lock is free, else
        as its holder releases it. A request never fails for it: one that
        finds the lock held by a teardown waits for it."""
        with self._teardown:
            self._ended.add(sid)
        self._end_sessions()

    def _end_sessions(self) -> None:
        """Drop the ended sessions while the device lock is free to take.
        Counted as a teardown from before its claim to after its release,
        so that a request refused the lock meanwhile waits and tries again
        (:meth:`_acquire_device`)."""
        with self._teardown:
            self._tearing += 1
        try:
            # an end marked while the lock was held here is dropped on the
            # next turn; one marked while a request holds it, on its release
            while self._ended and self._lock.acquire(blocking=False):
                try:
                    while True:
                        with self._teardown:
                            if not self._ended:
                                break
                            sid = self._ended.pop()
                        self._drop_session(sid)
                finally:
                    self._lock.release()
        finally:
            with self._teardown:
                self._tearing -= 1
                self._teardowns += 1
                self._teardown.notify_all()

    def _warmup_stream_graphs(self) -> None:
        """Run a throwaway stream session (keyframe, then a temporal frame,
        cond-only at input_size² × default_steps, built as `_edit_stream`
        builds one) and, with dynamic batching, multi-session batched frames.
        The sessions share this engine's pipeline params and caches, and end
        after."""
        from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.stream import (
            submit_frames_batched,
        )

        s = self.input_size
        scfg = self.pipeline.config.replace(
            width=s, height=s, num_inference_steps=self.default_steps)
        sess = self._new_session("warmup-0", scfg)
        sess.precompute_conditions("warmup")
        img = imaging.make_test_image(s, s, "gradient")
        t0 = time.monotonic()
        sess.process_frame(img)  # keyframe
        print(f"[warmup]   stream keyframe: {time.monotonic() - t0:.1f}s")
        t0 = time.monotonic()
        sess.process_frame(img)  # temporal frame
        print(f"[warmup]   stream temporal frame: {time.monotonic() - t0:.1f}s")
        sessions = [sess]
        if self.dynamic_batch > 1:
            cap = min(self.dynamic_batch, self.max_stream_sessions)
            b = 2
            while b <= cap:
                t0 = time.monotonic()
                group = []
                for _ in range(b):
                    s2 = self._new_session(f"warmup-{len(sessions)}", scfg)
                    s2.precompute_conditions("warmup")
                    s2.process_frame(img)  # past the keyframe
                    group.append(s2)
                    sessions.append(s2)
                handles = submit_frames_batched(group, [img] * b)
                group[0]._collect(handles[0])
                print(f"[warmup]   stream rows={b}: "
                      f"{time.monotonic() - t0:.1f}s")
                b *= 2
        for s2 in sessions:
            if s2.lockstep is not None:
                s2.lockstep.end()

    # ------------------------------------------------------------------

    def _acquire_device(self, blocking: bool) -> bool:
        """Claim the single-flight device lock: atomically (→ False when a
        request holds it) or waiting for it. A session teardown that held
        it when the claim failed, or ended since, is waited out and the
        claim made again."""
        while True:
            with self._teardown:
                done = self._teardowns
            if self._lock.acquire(blocking=blocking):
                return True
            with self._teardown:
                if not self._tearing and self._teardowns == done:
                    return False
                self._teardown.wait_for(lambda: not self._tearing)

    def _release_device(self) -> None:
        self._lock.release()
        if self._ended:
            self._end_sessions()

    def _join_leader_queue(self, entry: _Pending) -> bool:
        """Dynamic-batching follower path: block until this thread holds
        the device lock, then run the leader body (→ True; the caller then
        ``_release_device``s). A leader that served ``entry`` meanwhile has
        set its event; the body then only releases."""
        return self._acquire_device(blocking=True)

    def edit(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Process one EditRequest dict → EditResponse dict.

        Fields: image (base64 JPEG/PNG, or an array from a binary
        transport), prompt, steps, ref_image, blend_ratio, use_cfg, and the
        extensions ref_mode ("blend": blend the two images into one input;
        "condition": the ref image as a second condition image),
        negative_prompt, cfg_scale, seed, num_images, stream_session,
        stream_pipeline.
        """
        if self.pipeline is None:
            raise ModelNotLoaded("Model not loaded")
        if self.dynamic_batch > 1:
            if request.get("stream_session"):
                return self._edit_stream_dynamic(request)
            return self._edit_dynamic(request)
        if not self._acquire_device(self.queue_requests):
            raise EngineBusy("Server is busy processing another request")
        try:
            start = time.time()
            sid = request.get("stream_session")
            if sid:
                resp = self._edit_stream(str(sid), request, start)
            else:
                item = self._parse_edit(request)
                result = self.pipeline(
                    item["image"],
                    item["prompt"],
                    negative_prompt=item["negative_prompt"],
                    num_inference_steps=item["num_inference_steps"],
                    true_cfg_scale=item["true_cfg_scale"],
                    seed=item["seed"],
                    num_images_per_prompt=item["num_images"],
                )
                resp = self._response(item, result, start)
        finally:
            self._release_device()
        return self._encode(resp, bool(request.get("raw_response")))

    def _parse_edit(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Validate and normalize an /edit request into a pipeline item (the
        dict ``EditPipeline.edit_many`` takes), on the host.

        use_cfg passes an empty negative prompt (true CFG); without it the
        edit is cond-only. An explicit negative_prompt is honoured only with
        use_cfg; cfg_scale overrides true_cfg_scale; seed defaults to 42;
        num_images asks for N seed variations in one denoise call ("image"
        stays variation 0, the rest ride in "images"). Explicit None values
        mean the default. Binary transports pass arrays and set
        ``raw_response`` to get arrays back."""
        img = codec.to_array(request["image"])
        prompt = request.get("prompt", "Transform into oil painting style")
        steps = int(request.get("steps", self.default_steps))
        use_cfg = bool(request.get("use_cfg", False))

        s = self.input_size
        extra_images = []
        ref_b64 = request.get("ref_image")
        if ref_b64:
            ref_mode = request.get("ref_mode", "blend")
            if ref_mode not in ("blend", "condition"):
                # a typo must not run a different edit with HTTP 200
                raise InvalidRequest(
                    f"ref_mode must be 'blend' or 'condition', "
                    f"got {ref_mode!r}")
            ref = codec.to_array(ref_b64)
            if ref_mode == "condition":
                extra_images = [imaging.resize(ref, s, s)]
            else:
                img = imaging.blend(
                    imaging.resize(img, s, s),
                    imaging.resize(ref, s, s),
                    float(request.get("blend_ratio", 0.5)),
                )

        img = imaging.resize(img, s, s)
        cfg_scale = request.get("cfg_scale")
        seed = request.get("seed")
        cap = (min(self.max_rows, self.dynamic_batch)
               if self.dynamic_batch > 1 else self.max_rows)
        return {
            "image": [img] + extra_images,
            "prompt": prompt,
            "negative_prompt": (str(request.get("negative_prompt") or "")
                                if use_cfg else None),
            "num_inference_steps": steps,
            "true_cfg_scale": (None if cfg_scale is None
                               else float(cfg_scale)),
            "seed": 42 if seed is None else int(seed),
            "num_images": max(1, min(int(request.get("num_images") or 1),
                                     cap)),
            "raw_response": bool(request.get("raw_response")),
        }

    def _response(self, item: Dict[str, Any], result: Any, start: float,
                  batched_with: Optional[int] = None) -> Dict[str, Any]:
        """The response of a served item, its images still arrays
        (:meth:`_encode` makes them JPEG once the lock is released)."""
        elapsed = time.time() - start
        self.total_requests += 1
        self.last_elapsed = elapsed
        resp = {
            "image": result.images[0],
            "elapsed": elapsed,
            "status": "success",
        }
        if item["num_images"] > 1:
            # extras only: variation 0 is already in "image"
            resp["images"] = list(result.images[1:])
        if batched_with is not None and batched_with > 1:
            # how many requests shared the denoise dispatch
            resp["batched_with"] = batched_with
        return resp

    @staticmethod
    def _encode(resp: Dict[str, Any], raw: bool) -> Dict[str, Any]:
        """A response's images as base64 JPEG (q90), unless the transport
        takes arrays (``raw``). Called with the device lock released."""
        if not raw:
            resp["image"] = codec.to_base64_jpeg(resp["image"])
            if "images" in resp:
                resp["images"] = [codec.to_base64_jpeg(im) for im in resp["images"]]
        return resp

    def _edit_dynamic(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Cross-request batching (dynamic_batch > 1).

        Leader/follower over the device lock: every request parses up front,
        enqueues, then blocks on the lock. Whoever holds it leads: it drains
        the queued requests with the same compatibility key (steps, CFG-ness,
        cfg scale, condition-image count; up to dynamic_batch rows), takes
        the longest prefix whose rows are an exact batch of 1, 2, 4, 8 or 16,
        runs it as ONE ``EditPipeline.edit_many`` and publishes each result
        through its entry's event. A woken follower whose entry was served
        returns; one left behind leads the next dispatch."""
        start = time.time()
        item = self._parse_edit(request)
        key = (item["num_inference_steps"],
               item["negative_prompt"] is not None,
               item["true_cfg_scale"],
               len(item["image"]))
        entry = _Pending(item, key, start)
        with self._bq_lock:
            self._batch_queue.append(entry)
        if self._join_leader_queue(entry):
            try:
                if not entry.event.is_set():
                    with self._bq_lock:
                        self._batch_queue.remove(entry)
                        cands, rows = [entry], [item["num_images"]]
                        for other in list(self._batch_queue):
                            if sum(rows) >= self.dynamic_batch:
                                break
                            o_rows = other.item["num_images"]
                            if (other.key == entry.key
                                    and sum(rows) + o_rows
                                    <= self.dynamic_batch):
                                cands.append(other)
                                rows.append(o_rows)
                        # the longest prefix of an exact batch size; the
                        # rest leads the next dispatch right away
                        best = 1
                        for i in range(1, len(cands) + 1):
                            if sum(rows[:i]) in (1, 2, 4, 8, 16):
                                best = i
                        batch = cands[:best]
                        for e in batch[1:]:
                            self._batch_queue.remove(e)
                    try:
                        results = self.pipeline.edit_many(
                            [e.item for e in batch],
                            num_inference_steps=item["num_inference_steps"],
                            true_cfg_scale=item["true_cfg_scale"],
                        )
                        for e, res in zip(batch, results):
                            e.result = self._response(
                                e.item, res, e.start, batched_with=len(batch))
                    except BaseException as exc:
                        for e in batch:
                            e.error = exc
                    finally:
                        for e in batch:
                            e.event.set()
            finally:
                self._release_device()
        if entry.error is not None:
            # a fresh exception per waiter: K threads re-raising one shared
            # instance would mutate its __traceback__ concurrently
            raise RuntimeError(
                f"batched dispatch failed: {entry.error}") from entry.error
        return self._encode(entry.result, item["raw_response"])

    def _edit_stream_dynamic(self, request: Dict[str, Any]
                             ) -> Dict[str, Any]:
        """`stream_session` requests under dynamic batching: queue semantics
        plus cross-session frame batching. Requests parse on the host,
        enqueue and block on the lock; the holder drains every queued stream
        entry and serves them (:meth:`_serve_stream_entries`): compatible
        temporal frames of different sessions as one multi-row dispatch
        (``submit_frames_batched``), keyframes, similarity-filter and
        preview sessions, and further frames of one session on their own,
        within the same lock hold."""
        start = time.time()
        sid = str(request.get("stream_session"))
        img, pipelined = self._parse_stream_request(request)
        entry = _Pending(
            {"request": request, "sid": sid, "img": img,
             "pipelined": pipelined},
            ("stream", sid), start)
        with self._bq_lock:
            self._batch_queue.append(entry)
        if self._join_leader_queue(entry):
            try:
                if not entry.event.is_set():
                    with self._bq_lock:
                        drained = [e for e in self._batch_queue
                                   if e.key[0] == "stream"]
                        for e in drained:
                            self._batch_queue.remove(e)
                    self._serve_stream_entries(drained)
            finally:
                self._release_device()
        if entry.error is not None:
            raise RuntimeError(
                f"stream dispatch failed: {entry.error}") from entry.error
        return self._encode(entry.result, bool(request.get("raw_response")))

    def _serve_stream_entries(self, entries: list) -> None:
        """Serve drained stream entries in waves, one frame of a session a
        wave (frame N + 1 re-noises frame N's latent: they cannot share a
        dispatch)."""
        remaining = list(entries)
        while remaining:
            wave, defer, seen = [], [], set()
            for e in remaining:
                if e.item["sid"] in seen:
                    defer.append(e)
                else:
                    seen.add(e.item["sid"])
                    wave.append(e)
            self._serve_stream_wave(wave)
            remaining = defer

    def _serve_stream_wave(self, wave: list) -> None:
        """One frame per session: resolve sessions, group batchable
        temporal frames by compatibility, dispatch groups as multi-row
        frames and the rest one by one."""
        groups: Dict[tuple, list] = {}
        singles = []
        for e in wave:
            try:
                sess = self._resolve_stream_session(
                    e.item["sid"], e.item["request"])
            except BaseException as exc:
                e.error = exc
                e.event.set()
                continue
            c = sess.config
            kf = (sess.frame_count % c.keyframe_interval == 0
                  or sess.prev_latent is None)
            if kf or c.similarity_filter or sess._preview_scale() > 1:
                # keyframes are 1 in keyframe_interval and rarely aligned
                # across sessions; SSF decides per frame
                singles.append((e, sess))
                continue
            gkey = (c.num_inference_steps,
                    sess.negative_prompt is not None
                    and c.true_cfg_scale > 1.0,
                    c.true_cfg_scale, c.noise_strength,
                    c.transfer_format, c.width, c.height)
            groups.setdefault(gkey, []).append((e, sess))
        for items in groups.values():
            while items:
                # an exact batch size, as _edit_dynamic takes
                n = min(len(items), self.dynamic_batch)
                take = max(b for b in (1, 2, 4, 8, 16) if b <= n)
                batch, items = items[:take], items[take:]
                self._dispatch_stream_batch(batch)
        for e, sess in singles:
            self._serve_stream_one(e, sess)

    def _dispatch_stream_batch(self, batch: list) -> None:
        if len(batch) == 1:
            self._serve_stream_one(*batch[0])
            return
        from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import (
            stream as stream_mod,
        )

        try:
            handles = stream_mod.submit_frames_batched(
                [s for _, s in batch], [e.item["img"] for e, _ in batch])
        except BaseException as exc:
            for e, _ in batch:
                e.error = exc
                e.event.set()
            return
        for (e, sess), h in zip(batch, handles):
            try:
                e.result = self._serve_stream_frame(
                    e.item["sid"], sess, e.item["img"],
                    e.item["pipelined"], e.start, handle=h,
                    batched_with=len(batch))
            except BaseException as exc:
                e.error = exc
            finally:
                e.event.set()

    def _serve_stream_one(self, e: _Pending, sess: Any) -> None:
        try:
            e.result = self._serve_stream_frame(
                e.item["sid"], sess, e.item["img"], e.item["pipelined"],
                e.start)
        except BaseException as exc:
            e.error = exc
        finally:
            e.event.set()

    def _edit_stream(self, sid: str, request: Dict[str, Any],
                     start: float) -> Dict[str, Any]:
        """`/edit` with a `stream_session` id: temporal-latent streaming over
        the same wire. A per-session ``RealtimePipeline`` shares this
        engine's params and caches: its first frame (and every
        keyframe_interval-th) runs the full schedule from fresh noise, the
        frames between re-noise the previous latent and run only the tail.
        The output is input_size² (same-size img2img), unlike the
        sessionless area-1024² edit.

        Changing prompt/use_cfg mid-session re-freezes the prompt
        conditioning and keeps the temporal latent. ref_mode="condition" is
        refused. Sessions are LRU-bounded at max_stream_sessions. Responses
        carry `stream_session`, `keyframe`, `frame`.

        `stream_pipeline=true` overlaps the card's work with the wire: the
        request submits its frame and returns the PREVIOUS frame's pixels
        (`lag` 1); the session's first request returns its own (`lag` 0)
        and keeps it pending, so the next request re-serves it once.
        """
        img, pipelined = self._parse_stream_request(request)
        sess = self._resolve_stream_session(sid, request)
        return self._serve_stream_frame(sid, sess, img, pipelined, start)

    def _parse_stream_request(self, request: Dict[str, Any]):
        """Host prep of a stream-session request (decode, optional ref
        blend, resize): no session or device state touched, so dynamic
        batching runs it in the requesting thread before it enqueues."""
        img = codec.to_array(request["image"])
        s = self.input_size
        if request.get("ref_image"):
            ref_mode = request.get("ref_mode", "blend")
            if ref_mode != "blend":
                raise InvalidRequest(
                    "stream_session supports ref_mode='blend' only (the "
                    "stream path conditions on the live frame itself)")
            ref = codec.to_array(request["ref_image"])
            img = imaging.blend(
                imaging.resize(img, s, s), imaging.resize(ref, s, s),
                float(request.get("blend_ratio", 0.5)),
            )
        img = imaging.resize(img, s, s)
        return img, bool(request.get("stream_pipeline"))

    def _resolve_stream_session(self, sid: str, request: Dict[str, Any]):
        """Look up or create the session and sync it to the request's steps
        and prompt conditioning. Touches the LRU table and may run a prompt
        encode: call with the device lock held."""
        prompt = request.get("prompt", "Transform into oil painting style")
        steps = int(request.get("steps", self.default_steps))
        use_cfg = bool(request.get("use_cfg", False))
        s = self.input_size

        sess = self._sessions.pop(sid, None)
        if sess is None:
            while len(self._sessions) >= self.max_stream_sessions:
                self._drop_session(next(iter(self._sessions)))
            scfg = self.pipeline.config.replace(
                width=s, height=s, num_inference_steps=steps)
            sess = self._new_session(sid, scfg)
        self._sessions[sid] = sess  # (re)insert = LRU most recent

        if sess.config.num_inference_steps != steps:
            sess.pipe.config = sess.config.replace(
                num_inference_steps=steps)
        negative = (str(request.get("negative_prompt") or "")
                    if use_cfg else None)
        if (sess._frozen_txt is None or sess.prompt != prompt
                or sess.negative_prompt != negative):
            sess.precompute_conditions(prompt, negative)
        return sess

    def _serve_stream_frame(self, sid: str, sess: Any, img: Any,
                            pipelined: bool, start: float,
                            handle: Any = None,
                            batched_with: Optional[int] = None,
                            ) -> Dict[str, Any]:
        """Submit/collect one session frame and build its response, the
        image still an array (:meth:`_encode` makes it JPEG).
        ``handle`` set: the frame was already submitted as a row of a
        multi-session batch; only its collection remains."""
        lag = None
        if pipelined:
            t0 = time.time()
            if handle is None:
                handle = sess.submit_frame(img)
            prev = self._session_pending.get(sid)
            if prev is None:
                # prime: return the own frame but keep it pending, so the
                # next request enters the steady lag-1 overlap
                out, lag = sess._collect(handle), 0
            else:
                out, lag = sess._collect(prev), 1
            self._session_pending[sid] = handle
            sess.inference_times.append(time.time() - t0)
        else:
            # a session switching pipelined → sync drops its in-flight
            # frame; its latent already chained on the card
            self._session_pending.pop(sid, None)
            if handle is not None:
                t0 = time.time()
                out = sess._collect(handle)
                sess.inference_times.append(time.time() - t0)
            else:
                out = sess.process_frame(img)
        elapsed = time.time() - start
        self.total_requests += 1
        self.last_elapsed = elapsed
        resp = {
            "image": out,
            "elapsed": elapsed,
            "status": "success",
            "stream_session": sid,
            "keyframe": bool(sess.is_keyframe),
            "frame": sess.frame_count,
        }
        if lag is not None:
            resp["lag"] = lag
        if batched_with is not None and batched_with > 1:
            resp["batched_with"] = batched_with
        return resp

    # ------------------------------------------------------------------
    # Profiling: a torch.profiler trace (CPU, and the card's kernels when
    # there is one) written as a Chrome trace into log_dir on stop. The
    # profiler must start and stop on one thread, and the server answers
    # /profile/start and /profile/stop on two, so a thread of its own holds
    # it open.
    # ------------------------------------------------------------------

    _trace_dir: Optional[str] = None
    _trace: Optional[Dict[str, Any]] = None
    _trace_lock: threading.Lock = field(default_factory=threading.Lock)

    def start_trace(self, log_dir: str = TRACE_DIR) -> Dict[str, Any]:
        from torch.profiler import ProfilerActivity, profile

        with self._trace_lock:
            if self._trace_dir is not None:
                raise RuntimeError(f"trace already running → {self._trace_dir}")
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(log_dir, exist_ok=True)
            trace = {"started": threading.Event(), "stop": threading.Event(),
                     "path": os.path.join(log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}"
                                                   f"_{os.getpid()}.json")}

            def hold():
                try:
                    with profile(activities=activities) as prof:
                        trace["started"].set()
                        trace["stop"].wait()
                    prof.export_chrome_trace(trace["path"])
                except Exception as e:  # reported by stop_trace
                    trace["error"] = e
                finally:
                    trace["started"].set()

            trace["thread"] = threading.Thread(target=hold, name="qie-trace", daemon=True)
            trace["thread"].start()
            trace["started"].wait()
            if "error" in trace:
                raise RuntimeError(f"profiler failed to start: {trace['error']}")
            self._trace, self._trace_dir = trace, log_dir
            return {"status": "tracing", "log_dir": log_dir}

    def stop_trace(self) -> Dict[str, Any]:
        with self._trace_lock:
            if self._trace_dir is None:
                raise RuntimeError("no trace running")
            trace, d = self._trace, self._trace_dir
            self._trace, self._trace_dir = None, None
            trace["stop"].set()
            trace["thread"].join()
            if "error" in trace:
                raise RuntimeError(f"profiler failed: {trace['error']}")
            return {"status": "stopped", "log_dir": d, "trace": trace["path"]}

    # ------------------------------------------------------------------

    def health(self) -> Dict[str, Any]:
        """The reference's /health fields; ``gpu_memory`` is the bytes
        PyTorch holds allocated on the pipeline's card ("N/A" on the CPU)."""
        mem = "N/A"
        device = getattr(self.pipeline, "device", None)
        if device is not None and device.type == "cuda":
            mem = f"{torch.cuda.memory_allocated(device) / 1e9:.2f} GB"
        return {
            "status": "ok",
            "model_loaded": self.pipeline is not None,
            "optimized": f"cuda flash-attn ({self.default_steps}-step)",
            "inference_time": (
                f"{self.last_elapsed:.2f}s" if self.last_elapsed else "n/a"
            ),
            "gpu_memory": mem,
            "requests": self.total_requests,
        }


class LockstepPipeline:
    """Rank 0's handle on a pipeline that every rank of a world holds a
    slice of. Each call that does device work (``__call__``, ``edit_many``,
    ``warmup``) is first broadcast over ``group`` (the world) as one object,
    its method name and arguments, so that every other rank, in
    :func:`follow`, makes the same call in the same order: the caches then
    take the same hit or miss, the generators draw the same noise, and the
    collectives of the sharded forward meet. A dynamic batch's
    ``edit_many`` is one such call. Any other attribute reads the pipeline
    itself.

    The engine validates a request before its pipeline call, so a call that
    raises here is a fault (a device error, an out-of-memory), and the other
    ranks may be waiting in a collective that rank 0 left. The handle then
    ends the process group, so that their waits fail at once rather than at
    the group's timeout, and refuses every later call."""

    def __init__(self, pipe: Any, group: Any):
        self._pipe, self._group = pipe, group
        self._failed: Optional[str] = None
        self._dispatches = 0  # stream dispatches sent, their tags

    def _run(self, what: str, msg: Any, fn) -> Any:
        """Broadcast ``msg``, then ``fn()``; a raise ends the world."""
        from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed

        if self._failed is not None:
            raise RuntimeError(f"the ranks are out of step since {self._failed}; "
                               "restart the world")
        try:
            distributed.broadcast_object(msg, self._group)
            return fn()
        except BaseException as e:
            self._failed = f"rank 0's {what} raised {type(e).__name__}: {e}"
            distributed.shutdown()
            raise

    def _call(self, method: str, args: tuple, kwargs: dict) -> Any:
        return self._run(method, (method, args, kwargs),
                         lambda: getattr(self._pipe, method)(*args, **kwargs))

    def _stream(self, msg: "StreamMsg", fn) -> Tuple[Any, Optional[int]]:
        """A stream call: (``fn()``, its dispatch tag, for a dispatch)."""
        tag = None
        if msg.kind in DISPATCHES:
            self._dispatches += 1
            tag = self._dispatches
        return self._run(f"stream {msg.kind}", msg, fn), tag

    def __call__(self, *args, **kwargs):
        return self._call("__call__", args, kwargs)

    def edit_many(self, *args, **kwargs):
        return self._call("edit_many", args, kwargs)

    def warmup(self, *args, **kwargs):
        return self._call("warmup", args, kwargs)

    def shutdown(self) -> None:
        """End the followers' loops (nothing to end after a failed call: the
        process group is gone)."""
        from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed

        if self._failed is None:
            distributed.broadcast_object(None, self._group)

    def __getattr__(self, name: str) -> Any:
        return getattr(self._pipe, name)


class StreamMsg(NamedTuple):
    """A stream call broadcast by rank 0: ``kind`` (``precompute``,
    ``advance``, ``batched``, ``collect``, ``end``), the session id (the
    ids, for ``batched``), its config (the configs) and the arguments."""

    kind: str
    sid: Any
    config: Any
    args: tuple


# the stream calls that queue a frame: numbered alike on every rank
DISPATCHES = ("advance", "batched")


class SessionLink:
    """Rank 0's link from one stream session (``RealtimePipeline.lockstep``)
    to its mirrors on the other ranks, over a :class:`LockstepPipeline`."""

    def __init__(self, lockstep: LockstepPipeline, sid: str):
        self.lockstep, self.sid = lockstep, sid

    def call(self, sess: Any, kind: str, fn, args: tuple) -> Tuple[Any, Optional[int]]:
        """Broadcast the session's call, then run it: (result, tag)."""
        return self.lockstep._stream(StreamMsg(kind, self.sid, sess.config, args),
                                     lambda: fn(*args))

    def call_batched(self, sessions: list, frames: list, fn) -> Tuple[Any, Optional[int]]:
        return self.lockstep._stream(
            StreamMsg("batched", [s.lockstep.sid for s in sessions],
                      [s.config for s in sessions], (frames,)), fn)

    def collect(self, tag: int) -> None:
        """Rank 0 collects dispatch ``tag``: the mirrors wait for theirs."""
        self.lockstep._stream(StreamMsg("collect", self.sid, None, (tag,)), lambda: None)

    def end(self) -> None:
        self.lockstep._stream(StreamMsg("end", self.sid, None, ()), lambda: None)


class _StreamMirror:
    """A follower's stream sessions, mirrored from rank 0's broadcasts: a
    ``RealtimePipeline`` a session id, each dispatch's device event until
    rank 0 collects it."""

    def __init__(self, pipe: Any):
        self.pipe = pipe
        self.sessions: Dict[str, Any] = {}
        self.pending: Dict[int, Tuple[tuple, Any]] = {}  # tag → (sids, event)
        self.dispatches = 0

    def _session(self, sid: str, config: StreamConfig) -> Any:
        from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.stream import (
            RealtimePipeline,
        )

        sess = self.sessions.get(sid)
        if sess is None:
            sess = self.sessions[sid] = RealtimePipeline(
                pipe=dataclasses.replace(self.pipe, config=config))
        elif sess.pipe.config != config:
            sess.pipe.config = config
        return sess

    def _dispatched(self, sids: tuple) -> None:
        self.dispatches += 1
        event = None
        if self.pipe.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self.pending[self.dispatches] = (sids, event)

    def handle(self, msg: StreamMsg) -> None:
        from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import stream

        if msg.kind == "precompute":
            self._session(msg.sid, msg.config)._precompute(*msg.args)
        elif msg.kind == "advance":
            self._session(msg.sid, msg.config)._advance(*msg.args)
            self._dispatched((msg.sid,))
        elif msg.kind == "batched":
            sessions = [self._session(sid, cfg) for sid, cfg in zip(msg.sid, msg.config)]
            stream.submit_frames_batched(sessions, *msg.args)
            self._dispatched(tuple(msg.sid))
        elif msg.kind == "collect":
            _, event = self.pending.pop(msg.args[0], ((), None))
            if event is not None:
                event.synchronize()
        elif msg.kind == "end":
            self.sessions.pop(msg.sid, None)
            for tag in [t for t, (sids, _) in self.pending.items() if msg.sid in sids]:
                del self.pending[tag]
        else:
            raise ValueError(f"unknown stream message {msg.kind!r}")


def follow(pipe: Any, group: Any) -> int:
    """The loop of a rank > 0: make each call that rank 0's
    :class:`LockstepPipeline` broadcasts, and drop its result, until the
    shutdown message; a stream call goes to this rank's mirror of the
    session (:class:`_StreamMirror`). Returns the number of calls made. A
    call that raises ends the loop with its exception: the rank fails (and
    with it the world, under torchrun), since a rank that raised mid-forward
    has left collectives that the others wait in."""
    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed

    calls = 0
    mirror = _StreamMirror(pipe)
    while True:
        msg = distributed.broadcast_object(None, group)
        if msg is None:
            return calls
        if isinstance(msg, StreamMsg):
            mirror.handle(msg)
        else:
            method, args, kwargs = msg
            getattr(pipe, method)(*args, **kwargs)
        calls += 1
