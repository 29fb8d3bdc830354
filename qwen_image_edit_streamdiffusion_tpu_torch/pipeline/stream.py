"""StreamDiffusion-style realtime stream with temporal latent caching.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/pipeline/stream.py``
(the reference's ``qwen_realtime.py``), on one CUDA card:

- **keyframes** (every ``keyframe_interval`` processed frames): the full
  ``num_inference_steps`` denoise from fresh noise, the condition encoded by
  the full VAE;
- **temporal frames**: the previous frame's final latent, jittered by
  ``noise_strength`` and re-noised to σ at ``start = steps − max(1,
  steps // 2)`` (flow-matching forward process), runs only the tail of the
  schedule; with ``config.encoder="tiny"`` its condition goes through the
  tiny encoder;
- prompt conditioning is frozen once (:meth:`RealtimePipeline.precompute_conditions`,
  the positive and negative prompts as one encoder wave), never re-encoded a
  frame;
- a guided frame runs batched CFG, or ``rcfg`` / ``rcfg-self`` when that is
  the ``cfg_mode`` (``sequential`` and ``parallel`` run batched, as in the
  JAX stream's fused graph);
- the Stochastic Similarity Filter (``config.similarity_filter``) re-serves
  the last output for near-identical frames, with the JAX stream's
  ``np.random.default_rng(seed)`` draws, so its decisions are the same;
- hybrid resolution (``config.preview_scale`` s > 1): temporal frames run
  at 1/s the linear size and are upscaled (the JAX native library's
  Lanczos-3) on collection; a keyframe hands its latent off average-pooled
  s×s;
- :func:`submit_frames_batched`: several sessions' compatible frames as one
  multi-row dispatch, row r computed as session r alone.

PyTorch runs eagerly, so a frame is a sequence of launches on the card's
stream rather than one compiled graph. :meth:`RealtimePipeline.submit_frame`
queues a frame's work without waiting for the card: the frame reaches the
card through pinned memory with ``non_blocking=True`` (a resize, where one is
needed, runs on the host, as a resize on the card would have to fetch its
result back), the noise is drawn on the card from a per-frame generator, the
text rows are frozen on the card and the rope tables cached, so frame N + 1's
host work overlaps frame N's device work. Only :meth:`RealtimePipeline._collect`
fetches pixels, and only it waits.

Under a (cfg × model) mesh (a pipeline built with ``mesh=``) a frame runs
``EditPipeline._denoise`` tensor-parallel over the pipeline's model group
(and a multi-row dispatch's rows over its cfg groups); a guided frame stays
batched (or ``rcfg`` / ``rcfg-self``), never ``parallel``, as in the JAX
fused graph. Every rank makes the same calls: a stream driven on every rank
alike, or, behind the engine, rank 0's session mirrored on the other ranks
(``lockstep``, ``runtime/engine.py``): each call that does device work
(:meth:`RealtimePipeline.precompute_conditions`, a queued frame,
:func:`submit_frames_batched`) is broadcast before it runs, and a collect
after it; the similarity filter, the host fetch and the preview upscale
stay on rank 0, so a skipped frame is never sent.

Frames come in as (H, W, 3) uint8 arrays (a PIL image is accepted and
converted) and go out as (H, W, 3) uint8 arrays; PIL and cv2 are never
needed (``run_camera_loop`` imports cv2 lazily and streams a test pattern
without it).
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from qwen_image_edit_streamdiffusion_tpu_torch.core import imaging
from qwen_image_edit_streamdiffusion_tpu_torch.core.config import StreamConfig
from qwen_image_edit_streamdiffusion_tpu_torch.core.rng import frame_stream
from qwen_image_edit_streamdiffusion_tpu_torch.models import scheduler as sched
from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm
from qwen_image_edit_streamdiffusion_tpu_torch.models.text_encoder import encode_many
from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.edit_pipeline import (
    EditPipeline,
    _pad_rows,
)


class BatchPixels:
    """A dispatch's pixels, fetched to the host once and shared by every
    row's collector (and by the frames the similarity filter skips, which
    re-serve the same handle). On a card the copy to pinned host memory is
    queued right behind the decode, with an event after it: collecting waits
    for that event only, not for the frames queued since on the same
    stream (a plain ``.cpu()`` would wait for them too). ``tag``: the
    dispatch's number in its lockstep (None alone)."""

    __slots__ = ("pixels", "_ready", "_host", "tag")

    def __init__(self, pixels: torch.Tensor, tag: Optional[int] = None):
        self.tag = tag
        self._ready = None
        if pixels.device.type == "cuda":
            host = torch.empty(pixels.shape, dtype=pixels.dtype, pin_memory=True)
            host.copy_(pixels, non_blocking=True)
            self._ready = torch.cuda.Event()
            self._ready.record()
            pixels = host
        self.pixels = pixels
        self._host: Optional[List[np.ndarray]] = None

    @property
    def fetched(self) -> bool:
        return self._host is not None

    def fetch(self, pipe: EditPipeline) -> List[np.ndarray]:
        if self._host is None:
            if self._ready is not None:
                self._ready.synchronize()
            self._host = pipe._fetch_images(self.pixels)
            self.pixels = self._ready = None
        return self._host


def temporal_flicker(frames: Sequence[np.ndarray]) -> float:
    """Mean |frame_t − frame_{t−1}| over a sequence of outputs (uint8
    scale): 0 is a steady stream; higher is more frame-to-frame churn for
    the same input motion."""
    if len(frames) < 2:
        raise ValueError("need ≥2 frames")
    arrs = [np.asarray(f, np.float64) for f in frames]
    return float(np.mean([np.abs(x - y).mean() for x, y in zip(arrs[1:], arrs[:-1])]))


@dataclass
class RealtimePipeline:
    pipe: EditPipeline
    prompt: str = ""
    negative_prompt: Optional[str] = None
    prev_latent: Optional[torch.Tensor] = None  # (1, zh, zw, z) f32, on the card
    frame_count: int = 0
    is_keyframe: bool = True
    inference_times: List[float] = field(default_factory=list)
    # frozen prompt conditioning (precompute_conditions), on the card
    _frozen_txt: Optional[torch.Tensor] = None
    _frozen_mask: Optional[torch.Tensor] = None
    _frozen_neg_txt: Optional[torch.Tensor] = None
    _frozen_neg_mask: Optional[torch.Tensor] = None
    # Stochastic Similarity Filter state
    skipped_frames: int = 0
    _ssf_sig: Optional[np.ndarray] = None  # signature of the last processed frame
    _ssf_out: Optional[np.ndarray] = None  # last output (sequential path)
    _ssf_pixels: Optional[Tuple[BatchPixels, int]] = None  # last handle (pipelined)
    _ssf_streak: int = 0
    _ssf_rng: Optional[np.random.Generator] = None
    _preview_warned: bool = False
    _side_stream: Optional[object] = None  # the preview upscale's CUDA stream
    # rank 0's link to this session's mirror on the other ranks of a world
    # (runtime/engine.py::SessionLink); None: the session runs alone
    lockstep: Optional[object] = None

    @property
    def config(self) -> StreamConfig:
        return self.pipe.config

    @classmethod
    def create(cls, preset: str = "qwen-image-edit-2509",
               config: Optional[StreamConfig] = None, seed: int = 0,
               device="cuda", **kw) -> "RealtimePipeline":
        return cls(pipe=EditPipeline.create(preset, config=config, seed=seed,
                                            device=device, **kw))

    # ------------------------------------------------------------------

    def _lockstep_call(self, kind: str, fn, *args):
        """(``fn(*args)``, the dispatch's tag): alone, the call; under a
        ``lockstep`` link, broadcast to the mirrors first."""
        if self.lockstep is None:
            return fn(*args), None
        return self.lockstep.call(self, kind, fn, args)

    def precompute_conditions(self, prompt: str, negative_prompt: Optional[str] = None,
                              reference_image=None) -> None:
        """Encode and freeze the prompt conditioning on the card: the
        positive and (when given) negative prompt as one encoder wave, padded
        to one length (zero rows, False mask); text-only unless a reference
        image (resized to ``vl_image_area``) conditions it."""
        self._lockstep_call("precompute", self._precompute, prompt, negative_prompt,
                            reference_image)

    @torch.inference_mode()
    def _precompute(self, prompt: str, negative_prompt: Optional[str],
                    reference_image) -> None:
        self.prompt = prompt
        self.negative_prompt = negative_prompt
        p = self.pipe
        vl_images = []
        if reference_image is not None:
            arr = imaging.as_uint8_array(reference_image)
            lw, lh = imaging.calculate_dimensions(p.config.vl_image_area,
                                                  arr.shape[1] / arr.shape[0])
            vl_images = [imaging.resize(arr, lw, lh, "lanczos", p.device)]
        requests = [(prompt, vl_images)]
        if negative_prompt is not None:
            requests.append((negative_prompt, vl_images))
        embs = encode_many(p.encoder, requests)
        txt, mask = p._text_rows(embs[0])
        neg_txt, neg_mask = p._text_rows(embs[1]) if len(embs) > 1 else (txt, mask)
        length = max(txt.shape[1], neg_txt.shape[1])
        (self._frozen_txt, self._frozen_mask, self._frozen_neg_txt,
         self._frozen_neg_mask) = (_pad_rows(a, length)
                                   for a in (txt, mask, neg_txt, neg_mask))

    # ------------------------------------------------------------------

    def _next_is_keyframe(self) -> bool:
        """The next processed frame is a keyframe: every ``keyframe_interval``
        processed frames, and whenever no previous latent exists."""
        return self.frame_count % self.config.keyframe_interval == 0 or self.prev_latent is None

    def _refine_steps(self) -> int:
        return max(1, self.config.num_inference_steps // 2)

    def _preview_scale(self) -> int:
        """The validated hybrid-resolution factor (1 = off): width and height
        must be given and divisible by 16·s, so the keyframe's latent grid
        pools exactly s×s onto the preview grid; otherwise warn once and run
        full resolution."""
        s = int(self.config.preview_scale or 1)
        if s <= 1:
            return 1
        w, h = self.config.width, self.config.height
        if not w or not h or w % (16 * s) or h % (16 * s):
            if not self._preview_warned:
                warnings.warn(
                    f"preview_scale={s} requires explicit width/height "
                    f"divisible by {16 * s} (got {w}x{h}); running full "
                    "resolution every frame")
                self._preview_warned = True
            return 1
        return s

    def _frame_noise(self, kind: str, shape: Tuple[int, ...], frame_index: int):
        """The frame's noise, f32 on the card, from the generator of
        (seed, "temporal", frame_index): ``(ε,)`` for a keyframe, ``(jitter,
        ε)`` for a temporal frame. Each session draws its own rows."""
        device = self.pipe.device
        g = frame_stream(self.config.seed, "temporal", frame_index, device)
        n = 1 if kind == "key" else 2
        return tuple(torch.randn(shape, generator=g, dtype=torch.float32, device=device)
                     for _ in range(n))

    def _condition_image(self, arr: np.ndarray, preview: bool):
        """(out_h, out_w, condition image) of a frame: the preview grid and
        the frame resized onto it; else the output size (config, or
        area-``vae_image_area`` at the frame's aspect) and the frame resized
        to area ``vae_image_area`` (the edit path's rules). Resized on the
        host (Pillow's LANCZOS, bit for bit)."""
        cfgc = self.config
        if preview:
            s = self._preview_scale()
            out_w, out_h = cfgc.width // s, cfgc.height // s
            return out_h, out_w, imaging.resize(arr, out_w, out_h, "lanczos")
        aspect = arr.shape[1] / arr.shape[0]
        vw, vh = imaging.calculate_dimensions(cfgc.vae_image_area, aspect)
        out_w, out_h = cfgc.width or vw, cfgc.height or vh
        return out_h, out_w, imaging.resize(arr, vw, vh, "lanczos")

    def _run_frames(self, kind: str, images: List[np.ndarray], prev, noises,
                    txt, mask, neg_txt, neg_mask, out_hw: Tuple[int, int],
                    steps: int, use_cfg: bool, prev_pool: int = 1):
        """One frame dispatch of len(images) rows: encode (full VAE, or the
        tiny encoder on temporal frames) → x0 (fresh noise, or the re-noised
        previous latents) → denoise (the tail on temporal frames) → decode.
        Returns (device pixels, f32 latents), the latents pooled s×s when
        ``prev_pool`` = s > 1."""
        p, cfgc = self.pipe, self.config
        start = 0 if kind == "key" else steps - self._refine_steps()
        zh, zw = out_hw[0] // 8, out_hw[1] // 8
        params = p._encode_params_for(kind)
        cond = p._encode_pixels(images, "full" if params is p.vae_params else "tiny", params)
        czh, czw = images[0].shape[0] // 8, images[0].shape[1] // 8
        img_shapes = ((1, zh // 2, zw // 2), (1, czh // 2, czw // 2))
        if kind == "key":
            x = noises[0]
        else:
            jitter, eps = noises
            sigma = sched.make_schedule(steps, (zh // 2) * (zw // 2),
                                        p.preset.scheduler).sigmas[start]
            ns = float(np.float32(cfgc.noise_strength))
            x = sched.scale_noise(prev.float() + ns * jitter, eps, sigma)
        x0 = tfm.pack_latents(x).to(p._mdt)
        # a guided frame runs batched CFG unless cfg_mode is a residual mode
        mode = ("none" if not use_cfg else cfgc.cfg_mode
                if cfgc.cfg_mode in ("rcfg", "rcfg-self") else "batched")
        final = p._denoise(x0, cond, txt, mask, img_shapes, steps, mode, neg_txt,
                           neg_mask, cfgc.true_cfg_scale, start_step=start)
        pixels, z = p._decode(final, zh, zw)
        if prev_pool > 1:  # keyframe → preview handoff
            s = prev_pool
            z = z.reshape(z.shape[0], zh // s, s, zw // s, s, z.shape[-1]).mean((2, 4))
        return pixels, z

    # ------------------------------------------------------------------

    def process_frame(self, frame) -> np.ndarray:
        """Edit one camera frame and return it (the sequential path). A frame
        the similarity filter skips re-serves the last output; the keyframe
        cadence counts processed frames."""
        t0 = time.time()
        cfgc = self.config
        if self._ssf_should_skip(frame, self._ssf_out is not None):
            self.skipped_frames += 1
            return self._ssf_out
        out = self._collect((self._queue_frame(frame, cfgc.num_inference_steps), 0))
        self.inference_times.append(time.time() - t0)
        if cfgc.similarity_filter:
            self._ssf_out = out
        return out

    @torch.inference_mode()
    def submit_frame(self, frame):
        """Queue one frame's work on the card without waiting for it and
        return its handle for :meth:`_collect` (pipelined streaming: the host
        prepares frame N + 1 while the card runs frame N). ``prev_latent``
        becomes the frame's in-flight latent, so the next temporal frame
        depends on it on the card's stream. A similarity skip returns the
        last handle again."""
        cfgc = self.config
        if self._ssf_should_skip(frame, self._ssf_pixels is not None):
            self.skipped_frames += 1
            return self._ssf_pixels
        handle = (self._queue_frame(frame, cfgc.num_inference_steps), 0)
        if cfgc.similarity_filter:
            self._ssf_pixels = handle
        return handle

    def _queue_frame(self, frame, steps: int) -> BatchPixels:
        """A processed frame's dispatch (the prompt frozen first where it is
        not), broadcast to the mirrors under a lockstep link."""
        if self._frozen_txt is None:
            self.precompute_conditions(self.prompt, self.negative_prompt)
        pixels, tag = self._lockstep_call("advance", self._advance,
                                          imaging.as_uint8_array(frame), steps)
        return BatchPixels(pixels, tag)

    def _advance(self, frame: np.ndarray, steps: int) -> torch.Tensor:
        """Queue the next processed frame (a keyframe by the cadence) and
        count it; its pixels on the card."""
        self.is_keyframe = self._next_is_keyframe()
        pixels = self._submit_fused(frame, steps)
        self.frame_count += 1
        return pixels

    @torch.inference_mode()
    def _submit_fused(self, frame, steps: int) -> torch.Tensor:
        """Queue one frame (keyframe or temporal, by ``is_keyframe``) and
        return its pixels on the card; updates ``prev_latent``."""
        cfgc = self.config
        preview = self._preview_scale() > 1 and not self.is_keyframe
        out_h, out_w, image = self._condition_image(imaging.as_uint8_array(frame), preview)
        use_cfg = self.negative_prompt is not None and cfgc.true_cfg_scale > 1.0
        kind = "key" if self.is_keyframe else "temporal"
        zshape = (1, out_h // 8, out_w // 8, self.pipe.preset.vae.latent_channels)
        pixels, latents = self._run_frames(
            kind, [image], self.prev_latent, self._frame_noise(kind, zshape, self.frame_count),
            self._frozen_txt, self._frozen_mask, self._frozen_neg_txt,
            self._frozen_neg_mask, (out_h, out_w), steps, use_cfg,
            prev_pool=self._preview_scale() if self.is_keyframe else 1)
        self.prev_latent = latents
        return pixels

    @torch.inference_mode()
    def _collect(self, handle) -> np.ndarray:
        """The frame of a handle as an (H, W, 3) uint8 array: fetched (once
        per dispatch), and a preview frame upscaled to the display size on
        the pipeline's device, with the Lanczos-3 of the JAX stream's native
        library (``imaging.resize_native``). The only step of the stream that
        waits for the card; under a lockstep link the mirrors wait for their
        copy of the dispatch too (once a dispatch)."""
        if not isinstance(handle, tuple):
            handle = (BatchPixels(handle), 0)
        bp, row = handle
        if self.lockstep is not None and bp.tag is not None and not bp.fetched:
            self.lockstep.collect(bp.tag)
        img = bp.fetch(self.pipe)[row]
        w, h = self.config.width, self.config.height
        if self._preview_scale() > 1 and img.shape[:2] != (h, w):
            img = self._upscale(img, w, h)
        return img

    def _upscale(self, img: np.ndarray, w: int, h: int) -> np.ndarray:
        """A preview frame to the display size on the pipeline's device; on a
        card on a stream of its own, so it does not wait for the frames
        queued on the main stream."""
        device = self.pipe.device
        if device.type != "cuda":
            return imaging.resize_native(img, w, h, device)
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(device)
        with torch.cuda.stream(self._side_stream):
            return imaging.resize_native(img, w, h, device)

    # ------------------------------------------------------------------
    # Stochastic Similarity Filter (StreamDiffusion §3.3)
    # ------------------------------------------------------------------

    def _ssf_should_skip(self, frame, have_output: bool = True) -> bool:
        """True when this frame re-serves the previous output: the
        mean-centred cosine similarity of its 32×32 luma signature to the
        last processed frame's exceeds τ, a Bernoulli((sim − τ)/(1 − τ)) draw
        fires and fewer than ``similarity_max_skip`` frames were skipped in a
        row."""
        cfg = self.config
        if not cfg.similarity_filter:
            return False
        sig = imaging.luma_signature(imaging.as_uint8_array(frame)).astype(np.float32).ravel()
        sig = sig - sig.mean()
        prev = self._ssf_sig
        if prev is None or not have_output:
            self._ssf_sig = sig
            return False
        denom = float(np.linalg.norm(sig) * np.linalg.norm(prev)) + 1e-8
        sim = float(np.dot(sig, prev)) / denom
        tau = min(cfg.similarity_threshold, 1.0 - 1e-6)
        prob = max(0.0, (sim - tau) / (1.0 - tau))
        if self._ssf_rng is None:
            self._ssf_rng = np.random.default_rng(cfg.seed)
        skip = (prob > 0.0 and self._ssf_streak < cfg.similarity_max_skip
                and float(self._ssf_rng.random()) < prob)
        if skip:
            self._ssf_streak += 1
        else:
            self._ssf_sig = sig
            self._ssf_streak = 0
        return skip

    # ------------------------------------------------------------------

    def warmup(self, runs: int = 3, size: Optional[int] = None) -> None:
        """Run keyframe and temporal frames on a gray image (at least two),
        then reset the stream's state."""
        w = self.config.width or size or 512
        h = self.config.height or size or 512
        img = imaging.make_test_image(w, h, "gray")
        for _ in range(max(2, runs)):
            self._ssf_sig = self._ssf_out = None  # never skip a warm-up frame
            self.process_frame(img)
        self.frame_count = 0
        self.prev_latent = None
        self.inference_times.clear()
        self.skipped_frames = 0
        self._ssf_sig = self._ssf_out = self._ssf_pixels = None
        self._ssf_streak = 0

    def get_stats(self) -> Dict:
        """Rolling 30-frame stats."""
        if not self.inference_times:
            return {}
        avg = float(np.mean(self.inference_times[-30:]))
        stats = {"avg_inference_time": avg, "fps": (1.0 / avg) if avg > 0 else 0.0,
                 "frame_count": self.frame_count, "keyframe": self.is_keyframe}
        if self.config.similarity_filter:
            stats["skipped_frames"] = self.skipped_frames
        return stats

    def run_benchmark(self, num_frames: int = 20, pipelined: bool = True,
                      output_path: Optional[str] = "benchmark_output.png") -> float:
        """Frame-loop benchmark on the gradient test image; returns fps.
        ``pipelined`` submits frame N + 1 before collecting frame N (one frame
        of latency); else each frame is processed to the host in turn. The
        last frame is written to ``output_path`` (a PNG) unless it is None."""
        w = self.config.width or 512
        h = self.config.height or 512
        img = imaging.make_test_image(w, h, "gradient")
        out = None
        t_start = time.time()
        if pipelined:
            pending = None
            for _ in range(num_frames):
                nxt = self.submit_frame(img)
                if pending is not None:
                    out = self._collect(pending)
                pending = nxt
            out = self._collect(pending)
            total = time.time() - t_start
            fps = num_frames / total
            print(f"[Benchmark] {num_frames} frames pipelined: "
                  f"{total / num_frames:.3f}s/frame → {fps:.2f} fps")
        else:
            times = []
            for _ in range(num_frames):
                t0 = time.time()
                out = self.process_frame(img)
                times.append(time.time() - t0)
            avg = float(np.mean(times))
            fps = 1.0 / avg if avg else 0.0
            print(f"[Benchmark] {num_frames} frames: {avg:.3f}s ± "
                  f"{float(np.std(times)):.3f}s → {fps:.2f} fps")
        if out is not None and output_path:
            imaging.write_png(output_path, out)
        return fps

    def run_camera_loop(self, max_frames: Optional[int] = None,
                        pipelined: bool = True) -> None:
        """The webcam loop: camera ``config.camera_id`` through cv2 (imported
        here, shown in two windows with a stats overlay), or the animated
        sine test pattern, printed frame by frame, when there is no cv2 or
        no camera. ``pipelined`` overlaps frame N + 1's host work with frame
        N's device work (one frame of display latency)."""
        try:
            import cv2
            cap = cv2.VideoCapture(self.config.camera_id)
            have_cv = cap.isOpened()
        except Exception:
            cv2 = None
            cap = None
            have_cv = False

        w = self.config.width or 512
        h = self.config.height or 512
        interval = 1.0 / self.config.target_fps
        n = 0
        last = time.time()
        pending = None
        pending_src = None
        try:
            while max_frames is None or n < max_frames:
                if have_cv:
                    ok, bgr = cap.read()
                    if not ok:
                        break
                    frame = np.ascontiguousarray(bgr[:, :, ::-1])
                else:
                    frame = imaging.make_test_image(w, h, "sine")
                if pipelined:
                    t0 = time.time()
                    # no dispatch for a frame that would never be shown
                    is_final = max_frames is not None and n == max_frames - 1
                    nxt = None if is_final and pending is not None else self.submit_frame(frame)
                    if pending is None:  # prime: collect on the next turn
                        pending, pending_src = nxt, frame
                        continue
                    out = self._collect(pending)
                    self.inference_times.append(time.time() - t0)
                    frame, (pending, pending_src) = pending_src, (nxt, frame)
                else:
                    out = self.process_frame(frame)
                stats = self.get_stats()
                if have_cv and cv2 is not None:
                    disp = np.ascontiguousarray(out[:, :, ::-1])
                    for j, line in enumerate([f"FPS: {stats.get('fps', 0):.1f}",
                                              f"Steps: {self.config.num_inference_steps}",
                                              f"Frame: {self.frame_count}"]):
                        cv2.putText(disp, line, (10, 30 + 30 * j),
                                    cv2.FONT_HERSHEY_SIMPLEX, 1, (0, 255, 0), 2)
                    cv2.imshow("Original", np.ascontiguousarray(frame[:, :, ::-1]))
                    cv2.imshow("Qwen Real-time Edit (CUDA)", disp)
                    if cv2.waitKey(1) & 0xFF == ord("q"):
                        break
                else:
                    print(f"frame {n}: {stats}")
                n += 1
                dt = time.time() - last
                if dt < interval:
                    time.sleep(interval - dt)
                last = time.time()
        finally:
            # drain the frame in flight on an early exit
            if pending is not None:
                try:
                    self._collect(pending)
                except Exception:
                    pass
            if have_cv and cap is not None:
                cap.release()
                if cv2 is not None:
                    cv2.destroyAllWindows()


def _session_signature(sess: RealtimePipeline):
    c = sess.config
    return (c.width, c.height, c.num_inference_steps, c.transfer_format,
            c.noise_strength, c.true_cfg_scale,
            sess.negative_prompt is not None and c.true_cfg_scale > 1.0)


@torch.inference_mode()
def submit_frames_batched(sessions: List[RealtimePipeline], frames: list) -> list:
    """Queue several sessions' frames as ONE multi-row dispatch (cross-session
    batching): each row keeps its session's frozen prompts, previous latent
    and per-frame noise, so row r computes what session r alone would.

    The sessions must share the pipeline's params and agree on frame kind
    (keyframe or temporal), steps, CFG-ness, output geometry, transfer
    format, noise strength and CFG scale, and none may run a preview
    (``preview_scale`` > 1); else ``ValueError``. The similarity filter is
    not applied. Returns one ``(BatchPixels, row)`` handle per session for
    :meth:`RealtimePipeline._collect` (the first collector fetches the whole
    batch once); each session's state advances as if it had dispatched
    alone."""
    if len(sessions) != len(frames):
        raise ValueError("one frame per session required")
    if len(sessions) == 1:
        return [sessions[0].submit_frame(frames[0])]
    lead = sessions[0]
    p = lead.pipe
    sig0, kf0 = _session_signature(lead), lead._next_is_keyframe()
    for sess in sessions[1:]:
        if sess.pipe.tfm_params is not p.tfm_params:
            raise ValueError("batched sessions must share pipeline params")
        if _session_signature(sess) != sig0 or sess._next_is_keyframe() != kf0:
            raise ValueError(
                f"incompatible session for batched dispatch: {_session_signature(sess)}/"
                f"kf={sess._next_is_keyframe()} != {sig0}/kf={kf0}")
    for sess in sessions:
        if sess._preview_scale() > 1:
            raise ValueError("preview_scale sessions cannot batch "
                             "(temporal grid differs from keyframe grid)")
    frames = [imaging.as_uint8_array(f) for f in frames]
    images, out_hw = [], None
    for sess, frame in zip(sessions, frames):
        out_h, out_w, image = sess._condition_image(frame, False)
        if out_hw is None:
            out_hw = (out_h, out_w)
        elif (out_h, out_w) != out_hw or image.shape != images[0].shape:
            raise ValueError("batched sessions must share image geometry")
        images.append(image)
    for sess in sessions:
        if sess._frozen_txt is None:
            sess.precompute_conditions(sess.prompt, sess.negative_prompt)
    if lead.lockstep is None:
        bp = _dispatch_batched(sessions, images, out_hw, kf0, sig0)
    else:
        bp, tag = lead.lockstep.call_batched(
            sessions, frames, lambda: _dispatch_batched(sessions, images, out_hw, kf0, sig0))
        bp.tag = tag
    return [(bp, r) for r in range(len(sessions))]


def _dispatch_batched(sessions: List[RealtimePipeline], images: List[np.ndarray],
                      out_hw: Tuple[int, int], kf0: bool, sig0: tuple) -> BatchPixels:
    """The multi-row dispatch of :func:`submit_frames_batched`, validated:
    the sessions' condition images at one output size ``out_hw``."""
    lead = sessions[0]
    p = lead.pipe
    kind = "key" if kf0 else "temporal"
    rows = {k: [] for k in ("noise", "prev", "txt", "mask", "ntxt", "nmask")}
    for sess in sessions:
        zshape = (1, out_hw[0] // 8, out_hw[1] // 8, p.preset.vae.latent_channels)
        rows["noise"].append(sess._frame_noise(kind, zshape, sess.frame_count))
        rows["prev"].append(sess.prev_latent)
        for key, a in (("txt", sess._frozen_txt), ("mask", sess._frozen_mask),
                       ("ntxt", sess._frozen_neg_txt), ("nmask", sess._frozen_neg_mask)):
            rows[key].append(a)
    # the rows' text buckets may differ: pad to the longest (masked rows are inert)
    length = max(a.shape[1] for key in ("txt", "ntxt") for a in rows[key])
    txt, mask, ntxt, nmask = (torch.cat([_pad_rows(a, length) for a in rows[key]])
                              for key in ("txt", "mask", "ntxt", "nmask"))
    noises = tuple(torch.cat(parts) for parts in zip(*rows["noise"]))
    prev = None if kf0 else torch.cat(rows["prev"])
    pixels, latents = lead._run_frames(kind, images, prev, noises, txt, mask, ntxt,
                                       nmask, out_hw, sig0[2], sig0[-1])
    for r, sess in enumerate(sessions):
        sess.prev_latent = latents[r:r + 1]
        sess.frame_count += 1
        sess.is_keyframe = kf0
    return BatchPixels(pixels)
