#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the CUDA
toolkit. Phases, each printing one JSON line:

1. device  — the card's name and ``nvidia-smi`` name/power limit;
2. build   — compiles ``qwen_image_edit_streamdiffusion_tpu_torch/csrc`` with
             nvcc (sm_90a) and loads it; per kernel symbol, the HGMMA and
             IGMMA (bf16 and s8 wgmma) and UTMALDG (TMA) instructions of its
             SASS, its spill bytes and whether ptxas serialised its wgmmas:
             the forward (K1/K4/K7 and the causal K2 instance), both backward
             kernels (K8, K9), the conv (K3) and the int8 GEMM's wgmma body
             (K6) must show both, no spills and no serialisation;
   resize  — the request's resizes (1024² → 384² LANCZOS, 384² → 392²
             BICUBIC) timed on the host and on the card: first call, a new
             size in a warm process, warm; the card's bytes must equal the
             host's;
   inputs  — real inputs on the card's host (no Pillow, no transformers):
             the committed codec fixtures (``tests/fixtures/codec``:
             progressive JPEG, Adam7 and 16-bit PNG, CMYK, YCCK and RGB-coded
             JPEG, BMP at 8 and 24 bits and RLE8, an interlaced GIF, lossy
             WebP with and without alpha, lossless WebP) decoded to their
             manifest's SHA-256 of Pillow's bytes; the decode ms of a 1024²
             progressive JPEG and of the same image as baseline, and of a
             1024² image in each new format (CMYK, YCCK and RGB-coded JPEG,
             BMP, RLE8 BMP and GIF written here without Pillow and held to
             their sources; lossy and lossless WebP committed); a full-size
             Qwen2-layout tokenizer.json (``write_qwen2_tokenizer``: 151 643
             base ids, 22 added) written, its load ms, PROMPT's encode ms
             (cold and cached) and ids, and the chat template's ms; the same
             tokenizer as vocab.json + merges.txt + tokenizer_config.json,
             its load ms and PROMPT's and the template's ids, equal to the
             tokenizer.json form's;
3. kernels — each hand-written kernel against its plain PyTorch version at the
             main path's shapes: max-abs error against the stated tolerance,
             the median CUDA-event time of both and of the one PyTorch call
             that computes the same function (SDPA, cuDNN's conv), and the
             bound: the larger of bytes over HBM rate and operations over the
             tensor-core peak, with its share of the kernel's time
             (``bound_share``). K2 (L = 128, 384, 1024; both CTA tiles,
             64 and 128 query rows, checked and timed) and K3 (every shape
             of the VAE's mix) are timed on device time alone (``graph_ms``:
             one miss's launches in a CUDA graph, replayed), beside the
             per-call time (``wall_ms``), and so is their library call; the
             K3 mix prints its summed device ms a miss against its bound and
             cuDNN's. K7-K9 run at the train shape
             (2, 24, 8448, 128); K7's O must equal K1's bit for bit, masked
             keys must get exactly zero dK and dV, and a backward that takes
             exp2 of the bf16-rounded argument must fail the K8/K9 limit.
             Then the two-row shapes of guided and batched edits: K1 at
             (2, 24, 8448, 128) with two text masks, K2 at (2, 28/4, 384,
             128) with two real lengths, K3 at (2, 1024², 96→96);
4. block parity — a 2-block MMDiT at flagship width, one forward at the 1024²
             edit shape, ``use_flash_attention`` True (kernels) vs False
             (plain), held to a relative L2 tolerance; then the same blocks
             with rank-16 adapters: loss and every adapter gradient, kernels
             (K7-K9) vs plain attention under autograd; and one distillation
             step on them (the teacher's v* on K1, the student on K7-K9),
             unguided and guided, against the same step on plain attention;
5. slice   — the flagship ``qwen-image-edit-2509`` pipeline (60-layer MMDiT,
             7B VL encoder in path, full VAE; random weights from seed 0)
             answers a warm-up, two cache-miss and two cache-hit 1024²
             2-step cond-only edits, then one edit with two 1024² condition
             images (joint length ≈ 12.7k: the streaming role, K4). Each
             request prints its wall seconds, kernel launch counts, output
             shape and peak memory; K1 (or K4 for two images) must run 120
             times per request, K2 28 times per cache miss and 0 per hit, K3
             20 times a miss, 15 a hit and 25 with two images; then two more misses, one timed plainly and one
             under torch.profiler (device time by kernel kind, busy seconds,
             idle share = 1 - busy / the plain miss's wall);
   guided  — on the same bf16 pipeline: guided edits (negative prompt "",
             scale 4) in every cfg_mode — batched miss (K1 120 at 2 rows, K2
             28 at 2 rows: the pos+neg wave is one LM call) and hit,
             parallel hit (the batched hit's latents), sequential (K1 240),
             rcfg (60 at 2 rows, 60 at 1), rcfg-self (120 at 1); a negative
             prompt in the 320-token text bucket; a two-image batched edit
             (K4's role at 2 rows); ``num_images_per_prompt=2`` (K3's decode
             at batch 2) and ``edit_many`` of two items (K1 at 4 rows, one
             batched condition encode); a plain rcfg-self miss, a plain and
             a profiled miss each of batched and sequential. Each request
             prints the rows of every K1/K4, K2 and K3 call (a spy around
             the wrappers) and they are asserted;
   tiny    — the trained tiny decoder and encoder artifacts loaded into the
             live pipeline; two cache-hit edits decoded by the tiny decoder (K3
             0: its chain is F.conv2d, as the JAX chain is XLA); a profiled
             hit with each decoder; the decode stage alone, tiny and full;
             the tiny decode on the card against the CPU (rel-L2
             TINY_TOL); the tiny decoder's conv shapes graph-timed through
             cuDNN and through K3;
   stream  — the realtime stream (``pipeline/stream.py``) on the same
             pipeline, as the JAX suite's bench_stream: 512², 2 steps, a
             keyframe every 10 frames, yuv420, prompts frozen once (K2 28 in
             ``precompute_conditions`` at (1, 128), 0 a frame); warm-up; a
             keyframe (K1 120, K3 20) and a temporal frame (K1 60, K3 20)
             checked call by call; a keyframe and a temporal
             ``submit_frame`` under ``set_sync_debug_mode("error")`` and
             torch.profiler, each with the card held by a device-side spin
             before the frame's pixel pack (``scripts/sync_hold.cu``), must
             return before the host releases it, with no runtime call that
             waits for the card and no pageable copy in their host window
             (a planted blocking pageable upload must show there, and a
             planted submit that waits for its own pixels must meet the
             hold's time-out); sequential and pipelined ``run_benchmark``
             (12 frames: s/frame, fps, keyframes and temporal frames timed
             apart) and a profiled pipelined run;
             then a guided rcfg-self stream (K1 at 1 row, K2 over the pos+neg
             wave at 2 rows), the trained tiny pair (temporal frames K3 0,
             keyframes 5), ``preview_scale=2`` at 1024² (1024² keyframes
             pooling their latent onto the 512² temporal grid), the
             similarity filter on a static frame (skips bounded by
             ``similarity_max_skip``), two sessions as one batched dispatch
             (K1 at 2 rows, one host fetch, each row's latents within
             STREAM_TOL of its session alone; a row planted with the other
             session's text, then its noise, must exceed it) and the
             flicker of temporal latents against independent keyframes;
             last K1 (1 and 2 rows at 512², 1 at the 1024² preview
             keyframe), K2 (the frozen prompt's LM rows, 1 and 2) and K3 (a
             512² encode and decode) at the stream's shapes against their
             plain versions;
   yuv420  — ``transfer_format="yuv420"``: a hit and a miss; the output
             equals the host unpack of the decode's device pack, and the
             condition upload equals ``yuv420_to_rgb`` of the host pack
             computed on the CPU;
   serve   — the serving layer on the same pipeline: ``runtime/engine.py``
             behind ``serving/server.py`` in a thread, with the server's
             config (yuv420, batched CFG, 512² input, 2 steps): GET / and
             /health (gpu_memory a GB figure); /edit miss and hit, each
             beside the pipeline-only call of the same arrays (the wire's
             cost), use_cfg (K1 and K2 at 2 rows), ref_mode="condition"
             (K4's role), num_images=2; two concurrent /edits (one 200, one
             429); dynamic batching on a second engine (batched_with 2, K1
             120 at 2 rows); four pipelined stream frames over HTTP (lags 0,
             1, 1, 1; K1 120 / 60; the third frame's only host wait is its
             collect's event wait) and over the websocket; /profile/start
             and /stop around an /edit (the trace names K1's symbol);
             /edits of the committed 512² progressive JPEG, of the committed
             1024² lossy WebP and of a CMYK JPEG (written here without
             Pillow), each a miss with K1, K2 and K3 at a miss's counts; the codec's
             decode and encode ms; the CLI server as a subprocess on
             the card (/health, one /edit);
   train   — on the same bf16 pipeline before it is dropped: a rank-16 LoRA
             (default attention targets, ``remat``) over a batch of two
             1024² (condition, prompt, target) rows from ``build_batch``; a
             warm-up and two timed steps, each printing wall seconds, loss,
             launches (K7 120, K8 60, K9 60, K1 0 exactly) and peak bytes, then
             one profiled step (device time by kernel kind, idle share
             against the last timed step's wall); losses and
             gradients finite, gradients not all zero, adapters changed;
   distill — progressive distillation of a 2-step LoRA on the same
             pipeline (rank 16, remat), fed from a manifest of 1024² JPEG and
             PNG files through ``EditDataset`` and ``BatchLoader``: a warm-up,
             a timed step (K1 120 for the teacher, K7 120, K8 60, K9 60
             exactly), a guided step (scale 4 on the batch's negative rows:
             K1 240) and a profiled step; the adapter file read back equal;
             ``train_loop`` to step 2 with a state file, a second trainer
             resumed from it to step 3 equal bit for bit to the first one
             continued to step 3;
   tiny_train — the tiny decoder and encoder distilled from the flagship's
             VAE (width 64, 512², batch 4, 30 steps each): s a step and a
             batch build, loss and PSNR before and after (both must
             improve), K3 20 a decoder batch, 5 an encoder batch, 30 an
             encoder PSNR; both artifacts saved and read back equal;
   lora    — the trained adapters exported, written with the port's
             .safetensors writer, read back, fused in place into the live
             pipeline, and one cache-hit edit served again at the same seed:
             K1 120, K7 0, latents finite and unlike the pre-LoRA edit's;
6. int8    — the bf16 pipeline dropped, the same preset rebuilt with
             ``use_int8`` + ``use_int8_vl`` (quantized in place): warm-up,
             three misses, two hits and one two-image edit; K5 and K6 must
             run once per quantized linear the request executes (1200 in the
             MMDiT, 358 more in the VL encoder per one-image miss), and as
             often in a batched-CFG miss (the pair is one forward, at twice
             the rows); three 512² stream frames (a keyframe and two
             temporal frames: K5/K6 1200, 600 and 600, and 196 in
             ``precompute_conditions``, every K6 call's (M, K, N) counted
             against the stream's mix); one /edit miss served through an
             engine (K5/K6 1558); then a miss timed plainly and one
             profiled, as for bf16;
7. int4    — rebuilt with ``use_int4`` + ``use_int4_vl``: warm-up and one
             miss; K5/K6 run only for the vision tower's 3420-wide ``down``
             leaves, which take the int8 rung (32 per image per miss);
8. checkpoint — real-checkpoint serving at flagship width, depth cut to 2
             MMDiT blocks, 2 LM layers and 2 vision blocks (the full VAE and
             embedding): the tree made on the card from a seed, written with
             the port's ``export_*`` in the HF layout (bf16; the transformer
             and the VL sharded with index jsons, one block's q/k/v across a
             shard boundary), converted by the port's CLI in process (bf16;
             ``--fuse-qkv --quantize int8``; VAE; VL, whose tokenizer,
             vocab.json + merges.txt + tokenizer_config.json only in the
             diffusers layout's sibling ``tokenizer/``, the VL conversion
             finds and copies), loaded through
             ``InferenceEngine.create(transformer_path=..., vae_path=...,
             vl_path=...)`` (seconds, GB/s, card peak, the host's peak RSS
             growth under the largest shard + 1 GiB) and served: an /edit miss
             and hit with K1 = blocks × steps, K2 = LM layers a miss, K3 the
             VAE's; every loaded tensor and one miss's latents equal the
             in-memory tree's bit for bit (or within two in-memory runs'
             spread); an /edit of the committed progressive JPEG whose prompt
             the checkpoint's tokenizer encodes (the ids of every chat
             template are its and the tokenizer.json form's, not
             SimpleTokenizer's); the int8 checkpoint's
             codes and scales equal in-place
             quantize of the tree, its miss runs K5/K6 once per quantized
             linear; the server's CLI serves the converted tree; the full
             flagship's boot time extrapolated from the weights' GB/s (the
             tokenizer's load added once);
8b. tp     — multi-GPU serving (``parallel/``): a world of 2 ranks, mesh
             1 × 2, spawned with ``torch.multiprocessing`` (CUDA is live
             here) and joined by ``gloo`` (NCCL refuses two ranks on one
             card), every rank on cuda:0: the bf16 flagship at full width,
             its MMDiT cut to TP_DEPTH blocks (TP_PRESET: the VL encoder and
             the VAE whole; the gloo time goes with the depth), built from
             seed 0 a block at a time, each rank keeping its
             tensor-parallel slices; a cond-only miss and a hit, a
             guided batched miss, a two-image miss (K4's role) and one /edit
             served by rank 0 over HTTP while rank 1 follows it (the
             followed call held to the same launches and latents; a raise
             in it fails the phase); then the int8 rung (MMDiT and VL) at
             TP 2, one miss, its row-parallel int8 codes held to the
             one-device K5's bit for bit. Each result's latents within
             TP_TOL (rel-L2) of the one-process pipeline's of TP_PRESET on
             the same request (computed first and kept on the host); per
             rank its weight and peak bytes, its launches (K1 2 · TP_DEPTH
             at 12 local heads, K2 28 at 14 / 2 kv heads, K3 the VAE's;
             int8: 14 quantized linears a block, q/k/v unfused, a
             row-parallel one launching K5 and K6 twice each) asserted, and
             the collectives a forward;
8c. mesh   — a world of 4 ranks, mesh 2 × 2 (cfg × model), the depth cut as
             in phase 8: a ``cfg_mode="parallel"`` guided miss (each cfg
             group one row of the pair), an ``rcfg`` miss and
             ``num_images_per_prompt=2`` (the rows split over the cfg
             groups), each within TP_TOL of the one-process pipeline at the
             same cut, launches and rows asserted. The times of 8b and 8c
             are of ranks sharing one card through host-staged collectives:
             they say nothing of NCCL across cards;
8d. tp_train — multi-GPU training: a world of 2 ranks, mesh 1 × 2, the
             bf16 TP_PRESET of 8b: the LoRA trainer of
             ``LoRATrainer.from_pipeline`` on the rank's slices (the
             forward's all-reduces autograd nodes, the column-parallel
             inputs' gradients summed over the ranks in the backward, the
             adapter gradients in one flat all-reduce) takes the one-card
             batch's warm-up and two steps, then a distill trainer its
             unguided and guided step; each step's loss and every reduced
             adapter gradient within TRAIN_TOL of the one-process step's on
             the same cut, computed first: a rank-16 LoRA trainer (b drawn
             non-zero) on one 1024² row with its negative rows, the loss and
             clipped adapter gradients kept on the host in bf16 (the guided
             step's gradients within GUIDED_TRAIN_TOL), its launches
             (K7 2 · TP_DEPTH, K8 = K9 = TP_DEPTH; K1 2 · TP_DEPTH for the
             unguided teacher, twice that guided) at (1, 12, L, 128) exact,
             its collectives (forward, backward, the adapter reduction),
             seconds and peak printed;
             the adapters bit-identical across the ranks after the LoRA
             steps;
8e. mesh_train — 4 ranks, mesh 2 × 2, the depth cut as in 8c: a LoRA step on
             2 rows (split over cfg) and one on 1 row (every cfg group runs
             it), each held to the one-process step at that depth (computed
             first), K7 = 2 · depth and K8 = K9 = depth a rank, the adapters
             bit-identical on every rank;
8f. tp_stream — the realtime stream under a world of 2 ranks (mesh 1 × 2,
             the bf16 TP_PRESET of 8b): a 512² session of TP_STREAM_FRAMES
             frames submitted pipelined on both ranks (K2 28 at 14 / 2 heads
             in the prompt freeze; K1 2 · TP_DEPTH / TP_DEPTH at
             (1, 12, 2112, 128) and K3 20 a keyframe / temporal frame),
             s/frame, fps and rank 0's host seconds a submit; then a
             websocket session through the server on rank 0 while rank 1
             follows it (``follow``'s stream mirror), the socket's close
             ending the session on both ranks; every frame's latent within
             TP_TOL of the one-process stream's on the same cut, a
             TP_STREAM_FRAMES session and a TP_WS_FRAMES websocket session
             run first. Times of 8d-8f are of ranks sharing one card through
             gloo;
9. int8 kernels — K5 and K6 at every int8 shape of a one-image miss,
             of a batched-CFG miss (M = 16384, 512, 768, 2) and of a 512²
             stream keyframe with its precompute (M = 2048, 64, 1, 128),
             bit-identical to their plain versions, timed as K3 is, beside
             bf16 ``F.linear`` and ``torch._int_mm`` (the s8 product alone),
             with the mix's sums a miss. It runs after the pipelines: its
             graphs capture cuBLAS on a side stream, whose workspace would
             otherwise stay allocated through the requests above. Then the
             row-parallel entries at TP 2's shapes (K5's row scales and its
             codes of a given scale, K6's int32 sums and its epilogue on
             them), equal to their plain versions, timed beside
             ``torch._int_mm``, and one rank's whole row-parallel linear
             beside the one-device linear; K1 and K2 at a rank's heads and
             K5/K6 at the column-parallel int8 shapes. Every phase prints
             its wall seconds (``phase_seconds``).

Then it prints the kernels summary and, as the last line,
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before that line. Without a CUDA device, or outside a checkout, it exits
non-zero and prints no result.
"""

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "qwen_image_edit_streamdiffusion_tpu_torch"
PROMPT = "Transform into oil painting style"
SIZE = 1024
TXT_LEN = 256      # the flagship's text bucket for PROMPT with one 384² image
TXT_REAL = 208     # real text tokens in that bucket
LM_LEN = 384       # the flagship LM's 128-bucket for the same request
LM_REAL = 258
TXT_LEN_TWO = 448  # the text bucket of PROMPT with two 384² images
STEPS = 2
MMDIT_LAYERS = 60
K1_LAUNCHES = MMDIT_LAYERS * STEPS   # K1 (or K4) a request: one a layer a forward
CFG_SCALE = 4.0
NEG = ""           # the server's use_cfg convention: an empty negative prompt
NEG_REAL = TXT_REAL - 5  # its real text tokens: PROMPT's five words fewer
# sixty words: 263 real text tokens, the 320-token text bucket (PROMPT: 256),
# and 313 LM tokens, still PROMPT's 384 LM bucket (one batched LM call)
LONG_NEG = " ".join(f"word{i}" for i in range(60))
# int8 linears a request runs: 10 per MMDiT block and step; per VL miss 7 per
# LM layer (28) and, per condition image, 5 per vision block (32) + 2 merger
INT8_MMDIT = 10 * MMDIT_LAYERS * STEPS
INT8_LM = 7 * 28
INT8_VISION = 5 * 32 + 2
INT4_VISION = 32   # under int4 only the 3420-wide vision `down` stays int8

# Flash forward tolerance (K1, K2, K4, K7): kernel and plain version round at
# the same points (bf16 Q_pre, exp2 argument, P and O), but the kernel takes a
# blockwise running max where the plain version takes the row's global max, so
# a few rounded exp2 arguments, and with them P, differ; the outputs differ by
# at most ATTN_ULPS bf16 ulps (8 significant bits) at max|ref|. A K1 that let
# the 48 padded text keys through moves outputs by far more than that. LSE2 (f32, base 2, about 14 at the train shape) moves by < 1e-3 under
# the same rounding, and by 5e-3 when every P is biased low by one bf16
# rounding (exp2 taken in bf16): |got - ref| <= LSE_TOL.
ATTN_ULPS = 2
LSE_TOL = 2e-3
# K3: both sum the 9·cin bf16 products in f32, in other orders, and round once
# to bf16: max|got - ref| <= CONV_TOL * max(1, max|ref|), two bf16 ulps.
CONV_TOL = 8e-3
BLOCK_TOL = 3e-2   # rel-L2 of a 2-block bf16 MMDiT forward, kernels vs plain
# K8/K9 outputs are f32 sums over 8448 keys or rows of bf16 products whose
# inputs (dS, P) the kernel and the plain version round to bf16 at the same
# points, from an exp2 that differs in the last f32 bits (ex2.approx against
# torch.exp2, and sums taken in another order), so a few rounded P and dS
# differ: max|got - ref| <= GRAD_TOL * max|ref|. The kernels read about 1e-3
# of max|ref|. A backward that takes exp2 of the bf16-rounded argument
# (the bf16x2 exp2 shortcut) reads 5e-3 to 1.2e-2, and its dQ passed the
# earlier limit of 1e-2; phase_train_kernels shows that this one fails it.
GRAD_TOL = 4e-3
# rel-L2 of the loss and of each adapter gradient of a 2-block bf16 MMDiT,
# kernels vs plain attention under autograd (bf16 rounding of both backwards)
TRAIN_TOL = 5e-2
# rel-L2 of each adapter gradient of the guided distill step of phase
# tp_train against the one-card step. Its loss residual (v_s - v*) is small
# (loss 0.0022 at 1024², the unguided step's 0.0134), so the bf16 rounding
# of the guided teacher's velocities is a large share of every gradient:
# sound bf16 computations of the step differ by more than TRAIN_TOL.
# scripts/tp_train_tolerance.py measures them on one H100: one-card steps
# from one state with the row-parallel sums rounded in 2, 4 or 8 parts read
# 0.028-0.068 from each other at their worst gradient (the LoRA step's
# 0.0046-0.0058), while a TP-2 step with the backward all-reduce of the
# column-parallel inputs dropped reads 1.16 and one with the adapter
# gradients left unreduced 1.11: the limit sits 2.2x above the first and
# 7.8x below the second.
GUIDED_TRAIN_TOL = 0.15
TRAIN_ROWS = 2
TRAIN_RANK = 16
TRAIN_STEPS = 2
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and int8 tensor cores, HBM3
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
HBM_RATE = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def emit_kernel(rec: dict) -> None:
    """A kernel phase's record, with the share of its time the bound is."""
    emit({**rec, "bound_share": rec["bound_ms"] / rec["ms"]})


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# the port's kernel symbols, as nvcc mangles them into the library
KERNEL_SYMBOLS = ("flash_fwd_sm90_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                  "conv3x3_sm90_kernel", "conv3x3_f32_kernel", "int8_gemm_sm90_kernel",
                  "int8_gemm_mma_kernel", "quantize_rows_kernel", "int8_epilogue_kernel")
# the kernels the build gate holds to wgmma (HGMMA for bf16, IGMMA for s8) +
# TMA, no spills, no serialisation (flash_fwd_sm90_kernel<LSE, CAUSAL,
# consumer warpgroups>: <0,0,2> is K1/K4, <1,0,2> K7, <0,1,1> and <0,1,2> K2
# with 64- and 128-row CTAs; int8_gemm_sm90_kernel is K6 where K % 16 == 0,
# int8_gemm_mma_kernel, its mma.sync body for K % 16 != 0, is not held)
WGMMA_KERNELS = ("flash_fwd_sm90_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                 "conv3x3_sm90_kernel", "int8_gemm_sm90_kernel")
GMMA_OPS = ("HGMMA", "IGMMA")


def short_symbol(mangled: str) -> str:
    """``flash_fwd_sm90_kernel<1,0,2>`` for a mangled kernel name (its bool and
    int template arguments, where it has any, in angle brackets)."""
    import re

    for sym in KERNEL_SYMBOLS:
        if sym in mangled:
            args = re.match(re.escape(sym) + r"I((?:L[bi]\d+E)+)E",
                            mangled[mangled.index(sym):])
            if not args:
                return sym
            return sym + "<" + ",".join(re.findall(r"L[bi](\d+)E", args.group(1))) + ">"
    return mangled[:60]


def build_report(lib_path) -> dict:
    """Per kernel symbol: the HGMMA and IGMMA (bf16 and s8 wgmma) and
    UTMALDG (TMA load) instructions in ``cuobjdump --dump-sass`` of the
    built library, the spill
    bytes ``-Xptxas -v`` printed, and whether ptxas serialised its wgmmas
    (warnings C7510-C7515 in build.log)."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    report, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = short_symbol(line.split("Function : ")[1].strip())
            report[name] = {**dict.fromkeys(GMMA_OPS, 0), "UTMALDG": 0,
                            "spill_bytes": None, "wgmma_serialized": False}
        elif name is not None:
            for op in GMMA_OPS + ("UTMALDG",):
                report[name][op] += op in line
    log = (lib_path.parent / "build.log").read_text().splitlines()
    for i, line in enumerate(log):
        if "Function properties for " in line and i + 1 < len(log):
            name = short_symbol(line.split("Function properties for ")[1].strip())
            nums = [int(w) for w in log[i + 1].replace(",", " ").split() if w.isdigit()]
            if name in report and len(nums) >= 3:
                report[name]["spill_bytes"] = nums[1] + nums[2]
        for code in ("C7510", "C7511", "C7512", "C7513", "C7514", "C7515"):
            if code in line:
                for name in report:
                    if name.split("<")[0] in line:
                        report[name]["wgmma_serialized"] = True
    return report


def cuda_ms(fn, iters: int) -> float:
    """Median CUDA-event time of ``fn`` over ``iters`` runs, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, n: int, replays: int = 20) -> float:
    """Device milliseconds per call of ``fn``: ``n`` calls captured in one
    CUDA graph, the graph replayed between one event pair, the time over
    ``n``; the median of ``replays`` replays, after a warm-up call and a
    warm-up replay. The replay launches the captured kernels back to back,
    so no host work (the wrapper's checks, ctypes, allocation) is inside the
    time: this is the time ``cuda_ms`` has less the host cost of a call."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def timed(prefix: str, fn, n: int, iters: int = 20) -> dict:
    """``{prefix}ms``: device ms per call (:func:`graph_ms`, ``n`` calls a
    graph); ``{prefix}wall_ms``: the per-call CUDA-event time
    (:func:`cuda_ms`), which includes the host cost of each call."""
    return {f"{prefix}ms": graph_ms(fn, n), f"{prefix}wall_ms": cuda_ms(fn, iters)}


def attn_tolerance(ref) -> float:
    """ATTN_ULPS bf16 ulps at max|ref|."""
    return ATTN_ULPS * 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)


def conv_tolerance(ref) -> float:
    return CONV_TOL * max(1.0, ref.abs().max().item())


def bound(ops: float, nbytes: float, peak: float) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the HBM rate and
    the operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, ops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "ops": ops, "bytes": nbytes}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def attention_bound(q, k, v, out, mask, flops_per_pair: int, extra=()) -> dict:
    """Bound of a non-causal attention function over the keys the mask keeps:
    flops_per_pair · d flops per (query row, kept key) pair and head."""
    b, h, lq, d = q.shape
    kept = k.shape[2] if mask is None else mask.sum(-1).float().mean().item()
    return bound(flops_per_pair * b * h * lq * kept * d,
                 nbytes(q, k, v, *out, *extra) + (0 if mask is None else mask.numel()),
                 PEAK_BF16)


def randn(shape, seed, dtype):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def sdpa(q, k, v, mask=None, **kw):
    """PyTorch's fused attention on the same inputs: the library yardstick
    (the port never calls it)."""
    import torch.nn.functional as F

    m = None if mask is None else mask[:, None, None, :]
    return F.scaled_dot_product_attention(q, k, v, attn_mask=m, **kw)


def phase_resize():
    """The request's resizes (``core/imaging.py``: Pillow's resampling as
    float64 products): every request resizes its 1024² image to the VL's
    384² (LANCZOS), a miss also 384² → 392² (BICUBIC, in the VL encoder),
    and a two-image miss does both twice. Milliseconds on the host and on
    the card: the process's first call (which also loads the float64
    kernels it meets first), a miss after the weights' cache is cleared (a
    new input size in a warm process) and the median of five after it; the
    card's bytes must equal the host's."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.core import imaging

    imgs = [distinct_image(0), distinct_image(1)]
    torch.ones(8, 8, dtype=torch.float64, device="cuda").matmul(
        torch.ones(8, 8, dtype=torch.float64, device="cuda"))  # cuBLAS up
    rec, outs = {"phase": "resize"}, {}

    def ms(fn, dev):
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    for dev in ("cpu", "cuda"):
        def lanczos(i=0):
            return imaging.resize(imgs[i], 384, 384, "lanczos", dev)

        def miss(i=0):
            return imaging.resize(lanczos(i), 392, 392, "bicubic", dev)

        r = {"first_call_ms": ms(miss, dev)}
        imaging._coeffs.cache_clear()
        imaging._weights.cache_clear()
        r["cold_miss_ms"] = ms(miss, dev)
        for name, fn in (("lanczos_ms", lanczos), ("miss_ms", miss),
                         ("two_image_miss_ms", lambda: (miss(0), miss(1)))):
            r[name] = statistics.median(ms(fn, dev) for _ in range(5))
        rec[dev] = r
        outs[dev] = miss(1)
    rec["card_equals_host"] = bool((outs["cpu"] == outs["cuda"]).all())
    emit(rec)
    if not rec["card_equals_host"]:
        raise AssertionError("resize on the card differs from the host's")


def phase_kernels():
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.ops import flash_attention as fa

    bf16 = torch.bfloat16
    results = {}

    # K1 at the flagship joint shape: 24 heads × 128, [256 text ⊕ 4096 target
    # ⊕ 4096 condition] tokens, text bucket padded after TXT_REAL tokens.
    lk = TXT_LEN + 2 * (SIZE // 16) ** 2
    q, k, v = (randn((1, 24, lk, 128), s, bf16) for s in (1, 2, 3))
    mask = torch.ones((1, lk), dtype=torch.bool, device="cuda")
    mask[:, TXT_REAL:TXT_LEN] = False
    out = fa.joint_attention(q, k, v, mask, TXT_LEN)

    def k1_plain():  # a few heads at a time: all 24 of f32 scores are ~7 GB
        return torch.cat([fa.joint_attention_plain(q[:, h:h + 4], k[:, h:h + 4],
                                                   v[:, h:h + 4], mask)
                          for h in range(0, 24, 4)], dim=1)

    ref = k1_plain().float()
    err = (out.float() - ref).abs().max().item()
    tol = attn_tolerance(ref)
    rec = {"phase": "kernel", "name": "flash_attention_joint",
           "shape": list(q.shape), "max_abs_err": err, "tol": tol,
           "ref_max": ref.abs().max().item(),
           "ms": cuda_ms(lambda: fa.joint_attention(q, k, v, mask, TXT_LEN), 10),
           "plain_ms": cuda_ms(k1_plain, 3),
           "library_ms": cuda_ms(lambda: sdpa(q, k, v, mask), 10),
           **attention_bound(q, k, v, (out,), mask, 4)}
    emit_kernel(rec)
    if not err <= tol:
        raise AssertionError(f"K1 error {err} > {tol}")
    results["flash_attention_joint"] = rec
    del q, k, v, out, ref

    results.update(phase_causal_kernel())
    results.update(phase_conv_kernel())
    torch.cuda.empty_cache()
    results.update(phase_stream_kernel())
    results.update(phase_train_kernels())
    for name, err in phase_batch_kernels().items():
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    return results


def phase_batch_kernels() -> dict:
    """The shapes guided and batched edits give K1, K2 and K3, two rows
    each, against their plain versions and timed beside their library call
    and bound: K1 at (2, 24, 8448, 128) with the positive's and the empty
    negative's text masks (208 and 203 real tokens of 256); K2 at (2, 28/4,
    384, 128), the pos+neg LM rows (258 and 253 real, suffix-padded), graph-
    timed as a miss's 28 launches; K3 at (2, 1024², 96→96), a decode of two
    rows, graph-timed as its 9 launches. Returns the max-abs errors."""
    import torch
    import torch.nn.functional as F

    from qwen_image_edit_streamdiffusion_tpu_torch.ops import conv as conv_ops
    from qwen_image_edit_streamdiffusion_tpu_torch.ops import flash_attention as fa

    bf16 = torch.bfloat16
    errs = {}
    lk = TXT_LEN + 2 * (SIZE // 16) ** 2
    q, k, v = (randn((2, 24, lk, 128), s, bf16) for s in (60, 61, 62))
    mask = torch.ones((2, lk), dtype=torch.bool, device="cuda")
    mask[0, TXT_REAL:TXT_LEN] = False
    mask[1, NEG_REAL:TXT_LEN] = False
    out = fa.joint_attention(q, k, v, mask, TXT_LEN)

    def k1_plain():
        return torch.cat([fa.joint_attention_plain(q[:, h:h + 4], k[:, h:h + 4],
                                                   v[:, h:h + 4], mask)
                          for h in range(0, 24, 4)], dim=1)

    ref = k1_plain().float()
    err, tol = (out.float() - ref).abs().max().item(), attn_tolerance(ref)
    emit_kernel({"phase": "kernel", "name": "flash_attention_joint",
                 "shape": list(q.shape), "text_real": [TXT_REAL, NEG_REAL],
                 "max_abs_err": err, "tol": tol,
                 "ms": cuda_ms(lambda: fa.joint_attention(q, k, v, mask, TXT_LEN), 10),
                 "plain_ms": cuda_ms(k1_plain, 2),
                 "library_ms": cuda_ms(lambda: sdpa(q, k, v, mask), 10),
                 **attention_bound(q, k, v, (out,), mask, 4)})
    if not err <= tol:
        raise AssertionError(f"K1 error {err} > {tol} at two rows")
    errs["flash_attention_joint"] = err
    del q, k, v, out, ref
    torch.cuda.empty_cache()

    reals = (LM_REAL, LM_REAL - 5)
    q = randn((2, 28, LM_LEN, 128), 63, bf16)
    k, v = (randn((2, 4, LM_LEN, 128), s, bf16) for s in (64, 65))
    out = fa.causal_attention(q, k, v)
    err, tol = 0.0, 0.0
    for b, n_real in enumerate(reals):
        keep = torch.arange(LM_LEN, device="cuda") < n_real
        ref = fa.causal_attention_plain(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                        keep)[:, :, :n_real].float()
        err = max(err, (out[b:b + 1, :, :n_real].float() - ref).abs().max().item())
        tol = max(tol, attn_tolerance(ref))
    emit_kernel({"phase": "kernel", "name": "flash_attention_causal",
                 "shape": [2, 28, 4, LM_LEN], "n_real": list(reals),
                 "max_abs_err": err, "tol": tol, "graph_launches": K2_LAUNCHES,
                 "block_q": fa.causal_block_q(q),
                 **timed("", lambda: fa.causal_attention(q, k, v), K2_LAUNCHES),
                 "plain_ms": cuda_ms(lambda: [fa.causal_attention_plain(
                     q[b:b + 1], k[b:b + 1], v[b:b + 1]) for b in range(2)], 20),
                 **timed("library_", lambda: sdpa(q, k, v, is_causal=True,
                                                   enable_gqa=True), K2_LAUNCHES),
                 **bound(4 * 2 * 28 * (LM_LEN * (LM_LEN + 1) / 2) * 128,
                         nbytes(q, k, v) + nbytes(q), PEAK_BF16)})
    if not err <= tol:
        raise AssertionError(f"K2 error {err} > {tol} at two rows")
    errs["flash_attention_causal"] = err
    del q, k, v, out

    x = randn((2, SIZE, SIZE, 96), 66, bf16)
    w = (randn((3, 3, 96, 96), 67, torch.float32) * (9 * 96) ** -0.5).to(bf16)
    b = randn((96,), 68, bf16) * 0.1
    got = conv_ops.conv3x3(x, w, b).float()
    ref = conv_ops.conv3x3_plain(x, w, b).float()
    err, tol = (got - ref).abs().max().item(), conv_tolerance(ref)
    del got, ref
    wl = w.permute(3, 2, 0, 1)
    emit_kernel({"phase": "kernel", "name": "conv3x3", "shape": [2, SIZE, SIZE, 96, 96],
                 "launches_decode": 9, "max_abs_err": err, "tol": tol,
                 **timed("", lambda: conv_ops.conv3x3(x, w, b), 9, 10),
                 "plain_ms": cuda_ms(lambda: conv_ops.conv3x3_plain(x, w, b), 10),
                 **timed("library_", lambda: F.conv2d(x.permute(0, 3, 1, 2), wl, b,
                                                      padding=1), 9, 10),
                 **bound(2 * 2 * SIZE * SIZE * 9 * 96 * 96,
                         nbytes(x, w, b) + 2 * SIZE * SIZE * 96 * 2, PEAK_BF16)})
    if not err <= tol:
        raise AssertionError(f"K3 error {err} > {tol} at batch 2")
    errs["conv3x3"] = err
    del x, w, b
    torch.cuda.empty_cache()
    return errs


# K2's lengths (full buckets, and the main path's 384 bucket with 258 real
# tokens, suffix-padded): (L, real rows); its launches a miss (28 LM layers)
K2_LENGTHS = ((128, 128), (LM_LEN, LM_REAL), (1024, 1024))
K2_LAUNCHES = 28


def phase_causal_kernel():
    """K2 (28 q heads on 4 kv heads) at each length, compared with the plain
    version on the real rows; device time per launch from a graph of one
    miss's 28 launches, beside the per-call wall time, and SDPA
    (``is_causal``, ``enable_gqa``) under both timings. Both CTA tiles (64
    and 128 query rows) are checked and graph-timed; ``ms`` is the tile the
    wrapper picks (``block_q``)."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.ops import flash_attention as fa

    bf16 = torch.bfloat16
    k2, worst = None, 0.0
    for l, n_real in K2_LENGTHS:
        q = randn((1, 28, l, 128), 4, bf16)
        k, v = (randn((1, 4, l, 128), s, bf16) for s in (5, 6))
        keep = torch.arange(l, device="cuda") < n_real
        ref = fa.causal_attention_plain(q, k, v, keep)[:, :, :n_real].float()
        tol = attn_tolerance(ref)
        tiles = {}
        for block_q in (64, 128):
            got = fa.causal_attention(q, k, v, block_q)[:, :, :n_real].float()
            tiles[block_q] = {
                "max_abs_err": (got - ref).abs().max().item(),
                "ms": graph_ms(lambda: fa.causal_attention(q, k, v, block_q),
                               K2_LAUNCHES)}
        err = max(t["max_abs_err"] for t in tiles.values())
        worst = max(worst, err)
        rec = {"phase": "kernel", "name": "flash_attention_causal",
               "shape": [1, 28, 4, l], "n_real": n_real, "max_abs_err": err,
               "tol": tol, "graph_launches": K2_LAUNCHES,
               "block_q": fa.causal_block_q(q), "tiles": tiles,
               **timed("", lambda: fa.causal_attention(q, k, v), K2_LAUNCHES),
               "plain_ms": cuda_ms(lambda: fa.causal_attention_plain(q, k, v, keep), 20),
               **timed("library_", lambda: sdpa(q, k, v, is_causal=True,
                                                 enable_gqa=True), K2_LAUNCHES),
               # causal: each row meets (row + 1) keys
               **bound(4 * 28 * (l * (l + 1) / 2) * 128,
                       nbytes(q, k, v) + nbytes(q), PEAK_BF16)}
        emit_kernel(rec)
        if not err <= tol:
            raise AssertionError(f"K2 error {err} > {tol} at L={l}")
        if l == LM_LEN:
            k2 = dict(rec)
    k2["max_abs_err"] = worst
    return {"flash_attention_causal": k2}


# K3's shapes on the main path: (H = W, C_in, F, launches a miss, a hit),
# from the flagship VAE (base 96, multipliers (1, 2, 4, 4)): the decoder's
# convs (15, every request) and the encoder's (5 more a miss)
K3_MIX = ((SIZE, 96, 96, 9, 5), (SIZE, 96, 48, 1, 1), (SIZE, 48, 96, 1, 1),
          (SIZE, 96, 3, 1, 1), (SIZE // 2, 96, 96, 6, 6), (SIZE // 8, 16, 384, 1, 1),
          (SIZE // 2, 96, 192, 1, 0))


def phase_conv_kernel():
    """K3 at every shape of the mix, bf16, against its plain version; device
    time per launch from a graph of the shape's launches a miss, the per-call
    wall time, and cuDNN's conv (the same NHWC operands) under both; then
    the mix a miss: summed device ms of the kernel, its bound and cuDNN."""
    import torch
    import torch.nn.functional as F

    from qwen_image_edit_streamdiffusion_tpu_torch.ops import conv as conv_ops

    bf16 = torch.bfloat16
    k3, worst = None, 0.0
    mix = {"ms": 0.0, "wall_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
           "library_wall_ms": 0.0, "launches": 0}
    for size, cin, f, n_miss, n_hit in K3_MIX:
        x = randn((1, size, size, cin), 7, bf16)
        w = (randn((3, 3, cin, f), 8, torch.float32) * (9 * cin) ** -0.5).to(bf16)
        b = randn((f,), 9, bf16) * 0.1
        got = conv_ops.conv3x3(x, w, b).float()
        ref = conv_ops.conv3x3_plain(x, w, b).float()
        err = (got - ref).abs().max().item()
        tol = conv_tolerance(ref)
        worst = max(worst, err)
        del got, ref
        wl = w.permute(3, 2, 0, 1)  # the NHWC/HWIO operands as cuDNN's
        rec = {"phase": "kernel", "name": "conv3x3", "shape": [1, size, size, cin, f],
               "launches_miss": n_miss, "launches_hit": n_hit,
               "max_abs_err": err, "tol": tol,
               **timed("", lambda: conv_ops.conv3x3(x, w, b), n_miss, 10),
               "plain_ms": cuda_ms(lambda: conv_ops.conv3x3_plain(x, w, b), 10),
               **timed("library_", lambda: F.conv2d(x.permute(0, 3, 1, 2), wl, b,
                                                    padding=1), n_miss, 10),
               **bound(2 * size * size * 9 * cin * f,
                       nbytes(x, w, b) + size * size * f * 2, PEAK_BF16)}
        emit_kernel(rec)
        if not err <= tol:
            raise AssertionError(f"K3 error {err} > {tol} at {size}² {cin}->{f}")
        for key in ("ms", "wall_ms", "bound_ms", "library_ms", "library_wall_ms"):
            mix[key] += n_miss * rec[key]
        mix["launches"] += n_miss
        if (size, cin, f) == (SIZE, 96, 96):
            k3 = dict(rec)
        del x, w, b
        torch.cuda.empty_cache()
    emit({"phase": "kernel_mix", "name": "conv3x3", "per": "bf16 cache miss", **mix,
          "bound_share": mix["bound_ms"] / mix["ms"],
          "vs_library": mix["ms"] / mix["library_ms"]})
    k3["max_abs_err"] = worst
    return {"conv3x3": k3}


def phase_stream_kernel():
    """K4's role: the non-causal kernel at two-image joint lengths (text
    bucket + 3 × 4096 image tokens) with the text-prefix mask, 24/24 heads
    and, for its GQA, 28 q / 4 kv heads."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.ops import flash_attention as fa

    bf16 = torch.bfloat16
    img = 3 * (SIZE // 16) ** 2
    rec0, worst = None, 0.0
    for txt, h, hkv in ((256, 24, 24), (512, 24, 24), (256, 28, 4)):
        lk = txt + img
        q = randn((1, h, lk, 128), 12, bf16)
        k, v = (randn((1, hkv, lk, 128), s, bf16) for s in (13, 14))
        mask = torch.ones((1, lk), dtype=torch.bool, device="cuda")
        mask[:, txt - 48:txt] = False
        if not fa.streams_kv(k):
            raise AssertionError(f"Lk={lk} is not in K4's streaming role")
        out = fa.joint_attention(q, k, v, mask, txt)
        rep = h // hkv
        step = 4 if rep == 1 else rep  # heads per plain call: f32 scores are large

        def plain():
            return torch.cat([fa.joint_attention_plain(
                q[:, h0:h0 + step], k[:, h0 // rep:(h0 + step) // rep],
                v[:, h0 // rep:(h0 + step) // rep], mask)
                for h0 in range(0, h, step)], dim=1)

        ref = plain().float()
        err = (out.float() - ref).abs().max().item()
        tol = attn_tolerance(ref)
        rec = {"phase": "kernel", "name": "flash_attention_stream",
               "shape": [1, h, hkv, lk], "max_abs_err": err, "tol": tol,
               "ref_max": ref.abs().max().item(),
               "ms": cuda_ms(lambda: fa.joint_attention(q, k, v, mask, txt), 10),
               "plain_ms": cuda_ms(plain, 3),
               "library_ms": cuda_ms(lambda: sdpa(q, k, v, mask,
                                                  enable_gqa=rep > 1), 10),
               **attention_bound(q, k, v, (out,), mask, 4)}
        emit_kernel(rec)
        if not err <= tol:
            raise AssertionError(f"K4 error {err} > {tol} at {rec['shape']}")
        worst = max(worst, err)
        rec0 = rec0 or dict(rec)
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    rec0["max_abs_err"] = worst
    return {"flash_attention_stream": rec0}


# The int8 linears of a one-image int8 miss: (name, M, K, N, launches a
# miss), shapes that occur more than once merged. MMDiT (120 each: 60 blocks
# × 2 steps): the image stream at 8192 tokens, the text stream at the
# 256-token bucket, the two modulation GEMVs; the VL LM (28 layers, 384-token
# bucket); the vision tower (32 blocks, 784 patches) and its merger (196).
INT8_MIX = (("img_qkv", 8192, 3072, 9216, 120), ("img_out", 8192, 3072, 3072, 120),
            ("img_fc1", 8192, 3072, 12288, 120), ("img_fc2", 8192, 12288, 3072, 120),
            ("txt_qkv", 256, 3072, 9216, 120), ("txt_out", 256, 3072, 3072, 120),
            ("txt_fc1", 256, 3072, 12288, 120), ("txt_fc2", 256, 12288, 3072, 120),
            ("img_mod+txt_mod", 1, 3072, 18432, 240),
            ("lm_q+lm_o", LM_LEN, 3584, 3584, 56), ("lm_k+lm_v", LM_LEN, 3584, 512, 56),
            ("lm_gate+lm_up", LM_LEN, 3584, 18944, 56), ("lm_down", LM_LEN, 18944, 3584, 28),
            ("vis_qkv", 784, 1280, 3840, 32), ("vis_proj", 784, 1280, 1280, 32),
            ("vis_gate+vis_up", 784, 1280, 3420, 64), ("vis_down", 784, 3420, 1280, 32),
            ("merger_fc1", 196, 5120, 5120, 1), ("merger_fc2", 196, 5120, 3584, 1))
# A batched-CFG int8 miss: the MMDiT's and the LM's rows doubled (the pair
# is one forward; pos and neg are one LM call), the vision tower's unchanged
# (one image, shared); the same launches.
INT8_CFG_MIX = tuple((name, m if name.startswith(("vis", "merger")) else 2 * m, k, n,
                      launches) for name, m, k, n, launches in INT8_MIX)
# A 512² int8 stream keyframe with its frozen prompt: the MMDiT at 2048 image
# rows (1024 noise + 1024 condition tokens) and the 64-token text bucket, two
# forwards; the VL LM once, in precompute_conditions, at its 128-token bucket
# of the text-only prompt (no vision tower). A temporal frame runs the
# MMDiT's half.
INT8_STREAM_MIX = tuple(
    (name, {8192: 2048, 256: 64, LM_LEN: 128}.get(m, m), k, n, launches)
    for name, m, k, n, launches in INT8_MIX if not name.startswith(("vis", "merger")))


def int_mm(xq, wq):
    """``torch._int_mm`` on the same codes where it takes the shape (M > 16,
    K and N multiples of 8): the s8 product alone, int32 out, no scales, no
    bias. A yardstick for K6's product only; the port never calls it."""
    import torch

    m, k = xq.shape
    if m <= 16 or k % 8 or wq.shape[0] % 8:
        return None
    return lambda: torch._int_mm(xq, wq.t())


def phase_int8_kernels():
    """K5 and K6 at every int8 shape of a one-image miss, then of a
    batched-CFG miss (M = 16384, 512, 768 and 2 where the pair doubles the
    rows), then of a 512² stream keyframe and its precompute (M = 2048, 64,
    1 and 128), bit-identical to their plain versions (gate: max-abs error 0 for
    codes, scales and the GEMM output). Each shape: device time per launch
    from a graph of the shape's launches a miss (``ms``), the per-call time
    (``wall_ms``), the plain versions, bf16 ``F.linear`` (the rung int8
    replaces) and ``torch._int_mm`` under both, and the bound; then each
    mix a miss, summed per column."""
    if sum(n for *_, n in INT8_MIX) != INT8_MMDIT + INT8_LM + INT8_VISION:
        raise AssertionError("INT8_MIX does not hold a miss's int8 linears")
    worst = {"quantize_rows": 0.0, "int8_gemm": 0.0}
    recs = int8_mix(INT8_MIX, "int8 one-image miss", worst)
    int8_mix(INT8_CFG_MIX, "int8 batched-CFG miss", worst)
    int8_mix(INT8_STREAM_MIX, "int8 512² stream keyframe + precompute", worst)
    for key in recs:
        recs[key]["max_abs_err"] = worst[key]
    return recs


def int8_mix(shapes, per: str, worst: dict) -> dict:
    """One int8 mix (see :func:`phase_int8_kernels`); returns the img_qkv
    records of K5 and K6 and raises the worst errors in ``worst``."""
    import torch
    import torch.nn.functional as F

    from qwen_image_edit_streamdiffusion_tpu_torch.ops import int8

    bf16 = torch.bfloat16
    recs = {}
    cols = ("ms", "wall_ms", "bound_ms", "bf16_ms", "bf16_wall_ms")
    mix = {"int8_gemm": dict.fromkeys(cols + ("int_mm_ms", "int_mm_wall_ms",
                                              "int_mm_launches"), 0.0),
           "quantize_rows": dict.fromkeys(("ms", "wall_ms", "bound_ms"), 0.0)}
    for name, m, k, n, launches in shapes:
        x = randn((m, k), 15, bf16)
        w = randn((n, k), 16, torch.float32).mul_(0.02).to(bf16)
        b = randn((n,), 17, bf16) * 0.1
        wq, ws = int8.quantize_weight(w)
        xq, xs = int8.quantize_rows(x)
        xq_ref, xs_ref = int8.quantize_rows_plain(x)
        err5 = max((xq.int() - xq_ref.int()).abs().max().item(),
                   (xs - xs_ref).abs().max().item())
        out = int8.int8_matmul(xq_ref, xs_ref, wq, ws, b)
        ref = int8.int8_matmul_plain(xq_ref, xs_ref, wq, ws, b)
        err6 = (out.float() - ref.float()).abs().max().item()
        del out, ref
        plan = int8.gemm_plan(m, n, k, torch.cuda.get_device_properties(0)
                              .multi_processor_count)
        k5 = {**timed("", lambda: int8.quantize_rows(x), launches),
              "plain_ms": cuda_ms(lambda: int8.quantize_rows_plain(x), 5),
              **bound(0, nbytes(x, xq, xs), PEAK_INT8)}
        mm = int_mm(xq, wq)
        k6 = {**timed("", lambda: int8.int8_matmul(xq, xs, wq, ws, b), launches),
              "plain_ms": cuda_ms(lambda: int8.int8_matmul_plain(xq, xs, wq, ws, b), 3),
              **timed("bf16_", lambda: F.linear(x, w, b), launches),
              **(timed("int_mm_", mm, launches) if mm else
                 {"int_mm_ms": None, "int_mm_wall_ms": None}),
              **bound(2 * m * k * n, nbytes(xq, xs, wq, ws, b) + m * n * 2, PEAK_INT8)}
        for kname, rec, err in (("quantize_rows", k5, err5), ("int8_gemm", k6, err6)):
            extra = ({"route": plan.route, "splits": plan.splits, "grid": plan.grid}
                     if kname == "int8_gemm" else {})
            emit_kernel({"phase": "kernel", "name": kname, "shape": name, "mix": per,
                         "mkn": [m, k, n], "launches_miss": launches, **extra,
                         "max_abs_err": err, "tol": 0.0, **rec})
            worst[kname] = max(worst[kname], err)
            for key in mix[kname]:
                if key == "int_mm_launches":
                    mix[kname][key] += launches if mm else 0
                elif rec.get(key) is not None:
                    mix[kname][key] += launches * rec[key]
            if name == "img_qkv":
                # no single PyTorch call computes either (torch._int_mm has no
                # scaled epilogue); bf16 F.linear and _int_mm are printed above
                recs[kname] = {**rec, "library_ms": None}
        if err5 != 0 or err6 != 0:
            raise AssertionError(f"{name}: K5 error {err5}, K6 error {err6}: "
                                 "not bit-identical")
        del x, w, b, wq, ws, xq, xs, xq_ref, xs_ref
        torch.cuda.empty_cache()
    for kname, tot in mix.items():
        emit({"phase": "kernel_mix", "name": kname, "per": per,
              "launches": sum(n for *_, n in shapes), **tot,
              "bound_share": tot["bound_ms"] / tot["ms"],
              **({"vs_bf16_linear": tot["ms"] / tot["bf16_ms"]}
                 if kname == "int8_gemm" else {})})
    return recs


def bwd_exp2_bf16_argument(q_pre, k, v, do, lse, delta, mask):
    """(dQ, dK, dV) of K8 and K9 with one rounding point moved: P = exp2 of
    the bf16-rounded argument S2 − LSE2 (what the bf16x2 exp2 computes),
    everything else as the plain versions. GRAD_TOL must fail it."""
    import torch

    b, h, lq, d = q_pre.shape
    s = torch.matmul(q_pre.float(), k.float().transpose(-1, -2))
    s = s.masked_fill(~mask[:, None, None, :], -1e30)
    p = torch.exp2((s - lse.reshape(b, h, lq, 1)).bfloat16().float())
    del s
    ds = p * (torch.matmul(do.float(), v.float().transpose(-1, -2))
              - delta.reshape(b, h, lq, 1))
    dq = torch.matmul((ds * d ** -0.5).bfloat16().float(), k.float())
    dk = torch.matmul((ds * math.log(2)).bfloat16().float().transpose(-1, -2),
                      q_pre.float())
    dv = torch.matmul(p.bfloat16().float().transpose(-1, -2), do.float())
    return dq, dk, dv


def phase_train_kernels():
    """K7, K8 and K9 at the train step's attention shape: 2 rows, 24 heads,
    [256 text ⊕ 4096 target ⊕ 4096 condition] tokens, text padded after
    TXT_REAL. The plain versions run a few heads at a time (f32 scores). The
    library yardstick is SDPA: its forward for K7, its backward through
    autograd (dQ, dK and dV in one call) for K8 and K9. The backward with a
    bf16-rounded exp2 argument is held against the same plain versions and
    must miss GRAD_TOL."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.ops import flash_attention as fa

    bf16 = torch.bfloat16
    b, h, l = TRAIN_ROWS, 24, TXT_LEN + 2 * (SIZE // 16) ** 2
    q, k, v, do = (randn((b, h, l, 128), s, bf16) for s in (30, 31, 32, 33))
    mask = torch.ones((b, l), dtype=torch.bool, device="cuda")
    mask[:, TXT_REAL:TXT_LEN] = False
    out, lse = fa.flash_fwd_lse(q, k, v, mask, TXT_LEN)
    same_as_k1 = bool(torch.equal(out, fa.joint_attention(q, k, v, mask, TXT_LEN)))
    delta = (do.float() * out.float()).sum(-1).reshape(b * h, l)
    q_pre = fa.prescale_q(q)
    dq = fa.flash_bwd_dq(q_pre, k, v, do, lse, delta, mask, TXT_LEN)
    dk, dv = fa.flash_bwd_dkv(q_pre, k, v, do, lse, delta, mask, TXT_LEN)
    dead = ~mask
    dead_kv_nonzero = int(torch.count_nonzero(dk.transpose(1, 2)[dead])
                          + torch.count_nonzero(dv.transpose(1, 2)[dead]))

    g = 4  # heads per plain call
    lse4 = lse.reshape(b, h, l)
    dl4 = delta.reshape(b, h, l)

    def heads(i):
        s_ = slice(i, i + g)
        return (q_pre[:, s_], k[:, s_], v[:, s_], do[:, s_],
                lse4[:, s_].reshape(-1, l), dl4[:, s_].reshape(-1, l))

    def k7_plain():
        parts = [fa.flash_fwd_lse_plain(q[:, i:i + g], k[:, i:i + g], v[:, i:i + g],
                                        mask) for i in range(0, h, g)]
        return (torch.cat([o for o, _ in parts], 1),
                torch.cat([x.reshape(b, g, l) for _, x in parts], 1).reshape(b * h, l))

    def k8_plain():
        return torch.cat([fa.flash_bwd_dq_plain(*heads(i), mask)
                          for i in range(0, h, g)], 1)

    def k9_plain():
        parts = [fa.flash_bwd_dkv_plain(*heads(i), mask) for i in range(0, h, g)]
        return torch.cat([a for a, _ in parts], 1), torch.cat([c for _, c in parts], 1)

    ref_o, ref_lse = k7_plain()
    err7 = (out.float() - ref_o.float()).abs().max().item()
    tol7, ref_max7 = attn_tolerance(ref_o.float()), ref_o.abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    ref_dq = k8_plain()
    err8 = (dq - ref_dq).abs().max().item()
    tol8 = GRAD_TOL * ref_dq.abs().max().item()
    ref_dk, ref_dv = k9_plain()
    err9 = max((dk - ref_dk).abs().max().item(), (dv - ref_dv).abs().max().item())
    tol9 = GRAD_TOL * max(ref_dk.abs().max().item(), ref_dv.abs().max().item())
    # the wrong rounding point the limits must catch, against the same plain refs
    wrong8 = wrong9 = 0.0
    for i in range(0, h, g):
        s_ = slice(i, i + g)
        wq, wk, wv = bwd_exp2_bf16_argument(*heads(i), mask)
        wrong8 = max(wrong8, (wq - ref_dq[:, s_]).abs().max().item())
        wrong9 = max(wrong9, (wk - ref_dk[:, s_]).abs().max().item(),
                     (wv - ref_dv[:, s_]).abs().max().item())
        del wq, wk, wv
    del ref_o, ref_lse, ref_dq, ref_dk, ref_dv
    torch.cuda.empty_cache()

    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    o_lib = sdpa(qg, kg, vg, mask)
    lib_fwd = cuda_ms(lambda: sdpa(q, k, v, mask), 5)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(o_lib, (qg, kg, vg), do,
                                                  retain_graph=True), 5)
    del o_lib, qg, kg, vg
    torch.cuda.empty_cache()

    recs = {
        "flash_fwd_lse": {
            "max_abs_err": err7, "tol": tol7, "ref_max": ref_max7,
            "lse_max_abs_err": err_lse, "lse_tol": LSE_TOL,
            "o_equals_k1": same_as_k1,
            "ms": cuda_ms(lambda: fa.flash_fwd_lse(q, k, v, mask, TXT_LEN), 10),
            "plain_ms": cuda_ms(k7_plain, 2), "library_ms": lib_fwd,
            **attention_bound(q, k, v, (out, lse), mask, 4)},
        "flash_bwd_dq": {
            "max_abs_err": err8, "tol": tol8, "exp2_bf16_argument_err": wrong8,
            "ms": cuda_ms(lambda: fa.flash_bwd_dq(q_pre, k, v, do, lse, delta, mask,
                                                  TXT_LEN), 10),
            "plain_ms": cuda_ms(k8_plain, 2), "library_ms": lib_bwd,
            **attention_bound(q_pre, k, v, (dq,), mask, 6, (do, lse, delta))},
        "flash_bwd_dkv": {
            "max_abs_err": err9, "tol": tol9, "exp2_bf16_argument_err": wrong9,
            "masked_dkv_nonzero": dead_kv_nonzero,
            "ms": cuda_ms(lambda: fa.flash_bwd_dkv(q_pre, k, v, do, lse, delta, mask,
                                                   TXT_LEN), 10),
            "plain_ms": cuda_ms(k9_plain, 2), "library_ms": lib_bwd,
            **attention_bound(q_pre, k, v, (dk, dv), mask, 8, (do, lse, delta))},
    }
    for name, rec in recs.items():
        emit_kernel({"phase": "kernel", "name": name, "shape": [b, h, l, 128], **rec})
    if not same_as_k1:
        raise AssertionError("K7's O differs from K1's")
    if not err7 <= tol7:
        raise AssertionError(f"K7 error {err7} > {tol7}")
    if not err_lse <= LSE_TOL:
        raise AssertionError(f"K7 LSE error {err_lse} > {LSE_TOL}")
    if not (err8 <= tol8 and err9 <= tol9):
        raise AssertionError(f"K8 error {err8} (tol {tol8}), K9 {err9} (tol {tol9})")
    if not (wrong8 > tol8 and wrong9 > tol9):
        raise AssertionError(f"the limits pass a bf16 exp2 argument: dQ {wrong8} "
                             f"(tol {tol8}), dK/dV {wrong9} (tol {tol9})")
    if dead_kv_nonzero:
        raise AssertionError(f"{dead_kv_nonzero} nonzero dK/dV entries at masked keys")
    del q, k, v, do, out, lse, dq, dk, dv, q_pre, delta
    torch.cuda.empty_cache()
    return recs


def phase_block_parity():
    import dataclasses

    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.core.config import ModelConfig, StreamConfig
    from qwen_image_edit_streamdiffusion_tpu_torch.core.rng import stream
    from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm
    from qwen_image_edit_streamdiffusion_tpu_torch.models.optimize import fuse_qkv

    cfg = dataclasses.replace(ModelConfig(), num_layers=2)
    params = fuse_qkv(tfm.init(stream(0, "transformer", "cuda"), cfg, "cuda"))
    g = SIZE // 16
    img_shapes = ((1, g, g), (1, g, g))
    ropes = tfm.make_rope(cfg, img_shapes, TXT_LEN, "cuda")
    img = randn((1, 2 * g * g, cfg.in_channels), 10, torch.bfloat16)
    txt = randn((1, TXT_LEN, cfg.joint_dim), 11, torch.bfloat16)
    mask = torch.arange(TXT_LEN, device="cuda")[None] < TXT_REAL
    t = torch.tensor([500.0], device="cuda")
    outs = {}
    with torch.inference_mode():
        for flag in (True, False):
            use_flash = StreamConfig(use_flash_attention=flag).use_flash_attention
            outs[flag] = tfm.forward(params, cfg, img, txt, t, ropes, mask,
                                     use_flash=use_flash).float()
    a, b = outs[True], outs[False]
    rel = ((a - b).norm() / b.norm()).item()
    finite = bool(torch.isfinite(a).all().item())
    emit({"phase": "block_parity", "layers": 2, "tokens": img.shape[1] + TXT_LEN,
          "rel_l2": rel, "tol": BLOCK_TOL, "finite": finite})
    if not (finite and rel <= BLOCK_TOL):
        raise AssertionError(f"block parity rel-L2 {rel} > {BLOCK_TOL}")
    del params, outs, a, b
    torch.cuda.empty_cache()


def phase_train_parity():
    """The trainer's loss and adapter gradients through a 2-block flagship-
    width MMDiT at the 1024² edit shape, rank-16 adapters on the default
    targets (b drawn nonzero, so every adapter has a gradient), remat on:
    kernels (K7 forward, K8/K9 backward) vs plain attention under autograd."""
    import dataclasses

    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.core.config import ModelConfig
    from qwen_image_edit_streamdiffusion_tpu_torch.core.rng import stream
    from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm
    from qwen_image_edit_streamdiffusion_tpu_torch.models.optimize import fuse_qkv
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    cfg = dataclasses.replace(ModelConfig(), num_layers=2)
    params = fuse_qkv(tfm.init(stream(0, "transformer", "cuda"), cfg, "cuda"))
    tcfg = lt.TrainConfig(rank=TRAIN_RANK, alpha=16.0)
    lora = lt.init_lora(params, tcfg, stream(0, "lora"))
    leaves = lt.lora_leaves(lora)
    with torch.no_grad():
        gen = stream(1, "lora")
        for t in leaves[1::2]:  # the b of each target
            t.copy_(torch.randn(t.shape, generator=gen) * 0.01)
    g = SIZE // 16
    img_shapes = ((1, g, g), (1, g, g))
    ropes = tfm.make_rope(cfg, img_shapes, TXT_LEN, "cuda")
    x0 = randn((1, g * g, cfg.in_channels), 40, torch.bfloat16)
    cond = randn((1, g * g, cfg.in_channels), 41, torch.bfloat16)
    txt = randn((1, TXT_LEN, cfg.joint_dim), 42, torch.bfloat16)
    noise = randn((1, g * g, cfg.in_channels), 43, torch.float32)
    mask = torch.arange(TXT_LEN, device="cuda")[None] < TXT_REAL
    sigmas = torch.tensor([0.6], device="cuda")
    res = {}
    for flag in (True, False):
        kernels.reset_launches()
        loss = lt.flow_match_loss(params, lora, tcfg.alpha / tcfg.rank, cfg, x0, cond,
                                  txt, mask, sigmas, noise, ropes, use_flash=flag,
                                  remat=True)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        res[flag] = (loss.item(), [torch.zeros_like(p) if d is None else d.float()
                                   for p, d in zip(leaves, grads)],
                     dict(kernels.LAUNCHES))
        del loss, grads
        torch.cuda.empty_cache()
    (lf, gf, launches), (lp, gp, _) = res[True], res[False]
    rels = [((a - b).norm() / b.norm()).item() for a, b in zip(gf, gp)
            if b.norm().item() > 0]
    zero_ok = all(a.norm().item() == 0 for a, b in zip(gf, gp) if b.norm().item() == 0)
    finite = all(bool(torch.isfinite(a).all()) for a in gf)
    loss_rel = abs(lf - lp) / abs(lp)
    emit({"phase": "train_parity", "layers": 2, "rank": TRAIN_RANK,
          "tokens": 2 * g * g + TXT_LEN, "loss_kernels": lf, "loss_plain": lp,
          "loss_rel": loss_rel, "grad_rel_l2_max": max(rels),
          "grad_rel_l2_median": sorted(rels)[len(rels) // 2],
          "grads_compared": len(rels), "grads": len(gf), "tol": TRAIN_TOL,
          "finite": finite, "launches_kernels": {
              k: launches[k] for k in ("flash_fwd_lse", "flash_bwd_dq",
                                       "flash_bwd_dkv", "flash_joint")}})
    if not (finite and zero_ok and loss_rel <= TRAIN_TOL and max(rels) <= TRAIN_TOL):
        raise AssertionError(f"train parity: loss rel {loss_rel}, worst gradient "
                             f"rel-L2 {max(rels)} > {TRAIN_TOL}")
    if launches["flash_fwd_lse"] != 4 or launches["flash_bwd_dq"] != 2 \
            or launches["flash_bwd_dkv"] != 2 or launches["flash_joint"] != 0:
        raise AssertionError(f"train parity launches {launches}")
    del params, lora, leaves, res, gf, gp
    torch.cuda.empty_cache()


def phase_distill_parity():
    """One distillation step's v*, loss and adapter gradients through a
    2-block flagship-width MMDiT at the 1024² edit shape (rank-16 adapters,
    b drawn nonzero, remat on), the teacher on K1 and the student on K7-K9,
    against the same step on plain attention: unguided at interval 0, then
    guided (negative text of fewer tokens, scale 4) at interval 1, the same
    weights, intervals and ε on both sides."""
    import dataclasses

    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.core.config import (
        ModelConfig,
        SchedulerConfig,
    )
    from qwen_image_edit_streamdiffusion_tpu_torch.core.rng import stream
    from qwen_image_edit_streamdiffusion_tpu_torch.models import scheduler as sched
    from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm
    from qwen_image_edit_streamdiffusion_tpu_torch.models.optimize import fuse_qkv
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels
    from qwen_image_edit_streamdiffusion_tpu_torch.training import distill as dt
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    cfg = dataclasses.replace(ModelConfig(), num_layers=2)
    params = fuse_qkv(tfm.init(stream(0, "transformer", "cuda"), cfg, "cuda"))
    tcfg = lt.TrainConfig(rank=TRAIN_RANK, alpha=16.0)
    lora = lt.init_lora(params, tcfg, stream(0, "lora"))
    leaves = lt.lora_leaves(lora)
    with torch.no_grad():
        gen = stream(2, "lora")
        for t in leaves[1::2]:
            t.copy_(torch.randn(t.shape, generator=gen) * 0.01)
    g = SIZE // 16
    img_shapes = ((1, g, g), (1, g, g))
    ropes = tfm.make_rope(cfg, img_shapes, TXT_LEN, "cuda")
    sigmas = sched.make_schedule(STEPS, g * g, SchedulerConfig()).sigmas
    x0 = randn((1, g * g, cfg.in_channels), 50, torch.bfloat16)
    cond = randn((1, g * g, cfg.in_channels), 51, torch.bfloat16)
    txt = randn((1, TXT_LEN, cfg.joint_dim), 52, torch.bfloat16)
    neg = randn((1, TXT_LEN, cfg.joint_dim), 53, torch.bfloat16)
    eps = randn((1, g * g, cfg.in_channels), 54, torch.float32)
    mask = torch.arange(TXT_LEN, device="cuda")[None] < TXT_REAL
    neg_mask = torch.arange(TXT_LEN, device="cuda")[None] < NEG_REAL
    for i, scale in ((0, 0.0), (1, CFG_SCALE)):
        dcfg = dt.DistillConfig(train=tcfg, student_steps=STEPS, teacher_cfg_scale=scale)
        res = {}
        for flag in (True, False):
            kernels.reset_launches()
            loss, v_star = dt.distill_loss(
                params, lora, tcfg.alpha / tcfg.rank, cfg, dcfg, x0, cond, txt, mask,
                neg, neg_mask, sigmas[i:i + 1].cuda(), sigmas[i + 1:i + 2].cuda(), eps,
                ropes, use_flash=flag, remat=True)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            res[flag] = (loss.item(), v_star, [
                torch.zeros_like(p) if d is None else d.float()
                for p, d in zip(leaves, grads)], dict(kernels.LAUNCHES))
            del loss, grads
            torch.cuda.empty_cache()
        (lf, vf, gf, launches), (lp, vp, gp, _) = res[True], res[False]
        rels = [((a - b).norm() / b.norm()).item() for a, b in zip(gf, gp)
                if b.norm().item() > 0]
        zero_ok = all(a.norm().item() == 0 for a, b in zip(gf, gp) if b.norm().item() == 0)
        finite = all(bool(torch.isfinite(a).all()) for a in gf) and bool(
            torch.isfinite(vf).all())
        v_rel = ((vf - vp).norm() / vp.norm()).item()
        loss_rel = abs(lf - lp) / abs(lp)
        want = {"flash_joint": 2 * 2 * (2 if dcfg.guided else 1), "flash_fwd_lse": 4,
                "flash_bwd_dq": 2, "flash_bwd_dkv": 2, "flash_joint_stream": 0}
        emit({"phase": "distill_parity", "layers": 2, "rank": TRAIN_RANK,
              "interval": i, "teacher_cfg_scale": scale,
              "tokens": 2 * g * g + TXT_LEN, "v_star_rel_l2": v_rel,
              "loss_kernels": lf, "loss_plain": lp, "loss_rel": loss_rel,
              "grad_rel_l2_max": max(rels), "grads_compared": len(rels),
              "grads": len(gf), "tol": TRAIN_TOL, "finite": finite,
              "launches_kernels": {k: launches[k] for k in want}})
        if not (finite and zero_ok and v_rel <= TRAIN_TOL and loss_rel <= TRAIN_TOL
                and max(rels) <= TRAIN_TOL):
            raise AssertionError(f"distill parity (interval {i}): v* rel {v_rel}, "
                                 f"loss rel {loss_rel}, worst gradient rel-L2 "
                                 f"{max(rels)} > {TRAIN_TOL}")
        check_counts(f"distill parity (interval {i})", launches, want)
        del res, vf, vp, gf, gp
    del params, lora, leaves
    torch.cuda.empty_cache()


def distinct_image(i: int, size: int = SIZE):
    """A size² gradient test image with a per-i tint, so caches miss per i."""
    import numpy as np

    y = np.linspace(0, 1, size)[:, None]
    x = np.linspace(0, 1, size)[None, :]
    base = np.stack([100 + 100 * np.broadcast_to(y, (size, size)),
                     100 + 100 * np.broadcast_to(x, (size, size)),
                     np.full((size, size), 150.0)], axis=-1).astype(np.uint8)
    tint = np.random.default_rng(i).integers(0, 64, (3,), np.int32)
    return np.clip(base.astype(np.int32) + tint, 0, 255).astype(np.uint8)


class RowSpy:
    """Records the batch rows of each K1/K4, K2 and K3 call of a request by
    wrapping the wrappers (each still counts its own launch, once):
    {counter: {rows: calls}}, K1/K4 keyed "rows x keys"; K2's calls also
    under "flash_causal_len", keyed "rows x length"."""

    def __init__(self):
        self.rows = {}
        self._saved = []

    def _note(self, counter, key):
        per = self.rows.setdefault(counter, {})
        per[key] = per.get(key, 0) + 1

    def __enter__(self):
        from qwen_image_edit_streamdiffusion_tpu_torch.ops import conv as conv_ops
        from qwen_image_edit_streamdiffusion_tpu_torch.ops import flash_attention as fa

        def spy(mod, name, note):
            real = getattr(mod, name)

            def wrapped(*args, **kw):
                note(*args)
                return real(*args, **kw)

            self._saved.append((mod, name, real))
            setattr(mod, name, wrapped)

        spy(fa, "joint_attention", lambda q, k, *_: self._note(
            "flash_joint_stream" if fa.streams_kv(k) else "flash_joint",
            f"{q.shape[0]}x{k.shape[2]}"))
        spy(fa, "causal_attention", lambda q, *_: (
            self._note("flash_causal", str(q.shape[0])),
            self._note("flash_causal_len", f"{q.shape[0]}x{q.shape[2]}")))
        spy(conv_ops, "conv3x3", lambda x, *_: self._note("conv3x3", str(x.shape[0])))
        return self

    def __exit__(self, *exc):
        for mod, name, real in reversed(self._saved):
            setattr(mod, name, real)
        self._saved.clear()


def serve(label: str, name: str, call, want: dict, rows=None, outputs: int = 1,
          **info):
    """Run one request (``call()`` returns an EditResult or a list of them),
    print its wall seconds, launch counts, rows a kernel call, outputs and
    peak bytes, and raise unless every count in ``want`` and ``rows`` and
    the outputs (``outputs`` (1024, 1024, 3) uint8 arrays, finite latents)
    are as expected. Returns (results list, latents of the first)."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

    before = dict(kernels.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    with RowSpy() as spy:
        res = call()
        torch.cuda.synchronize()
    wall = time.time() - t0
    results = res if isinstance(res, list) else [res]
    images = [img for r in results for img in r.images]
    delta = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
    finite = all(bool(torch.isfinite(r.latents).all().item()) for r in results)
    out = images[0]
    emit({"phase": "request", "path": label, "name": name, **info,
          "seconds": wall, "launches": delta, "rows": spy.rows,
          "outputs": len(images), "shape": list(out.shape), "dtype": str(out.dtype),
          "latents": list(results[0].latents.shape), "latents_finite": finite,
          "pixel_mean": float(out.mean()),
          "peak_bytes": torch.cuda.max_memory_allocated()})
    for key, n in want.items():
        if delta[key] != n:
            raise AssertionError(f"{label}/{name}: {key} ran {delta[key]} times, "
                                 f"not {n}")
    for key, per in (rows or {}).items():
        if spy.rows.get(key) != per:
            raise AssertionError(f"{label}/{name}: {key} rows {spy.rows.get(key)}, "
                                 f"not {per}")
    if len(images) != outputs or not finite or any(
            i.shape != (SIZE, SIZE, 3) or str(i.dtype) != "uint8" for i in images):
        raise AssertionError(f"{label}/{name}: bad outputs {len(images)} "
                             f"{[(i.shape, str(i.dtype)) for i in images]} "
                             f"finite={finite}")
    return results


def run_requests(pipe, requests, label: str, latents=None):
    """Serve ``requests`` (name, images, prompt, expected launches) one by
    one through :func:`serve`. Returns the launches of the whole path,
    counted from 0 just before it; fills ``latents`` (name → final latents)
    when given."""
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

    kernels.reset_launches()
    for name, imgs, prompt, want in requests:
        res = serve(label, name, lambda: pipe(imgs if len(imgs) > 1 else imgs[0],
                                              prompt, num_inference_steps=STEPS,
                                              seed=42),
                    want, images=len(imgs))
        if latents is not None:
            latents[name] = res[0].latents
    return dict(kernels.LAUNCHES)


def expected(miss: bool, n_images: int = 1, int8_miss: int = 0,
             int8_per_request: int = 0, k1: int = K1_LAUNCHES,
             encodes=None, k2: int = K2_LAUNCHES):
    """Launches of one request: K1 (or K4 with two images) once per MMDiT
    layer and forward (``k1``), K2 per LM layer on a miss, K3 per decoder
    conv of K3_MIX and, on a miss, per encoder conv and encode call
    (``encodes``, one per image unless a wave batches them), K5/K6 per
    quantized linear."""
    joint = "flash_joint_stream" if n_images > 1 else "flash_joint"
    other = "flash_joint" if n_images > 1 else "flash_joint_stream"
    q = int8_per_request + (int8_miss if miss else 0)
    decoder = sum(hit for *_, hit in K3_MIX)
    encoder = sum(n - hit for *_, n, hit in K3_MIX)
    encodes = n_images if encodes is None else encodes
    return {joint: k1, other: 0,
            "flash_causal": k2 if miss else 0,
            "conv3x3": decoder + (encodes * encoder if miss else 0),
            "quantize_rows": q, "int8_gemm": q,
            "flash_fwd_lse": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def create_pipeline(label: str, **quant):
    """The flagship pipeline on the card, quantized in place when asked;
    prints its creation time, peak and resident device bytes and weight
    bytes."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.core.config import StreamConfig
    from qwen_image_edit_streamdiffusion_tpu_torch.models.common import param_count
    from qwen_image_edit_streamdiffusion_tpu_torch.models.quantize import (
        quantized_bytes,
    )
    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.edit_pipeline import (
        EditPipeline,
    )

    config = StreamConfig(width=SIZE, height=SIZE, num_inference_steps=STEPS,
                          cfg_mode="none", **quant)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pipe = EditPipeline.create("qwen-image-edit-2509", config, seed=0,
                               device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "create", "path": label, "preset": "qwen-image-edit-2509",
          "quant": quant, "seconds": time.time() - t0,
          "params_tfm": param_count(pipe.tfm_params),
          "params_vl": param_count(pipe.encoder.params),
          "params_vae": param_count(pipe.vae_params),
          "weight_bytes": {"tfm": quantized_bytes(pipe.tfm_params),
                           "vl": quantized_bytes(pipe.encoder.params),
                           "vae": quantized_bytes(pipe.vae_params)},
          "device_bytes": torch.cuda.memory_allocated(),
          "peak_bytes_during_create": torch.cuda.max_memory_allocated()})
    return pipe


def phase_slice():
    """The bf16 flagship: one-image misses and hits, then a two-image edit;
    then, on the same pipeline, the guided and batched edits, the tiny
    decoder, the realtime stream, the yuv420 wire, the LoRA fine-tune and
    the LoRA-fused edit."""
    pipe = create_pipeline("bf16")
    two = [distinct_image(2000), distinct_image(2001)]
    requests = ([("warmup", [distinct_image(1000)], "warmup", expected(True))]
                + [(f"miss{i}", [distinct_image(i)], PROMPT, expected(True))
                   for i in range(2)]
                + [(f"hit{i}", [distinct_image(0)], PROMPT, expected(False))
                   for i in range(2)]
                + [("two_images", two, PROMPT, expected(True, 2))])
    latents = {}
    launches = run_requests(pipe, requests, "bf16", latents)
    for k, n in profile_request(pipe, "bf16", expected(True), 6000).items():
        launches[k] += n
    for phase in (phase_guided, phase_tiny, phase_stream, phase_yuv420,
                  phase_serve):
        for k, n in sub(phase, pipe).items():
            launches[k] += n
    train_launches, adapters = sub(phase_train, pipe)
    more = [train_launches] + [sub(phase, pipe) for phase in (
        phase_distill, phase_tiny_train)]
    more.append(sub(phase_lora_serve, pipe, adapters, latents["hit1"]))
    for delta in more:
        for k, n in delta.items():
            launches[k] += n
    return launches


def sub(fn, *args):
    """``fn(*args)``, printing its wall seconds (``phase_seconds``, the name
    of a part of phase slice)."""
    t0 = time.time()
    out = fn(*args)
    emit({"phase": "phase_seconds", "name": fn.__name__, "part_of": "phase_slice",
          "seconds": time.time() - t0})
    return out


def guided(pipe, mode: str, image, negative_prompt=NEG, **kw):
    """A call of a guided edit in ``mode`` (set on the live pipeline's
    config, as the JAX ``load_tiny_decoder`` replaces it)."""
    def call():
        pipe.config = pipe.config.replace(cfg_mode=mode)
        return pipe(image, PROMPT, negative_prompt=negative_prompt,
                    true_cfg_scale=CFG_SCALE, num_inference_steps=STEPS,
                    seed=42, **kw)
    return call


def k1_rows(rows: int, n: int = K1_LAUNCHES, txt: int = TXT_LEN, images: int = 1):
    """RowSpy key → calls of n K1 (K4 beyond one image) launches of ``rows``
    rows over [txt ⊕ target ⊕ images] keys."""
    lk = txt + (1 + images) * (SIZE // 16) ** 2
    return {"flash_joint_stream" if images > 1 else "flash_joint": {f"{rows}x{lk}": n}}


def phase_guided(pipe) -> dict:
    """Guided and batched edits on the bf16 pipeline (negative prompt "",
    scale 4): a batched-CFG miss (K1 at 2 rows, one LM call over the
    pos+neg pair: K2 28) and hit, a sequential, an rcfg (first step 2 rows,
    then 1) and an rcfg-self miss (1 row), a parallel hit (= batched, the
    same latents), a negative prompt in the next text bucket (320 tokens:
    the padding path, two different row masks), a two-image batched edit
    (K4's role at 2 rows), ``num_images_per_prompt=2`` under rcfg-self (K3's
    decode at batch 2) and ``edit_many`` of two items under batched CFG (4
    rows, one batched condition encode); then a plain rcfg-self miss, and a
    plain and a profiled miss each of batched and sequential."""
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

    kernels.reset_launches()
    miss, hit = expected(True), expected(False)
    one = {"flash_causal": {"2": K2_LAUNCHES}}
    b2 = {**k1_rows(2), "conv3x3": {"1": 20}}
    hit_img = distinct_image(7000)
    res = {}
    for name, call, want, rows, outputs in (
            ("cfg_batched_miss", guided(pipe, "batched", hit_img), miss,
             {**b2, **one}, 1),
            ("cfg_batched_hit", guided(pipe, "batched", hit_img), hit,
             {**k1_rows(2), "conv3x3": {"1": 15}}, 1),
            ("cfg_parallel_hit", guided(pipe, "parallel", hit_img), hit,
             {**k1_rows(2), "conv3x3": {"1": 15}}, 1),
            ("cfg_sequential_miss", guided(pipe, "sequential", distinct_image(7001)),
             expected(True, k1=2 * K1_LAUNCHES), {**k1_rows(1, 2 * K1_LAUNCHES), **one}, 1),
            ("cfg_rcfg_miss", guided(pipe, "rcfg", distinct_image(7002)), miss,
             {"flash_joint": {f"2x{TXT_LEN + 8192}": MMDIT_LAYERS,
                              f"1x{TXT_LEN + 8192}": MMDIT_LAYERS}, **one}, 1),
            ("cfg_rcfg_self_miss", guided(pipe, "rcfg-self", distinct_image(7003)),
             miss, {**k1_rows(1), **one}, 1),
            ("cfg_long_negative_miss",
             guided(pipe, "batched", distinct_image(7004), negative_prompt=LONG_NEG),
             miss, {**k1_rows(2, txt=320), **one}, 1),
            ("cfg_two_images_miss",
             guided(pipe, "batched", [distinct_image(7005), distinct_image(7006)]),
             expected(True, 2), {**k1_rows(2, txt=TXT_LEN_TWO, images=2), **one}, 1),
            ("num_images_2_rcfg_self",
             guided(pipe, "rcfg-self", distinct_image(7007), num_images_per_prompt=2),
             miss, {**k1_rows(2), **one, "conv3x3": {"1": 5, "2": 15}}, 2),
            ("edit_many_2_batched", lambda: edit_many_pair(pipe),
             expected(True, encodes=1),
             {**k1_rows(4), "flash_causal": {"4": K2_LAUNCHES}, "conv3x3": {"2": 20}}, 2)):
        res[name] = serve("bf16", name, call, want, rows, outputs)
    same = max((a.latents - b.latents).abs().max().item() for a, b in
               zip(res["cfg_parallel_hit"], res["cfg_batched_hit"]))
    variants = res["num_images_2_rcfg_self"][0].images
    distinct = not (variants[0] == variants[1]).all()
    emit({"phase": "guided_checks", "parallel_vs_batched_max_abs": same,
          "num_images_outputs_distinct": bool(distinct)})
    if same != 0 or not distinct:
        raise AssertionError(f"parallel differs from batched by {same}, or the "
                             f"two variations are equal ({not distinct})")
    serve("bf16", "cfg_rcfg_self_plain", guided(pipe, "rcfg-self", distinct_image(7010)),
          miss)
    launches = dict(kernels.LAUNCHES)
    for mode, image in (("batched", 7020), ("sequential", 7030)):
        for k, n in profile_request(pipe, f"bf16 {mode} cfg", dict(
                miss, flash_joint=(2 if mode == "sequential" else 1) * K1_LAUNCHES),
                image, cfg_mode=mode).items():
            launches[k] += n
    pipe.config = pipe.config.replace(cfg_mode="none")
    return launches


def edit_many_pair(pipe):
    pipe.config = pipe.config.replace(cfg_mode="batched")
    items = [{"image": distinct_image(7008 + i), "prompt": PROMPT,
              "negative_prompt": NEG, "seed": 42 + i} for i in range(2)]
    return pipe.edit_many(items, num_inference_steps=STEPS, true_cfg_scale=CFG_SCALE)


# The tiny decoder's convs at 1024² out (width 64, 2 blocks a stage, 3
# upsamples): (H = W, C_in, F, launches a decode)
TINY_MIX = ((SIZE // 8, 16, 64, 1), (SIZE // 8, 64, 64, 4), (SIZE // 4, 64, 64, 5),
            (SIZE // 2, 64, 64, 5), (SIZE, 64, 64, 5), (SIZE, 64, 3, 1))
TINY_DECODER = os.path.join(ROOT, "artifacts", "tiny_decoder_bench-2b.safetensors")
TINY_ENCODER = os.path.join(ROOT, "artifacts", "tiny_encoder_bench-2b.safetensors")
TINY_TOL = 2e-2    # rel-L2 of the tiny decode, card (cuDNN) vs CPU, bf16


def phase_tiny(pipe) -> dict:
    """The trained tiny pair loaded into the live pipeline; two cache-hit
    edits decoded by the tiny decoder (K3 0: the tiny chain is F.conv2d, as
    JAX's is XLA); a profiled hit with each decoder; the decode stage
    alone, tiny and full; the tiny decode on the card against the same
    module on the CPU (a 16² latent crop); the tiny decoder's conv shapes
    through F.conv2d (cuDNN, what it runs) and through K3, both
    graph-timed."""
    import torch
    import torch.nn.functional as F

    from qwen_image_edit_streamdiffusion_tpu_torch.models import tiny_vae
    from qwen_image_edit_streamdiffusion_tpu_torch.models import vae as vae_mod
    from qwen_image_edit_streamdiffusion_tpu_torch.ops import conv as conv_ops
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

    kernels.reset_launches()
    t0 = time.time()
    pipe.load_tiny_decoder(TINY_DECODER)
    pipe.load_tiny_encoder(TINY_ENCODER)
    emit({"phase": "tiny_load", "seconds": time.time() - t0,
          "decoder": str(pipe.tiny_vae[1]), "encoder": str(pipe.tiny_encoder[1])})
    want = {**expected(False), "conv3x3": 0}
    for name in ("tiny_decoder_hit0", "tiny_decoder_hit1"):  # the first loads cuDNN's
        res = serve("bf16+tiny", name,
                    lambda: pipe(distinct_image(0), PROMPT, num_inference_steps=STEPS,
                                 seed=42), want, {"conv3x3": None})
    launches = dict(kernels.LAUNCHES)
    for decoder in ("tiny", "full"):  # where a hit's time goes with each decoder
        pipe.config = pipe.config.replace(decoder=decoder)
        profile_hit(pipe, f"bf16+{decoder} decoder")
    pipe.config = pipe.config.replace(decoder="tiny")
    params, tcfg = pipe.tiny_vae
    z = res[0].latents[:, :16, :16].contiguous()
    with torch.inference_mode():
        card = tiny_vae.decode(params, tcfg, z).float().cpu()
        cpu = tiny_vae.decode(_to_cpu(params), tcfg, z.cpu()).float()
    rel = ((card - cpu).norm() / cpu.norm()).item()
    pipe.config = pipe.config.replace(decoder="full")
    # the decode stage alone: tiny against the full VAE on the hit's latents
    z = res[0].latents
    with torch.inference_mode():
        stage = {"tiny_decode_ms": cuda_ms(lambda: tiny_vae.decode(params, tcfg, z), 5),
                 "full_decode_ms": cuda_ms(lambda: vae_mod.decode(
                     pipe.vae_params, pipe.preset.vae, z.to(torch.bfloat16)), 5),
                 "tiny_decode_profile": profile_call(
                     lambda: tiny_vae.decode(params, tcfg, z))}
    emit({"phase": "tiny_decode_stage", **stage})
    mix = {"cudnn_ms": 0.0, "k3_ms": 0.0, "bound_ms": 0.0, "launches": 0}
    worst = 0.0
    bf16 = torch.bfloat16
    for size, cin, f, n in TINY_MIX:
        x = randn((1, size, size, cin), 50, bf16)
        w = (randn((3, 3, cin, f), 51, torch.float32) * (9 * cin) ** -0.5).to(bf16)
        b = randn((f,), 52, bf16) * 0.1
        wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        ref = conv_ops.conv3x3_plain(x, w, b).float()
        err = (conv_ops.conv3x3(x, w, b).float() - ref).abs().max().item()
        tol = conv_tolerance(ref)
        worst = max(worst, err / tol)
        rec = {"phase": "kernel", "name": "conv3x3", "mix": "tiny decoder",
               "shape": [1, size, size, cin, f], "launches_decode": n,
               "max_abs_err": err, "tol": tol,
               **timed("cudnn_", lambda: F.conv2d(x.permute(0, 3, 1, 2), wl, b,
                                                  padding=1), n, 10),
               **timed("k3_", lambda: conv_ops.conv3x3(x, w, b), n, 10),
               **bound(2 * size * size * 9 * cin * f,
                       nbytes(x, w, b) + size * size * f * 2, PEAK_BF16)}
        emit({**rec, "k3_vs_cudnn": rec["k3_ms"] / rec["cudnn_ms"]})
        if not err <= tol:
            raise AssertionError(f"K3 error {err} > {tol} at the tiny shape {size}² "
                                 f"{cin}->{f}")
        for key in ("cudnn_ms", "k3_ms", "bound_ms"):
            mix[key] += n * rec[key]
        mix["launches"] += n
        del x, w, b, wl, ref
    torch.cuda.empty_cache()
    emit({"phase": "tiny_checks", "card_vs_cpu_rel_l2": rel, "tol": TINY_TOL,
          "conv_mix_per_decode": mix, "k3_vs_cudnn": mix["k3_ms"] / mix["cudnn_ms"]})
    if not rel <= TINY_TOL:
        raise AssertionError(f"tiny decode card vs CPU rel-L2 {rel} > {TINY_TOL}")
    return launches


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


# The realtime stream (phase stream), the JAX suite's bench_stream on the live
# flagship: 512² in and out, 2 steps, a keyframe every 10 processed frames,
# the yuv420 wire, prompts frozen once.
STREAM_SIZE = 512
STREAM_FRAMES = 12
STREAM_INTERVAL = 10
STREAM_MAX_SKIP = 3
STREAM_PROMPT_B = "Turn it into a watercolor painting"
# rel-L2 of a batched row's latents against its session alone: sound rows
# read 3.5-4.0e-4 on the H100; a row given the other session's noise reads
# 0.067 (planted in stream_batched, with a text swap that the exact row
# check catches)
STREAM_TOL = 4e-3
STREAM_LM_LEN = 128  # the LM's 128-token bucket of a text-only stream prompt
# K3's shapes at 512²: K3_MIX at half the size; a full-VAE decode and encode
STREAM_K3_MIX = tuple((size // 2, cin, f, n, hit) for size, cin, f, n, hit in K3_MIX)
K3_DECODE = sum(hit for *_, hit in K3_MIX)
K3_ENCODE = sum(n - hit for *_, n, hit in K3_MIX)


def stream_config(pipe, size: int = STREAM_SIZE, **kw):
    """bench_stream's StreamConfig on the live pipeline's: size² in and
    out, 2 steps, a keyframe every STREAM_INTERVAL frames, yuv420, cond-only,
    the full VAE both ways, no similarity filter, no preview; ``kw`` on top."""
    base = dict(width=size, height=size, vae_image_area=size * size,
                vl_image_area=min(384 * 384, size * size), num_inference_steps=STEPS,
                keyframe_interval=STREAM_INTERVAL, transfer_format="yuv420",
                preview_scale=1, cfg_mode="none", similarity_filter=False,
                decoder="full", encoder="full")
    return pipe.config.replace(**{**base, **kw})


def stream_image(kind: str = "gradient", size: int = STREAM_SIZE, phase: float = 0.0):
    from qwen_image_edit_streamdiffusion_tpu_torch.core import imaging

    return imaging.make_test_image(size, size, kind, phase)


def frame_want(key: bool, k3=None, int8: int = 0, layers: int = MMDIT_LAYERS) -> dict:
    """Launches of one 2-step stream frame: K1 once a layer a forward (two
    forwards a keyframe, one a temporal frame), K3 for a full-VAE encode
    and decode unless ``k3`` says otherwise, K2 0, K5/K6 ``int8``."""
    return {"flash_joint": (2 if key else 1) * layers, "flash_joint_stream": 0,
            "flash_causal": 0, "conv3x3": K3_ENCODE + K3_DECODE if k3 is None else k3,
            "quantize_rows": int8, "int8_gemm": int8}


def launch_delta(before: dict) -> dict:
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

    return {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}


def check_counts(where: str, delta: dict, want: dict, rows=None, spy=None) -> None:
    for key, n in want.items():
        if delta[key] != n:
            raise AssertionError(f"{where}: {key} ran {delta[key]} times, not {n}")
    for key, per in (rows or {}).items():
        if spy.rows.get(key) != per:
            raise AssertionError(f"{where}: {key} rows {spy.rows.get(key)}, not {per}")


def stream_frame(rt, label: str, name: str, want: dict, rows=None, image=None,
                 size: int = STREAM_SIZE):
    """One ``process_frame`` of ``rt``: wall seconds, launches, the rows of
    every K1/K2/K3 call, the frame and its latent; raises unless the counts,
    the rows and the (size, size, 3) uint8 frame are as expected."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

    image = stream_image(size=size) if image is None else image
    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.time()
    with RowSpy() as spy:
        out = rt.process_frame(image)
        torch.cuda.synchronize()
    wall = time.time() - t0
    delta = launch_delta(before)
    finite = bool(torch.isfinite(rt.prev_latent).all().item())
    emit({"phase": "stream_frame", "path": label, "name": name, "keyframe": rt.is_keyframe,
          "seconds": wall, "launches": {k: n for k, n in delta.items() if n},
          "rows": spy.rows, "shape": list(out.shape), "dtype": str(out.dtype),
          "latent": list(rt.prev_latent.shape), "latent_finite": finite,
          "pixel_mean": float(out.mean())})
    check_counts(f"{label}/{name}", delta, want, rows, spy)
    if out.shape != (size, size, 3) or str(out.dtype) != "uint8" or not finite:
        raise AssertionError(f"{label}/{name}: frame {out.shape} {out.dtype}, "
                             f"latent finite {finite}")
    return out


def stream_bench(rt, label: str, pipelined: bool, frames: int = STREAM_FRAMES,
                 rows_per_forward: int = 1) -> dict:
    """``run_benchmark`` of ``frames`` frames: s/frame and fps (the
    sequential run also times its keyframes and temporal frames apart, from
    ``inference_times``); K1 must run once a layer a forward of each frame."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

    os.makedirs(os.path.join(ROOT, "build", "chip_smoke"), exist_ok=True)
    first = rt.frame_count
    keys = sum((first + i) % rt.config.keyframe_interval == 0 for i in range(frames))
    if rt.prev_latent is None and first % rt.config.keyframe_interval != 0:
        keys += 1
    rt.inference_times.clear()
    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.time()
    fps = rt.run_benchmark(frames, pipelined=pipelined, output_path=os.path.join(
        ROOT, "build", "chip_smoke", f"stream_{label.replace(' ', '_')}.png"))
    wall = time.time() - t0
    delta = launch_delta(before)
    rec = {"phase": "stream_bench", "path": label,
           "mode": "pipelined" if pipelined else "sequential", "frames": frames,
           "keyframes": keys, "fps": fps, "s_per_frame": wall / frames, "wall_s": wall,
           "launches": {k: n for k, n in delta.items() if n}}
    if not pipelined:
        kinds = [(first + i) % rt.config.keyframe_interval == 0 for i in range(frames)]
        times = rt.inference_times[-frames:]
        rec["keyframe_s"] = [t for t, k in zip(times, kinds) if k]
        rec["temporal_s"] = [t for t, k in zip(times, kinds) if not k]
        rec["temporal_s_median"] = statistics.median(rec["temporal_s"])
    emit(rec)
    check_counts(f"{label} {rec['mode']}", delta,
                 {"flash_joint": (frames + keys) * rows_per_forward * MMDIT_LAYERS,
                  "flash_causal": 0})
    return rec


def lm_tokens(pipe, prompt: str) -> int:
    """The real LM tokens of a text-only prompt (its chat template's ids)."""
    from qwen_image_edit_streamdiffusion_tpu_torch.models import qwen_vl

    enc = pipe.encoder
    return len(qwen_vl.build_chat_ids(enc.tokenizer, prompt, [], drop_idx=enc.drop_idx)[0])


def precompute(rt, label: str, prompt: str, negative_prompt=None, k2_rows: int = 1):
    """Freeze the prompt conditioning: K2 28 at ``k2_rows`` rows of
    STREAM_LM_LEN (one LM call over the wave), nothing else on the card's
    kernels."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

    for text in (prompt, negative_prompt):
        if text is not None and not lm_tokens(rt.pipe, text) <= STREAM_LM_LEN:
            raise AssertionError(f"{label}: {text!r} is longer than the LM bucket")

    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.time()
    with RowSpy() as spy:
        rt.precompute_conditions(prompt, negative_prompt=negative_prompt)
        torch.cuda.synchronize()
    delta = launch_delta(before)
    emit({"phase": "stream_precompute", "path": label, "seconds": time.time() - t0,
          "txt": list(rt._frozen_txt.shape), "real": int(rt._frozen_mask.sum().item()),
          "launches": {k: n for k, n in delta.items() if n}, "rows": spy.rows})
    check_counts(f"{label}/precompute", delta,
                 {"flash_causal": K2_LAUNCHES, "flash_joint": 0, "conv3x3": 0},
                 {"flash_causal": {str(k2_rows): K2_LAUNCHES},
                  "flash_causal_len": {f"{k2_rows}x{STREAM_LM_LEN}": K2_LAUNCHES}}, spy)
    return rt._frozen_txt.shape[1]


# CUDA runtime calls that make the host wait for the card (or for a copy)
HOST_WAIT_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
                   "cudaMemcpy", "cudaMemcpy2D", "cudaMemset", "cudaFree", "cudaFreeHost")
# a copy call that holds the host this long (µs) waited for the stream: a
# pinned copy is queued in microseconds, and a full launch queue frees a slot
# within one kernel's time
COPY_WAIT_US = 10_000


def host_waits(fn):
    """Runs ``fn`` under torch.profiler (then synchronizes); returns its
    result, what ``fn`` itself did that makes the host wait, and the copies
    the profiler recorded. Waits: the runtime calls of HOST_WAIT_CALLS in
    its host window, a ``cudaMemcpyAsync`` there that held the host over
    COPY_WAIT_US (the driver may drain the stream before a copy from
    pageable memory: a wait ``set_sync_debug_mode`` does not see), and
    every recorded copy from or to pageable memory. The device's copy
    records can go missing in a long process, so the runtime calls are the
    firm part."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("submits"):
            out = fn()
        torch.cuda.synchronize()
    events = prof.events()
    win = next(e.time_range for e in events
               if e.name == "submits" and e.device_type == torch.autograd.DeviceType.CPU)
    waits, copies = {}, {"cudaMemcpyAsync_max_us": 0.0}
    for e in events:
        inside = win.start <= e.time_range.start and e.time_range.end <= win.end
        held = e.time_range.end - e.time_range.start
        name = e.name
        if e.name.startswith("Memcpy"):
            copies[name] = copies.get(name, 0) + 1
        if inside and name == "cudaMemcpyAsync":
            copies["cudaMemcpyAsync_max_us"] = max(copies["cudaMemcpyAsync_max_us"], held)
            name = f"cudaMemcpyAsync over {COPY_WAIT_US} us" if held > COPY_WAIT_US else ""
        if ((name in HOST_WAIT_CALLS and inside) or name.startswith("cudaMemcpyAsync over")
                or (name.startswith("Memcpy") and "Pageable" in name)):
            waits[name] = waits.get(name, 0) + 1
    return out, waits, copies


# the hold's own time-out (s): a submit's host time is about 0.25 s on the
# card's host, so an honest submit returns well inside it
HOLD_TIMEOUT_S = 8.0
HOLD_SOURCE = "scripts/sync_hold.cu"


class SyncHold:
    """A device-side hold (``scripts/sync_hold.cu``, built at first use with
    nvcc for sm_90a into ``build/kernels/`` and loaded with ctypes, as
    ``runtime/kernels.py`` builds the port's kernels; no fallback): one
    thread spins on a flag in mapped pinned host memory until the host sets
    it or HOLD_TIMEOUT_S pass on the card's clock, and records which came
    first. :meth:`around_pack` launches it just before a stream frame's pixel
    pack, so only the pack's few launches queue behind it."""

    def __init__(self):
        import ctypes
        import hashlib

        from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

        src = os.path.join(ROOT, HOLD_SOURCE)
        with open(src, "rb") as f:
            tag = hashlib.sha256(f.read() + " ".join(kernels.ARCH_FLAGS).encode()).hexdigest()[:16]
        lib = os.path.join(ROOT, "build", "kernels", f"sync_hold-{tag}.so")
        if not os.path.exists(lib):
            os.makedirs(os.path.dirname(lib), exist_ok=True)
            tmp = f"{lib}.{os.getpid()}.tmp"
            subprocess.run([kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O2",
                            "-shared", "-Xcompiler", "-fPIC", "-o", tmp, src],
                           check=True, timeout=300)
            os.replace(tmp, lib)
        self.lib = ctypes.CDLL(lib)
        self.lib.qie_hold_launch.argtypes = (ctypes.c_void_p, ctypes.c_ulonglong,
                                             ctypes.c_void_p)
        ptr = ctypes.c_void_p()
        kernels.check(self.lib.qie_hold_alloc(ctypes.byref(ptr)), "cudaHostAlloc (hold)")
        self.state = (ctypes.c_uint32 * 4).from_address(ptr.value)
        self.ptr, self.launches = ptr.value, 0

    def arm(self) -> None:
        for i in range(4):
            self.state[i] = 0
        self.launches = 0

    def launch(self) -> None:
        import torch

        from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

        kernels.check(self.lib.qie_hold_launch(
            self.ptr, int(HOLD_TIMEOUT_S * 1e9), torch.cuda.current_stream().cuda_stream),
            "hold kernel launch")
        self.launches += 1

    def release(self) -> None:
        self.state[0] = 1

    def outcome(self) -> dict:
        """After the card ran the hold: released or timed out, and its spin."""
        word = self.state[1]
        return {"outcome": {0: "not run", 1: "released", 2: "timed out"}[word],
                "spun_ms": (self.state[2] | self.state[3] << 32) / 1e6,
                "launches": self.launches}

    def around_pack(self, fn):
        """``fn()`` with the hold launched before the stream's pixel pack
        (``colorspace.rgb_to_yuv420``, patched for the call) and released
        once ``fn`` has returned; (its result, its host seconds)."""
        from qwen_image_edit_streamdiffusion_tpu_torch.ops import colorspace

        real = colorspace.rgb_to_yuv420

        def held_pack(x32):
            self.launch()
            return real(x32)

        self.arm()
        colorspace.rgb_to_yuv420 = held_pack
        t0 = time.time()
        try:
            out = fn()
            return out, time.time() - t0
        finally:
            self.release()
            colorspace.rgb_to_yuv420 = real


def held_verdict(name: str, held: dict) -> list:
    """What a held window says is wrong: a hold that did not run once, or a
    submit that did not return while the card was held."""
    if held["launches"] != 1:
        return [f"{name}: the hold ran {held['launches']} times, not once"]
    if held["outcome"] != "released":
        return [f"{name}: the submit returned only after the card was free "
                f"({held['outcome']} after {held['spun_ms']:.1f} ms)"]
    return []


def stream_sync_check(rt) -> None:
    """After warm-up: a keyframe and a temporal ``submit_frame``, each in a
    held window of its own (:class:`SyncHold`: the card spins just before
    the frame's pixel pack until the host releases it once the submit has
    returned, so a submit that waits for its own frame meets the hold's
    time-out instead), under ``torch.cuda.set_sync_debug_mode("error")`` (a
    sync PyTorch sees raises) and under torch.profiler: no runtime call that
    waits for the card and no pageable copy in their host window
    (:func:`host_waits`), and each hold released, not timed out; then both
    are collected. The host can run only a bounded queue of launches ahead
    of the card, so a submit still waits for the card once that queue is
    full: that is back-pressure, not a sync, and the hold sits after the
    frame's launch-heavy stages so that the few launches behind it cannot
    fill the queue. Then three planted faults, each a temporal submit:
    uploads from pageable memory as before the stream's pinned uploads
    (blocking), whose ``cudaStreamSynchronize`` :func:`host_waits` must
    show, non-blocking from pageable memory, where the CUDA driver may wait
    unseen by the debug mode (printed: whether the profile caught it), and a
    submit that polls an event behind its own pixels before it returns (a
    wait neither the debug mode nor the runtime calls show), whose held
    window must time out and fail :func:`held_verdict`. Last, one more
    temporal submit on an idle card: its host seconds, and the device
    seconds its work needs after it returns."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import edit_pipeline as tep

    if rt.config.transfer_format != "yuv420":
        raise AssertionError("sync check: the hold sits before the yuv420 pack")
    hold = SyncHold()
    img = stream_image()
    rt.frame_count, rt.prev_latent = 0, None
    flags, seconds, held, waits, copies, handles = [], [], {}, {}, {}, []

    def submit():
        torch.cuda.set_sync_debug_mode("error")
        try:
            return hold.around_pack(lambda: rt.submit_frame(img))
        finally:
            torch.cuda.set_sync_debug_mode("default")

    for name in ("keyframe", "temporal"):
        (handle, dt), seen, seen_copies = host_waits(submit)
        handles.append(handle)
        flags.append(rt.is_keyframe)
        seconds.append(dt)
        held[name] = {**hold.outcome(), "submit_s": dt}
        for k, v in seen.items():
            waits[k] = waits.get(k, 0) + v
        copies[name] = seen_copies
    t0 = time.time()
    outs = [rt._collect(h) for h in handles]
    t_collect = time.time() - t0
    planted, real = {}, tep.to_device
    for name, non_blocking in (("pageable_blocking", False), ("pageable", True)):
        tep.to_device = lambda x, device: torch.as_tensor(x).to(
            device, non_blocking=non_blocking)
        try:
            handle, seen, seen_copies = host_waits(lambda: rt.submit_frame(img))
        finally:
            tep.to_device = real
        rt._collect(handle)
        planted[name] = {"waits": seen, "copies": seen_copies}

    def self_syncing():
        handle = rt.submit_frame(img)
        own = torch.cuda.Event()
        own.record()
        while not own.query():
            time.sleep(1e-4)
        return handle

    (handle, dt), seen, _ = host_waits(lambda: hold.around_pack(self_syncing))
    rt._collect(handle)
    caught = held_verdict("self_sync", hold.outcome())
    planted["self_sync"] = {**hold.outcome(), "submit_s": dt, "waits": seen,
                            "verdict": caught}
    # a temporal submit on an idle card: its host time, then the device time
    # its work still needs once it returns
    torch.cuda.synchronize()
    t0 = time.time()
    handle = rt.submit_frame(img)
    idle_submit = time.time() - t0
    torch.cuda.synchronize()
    left = time.time() - t0 - idle_submit
    rt._collect(handle)
    emit({"phase": "stream_sync_check", "keyframe_submit_s": seconds[0],
          "temporal_submit_s": seconds[1], "collect_s": t_collect,
          "held": held, "flags": flags, "host_waits": waits, "copies": copies,
          "planted": planted, "shapes": [list(o.shape) for o in outs],
          "idle_card_temporal_submit_s": idle_submit, "device_s_left_after_it": left})
    problems = [p for name in held for p in held_verdict(name, held[name])]
    if (flags != [True, False] or problems or waits
            or not planted["pageable_blocking"]["waits"].get("cudaStreamSynchronize")
            or not caught):
        raise AssertionError(f"sync check: keyframe/temporal {flags}, held windows "
                             f"{problems or 'released'}, host waits {waits}, copies "
                             f"{copies}, planted faults {planted}")


def stream_batched(pipe, lk: int) -> None:
    """Two sessions (different prompts and seeds), each a keyframe, then one
    temporal frame: each alone, then (re-primed) as one 2-row dispatch. K1
    at 2 rows; the rows handed to the forward equal, bit for bit, each
    session's text and mask, previous latent and own noise draw; each row's
    latents within STREAM_TOL (rel-L2) of its session alone; one host fetch
    for both rows, the two rows different. Then two planted faults, each on
    a re-primed pair: row 0 given session 1's text rows, then session 1's
    noise. Each must fail the row check; the noise must also read above
    STREAM_TOL (the text's reading is printed: with random weights 8 text
    tokens of 2112 move a row's latents less than bf16 batching does)."""
    import dataclasses

    import numpy as np
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import edit_pipeline as tep
    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.stream import (
        RealtimePipeline,
        submit_frames_batched,
    )
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

    frames = [stream_image("sine", phase=p) for p in (0.0, 1.0, 2.0)]

    def prime():
        pair = []
        for prompt, frame, seed in ((PROMPT, frames[0], 0), (STREAM_PROMPT_B, frames[1], 7)):
            rt = RealtimePipeline(pipe=dataclasses.replace(
                pipe, config=pipe.config.replace(seed=seed)))
            rt.precompute_conditions(prompt)
            rt.process_frame(frame)
            pair.append(rt)
        return pair

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    def dispatch(pair, own):
        """frames[2] on both sessions as one dispatch; the collected frames
        and, per row, whether the forward's rows equal ``own`` (each
        session's text, mask and previous latent as of before the fault)
        and the session's own noise draw."""
        seen = {}
        real_run = RealtimePipeline._run_frames

        def spy(self, kind, images, prev, noises, txt, mask, *rest):
            seen.update(kind=kind, prev=prev, noises=noises, txt=txt, mask=mask)
            return real_run(self, kind, images, prev, noises, txt, mask, *rest)

        RealtimePipeline._run_frames = spy
        try:
            handles = submit_frames_batched(pair, [frames[2], frames[2]])
        finally:
            RealtimePipeline._run_frames = real_run
        outs = [rt._collect(h) for rt, h in zip(pair, handles)]
        equal = []
        for r, (rt, (txt, mask, prev)) in enumerate(zip(pair, own)):
            n = txt.shape[1]
            draws = RealtimePipeline._frame_noise(
                rt, seen["kind"], (1, *seen["noises"][0].shape[1:]), rt.frame_count - 1)
            equal.append(bool(
                torch.equal(seen["txt"][r:r + 1, :n], txt)
                and torch.equal(seen["mask"][r:r + 1, :n], mask)
                and not seen["mask"][r, n:].any() and torch.equal(seen["prev"][r:r + 1], prev)
                and all(torch.equal(a[r:r + 1], b) for a, b in zip(seen["noises"], draws))))
        return outs, equal

    alone = prime()
    ref = [(rt.process_frame(frames[2]), rt.prev_latent) for rt in alone]
    torch.cuda.synchronize()
    t0 = time.time()
    for rt in alone:  # each session's next temporal frame alone, timed
        rt.process_frame(frames[0])
    alone_s = time.time() - t0
    pair = prime()
    own = [(rt._frozen_txt, rt._frozen_mask, rt.prev_latent) for rt in pair]
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    fetches = []
    real = tep.EditPipeline._fetch_images
    tep.EditPipeline._fetch_images = lambda self, px: fetches.append(1) or real(self, px)
    try:
        t0 = time.time()
        with RowSpy() as spy:
            outs, rows_equal = dispatch(pair, own)
            torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        tep.EditPipeline._fetch_images = real
    delta = launch_delta(before)
    rels = [rel(rt.prev_latent, lat) for rt, (_, lat) in zip(pair, ref)]
    codes = [int(np.abs(o.astype(np.int16) - r.astype(np.int16)).max())
             for o, (r, _) in zip(outs, ref)]
    exact = [bool(torch.equal(rt.prev_latent, lat)) for rt, (_, lat) in zip(pair, ref)]
    apart = int(np.abs(outs[0].astype(np.int16) - outs[1].astype(np.int16)).max())
    torch.cuda.synchronize()
    t0 = time.time()  # the next batched frame, warm, against the two alone
    for rt, h in zip(pair, submit_frames_batched(pair, [frames[0], frames[0]])):
        rt._collect(h)
    warm = time.time() - t0
    planted = {}
    for fault in ("text", "noise"):
        bad = prime()
        own = [(rt._frozen_txt, rt._frozen_mask, rt.prev_latent) for rt in bad]
        if fault == "text":
            bad[0]._frozen_txt, bad[0]._frozen_mask = bad[1]._frozen_txt, bad[1]._frozen_mask
        else:
            bad[0]._frame_noise = bad[1]._frame_noise
        _, equal = dispatch(bad, own)
        planted[fault] = {"row0_rel_l2": rel(bad[0].prev_latent, ref[0][1]),
                          "rows_equal": equal}
    emit({"phase": "stream_batched", "sessions": 2, "first_s": wall, "seconds": warm,
          "two_alone_s": alone_s, "launches": {k: n for k, n in delta.items() if n},
          "rows": spy.rows, "host_fetches": len(fetches), "rows_equal": rows_equal,
          "row_latent_rel_l2": rels, "row_latent_equal": exact, "row_max_code_diff": codes,
          "rows_max_code_apart": apart, "tol": STREAM_TOL, "planted": planted})
    check_counts("stream/batched", delta, frame_want(False, k3=K3_ENCODE + K3_DECODE),
                 {"flash_joint": {f"2x{lk}": MMDIT_LAYERS},
                  "conv3x3": {"2": K3_ENCODE + K3_DECODE}}, spy)
    if (len(fetches) != 1 or not all(rows_equal) or max(rels) > STREAM_TOL or apart <= 1
            or any(o.shape != (STREAM_SIZE, STREAM_SIZE, 3) for o in outs)):
        raise AssertionError(f"batched stream: fetches {len(fetches)}, rows equal "
                             f"{rows_equal}, rel-L2 {rels}, rows apart {apart}")
    if (any(p["rows_equal"] != [False, True] for p in planted.values())
            or not planted["noise"]["row0_rel_l2"] > STREAM_TOL):
        raise AssertionError(f"batched stream: a planted row fault was not seen: {planted}")


def stream_flicker(pipe) -> dict:
    """bench_stream's temporal coherence: 8 frames of the moving sine pattern
    through a stream with temporal latents (a keyframe every 10) and one of
    independent keyframes (interval 1); the outputs' mean frame-to-frame
    change against the input's."""
    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.stream import (
        RealtimePipeline,
        temporal_flicker,
    )

    frames_in = [stream_image("sine", phase=0.35 * i) for i in range(8)]
    rec = {"phase": "stream_flicker", "input": temporal_flicker(frames_in)}
    for name, interval in (("temporal", STREAM_INTERVAL), ("keyframes", 1)):
        pipe.config = stream_config(pipe, keyframe_interval=interval)
        rt = RealtimePipeline(pipe=pipe)
        rt.precompute_conditions(PROMPT)
        rec[name] = temporal_flicker([rt.process_frame(f) for f in frames_in])
    emit(rec)
    if not all(math.isfinite(v) for k, v in rec.items() if k != "phase"):
        raise AssertionError(f"flicker not finite: {rec}")
    return rec


def phase_stream(pipe) -> dict:
    """The realtime stream on the live bf16 flagship (after phase_tiny loaded
    the trained tiny pair), as bench_stream drives it: prompts frozen (K2 in
    precompute only), warm-up, a keyframe and a temporal frame checked
    launch by launch (K1 120 / 60 at 1 row, K3 20 / 20), submit_frame free
    of host waits, sequential and pipelined benchmarks, a profiled pipelined
    run; then a guided rcfg-self stream (K1 at 1 row), the tiny encoder and
    decoder on temporal frames (K3 0; the keyframe 5, its full encode),
    ``preview_scale=2`` at 1024² (1024² keyframes, 512² temporal frames),
    the similarity filter on a static frame, two sessions as one batched
    dispatch (K1 at 2 rows) and the flicker of temporal latents against
    independent keyframes; last, K1, K2 and K3 at the stream's shapes
    against their plain versions. Restores the pipeline's config."""
    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.stream import RealtimePipeline
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

    saved = pipe.config
    kernels.reset_launches()
    pipe.config = stream_config(pipe)
    rt = RealtimePipeline(pipe=pipe)
    txt = precompute(rt, "stream", PROMPT)
    lk = txt + 2 * (STREAM_SIZE // 16) ** 2
    t0 = time.time()
    rt.warmup(runs=2)
    emit({"phase": "stream_warmup", "seconds": time.time() - t0, "joint_length": lk})
    k1 = lambda n, rows=1, l=lk: {"flash_joint": {f"{rows}x{l}": n}}
    full = {"conv3x3": {"1": K3_ENCODE + K3_DECODE}}
    stream_frame(rt, "stream", "keyframe", frame_want(True), {**k1(120), **full})
    stream_frame(rt, "stream", "temporal", frame_want(False), {**k1(60), **full})
    stream_sync_check(rt)
    rt.warmup(runs=2)
    benches = {mode: stream_bench(rt, "bf16", mode == "pipelined")
               for mode in ("sequential", "pipelined")}
    plain = benches["pipelined"]["wall_s"]
    emit({"phase": "stream_profile", "path": "bf16 pipelined", "frames": STREAM_FRAMES,
          **profile_call(lambda: rt.run_benchmark(STREAM_FRAMES, pipelined=True,
                                                  output_path=None), plain)})

    # guided: rcfg-self (the virtual negative anchors on the frame; 1 row)
    pipe.config = stream_config(pipe, cfg_mode="rcfg-self")
    rt = RealtimePipeline(pipe=pipe)
    gtxt = precompute(rt, "stream rcfg-self", PROMPT, NEG, k2_rows=2)
    glk = gtxt + 2 * (STREAM_SIZE // 16) ** 2
    rt.warmup(runs=2)
    stream_frame(rt, "stream rcfg-self", "keyframe", frame_want(True), {**k1(120, l=glk), **full})
    stream_frame(rt, "stream rcfg-self", "temporal", frame_want(False), {**k1(60, l=glk), **full})
    stream_bench(rt, "bf16 rcfg-self", True)

    # the tiny pair: temporal frames encode and decode through it (K3 0);
    # keyframes encode through the full VAE (K3 5), decode through the tiny
    pipe.config = stream_config(pipe, encoder="tiny", decoder="tiny")
    rt = RealtimePipeline(pipe=pipe)
    precompute(rt, "stream tiny", PROMPT)
    rt.warmup(runs=2)
    stream_frame(rt, "stream tiny", "keyframe", frame_want(True, k3=K3_ENCODE),
                 {**k1(120), "conv3x3": {"1": K3_ENCODE}})
    stream_frame(rt, "stream tiny", "temporal", frame_want(False, k3=0),
                 {**k1(60), "conv3x3": None})
    stream_bench(rt, "bf16 tiny pair", True)

    # hybrid resolution: 1024² keyframes, 512² preview temporal frames
    pipe.config = stream_config(pipe, size=SIZE, preview_scale=2)
    rt = RealtimePipeline(pipe=pipe)
    precompute(rt, "stream preview", PROMPT)
    rt.warmup(runs=2)
    big = txt + 2 * (SIZE // 16) ** 2
    stream_frame(rt, "stream preview", "keyframe", frame_want(True),
                 {**k1(120, l=big), **full}, size=SIZE)
    if tuple(rt.prev_latent.shape) != (1, SIZE // 16, SIZE // 16, 16):
        raise AssertionError(f"preview handoff latent {tuple(rt.prev_latent.shape)}")
    stream_frame(rt, "stream preview", "temporal", frame_want(False), {**k1(60), **full},
                 size=SIZE)
    for mode in ("sequential", "pipelined"):
        stream_bench(rt, "bf16 preview 1024", mode == "pipelined")

    # the similarity filter on a static frame: skips, never past the bound
    pipe.config = stream_config(pipe, similarity_filter=True,
                                similarity_max_skip=STREAM_MAX_SKIP)
    rt = RealtimePipeline(pipe=pipe)
    precompute(rt, "stream ssf", PROMPT)
    rt.warmup(runs=2)
    static, ran, t0 = stream_image(), [], time.time()
    before = dict(kernels.LAUNCHES)
    for _ in range(STREAM_FRAMES):
        n = rt.frame_count
        out = rt.process_frame(static)
        ran.append(rt.frame_count > n)
    wall = time.time() - t0
    streak = longest = 0
    for r in ran:
        streak = 0 if r else streak + 1
        longest = max(longest, streak)
    delta = launch_delta(before)
    emit({"phase": "stream_ssf", "frames": STREAM_FRAMES, "processed": sum(ran),
          "skipped": rt.skipped_frames, "longest_skip_run": longest,
          "max_skip": STREAM_MAX_SKIP, "s_per_frame": wall / STREAM_FRAMES,
          "fps": STREAM_FRAMES / wall, "pattern": "".join("P" if r else "s" for r in ran),
          "launches": {k: n for k, n in delta.items() if n}})
    keys = sum(1 for i, r in enumerate(ran) if r and sum(ran[:i]) % STREAM_INTERVAL == 0)
    check_counts("stream/ssf", delta, {"flash_joint": (sum(ran) + keys) * MMDIT_LAYERS})
    if not (rt.skipped_frames >= 1 and longest <= STREAM_MAX_SKIP
            and sum(ran) + rt.skipped_frames == STREAM_FRAMES
            and out.shape == (STREAM_SIZE, STREAM_SIZE, 3)):
        raise AssertionError(f"similarity filter: {ran}, skipped {rt.skipped_frames}")

    pipe.config = stream_config(pipe)
    stream_batched(pipe, lk)
    stream_flicker(pipe)
    pipe.config = saved
    launches = dict(kernels.LAUNCHES)
    STREAM_KERNEL_ERRS.update(phase_stream_shapes(
        txt, int(rt._frozen_mask.sum().item()), (lm_tokens(pipe, PROMPT), lm_tokens(pipe, NEG))))
    return launches


# max-abs errors of K1, K2 and K3 at the stream's shapes (phase_stream_shapes),
# folded into the kernels line
STREAM_KERNEL_ERRS = {}


def phase_stream_shapes(txt: int, txt_real: int, lm_real) -> dict:
    """K1, K2 and K3 at the shapes the stream gives them, against their
    plain versions, timed beside their library call and bound: K1 at (1,
    24, L, 128) and (2, 24, L, 128), L = the frozen text bucket + 2 × 1024
    image tokens (512²), and at (1, 24, L', 128), L' = the bucket + 2 ×
    4096 (the 1024² preview keyframe), the text masked after its real
    tokens (the second row 5 fewer); K2 at (1, 28/4, STREAM_LM_LEN, 128)
    and (2, 28/4, STREAM_LM_LEN, 128), the frozen prompt's LM rows
    (``lm_real``: the positive's and the negative's real tokens,
    suffix-padded), graph-timed as ``precompute_conditions``' 28 launches;
    K3 at every shape of a 512² full-VAE encode and decode, graph-timed as
    a keyframe's launches, with the mix's sums a keyframe. Returns the
    max-abs errors."""
    import torch
    import torch.nn.functional as F

    from qwen_image_edit_streamdiffusion_tpu_torch.ops import conv as conv_ops
    from qwen_image_edit_streamdiffusion_tpu_torch.ops import flash_attention as fa

    bf16 = torch.bfloat16
    errs = {"flash_attention_joint": 0.0, "flash_attention_causal": 0.0, "conv3x3": 0.0}
    for rows, size in ((1, STREAM_SIZE), (2, STREAM_SIZE), (1, SIZE)):
        lk = txt + 2 * (size // 16) ** 2
        q, k, v = (randn((rows, 24, lk, 128), s, bf16) for s in (70, 71, 72))
        mask = torch.ones((rows, lk), dtype=torch.bool, device="cuda")
        for r in range(rows):
            mask[r, txt_real - 5 * r:txt] = False
        out = fa.joint_attention(q, k, v, mask, txt)

        def k1_plain():
            return torch.cat([fa.joint_attention_plain(q[:, h:h + 4], k[:, h:h + 4],
                                                       v[:, h:h + 4], mask)
                              for h in range(0, 24, 4)], dim=1)

        ref = k1_plain().float()
        err, tol = (out.float() - ref).abs().max().item(), attn_tolerance(ref)
        emit_kernel({"phase": "kernel", "name": "flash_attention_joint", "cell": "stream",
                     "shape": list(q.shape), "text_real": [txt_real - 5 * r for r in range(rows)],
                     "max_abs_err": err, "tol": tol,
                     "ms": cuda_ms(lambda: fa.joint_attention(q, k, v, mask, txt), 20),
                     "plain_ms": cuda_ms(k1_plain, 5),
                     "library_ms": cuda_ms(lambda: sdpa(q, k, v, mask), 20),
                     **attention_bound(q, k, v, (out,), mask, 4)})
        if not err <= tol:
            raise AssertionError(f"K1 error {err} > {tol} at the stream's {rows} x {lk}")
        errs["flash_attention_joint"] = max(errs["flash_attention_joint"], err)
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    for reals in (lm_real[:1], lm_real):
        rows, l = len(reals), STREAM_LM_LEN
        q = randn((rows, 28, l, 128), 76, bf16)
        k, v = (randn((rows, 4, l, 128), s, bf16) for s in (77, 78))
        out = fa.causal_attention(q, k, v)
        err, tol = 0.0, 0.0
        for b, n_real in enumerate(reals):
            keep = torch.arange(l, device="cuda") < n_real
            ref = fa.causal_attention_plain(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                            keep)[:, :, :n_real].float()
            err = max(err, (out[b:b + 1, :, :n_real].float() - ref).abs().max().item())
            tol = max(tol, attn_tolerance(ref))
        emit_kernel({"phase": "kernel", "name": "flash_attention_causal", "cell": "stream",
                     "shape": [rows, 28, 4, l], "n_real": list(reals),
                     "max_abs_err": err, "tol": tol, "graph_launches": K2_LAUNCHES,
                     "block_q": fa.causal_block_q(q),
                     **timed("", lambda: fa.causal_attention(q, k, v), K2_LAUNCHES),
                     "plain_ms": cuda_ms(lambda: [fa.causal_attention_plain(
                         q[b:b + 1], k[b:b + 1], v[b:b + 1]) for b in range(rows)], 20),
                     **timed("library_", lambda: sdpa(q, k, v, is_causal=True,
                                                       enable_gqa=True), K2_LAUNCHES),
                     **bound(4 * rows * 28 * (l * (l + 1) / 2) * 128,
                             nbytes(q, k, v) + nbytes(q), PEAK_BF16)})
        if not err <= tol:
            raise AssertionError(f"K2 error {err} > {tol} at the stream's {rows} rows "
                                 f"{list(reals)} of {l}")
        errs["flash_attention_causal"] = max(errs["flash_attention_causal"], err)
        del q, k, v, out
    mix = {"ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "launches": 0}
    for size, cin, f, n, _ in STREAM_K3_MIX:
        x = randn((1, size, size, cin), 73, bf16)
        w = (randn((3, 3, cin, f), 74, torch.float32) * (9 * cin) ** -0.5).to(bf16)
        b = randn((f,), 75, bf16) * 0.1
        ref = conv_ops.conv3x3_plain(x, w, b).float()
        err = (conv_ops.conv3x3(x, w, b).float() - ref).abs().max().item()
        tol = conv_tolerance(ref)
        wl = w.permute(3, 2, 0, 1)
        rec = {"phase": "kernel", "name": "conv3x3", "cell": "stream",
               "shape": [1, size, size, cin, f], "launches_keyframe": n,
               "max_abs_err": err, "tol": tol,
               **timed("", lambda: conv_ops.conv3x3(x, w, b), n, 10),
               "plain_ms": cuda_ms(lambda: conv_ops.conv3x3_plain(x, w, b), 10),
               **timed("library_", lambda: F.conv2d(x.permute(0, 3, 1, 2), wl, b,
                                                    padding=1), n, 10),
               **bound(2 * size * size * 9 * cin * f,
                       nbytes(x, w, b) + size * size * f * 2, PEAK_BF16)}
        emit_kernel(rec)
        if not err <= tol:
            raise AssertionError(f"K3 error {err} > {tol} at the stream's {size}² "
                                 f"{cin}->{f}")
        errs["conv3x3"] = max(errs["conv3x3"], err)
        for key in ("ms", "bound_ms", "library_ms"):
            mix[key] += n * rec[key]
        mix["launches"] += n
        del x, w, b, ref
    torch.cuda.empty_cache()
    emit({"phase": "kernel_mix", "name": "conv3x3", "per": "512² stream keyframe", **mix,
          "bound_share": mix["bound_ms"] / mix["ms"],
          "vs_library": mix["ms"] / mix["library_ms"]})
    return errs


def stream_int8(pipe) -> None:
    """Three 512² stream frames on the int8 pipeline (a keyframe, two
    temporal frames): K5/K6 once per quantized linear, at the stream's
    shapes: every K6 call's (M, K, N) counted, the precompute's and the
    keyframe's together equal to INT8_STREAM_MIX, a temporal frame's to its
    MMDiT half (the shapes phase_int8_kernels holds bit-exact)."""
    from qwen_image_edit_streamdiffusion_tpu_torch.ops import int8
    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.stream import RealtimePipeline
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

    want = {}
    for _, m, k, n, launches in INT8_STREAM_MIX:
        want[(m, k, n)] = want.get((m, k, n), 0) + launches
    temporal = {mkn: c // 2 for mkn, c in want.items() if mkn[0] != 128}
    seen = {}
    real = int8.int8_matmul

    def spy(x_q, x_scale, w_q, *args, **kw):
        mkn = (x_q.shape[0], x_q.shape[1], w_q.shape[0])
        seen[mkn] = seen.get(mkn, 0) + 1
        return real(x_q, x_scale, w_q, *args, **kw)

    saved = pipe.config
    pipe.config = stream_config(pipe)
    rt = RealtimePipeline(pipe=pipe)
    int8.int8_matmul = spy
    try:
        before = dict(kernels.LAUNCHES)
        precompute(rt, "stream int8", PROMPT)
        delta = launch_delta(before)
        if delta["int8_gemm"] != INT8_LM or delta["quantize_rows"] != INT8_LM:
            raise AssertionError(f"int8 stream precompute: K5/K6 {delta}")
        per_forward = INT8_MMDIT // STEPS
        for name, key in (("keyframe", True), ("temporal0", False), ("temporal1", False)):
            stream_frame(rt, "stream int8", name,
                         frame_want(key, int8=(2 if key else 1) * per_forward))
            shapes, got = (want if key else temporal), dict(seen)
            emit({"phase": "stream_int8_shapes", "frame": name,
                  "mkn": {"x".join(map(str, mkn)): c for mkn, c in sorted(got.items())}})
            if got != shapes:
                raise AssertionError(f"int8 stream {name}: K6 at {got}, not {shapes}")
            seen.clear()
    finally:
        int8.int8_matmul = real
        pipe.config = saved


def phase_yuv420(pipe) -> dict:
    """``transfer_format="yuv420"`` on the live pipeline: a hit and a miss.
    The output must equal the host unpack of the decode's device pack (the
    hit's latents decoded again), and the miss's condition upload must equal
    ``yuv420_to_rgb`` of the host pack computed on the CPU."""
    import numpy as np
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm
    from qwen_image_edit_streamdiffusion_tpu_torch.ops import colorspace
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

    kernels.reset_launches()
    pipe.config = pipe.config.replace(transfer_format="yuv420")
    res = {}
    for name, img, want in (("yuv420_hit", distinct_image(0), expected(False)),
                            ("yuv420_miss", distinct_image(7100), expected(True))):
        res[name] = serve("bf16+yuv420", name,
                          lambda: pipe(img, PROMPT, num_inference_steps=STEPS,
                                       seed=42), want)
    launches = dict(kernels.LAUNCHES)
    g = SIZE // 8
    with torch.inference_mode():
        tokens = tfm.pack_latents(res["yuv420_hit"][0].latents)
        packed, _ = pipe._decode(tokens, g, g)
        unpacked = pipe._fetch_images(packed)[0]
        vae_img = pipe._prepare_images([distinct_image(7100)], None, None)[2][0]
        upload = pipe._upload([vae_img]).cpu()
    host_rgb = colorspace.yuv420_to_rgb(
        torch.from_numpy(colorspace.pack_yuv420_host(vae_img))[None])
    checks = {"packed_shape": list(packed.shape),
              "output_equals_host_unpack": bool(np.array_equal(
                  unpacked, res["yuv420_hit"][0].images[0])),
              "upload_equals_host_pack_rgb": bool(torch.equal(upload, host_rgb))}
    emit({"phase": "yuv420_checks", **checks})
    pipe.config = pipe.config.replace(transfer_format="rgb")
    if not (checks["output_equals_host_unpack"] and checks["upload_equals_host_pack_rgb"]
            and checks["packed_shape"] == [1, SIZE // 2, SIZE // 2, 6]):
        raise AssertionError(f"yuv420 checks failed: {checks}")
    return launches


# The server's request: a 512² input (the engine resizes every input to
# input_size²), area-1024² output, 2 steps, cond-only, yuv420, batched CFG for
# use_cfg, as `serving/server.py` runs by default
SERVE_INPUT = 512
CLI_HEALTH_S = 120   # bound on the CLI server's start-up, until /health answers

# Phases 8b/8c: the one-process latents of their requests are computed by
# each phase itself before it spawns (host tensors)
TP_TOL = 3e-2          # rel-L2 of sharded against one-process latents, bf16
TP_IMAGES = {"miss_a": 8000, "guided": 8002, "two": (8003, 8004),
             "edit": 8005, "int8": 8100, "mesh_parallel": 8200, "mesh_rcfg": 8201,
             "mesh_num_images": 8202}
WORLD_TIMEOUT_S = 600  # a spawned world's bound, spawn to its last record
RANK_DEVICE = "cuda:0"  # every rank's device: the one card, shared


def http(url: str, payload=None, timeout: float = 600):
    """(status, JSON body, wall seconds) of one GET (no payload) or POST."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json"})
    t0 = time.time()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body, code = r.read(), r.status
    except urllib.error.HTTPError as e:
        body, code = e.read(), e.code
    return code, json.loads(body), time.time() - t0


def served(url: str, label: str, name: str, payload: dict, want: dict, rows=None,
           outputs: int = 1):
    """POST one /edit, print its status, wall seconds over HTTP, the
    engine's ``elapsed``, launch counts and the rows of every K1/K2/K3 call,
    and raise unless it is a 200 whose counts, rows and decoded outputs
    (``outputs`` SIZE² images) are as expected. Returns (body, wall, the
    first output array)."""
    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

    before = dict(kernels.LAUNCHES)
    with RowSpy() as spy:
        code, body, wall = http(url + "/edit", payload)
    delta = launch_delta(before)
    images = ([codec.decode_base64(body["image"])]
              + [codec.decode_base64(b) for b in body.get("images", [])]) if code == 200 else []
    emit({"phase": "serve_request", "path": label, "name": name, "status": code,
          "wall_s": wall, "elapsed_s": body.get("elapsed"),
          "launches": {k: n for k, n in delta.items() if n}, "rows": spy.rows,
          "outputs": len(images), "shape": list(images[0].shape) if images else None,
          **{k: body[k] for k in ("batched_with", "stream_session", "keyframe", "frame",
                                  "lag") if k in body}})
    if code != 200:
        raise AssertionError(f"{label}/{name}: HTTP {code} {body}")
    check_counts(f"{label}/{name}", delta, want, rows, spy)
    if len(images) != outputs or any(i.shape != (SIZE, SIZE, 3) or str(i.dtype) != "uint8"
                                     for i in images):
        raise AssertionError(f"{label}/{name}: outputs {[i.shape for i in images]}")
    return body, wall, images[0]


def pipeline_only(pipe, item: dict, fresh_caches: bool):
    """(wall seconds, output arrays) of the engine's pipeline call on a
    parsed request's arrays, without the wire; ``fresh_caches`` runs it on
    empty prompt and latent caches (a miss), then puts the live caches
    back."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.cache import (
        LatentCache,
        PromptCache,
    )

    saved = pipe.prompt_cache, pipe.latent_cache
    if fresh_caches:
        pipe.prompt_cache, pipe.latent_cache = PromptCache(pipe.encoder), LatentCache()
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        result = pipe(item["image"], item["prompt"], negative_prompt=item["negative_prompt"],
                      num_inference_steps=item["num_inference_steps"],
                      true_cfg_scale=item["true_cfg_scale"], seed=item["seed"],
                      num_images_per_prompt=item["num_images"])
        torch.cuda.synchronize()
        return time.time() - t0, result.images
    finally:
        pipe.prompt_cache, pipe.latent_cache = saved


def start_server(engine):
    import threading

    from qwen_image_edit_streamdiffusion_tpu_torch.serving.server import make_server

    srv = make_server(engine, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def stop_server(srv) -> None:
    srv.shutdown()
    srv.server_close()


def stream_k1(spy, n: int) -> bool:
    """Every K1 call of a stream frame at 1 row, n of them."""
    per = spy.rows.get("flash_joint", {})
    return all(k.startswith("1x") for k in per) and sum(per.values()) == n


def serve_stream_http(url: str, engine, label: str = "http stream") -> None:
    """Four pipelined frames of one session over /edit: lags 0, 1, 1, 1; K1
    120 on the keyframe, 60 on each temporal frame, at 1 row; K2 28 on the
    first (the session's prompt freeze); 512² replies. The third frame is
    served under torch.profiler in the server's thread (host_waits): its
    only host wait must be the one event wait of collecting the previous
    frame."""
    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

    real = engine._serve_stream_frame
    waits = {}

    def profiled(*a, **kw):
        out, waits["waits"], waits["copies"] = host_waits(lambda: real(*a, **kw))
        return out

    lags = []
    for i in range(4):
        payload = {"image": codec.to_base64_jpeg(stream_image("sine", SERVE_INPUT, 0.3 * i)),
                   "prompt": PROMPT, "stream_session": "cam-http", "stream_pipeline": True}
        want = frame_want(i == 0)
        if i == 0:
            want["flash_causal"] = K2_LAUNCHES
        if i == 2:
            engine._serve_stream_frame = profiled
        try:
            before = dict(kernels.LAUNCHES)
            with RowSpy() as spy:
                code, body, wall = http(url + "/edit", payload)
        finally:
            engine._serve_stream_frame = real
        delta = launch_delta(before)
        out = codec.decode_base64(body["image"]) if code == 200 else None
        emit({"phase": "serve_stream", "path": label, "status": code, "wall_s": wall,
              "elapsed_s": body.get("elapsed"), "lag": body.get("lag"),
              "frame": body.get("frame"), "keyframe": body.get("keyframe"),
              "launches": {k: n for k, n in delta.items() if n}, "rows": spy.rows,
              "shape": None if out is None else list(out.shape),
              **({"host_waits": waits["waits"], "copies": waits["copies"]} if i == 2 else {})})
        if code != 200 or out.shape != (SERVE_INPUT, SERVE_INPUT, 3) or not stream_k1(spy, want[
                "flash_joint"]):
            raise AssertionError(f"{label} frame {i}: {code} {body if code != 200 else ''}")
        check_counts(f"{label} frame {i}", delta, want)
        lags.append(body["lag"])
    if lags != [0, 1, 1, 1]:
        raise AssertionError(f"{label}: lags {lags}")
    if waits["waits"] != {"cudaEventSynchronize": 1}:
        raise AssertionError(f"{label}: the pipelined frame's host waits {waits['waits']} "
                             "are not the one event wait of its collect")


def serve_stream_ws(host: str, port: int) -> None:
    """The same session over the websocket /stream with the port's WSClient:
    lags 0, 1, 1, 1, K1 120 / 60 a frame at 1 row, each reply's JPEG 512²."""
    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels
    from qwen_image_edit_streamdiffusion_tpu_torch.serving import ws

    c = ws.WSClient(host, port, timeout=600)
    try:
        ready = c.recv()
        c.send_config(prompt=PROMPT, steps=STEPS, pipeline=True)
        ack = c.recv()
        if ready.get("status") != "ready" or ack.get("status") != "ok":
            raise AssertionError(f"ws handshake: {ready} {ack}")
        lags = []
        for i in range(4):
            want = frame_want(i == 0)
            if i == 0:
                want["flash_causal"] = K2_LAUNCHES
            before = dict(kernels.LAUNCHES)
            t0 = time.time()
            with RowSpy() as spy:
                c.send_image(stream_image("sine", SERVE_INPUT, 0.3 * i))
                reply = c.recv()
            wall = time.time() - t0
            delta = launch_delta(before)
            if not isinstance(reply, tuple):
                raise AssertionError(f"ws frame {i}: {reply}")
            meta, jpeg = reply
            out = codec.decode(jpeg)
            emit({"phase": "serve_stream", "path": "ws stream", "wall_s": wall,
                  "elapsed_s": meta.get("elapsed"), "lag": meta.get("lag"),
                  "frame": meta.get("frame"), "keyframe": meta.get("keyframe"),
                  "jpeg_bytes": len(jpeg), "launches": {k: n for k, n in delta.items() if n},
                  "rows": spy.rows, "shape": list(out.shape)})
            if out.shape != (SERVE_INPUT, SERVE_INPUT, 3) or not stream_k1(
                    spy, want["flash_joint"]):
                raise AssertionError(f"ws frame {i}: {meta} {out.shape} {spy.rows}")
            check_counts(f"ws stream frame {i}", delta, want)
            lags.append(meta["lag"])
        if lags != [0, 1, 1, 1]:
            raise AssertionError(f"ws stream: lags {lags}")
    finally:
        c.close()


def serve_race(url: str, payload: dict) -> None:
    """Two concurrent /edits, queueing off: exactly one 200 and one 429."""
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels
    import threading

    barrier, out = threading.Barrier(2), []

    def post():
        barrier.wait()
        out.append(http(url + "/edit", payload)[0])

    before = dict(kernels.LAUNCHES)
    threads = [threading.Thread(target=post) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    delta = launch_delta(before)
    emit({"phase": "serve_race", "statuses": sorted(out),
          "launches": {k: n for k, n in delta.items() if n}})
    if sorted(out) != [200, 429]:
        raise AssertionError(f"race: statuses {out}")
    check_counts("race", delta, {"flash_joint": K1_LAUNCHES})


def serve_dynamic(pipe, payloads) -> None:
    """A second engine with dynamic_batch=2 on the same pipeline: two
    compatible requests enqueue while its lock is held, then coalesce into
    one 2-row dispatch: both 200 with batched_with 2, K1 120 at 2 rows, one
    LM call (K2 28 at 2 rows) and one batched condition encode."""
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels
    import threading

    from qwen_image_edit_streamdiffusion_tpu_torch.runtime.engine import InferenceEngine

    engine = InferenceEngine(pipeline=pipe, input_size=SERVE_INPUT, default_steps=STEPS,
                             dynamic_batch=2)
    srv, url = start_server(engine)
    try:
        out = {}

        def post(i):
            out[i] = http(url + "/edit", payloads[i])

        engine._lock.acquire()
        threads = [threading.Thread(target=post, args=(i,)) for i in range(2)]
        before = dict(kernels.LAUNCHES)
        with RowSpy() as spy:
            for t in threads:
                t.start()
            for _ in range(6000):
                with engine._bq_lock:
                    if len(engine._batch_queue) == 2:
                        break
                time.sleep(0.005)
            engine._lock.release()
            for t in threads:
                t.join(timeout=600)
        delta = launch_delta(before)
        emit({"phase": "serve_dynamic_batch",
              "statuses": [out[i][0] for i in range(2)],
              "batched_with": [out[i][1].get("batched_with") for i in range(2)],
              "wall_s": [out[i][2] for i in range(2)],
              "elapsed_s": [out[i][1].get("elapsed") for i in range(2)],
              "launches": {k: n for k, n in delta.items() if n}, "rows": spy.rows})
        if any(out[i][0] != 200 or out[i][1].get("batched_with") != 2 for i in range(2)):
            raise AssertionError(f"dynamic batching: {[out[i][:2] for i in range(2)]}")
        check_counts("dynamic batching", delta, expected(True, encodes=1),
                     {**k1_rows(2), "flash_causal": {"2": K2_LAUNCHES},
                      "conv3x3": {"2": K3_ENCODE + K3_DECODE}}, spy)
    finally:
        stop_server(srv)


def serve_profile(url: str, payload: dict, want: dict) -> None:
    """/profile/start, one /edit, /profile/stop: the Chrome trace must exist
    and name K1's kernel symbol."""
    code, started, _ = http(url + "/profile/start", {})
    if code != 200:
        raise AssertionError(f"/profile/start: {code} {started}")
    body, wall, _ = served(url, "serve", "edit_profiled", payload, want)
    code, stopped, stop_s = http(url + "/profile/stop", {})
    path = stopped.get("trace")
    text = open(path).read() if code == 200 and path and os.path.exists(path) else ""
    k1 = text.count("flash_fwd_sm90_kernel")
    emit({"phase": "serve_profile", "status": code, "trace": path, "trace_bytes": len(text),
          "k1_symbol_mentions": k1, "stop_s": stop_s, "edit_wall_s": wall})
    if k1 == 0:
        raise AssertionError(f"the trace {path} does not name flash_fwd_sm90_kernel")


def serve_codec(miss_output) -> dict:
    """The codec on the card's host: decode of a 512² q90 frame and encode of
    the served miss's 1024² output, median ms of 20."""
    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

    frame = codec.encode_jpeg(distinct_image(9000, SERVE_INPUT), 90)
    times = {"decode_512_q90": host_ms(lambda: codec.decode(frame), 20),
             "encode_1024_q90": host_ms(lambda: codec.encode_jpeg(miss_output, 90), 20)}
    rec = {"phase": "serve_codec", **{f"{k}_ms": v for k, v in times.items()},
           "frame_bytes": len(frame), "output_bytes": len(codec.encode_jpeg(miss_output, 90))}
    emit(rec)
    return rec


def serve_cli(label: str = "serve_cli", args=("--preset", "tiny"), prelude: str = "") -> None:
    """The server's CLI as a subprocess on its default device: ``args`` (by
    default `--preset tiny`) and `--no-warmup` on a free port; /health must
    answer within CLI_HEALTH_S with a GB figure (it runs on the card), one
    /edit must return 200; then the process is terminated
    and waited for. ``prelude`` (Python run before the server's ``main``, in
    the subprocess) registers a preset the package does not hold."""
    import socket
    import urllib.error

    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    log_path = os.path.join(ROOT, "build", "chip_smoke", f"{label}.log")
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    server = ["-m", f"{PKG}.serving.server"]
    if prelude:
        server = ["-c", f"import sys; sys.path.insert(0, {ROOT!r}); {prelude}; "
                        f"from {PKG}.serving.server import main; main(sys.argv[1:])"]
    t0 = time.time()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, *server, *args,
             "--no-warmup", "--host", "127.0.0.1", "--port", str(port)],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        try:
            url, health = f"http://127.0.0.1:{port}", None
            while time.time() - t0 < CLI_HEALTH_S and proc.poll() is None:
                try:
                    code, health, _ = http(url + "/health", timeout=5)
                    break
                except (urllib.error.URLError, ConnectionError, OSError):
                    time.sleep(0.5)
            ready_s = time.time() - t0
            if health is None:
                raise AssertionError(f"CLI server: no /health in {ready_s:.0f} s "
                                     f"(exit {proc.poll()}); see {log_path}")
            code, body, wall = http(url + "/edit", {
                "image": codec.to_base64_jpeg(distinct_image(9100, SERVE_INPUT)), "prompt": PROMPT})
            out = codec.decode_base64(body["image"]) if code == 200 else None
            emit({"phase": label, "ready_s": ready_s, "health": health,
                  "edit_status": code, "edit_wall_s": wall,
                  "shape": None if out is None else list(out.shape)})
            if not str(health.get("gpu_memory", "")).endswith(" GB") or code != 200:
                raise AssertionError(f"CLI server: health {health}, /edit {code} {body}")
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def phase_serve(pipe) -> dict:
    """The serving layer on the live bf16 flagship: an InferenceEngine with
    the server's config (yuv420, batched CFG, 512² input, 2 steps) behind
    make_server in a thread. GET / and /health; /edit miss, hit (each beside
    the pipeline-only call of the same arrays, whose q90 JPEG must decode to
    the served images bit for bit), use_cfg, ref_mode
    condition, num_images 2; misses uploaded as a progressive JPEG, a lossy
    WebP, a CMYK JPEG, a TIFF (LZW, Predictor 2), a PSD (PackBits) and a BLP2
    (256 colours, held to its quantized source); a race of two (one
    429); dynamic batching on a second engine; a pipelined stream session
    over HTTP and over the websocket; a profiled /edit; the codec's ms; the
    CLI as a subprocess.
    Restores the pipeline's config."""
    import base64

    import numpy as np

    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime.engine import InferenceEngine

    t0 = time.time()
    codec.library()  # built with the host's c++ at first use
    emit({"phase": "serve_codec_build", "seconds": time.time() - t0,
          "library": str(codec.library_path())})
    saved = pipe.config
    pipe.config = pipe.config.replace(transfer_format="yuv420", cfg_mode="batched",
                                      decoder="full", encoder="full")
    engine = InferenceEngine(pipeline=pipe, input_size=SERVE_INPUT, default_steps=STEPS)
    srv, url = start_server(engine)
    kernels.reset_launches()
    b64 = {i: codec.to_base64_jpeg(distinct_image(i, SERVE_INPUT)) for i in range(8000, 8007)}
    try:
        code, root, _ = http(url + "/")
        code_h, health, _ = http(url + "/health")
        emit({"phase": "serve_get", "root": root, "health": health})
        if code != 200 or code_h != 200 or not str(health["gpu_memory"]).endswith(" GB"):
            raise AssertionError(f"GET /: {code} {root}; /health: {code_h} {health}")

        req = {"image": b64[8000], "prompt": PROMPT}
        item = engine._parse_edit(dict(req))
        miss_body, miss_wall, miss_out = served(url, "serve", "edit_miss", req, expected(True))
        miss_plain, plain_images = pipeline_only(pipe, item, fresh_caches=True)
        _, hit_wall, hit_out = served(url, "serve", "edit_hit", req, expected(False))
        hit_plain, hit_images = pipeline_only(pipe, item, fresh_caches=False)
        # the wire returns the pipeline's image: the served miss and hit decode
        # to the pipeline-only output through the same q90 JPEG, bit for bit
        want = codec.decode(codec.encode_jpeg(plain_images[0], 90))
        wire_err = {"miss": int(np.abs(miss_out.astype(np.int16) - want).max()),
                    "hit": int(np.abs(hit_out.astype(np.int16) - want).max()),
                    "pipeline_hit_vs_miss": int(np.abs(
                        hit_images[0].astype(np.int16) - plain_images[0]).max())}
        emit({"phase": "serve_wire", "miss_wall_s": miss_wall, "miss_elapsed_s":
              miss_body["elapsed"], "miss_pipeline_only_s": miss_plain,
              "miss_wire_s": miss_wall - miss_plain, "hit_wall_s": hit_wall,
              "hit_pipeline_only_s": hit_plain, "hit_wire_s": hit_wall - hit_plain,
              "max_abs_diff_vs_pipeline": wire_err})
        if any(wire_err.values()):
            raise AssertionError(f"served images differ from the pipeline's: {wire_err}")
        served(url, "serve", "edit_cfg_miss", {"image": b64[8001], "prompt": PROMPT,
                                               "use_cfg": True},
               expected(True), {**k1_rows(2), "flash_causal": {"2": K2_LAUNCHES}})
        served(url, "serve", "edit_ref_condition_miss",
               {"image": b64[8002], "ref_image": b64[8003], "ref_mode": "condition",
                "prompt": PROMPT}, expected(True, 2),
               k1_rows(1, txt=TXT_LEN_TWO, images=2))
        served(url, "serve", "edit_num_images_2_miss",
               {"image": b64[8004], "prompt": PROMPT, "num_images": 2}, expected(True),
               {**k1_rows(2), "conv3x3": {"1": K3_ENCODE, "2": K3_DECODE}}, outputs=2)
        served(url, "serve", "edit_progressive_miss",
               {"image": fixture_b64(PROGRESSIVE_UPLOAD), "prompt": PROMPT}, expected(True),
               k1_rows(1))
        # uploads the web clients never send, API clients may: a lossy WebP
        # and a CMYK JPEG (written without Pillow, :func:`cmyk_jpeg`)
        served(url, "serve", "edit_webp_miss",
               {"image": fixture_b64(WEBP_UPLOAD), "prompt": PROMPT}, expected(True),
               k1_rows(1))
        rgb = distinct_image(8007, SERVE_INPUT)
        cmyk = cmyk_jpeg([rgb[..., 0], rgb[..., 1], rgb[..., 2], rgb[..., 1] // 4])
        served(url, "serve", "edit_cmyk_miss",
               {"image": base64.b64encode(cmyk).decode(), "prompt": PROMPT}, expected(True),
               k1_rows(1))
        # a TIFF (LZW + horizontal differencing, strips), written here
        src = distinct_image(8008, SERVE_INPUT)
        tif = tiff_upload(src)
        t0 = time.perf_counter()
        tif_px = codec.decode(tif)
        emit({"phase": "serve_tiff_upload", "bytes": len(tif), "shape": list(tif_px.shape),
              "decode_ms": (time.perf_counter() - t0) * 1e3,
              "equal_to_source": bool(np.array_equal(tif_px, src))})
        if not np.array_equal(tif_px, src):
            raise AssertionError("the TIFF upload does not decode to its source")
        served(url, "serve", "edit_tiff_miss",
               {"image": base64.b64encode(tif).decode(), "prompt": PROMPT}, expected(True),
               k1_rows(1))
        # a PSD (the merged image, PackBits rows), written here
        src = distinct_image(8009, SERVE_INPUT)
        psd = psd_upload(src)
        t0 = time.perf_counter()
        psd_px = codec.decode(psd)
        emit({"phase": "serve_psd_upload", "bytes": len(psd), "shape": list(psd_px.shape),
              "decode_ms": (time.perf_counter() - t0) * 1e3,
              "equal_to_source": bool(np.array_equal(psd_px, src))})
        if not np.array_equal(psd_px, src):
            raise AssertionError("the PSD upload does not decode to its source")
        served(url, "serve", "edit_psd_miss",
               {"image": base64.b64encode(psd).decode(), "prompt": PROMPT}, expected(True),
               k1_rows(1))
        # a BLP2 texture (the image in 256 colours, an uncompressed palette), written here
        blp, src = blp_upload(distinct_image(8010, SERVE_INPUT))
        t0 = time.perf_counter()
        blp_px = codec.decode(blp)
        emit({"phase": "serve_blp_upload", "bytes": len(blp), "shape": list(blp_px.shape),
              "decode_ms": (time.perf_counter() - t0) * 1e3,
              "equal_to_source": bool(np.array_equal(blp_px, src))})
        if not np.array_equal(blp_px, src):
            raise AssertionError("the BLP upload does not decode to its quantized source")
        served(url, "serve", "edit_blp_miss",
               {"image": base64.b64encode(blp).decode(), "prompt": PROMPT}, expected(True),
               k1_rows(1))
        serve_race(url, req)
        serve_dynamic(pipe, [{"image": b64[i], "prompt": PROMPT} for i in (8005, 8006)])
        serve_stream_http(url, engine)
        serve_stream_ws("127.0.0.1", srv.server_address[1])
        serve_profile(url, req, expected(False))
        serve_codec(miss_out)
    finally:
        stop_server(srv)
        pipe.config = saved
    launches = dict(kernels.LAUNCHES)
    serve_cli()
    return launches


def serve_int8(pipe) -> dict:
    """One /edit miss through an engine on the int8 pipeline: K5 and K6
    once per quantized linear the request runs (1558)."""
    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime.engine import InferenceEngine

    saved = pipe.config
    pipe.config = pipe.config.replace(transfer_format="yuv420", cfg_mode="batched")
    srv, url = start_server(InferenceEngine(pipeline=pipe, input_size=SERVE_INPUT,
                                            default_steps=STEPS))
    kernels.reset_launches()
    try:
        served(url, "int8 serve", "edit_miss",
               {"image": codec.to_base64_jpeg(distinct_image(8100, SERVE_INPUT)), "prompt": PROMPT},
               expected(True, int8_per_request=INT8_MMDIT, int8_miss=INT8_LM + INT8_VISION))
    finally:
        stop_server(srv)
        pipe.config = saved
    return dict(kernels.LAUNCHES)


# (symbol fragment, kind) of the port's kernels, as torch.profiler names them
KERNEL_KINDS = (("flash_fwd_sm90_kernel<false, true,", "K2 flash_fwd_sm90 causal"),
                ("flash_fwd_sm90", "K1/K4/K7 flash_fwd_sm90"),
                ("conv3x3", "K3 conv3x3"),
                ("quantize_rows", "K5 quantize_rows"),
                ("int8_gemm_mma", "K6 int8_gemm_mma (K % 16 != 0)"),
                ("int8_gemm", "K6 int8_gemm_sm90"),
                ("flash_bwd_dq", "K8 flash_bwd_dq"),
                ("flash_bwd_dkv", "K9 flash_bwd_dkv"))


def kernel_kind(name: str) -> str:
    for frag, kind in KERNEL_KINDS:
        if frag in name:
            return kind
    if any(w in name.lower() for w in ("gemm", "cutlass", "xmma", "nvjet")):
        return "GEMM (cuBLAS)"
    return "other"


def profile_call(fn, plain_wall=None) -> dict:
    """Device time of one call of ``fn`` by kernel kind (torch.profiler), its
    wall seconds, device busy seconds, and the span from its first device
    event's start to its last one's end. The profiler's host cost stretches
    that wall and span, so the idle share is taken against ``plain_wall``,
    the wall seconds of the same work timed without the profiler:
    1 - busy / plain_wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.time() - t0
    t_read = time.time()
    per, span = device_events(prof)
    kinds, top, events = {}, [], 0
    for name, (t, count) in per.items():
        kind = kernel_kind(name)
        kinds[kind] = kinds.get(kind, 0.0) + t
        top.append((t, count, name[:90]))
        events += count
    busy = sum(kinds.values())
    top.sort(reverse=True)
    out = {"wall_s": wall, "busy_s": busy, "span_s": span,
           "span_idle_share": 1 - busy / span, "device_events": events,
           "read_s": time.time() - t_read}
    if plain_wall is not None:
        out.update(plain_wall_s=plain_wall, idle_share=1 - busy / plain_wall,
                   host_gap_s=plain_wall - busy)
    out.update(device_s=dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
               top=[{"s": t, "calls": c, "kernel": n} for t, c, n in top[:12]])
    return out


def device_events(prof):
    """({kernel name: (device seconds, calls)}, the span in seconds from the
    first device event's start to the last one's end) of a finished
    torch.profiler run, read from its raw Kineto events (the profiler's
    event tree, which ``key_averages`` builds first, takes tens of seconds
    over a train step's 30k kernels). A device event is a kernel, copy or
    set."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    per: dict = {}
    first, last = None, None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        t, n = per.get(e.name(), (0.0, 0))
        per[e.name()] = (t + e.duration_ns() / 1e9, n + 1)
        first = e.start_ns() if first is None else min(first, e.start_ns())
        last = e.end_ns() if last is None else max(last, e.end_ns())
    return per, (last - first) / 1e9


def profile_request(pipe, label: str, want: dict, image: int,
                    cfg_mode=None) -> dict:
    """Two more cache misses on ``pipe`` (images ``image``, ``image`` + 1):
    one timed plainly, then one under torch.profiler: device time by kernel
    kind, busy seconds and the idle share against the plain miss's wall
    (the profiles PERF.md §5 keeps); guided in ``cfg_mode`` when given.
    Returns their launches, each held to ``want``, a miss's counts."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

    def miss(i):
        if cfg_mode is not None:
            return guided(pipe, cfg_mode, distinct_image(i))
        return lambda: pipe(distinct_image(i), PROMPT, num_inference_steps=STEPS,
                            seed=42)

    total = {k: 0 for k in kernels.LAUNCHES}
    plain_wall = None
    for name, img in (("miss_plain", image), ("miss_profiled", image + 1)):
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.time()
        if plain_wall is None:
            miss(img)()
            torch.cuda.synchronize()
            plain_wall = time.time() - t0
            rec = {"wall_s": plain_wall}
        else:
            rec = profile_call(miss(img), plain_wall)
        delta = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
        emit({"phase": "request_profile", "path": label, "name": name,
              "launches": delta, **rec})
        for key, n in want.items():
            if delta[key] != n:
                raise AssertionError(f"{name}: {key} ran {delta[key]} times, not {n}")
        for k, n in delta.items():
            total[k] += n
    return total


def profile_hit(pipe, label: str) -> None:
    """A cache hit (image 0, PROMPT) timed plainly, then one under
    torch.profiler, as :func:`profile_request` does for misses."""
    import torch

    def hit():
        return pipe(distinct_image(0), PROMPT, num_inference_steps=STEPS, seed=42)

    torch.cuda.synchronize()
    t0 = time.time()
    hit()
    torch.cuda.synchronize()
    emit({"phase": "request_profile", "path": label, "name": "hit_profiled",
          **profile_call(hit, time.time() - t0)})


def phase_train(pipe):
    """LoRA fine-tune of the live bf16 flagship: rank 16 on the default
    attention targets, remat, a batch of two 1024² rows; warm-up, timed
    steps, one profiled step. Returns the launches of the steps and the
    (adapters, TrainConfig)."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    gc.collect()
    torch.cuda.empty_cache()
    items = [{"image": distinct_image(4000 + i), "prompt": PROMPT,
              "target": distinct_image(5000 + i)} for i in range(TRAIN_ROWS)]
    t0 = time.time()
    batch = lt.build_batch(pipe, items)
    torch.cuda.synchronize()
    emit({"phase": "train_batch", "seconds": time.time() - t0,
          "rows": TRAIN_ROWS, "img_shapes": batch["img_shapes"],
          "shapes": {k: list(v.shape) for k, v in batch.items()
                     if torch.is_tensor(v)}})
    cfg = lt.TrainConfig(rank=TRAIN_RANK, alpha=16.0, remat=True)
    trainer = lt.LoRATrainer.from_pipeline(pipe, cfg)
    leaves = lt.lora_leaves(trainer.lora)
    before = [t.detach().clone() for t in leaves]
    want = {"flash_fwd_lse": 2 * MMDIT_LAYERS, "flash_bwd_dq": MMDIT_LAYERS,
            "flash_bwd_dkv": MMDIT_LAYERS, "flash_joint": 0,
            "flash_joint_stream": 0}
    kernels.reset_launches()
    for name in ["warmup"] + [f"step{i}" for i in range(TRAIN_STEPS)]:
        prev = dict(kernels.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.time()
        loss = trainer.step(batch)
        torch.cuda.synchronize()
        wall = time.time() - t0
        delta = {k: kernels.LAUNCHES[k] - prev[k] for k in kernels.LAUNCHES}
        grads = [p.grad for p in leaves]
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads)).item()
        emit({"phase": "train_step", "name": name, "seconds": wall, "loss": loss,
              "launches": delta, "grad_norm_clipped": gnorm,
              "grads_finite": finite, "peak_bytes": torch.cuda.max_memory_allocated()})
        for key, n in want.items():
            if delta[key] != n:
                raise AssertionError(f"train/{name}: {key} ran {delta[key]} times, "
                                     f"not {n}")
        if not (math.isfinite(loss) and finite and gnorm > 0):
            raise AssertionError(f"train/{name}: loss {loss}, grads finite "
                                 f"{finite}, norm {gnorm}")
    launches = dict(kernels.LAUNCHES)
    changed = sum(not torch.equal(a, b) for a, b in zip(before, leaves))
    emit({"phase": "train_profile", "adapters_changed": changed,
          "adapters": len(leaves),
          **profile_call(lambda: trainer.step(batch), wall)})  # wall: the last timed step
    if changed == 0:
        raise AssertionError("training changed no adapter")
    return launches, (trainer.lora, cfg)


def phase_lora_serve(pipe, trained, pre_latents):
    """Export the trained adapters, write them with the port's .safetensors
    writer, read them back, fuse them into the live pipeline in place and
    serve a cache hit again at the same seed."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.models import lora
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    adapters, cfg = trained
    sd = lt.export_lora_state_dict(adapters, cfg)
    path = os.path.join(ROOT, "build", "chip_smoke", "lora.safetensors")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    lora.save_safetensors(path, sd)
    loaded = lora.load_lora_weights(path)
    if sorted(loaded) != sorted(sd) or not all(
            torch.equal(loaded[k], torch.from_numpy(sd[k])) for k in sd):
        raise AssertionError("the .safetensors round trip changed the adapters")
    del adapters, trained
    gc.collect()
    torch.cuda.empty_cache()
    lora.fuse_lora(pipe.tfm_params, loaded)
    out = {}
    launches = run_requests(pipe, [("lora_hit", [distinct_image(0)], PROMPT,
                                    expected(False))], "bf16+lora", out)
    diff = (out["lora_hit"] - pre_latents).abs().max().item()
    emit({"phase": "lora_serve", "file_bytes": os.path.getsize(path),
          "tensors": len(loaded), "latents_max_abs_change": diff})
    if not diff > 0:
        raise AssertionError("the fused LoRA did not change the edit")
    return launches


DISTILL_ITEMS = 4
DISTILL_DIR = os.path.join(ROOT, "build", "chip_smoke", "data")


def write_distill_data() -> str:
    """A JSONL manifest of DISTILL_ITEMS 1024² items under DISTILL_DIR: each
    condition image a JPEG (q90, the port's codec), each target a PNG; the
    first two carry the negative prompt ""."""
    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec, imaging

    os.makedirs(DISTILL_DIR, exist_ok=True)
    lines = []
    for i in range(DISTILL_ITEMS):
        item = {"image": f"in{i}.jpg", "target": f"out{i}.png", "prompt": PROMPT}
        with open(os.path.join(DISTILL_DIR, item["image"]), "wb") as f:
            f.write(codec.encode_jpeg(distinct_image(6000 + i), 90))
        imaging.write_png(os.path.join(DISTILL_DIR, item["target"]),
                          distinct_image(7000 + i))
        if i < 2:
            item["negative_prompt"] = NEG
        lines.append(json.dumps(item))
    path = os.path.join(DISTILL_DIR, "train.jsonl")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def distill_want(guided: bool, steps: int = 1) -> dict:
    """Launches of ``steps`` distillation steps: the teacher's two forwards
    (four guided) on K1, the student's forward twice with remat on K7, its
    backward on K8 and K9."""
    return {"flash_joint": steps * (4 if guided else 2) * MMDIT_LAYERS,
            "flash_fwd_lse": steps * 2 * MMDIT_LAYERS,
            "flash_bwd_dq": steps * MMDIT_LAYERS, "flash_bwd_dkv": steps * MMDIT_LAYERS,
            "flash_joint_stream": 0}


def distill_step(trainer, batch, name: str, guided: bool) -> float:
    """One timed distillation step: wall seconds, loss, launches (held to
    :func:`distill_want`), the clipped gradient norm and the peak bytes."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    before = dict(kernels.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    loss = trainer.step(batch)
    torch.cuda.synchronize()
    wall = time.time() - t0
    delta = launch_delta(before)
    grads = [p.grad for p in lt.lora_leaves(trainer.lora)]
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads)).item()
    emit({"phase": "distill_step", "name": name, "guided": guided,
          "teacher_cfg_scale": trainer.dcfg.teacher_cfg_scale, "seconds": wall,
          "loss": loss, "launches": delta, "grad_norm_clipped": gnorm,
          "grads_finite": finite, "neg_rows": "neg_txt" in batch,
          "peak_bytes": torch.cuda.max_memory_allocated()})
    check_counts(f"distill/{name}", delta, distill_want(guided))
    if not (math.isfinite(loss) and finite and gnorm > 0):
        raise AssertionError(f"distill/{name}: loss {loss}, grads finite {finite}, "
                             f"norm {gnorm}")
    return wall


def phase_distill(pipe) -> dict:
    """Progressive distillation of the live bf16 flagship (rank 16, remat,
    student_steps 2) on a manifest of files through ``EditDataset`` →
    ``BatchLoader``: a warm-up and an unguided step, a guided step
    (scale 4, the batch's negative rows), a profiled step; ``train_loop`` to
    step 2 with a state file, a second ``train_loop`` resumed to step 3 equal
    to the first trainer continued to step 3; the adapter file round trip.
    Returns the launches."""
    import contextlib
    import dataclasses
    import io

    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.models import lora
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels
    from qwen_image_edit_streamdiffusion_tpu_torch.training import data
    from qwen_image_edit_streamdiffusion_tpu_torch.training import distill as dt
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    gc.collect()
    torch.cuda.empty_cache()
    start = dict(kernels.LAUNCHES)
    dataset = data.EditDataset.from_manifest(write_distill_data())
    t0 = time.time()
    batches = list(data.BatchLoader(pipe, dataset, TRAIN_ROWS, seed=0).batches(3))
    torch.cuda.synchronize()
    emit({"phase": "distill_batches", "seconds": time.time() - t0,
          "batches": len(batches), "rows": TRAIN_ROWS,
          "img_shapes": batches[0]["img_shapes"],
          "neg_rows": ["neg_txt" in b for b in batches]})
    with_neg = [b for b in batches if "neg_txt" in b]
    if not with_neg:
        raise AssertionError("no batch of the manifest carries negative rows")

    dcfg = dt.DistillConfig(train=lt.TrainConfig(rank=TRAIN_RANK, alpha=16.0,
                                                 remat=True), student_steps=STEPS)
    trainer = dt.DistillTrainer.from_pipeline(pipe, dcfg)
    initial = [t.detach().clone() for t in lt.lora_leaves(trainer.lora)]
    walls = [distill_step(trainer, batches[i], name, False)
             for i, name in enumerate(("warmup", "step0"))]
    trainer.dcfg = dataclasses.replace(dcfg, teacher_cfg_scale=CFG_SCALE)
    distill_step(trainer, with_neg[0], "guided", True)
    trainer.dcfg = dcfg
    before = dict(kernels.LAUNCHES)
    prof = profile_call(lambda: trainer.step(batches[2]), walls[-1])
    delta = launch_delta(before)
    check_counts("distill/profiled", delta, distill_want(False))
    changed = sum(not torch.equal(a, b)
                  for a, b in zip(initial, lt.lora_leaves(trainer.lora)))
    emit({"phase": "distill_profile", "adapters_changed": changed,
          "adapters": len(initial), "launches": delta, **prof})
    if changed == 0:
        raise AssertionError("distillation changed no adapter")

    path = os.path.join(ROOT, "build", "chip_smoke", "distilled.safetensors")
    lt.save_lora(path, trainer.lora, dcfg.train)
    sd = lt.export_lora_state_dict(trainer.lora, dcfg.train)
    loaded = lora.load_lora_weights(path)
    if sorted(loaded) != sorted(sd) or not all(
            torch.equal(loaded[k], torch.from_numpy(sd[k])) for k in sd):
        raise AssertionError("the distilled adapter file does not read back equal")
    emit({"phase": "distill_lora_file", "file_bytes": os.path.getsize(path),
          "tensors": len(loaded)})
    del trainer, initial, batches, with_neg
    gc.collect()
    torch.cuda.empty_cache()

    state = os.path.join(ROOT, "build", "chip_smoke", "distill_state.pt")
    if os.path.exists(state):
        os.remove(state)
    loader = lambda: data.BatchLoader(pipe, dataset, TRAIN_ROWS, seed=1)
    first = dt.DistillTrainer.from_pipeline(pipe, dcfg)
    resumed = dt.DistillTrainer.from_pipeline(pipe, dcfg)
    before = dict(kernels.LAUNCHES)
    t0 = time.time()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        to2 = data.train_loop(first, loader(), 2, log_every=1, state_path=state,
                              save_every=1)
        torch.cuda.synchronize()
        loop_s = time.time() - t0
        to3 = data.train_loop(resumed, loader(), 3, log_every=1, state_path=state)
        unbroken = data.train_loop(first, loader(), 3)
    delta = launch_delta(before)
    printed = out.getvalue().splitlines()
    equal = all(torch.equal(a, b) for a, b in zip(lt.lora_leaves(first.lora),
                                                  lt.lora_leaves(resumed.lora)))
    emit({"phase": "distill_resume", "seconds_to_step2": loop_s,
          "losses_to_step2": to2, "losses_resumed": to3,
          "loss_unbroken_step3": unbroken, "printed": printed,
          "adapters_equal_unbroken": equal, "steps": [first.steps, resumed.steps],
          "launches": delta})
    if f"resumed from {state} at step 2" not in printed or resumed.steps != 3 \
            or len(to3) != 1 or not equal:
        raise AssertionError(f"distill resume: {printed}, steps {resumed.steps}, "
                             f"adapters equal {equal}")
    check_counts("distill/train_loop", delta, distill_want(False, 4))
    del first, resumed
    gc.collect()
    torch.cuda.empty_cache()
    return launch_delta(start)


TINY_TRAIN_SIZE = 512
TINY_TRAIN_BATCH = 4
TINY_TRAIN_STEPS = 30


def phase_tiny_train(pipe) -> dict:
    """Distil the tiny decoder and the tiny encoder (width 64, 2 blocks a
    stage) from the live flagship VAE at 512², batch 4, on the synthetic
    images: s a step and a batch build, the loss first → last, ``eval_psnr``
    on a fixed batch before → after; K3 20 a decoder batch (the full encode
    and decode), 5 an encoder batch, 30 an encoder ``eval_psnr`` (two full
    decodes), 0 a step (the tiny chain is ``F.conv2d``); both artifacts
    saved and read back equal. Returns the launches."""
    import numpy as np
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.models import tiny_vae as tv
    from qwen_image_edit_streamdiffusion_tpu_torch.models.common import flatten
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels
    from qwen_image_edit_streamdiffusion_tpu_torch.training import tiny_vae as tt

    gc.collect()
    torch.cuda.empty_cache()
    start = dict(kernels.LAUNCHES)
    imgs = tt._synthetic_images(TINY_TRAIN_SIZE, 8 * TINY_TRAIN_BATCH)
    eval_imgs = tt._synthetic_images(TINY_TRAIN_SIZE, TINY_TRAIN_BATCH, seed=1)
    full = K3_ENCODE + K3_DECODE
    for kind, cls, build, k3_batch, k3_eval, load in (
            ("decoder", tt.TinyVAETrainer, tt.build_decoder_batch, full, 0, tv.load),
            ("encoder", tt.TinyEncoderTrainer, tt.build_encoder_batch, K3_ENCODE,
             2 * K3_DECODE, tv.load_encoder)):
        trainer = cls.from_pipeline(pipe, tt.TinyVAETrainConfig())
        torch.cuda.reset_peak_memory_stats()
        eval_batch = build(pipe, eval_imgs)
        before = dict(kernels.LAUNCHES)
        psnr0 = trainer.eval_psnr(eval_batch)
        check_counts(f"tiny_train/{kind} eval", launch_delta(before), {"conv3x3": k3_eval})
        rng = np.random.default_rng(0)
        losses, batch_s, step_s = [], [], []
        for i in range(TINY_TRAIN_STEPS):
            pick = rng.choice(len(imgs), size=TINY_TRAIN_BATCH, replace=False)
            before = dict(kernels.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.time()
            batch = build(pipe, [imgs[j] for j in pick])
            torch.cuda.synchronize()
            batch_s.append(time.time() - t0)
            check_counts(f"tiny_train/{kind} batch", launch_delta(before),
                         {"conv3x3": k3_batch})
            before = dict(kernels.LAUNCHES)
            t0 = time.time()
            losses.append(trainer.step(batch))
            torch.cuda.synchronize()
            step_s.append(time.time() - t0)
            check_counts(f"tiny_train/{kind} step", launch_delta(before), {"conv3x3": 0})
        psnr1 = trainer.eval_psnr(eval_batch)
        path = os.path.join(ROOT, "build", "chip_smoke", f"tiny_{kind}.safetensors")
        trainer.save(path)
        params, cfg = load(path, pipe.device)
        want = flatten(trainer.export())
        got = flatten(params)
        same = sorted(got) == sorted(want) and all(torch.equal(got[k], want[k])
                                                   for k in want)
        emit({"phase": "tiny_train", "kind": kind, "width": cfg.width,
              "blocks_per_stage": cfg.blocks_per_stage, "dtype": cfg.dtype,
              "size": TINY_TRAIN_SIZE, "batch": TINY_TRAIN_BATCH,
              "steps": TINY_TRAIN_STEPS,
              "s_step_median": statistics.median(step_s[1:]), "s_step_first": step_s[0],
              "s_batch_median": statistics.median(batch_s[1:]),
              "s_batch_first": batch_s[0], "loss_first": losses[0],
              "loss_last": losses[-1], "psnr_before": psnr0, "psnr_after": psnr1,
              "k3_batch": k3_batch, "k3_eval": k3_eval, "artifact_bytes":
              os.path.getsize(path), "artifact_equal": same,
              "peak_bytes": torch.cuda.max_memory_allocated()})
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]
                and psnr1 > psnr0 and same):
            raise AssertionError(f"tiny_train/{kind}: loss {losses[0]} → {losses[-1]}, "
                                 f"PSNR {psnr0} → {psnr1}, artifact equal {same}")
        del trainer, eval_batch, batch, params
        gc.collect()
        torch.cuda.empty_cache()
    return launch_delta(start)


def phase_int8():
    """The int8 rung (MMDiT and VL): K5 → K6 for every quantized linear;
    a batched-CFG miss; then a plain and a profiled miss."""
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

    pipe = create_pipeline("int8", use_int8=True, use_int8_vl=True)
    one = dict(int8_per_request=INT8_MMDIT, int8_miss=INT8_LM + INT8_VISION)
    two = [distinct_image(3000), distinct_image(3001)]
    requests = ([("warmup", [distinct_image(1001)], "warmup", expected(True, **one))]
                + [(f"miss{i}", [distinct_image(10 + i)], PROMPT, expected(True, **one))
                   for i in range(3)]
                + [(f"hit{i}", [distinct_image(10)], PROMPT, expected(False, **one))
                   for i in range(2)]
                # the two images run the vision tower as one batch: its
                # linears launch once for both, at 2 × 784 rows
                + [("two_images", two, PROMPT,
                    expected(True, 2, int8_per_request=INT8_MMDIT,
                             int8_miss=INT8_LM + INT8_VISION))])
    run_requests(pipe, requests, "int8")
    # batched CFG: the pair runs as one forward, so K5/K6 launch as often as
    # for a cond-only miss, at twice the rows (M = 16384, 512, 768 and 2)
    serve("int8", "cfg_batched_miss", guided(pipe, "batched", distinct_image(3010)),
          expected(True, **one), k1_rows(2))
    pipe.config = pipe.config.replace(cfg_mode="none")
    stream_int8(pipe)
    launches = dict(kernels.LAUNCHES)
    for k, n in serve_int8(pipe).items():
        launches[k] += n
    for k, n in profile_request(pipe, "int8", expected(True, **one), 6010).items():
        launches[k] += n
    return launches


def phase_int4():
    """The int4 rung: dequantize + dense product; the vision `down` leaves
    (in-dim 3420, not a multiple of 64) take the int8 rung."""
    pipe = create_pipeline("int4", use_int4=True, use_int4_vl=True)
    requests = [("warmup", [distinct_image(1002)], "warmup",
                 expected(True, int8_miss=INT4_VISION)),
                ("miss0", [distinct_image(20)], PROMPT,
                 expected(True, int8_miss=INT4_VISION))]
    return run_requests(pipe, requests, "int4")


# The checkpoint phase's tree: the flagship at full width, depth cut to 2
# MMDiT blocks, 2 LM layers and 2 vision blocks (the full VAE and the full
# 152064 × 3584 embedding), written in the HF layout in bf16 with shards of
# HF_SHARD_BYTES: the cut transformer (1.44 GB) and VL (2.19 GB) then span 4
# and 5 shards, and block 1's image q/k/v straddle two of them
CUT_PRESET = "qwen-image-edit-2509-depth2"
CUT_DEPTH = 2
HF_SHARD_BYTES = 400 << 20
REGISTER_CUT = "import chip_smoke; chip_smoke.cut_preset()"


TP_PRESET = "qwen-image-edit-2509-mmdit6"
TP_DEPTH = 6       # the MMDiT blocks of phases tp, tp_train and tp_stream (gloo time
                   # goes with the depth)
K1_TP = TP_DEPTH * STEPS


def tp_preset():
    """The flagship preset with only its MMDiT cut to TP_DEPTH blocks (the
    VL encoder and the VAE whole), registered as TP_PRESET."""
    import dataclasses

    from qwen_image_edit_streamdiffusion_tpu_torch.core import config

    full = config.get_preset("qwen-image-edit-2509")
    cut = dataclasses.replace(full, name=TP_PRESET,
                              model=dataclasses.replace(full.model, num_layers=TP_DEPTH))
    config.PRESETS[TP_PRESET] = cut
    return cut


def cut_preset():
    """The flagship preset with its depths cut to CUT_DEPTH, registered as
    CUT_PRESET in the port's presets (so the CLIs find it by name)."""
    import dataclasses

    from qwen_image_edit_streamdiffusion_tpu_torch.core import config

    full = config.get_preset("qwen-image-edit-2509")
    cut = dataclasses.replace(
        full, name=CUT_PRESET, model=dataclasses.replace(full.model, num_layers=CUT_DEPTH),
        vl=dataclasses.replace(full.vl, num_layers=CUT_DEPTH, vision_depth=CUT_DEPTH))
    config.PRESETS[CUT_PRESET] = cut
    return cut


def flagship_weight_bytes() -> int:
    """The full flagship's weight bytes (MMDiT, VL encoder, VAE), counted
    on meta-device inits."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.core.config import get_preset
    from qwen_image_edit_streamdiffusion_tpu_torch.models import qwen_vl, vae
    from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm
    from qwen_image_edit_streamdiffusion_tpu_torch.models.common import flatten

    full, meta = get_preset("qwen-image-edit-2509"), torch.device("meta")
    trees = (tfm.init(None, full.model, meta), qwen_vl.init(None, full.vl, meta),
             vae.init(None, full.vae, meta))
    return sum(t.numel() * t.element_size() for tree in trees for t in flatten(tree).values())


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def host_rss() -> int:
    """This process's resident bytes (VmRSS)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise AssertionError("no VmRSS in /proc/self/status")


class RssPeak:
    """The peak of VmRSS over a ``with`` block, sampled every millisecond in
    a thread (the card's machine refuses a write to /proc/self/clear_refs,
    so VmHWM cannot be reset to time a window): ``growth`` is the peak less
    the RSS at entry."""

    def __enter__(self):
        import threading

        self.base = self.peak = host_rss()
        self.samples = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, host_rss())
            self.samples += 1
            time.sleep(0.001)

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, host_rss())
        self.growth = self.peak - self.base


def straddling_qkv(index_path: str, layers: int) -> list:
    """(block, stream) pairs whose q, k and v tensors lie in more than one
    shard of an HF index."""
    with open(index_path) as f:
        where = json.load(f)["weight_map"]
    out = []
    for b in range(layers):
        for stream, names in (("img", ("to_q", "to_k", "to_v")),
                              ("txt", ("add_q_proj", "add_k_proj", "add_v_proj"))):
            files = {where[f"transformer_blocks.{b}.attn.{n}.{p}"]
                     for n in names for p in ("weight", "bias")}
            if len(files) > 1:
                out.append((b, stream))
    return out


def assert_equal_trees(what: str, got, want) -> int:
    """Every leaf of ``got`` equals ``want``'s, dtype and bits; returns the
    leaves compared."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.models.common import flatten

    fg, fw = flatten(got), flatten(want)
    if sorted(fg) != sorted(fw):
        raise AssertionError(f"{what}: leaves differ: {sorted(set(fg) ^ set(fw))[:6]}")
    bad = [k for k in fg if fg[k].dtype != fw[k].dtype or not torch.equal(fg[k], fw[k])]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} leaves differ, e.g. {bad[:4]}")
    return len(fg)


def same_latents(what: str, loaded, in_memory, image) -> dict:
    """One miss of the same request on the loaded and on the in-memory
    pipeline, and a second in-memory miss (fresh caches): the loaded
    latents must equal the in-memory ones bit for bit, or, if the two
    in-memory runs differ, lie within their spread."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.cache import LatentCache, PromptCache

    def miss(pipe):
        pipe.prompt_cache, pipe.latent_cache = PromptCache(pipe.encoder), LatentCache()
        return pipe(image, PROMPT, num_inference_steps=STEPS, seed=42).latents

    got, ref, ref2 = miss(loaded), miss(in_memory), miss(in_memory)
    spread = float((ref - ref2).abs().max())
    err = float((got - ref).abs().max())
    rec = {"phase": "checkpoint_latents", "rung": what, "bit_equal": bool(torch.equal(got, ref)),
           "max_abs_diff": err, "in_memory_spread": spread,
           "finite": bool(torch.isfinite(got).all())}
    emit(rec)
    if not rec["finite"] or not (rec["bit_equal"] if spread == 0 else err <= spread):
        raise AssertionError(f"{what}: loaded latents differ from the in-memory pipeline's: {rec}")
    return rec


# ---------------------------------------------------------------------------
# Real inputs: a Qwen2-layout tokenizer.json and the codec's fixtures
# ---------------------------------------------------------------------------

# Qwen2.5-VL's added tokens, contiguous from its base vocabulary's end
# (151 643); the last element says whether the token is special
QWEN2_VL_ADDED = (
    ("<|endoftext|>", True), ("<|im_start|>", True), ("<|im_end|>", True),
    ("<|object_ref_start|>", True), ("<|object_ref_end|>", True), ("<|box_start|>", True),
    ("<|box_end|>", True), ("<|quad_start|>", True), ("<|quad_end|>", True),
    ("<|vision_start|>", True), ("<|vision_end|>", True), ("<|vision_pad|>", True),
    ("<|image_pad|>", True), ("<|video_pad|>", True), ("<tool_call>", False),
    ("</tool_call>", False), ("<|fim_prefix|>", False), ("<|fim_middle|>", False),
    ("<|fim_suffix|>", False), ("<|fim_pad|>", False), ("<|repo_name|>", False),
    ("<|file_sep|>", False))
QWEN2_BASE_VOCAB = 151643
TOKENIZER_MERGES = 400
TOKENIZER_CORPUS = (
    "Transform into oil painting style. Turn it into a watercolor painting. "
    "Replace the sky with stars; make the cat's fur orange, and don't change "
    "the background. It's the user's picture: we'll keep it, they're happy, "
    "you've seen it, I'm sure, she'd agree.\n\nPicture 1: Picture 2: "
    "Describe the key features of the input image (color, shape, size, texture, "
    "objects, background), then explain how the user's text instruction should "
    "alter or modify the image. Generate a new image that meets the user's "
    "requirements while maintaining consistency with the original input where "
    "appropriate.\r\n  system user assistant 1024 × 768 px, 3.5 steps — 100%!\t"
    "把这张照片变成油画风格，天空换成星空。写真を水彩画にしてください。"
    "사진을 유화 스타일로 바꿔 주세요. Сделай фото в стиле масляной живописи. "
    "Ψηφιακή ζωγραφική. اجعلها لوحة زيتية. तस्वीर को तेल चित्र बनाओ। "
    "Café crème, naïve façade, Ångström, Straße. 🎨🖌️✨ ١٢٣ ４５６ Ⅻ ½")


def learn_merges(corpus: str = TOKENIZER_CORPUS, n: int = TOKENIZER_MERGES) -> list:
    """Byte-level BPE merges learned on ``corpus`` (pre-tokenized as Qwen2
    does): the most frequent adjacent pair each round, the smallest pair of
    equal counts, ``n`` rounds or until no pair is left."""
    import unicodedata
    from collections import Counter

    from qwen_image_edit_streamdiffusion_tpu_torch.models.tokenizer import (
        BYTE_CHARS,
        pre_tokenize,
    )

    words = Counter("".join(BYTE_CHARS[b] for b in w.encode())
                    for w in pre_tokenize(unicodedata.normalize("NFC", corpus)))
    seqs = {w: list(w) for w in words}
    merges = []
    while len(merges) < n:
        pairs = Counter()
        for w, syms in seqs.items():
            for a, b in zip(syms, syms[1:]):
                pairs[(a, b)] += words[w]
        if not pairs:
            break
        top = max(pairs.values())
        a, b = min(p for p, c in pairs.items() if c == top)
        merges.append((a, b))
        for syms in seqs.values():
            i = 0
            while i < len(syms) - 1:
                if syms[i] == a and syms[i + 1] == b:
                    syms[i:i + 2] = [a + b]
                i += 1
    return merges


def write_qwen2_tokenizer(dst: str, merges=None, pair_merges: bool = False,
                          slow: bool = False) -> str:
    """A tokenizer.json and tokenizer_config.json in Qwen2.5-VL's layout in
    ``dst``: the byte alphabet in GPT-2's order, the results of ``merges``
    (:func:`learn_merges` when None), then unreachable two-character tokens
    of CJK characters (outside the byte alphabet) and their merges up to the
    published file's 151 643 ids and about its merge count, then the 22 added
    tokens at 151 643-151 664. Merges are written as "a b" strings, or as
    [a, b] pairs with ``pair_merges``. With ``slow`` the same tokenizer is
    written as vocab.json + merges.txt (after its ``#version`` line) +
    tokenizer_config.json instead, the layout of ``save_pretrained(
    legacy_format=True)`` without tokenizer.json. Returns the path of
    tokenizer.json (of vocab.json with ``slow``)."""
    from qwen_image_edit_streamdiffusion_tpu_torch.models.tokenizer import (
        BYTE_CHARS,
        QWEN2_PATTERN,
    )

    merges = list(learn_merges() if merges is None else merges)
    vocab = {ch: i for i, ch in enumerate(sorted(BYTE_CHARS.values()))}
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    base = [chr(0x4E00 + i) for i in range(400)]
    for ch in base:
        vocab[ch] = len(vocab)
    for a in base:
        for b in base:
            if len(vocab) == QWEN2_BASE_VOCAB:
                break
            vocab[a + b] = len(vocab)
            merges.append((a, b))
    if len(vocab) != QWEN2_BASE_VOCAB:
        raise AssertionError(f"tokenizer vocabulary of {len(vocab)}, not {QWEN2_BASE_VOCAB}")
    added = [{"id": QWEN2_BASE_VOCAB + i, "content": t, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": special}
             for i, (t, special) in enumerate(QWEN2_VL_ADDED)]
    byte_level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
                  "use_regex": False}
    spec = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN2_PATTERN}, "behavior": "Isolated",
             "invert": False}, byte_level]},
        "post_processor": byte_level, "decoder": byte_level,
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "",
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab,
                  "merges": [[a, b] if pair_merges else f"{a} {b}" for a, b in merges]},
    }
    config = {
        "add_prefix_space": False, "bos_token": None, "eos_token": "<|im_end|>",
        "pad_token": "<|endoftext|>", "unk_token": None, "errors": "replace",
        "clean_up_tokenization_spaces": False, "split_special_tokens": False,
        "model_max_length": 131072, "tokenizer_class": "Qwen2Tokenizer",
        "additional_special_tokens": [t for t, special in QWEN2_VL_ADDED[1:] if special],
        "added_tokens_decoder": {str(a["id"]): {k: a[k] for k in (
            "content", "lstrip", "normalized", "rstrip", "single_word", "special")}
            for a in added},
    }
    os.makedirs(dst, exist_ok=True)
    with open(os.path.join(dst, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump(config, f, ensure_ascii=False, indent=1)
    if slow:
        path = os.path.join(dst, "vocab.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(vocab, f, ensure_ascii=False)
        with open(os.path.join(dst, "merges.txt"), "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
        return path
    path = os.path.join(dst, "tokenizer.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    return path


# PROMPT's ids under the file write_qwen2_tokenizer() writes by default
# (held against transformers' Qwen2TokenizerFast in the CPU tests)
TOKENIZER_PROMPT_IDS = (426, 377, 307, 327, 378, 379, 520)
TOKENIZER_DIR = os.path.join(ROOT, "build", "chip_smoke", "tokenizer")
TOKENIZER_SLOW_DIR = os.path.join(ROOT, "build", "chip_smoke", "tokenizer_slow")
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "codec")
PROGRESSIVE_UPLOAD = "prog_512_420.jpg"  # the /edit uploads of phases serve and checkpoint
WEBP_UPLOAD = "lossy_1024.webp"          # phase serve's lossy WebP /edit
DECODE_REPS = 10
DECODE_SIZE = 1024


def cmyk_jpeg(planes, transform: int = 0, quality: int = 90) -> bytes:
    """A 4-component baseline JPEG written with the port's own encoder, no
    Pillow: each of the four (H, W) uint8 ``planes`` encoded as a gray
    JPEG, whose scan becomes one non-interleaved scan of a 4-component
    frame (1x1 sampling, the same tables), behind an Adobe APP14 marker with
    ``transform`` 0 (CMYK) or 2 (YCCK)."""
    import struct

    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

    def segments(data: bytes):
        pos, out = 2, []
        while True:
            marker = data[pos + 1]
            if marker == 0xD9:
                return out
            (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
            body = data[pos + 4:pos + 2 + n]
            if marker == 0xDA:
                end = data.index(b"\xff\xd9", pos + 2 + n)
                out.append((marker, body, data[pos + 2 + n:end]))
                pos = end
            else:
                out.append((marker, body, b""))
                pos += 2 + n

    def seg(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    grays = [segments(codec.encode_jpeg(p, quality)) for p in planes]
    tables = b"".join(seg(m, b) for m, b, _ in grays[0] if m in (0xDB, 0xC4))
    _, h, w, _ = struct.unpack(">BHHB", next(b for m, b, _ in grays[0] if m == 0xC0)[:6])
    sof = struct.pack(">BHHB", 8, h, w, 4) + b"".join(bytes([k, 0x11, 0]) for k in range(1, 5))
    out = (b"\xff\xd8" + seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([transform]))
           + tables + seg(0xC0, sof))
    for k, g in enumerate(grays):
        scan = next(d for m, _, d in g if m == 0xDA)
        out += seg(0xDA, bytes([1, k + 1, 0x00, 0, 63, 0])) + scan
    return out + b"\xff\xd9"


def cmyk_rgb(c, m, y, k):
    """Pillow's reading of CMYK samples as RGB: inverted ("CMYK;I"), then
    convert("RGB")'s cmyk2rgb."""
    import numpy as np

    nk = k.astype(np.int32)

    def muldiv255(a):
        t = (255 - a.astype(np.int32)) * nk + 128
        return ((t >> 8) + t) >> 8
    return np.clip(np.stack([nk - muldiv255(p) for p in (c, m, y)], -1), 0, 255).astype(np.uint8)


# decode-set rows that are committed fixtures, each held to its manifest's
# SHA-256 of Pillow's pixels: the lossless 1024² AVIF (2x2 tiles; the card's
# host has no AV1 encoder to write one)
FIXTURE_ROWS = {"avif_lossless": "avif_1024.avif"}


def decode_set():
    """{name: (bytes, want)}: a 1024² image in each format the codec gained,
    ``want`` the RGB it must decode to where this host can tell without
    Pillow, else its shape where that is not 1024² (None for the committed
    WebP, arithmetic-coded JPEG and lossless AVIF files, whose hashes phase
    inputs checks, and for the cut progressive JPEG).
    BMP, GIF, TIFF, the lossless JPEG and the 4-component JPEGs are written
    here: the writers of ``scripts/codec_fixtures.py`` and
    :func:`cmyk_jpeg`. A lossless coding is held to its source; the
    JPEG-in-TIFF file to the port's decode of each strip's JPEG alone."""
    import sys

    import numpy as np

    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from codec_fixtures import (bmp_file, cut_progressive, gif_file, lossless_jpeg, pcx_file,
                                ppm_file, psd_file, qoi_file, scene, sgi_file, tga_file,
                                tiff_file)

    n = DECODE_SIZE
    rgb = scene(n, n, 1)
    planes = [rgb[..., 0], rgb[..., 1], rgb[..., 2], scene(n, n, 2)[..., 0] // 4]
    cmyk = cmyk_jpeg(planes)
    gray = [codec.decode(codec.encode_jpeg(p, 90))[..., 0] for p in planes]
    idx = ((rgb[..., 0] >> 5).astype(np.int64) * 8 + (rgb[..., 1] >> 5)) * 4 + (rgb[..., 2] >> 6)
    pal = np.random.default_rng(3).integers(0, 256, (256, 3)).astype(np.uint8)
    runs = idx.copy()
    runs[:, ::2] = runs[:, 1::2]  # pairs for RLE8
    base = fixture("base_1024.jpg")
    app0 = base.index(b"\xff\xe0")
    rgb_coded = (base[:app0] + b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
                 + base[app0 + 2 + int.from_bytes(base[app0 + 2:app0 + 4], "big"):])
    rows = 64  # TIFF strip rows
    bw = (rgb[..., 0] > 128).astype(np.uint8)
    strips = [codec.encode_jpeg(np.ascontiguousarray(rgb[y:y + rows]), 90)
              for y in range(0, n, rows)]
    jpeg_tiff = tiff_file(rgb, 6, 8, compression=7, rows_per_strip=rows,
                          ycbcr_subsampling=(2, 2),
                          jpeg=lambda block: codec.encode_jpeg(np.ascontiguousarray(block), 90))
    return {
        "tiff_lzw_predictor": (tiff_file(rgb, 2, 8, compression=5, predictor=2,
                                         rows_per_strip=rows), rgb),
        "tiff_deflate": (tiff_file(rgb, 2, 8, compression=8, rows_per_strip=rows), rgb),
        "tiff_packbits": (tiff_file(pal[runs], 2, 8, compression=32773, rows_per_strip=rows),
                          pal[runs]),
        "tiff_tiled_lzw": (tiff_file(rgb, 2, 8, compression=5, tile=(256, 256)), rgb),
        "tiff_planar_deflate": (tiff_file(rgb, 2, 8, compression=8, planar=2,
                                          rows_per_strip=rows), rgb),
        "tiff_g4": (tiff_file(bw, 0, 1, compression=4),
                    np.repeat((bw == 0)[..., None].astype(np.uint8) * 255, 3, axis=2)),
        "tiff_jpeg_ycbcr": (jpeg_tiff, np.concatenate([codec.decode(j) for j in strips])),
        "jpeg_arithmetic": (fixture("arith_1024.jpg"), None),
        "jpeg_arithmetic_progressive": (fixture("arith_prog_1024.jpg"), None),
        "jpeg_lossless": (lossless_jpeg(rgb, predictor=1), rgb),
        "jpeg_block_smoothed": (cut_progressive(fixture("prog_1024.jpg"), 3), None),
        "cmyk_jpeg": (cmyk, cmyk_rgb(*gray)),
        "ycck_jpeg": (cmyk[:cmyk.index(b"Adobe") + 11] + b"\x02"
                      + cmyk[cmyk.index(b"Adobe") + 12:], None),
        "rgb_coded_jpeg": (rgb_coded, None),
        "bmp24": (bmp_file(rgb, 24), rgb),
        "bmp_rle8": (bmp_file(runs, 8, palette=pal, compression=1), pal[runs]),
        "gif": (gif_file(idx, pal), pal[idx]),
        "webp_lossy": (fixture("lossy_1024.webp"), None),
        "webp_lossless": (fixture("lossless_1024.webp"), None),
        "ppm": (ppm_file(rgb), rgb),
        "tga_rle": (tga_file(rgb, 10, 24, flags=0), rgb),
        "psd_rle": (psd_file(rgb.transpose(2, 0, 1), 3), rgb),
        "qoi": (qoi_file(rgb), rgb),
        "pcx": (pcx_file(rgb, 8, 3), rgb),
        "sgi_rle": (sgi_file(rgb), rgb),
        **small_decode_set(n, rgb),
        **jpeg2000_decode_set(),
        **rare_decode_set(n, rgb),
        **lab_decode_set(n, rgb),
        **{row: (fixture(name), None) for row, name in FIXTURE_ROWS.items()},
    }


def jpeg2000_decode_set():
    """{name: (bytes, want)}: the committed 1024² JPEG 2000 pair (Pillow wrote
    them; this host has none): the smooth scene as a 5/3 JP2, held to its
    source, and the baseline JPEG's textured scene as a 9/7 codestream at
    rate 40, whose pixels the manifest's hash holds."""
    import sys

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from codec_fixtures import smooth_scene

    return {"jpeg2000_53": (fixture("rev53_1024.jp2"), smooth_scene(1024)),
            "jpeg2000_97": (fixture("irr97_1024.j2k"), None)}


def small_decode_set(n: int, rgb=None):
    """{name: (bytes, want)}: an ``n``² image in each format of the small
    decoders and ZSTD TIFF, written without Pillow (``scripts/
    codec_fixtures.py``'s writers; ZSTD strips through the system's
    libzstd): each held to its source but the BC1 and BC7 surfaces (lossy:
    their pixels are held by the committed fixtures' hashes). An ICNS it32
    member is 128² whatever ``n``: its size is its type's. ``rgb``: the
    decode set's ``n``² source, made here where not given."""
    import sys

    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from codec_fixtures import (bc1_blocks, bc7_blocks, dds_file, icns_file, icns_rle24,
                                msp_file, scene, sun_file, tiff_file, xbm_file, xpm_file)

    rgb = scene(n, n, 1) if rgb is None else rgb
    idx = ((rgb[..., 0] >> 5).astype(np.int64) * 8 + (rgb[..., 1] >> 5)) * 4 + (rgb[..., 2] >> 6)
    pal = np.random.default_rng(3).integers(0, 256, (256, 3)).astype(np.uint8)
    bits = rgb[..., 0] > 128
    white = np.repeat(bits[..., None].astype(np.uint8) * 255, 3, axis=2)
    icon = scene(128, 128, 2) // 8 * 8  # runs for RLE24
    bgrx = np.concatenate([rgb[..., ::-1], np.full((n, n, 1), 255, np.uint8)], -1)
    return {
        "tiff_zstd_predictor": (tiff_file(rgb, 2, 8, compression=50000, predictor=2,
                                          rows_per_strip=64), rgb),
        "sun_rle": (sun_file(rgb, 24, 2), rgb),
        "msp_v2": (msp_file(bits), white),
        "xbm": (xbm_file(bits), white),
        "xpm": (xpm_file(idx, pal), pal[idx]),
        "icns_it32": (icns_file([(b"it32", bytes(4) + icns_rle24(icon)),
                                 (b"t8mk", bytes(128 * 128))]), icon),
        "dds_rgb": (dds_file(n, n, bgrx.tobytes(), 0x41, bitcount=32,
                             masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)), rgb),
        "dds_rgb24": (dds_file(n, n, rgb[..., ::-1].tobytes(), 0x40, bitcount=24,
                               masks=(0xFF0000, 0xFF00, 0xFF, 0)), rgb),
        "dds_bc1": (dds_file(n, n, bc1_blocks(rgb), 0x4, b"DXT1"), None),
        "dds_bc7": (dds_file(n, n, bc7_blocks(rgb), 0x4, dxgi=98), None),
    }


def rare_decode_set(n: int, rgb=None):
    """{name: (bytes, want)}: an ``n``² image in each of the rare formats
    Pillow decodes, written without Pillow (``scripts/codec_fixtures.py``'s
    writers): ``want`` its source where the coding is lossless (IM, the
    palettes of BLP2 and FLI, FITS raw and GZIP_1, GIMP brush, IM Tools,
    IPTC, McIdas, Pixar, SPIDER, XV), else its shape (BLP2 DXT1, BLP1 JPEG,
    FTEX DXT1; PhotoCD's fixed 768 x 512 base image). An XV thumbnail is 80
    x 60, the largest xv writes. ``rgb``: the decode set's ``n``² source,
    made here where not given."""
    import sys

    import numpy as np

    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from codec_fixtures import (bc1_blocks, blp_file, fits_file, fli_brun, fli_file, fli_frame,
                                fli_palette_chunk, ftex_file, gbr_file, im_file, imt_file,
                                iptc_file, mcidas_file, pcd_file, photo_ycc, pixar_file, scene,
                                spider_file, xv_indices, xv_palette, xvthumb_file)

    rgb = scene(n, n, 1) if rgb is None else rgb
    gray = np.ascontiguousarray(rgb[..., 1])
    gray3 = np.repeat(gray[..., None], 3, axis=2)
    idx, xv = xv_indices(rgb), xv_palette()
    thumb = np.ascontiguousarray(idx[:60, :80])
    jpeg = codec.encode_jpeg(rgb, 90)
    sos = jpeg.index(b"\xff\xda")
    bc1 = bc1_blocks(rgb)
    return {
        "im_rgb": (im_file(b"RGB", n, n, rgb[::-1].transpose(0, 2, 1).tobytes()), rgb),
        "blp2_palette": (blp_file(2, n, n, idx.astype(np.uint8).tobytes(), palette=xv),
                         xv[idx]),
        "blp2_dxt1": (blp_file(2, n, n, bc1, encoding=2), None),
        "blp1_jpeg": (blp_file(1, n, n, jpeg[sos:], compression=0, jpeg_header=jpeg[:sos]),
                      None),
        "fits_8": (fits_file(gray, 8), gray3),
        "fits_gzip": (fits_file(gray, 8, gzip_tile=True), gray3),
        "fli_brun": (fli_file([fli_frame(fli_palette_chunk(xv >> 2), fli_brun(idx))], n, n,
                              flc=False), (xv >> 2 << 2)[idx]),
        "ftex_dxt1": (ftex_file(n, n, bc1), None),
        "gbr_rgba": (gbr_file(np.concatenate([rgb, gray[..., None]], -1)), rgb),
        "imt": (imt_file(gray), gray3),
        "iptc_raw": (iptc_file(n, n, gray.tobytes()), gray3),
        "mcidas": (mcidas_file(gray), gray3),
        "pcd": (pcd_file(*photo_ycc(scene(512, 768, 2))), (512, 768, 3)),
        "pixar": (pixar_file(rgb), rgb),
        "spider": (spider_file(gray.astype(np.float32)), gray3),
        "xvthumb": (xvthumb_file(thumb), xv[thumb]),
    }


# SHA-256 of Pillow 12.1's RGB of each 1024² file of lab_decode_set (its
# CIELab through LittleCMS 2.17, BC6H through its bcn decoder), and of
# Pillow's RGB of all 2^24 Lab8 inputs (L, a + 128, b + 128 of i >> 16,
# i >> 8 & 255, i & 255) in order. The card's host has no Pillow: they are
# computed on a host that has it (tests/test_torch_codec_lab.py holds them to
# it)
LAB_DECODE_SHA256 = {
    "tiff_lab": "64d904aabda27252338d3821734107399dd83eec84bd67b65783c449b26178a1",
    "psd_lab": "97f6e5cafd7a6dd59eeac5f362c01e69af448819e972de969aac30692fca6b27",
    "dds_bc6h": "e6dcadf6279d11c75edce62d23f131020567f53cd8a4b006cbf5e0d1bb89b212",
    "dds_bc6hs": "759e6c1245aeaec5afa28b5a4eea77c3b08ccf02fa532f23be1bdf5922fb3fb4",
}
LAB_SWEEP_SHA256 = "f1ae0609778284fb45d7ac0f0ab7e164dae97539e23c975eef6fd284ccf16101"


def lab_decode_set(n: int, rgb=None):
    """{name: (bytes, None)}: an ``n``² CIELab TIFF (Adobe Deflate, horizontal
    differencing, 64-row strips, as prepress tools write one) and Lab PSD
    (PackBits rows, Photoshop's Lab mode), their samples the decode set's
    source taken as L, a and b, and DDS surfaces of BC6H_UF16 and BC6H_SF16
    blocks of the source, written without Pillow (``scripts/
    codec_fixtures.py``'s writers); at 1024² phase inputs holds each to
    :data:`LAB_DECODE_SHA256`. ``rgb``: the decode set's ``n``² source,
    made here where not given."""
    import sys

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from codec_fixtures import bc6h_blocks, dds_file, psd_file, scene, tiff_file

    rgb = scene(n, n, 1) if rgb is None else rgb
    return {
        "tiff_lab": (tiff_file(rgb, 8, 8, compression=32946, predictor=2, rows_per_strip=64),
                     None),
        "psd_lab": (psd_file(rgb.transpose(2, 0, 1), 9, compression=1), None),
        "dds_bc6h": (dds_file(n, n, bc6h_blocks(rgb), 0x4, dxgi=95), None),
        "dds_bc6hs": (dds_file(n, n, bc6h_blocks(rgb, signed=True), 0x4, dxgi=96), None),
    }


def lab_sweep():
    """(SHA-256, ms) of the port's RGB of all 2^24 Lab8 inputs in order,
    the conversion's tables built first."""
    import hashlib

    import numpy as np

    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

    i = np.arange(1 << 24, dtype=np.uint32)
    lab = np.stack([i >> 16, (i >> 8) & 255, i & 255], -1).astype(np.uint8)
    codec.lab_to_rgb(lab[:1])
    t0 = time.perf_counter()
    rgb = codec.lab_to_rgb(lab)
    ms = (time.perf_counter() - t0) * 1e3
    return hashlib.sha256(rgb.tobytes()).hexdigest(), ms


def blp_upload(rgb):
    """(bytes, source): a BLP2 texture of ``rgb`` in 256 colours (XV's
    3:3:2 palette), uncompressed indices, as a game's asset tools write one
    (``scripts/codec_fixtures.py``'s writer, no Pillow); the source it must
    decode to is the quantized image."""
    import sys

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from codec_fixtures import blp_file, xv_indices, xv_palette

    h, w = rgb.shape[:2]
    idx, palette = xv_indices(rgb), xv_palette()
    return blp_file(2, w, h, idx.astype("uint8").tobytes(), palette=palette), palette[idx]


def tiff_upload(rgb) -> bytes:
    """An RGB TIFF as a scanner or an image editor writes it: LZW with
    horizontal differencing, 64-row strips (``scripts/codec_fixtures.py``'s
    writer, no Pillow)."""
    import sys

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from codec_fixtures import tiff_file

    return tiff_file(rgb, 2, 8, compression=5, predictor=2, rows_per_strip=64)


def psd_upload(rgb) -> bytes:
    """An RGB PSD as Photoshop saves one: the merged image PackBits-coded
    row by row, after an image resource (``scripts/codec_fixtures.py``'s
    writer, no Pillow)."""
    import sys

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from codec_fixtures import psd_file, psd_resource

    return psd_file(rgb.transpose(2, 0, 1), 3, compression=1,
                    resources=psd_resource(1005, bytes(16)))


def fixture(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def fixture_b64(name: str) -> str:
    import base64

    return base64.b64encode(fixture(name)).decode()


def host_ms(fn, reps: int) -> float:
    """Median wall ms of ``fn`` on the host, after one call."""
    fn()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def phase_inputs() -> None:
    """The request's real inputs on the card's host, which has neither Pillow
    nor transformers: each committed codec fixture decoded to its manifest's
    shape and SHA-256 of Pillow's bytes; the decode ms of a 1024² progressive
    JPEG against the same image as baseline, and of a 1024² image in each
    format the codec gained (:func:`decode_set`; the CIELab and BC6H files
    held to :data:`LAB_DECODE_SHA256`, the lossless AVIF of
    :data:`FIXTURE_ROWS` to its manifest's); all 2^24 Lab8 inputs converted, their
    SHA-256 held to Pillow's (:data:`LAB_SWEEP_SHA256`: a compiler that
    rounds the conversion's arithmetic otherwise shows here); a full-size
    Qwen2-layout tokenizer.json written, its load ms and the ms of PROMPT's encode (cold,
    then cached) and of its chat template, PROMPT's ids as the CPU tests hold
    them; the same tokenizer as vocab.json + merges.txt, its load ms and
    ids, equal to the tokenizer.json form's."""
    import hashlib
    import shutil

    import numpy as np

    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec
    from qwen_image_edit_streamdiffusion_tpu_torch.models import qwen_vl

    codec.library()
    smi = nvidia_smi_line()
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    for name, entry in manifest.items():
        px = codec.decode(fixture(name))
        digest = hashlib.sha256(px.tobytes()).hexdigest()
        emit({"phase": "inputs_fixture", "name": name, "shape": list(px.shape),
              "equal": list(px.shape) == entry["shape"] and digest == entry["sha256"]})
        if list(px.shape) != entry["shape"] or digest != entry["sha256"]:
            raise AssertionError(f"{name}: decoded {px.shape} {digest}, manifest {entry}")
    prog, base = fixture("prog_1024.jpg"), fixture("base_1024.jpg")
    ms = {k: host_ms(lambda d=d: codec.decode(d), DECODE_REPS)
          for k, d in (("progressive", prog), ("baseline", base))}
    emit({"phase": "inputs_decode", "size": 1024, "quality": 90,
          "progressive_ms": ms["progressive"], "baseline_ms": ms["baseline"],
          "progressive_over_baseline": ms["progressive"] / ms["baseline"],
          "bytes": {"progressive": len(prog), "baseline": len(base)}, "nvidia_smi": smi})
    t0 = time.perf_counter()
    formats = decode_set()
    write_s = time.perf_counter() - t0
    rows = {}
    for name, (data, want) in formats.items():
        px = codec.decode(data)
        source = isinstance(want, np.ndarray)
        shape = want.shape if source else want or (DECODE_SIZE, DECODE_SIZE, 3)
        if px.shape != tuple(shape) or (source and not np.array_equal(px, want)):
            raise AssertionError(f"{name}: decoded {px.shape}, not its source")
        pinned = LAB_DECODE_SHA256.get(name) if DECODE_SIZE == 1024 else None
        if name in FIXTURE_ROWS:
            pinned = manifest[FIXTURE_ROWS[name]]["sha256"]
        if pinned and hashlib.sha256(px.tobytes()).hexdigest() != pinned:
            raise AssertionError(f"{name}: decoded to other pixels than Pillow's")
        rows[name] = {"ms": host_ms(lambda d=data: codec.decode(d), DECODE_REPS),
                      "bytes": len(data), "held_to_source": source,
                      "held_to_pillow_sha256": bool(pinned)}
        rows[name]["over_baseline"] = rows[name]["ms"] / ms["baseline"]
    emit({"phase": "inputs_decode_formats", "size": DECODE_SIZE, "baseline_jpeg_ms":
          ms["baseline"], "formats": rows, "write_s": write_s, "nvidia_smi": smi})
    digest, sweep_ms = lab_sweep()
    emit({"phase": "inputs_lab_sweep", "inputs": 1 << 24, "ms": sweep_ms, "sha256": digest,
          "equal_to_pillow": digest == LAB_SWEEP_SHA256, "nvidia_smi": smi})
    if digest != LAB_SWEEP_SHA256:
        raise AssertionError("Lab8 -> sRGB: the 2^24 inputs convert to other bytes than Pillow's")

    t0 = time.perf_counter()
    path = write_qwen2_tokenizer(TOKENIZER_DIR)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tok = qwen_vl.load_hf_tokenizer(TOKENIZER_DIR)
    load_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ids = tok.encode(PROMPT)
    cold_ms = (time.perf_counter() - t0) * 1e3
    warm_ms = host_ms(lambda: tok.encode(PROMPT), 20)
    template_ms = host_ms(lambda: qwen_vl.build_chat_ids(tok, PROMPT, [196]), 20)
    chat = qwen_vl.build_chat_ids(tok, PROMPT, [196])[0]
    emit({"phase": "inputs_tokenizer", "file_bytes": os.path.getsize(path),
          "ids": len(tok), "merges": len(tok.ranks), "write_s": write_s, "load_ms": load_ms,
          "prompt_encode_cold_ms": cold_ms, "prompt_encode_cached_ms": warm_ms,
          "chat_template_ms": template_ms, "prompt_ids": ids, "template_ids": len(chat),
          "nvidia_smi": smi})
    if tuple(ids) != TOKENIZER_PROMPT_IDS or len(tok) != 151665 or any(
            tok.added[t] != i for t, i in qwen_vl._SPECIAL_IDS.items()):
        raise AssertionError(f"tokenizer: PROMPT ids {ids}, {len(tok)} ids")

    # the same tokenizer as the slow files alone
    shutil.rmtree(TOKENIZER_SLOW_DIR, ignore_errors=True)
    write_qwen2_tokenizer(TOKENIZER_SLOW_DIR, slow=True)
    t0 = time.perf_counter()
    slow = qwen_vl.load_hf_tokenizer(TOKENIZER_SLOW_DIR)
    slow_ms = (time.perf_counter() - t0) * 1e3
    slow_ids = slow.encode(PROMPT)
    slow_chat = qwen_vl.build_chat_ids(slow, PROMPT, [196])[0]
    emit({"phase": "inputs_tokenizer_slow", "files": sorted(os.listdir(TOKENIZER_SLOW_DIR)),
          "bytes": dir_bytes(TOKENIZER_SLOW_DIR), "ids": len(slow),
          "merges": len(slow.ranks), "load_ms": slow_ms,
          "json_load_ms": load_ms, "prompt_ids": slow_ids,
          "equal_to_json_form": slow_ids == ids and slow_chat == chat, "nvidia_smi": smi})
    if slow_ids != ids or slow_chat != chat or len(slow) != len(tok) or slow.added != tok.added:
        raise AssertionError(f"vocab.json + merges.txt: PROMPT ids {slow_ids}, {len(slow)} ids")


class ChatIds:
    """Records the ids every ``qwen_vl.build_chat_ids`` call returns (the
    encoder looks the function up at each call, on any thread)."""

    def __enter__(self):
        from qwen_image_edit_streamdiffusion_tpu_torch.models import qwen_vl

        self.mod, self.real, self.calls = qwen_vl, qwen_vl.build_chat_ids, []

        def spy(tok, prompt, merged, drop_idx=None):
            out = self.real(tok, prompt, merged, drop_idx)
            self.calls.append((prompt, list(merged), out[0]))
            return out

        qwen_vl.build_chat_ids = spy
        return self

    def __exit__(self, *exc):
        self.mod.build_chat_ids = self.real

    def check(self, label: str, tok, vocab: int) -> None:
        """Each call's ids are ``tok``'s for its template, not the hashed
        fallback's."""
        emit({"phase": "chat_ids", "path": label, "calls": [
            {"prompt": p, "merged": m, "ids": len(ids), "first": ids[:8]}
            for p, m, ids in self.calls]})
        if not self.calls:
            raise AssertionError(f"{label}: no prompt was encoded")
        for prompt, merged, ids in self.calls:
            if ids != self.real(tok, prompt, merged)[0] or ids == self.real(
                    self.mod.SimpleTokenizer(vocab), prompt, merged)[0]:
                raise AssertionError(f"{label}: {prompt!r} was not encoded by the "
                                     f"checkpoint's tokenizer")


def phase_checkpoint() -> dict:
    """Real-checkpoint serving at flagship width: a depth-cut tree made on
    the card from a seed, written in the HF layout (bf16, sharded with index
    jsons), converted by the port's CLI in process (bf16; fused q/k/v +
    int8; VAE; VL), loaded by ``InferenceEngine.create`` from the converted
    checkpoints just written (seconds, GB/s, card peak and the host's peak
    RSS growth, which must stay under the largest shard + 1 GiB) and
    served: /edit miss and hit with K1/K2/K3 at the cut depths' counts, and
    a miss of the committed progressive JPEG whose prompt the checkpoint's
    tokenizer (vocab.json + merges.txt, written in the HF tree's sibling
    tokenizer/, copied by the VL conversion) encodes, as its tokenizer.json
    form does; every loaded tensor and the latents of one miss
    equal the in-memory tree's; the int8 checkpoint likewise, K5/K6 once per quantized linear
    it runs; the server's CLI serves the converted tree; the full
    flagship's boot time extrapolated. The tree is removed however the
    phase ends."""
    import shutil

    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec
    from qwen_image_edit_streamdiffusion_tpu_torch.core.config import StreamConfig
    from qwen_image_edit_streamdiffusion_tpu_torch.core.rng import stream
    from qwen_image_edit_streamdiffusion_tpu_torch.models import checkpoint, lora, quantize
    from qwen_image_edit_streamdiffusion_tpu_torch.models import convert as cv
    from qwen_image_edit_streamdiffusion_tpu_torch.models import qwen_vl
    from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm
    from qwen_image_edit_streamdiffusion_tpu_torch.models import vae
    from qwen_image_edit_streamdiffusion_tpu_torch.models.common import flatten, unflatten
    from qwen_image_edit_streamdiffusion_tpu_torch.models.optimize import fuse_qkv
    from qwen_image_edit_streamdiffusion_tpu_torch.models.tokenizer import Tokenizer
    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.edit_pipeline import EditPipeline
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime.engine import InferenceEngine

    cut = cut_preset()
    layers, lm_layers = cut.model.num_layers, cut.vl.num_layers
    work = os.path.join(ROOT, "build", "chip_smoke", "checkpoint")
    dev = torch.device("cuda")
    gen = lambda name: stream(11, name, dev)  # noqa: E731
    tfm_mem = tfm.init(gen("transformer"), cut.model, dev)
    vae_mem = vae.init(gen("vae"), cut.vae, dev)
    vl_mem = qwen_vl.init(gen("vl"), cut.vl, dev)
    tree_bytes = sum(t.numel() * t.element_size()
                     for tree in (tfm_mem, vae_mem, vl_mem) for t in flatten(tree).values())
    os.makedirs(work, exist_ok=True)
    free = shutil.disk_usage(work).free
    need = int(2.5 * tree_bytes) + (2 << 30)  # HF tree, bf16 and int8 conversions
    emit({"phase": "checkpoint_disk", "free_bytes": free, "need_bytes": need,
          "tree_bytes": tree_bytes})
    if free < need:
        raise AssertionError(f"checkpoint phase: {free} bytes free under {work}, needs {need}")
    kernels.reset_launches()
    try:
        # 1. the HF-layout tree, bf16
        hf = {c: os.path.join(work, "hf", c) for c in ("transformer", "vae", "vl")}
        t0 = time.time()
        lora.save_safetensors(hf["transformer"], cv.export_transformer(tfm_mem, cut.model),
                              max_shard_bytes=HF_SHARD_BYTES, basename="diffusion_pytorch_model")
        lora.save_safetensors(hf["vl"], cv.export_vl(vl_mem, cut.vl),
                              max_shard_bytes=HF_SHARD_BYTES, basename="model")
        # the tokenizer as vocab.json + merges.txt only, in the diffusers
        # layout's sibling tokenizer/ (the conversion finds and copies it)
        tok_src = os.path.join(work, "hf", "tokenizer")
        write_qwen2_tokenizer(tok_src, slow=True)
        os.makedirs(hf["vae"])
        lora.save_safetensors(os.path.join(hf["vae"], "diffusion_pytorch_model.safetensors"),
                              cv.export_vae(vae_mem, cut.vae))
        shards = {c: len(cv.shard_files(d)) for c, d in hf.items()}
        straddle = straddling_qkv(os.path.join(
            hf["transformer"], "diffusion_pytorch_model.safetensors.index.json"), layers)
        emit({"phase": "checkpoint_hf_tree", "seconds": time.time() - t0, "shards": shards,
              "bytes": {c: dir_bytes(d) for c, d in hf.items()}, "qkv_straddling": straddle})
        if shards["transformer"] < 3 or shards["vl"] < 3 or not straddle:
            raise AssertionError(f"HF tree: shards {shards}, straddling q/k/v {straddle}")

        # 2. the port's CLI, in process, on the card
        out = {n: os.path.join(work, "port", n)
               for n in ("transformer", "transformer_int8_fq", "vae", "vl")}
        runs = (("transformer", "transformer", []),
                ("transformer_int8_fq", "transformer", ["--fuse-qkv", "--quantize", "int8"]),
                ("vae", "vae", []), ("vl", "vl", []))
        for name, comp, extra in runs:
            t0 = time.time()
            checkpoint.main(["convert", "--src", hf[comp], "--component", comp, "--preset",
                             CUT_PRESET, "--out", out[name], "--device", "cuda", *extra])
            torch.cuda.synchronize()
            emit({"phase": "checkpoint_convert", "name": name, "seconds": time.time() - t0,
                  "gb_on_disk": dir_bytes(out[name]) / 1e9,
                  "layout": checkpoint.layout(out[name])})
        bf16_dirs = (out["transformer"], out["vae"], out["vl"])
        largest_shard = max(os.path.getsize(f) for d in bf16_dirs for f in cv.shard_files(d))
        copied = sorted(os.listdir(tok_src))
        for name in copied:
            with open(os.path.join(tok_src, name), "rb") as a, \
                    open(os.path.join(out["vl"], name), "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"convert --component vl did not copy {name}")
        if os.path.exists(os.path.join(out["vl"], "tokenizer.json")) or \
                "merges.txt" not in copied:
            raise AssertionError(f"the VL checkpoint's tokenizer files: {copied}")
        t0 = time.perf_counter()
        qwen_vl.load_hf_tokenizer(out["vl"])
        tok_s = time.perf_counter() - t0  # a part of each load below, whatever its bytes
        emit({"phase": "checkpoint_tokenizer", "copied": copied, "load_ms": tok_s * 1e3})

        # 3. load the bf16 rung through the engine (the files were just
        # written: the page cache may hold them)
        config = StreamConfig(width=SIZE, height=SIZE, num_inference_steps=STEPS,
                              cfg_mode="none", model_preset=CUT_PRESET)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_alloc = torch.cuda.memory_allocated()
        with RssPeak() as rss:
            t0 = time.time()
            engine = InferenceEngine.create(CUT_PRESET, config=config, warmup_runs=0,
                                            input_size=SERVE_INPUT,
                                            transformer_path=out["transformer"],
                                            vae_path=out["vae"], vl_path=out["vl"], device="cuda")
            torch.cuda.synchronize()
            load_s = time.time() - t0
        growth = rss.growth
        loaded_bytes = sum(dir_bytes(d) for d in bf16_dirs)
        gbps = loaded_bytes / (load_s - tok_s) / 1e9  # the weights' rate
        smi = nvidia_smi_line()
        emit({"phase": "checkpoint_load", "rung": "bf16", "seconds": load_s,
              "tokenizer_s": tok_s, "bytes": loaded_bytes, "gb_per_s": gbps,
              "card_peak_bytes": torch.cuda.max_memory_allocated() - base_alloc,
              "host_rss_growth_bytes": growth, "host_rss_before_bytes": rss.base,
              "rss_samples": rss.samples, "largest_shard_bytes": largest_shard,
              "nvidia_smi": smi})
        if growth >= largest_shard + (1 << 30):
            raise AssertionError(f"loading grew the host's RSS by {growth} bytes, over the "
                                 f"largest shard ({largest_shard}) + 1 GiB")

        # 4. every loaded tensor equals the in-memory one (q/k/v fused as
        # the engine's config fuses them)
        fused_mem = fuse_qkv(unflatten(flatten(tfm_mem)))
        pipe = engine.pipeline
        if not isinstance(pipe.encoder.tokenizer, Tokenizer):
            raise AssertionError(f"the engine's tokenizer is {type(pipe.encoder.tokenizer)}")
        n = (assert_equal_trees("transformer", pipe.tfm_params, fused_mem)
             + assert_equal_trees("vae", pipe.vae_params, vae_mem)
             + assert_equal_trees("vl", pipe.encoder.params, vl_mem))
        del fused_mem
        srv, url = start_server(engine)
        b64 = codec.to_base64_jpeg(distinct_image(7100, SERVE_INPUT))
        want = expected(True, k1=layers * STEPS, k2=lm_layers)
        try:
            served(url, "checkpoint bf16", "edit_miss", {"image": b64, "prompt": PROMPT}, want)
            served(url, "checkpoint bf16", "edit_hit", {"image": b64, "prompt": PROMPT},
                   expected(False, k1=layers * STEPS, k2=lm_layers))
            # a progressive upload, its prompt encoded by the checkpoint's file
            with ChatIds() as chat:
                served(url, "checkpoint bf16", "edit_progressive_miss",
                       {"image": fixture_b64(PROGRESSIVE_UPLOAD), "prompt": PROMPT},
                       expected(True, k1=layers * STEPS, k2=lm_layers))
            chat.check("checkpoint bf16", Tokenizer.from_dir(out["vl"]), cut.vl.vocab_size)
            # the slow files' ids are the tokenizer.json form's
            chat.check("checkpoint bf16, tokenizer.json form", Tokenizer.from_dir(TOKENIZER_DIR),
                       cut.vl.vocab_size)
        finally:
            stop_server(srv)
        mem_pipe = EditPipeline.from_weights(cut, config, tfm_mem, vae_mem, vl_mem, dev)
        mem_pipe.encoder.tokenizer = pipe.encoder.tokenizer
        same_latents("bf16", pipe, mem_pipe, distinct_image(7101))
        emit({"phase": "checkpoint_equal", "rung": "bf16", "leaves": n})
        del engine, pipe, mem_pipe
        gc.collect()
        torch.cuda.empty_cache()

        # 5. the pre-quantized fused-q/k/v int8 rung: its codes and scales
        # are in-place quantize of the in-memory tree (fused by from_weights)
        quantize.quantize_transformer(tfm_mem, bits=8)
        config8 = config.replace(use_int8=True)
        t0 = time.time()
        engine = InferenceEngine.create(CUT_PRESET, config=config8, warmup_runs=0,
                                        input_size=SERVE_INPUT,
                                        transformer_path=out["transformer_int8_fq"],
                                        vae_path=out["vae"], vl_path=out["vl"], device="cuda")
        torch.cuda.synchronize()
        emit({"phase": "checkpoint_load", "rung": "int8, fused q/k/v",
              "seconds": time.time() - t0,
              "bytes": dir_bytes(out["transformer_int8_fq"])})
        pipe = engine.pipeline
        assert_equal_trees("transformer int8", pipe.tfm_params, tfm_mem)
        # K5/K6 once per quantized linear a forward runs: per block the two
        # fused q/k/v, two outputs, four MLP and two modulation linears
        per_block = [sum(k.endswith(".w_q") for k in flatten(b)) for b in pipe.tfm_params["blocks"]]
        if per_block != [10] * layers:
            raise AssertionError(f"quantized linears a block: {per_block}, not 10")
        srv, url = start_server(engine)
        try:
            served(url, "checkpoint int8", "edit_miss",
                   {"image": codec.to_base64_jpeg(distinct_image(7200, SERVE_INPUT)),
                    "prompt": PROMPT},
                   expected(True, k1=layers * STEPS, k2=lm_layers,
                            int8_per_request=sum(per_block) * STEPS))
        finally:
            stop_server(srv)
        mem_pipe = EditPipeline.from_weights(cut, config8, tfm_mem, vae_mem, vl_mem, dev)
        mem_pipe.encoder.tokenizer = pipe.encoder.tokenizer
        same_latents("int8", pipe, mem_pipe, distinct_image(7201))
        launches = dict(kernels.LAUNCHES)
        del engine, pipe, mem_pipe, tfm_mem, vae_mem, vl_mem
        gc.collect()
        torch.cuda.empty_cache()

        # 6. the server's CLI on the converted bf16 tree
        serve_cli("checkpoint_serve_cli", ("--preset", CUT_PRESET, "--transformer",
                                           out["transformer"], "--vae", out["vae"],
                                           "--vl", out["vl"]), prelude=REGISTER_CUT)

        # 7. the full flagship's boot, extrapolated from this load's rate
        full_bytes = flagship_weight_bytes()
        emit({"phase": "checkpoint_boot_extrapolated", "flagship_bf16_bytes": full_bytes,
              "gb_per_s": gbps, "extrapolated_boot_s": full_bytes / (gbps * 1e9) + tok_s,
              "nvidia_smi": smi})
    finally:
        shutil.rmtree(work, ignore_errors=False)
    return launches

# ---------------------------------------------------------------------------
# Phases 8b and 8c: worlds of ranks sharing the card through gloo
# ---------------------------------------------------------------------------


class Capture:
    """A pipeline whose ``__call__`` results are kept (the latents of a
    request served through the engine)."""

    def __init__(self, pipe):
        self.pipe, self.results = pipe, []

    def __call__(self, *args, **kwargs):
        self.results.append(self.pipe(*args, **kwargs))
        return self.results[-1]

    def __getattr__(self, name):
        return getattr(self.pipe, name)


def tp_edit_payload() -> dict:
    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

    return {"image": codec.to_base64_jpeg(distinct_image(TP_IMAGES["edit"], SERVE_INPUT)),
            "prompt": PROMPT, "seed": 42}


def tp_calls(pipe) -> dict:
    """The requests of phase 8b that are held to the one-process pipeline,
    as calls on ``pipe``: name → (call, launches, rows)."""
    img = lambda name: distinct_image(TP_IMAGES[name])  # noqa: E731

    def plain(*imgs):
        return lambda: pipe(list(imgs) if len(imgs) > 1 else imgs[0], PROMPT,
                            num_inference_steps=STEPS, seed=42)

    return {"miss_a": (plain(img("miss_a")), expected(True, k1=K1_TP), None),
            "hit_a": (plain(img("miss_a")), expected(False, k1=K1_TP), None),
            "guided": (guided(pipe, "batched", img("guided")), expected(True, k1=K1_TP),
                       k1_rows(2, K1_TP)),
            "two": (plain(*(distinct_image(i) for i in TP_IMAGES["two"])),
                    expected(True, 2, k1=K1_TP), None)}


def tp_references() -> dict:
    """Phase 8b's requests on one-process pipelines of TP_PRESET: their
    latents kept on the host (the /edit's through an engine with the
    server's input size); then the int8 rung's miss."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.edit_pipeline import (
        EditPipeline,
    )
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime.engine import InferenceEngine

    tp_preset()
    refs = {}
    pipe = EditPipeline.create(TP_PRESET, tp_config(), seed=0, device=RANK_DEVICE)
    for name, (call, _, _) in tp_calls(pipe).items():
        refs[name] = call().latents.float().cpu()
    pipe.config = pipe.config.replace(cfg_mode="none")
    cap = Capture(pipe)
    InferenceEngine(pipeline=cap, input_size=SERVE_INPUT, default_steps=STEPS).edit(
        tp_edit_payload())
    refs["edit"] = cap.results[0].latents.float().cpu()
    del pipe, cap
    gc.collect()
    torch.cuda.empty_cache()
    pipe = EditPipeline.create(TP_PRESET, tp_config().replace(use_int8=True, use_int8_vl=True),
                               seed=0, device=RANK_DEVICE)
    refs["int8"] = pipe(distinct_image(TP_IMAGES["int8"]), PROMPT, num_inference_steps=STEPS,
                        seed=42).latents.float().cpu()
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return refs


def rel_l2(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).norm() / b.norm())


def held(label: str, name: str, latents, ref) -> float:
    err = rel_l2(latents, ref)
    emit({"phase": "tp_parity", "path": label, "name": name, "rel_l2": err, "tol": TP_TOL})
    if not err <= TP_TOL:
        raise AssertionError(f"{label}/{name}: rel-L2 {err} against the one-process "
                             f"pipeline, over {TP_TOL}")
    return err


def rank_weights(pipe) -> dict:
    from qwen_image_edit_streamdiffusion_tpu_torch.models.quantize import quantized_bytes

    return {"tfm": quantized_bytes(pipe.tfm_params),
            "vl": quantized_bytes(pipe.encoder.params),
            "vae": quantized_bytes(pipe.vae_params)}


def rank_create(label: str, preset: str, config, mesh):
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.edit_pipeline import (
        EditPipeline,
    )

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pipe = EditPipeline.create(preset, config, seed=0, device=RANK_DEVICE, mesh=mesh)
    torch.cuda.synchronize()
    emit({"phase": "rank_create", "path": label, "seconds": time.time() - t0,
          "mesh": [mesh.cfg, mesh.model], "coords": [mesh.c, mesh.m],
          "weight_bytes": rank_weights(pipe),
          "device_bytes": torch.cuda.memory_allocated(),
          "peak_bytes_during_create": torch.cuda.max_memory_allocated()})
    return pipe


def int8_code_spy(mesh, checks: list):
    """Wrap K5's given-scale entry for the first row-parallel linear of each
    (M, K) the miss runs (the vision tower's proj and down, the merger, the
    LM's o_proj and down, the MMDiT's outputs and fc2 at the text and image
    rows): the slices gathered over the model group, the whole rows
    quantized as one device quantizes them (K5's plain version, which phase
    9 holds K5 to bit for bit; no launch is added to the path's counts),
    its codes and scales held to the given-scale codes bit for bit (zero
    padding columns left out)."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.ops import int8
    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed

    inner, row_inner = int8.quantize_rows_given, int8.int8_linear_row
    widths = []

    def row(x, p, group):
        widths.append(x.shape[-1])
        return row_inner(x, p, group)

    def given(x, scale):
        codes = inner(x, scale)
        k = widths.pop(0)
        if [x.shape[0], k] not in [c["mk"] for c in checks]:
            g = mesh.model_group
            whole = distributed.all_gather(x[:, :k].contiguous(), g, dim=-1)
            want, want_scale = int8.quantize_rows_plain(whole)
            checks.append({"mk": [x.shape[0], k], "codes_equal": bool(torch.equal(
                codes[:, :k], want[:, g.rank * k:(g.rank + 1) * k])),
                "scales_equal": bool(torch.equal(scale, want_scale))})
        return codes

    return given, row


def tp_config(model_axis: int = 1):
    """The config of phases 8b, 8d and 8f (TP_PRESET): ``model_axis`` 2 on a
    rank, 1 for the one-process references."""
    from qwen_image_edit_streamdiffusion_tpu_torch.core.config import StreamConfig

    return StreamConfig(width=SIZE, height=SIZE, num_inference_steps=STEPS,
                        cfg_mode="none", model_preset=TP_PRESET, mesh_model_axis=model_axis)


def rank_tp(mesh, refs) -> dict:
    """Phase 8b on one rank (see the module docstring): the bf16 rung, then,
    with every reference to its pipeline gone, the int8 rung."""
    import torch

    launches = rank_tp_bf16(mesh, refs)
    gc.collect()
    torch.cuda.empty_cache()
    for k, n in rank_tp_int8(mesh, refs).items():
        launches[k] += n
    return launches


def rank_tp_bf16(mesh, refs) -> dict:
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime.engine import (
        InferenceEngine,
        LockstepPipeline,
        follow,
    )

    rank = mesh.world_group.rank
    label = f"tp2 bf16 rank{rank}"
    tp_preset()
    pipe = rank_create(label, TP_PRESET, tp_config(model_axis=2), mesh)
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    for name, (call, want, rows) in tp_calls(pipe).items():
        distributed.reset_stats()
        res = serve(label, name, call, want, rows)
        held(label, name, res[0].latents, refs[name])
        if name == "miss_a":  # a cond-only miss: the collectives of its two forwards
            emit({"phase": "collectives", "path": label, "request": name,
                  "forwards": STEPS, **distributed.STATS})
    pipe.config = pipe.config.replace(cfg_mode="none")
    if rank == 0:
        cap = Capture(pipe)
        engine = InferenceEngine(pipeline=LockstepPipeline(cap, mesh.world_group),
                                 input_size=SERVE_INPUT, default_steps=STEPS)
        srv, url = start_server(engine)
        try:
            served(url, label, "edit_miss", tp_edit_payload(), expected(True, k1=K1_TP))
        finally:
            stop_server(srv)
            engine.pipeline.shutdown()
        held(label, "edit_miss", cap.results[0].latents, refs["edit"])
    else:  # the followed call, under rank 0's checks; a raise fails the phase
        cap = Capture(pipe)
        before = dict(kernels.LAUNCHES)
        calls = follow(cap, mesh.world_group)
        delta = launch_delta(before)
        emit({"phase": "follow_request", "path": label, "name": "edit_miss",
              "calls": calls, "launches": {k: n for k, n in delta.items() if n}})
        if calls != 1:
            raise AssertionError(f"{label}: followed {calls} calls, not 1")
        check_counts(f"{label}/edit_miss", delta, expected(True, k1=K1_TP))
        held(label, "edit_miss", cap.results[0].latents, refs["edit"])
    emit({"phase": "rank_peak", "path": label, "weight_bytes": rank_weights(pipe),
          "peak_bytes": torch.cuda.max_memory_allocated()})
    return dict(kernels.LAUNCHES)


def rank_tp_int8(mesh, refs) -> dict:
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.models.common import flatten
    from qwen_image_edit_streamdiffusion_tpu_torch.ops import int8
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

    label = f"tp2 int8 rank{mesh.world_group.rank}"
    tp_preset()
    pipe = rank_create(label, TP_PRESET,
                       tp_config(model_axis=2).replace(use_int8=True, use_int8_vl=True), mesh)
    per_block = [sum(k.endswith(".w_q") for k in flatten(b))
                 for b in pipe.tfm_params["blocks"]]
    if per_block != [14] * TP_DEPTH:
        raise AssertionError(f"{label}: quantized linears a block {set(per_block)}, not 14")
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    checks: list = []
    saved = int8.quantize_rows_given, int8.int8_linear_row
    int8.quantize_rows_given, int8.int8_linear_row = int8_code_spy(mesh, checks)
    try:
        res = serve(label, "miss", lambda: pipe(distinct_image(TP_IMAGES["int8"]), PROMPT,
                                                num_inference_steps=STEPS, seed=42),
                    expected(True, k1=K1_TP,
                             int8_per_request=14 * K1_TP + ROW_REQUEST * TP_DEPTH // MMDIT_LAYERS,
                             int8_miss=INT8_LM + INT8_VISION + ROW_MISS))
    finally:
        int8.quantize_rows_given, int8.int8_linear_row = saved
    emit({"phase": "tp_int8_codes", "path": label, "checks": checks})
    if len(checks) < 9 or not all(c["codes_equal"] and c["scales_equal"] for c in checks):
        raise AssertionError(f"{label}: row-parallel int8 codes differ from one "
                             f"device's: {checks}")
    held(label, "miss", res[0].latents, refs["int8"])
    emit({"phase": "rank_peak", "path": label, "weight_bytes": rank_weights(pipe),
          "peak_bytes": torch.cuda.max_memory_allocated()})
    return dict(kernels.LAUNCHES)


def mesh_calls(pipe) -> dict:
    """Phase 8c's requests on ``pipe`` (cut depth): name → (call, launches,
    rows of K1's calls)."""
    k = expected(True, k1=CUT_DEPTH * STEPS, k2=CUT_DEPTH)
    lk = TXT_LEN + 2 * (SIZE // 16) ** 2
    return {"mesh_parallel": (guided(pipe, "parallel", distinct_image(TP_IMAGES["mesh_parallel"])),
                              k, {"flash_joint": {f"1x{lk}": CUT_DEPTH * STEPS}}),
            "mesh_rcfg": (guided(pipe, "rcfg", distinct_image(TP_IMAGES["mesh_rcfg"])), k,
                          {"flash_joint": {f"2x{lk}": CUT_DEPTH,
                                           f"1x{lk}": CUT_DEPTH * (STEPS - 1)}}),
            "mesh_num_images": (lambda: pipe(distinct_image(TP_IMAGES["mesh_num_images"]),
                                             PROMPT, num_inference_steps=STEPS, seed=42,
                                             num_images_per_prompt=2),
                                k, None)}


def rank_mesh(mesh, refs) -> dict:
    """Phase 8c on one rank."""
    from qwen_image_edit_streamdiffusion_tpu_torch.core.config import StreamConfig
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

    cut_preset()
    label = f"mesh2x2 rank{mesh.world_group.rank}"
    config = StreamConfig(width=SIZE, height=SIZE, num_inference_steps=STEPS,
                          cfg_mode="parallel", model_preset=CUT_PRESET,
                          mesh_cfg_axis=2, mesh_model_axis=2)
    pipe = rank_create(label, CUT_PRESET, config, mesh)
    kernels.reset_launches()
    calls = mesh_calls(pipe)
    lk = TXT_LEN + 2 * (SIZE // 16) ** 2
    for name, (call, want, rows) in calls.items():
        if name == "mesh_num_images":  # the rows split over the cfg groups
            rows = {"flash_joint": {f"1x{lk}": CUT_DEPTH * STEPS}}
        res = serve(label, name, call, want, rows,
                    outputs=2 if name == "mesh_num_images" else 1)
        held(label, name, res[0].latents, refs[name])
    return dict(kernels.LAUNCHES)




def rank_entry(rank: int, world: int, init_file: str, queue, phase: str, refs) -> None:
    """A spawned rank: gloo on cuda:0, the mesh, one phase; its records and
    launches (or its traceback) go back to the parent."""
    import traceback

    records = []
    globals()["emit"] = lambda obj: records.append({"rank": rank, **obj})
    try:
        import datetime

        import torch

        from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed
        from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

        torch.cuda.set_device(RANK_DEVICE)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kernels.library()  # built by the parent: loaded, never built here
        timeout = datetime.timedelta(seconds=WORLD_TIMEOUT_S)
        distributed.initialize("gloo", RANK_DEVICE, timeout=timeout,
                               init_method=f"file://{init_file}", rank=rank,
                               world_size=world)
        mesh = distributed.global_mesh(*WORLD_SHAPES[phase], timeout=timeout)
        launches = RANK_PHASES[phase](mesh, refs)
        queue.put((rank, {"records": records, "launches": launches}))
    except Exception:  # reported to the parent, which fails the run
        queue.put((rank, {"records": records, "error": traceback.format_exc()}))
    finally:
        from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed

        distributed.shutdown()


def run_world(phase: str, world: int, refs) -> dict:
    """Spawn ``world`` ranks of ``phase`` (``torch.multiprocessing`` spawn:
    CUDA is live in this process), print their records, and return their
    launches summed; raises when a rank raised or died, and stops every
    rank it started."""
    import queue as queue_mod
    import tempfile

    import torch
    import torch.multiprocessing as mp

    gc.collect()
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    fd, init_file = tempfile.mkstemp(prefix="qie_world_")
    os.close(fd)
    os.unlink(init_file)
    procs = [ctx.Process(target=rank_entry, args=(r, world, init_file, q, phase, refs))
             for r in range(world)]
    t0 = time.time()
    got = {}
    try:
        for p in procs:
            p.start()
        while len(got) < world:
            try:
                rank, rec = q.get(timeout=5)
                got[rank] = rec
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise AssertionError(f"{phase}: rank(s) {dead} died "
                                         f"(exit {[procs[r].exitcode for r in dead]})")
                if time.time() - t0 > WORLD_TIMEOUT_S:
                    raise AssertionError(f"{phase}: no record from ranks "
                                         f"{sorted(set(range(world)) - set(got))}")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        if os.path.exists(init_file):
            os.unlink(init_file)
    for rank in range(world):
        for rec in got[rank]["records"]:
            emit(rec)
    errors = {r: rec["error"] for r, rec in got.items() if "error" in rec}
    if errors:
        raise AssertionError("\n".join(f"{phase} rank {r}:\n{e}" for r, e in errors.items()))
    total = {}
    for rec in got.values():
        for k, n in rec["launches"].items():
            total[k] = total.get(k, 0) + n
    emit({"phase": f"{phase}_world", "ranks": world, "seconds": time.time() - t0,
          "launches": total, "nvidia_smi": nvidia_smi_line(),
          "note": "ranks share one card through gloo (host-staged collectives)"})
    return total


def phase_tp() -> dict:
    """Phase 8b: 2 ranks, mesh 1 × 2, TP_PRESET (module docstring); the
    one-process latents of its requests first, on the same cut."""
    return run_world("tp", 2, tp_references())


def phase_mesh() -> dict:
    """Phase 8c: 4 ranks, mesh 2 × 2, CUT_PRESET; the one-process latents
    of its requests first, on the same cut."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.core.config import StreamConfig
    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.edit_pipeline import (
        EditPipeline,
    )

    cut_preset()
    config = StreamConfig(width=SIZE, height=SIZE, num_inference_steps=STEPS,
                          cfg_mode="parallel", model_preset=CUT_PRESET)
    pipe = EditPipeline.create(CUT_PRESET, config, seed=0, device=RANK_DEVICE)
    refs = {name: call().latents.float().cpu()
            for name, (call, _, _) in mesh_calls(pipe).items()}
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return run_world("mesh", 4, refs)


# Phases tp_train, mesh_train and tp_stream: the LoRA and distill steps and
# the realtime stream under a world, each rank held to the one-process run of
# the same inputs (phase slice computes the stream's, the parents of phases
# tp_train and mesh_train those at their cut depths).
TRAIN_REF_PATH = os.path.join(ROOT, "build", "chip_smoke", "tp_train_refs.pt")
TP_TRAIN_IMAGE = 8300      # the condition image; the target is the next one
TP_STREAM_FRAMES = 8
TP_WS_FRAMES = 3
MESH_TRAIN_IMAGE = 8400


def train_items(rows: int, base: int) -> list:
    """``rows`` train items (a condition, a target, PROMPT and the negative
    prompt ""), the images distinct per row."""
    return [{"image": distinct_image(base + 2 * i, SIZE),
             "target": distinct_image(base + 2 * i + 1, SIZE),
             "prompt": PROMPT, "negative_prompt": NEG} for i in range(rows)]


def seeded_b(trainer) -> None:
    """Every adapter's b drawn non-zero (as phase train_parity draws it)
    from one CPU generator, so every factor has a gradient, alike on every
    rank and in one process."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.core.rng import stream
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    gen = stream(1, "lora")
    with torch.no_grad():
        for t in lt.lora_leaves(trainer.lora)[1::2]:
            t.copy_(torch.randn(t.shape, generator=gen) * 0.01)


def train_plan(pipe, batch, hook, after_lora=None) -> None:
    """The steps of phase tp_train on ``pipe`` (the one-card pipeline in
    phase slice, a rank's slices in tp_train), each on ``batch`` through
    ``hook(kind, name, trainer, batch)``: a rank-16 LoRA trainer's warm-up
    and two steps (``after_lora(trainer)`` after them), then a distill
    trainer's unguided step and its guided step (scale 4, the batch's
    negative rows). Each trainer draws its sigmas and noise (intervals and
    ε) from its own seeded CPU generator, alike everywhere."""
    import dataclasses

    from qwen_image_edit_streamdiffusion_tpu_torch.training import distill as dt
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    cfg = lt.TrainConfig(rank=TRAIN_RANK, alpha=16.0, remat=True)
    trainer = lt.LoRATrainer.from_pipeline(pipe, cfg)
    seeded_b(trainer)
    for name in ("warmup", "step0", "step1"):
        hook("lora", name, trainer, batch)
    if after_lora is not None:
        after_lora(trainer)
    del trainer
    gc.collect()
    dcfg = dt.DistillConfig(train=cfg, student_steps=STEPS)
    trainer = dt.DistillTrainer.from_pipeline(pipe, dcfg)
    seeded_b(trainer)
    hook("distill", "unguided", trainer, batch)
    trainer.dcfg = dataclasses.replace(dcfg, teacher_cfg_scale=CFG_SCALE)
    hook("distill", "guided", trainer, batch)


def host_batch(batch) -> dict:
    import torch

    return {k: v.cpu() if torch.is_tensor(v) else v for k, v in batch.items()}


def step_grads(trainer) -> list:
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    return [p.grad for p in lt.lora_leaves(trainer.lora)]


def train_references(pipe) -> None:
    """Phase tp_train's steps on the one-card pipeline: the batch (1 row of
    1024², its negative rows), each step's loss and clipped adapter
    gradients, kept on the host (the gradients in bf16) and written to
    TRAIN_REF_PATH for the ranks."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    batch = lt.build_batch(pipe, train_items(1, TP_TRAIN_IMAGE))
    refs = {"batch": host_batch(batch), "steps": {}}

    def hook(kind, name, trainer, batch):
        torch.cuda.synchronize()
        t0 = time.time()
        loss = trainer.step(batch)
        torch.cuda.synchronize()
        refs["steps"][name] = {"loss": loss, "grads": [g.detach().to(torch.bfloat16).cpu()
                                                       for g in step_grads(trainer)]}
        emit({"phase": "tp_train_reference", "name": name, "seconds": time.time() - t0,
              "loss": loss})

    train_plan(pipe, batch, hook)
    os.makedirs(os.path.dirname(TRAIN_REF_PATH), exist_ok=True)
    torch.save(refs, TRAIN_REF_PATH)


def train_want(kind: str, name: str, layers: int = MMDIT_LAYERS) -> dict:
    """A step's launches: the student's forward twice (remat) on K7, its
    backward on K8 and K9; a distill step's teacher two forwards (four
    guided) on K1."""
    k1 = 0 if kind == "lora" else (4 if name == "guided" else 2) * layers
    return {"flash_fwd_lse": 2 * layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers,
            "flash_joint": k1, "flash_joint_stream": 0}


class HeadSpy:
    """The (rows, heads, length, head dim) of every K1, K2 and K7 call and of
    K8/K9's queries: {counter: {shape: calls}}."""

    NAMES = (("joint_attention", "flash_joint"), ("causal_attention", "flash_causal"),
             ("flash_fwd_lse", "flash_fwd_lse"), ("flash_bwd_dq", "flash_bwd_dq"),
             ("flash_bwd_dkv", "flash_bwd_dkv"))

    def __enter__(self):
        from qwen_image_edit_streamdiffusion_tpu_torch.ops import flash_attention as fa

        self.shapes, self._saved = {}, []
        for name, counter in self.NAMES:
            real = getattr(fa, name)

            def wrapped(q, *a, _real=real, _c=counter, **kw):
                per = self.shapes.setdefault(_c, {})
                key = "x".join(str(n) for n in q.shape)
                per[key] = per.get(key, 0) + 1
                return _real(q, *a, **kw)

            self._saved.append((fa, name, real))
            setattr(fa, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, real in reversed(self._saved):
            setattr(mod, name, real)


def check_grads(where: str, rec: dict, grad_tol: float = TRAIN_TOL) -> None:
    """Raise unless a step graded by :func:`grade_grads` holds: the loss's
    relative error within TRAIN_TOL and every gradient's rel-L2 within
    ``grad_tol``, a gradient that is zero in the reference zero here."""
    if not (rec["count_equal"] and rec["zeros_kept"] and rec["loss_rel"] <= TRAIN_TOL
            and rec["grad_rel_l2_max"] <= grad_tol):
        raise AssertionError(f"{where}: against one process {rec}, tolerance {grad_tol}")


def leaf_names(lora) -> list:
    """The name of every adapter tensor, in :func:`step_grads`' order:
    ``block.path.a`` / ``.b``."""
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    return [f"{i}.{'.'.join(path)}.{f}" for i, blk in enumerate(lora["blocks"])
            for path in lt._adapter_paths({"blocks": [blk]}) for f in ("a", "b")]


def worst_grads(grads, ref, names, n: int = 3) -> list:
    """The ``n`` gradients furthest (rel-L2) from ``ref``'s: their leaf,
    rel-L2 and norm over the median norm of ``ref``'s gradients."""
    rows = []
    norms = sorted(w.float().norm().item() for w in ref["grads"])
    med = norms[len(norms) // 2]
    for g, w, name in zip(grads, ref["grads"], names):
        w = w.float()
        wn = w.norm().item()
        if wn > 0:
            rows.append((((g.detach().float().cpu() - w).norm() / wn).item(), name, wn / med))
    rows.sort(reverse=True)
    return [{"leaf": name, "rel_l2": r, "norm_over_median": m} for r, name, m in rows[:n]]


def grade_grads(loss: float, grads, ref) -> dict:
    """The loss's relative error and each gradient's rel-L2 against
    ``ref``'s (max and median; and of all gradients as one vector), and
    whether its zero gradients stay zero."""
    rels, zero_ok, diff2, ref2 = [], True, 0.0, 0.0
    for g, w in zip(grads, ref["grads"]):
        g, w = g.detach().float().cpu(), w.float()
        wn = w.norm().item()
        diff2 += (g - w).norm().item() ** 2
        ref2 += wn ** 2
        if wn > 0:
            rels.append(((g - w).norm() / wn).item())
        else:
            zero_ok = zero_ok and g.norm().item() == 0
    loss_rel = abs(loss - ref["loss"]) / abs(ref["loss"])
    return {"loss": loss, "loss_ref": ref["loss"], "loss_rel": loss_rel,
            "grad_rel_l2_max": max(rels), "grad_rel_l2_median": sorted(rels)[len(rels) // 2],
            "grad_rel_l2_whole": (diff2 / ref2) ** 0.5,
            "grads_compared": len(rels), "zeros_kept": zero_ok,
            "count_equal": len(grads) == len(ref["grads"])}


def identical_across(label: str, tensors, group) -> None:
    """Raise unless ``tensors`` are bit-identical on every rank of
    ``group``: their flat f32 copy equals its elementwise max and min over
    the group."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed

    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    hi = distributed.all_reduce(flat.clone(), group, op="max")
    lo = -distributed.all_reduce(-flat, group, op="max")
    same = bool(torch.equal(hi, flat)) and bool(torch.equal(lo, flat))
    emit({"phase": "adapters_across_ranks", "path": label, "elements": flat.numel(),
          "bit_identical": same})
    if not same:
        raise AssertionError(f"{label}: the adapters differ across the ranks")


def heads_of(label: str, shapes: dict, counter: str, heads: int, calls: int) -> None:
    """Raise unless ``counter``'s calls (HeadSpy) number ``calls``, each at
    ``heads`` heads (a rank's share) and one row."""
    per = shapes.get(counter, {})
    if sum(per.values()) != calls or any(
            k.split("x")[:2] != ["1", str(heads)] for k in per):
        raise AssertionError(f"{label}: {counter} at {per}, not {calls} calls of "
                             f"1 row and {heads} heads")


def rank_train_hook(label: str, refs: dict, steps_done: dict, layers: int, heads: int):
    """The rank side of :func:`train_plan`: one step timed (a gloo time of
    ranks sharing the card), its launches (and their heads) and collectives
    printed and checked, its loss and gradients held to ``refs``."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

    def hook(kind, name, trainer, batch):
        before = dict(kernels.LAUNCHES)
        distributed.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.time()
        with HeadSpy() as spy:
            loss = trainer.step(batch)
            torch.cuda.synchronize()
        wall = time.time() - t0
        delta = launch_delta(before)
        grads = step_grads(trainer)
        ref, tol = refs[name], GUIDED_TRAIN_TOL if name == "guided" else TRAIN_TOL
        held = grade_grads(loss, grads, ref)
        emit({"phase": "tp_train_step", "path": label, "kind": kind, "name": name,
              "seconds": wall, "launches": {k: n for k, n in delta.items() if n},
              "heads": spy.shapes, "collectives": dict(distributed.STATS),
              "peak_bytes": torch.cuda.max_memory_allocated(), **held, "grad_tol": tol,
              "worst": worst_grads(grads, ref, leaf_names(trainer.lora)),
              "note": "gloo: ranks share one card"})
        check_grads(f"{label}/{name}", held, tol)
        want = train_want(kind, name, layers)
        check_counts(f"{label}/{name}", delta, want)
        for counter in ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv", "flash_joint"):
            heads_of(f"{label}/{name}", spy.shapes, counter, heads, want[counter])
        steps_done[name] = wall

    return hook


def rank_tp_train(mesh, refs) -> dict:
    """Phase tp_train on one rank: TP_PRESET's slices (mesh 1 × 2), the
    one-card batch, train_plan's five steps held to the parent's."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    label = f"tp2 train rank{mesh.world_group.rank}"
    tp_preset()
    pipe = rank_create(label, TP_PRESET, tp_config(model_axis=2), mesh)
    saved = torch.load(TRAIN_REF_PATH, map_location="cpu", weights_only=True, mmap=True)
    batch = {k: v.to(RANK_DEVICE) if torch.is_tensor(v) else v
             for k, v in saved["batch"].items()}
    kernels.reset_launches()
    walls: dict = {}
    cfg = pipe.preset.model
    train_plan(pipe, batch, rank_train_hook(label, saved["steps"], walls, cfg.num_layers,
                                            cfg.num_heads // mesh.model),
               after_lora=lambda t: identical_across(label, lt.lora_leaves(t.lora),
                                                     mesh.world_group))
    emit({"phase": "rank_peak", "path": label, "weight_bytes": rank_weights(pipe),
          "peak_bytes": torch.cuda.max_memory_allocated(), "step_seconds": walls})
    return dict(kernels.LAUNCHES)


def cut_train_config():
    from qwen_image_edit_streamdiffusion_tpu_torch.core.config import StreamConfig

    return StreamConfig(width=SIZE, height=SIZE, num_inference_steps=STEPS,
                        model_preset=CUT_PRESET)


def cut_lora_steps(pipe, refs, hook_for) -> None:
    """Phase mesh_train's steps on ``pipe`` at the cut depth: one LoRA step
    on 2 rows (split over cfg on the mesh), one on 1 row (every cfg group
    runs it), each on its own fresh trainer."""
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    cfg = lt.TrainConfig(rank=TRAIN_RANK, alpha=16.0, remat=True)
    for name in ("split", "replicated"):
        trainer = lt.LoRATrainer.from_pipeline(pipe, cfg)
        seeded_b(trainer)
        hook_for(name)("lora", name, trainer, refs["batches"][name])


def phase_mesh_train() -> dict:
    """Phase mesh_train: 4 ranks, mesh 2 × 2, CUT_PRESET: a LoRA step on 2
    rows (split over cfg) and one on 1 row (replicated over cfg), each held
    to the one-process step at that depth, computed first."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.edit_pipeline import (
        EditPipeline,
    )
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    cut_preset()
    pipe = EditPipeline.create(CUT_PRESET, cut_train_config(), seed=0, device=RANK_DEVICE)
    refs = {"batches": {}, "steps": {}}
    for name, rows in (("split", 2), ("replicated", 1)):
        refs["batches"][name] = host_batch(lt.build_batch(
            pipe, train_items(rows, MESH_TRAIN_IMAGE)))

    def hook_for(name):
        def hook(kind, _, trainer, batch):
            dev = {k: v.to(RANK_DEVICE) if torch.is_tensor(v) else v for k, v in batch.items()}
            loss = trainer.step(dev)
            refs["steps"][name] = {"loss": loss, "grads": [
                g.detach().to(torch.bfloat16).cpu() for g in step_grads(trainer)]}
        return hook

    cut_lora_steps(pipe, refs, hook_for)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return run_world("mesh_train", 4, refs)


def rank_mesh_train(mesh, refs) -> dict:
    """Phase mesh_train on one rank."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels
    from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

    cut_preset()
    label = f"mesh2x2 train rank{mesh.world_group.rank}"
    config = cut_train_config().replace(mesh_cfg_axis=2, mesh_model_axis=2)
    pipe = rank_create(label, CUT_PRESET, config, mesh)
    kernels.reset_launches()
    walls: dict = {}
    cfg = pipe.preset.model
    inner = rank_train_hook(label, refs["steps"], walls, cfg.num_layers,
                            cfg.num_heads // mesh.model)

    def hook_for(name):
        def hook(kind, _, trainer, batch):
            dev = {k: v.to(RANK_DEVICE) if torch.is_tensor(v) else v for k, v in batch.items()}
            inner(kind, name, trainer, dev)
            identical_across(f"{label}/{name}", lt.lora_leaves(trainer.lora), mesh.world_group)
        return hook

    cut_lora_steps(pipe, refs, hook_for)
    return dict(kernels.LAUNCHES)


class LatentSpy:
    """Records each stream frame's final latent as its session queues it
    (``RealtimePipeline._advance``), on the host."""

    def __enter__(self):
        from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import stream

        self.latents, self._real = [], stream.RealtimePipeline._advance
        spy = self

        def advance(rt, *a, **kw):
            out = spy._real(rt, *a, **kw)
            spy.latents.append(rt.prev_latent.float().cpu())
            return out

        stream.RealtimePipeline._advance = advance
        return self

    def __exit__(self, *exc):
        from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import stream

        stream.RealtimePipeline._advance = self._real


def tp_stream_frames(n: int):
    return [stream_image("sine", STREAM_SIZE, 0.3 * i) for i in range(n)]


def ws_session(host: str, port: int, frames) -> list:
    """One websocket session of ``frames`` (pipelined: lags 0, 1, 1, ...):
    the replies' metadata; the socket closed."""
    from qwen_image_edit_streamdiffusion_tpu_torch.serving import ws

    c = ws.WSClient(host, port, timeout=600)
    metas = []
    try:
        ready = c.recv()
        c.send_config(prompt=PROMPT, steps=STEPS, pipeline=True)
        ack = c.recv()
        if ready.get("status") != "ready" or ack.get("status") != "ok":
            raise AssertionError(f"ws handshake: {ready} {ack}")
        for fr in frames:
            c.send_image(fr)
            reply = c.recv()
            if not isinstance(reply, tuple):
                raise AssertionError(f"ws frame: {reply}")
            metas.append(reply[0])
    finally:
        c.close()
    return metas


def stream_engine(pipe):
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime.engine import InferenceEngine

    return InferenceEngine(pipeline=pipe, input_size=STREAM_SIZE, default_steps=STEPS)


def stream_references() -> dict:
    """Phase tp_stream's runs on a one-process pipeline of TP_PRESET: a
    session of TP_STREAM_FRAMES frames submitted pipelined (each frame's
    latent), then a websocket session of TP_WS_FRAMES frames through an
    engine behind the server (each frame's latent)."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.edit_pipeline import (
        EditPipeline,
    )
    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.stream import RealtimePipeline

    tp_preset()
    pipe = EditPipeline.create(TP_PRESET, tp_config(), seed=0, device=RANK_DEVICE)
    pipe.config = stream_config(pipe, STREAM_SIZE)
    refs = {}
    rt = RealtimePipeline(pipe=pipe)
    rt.precompute_conditions(PROMPT)
    with LatentSpy() as spy:
        pending = None
        for fr in tp_stream_frames(TP_STREAM_FRAMES):
            handle = rt.submit_frame(fr)
            if pending is not None:
                rt._collect(pending)
            pending = handle
        rt._collect(pending)
    refs["frames"] = spy.latents
    engine = stream_engine(pipe)
    srv, url = start_server(engine)
    try:
        with LatentSpy() as spy:
            refs["ws_meta"] = ws_session("127.0.0.1", srv.server_address[1],
                                         tp_stream_frames(TP_WS_FRAMES))
    finally:
        stop_server(srv)
    refs["ws"] = spy.latents
    torch.cuda.synchronize()
    emit({"phase": "tp_stream_reference", "frames": len(refs["frames"]),
          "ws_frames": len(refs["ws"]), "ws_lags": [m.get("lag") for m in refs["ws_meta"]]})
    del rt, engine, pipe
    gc.collect()
    torch.cuda.empty_cache()
    return refs


def held_frames(label: str, name: str, latents, refs) -> list:
    if len(latents) != len(refs):
        raise AssertionError(f"{label}/{name}: {len(latents)} frames, not {len(refs)}")
    return [held(label, f"{name}{i}", got, want) for i, (got, want) in
            enumerate(zip(latents, refs))]


def rank_tp_stream(mesh, refs) -> dict:
    """Phase tp_stream on one rank: TP_PRESET's slices, a stream session
    of TP_STREAM_FRAMES pipelined frames driven alike on both ranks (K2 28
    at 14/2 heads in the prompt freeze; K1 2 · TP_DEPTH / TP_DEPTH at
    (1, 12, 2112, 128) and K3 20 a keyframe / temporal frame), then a
    websocket session through
    the server on rank 0 while rank 1 follows; every frame's latent held to
    the one-process stream's."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.stream import RealtimePipeline
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime.engine import (
        LockstepPipeline,
        follow,
    )

    rank = mesh.world_group.rank
    label = f"tp2 stream rank{rank}"
    tp_preset()
    pipe = rank_create(label, TP_PRESET, tp_config(model_axis=2), mesh)
    pipe.config = stream_config(pipe, STREAM_SIZE)
    kernels.reset_launches()
    rt = RealtimePipeline(pipe=pipe)
    vl, mcfg = pipe.preset.vl, pipe.preset.model
    with HeadSpy() as heads:
        precompute(rt, label, PROMPT)
    heads_of(label, heads.shapes, "flash_causal", vl.num_heads // mesh.model, vl.num_layers)
    lk = int(rt._frozen_txt.shape[1]) + 2 * (STREAM_SIZE // 16) ** 2
    submits, pending = [], None
    torch.cuda.synchronize()
    t_all = time.time()
    with LatentSpy() as spy:
        for i, fr in enumerate(tp_stream_frames(TP_STREAM_FRAMES)):
            key = i % STREAM_INTERVAL == 0
            before = dict(kernels.LAUNCHES)
            t0 = time.time()
            with RowSpy() as rows, HeadSpy() as hs:
                handle = rt.submit_frame(fr)
            submits.append(time.time() - t0)
            delta = launch_delta(before)
            k1 = (2 if key else 1) * mcfg.num_layers
            check_counts(f"{label}/frame{i}", delta, frame_want(key, layers=mcfg.num_layers),
                         {"flash_joint": {f"1x{lk}": k1}}, rows)
            heads_of(f"{label}/frame{i}", hs.shapes, "flash_joint",
                     mcfg.num_heads // mesh.model, k1)
            if pending is not None:
                rt._collect(pending)
            pending = handle
        rt._collect(pending)
    wall = time.time() - t_all
    errs = held_frames(label, "frame", spy.latents, refs["frames"])
    emit({"phase": "tp_stream_session", "path": label, "frames": TP_STREAM_FRAMES,
          "s_per_frame": wall / TP_STREAM_FRAMES, "fps": TP_STREAM_FRAMES / wall,
          "host_s_per_submit": submits, "temporal_submit_host_s_median": statistics.median(
              submits[1:]), "rel_l2": errs, "joint_length": lk,
          "note": "gloo: ranks share one card; host time a submit includes the "
                  "frame's host-staged all-reduces"})
    del rt
    group = mesh.world_group
    with LatentSpy() as spy:
        if rank == 0:
            engine = stream_engine(LockstepPipeline(pipe, group))
            srv, url = start_server(engine)
            try:
                t0 = time.time()
                metas = ws_session("127.0.0.1", srv.server_address[1],
                                   tp_stream_frames(TP_WS_FRAMES))
                ws_wall = time.time() - t0
                deadline = time.time() + 120
                while engine._sessions and time.time() < deadline:
                    time.sleep(0.05)
                left = sorted(engine._sessions)
            finally:
                stop_server(srv)
                engine.pipeline.shutdown()
            emit({"phase": "tp_stream_ws", "path": label, "frames": TP_WS_FRAMES,
                  "wall_s": ws_wall, "lags": [m.get("lag") for m in metas],
                  "sessions_left": left})
            if [m.get("lag") for m in metas] != [m.get("lag") for m in refs["ws_meta"]] \
                    or left:
                raise AssertionError(f"{label}: ws lags {metas}, sessions left {left}")
        else:
            calls = follow(pipe, group)
            emit({"phase": "tp_stream_follow", "path": label, "calls": calls})
    held_frames(label, "ws", spy.latents, refs["ws"])
    emit({"phase": "rank_peak", "path": label, "weight_bytes": rank_weights(pipe),
          "peak_bytes": torch.cuda.max_memory_allocated()})
    return dict(kernels.LAUNCHES)


def phase_tp_train() -> dict:
    """Phase tp_train: 2 ranks, mesh 1 × 2, TP_PRESET (module docstring);
    the one-process steps first, on the same cut."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.pipeline.edit_pipeline import (
        EditPipeline,
    )

    tp_preset()
    pipe = EditPipeline.create(TP_PRESET, tp_config(), seed=0, device=RANK_DEVICE)
    train_references(pipe)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return run_world("tp_train", 2, {})


def phase_tp_stream() -> dict:
    """Phase tp_stream: 2 ranks, mesh 1 × 2, TP_PRESET (module docstring);
    the one-process stream first, on the same cut."""
    return run_world("tp_stream", 2, stream_references())


RANK_PHASES = {"tp": rank_tp, "mesh": rank_mesh, "tp_train": rank_tp_train,
               "mesh_train": rank_mesh_train, "tp_stream": rank_tp_stream}
WORLD_SHAPES = {"tp": (1, 2), "mesh": (2, 2), "tp_train": (1, 2), "mesh_train": (2, 2),
                "tp_stream": (1, 2)}


# The row-parallel int8 linears of a TP-2 int8 miss: (name, M, K of a rank's
# slice, N, linears a miss a rank). The vision `down` slice (1710) holds zero
# columns up to 1712 (parallel/sharding.py::pad_codes): K5's codes and K6's
# sums run at K = 1712, K5's row scales at 1710. Each such linear launches
# K5 twice (its row scales, then its codes) and K6 twice (its int32 sums,
# then its epilogue), one launch more of each than a column-parallel one.
ROW_MIX = (("img_out", 8192, 1536, 3072, 120), ("img_fc2", 8192, 6144, 3072, 120),
           ("txt_out", 256, 1536, 3072, 120), ("txt_fc2", 256, 6144, 3072, 120),
           ("lm_o", LM_LEN, 1792, 3584, 28), ("lm_down", LM_LEN, 9472, 3584, 28),
           ("vis_proj", 784, 640, 1280, 32), ("vis_down", 784, 1710, 1280, 32),
           ("merger_fc2", 196, 2560, 3584, 1))
# the extra K5 (and K6) launches of the row-parallel linears: every request
# (the MMDiT's), and a miss's VL encode on top
ROW_REQUEST = sum(n for name, *_, n in ROW_MIX if name[:3] in ("img", "txt"))
ROW_MISS = sum(n for *_, n in ROW_MIX) - ROW_REQUEST


# The column-parallel int8 linears of a TP-2 int8 miss at a rank's N (q/k/v
# unfused), the modulation GEMV's 6d/2 outputs, the VL at 14 / 2 heads.
TP_COL_MIX = (("img_q+k+v", 8192, 3072, 1536, 360), ("img_fc1", 8192, 3072, 6144, 120),
              ("txt_q+k+v", 256, 3072, 1536, 360), ("txt_fc1", 256, 3072, 6144, 120),
              ("img_mod+txt_mod", 1, 3072, 9216, 240), ("lm_q", LM_LEN, 3584, 1792, 28),
              ("lm_k+lm_v", LM_LEN, 3584, 256, 56), ("lm_gate+lm_up", LM_LEN, 3584, 9472, 56),
              ("vis_qkv", 784, 1280, 1920, 32), ("vis_gate+vis_up", 784, 1280, 1710, 64),
              ("merger_fc1", 196, 5120, 2560, 1))


def phase_rank_kernels() -> dict:
    """K1, K2 and K6 at a TP-2 rank's shapes: K1 at (1, 12, 8448, 128), K2
    at (1, 14 / 2, 384, 128) (and 7 / 1, a rank of 4), timed as phase 3
    times them, beside SDPA and their bounds; K5 and K6 at the
    column-parallel int8 shapes (:data:`TP_COL_MIX`, as phase 9's mixes).
    Returns the worst error of each kernel."""
    import torch

    from qwen_image_edit_streamdiffusion_tpu_torch.ops import flash_attention as fa

    bf16 = torch.bfloat16
    worst = {"quantize_rows": 0.0, "int8_gemm": 0.0}
    lk = TXT_LEN + 2 * (SIZE // 16) ** 2
    q, k, v = (randn((1, 12, lk, 128), s, bf16) for s in (41, 42, 43))
    mask = torch.ones((1, lk), dtype=torch.bool, device="cuda")
    mask[:, TXT_REAL:TXT_LEN] = False
    out = fa.joint_attention(q, k, v, mask, TXT_LEN)

    def k1_plain():
        return torch.cat([fa.joint_attention_plain(q[:, h:h + 4], k[:, h:h + 4],
                                                   v[:, h:h + 4], mask)
                          for h in range(0, 12, 4)], dim=1)

    ref = k1_plain().float()
    err = (out.float() - ref).abs().max().item()
    rec = {"phase": "kernel", "name": "flash_attention_joint", "shape": list(q.shape),
           "mesh": "TP 2 rank", "max_abs_err": err, "tol": attn_tolerance(ref),
           "ms": cuda_ms(lambda: fa.joint_attention(q, k, v, mask, TXT_LEN), 10),
           "plain_ms": cuda_ms(k1_plain, 3),
           "library_ms": cuda_ms(lambda: sdpa(q, k, v, mask), 10),
           **attention_bound(q, k, v, (out,), mask, 4)}
    emit_kernel(rec)
    if not err <= rec["tol"]:
        raise AssertionError(f"K1 error {err} > {rec['tol']} at a rank's shape")
    worst["flash_attention_joint"] = err
    del q, k, v, out, ref
    worst["flash_attention_causal"] = 0.0
    for hq, hkv in ((14, 2), (7, 1)):
        q = randn((1, hq, LM_LEN, 128), 44, bf16)
        k, v = (randn((1, hkv, LM_LEN, 128), s, bf16) for s in (45, 46))
        keep = torch.arange(LM_LEN, device="cuda") < LM_REAL
        ref = fa.causal_attention_plain(q, k, v, keep)[:, :, :LM_REAL].float()
        err = (fa.causal_attention(q, k, v)[:, :, :LM_REAL].float() - ref).abs().max().item()
        rec = {"phase": "kernel", "name": "flash_attention_causal",
               "shape": [1, hq, hkv, LM_LEN], "mesh": f"TP {28 // hq} rank",
               "max_abs_err": err, "tol": attn_tolerance(ref),
               **timed("", lambda: fa.causal_attention(q, k, v), K2_LAUNCHES),
               "plain_ms": cuda_ms(lambda: fa.causal_attention_plain(q, k, v, keep), 20),
               **timed("library_", lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
                       K2_LAUNCHES),
               **bound(4 * hq * (LM_LEN * (LM_LEN + 1) / 2) * 128,
                       nbytes(q, k, v) + nbytes(q), PEAK_BF16)}
        emit_kernel(rec)
        if not err <= rec["tol"]:
            raise AssertionError(f"K2 error {err} > {rec['tol']} at {hq} / {hkv} heads")
        worst["flash_attention_causal"] = max(worst["flash_attention_causal"], err)
        del q, k, v, ref
    torch.cuda.empty_cache()
    int8_mix(TP_COL_MIX, "TP-2 int8 miss, column-parallel", worst)
    return worst


def phase_row_parallel_kernels() -> dict:
    """K5's and K6's row-parallel entries at every row-parallel shape of a
    TP-2 int8 miss (:data:`ROW_MIX`): K5's row scales alone and its codes of
    a given scale, K6's int32 sums and its epilogue on them, each equal to
    its plain version (max-abs error 0), with device time (a graph of the
    shape's launches), wall time, plain time and bound; K6's sums beside
    ``torch._int_mm`` (the same function: the s8 product, int32 out). Then
    one rank's whole row-parallel linear (``int8_linear_row``, its two
    all-reduces left out: phase 8b times those) beside the one-device int8
    linear of the whole rows (K twice the slice's), in device time. Returns
    the worst error of each kernel."""
    from types import SimpleNamespace

    import torch
    import torch.nn.functional as F

    from qwen_image_edit_streamdiffusion_tpu_torch.ops import int8
    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed, sharding

    bf16 = torch.bfloat16
    worst = {"quantize_rows": 0.0, "int8_gemm": 0.0}
    mix: dict = {}
    linear = {"row_ms": 0.0, "one_device_ms": 0.0}
    real_all_reduce = distributed.all_reduce
    for name, m, k, n, launches in ROW_MIX:
        whole = randn((m, 2 * k), 25, bf16)
        x = whole[:, :k].contiguous()  # rank 0's slice of the rows
        w_q_whole, ws = int8.quantize_weight(
            randn((n, 2 * k), 26, torch.float32).mul_(0.02).to(bf16))
        b = randn((n,), 27, torch.float32).mul_(0.1).to(bf16)
        wq = sharding.pad_codes(w_q_whole[:, :k]).contiguous()
        xp = F.pad(x, (0, wq.shape[1] - k))
        scale = int8.row_scales_plain(whole)  # the MAX over the ranks' scales
        own = int8.row_scales(x)
        xq = int8.quantize_rows_given(xp, scale)
        acc = int8.int8_matmul_acc(xq, wq)
        out = int8.int8_epilogue(acc, scale, ws, b, bf16)
        mm = int_mm(xq, wq)
        recs = {
            ("quantize_rows", "row_scales"): (
                (own - int8.row_scales_plain(x)).abs().max().item(),
                {**timed("", lambda: int8.row_scales(x), launches),
                 "plain_ms": cuda_ms(lambda: int8.row_scales_plain(x), 5),
                 "library_ms": None, **bound(0, nbytes(x, own), PEAK_INT8)}),
            ("quantize_rows", "given_scale"): (
                (xq.int() - int8.quantize_rows_given_plain(xp, scale).int()).abs().max().item(),
                {**timed("", lambda: int8.quantize_rows_given(xp, scale), launches),
                 "plain_ms": cuda_ms(lambda: int8.quantize_rows_given_plain(xp, scale), 5),
                 "library_ms": None, **bound(0, nbytes(xp, xq, scale), PEAK_INT8)}),
            ("int8_gemm", "int32_acc"): (
                (acc.long() - int8.int8_matmul_acc_plain(xq, wq).long()).abs().max().item(),
                {**timed("", lambda: int8.int8_matmul_acc(xq, wq), launches),
                 "plain_ms": cuda_ms(lambda: int8.int8_matmul_acc_plain(xq, wq), 3),
                 "library_ms": graph_ms(mm, launches) if mm else None,
                 **bound(2 * m * wq.shape[1] * n, nbytes(xq, wq, acc), PEAK_INT8)}),
            ("int8_gemm", "epilogue"): (
                (out.float() - int8.int8_epilogue_plain(acc, scale, ws, b, bf16).float()
                 ).abs().max().item(),
                {**timed("", lambda: int8.int8_epilogue(acc, scale, ws, b, bf16), launches),
                 "plain_ms": cuda_ms(lambda: int8.int8_epilogue_plain(acc, scale, ws, b, bf16),
                                     5),
                 "library_ms": None, **bound(0, nbytes(acc, scale, ws, b, out), PEAK_INT8)}),
        }
        for (kname, entry), (err, rec) in recs.items():
            emit_kernel({"phase": "kernel", "name": kname, "entry": entry, "shape": name,
                         "mix": "TP-2 int8 miss, row-parallel", "mkn": [m, k, n],
                         "launches_miss": launches, "max_abs_err": err, "tol": 0.0, **rec})
            worst[kname] = max(worst[kname], err)
            tot = mix.setdefault((kname, entry), dict.fromkeys(
                ("ms", "bound_ms", "plain_ms", "library_ms"), 0.0))
            for key in tot:
                if rec.get(key) is not None:
                    tot[key] += launches * rec[key]
            if err != 0:
                raise AssertionError(f"{name}: {kname} {entry} error {err}: not equal "
                                     "to its plain version")
        p_row = {"w_q": wq, "scale": ws, "bias": b}
        rank0 = SimpleNamespace(size=2, rank=0)
        distributed.all_reduce = lambda t, group, op="sum": t
        try:
            row = graph_ms(lambda: int8.int8_linear_row(x, p_row, rank0), launches)
        finally:
            distributed.all_reduce = real_all_reduce
        p_one = {"w_q": w_q_whole, "scale": ws, "bias": b}
        one = graph_ms(lambda: int8.int8_linear(whole, p_one), launches)
        emit({"phase": "row_linear", "shape": name, "mkn": [m, k, n],
              "launches_miss": launches, "row_ms": row, "one_device_ms": one,
              "note": "one rank's row-parallel int8 linear without its all-reduces "
                      "beside the one-device int8 linear of the whole rows"})
        linear["row_ms"] += launches * row
        linear["one_device_ms"] += launches * one
        del whole, x, xp, w_q_whole, wq, ws, b, own, xq, acc, out, scale, p_row, p_one
        torch.cuda.empty_cache()
    for (kname, entry), tot in mix.items():
        if entry != "int32_acc":  # no single library call computes the others
            tot["library_ms"] = None
        emit({"phase": "kernel_mix", "name": kname, "per": "TP-2 int8 miss, row-parallel",
              "entry": entry, "launches": sum(n for *_, n in ROW_MIX), **tot,
              "bound_share": tot["bound_ms"] / tot["ms"]})
    emit({"phase": "row_linear_mix", "per": "TP-2 int8 miss, a rank",
          "linears": sum(n for *_, n in ROW_MIX), **linear})
    return worst


def timed_phase(fn):
    """``fn`` that prints its wall seconds (``phase_seconds``) when it returns."""
    def run():
        t0 = time.time()
        out = fn()
        emit({"phase": "phase_seconds", "name": fn.__name__, "seconds": time.time() - t0})
        return out

    return run


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, PKG)):
        print(f"chip_smoke: {PKG}/ not found beside this script; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

    t0 = time.time()
    kernels.library()
    build_s = time.time() - t0
    sass = build_report(kernels.library_path())
    emit({"phase": "build", "seconds": build_s, "kernels": sass})
    for sym in WGMMA_KERNELS:
        if not any(name.startswith(sym) for name in sass):
            raise AssertionError(f"{sym} is not in the library")
    for name, rec in sass.items():
        if name.startswith(WGMMA_KERNELS) and not (
                sum(rec[op] for op in GMMA_OPS) > 0 and rec["UTMALDG"] > 0
                and rec["spill_bytes"] == 0
                and not rec["wgmma_serialized"]):
            raise AssertionError(f"{name}: not a wgmma/TMA kernel without spills "
                                 f"and serialisation: {rec}")

    timed_phase(phase_resize)()
    timed_phase(phase_inputs)()
    per_kernel = timed_phase(phase_kernels)()
    for phase in (phase_block_parity, phase_train_parity, phase_distill_parity):
        timed_phase(phase)()
    launches = {}
    for phase in (phase_slice, phase_int8, phase_int4, phase_checkpoint, phase_tp,
                  phase_mesh, phase_tp_train, phase_mesh_train, phase_tp_stream):
        for k, n in timed_phase(phase)().items():  # each pipeline is dropped on return
            launches[k] = launches.get(k, 0) + n
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "launches", "total": launches})
    for name, err in STREAM_KERNEL_ERRS.items():  # K1, K2 and K3 at the stream's shapes
        per_kernel[name]["max_abs_err"] = max(per_kernel[name]["max_abs_err"], err)
    per_kernel.update(timed_phase(phase_int8_kernels)())
    for phase in (phase_row_parallel_kernels, phase_rank_kernels):
        for name, err in timed_phase(phase)().items():
            per_kernel[name]["max_abs_err"] = max(per_kernel[name]["max_abs_err"], err)

    sources = {
        "flash_attention_joint": ("csrc/flash_fwd_sm90.cu", "flash_joint",
                                  "qwen_image_edit_streamdiffusion_tpu/ops/flash_attention.py:42"),
        "flash_attention_causal": ("csrc/flash_fwd_sm90.cu", "flash_causal",
                                   "qwen_image_edit_streamdiffusion_tpu/ops/flash_attention.py:163"),
        "conv3x3": ("csrc/conv3x3.cu", "conv3x3",
                    "qwen_image_edit_streamdiffusion_tpu/ops/conv.py:44"),
        "flash_attention_stream": ("csrc/flash_fwd_sm90.cu", "flash_joint_stream",
                                   "qwen_image_edit_streamdiffusion_tpu/ops/flash_attention.py:286"),
        "quantize_rows": ("csrc/int8_gemm.cu", "quantize_rows",
                          "qwen_image_edit_streamdiffusion_tpu/ops/int8.py:139"),
        "int8_gemm": ("csrc/int8_gemm.cu", "int8_gemm",
                      "qwen_image_edit_streamdiffusion_tpu/ops/int8.py:174"),
        "flash_fwd_lse": ("csrc/flash_fwd_sm90.cu", "flash_fwd_lse",
                          "qwen_image_edit_streamdiffusion_tpu/ops/flash_attention.py:426"),
        "flash_bwd_dq": ("csrc/flash_attention_bwd.cu", "flash_bwd_dq",
                         "qwen_image_edit_streamdiffusion_tpu/ops/flash_attention.py:492"),
        "flash_bwd_dkv": ("csrc/flash_attention_bwd.cu", "flash_bwd_dkv",
                          "qwen_image_edit_streamdiffusion_tpu/ops/flash_attention.py:546"),
    }
    summary = []
    for name, (src, counter, replaces) in sources.items():
        rec = per_kernel[name]
        if launches[counter] <= 0:
            raise AssertionError(f"{name} never ran on the main path")
        summary.append({"name": name, "route": "cuda", "source": f"{PKG}/{src}",
                        "replaces": replaces, "launches": launches[counter],
                        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"]})
    print(nvidia_smi_line(), flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
