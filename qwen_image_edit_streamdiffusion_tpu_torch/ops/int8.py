"""Weight-only int8 and int4 linears: row quantize (K5) → int8 GEMM (K6).

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/ops/int8.py``:

- weights: per-output-channel symmetric int8 (absmax), quantized offline
  (:func:`quantize_weight`), or group-64 symmetric int4 (:func:`quantize_weight_int4`);
- activations: per-row symmetric int8, quantized at run time by K5
  (``quantize_rows``, replacing the Pallas ``_quantize_rows_kernel``);
- accumulation: exact int32 in K6 (``int8_matmul``, replacing
  ``_int8_gemm_v2_kernel``), then one f32 epilogue and one cast.

The port follows ``int8_matmul_xla``, the path the JAX package takes by default
and on the CPU, not the Pallas v2 entry:

- row scale = max(absmax, 1e-8) · fl(1/127): the JAX source divides by 127,
  but XLA compiles a division by a constant into a multiply by its f32
  reciprocal, and the JAX package always runs this under ``jit`` (the Pallas
  kernel in interpret mode too), so that is the arithmetic to match bit for
  bit. Offline weight quantization runs eagerly in the JAX package, where
  the division stays a division, and so it does here;
- codes = clip(round-half-even(x / scale), −127, 127);
- out = (((acc · x_scale) · w_scale) + bias) in f32, cast once to the
  activation dtype. Pallas v2 (``int8_linear_v2``) adds the bias after the
  cast; the port adds it before, as XLA does.

There is no switch between the two: on a CUDA tensor every int8 linear is K5
then K6. Each wrapper takes its plain version only for a tensor on the CPU;
a CUDA tensor launches the kernel or the call raises. K6 has two bodies,
chosen by shape before the launch (:func:`gemm_plan`): the wgmma + TMA
kernel where K % 16 == 0, and the ``mma.sync`` kernel where K % 16 != 0
(TMA's row strides are multiples of 16 bytes; on the path only the vision
tower's ``down``, K = 3420).

Under tensor parallelism a row-parallel int8 linear (:func:`int8_linear_row`)
takes two entries of K5 and two of K6: the slice's row scales
(:func:`row_scales`), whose MAX over the ranks is the whole row's scale; the
codes of that scale (:func:`quantize_rows_given`); the slice's exact int32
sums (:func:`int8_matmul_acc`), which the ranks add; and the epilogue on
the sums (:func:`int8_epilogue`): the one-device result, bit for bit.

Layouts are the port's: an int8 leaf is ``{"w_q": (out, in) int8, "scale":
(out,) f32, "bias"}``; an int4 leaf is ``{"w_q4": (out, in/2) uint8,
"scale4": (out, in/64) f32, "bias"}``, where byte ``[o, j]`` holds input
``2j`` in its low nibble and input ``2j + 1`` in its high nibble, each stored
as code + 8 (codes in [−7, 7]). That is the JAX (in/2, out) / (in/64, out)
layout transposed; the nibble pairs stay pairs along ``in``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

INT4_GROUP = 64  # input-dim group size of the int4 scales


RCP127 = 0.007874015718698502  # fl32(1 / 127), exact in a float


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / c as an IEEE division: on CUDA, PyTorch multiplies by the
    reciprocal when it divides by a Python scalar, which can differ by an
    ulp."""
    return a / torch.full_like(a, c)


# ---------------------------------------------------------------------------
# Offline weight quantization (plain PyTorch, as in the JAX package)
# ---------------------------------------------------------------------------


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) float weight → ((out, in) int8 codes, (out,) f32 scales),
    symmetric per output channel."""
    w32 = w.float()
    scale = _div(w32.abs().amax(dim=1).clamp_min(1e-8), 127.0)
    w_q = torch.round(w32 / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return w_q, scale


def quantize_weight_int4(w: torch.Tensor, group: int = INT4_GROUP
                         ) -> Dict[str, torch.Tensor]:
    """(out, in) float → ``{"w_q4": (out, in/2) uint8, "scale4": (out,
    in/group) f32}``: codes in [−7, 7] per (output channel, input group),
    packed as described in the module docstring. ``in`` must be divisible by
    max(group, 2)."""
    out, kin = w.shape
    if kin % group or kin % 2:
        raise ValueError(f"in_dim {kin} not divisible by group {group}")
    w32 = w.float().reshape(out, kin // group, group)
    scale = _div(w32.abs().amax(dim=2).clamp_min(1e-8), 7.0)
    q = torch.round(w32 / scale[:, :, None]).clamp(-7, 7)
    q = (q.reshape(out, kin).to(torch.int8) + 8).to(torch.uint8)
    return {"w_q4": q[:, 0::2] | (q[:, 1::2] << 4), "scale4": scale}


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor, dtype,
                    group: int = INT4_GROUP) -> torch.Tensor:
    """Inverse of :func:`quantize_weight_int4` → (out, in) weight in
    ``dtype``; the scale multiply runs in ``dtype``, as in the JAX package."""
    out, half = packed.shape
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    q = torch.stack([lo, hi], dim=-1).reshape(out, half * 2).to(dtype)
    w = q.reshape(out, -1, group) * scale[:, :, None].to(dtype)
    return w.reshape(out, half * 2)


def int4_linear(x: torch.Tensor, p: dict, group=None) -> torch.Tensor:
    """Weight-only int4: dequantize in the activation dtype, then a dense
    product. Saves memory, not time. Plain PyTorch, as XLA ran it.

    With ``group`` (a row-parallel leaf, ``models/common.py::row_linear``)
    the leaf holds this rank's input columns and the bias is left to the
    caller. Its ``scale4`` may be whole, where the ranks' slices cut the
    64-wide groups (the sharding rules replicate a dim that does not divide):
    each column then takes its group's scale."""
    packed, scale = p["w_q4"], p["scale4"]
    if group is not None:
        k_local = packed.shape[1] * 2
        if scale.shape[1] * INT4_GROUP != k_local:
            cols = scale.repeat_interleave(INT4_GROUP, dim=1)
            scale = cols[:, group.rank * k_local:(group.rank + 1) * k_local]
            return F.linear(x, dequantize_int4(packed, scale, x.dtype, group=1))
        return F.linear(x, dequantize_int4(packed, scale, x.dtype))
    w = dequantize_int4(packed, scale, x.dtype)
    b = p.get("bias")
    return F.linear(x, w, None if b is None else b.to(x.dtype))


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------


def quantize_rows_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, K) float → ((M, K) int8 codes, (M, 1) f32 row scales)."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) * RCP127
    return torch.round(x32 / scale).clamp(-127, 127).to(torch.int8), scale


def int8_matmul_plain(x_q: torch.Tensor, x_scale: torch.Tensor,
                      w_q: torch.Tensor, w_scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """x_q (M, K) int8 · w_q (N, K) int8ᵀ → (M, N) ``out_dtype``. The integer
    product is exact: a float64 matmul of the codes, whose partial sums stay
    below 2⁵³ (|acc| ≤ 127² · K). Epilogue as in the module docstring."""
    acc = torch.matmul(x_q.double(), w_q.double().t()).float()
    out = acc * x_scale.float().reshape(-1, 1) * w_scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def row_scales_plain(x: torch.Tensor) -> torch.Tensor:
    """(M, K) float → (M, 1) f32 row scales, :func:`quantize_rows_plain`'s."""
    return x.float().abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) * RCP127


def quantize_rows_given_plain(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(M, K) float, (M, 1) f32 row scales → (M, K) int8 codes of those
    scales (:func:`quantize_rows_plain`'s codes, the scale given)."""
    return torch.round(x.float() / scale).clamp(-127, 127).to(torch.int8)


def int8_matmul_acc_plain(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """x_q (M, K) int8 · w_q (N, K) int8ᵀ → the exact (M, N) int32 sums."""
    return torch.matmul(x_q.double(), w_q.double().t()).to(torch.int32)


def int8_epilogue_plain(acc: torch.Tensor, x_scale: torch.Tensor,
                        w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                        out_dtype) -> torch.Tensor:
    """K6's epilogue on int32 sums, in its order: ((acc · x_scale) · w_scale)
    + bias in f32 (one rounding each, as K6's __fmul_rn / __fadd_rn), then
    one cast — :func:`int8_matmul_plain` after its product."""
    out = acc.float() * x_scale.float().reshape(-1, 1) * w_scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


QUANTIZE_MAX_K = 32768  # K5 holds a row in the registers of one CTA


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: (M, K) bf16 → ((M, K) int8, (M, 1) f32), bit-identical to
    :func:`quantize_rows_plain`; K <= 32768."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x)
    kernels.refuse_grad("quantize_rows", x)
    if x.device.type != "cuda":
        raise RuntimeError(f"quantize_rows: unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"quantize_rows: x must be (M, K), got {tuple(x.shape)}")
    _check("quantize_rows: x", x, torch.bfloat16, x.device)
    m, k = x.shape
    if m == 0 or k == 0 or k > QUANTIZE_MAX_K:
        raise ValueError(f"quantize_rows: x {tuple(x.shape)}; K must be in "
                         f"[1, {QUANTIZE_MAX_K}]")
    lib = kernels.library()
    x_q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    err = lib.qie_quantize_rows_bf16(x.data_ptr(), x_q.data_ptr(), scale.data_ptr(),
                                     m, k, kernels.current_stream_handle(x.device))
    kernels.check(err, "quantize_rows")
    kernels.LAUNCHES["quantize_rows"] += 1
    return x_q, scale


def row_scales(x: torch.Tensor) -> torch.Tensor:
    """K5's row scales alone: (M, K) bf16 → (M, 1) f32, bit-identical to
    :func:`row_scales_plain`; no codes are written. K <= 32768. Counted
    under K5."""
    if x.device.type == "cpu":
        return row_scales_plain(x)
    kernels.refuse_grad("row_scales", x)
    if x.device.type != "cuda":
        raise RuntimeError(f"row_scales: unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"row_scales: x must be (M, K), got {tuple(x.shape)}")
    _check("row_scales: x", x, torch.bfloat16, x.device)
    m, k = x.shape
    if m == 0 or k == 0 or k > QUANTIZE_MAX_K:
        raise ValueError(f"row_scales: x {tuple(x.shape)}; K must be in "
                         f"[1, {QUANTIZE_MAX_K}]")
    lib = kernels.library()
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    err = lib.qie_row_scales_bf16(x.data_ptr(), scale.data_ptr(), m, k,
                                  kernels.current_stream_handle(x.device))
    kernels.check(err, "row_scales")
    kernels.LAUNCHES["quantize_rows"] += 1
    return scale


def quantize_rows_given(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K5 with the row scales given: (M, K) bf16, (M, 1) f32 → (M, K) int8,
    bit-identical to :func:`quantize_rows_given_plain`; K <= 32768. Counted
    under K5."""
    if x.device.type == "cpu":
        return quantize_rows_given_plain(x, scale)
    kernels.refuse_grad("quantize_rows_given", x, scale)
    if x.device.type != "cuda":
        raise RuntimeError(f"quantize_rows_given: unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"quantize_rows_given: x must be (M, K), got {tuple(x.shape)}")
    _check("quantize_rows_given: x", x, torch.bfloat16, x.device)
    _check("quantize_rows_given: scale", scale, torch.float32, x.device)
    m, k = x.shape
    if m == 0 or k == 0 or k > QUANTIZE_MAX_K or scale.numel() != m:
        raise ValueError(f"quantize_rows_given: x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}; K must be in [1, {QUANTIZE_MAX_K}]")
    lib = kernels.library()
    x_q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    err = lib.qie_quantize_rows_given_bf16(x.data_ptr(), x_q.data_ptr(),
                                           scale.data_ptr(), m, k,
                                           kernels.current_stream_handle(x.device))
    kernels.check(err, "quantize_rows_given")
    kernels.LAUNCHES["quantize_rows"] += 1
    return x_q


# K6's wgmma body: 128 × 256 output tiles, K in 128-byte slabs
BLOCK_M, BLOCK_N, SLAB = 128, 256, 128
MAX_SPLITS = 16
# The split-K cost model, in slab times of one CTA (a slab: 128 × 256 × 128
# bytes of product, about 0.6 µs on an H100): a unit's fixed cost (its
# pipeline drain), a tile's epilogue (for 128 live rows), a split unit's
# partial write, fence and counter, and the last unit's read of each other
# partial (for 128 live rows). Fitted on an H100 SXM to a sweep of every
# split count over the path's small-M shapes (PERF.md §6 gives how far its
# picks are from the sweep's best).
UNIT_SLABS, EPILOGUE_SLABS, PARTIAL_SLABS, REDUCE_SLABS = 1, 1, 4, 4
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """How K6 runs one (M, N, K): ``route`` "wgmma" (K % 16 == 0) or
    "mma_sync"; output tiles of ``block_m`` × ``block_n``; each tile's K in
    ``splits`` ranges of ``kb_per_split`` slabs of ``slab`` bytes (the last
    range may be shorter, none is empty); ``grid`` CTAs (persistent for
    wgmma: one a SM at most)."""

    route: str
    block_m: int
    block_n: int
    slab: int
    splits: int
    kb_per_split: int
    tiles: int
    grid: int

    @property
    def units(self) -> int:
        return self.tiles * self.splits


@functools.lru_cache(maxsize=None)  # a pure function of a few shapes a model
def gemm_plan(m: int, n: int, k: int, sms: int = H100_SMS) -> GemmPlan:
    """K6's plan for x_q (M, K) · w_q (N, K)ᵀ on a card of ``sms`` SMs: the
    mma.sync body where K % 16 != 0; else the wgmma body, with the split of
    K that minimises the modelled time, waves × (slabs a unit + fixed cost
    + epilogue [+ partial write]) + the last unit's reads, the epilogue and
    the reads scaled by the tile's live rows. Splitting pays where few tiles
    each run a long K (txt_fc2, lm_down: 24 and 42 tiles) and costs more
    than it saves where K is short or M = 1."""
    if k % 16:
        tiles = -(-m // 128) * -(-n // 128)
        return GemmPlan("mma_sync", 128, 128, 64, 1, -(-k // 64), tiles, tiles)
    tiles = -(-m // BLOCK_M) * -(-n // BLOCK_N)
    slabs = -(-k // SLAB)
    live = min(m, BLOCK_M) / BLOCK_M  # the share of a tile's rows that are real
    best, best_cost = None, None
    for want in range(1, min(slabs, MAX_SPLITS) + 1):
        per = -(-slabs // want)
        splits = -(-slabs // per)  # no empty range
        if splits != want:
            continue
        waves = -(-(tiles * splits) // sms)
        cost = (waves * (per + UNIT_SLABS + live * EPILOGUE_SLABS
                         + (PARTIAL_SLABS if splits > 1 else 0))
                + live * REDUCE_SLABS * (splits - 1))
        if best_cost is None or cost < best_cost:
            best, best_cost = (splits, per), cost
    splits, per = best
    return GemmPlan("wgmma", BLOCK_M, BLOCK_N, SLAB, splits, per, tiles,
                    min(tiles * splits, sms))


_SMS: Dict[int, int] = {}


def int8_matmul(x_q: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """K6: x_q (M, K) int8, x_scale (M, 1) f32, w_q (N, K) int8, w_scale (N,)
    f32, bias (N,) bf16 or None → (M, N) bf16, bit-identical to
    :func:`int8_matmul_plain`. K must be a multiple of 4; where K % 16 == 0
    (the wgmma body, TMA operands) x_q and w_q must be 16-byte aligned, else
    4-byte aligned."""
    if x_q.device.type == "cpu":
        return int8_matmul_plain(x_q, x_scale, w_q, w_scale, bias, out_dtype)
    dev = x_q.device
    kernels.refuse_grad("int8_matmul", x_scale, w_scale, bias)
    if dev.type != "cuda":
        raise RuntimeError(f"int8_matmul: unsupported device {dev}")
    if out_dtype != torch.bfloat16:
        raise TypeError(f"int8_matmul: output must be bfloat16, got {out_dtype}")
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[1]:
        raise ValueError(f"int8_matmul: x_q {tuple(x_q.shape)}, w_q {tuple(w_q.shape)}")
    m, k = x_q.shape
    n = w_q.shape[0]
    _check("int8_matmul: x_q", x_q, torch.int8, dev)
    _check("int8_matmul: w_q", w_q, torch.int8, dev)
    _check("int8_matmul: x_scale", x_scale, torch.float32, dev)
    _check("int8_matmul: w_scale", w_scale, torch.float32, dev)
    if x_scale.numel() != m or w_scale.numel() != n:
        raise ValueError(f"int8_matmul: scales {tuple(x_scale.shape)}, "
                         f"{tuple(w_scale.shape)} for M={m}, N={n}")
    if bias is not None:
        _check("int8_matmul: bias", bias, torch.bfloat16, dev)
        if bias.numel() != n:
            raise ValueError(f"int8_matmul: bias {tuple(bias.shape)} for N={n}")
    if m == 0 or n == 0 or k == 0 or k % 4 or k > 1 << 17:
        raise ValueError(f"int8_matmul: M={m}, N={n}, K={k}; K must be a "
                         "positive multiple of 4, at most 2^17")
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = gemm_plan(m, n, k, _SMS[dev.index])
    align = 16 if plan.route == "wgmma" else 4
    if x_q.data_ptr() % align or w_q.data_ptr() % align:
        raise ValueError(f"int8_matmul: x_q and w_q must be {align}-byte aligned "
                         f"at K={k}")
    if plan.route == "mma_sync" and -(-m // 128) > 65535:  # grid.y = 128-row tiles
        raise ValueError(f"int8_matmul: M={m} too large")
    lib = kernels.library()
    stream = kernels.current_stream_handle(dev)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    bias_ptr = bias.data_ptr() if bias is not None else None
    if plan.route == "wgmma":
        partials = counters = None
        if plan.splits > 1:
            # the call's own workspace (the stream-aware allocator keeps it
            # from any launch still running on another stream): s32 partials,
            # then one counter a tile, which the launcher zeroes on `stream`
            part_ints = plan.units * BLOCK_M * BLOCK_N
            work = torch.empty(part_ints + plan.tiles, dtype=torch.int32, device=dev)
            partials, counters = work.data_ptr(), work[part_ints:].data_ptr()
        err = lib.qie_int8_gemm_sm90(
            x_q.data_ptr(), x_scale.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
            bias_ptr, out.data_ptr(), partials, counters,
            m, n, k, plan.splits, plan.kb_per_split, plan.grid, stream)
    else:
        err = lib.qie_int8_gemm_mma(
            x_q.data_ptr(), x_scale.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
            bias_ptr, out.data_ptr(), m, n, k, stream)
    kernels.check(err, "int8_matmul")
    kernels.LAUNCHES["int8_gemm"] += 1
    return out


def int8_matmul_acc(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """K6 with its int32 epilogue: x_q (M, K) int8 · w_q (N, K) int8ᵀ → the
    exact (M, N) int32 sums, equal to :func:`int8_matmul_acc_plain`; the
    wgmma body only (K % 16 == 0, 16-byte aligned operands). Counted under
    K6."""
    if x_q.device.type == "cpu":
        return int8_matmul_acc_plain(x_q, w_q)
    dev = x_q.device
    if dev.type != "cuda":
        raise RuntimeError(f"int8_matmul_acc: unsupported device {dev}")
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[1]:
        raise ValueError(f"int8_matmul_acc: x_q {tuple(x_q.shape)}, w_q {tuple(w_q.shape)}")
    _check("int8_matmul_acc: x_q", x_q, torch.int8, dev)
    _check("int8_matmul_acc: w_q", w_q, torch.int8, dev)
    m, k = x_q.shape
    n = w_q.shape[0]
    if m == 0 or n == 0 or k == 0 or k % 16 or k > 1 << 17:
        raise ValueError(f"int8_matmul_acc: M={m}, N={n}, K={k}; K must be a "
                         "positive multiple of 16, at most 2^17")
    if x_q.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("int8_matmul_acc: x_q and w_q must be 16-byte aligned")
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = gemm_plan(m, n, k, _SMS[dev.index])
    lib = kernels.library()
    acc = torch.empty((m, n), dtype=torch.int32, device=dev)
    partials = counters = None
    if plan.splits > 1:
        part_ints = plan.units * BLOCK_M * BLOCK_N
        work = torch.empty(part_ints + plan.tiles, dtype=torch.int32, device=dev)
        partials, counters = work.data_ptr(), work[part_ints:].data_ptr()
    err = lib.qie_int8_gemm_sm90_acc(
        x_q.data_ptr(), w_q.data_ptr(), acc.data_ptr(), partials, counters,
        m, n, k, plan.splits, plan.kb_per_split, plan.grid,
        kernels.current_stream_handle(dev))
    kernels.check(err, "int8_matmul_acc")
    kernels.LAUNCHES["int8_gemm"] += 1
    return acc


def int8_epilogue(acc: torch.Tensor, x_scale: torch.Tensor, w_scale: torch.Tensor,
                  bias: Optional[torch.Tensor], out_dtype) -> torch.Tensor:
    """K6's epilogue on int32 sums: acc (M, N) int32, x_scale (M, 1) f32,
    w_scale (N,) f32, bias (N,) or None → (M, N) ``out_dtype`` (bf16 on the
    card), bit-identical to :func:`int8_epilogue_plain`. Counted under K6."""
    if acc.device.type == "cpu":
        return int8_epilogue_plain(acc, x_scale, w_scale, bias, out_dtype)
    dev = acc.device
    kernels.refuse_grad("int8_epilogue", x_scale, w_scale, bias)
    if dev.type != "cuda":
        raise RuntimeError(f"int8_epilogue: unsupported device {dev}")
    if out_dtype != torch.bfloat16:
        raise TypeError(f"int8_epilogue: output must be bfloat16, got {out_dtype}")
    if acc.dim() != 2:
        raise ValueError(f"int8_epilogue: acc must be (M, N), got {tuple(acc.shape)}")
    m, n = acc.shape
    _check("int8_epilogue: acc", acc, torch.int32, dev)
    _check("int8_epilogue: x_scale", x_scale, torch.float32, dev)
    _check("int8_epilogue: w_scale", w_scale, torch.float32, dev)
    if x_scale.numel() != m or w_scale.numel() != n:
        raise ValueError(f"int8_epilogue: scales {tuple(x_scale.shape)}, "
                         f"{tuple(w_scale.shape)} for M={m}, N={n}")
    if bias is not None:
        _check("int8_epilogue: bias", bias, torch.bfloat16, dev)
        if bias.numel() != n:
            raise ValueError(f"int8_epilogue: bias {tuple(bias.shape)} for N={n}")
    if m == 0 or n == 0:
        raise ValueError(f"int8_epilogue: M={m}, N={n}")
    lib = kernels.library()
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    err = lib.qie_int8_epilogue_bf16(
        acc.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(), m, n,
        kernels.current_stream_handle(dev))
    kernels.check(err, "int8_epilogue")
    kernels.LAUNCHES["int8_gemm"] += 1
    return out


def int8_linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Quantized replacement for ``common.linear``: (..., in) → (..., out)
    in x's dtype. K5 then K6 on a CUDA tensor; their plain versions on the
    CPU."""
    lead = x.shape[:-1]
    x_q, x_scale = quantize_rows(x.reshape(-1, x.shape[-1]).contiguous())
    out = int8_matmul(x_q, x_scale, p["w_q"], p["scale"], p.get("bias"),
                      out_dtype=x.dtype)
    return out.reshape(*lead, -1)


def int8_linear_row(x: torch.Tensor, p: dict, group) -> torch.Tensor:
    """Row-parallel int8 linear over ``group`` (a ``core.meshes.Group``): x
    (..., in/n) holds this rank's slice of each input row and ``p["w_q"]``
    the matching columns. Equal, bit for bit, to the int8 linear of the
    whole row on one device (the JAX ``int8_matmul_xla`` under GSPMD):

    - K5 (:func:`row_scales`) gives the slice's row scales, and their MAX
      over the ranks (an all-reduce) is the whole row's scale: the scale
      grows with the absmax, and the ranks' slices share the row's absmax;
    - K5 (:func:`quantize_rows_given`) writes the one-device codes;
    - K6 (:func:`int8_matmul_acc`) writes the slice's exact int32 sums, and
      the ranks add them (an all-reduce of int32: exact);
    - K6 (:func:`int8_epilogue`) applies the scales, the bias (once) and
      the cast, in K6's order.

    Where the slice's K is not a multiple of 16 (the vision tower's
    3420-wide ``down`` over 2 or 4 ranks), the sharded ``w_q`` holds zero
    columns up to one (``parallel/sharding.py::shard_leaves``) and x gets as
    many, so K6 takes its wgmma body: zero codes add nothing to the sums."""
    from qwen_image_edit_streamdiffusion_tpu_torch.parallel import distributed as dist

    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k).contiguous()
    scale = dist.all_reduce(row_scales(x2), group, op="max")
    pad = p["w_q"].shape[1] - k
    if pad:
        x2 = F.pad(x2, (0, pad))
    acc = dist.all_reduce(int8_matmul_acc(quantize_rows_given(x2, scale), p["w_q"]), group)
    out = int8_epilogue(acc, scale, p["scale"], p.get("bias"), x.dtype)
    return out.reshape(*lead, -1)
