// The int8 linear for Hopper (sm_90a): row quantize (K5) and int8 GEMM (K6).
//
// Replaces two Pallas TPU kernels of qwen_image_edit_streamdiffusion_tpu:
//   K5  ops/int8.py::_quantize_rows_kernel   (M, K) bf16 → (M, K) int8 codes
//       and (M, 1) f32 scales, scale = max(absmax, 1e-8) · fl(1/127) (XLA
//       compiles the JAX source's "/ 127" into that multiply);
//   K6  ops/int8.py::_int8_gemm_v2_kernel    int8 (M, K) · int8 (N, K)ᵀ →
//       exact int32, epilogue ((acc · x_scale) · w_scale) + bias in f32, one
//       cast to bf16 (the order of int8_matmul_xla, the JAX package's default).
//
// Both are bit-identical to the port's plain versions (ops/int8.py): K5
// divides x by its scale with __fdiv_rn (not a reciprocal) and rounds half to
// even with rintf, and the build uses no --use_fast_math; K6 sums integers
// exactly (in any order, so split-K stays exact and deterministic) and
// writes its epilogue with __fmul_rn / __fadd_rn, so nvcc cannot contract it
// into an FMA.
//
// K5. It reads 2 bytes and writes 1 per element plus one scale per row: pure
// bandwidth (8192 × 3072: 75 MB, 22.5 µs at 3.35 TB/s). One pass: a row is
// read from device memory once, into registers (up to 32 elements a
// thread), reduced to its absmax by warp shuffles (and shared memory across
// the warps of a row), then coded from the same registers. A row takes the
// fewest of 32, 64, ..., 1024 threads that hold it: K = 3072 and 3584 take
// 128 (two rows a 256-thread CTA), 12288 512 and 18944 1024, up to K =
// 32768. A warp a row (128 elements a thread) took 176 registers, one CTA an
// SM, and ran at 36 % of the bound: its loads and its divisions did not
// overlap. Loads are 16 bytes where K % 8 == 0, 8 where K % 4 == 0 (the
// vision tower's 3420), codes are stored 8 or 4 bytes at a time.
//
// K6 at the MMDiT's image-token shapes (M = 8192, K = 3072/12288) does
// 0.15-0.6 TOP per call on 40-60 MB of int8 operands: tensor-core bound
// (img_qkv: 0.234 ms at the 1979 TOP/s int8 peak). Design, on the skeleton of
// flash_fwd_sm90.cu: a persistent CTA a SM walks output tiles of 128 × 256;
// warpgroup 2 is the producer (setmaxnreg down to 40), whose one thread
// issues 2-D TMA loads of 128-byte K slabs (A 16 KB, B 32 KB a stage,
// 128-byte swizzle) into a 4-stage mbarrier ring that runs on across tiles,
// so the next tile's loads overlap this tile's epilogue; warpgroups 0 and 1
// (232 registers) each own 64 rows of the tile and issue
// wgmma.m64n256k32.s32.s8.s8 from shared memory, 128 s32 accumulators a
// thread, one K slab in flight. Both operands are K-major in memory (x_q
// (M, K), w_q (N, K) = (out, in)), which 8-bit wgmma requires. Tiles are
// rastered in groups of 8 column blocks, so the CTAs in flight share a few
// weight panels and activation panels in the 50 MB L2. Rows past M or N and
// bytes past K arrive as TMA's zero fill. The epilogue runs from registers
// (the wgmma accumulator layout, sm90.cuh): the tile's row and column scales
// and bias are loaded before its main loop (the columns' through shared
// memory), so no load latency is left in it, and a 4 × 4 transpose across
// each quad of lanes turns the accumulator's column pairs into 16-byte
// stores of eight columns where N % 8 == 0. At img_qkv's shape on an H100
// SXM the kernel takes 0.36 ms; with its scale loads inside the epilogue
// and 4-byte stores it took 0.47.
//
// Split-K (M = 256 / 384 / 784: the text stream, the VL LM, the vision
// tower): where the tiles would not fill the SMs, ops/int8.py::gemm_plan
// gives each tile `splits` K ranges of kb_per_split slabs. Each (tile,
// split) unit writes its s32 partial sums to a workspace in fragment order
// (coalesced), fences and counts itself on the tile's counter; the unit that
// arrives last adds the other partials (exact integer sums) into its
// registers and runs the epilogue. Partials and counters are the call's own
// workspace (the counters zeroed by a memset on the launch's stream), so
// launches on other streams or in CUDA graphs never share them. One kernel,
// no atomics on the data.
//
// Row-parallel linears (tensor parallelism, parallel/sharding.py) take two
// entries of each. K5: the row scales of the rank's slice alone
// (qie_row_scales_bf16), whose MAX over the ranks is the whole row's scale,
// then the codes of that scale (qie_quantize_rows_given_bf16), equal to one
// device's bit for bit. K6: the exact int32 sums alone
// (qie_int8_gemm_sm90_acc: no scales, no bias), which the ranks add, then
// the epilogue on the sums (qie_int8_epilogue_bf16, the wgmma body's order
// and roundings), so the output equals one device's too.
//
// Where K % 16 != 0 (the vision tower's `down`, K = 3420; the int4 rung's
// only K5/K6 use) TMA cannot take the operands (its row strides are
// multiples of 16 bytes), and the wrapper takes the earlier mma.sync body
// instead: 128 × 128 tiles, m16n8k32, a three-stage ring of 4-byte cp.async.
// int32 cannot overflow for K <= 2^17 (|acc| <= 127² · K).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace qie::sm90;

// ---------------------------------------------------------------------------
// K5: row quantize, one pass
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_code(float v, float s) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(r)) & 0xffu;
}

// VEC bf16 elements a load (8: 16 bytes, 4: 8 bytes, 1); TPR threads own a
// row and hold all of it in registers, up to kCap elements a thread: few
// enough registers that several CTAs share an SM, so one CTA's loads
// overlap another's arithmetic.
constexpr int kCap = 32;
template <int VEC>
struct RowVec;
template <>
struct RowVec<8> {
  using T = uint4;
};
template <>
struct RowVec<4> {
  using T = uint2;
};
template <>
struct RowVec<1> {
  using T = unsigned short;
};

__host__ __device__ constexpr int row_cta_threads(int tpr) {
  return tpr > 256 ? tpr : 256;
}

template <int VEC, int TPR>
__global__ void __launch_bounds__(row_cta_threads(TPR))
quantize_rows_kernel(const __nv_bfloat16* __restrict__ x,
                     int8_t* __restrict__ xq, float* __restrict__ scale,
                     const float* __restrict__ given, int M, int K) {
  using T = typename RowVec<VEC>::T;
  constexpr int kChunks = kCap / VEC;
  constexpr int kThreads = row_cta_threads(TPR);
  constexpr int kWarps = TPR / 32;  // warps a row
  __shared__ float red[kThreads / 32];
  const int lt = threadIdx.x % TPR;
  const int rr = threadIdx.x / TPR;  // the CTA's row this thread works on
  const size_t row = (size_t)blockIdx.x * (kThreads / TPR) + rr;
  const bool live = row < (size_t)M;
  const int nchunks = K / VEC;
  const T* xr = reinterpret_cast<const T*>(x + row * K);

  T v[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int i = c * TPR + lt;
    if (live && i < nchunks) {
      v[c] = xr[i];
    } else {
      v[c] = T{};  // zeros: |0| adds nothing to the absmax
    }
  }
  float s = 0.f;
  if (given == nullptr) {  // uniform over the grid: the barrier below is too
    float amax = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const uint16_t* h = reinterpret_cast<const uint16_t*>(&v[c]);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        amax = fmaxf(amax, fabsf(__uint_as_float((uint32_t)h[e] << 16)));
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, d));
    if constexpr (kWarps > 1) {
      if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kWarps; ++w) amax = fmaxf(amax, red[rr * kWarps + w]);
    }
    s = __fmul_rn(fmaxf(amax, 1e-8f), 1.f / 127.f);
  }
  if (!live) return;

  if (given != nullptr) {
    s = given[row];  // the row's scale over all ranks' slices of the row
  } else if (lt == 0) {
    scale[row] = s;
  }
  if (xq == nullptr) return;  // the scales alone
  int8_t* qr = xq + row * K;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int i = c * TPR + lt;
    if (i >= nchunks) break;
    const uint16_t* h = reinterpret_cast<const uint16_t*>(&v[c]);
    uint32_t w[(VEC + 3) / 4] = {};
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      w[e / 4] |= to_code(__uint_as_float((uint32_t)h[e] << 16), s) << (8 * (e % 4));
    if constexpr (VEC == 8) {
      reinterpret_cast<uint2*>(qr)[i] = make_uint2(w[0], w[1]);
    } else if constexpr (VEC == 4) {
      reinterpret_cast<uint32_t*>(qr)[i] = w[0];
    } else {
      qr[i] = static_cast<int8_t>(w[0]);
    }
  }
}

template <int VEC, int TPR>
int launch_quantize(const void* x, void* xq, void* scale, const void* given,
                    int M, int K, cudaStream_t s) {
  constexpr int kThreads = row_cta_threads(TPR);
  constexpr int kRows = kThreads / TPR;
  quantize_rows_kernel<VEC, TPR><<<(M + kRows - 1) / kRows, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(scale), static_cast<const float*>(given), M, K);
  return (int)cudaGetLastError();
}

// The fewest threads a row that hold it (VEC divides K, so a row is whole
// VEC-wide loads): a warp up to K = 1024, a CTA of 1024 threads up to 32768.
template <int VEC>
int launch_quantize_vec(const void* x, void* xq, void* scale, const void* given,
                        int M, int K, cudaStream_t s) {
  if (K <= 32 * kCap) return launch_quantize<VEC, 32>(x, xq, scale, given, M, K, s);
  if (K <= 64 * kCap) return launch_quantize<VEC, 64>(x, xq, scale, given, M, K, s);
  if (K <= 128 * kCap) return launch_quantize<VEC, 128>(x, xq, scale, given, M, K, s);
  if (K <= 256 * kCap) return launch_quantize<VEC, 256>(x, xq, scale, given, M, K, s);
  if (K <= 512 * kCap) return launch_quantize<VEC, 512>(x, xq, scale, given, M, K, s);
  if (K <= 1024 * kCap) return launch_quantize<VEC, 1024>(x, xq, scale, given, M, K, s);
  return (int)cudaErrorInvalidValue;
}

int quantize_entry(const void* x, void* xq, void* scale, const void* given,
                   int M, int K, cudaStream_t s) {
  const uintptr_t px = (uintptr_t)x, pq = (uintptr_t)xq;
  if (K % 8 == 0 && px % 16 == 0 && pq % 8 == 0)
    return launch_quantize_vec<8>(x, xq, scale, given, M, K, s);
  if (K % 4 == 0 && px % 8 == 0 && pq % 4 == 0)
    return launch_quantize_vec<4>(x, xq, scale, given, M, K, s);
  return launch_quantize_vec<1>(x, xq, scale, given, M, K, s);
}

// ---------------------------------------------------------------------------
// K6: int8 GEMM on wgmma + TMA (K % 16 == 0)
// ---------------------------------------------------------------------------

constexpr int kBM = 128;                       // output rows a tile
constexpr int kBN = 256;                       // output columns a tile
constexpr int kBK = 128;                       // K bytes a stage (one slab)
constexpr int kStages = 4;
constexpr int kThreads = 384;                  // 2 consumer warpgroups + producer
constexpr int kABytes = kBM * kBK;             // 16 KB
constexpr int kBBytes = kBN * kBK;             // 32 KB
constexpr int kBOff = kStages * kABytes;
constexpr int kBarOff = kBOff + kStages * kBBytes;   // 196,608
constexpr int kEpiOff = kBarOff + 128;         // after the barriers and the flag
constexpr int kSmemBytes = kEpiOff + 2 * 2 * kBN * 4 + 1024;
constexpr int kGroupN = 8;                     // column blocks a raster group
constexpr int kPartInts = 256 * 128;           // one unit's partials, s32

// (row block, column block) of output tile t. Tiles run in groups of
// kGroupN column blocks; within a group the column block runs fastest, so
// the tiles in flight at once share a few activation and weight panels.
__device__ __forceinline__ void tile_coords(int t, int tiles_m, int tiles_n,
                                            int& mb, int& nb) {
  const int per_group = kGroupN * tiles_m;
  const int group = t / per_group;
  const int first_n = group * kGroupN;
  const int gn = min(kGroupN, tiles_n - first_n);
  const int local = t - group * per_group;
  mb = local / gn;
  nb = first_n + local % gn;
}

__global__ void __launch_bounds__(kThreads, 1)
int8_gemm_sm90_kernel(const __grid_constant__ CUtensorMap a_map,
                      const __grid_constant__ CUtensorMap b_map,
                      const float* __restrict__ xs, const float* __restrict__ ws,
                      const __nv_bfloat16* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int* __restrict__ acc_out,
                      int* __restrict__ partials,
                      int* __restrict__ counters, int M, int N, int tiles_m,
                      int tiles_n, int splits, int kb_total, int kb_per_split,
                      bool pairs, bool wide) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t a_s = base;
  const uint32_t b_s = base + kBOff;
  const uint32_t bars = base + kBarOff;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  volatile int* last_flag =
      reinterpret_cast<volatile int*>(smem + kBarOff + 16 * kStages);
  const int units = tiles_m * tiles_n * splits;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // a lane of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer: one thread issues every TMA load ------------
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      tma_prefetch_map(&a_map);
      tma_prefetch_map(&b_map);
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int tile = u / splits;
        const int kb0 = (u - tile * splits) * kb_per_split;
        const int kb1 = min(kb0 + kb_per_split, kb_total);
        int mb, nb;
        tile_coords(tile, tiles_m, tiles_n, mb, nb);
        for (int kb = kb0; kb < kb1; ++kb, ++it) {
          const int st = it % kStages;
          mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(full(st), kABytes + kBBytes);
          tma_load_2d(a_s + st * kABytes, &a_map, full(st), kb * kBK, mb * kBM);
          tma_load_2d(b_s + st * kBBytes, &b_map, full(st), kb * kBK, nb * kBN);
        }
      }
    }
    return;
  }

  // ---------------- consumers: 64 rows × 256 columns each -------------------
  regs_alloc<232>();
  const int ct = threadIdx.x;  // 0..255
  const int warp = (ct % 128) / 32;
  const int lane = ct % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  int acc[128];
  int it = 0;
  for (int u = blockIdx.x, uu = 0; u < units; u += gridDim.x, ++uu) {
    const int tile = u / splits;
    const int split = u - tile * splits;
    const int kb0 = split * kb_per_split;
    const int kb1 = min(kb0 + kb_per_split, kb_total);
    int mb, nb;
    tile_coords(tile, tiles_m, tiles_n, mb, nb);
    // This thread's rows: register 4j + e is row row_lo + 8·(e / 2), column
    // 8j + 2·t4 + e % 2 of the tile (the wgmma accumulator layout, sm90.cuh).
    const int row_lo = mb * kBM + wg * 64 + warp * 16 + g;
    const bool live_lo = row_lo < M;
    const bool live_hi = row_lo + 8 < M;
    // The epilogue's scales and bias, loaded now, so that their latency
    // passes under the main loop: the row scales of this thread's rows, and
    // the column scale and bias of column ct of the tile, which reach the
    // other threads through shared memory.
    const bool scaled = acc_out == nullptr;
    const float xs_lo = scaled && live_lo ? __ldg(xs + row_lo) : 0.f;
    const float xs_hi = scaled && live_hi ? __ldg(xs + row_lo + 8) : 0.f;
    const int c_own = nb * kBN + ct;
    const float ws_own = scaled && c_own < N ? __ldg(ws + c_own) : 0.f;
    const float b_own =
        bias != nullptr && c_own < N ? __bfloat162float(bias[c_own]) : 0.f;

#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    int prev = 0;
    for (int kb = kb0; kb < kb1; ++kb, ++it) {
      const int st = it % kStages;
      mbar_wait(full(st), (it / kStages) & 1);
      fence_regs(acc);
      wgmma_fence();
      const uint32_t a = a_s + st * kABytes + wg * 8192;  // this warpgroup's 64 rows
      const uint32_t b = b_s + st * kBBytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_ss_m64n256k32_s8(acc, desc_sw128(a + kk * 32, 16, 1024),
                               desc_sw128(b + kk * 32, 16, 1024), 1);
      wgmma_commit();
      if (kb > kb0) {  // the last slab's products have read their stage
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty(prev));
      }
      prev = st;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty(prev));

    if (splits > 1) {
      // partial sums of the live rows out in fragment order; the last unit
      // of the tile adds the others and writes the tile
      int* part = partials + (size_t)u * kPartInts + ct;
#pragma unroll
      for (int i = 0; i < 128; ++i)
        if (i & 2 ? live_hi : live_lo) __stcg(part + i * 256, acc[i]);
      __threadfence();
      named_barrier(1, 256);
      if (ct == 0) *last_flag = atomicAdd(counters + tile, 1) == splits - 1;
      named_barrier(1, 256);
      if (!*last_flag) continue;
      __threadfence();
      for (int sp = 0; sp < splits; ++sp) {
        if (sp == split || !live_lo) continue;
        const int* q = partials + (size_t)(tile * splits + sp) * kPartInts + ct;
#pragma unroll
        for (int i = 0; i < 128; ++i)
          if (i & 2 ? live_hi : live_lo) acc[i] += __ldcg(q + i * 256);
      }
    }

    if (!scaled) {
      // The exact int32 sums of the live rows, no epilogue: a row-parallel
      // caller adds the ranks' sums first (uniform over the grid, so no
      // thread waits at the barrier below without the others).
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (!(half ? live_hi : live_lo)) continue;
        int* orow = acc_out + (size_t)(row_lo + 8 * half) * N;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int col = nb * kBN + 8 * j + 2 * t4;
          if (col >= N) continue;
          const int a0 = acc[4 * j + 2 * half], a1 = acc[4 * j + 2 * half + 1];
          if (pairs) {
            *reinterpret_cast<int2*>(orow + col) = make_int2(a0, a1);
          } else {
            orow[col] = a0;
            if (col + 1 < N) orow[col + 1] = a1;
          }
        }
      }
      continue;
    }

    // The tile's column scales and biases, one buffer of two a unit: the
    // barrier after the writes also keeps every thread's reads of the
    // buffer two units back behind them.
    float* cw = reinterpret_cast<float*>(smem + kEpiOff) + (uu & 1) * 2 * kBN;
    float* cb = cw + kBN;
    cw[ct] = ws_own;
    cb[ct] = b_own;
    named_barrier(1, 256);
    if (mb * kBM + wg * 64 + warp * 16 >= M) continue;  // the warp's rows: all past M

    // Epilogue in f32, the plain version's order, no contraction.
    auto y = [&](int j, int half, int e) {
      const int c = 8 * j + 2 * t4 + e;
      float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * half + e]),
                                    half ? xs_hi : xs_lo),
                          cw[c]);
      if (bias != nullptr) v = __fadd_rn(v, cb[c]);
      return v;
    };
    if (wide) {
      // Two column groups (j, j + 1) of the quad's two rows: lane t4 holds
      // column pair t4 of each; a 4 × 4 transpose across the quad (two
      // xor-shuffle steps) gives lane q the eight columns of one group of
      // one row, stored as 16 bytes.
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        uint32_t r[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const __nv_bfloat162 h = __floats2bfloat162_rn(y(j + (q & 1), q >> 1, 0),
                                                         y(j + (q & 1), q >> 1, 1));
          r[q] = *reinterpret_cast<const uint32_t*>(&h);
        }
#pragma unroll
        for (int s = 1; s <= 2; s <<= 1) {
          const bool upper = t4 & s;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (q & s) continue;
            const uint32_t got =
                __shfl_xor_sync(0xffffffffu, upper ? r[q] : r[q | s], s);
            if (upper) {
              r[q] = got;
            } else {
              r[q | s] = got;
            }
          }
        }
        const int row = row_lo + 8 * (t4 >> 1);
        const int col = nb * kBN + 8 * (j + (t4 & 1));
        if ((t4 >> 1 ? live_hi : live_lo) && col < N)
          *reinterpret_cast<uint4*>(out + (size_t)row * N + col) =
              make_uint4(r[0], r[1], r[2], r[3]);
      }
      continue;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!(half ? live_hi : live_lo)) continue;
      __nv_bfloat16* orow = out + (size_t)(row_lo + 8 * half) * N;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = nb * kBN + 8 * j + 2 * t4;
        if (col >= N) continue;
        const float v0 = y(j, half, 0), v1 = y(j, half, 1);
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          orow[col] = __float2bfloat16_rn(v0);
          if (col + 1 < N) orow[col + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K6 where K % 16 != 0: the mma.sync body with 4-byte copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d (16x8 s32) += a (16x32 s8, row) · b (32x8 s8, col)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kMBM = 128;                     // output rows per CTA
constexpr int kMBN = 128;                     // output columns per CTA
constexpr int kMBK = 64;                      // K bytes per stage
constexpr int kMStages = 3;
constexpr int kMThreads = 256;                // 8 warps: 2 (M) × 4 (N)
constexpr int kLdB = kMBK + 16;               // smem row stride, bytes (80)
constexpr int kTileBytes = kMBM * kLdB;       // one operand's stage (kMBM == kMBN)
constexpr int kMmaSmem = kMStages * 2 * kTileBytes;  // 61,440 bytes

// One operand's (128 rows × 64 bytes) slice at (r0, k0) of a (R, K) int8
// matrix into shared memory, 4 bytes a copy; rows >= R and bytes >= K are
// zero-filled.
__device__ __forceinline__ void load_tile(uint8_t* dst,
                                          const int8_t* __restrict__ src,
                                          int R, int K, int r0, int k0,
                                          int tid) {
  constexpr int kChunks = kMBK / 16;  // 16-byte chunks per row
#pragma unroll
  for (int i = tid; i < kMBM * kChunks; i += kMThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 16;
    const int gr = r0 + r;
    const int gk = k0 + c;
    uint8_t* d = dst + r * kLdB + c;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = gr < R && gk + 4 * j < K;
      cp_async4(d + 4 * j, src + (ok ? (size_t)gr * K + gk + 4 * j : 0), ok);
    }
  }
}

// Fragment layout of mma.m16n8k32.s8 (g = lane / 4, t = lane % 4), in bytes:
//   A regs 0..3: (row g, k 4t..4t+3), (g+8, 4t..), (g, 16+4t..), (g+8, 16+4t..);
//   B regs 0..1: (k 4t..4t+3, col g), (k 16+4t.., col g);
//   C/D 0..3:    (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1).
// The byte layout of A and B equals bf16 m16n8k16's, so ldmatrix.b16 loads
// both from K-major rows, padded to 80 bytes: no bank conflicts.
__global__ void __launch_bounds__(kMThreads, 2)
int8_gemm_mma_kernel(const int8_t* __restrict__ a, const float* __restrict__ xs,
                     const int8_t* __restrict__ b, const float* __restrict__ ws,
                     const __nv_bfloat16* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int n0 = blockIdx.x * kMBN;
  const int m0 = blockIdx.y * kMBM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int mat = lane >> 3;  // which 8x8 matrix this lane addresses
  const int r8 = lane & 7;    // and which of its rows
  const int wm = warp >> 2;   // 64-row half of the tile
  const int wn = warp & 3;    // 32-column quarter of the tile

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;

  const int nkt = (K + kMBK - 1) / kMBK;
  auto load_stage = [&](int kt) {
    uint8_t* as = smem + (kt % kMStages) * 2 * kTileBytes;
    load_tile(as, a, M, K, m0, kt * kMBK, tid);
    load_tile(as + kTileBytes, b, N, K, n0, kt * kMBK, tid);
  };

#pragma unroll
  for (int s = 0; s < kMStages - 1; ++s) {
    if (s < nkt) load_stage(s);
    cp_async_commit();  // empty groups keep the count uniform
  }

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<kMStages - 2>();
    __syncthreads();  // stage kt landed; every warp is done with kt - 1
    if (kt + kMStages - 1 < nkt) load_stage(kt + kMStages - 1);
    cp_async_commit();

    const uint8_t* as = smem + (kt % kMStages) * 2 * kTileBytes;
    const uint8_t* bs = as + kTileBytes;
#pragma unroll
    for (int ks = 0; ks < kMBK / 32; ++ks) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], as + (wm * 64 + mi * 16 + (mat & 1) * 8 + r8) * kLdB +
                                ks * 32 + (mat >> 1) * 16);
      uint32_t bf[2][4];  // column tiles 2np, 2np+1 × k halves lo, hi
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4(bf[np], bs + (wn * 32 + np * 16 + (mat >> 1) * 8 + r8) * kLdB +
                                ks * 32 + (mat & 1) * 16);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma_s8(acc[mi][2 * np], af[mi], bf[np][0], bf[np][1]);
          mma_s8(acc[mi][2 * np + 1], af[mi], bf[np][2], bf[np][3]);
        }
    }
  }
  cp_async_wait<0>();

  // Epilogue in f32, the plain version's order, no contraction.
  const bool even_n = (N & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
      if (row >= M) continue;
      const float xsr = xs[row];
      __nv_bfloat16* orow = out + (size_t)row * N;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * t4;
        if (col >= N) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = col + e < N ? col + e : col;
          float y = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][half * 2 + e]),
                                        xsr),
                              ws[c]);
          if (bias != nullptr) y = __fadd_rn(y, __bfloat162float(bias[c]));
          v[e] = y;
        }
        if (even_n) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(v[0], v[1]);
        } else {
          orow[col] = __float2bfloat16_rn(v[0]);
          if (col + 1 < N) orow[col + 1] = __float2bfloat16_rn(v[1]);
        }
      }
    }
  }
}

}  // namespace

// x (M, K) bf16 → xq (M, K) int8, scale (M,) f32; contiguous; K <= 32768.
// Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a K it does not take.
extern "C" int qie_quantize_rows_bf16(const void* x, void* xq, void* scale,
                                      int M, int K, void* stream) {
  return quantize_entry(x, xq, scale, nullptr, M, K,
                        static_cast<cudaStream_t>(stream));
}

// K5's row scales alone: x (M, K) bf16 → scale (M,) f32, max(absmax,
// 1e-8) · fl(1/127), no codes written. One rounding of a product by a
// positive constant never decreases as the absmax grows, so the MAX of the
// scales of a row's slices is the scale of the whole row.
extern "C" int qie_row_scales_bf16(const void* x, void* scale, int M, int K,
                                   void* stream) {
  return quantize_entry(x, nullptr, scale, nullptr, M, K,
                        static_cast<cudaStream_t>(stream));
}

// K5 with the row scales given, (M,) f32 (a row-parallel linear's scales of
// the whole row, max(absmax over every rank's slice, 1e-8) · fl(1/127)):
// x (M, K) bf16 → xq (M, K) int8 only, the codes of the given scales.
extern "C" int qie_quantize_rows_given_bf16(const void* x, void* xq,
                                            const void* scale, int M, int K,
                                            void* stream) {
  return quantize_entry(x, xq, nullptr, scale, M, K,
                        static_cast<cudaStream_t>(stream));
}

// The wgmma body, K % 16 == 0: xq (M, K) int8, xs (M,) f32, wq (N, K) int8,
// ws (N,) f32, bias (N,) bf16 or null → out (M, N) bf16; contiguous, xq and
// wq 16-byte aligned. The plan (ops/int8.py::gemm_plan): `splits` K ranges
// of kb_per_split 128-byte slabs a tile, covering ceil(K / 128) slabs with
// none empty; `grid` persistent CTAs. With splits > 1, `partials` holds
// tiles · splits · 32768 int32 and `counters` tiles int32, both of this call
// alone (the counters are zeroed here, on `stream`, before the launch).
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a plan or operand it does not take.
static int int8_gemm_sm90(const void* xq, const void* xs, const void* wq,
                          const void* ws, const void* bias, void* out,
                          void* acc_out, void* partials, void* counters, int M,
                          int N, int K, int splits, int kb_per_split, int grid,
                          void* stream) {
  const int kb_total = (K + kBK - 1) / kBK;
  if (K % 16 != 0 || ((uintptr_t)xq | (uintptr_t)wq) % 16 != 0 || splits < 1 ||
      kb_per_split < 1 || (splits - 1) * kb_per_split >= kb_total ||
      splits * kb_per_split < kb_total || grid < 1 ||
      (splits > 1 && (partials == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap am, bm;
  if (!make_map_s8(&am, xq, M, K, kBM) || !make_map_s8(&bm, wq, N, K, kBN))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_m = (M + kBM - 1) / kBM;
  const int tiles_n = (N + kBN - 1) / kBN;
  if (splits > 1) {
    err = cudaMemsetAsync(counters, 0, sizeof(int) * tiles_m * tiles_n,
                          static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
  }
  // a column pair as one bf16x2 (int2) store, eight bf16 columns of a row
  // as 16 bytes
  const bool pairs = acc_out != nullptr
                         ? N % 2 == 0 && (uintptr_t)acc_out % 8 == 0
                         : N % 2 == 0 && (uintptr_t)out % 4 == 0;
  const bool wide = acc_out == nullptr && N % 8 == 0 && (uintptr_t)out % 16 == 0;
  int8_gemm_sm90_kernel<<<grid, kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      am, bm, static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out),
      static_cast<int*>(acc_out), static_cast<int*>(partials),
      static_cast<int*>(counters), M, N, tiles_m, tiles_n, splits, kb_total,
      kb_per_split, pairs, wide);
  return (int)cudaGetLastError();
}

extern "C" int qie_int8_gemm_sm90(const void* xq, const void* xs, const void* wq,
                                  const void* ws, const void* bias, void* out,
                                  void* partials, void* counters, int M, int N,
                                  int K, int splits, int kb_per_split, int grid,
                                  void* stream) {
  if (xs == nullptr || ws == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  return int8_gemm_sm90(xq, xs, wq, ws, bias, out, nullptr, partials, counters,
                        M, N, K, splits, kb_per_split, grid, stream);
}

// The wgmma body with the int32 epilogue: xq (M, K) int8 · wq (N, K) int8ᵀ →
// acc (M, N) int32, the exact sums and nothing else (no scales, no bias),
// for a row-parallel linear that sums them over its ranks before the f32
// epilogue. Plan, workspace and returns as qie_int8_gemm_sm90.
extern "C" int qie_int8_gemm_sm90_acc(const void* xq, const void* wq, void* acc,
                                      void* partials, void* counters, int M,
                                      int N, int K, int splits, int kb_per_split,
                                      int grid, void* stream) {
  if (acc == nullptr) return (int)cudaErrorInvalidValue;
  return int8_gemm_sm90(xq, nullptr, wq, nullptr, nullptr, nullptr, acc,
                        partials, counters, M, N, K, splits, kb_per_split, grid,
                        stream);
}

// K6's epilogue on int32 sums (a row-parallel linear's, after the ranks'
// all-reduce): out = bf16(((float(acc) · xs[row]) · ws[col]) + bias[col]),
// the wgmma body's order and roundings. One thread eight columns of a row:
// two 16-byte loads of the sums, one 16-byte store where N % 8 == 0 and the
// operands are 16-byte aligned.
template <bool kVec>
__global__ void __launch_bounds__(256)
int8_epilogue_kernel(const int* __restrict__ acc, const float* __restrict__ xs,
                     const float* __restrict__ ws,
                     const __nv_bfloat16* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int M, int N) {
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (c0 >= N) return;
  for (int row = blockIdx.y; row < M; row += gridDim.y) {
    const float sx = __ldg(xs + row);
    const size_t base = (size_t)row * N + c0;
    if constexpr (kVec) {
      const int4 a0 = *reinterpret_cast<const int4*>(acc + base);
      const int4 a1 = *reinterpret_cast<const int4*>(acc + base + 4);
      const float4 w0 = __ldg(reinterpret_cast<const float4*>(ws + c0));
      const float4 w1 = __ldg(reinterpret_cast<const float4*>(ws + c0 + 4));
      const int a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = __fmul_rn(__fmul_rn(__int2float_rn(a[e]), sx), w[e]);
      if (bias != nullptr) {
        const uint4 b = __ldg(reinterpret_cast<const uint4*>(bias + c0));
        const __nv_bfloat16* bh = reinterpret_cast<const __nv_bfloat16*>(&b);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(v[e], __bfloat162float(bh[e]));
      }
      uint4 o;
      __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int p = 0; p < 4; ++p) oh[p] = __floats2bfloat162_rn(v[2 * p], v[2 * p + 1]);
      *reinterpret_cast<uint4*>(out + base) = o;
    } else {
      for (int e = 0; e < 8 && c0 + e < N; ++e) {
        float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[base + e]), sx), ws[c0 + e]);
        if (bias != nullptr) v = __fadd_rn(v, __bfloat162float(bias[c0 + e]));
        out[base + e] = __float2bfloat16_rn(v);
      }
    }
  }
}

// acc (M, N) int32, xs (M,) f32, ws (N,) f32, bias (N,) bf16 or null → out
// (M, N) bf16. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int qie_int8_epilogue_bf16(const void* acc, const void* xs,
                                      const void* ws, const void* bias, void* out,
                                      int M, int N, void* stream) {
  if (M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const bool vec = N % 8 == 0 &&
                   (((uintptr_t)acc | (uintptr_t)ws | (uintptr_t)bias |
                     (uintptr_t)out) % 16) == 0;
  const int threads = (N + 7) / 8;  // one a group of eight columns
  const dim3 grid((threads + 255) / 256, M < 65535 ? M : 65535);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(acc);
  const float* x = static_cast<const float*>(xs);
  const float* w = static_cast<const float*>(ws);
  const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(bias);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (vec) {
    int8_epilogue_kernel<true><<<grid, 256, 0, s>>>(a, x, w, b, o, M, N);
  } else {
    int8_epilogue_kernel<false><<<grid, 256, 0, s>>>(a, x, w, b, o, M, N);
  }
  return (int)cudaGetLastError();
}

// The mma.sync body, any K % 4 == 0 (the wrapper takes it where K % 16 != 0):
// operands as above, 4-byte aligned. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int qie_int8_gemm_mma(const void* xq, const void* xs, const void* wq,
                                 const void* ws, const void* bias, void* out,
                                 int M, int N, int K, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kMBN - 1) / kMBN, (M + kMBM - 1) / kMBM);
  int8_gemm_mma_kernel<<<grid, kMThreads, kMmaSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wq), static_cast<const float*>(ws),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out),
      M, N, K);
  return (int)cudaGetLastError();
}
