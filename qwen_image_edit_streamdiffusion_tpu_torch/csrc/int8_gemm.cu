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
// exactly and writes its epilogue with __fmul_rn / __fadd_rn, so nvcc cannot
// contract it into an FMA.
//
// What bounds them on the H100. K5 reads 2 bytes and writes 1 per element
// plus one scale per row: pure bandwidth. One CTA owns one row, takes the
// absmax in f32 with warp shuffles, then re-reads the row (from L1/L2: the
// widest row is 37 KB) to write the codes, 16-byte loads where K % 8 == 0.
// K6 at the MMDiT's image-token shapes (M = 8192, K = 3072/12288) does
// ~0.5 TOP per call on ~40 MB of int8 operands: tensor-core bound. It is the
// classic mma.sync shape: a CTA of 8 warps owns a 128 × 128 output tile, each
// warp 64 × 32 (4 × 4 m16n8k32 tiles, 64 int32 accumulators a thread), and
// 64-byte K slices of both operands stream through a three-stage cp.async
// ring. Both operands are K-major (the port's weight is (out, in)), so one
// ldmatrix.x4 pattern serves A and B, and rows padded to 80 bytes make every
// ldmatrix free of bank conflicts. At M = 1 (the modulation linears, a GEMV
// over 57 MB of weight) the padded rows are zero-filled and never read: the
// kernel streams the weight once, bandwidth bound. Where K % 16 != 0 (the
// vision tower's K = 3420) the loads fall back to 4-byte cp.async, so no
// operand needs padding; the K tail is zero-filled, and zeros add nothing.
// int32 cannot overflow for K <= 2^17. s8 wgmma, TMA and a persistent
// schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global → shared copies; the destination is zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
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
      : "r"(smem_addr(p)));
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

// ---------------------------------------------------------------------------
// K5: row quantize
// ---------------------------------------------------------------------------

constexpr int kQThreads = 256;

__device__ __forceinline__ int8_t to_code(float v, float s) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// VEC: K % 8 == 0 and 16-byte aligned rows — 8 elements a thread per step.
template <bool VEC>
__global__ void __launch_bounds__(kQThreads)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ x,
                     int8_t* __restrict__ xq, float* __restrict__ scale,
                     int K) {
  __shared__ float red[kQThreads / 32];
  const size_t row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * K;
  int8_t* qr = xq + row * K;
  const int tid = threadIdx.x;

  float amax = 0.f;
  if (VEC) {
    for (int c = tid * 8; c < K; c += kQThreads * 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h2[j]);
        amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
      }
    }
  } else {
    for (int c = tid; c < K; c += kQThreads)
      amax = fmaxf(amax, fabsf(__bfloat162float(xr[c])));
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, d));
  if (tid % 32 == 0) red[tid / 32] = amax;
  __syncthreads();
  amax = (tid % 32) < kQThreads / 32 ? red[tid % 32] : 0.f;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, d));

  const float s = __fmul_rn(fmaxf(amax, 1e-8f), 1.f / 127.f);
  if (tid == 0) scale[row] = s;
  if (VEC) {
    for (int c = tid * 8; c < K; c += kQThreads * 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      union {
        int8_t b[8];
        uint2 u;
      } codes;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h2[j]);
        codes.b[2 * j] = to_code(f.x, s);
        codes.b[2 * j + 1] = to_code(f.y, s);
      }
      *reinterpret_cast<uint2*>(qr + c) = codes.u;
    }
  } else {
    for (int c = tid; c < K; c += kQThreads)
      qr[c] = to_code(__bfloat162float(xr[c]), s);
  }
}

// ---------------------------------------------------------------------------
// K6: int8 GEMM
// ---------------------------------------------------------------------------

constexpr int kBM = 128;                      // output rows per CTA
constexpr int kBN = 128;                      // output columns per CTA
constexpr int kBK = 64;                       // K bytes per stage
constexpr int kStages = 3;
constexpr int kGThreads = 256;                // 8 warps: 2 (M) × 4 (N)
constexpr int kLdB = kBK + 16;                // smem row stride, bytes (80)
constexpr int kTileBytes = kBM * kLdB;        // one operand's stage (kBM == kBN)
constexpr int kGemmSmem = kStages * 2 * kTileBytes;  // 61,440 bytes

// One operand's (128 rows × 64 bytes) slice at (r0, k0) of a (R, K) int8
// matrix into shared memory; rows >= R and bytes >= K are zero-filled.
template <bool VEC16>
__device__ __forceinline__ void load_tile(uint8_t* dst,
                                          const int8_t* __restrict__ src,
                                          int R, int K, int r0, int k0,
                                          int tid) {
  constexpr int kChunks = kBK / 16;  // 16-byte chunks per row
#pragma unroll
  for (int i = tid; i < kBM * kChunks; i += kGThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 16;
    const int gr = r0 + r;
    const int gk = k0 + c;
    uint8_t* d = dst + r * kLdB + c;
    if (VEC16) {
      const bool ok = gr < R && gk < K;
      cp_async16(d, src + (ok ? (size_t)gr * K + gk : 0), ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = gr < R && gk + 4 * j < K;
        cp_async4(d + 4 * j, src + (ok ? (size_t)gr * K + gk + 4 * j : 0), ok);
      }
    }
  }
}

// Fragment layout of mma.m16n8k32.s8 (g = lane / 4, t = lane % 4), in bytes:
//   A regs 0..3: (row g, k 4t..4t+3), (g+8, 4t..), (g, 16+4t..), (g+8, 16+4t..);
//   B regs 0..1: (k 4t..4t+3, col g), (k 16+4t.., col g);
//   C/D 0..3:    (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1).
// The byte layout of A and B equals bf16 m16n8k16's, so ldmatrix.b16 loads
// both from K-major rows.
template <bool VEC16>
__global__ void __launch_bounds__(kGThreads, 2)
int8_gemm_kernel(const int8_t* __restrict__ a, const float* __restrict__ xs,
                 const int8_t* __restrict__ b, const float* __restrict__ ws,
                 const __nv_bfloat16* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
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

  const int nkt = (K + kBK - 1) / kBK;
  auto load_stage = [&](int kt) {
    uint8_t* as = smem + (kt % kStages) * 2 * kTileBytes;
    load_tile<VEC16>(as, a, M, K, m0, kt * kBK, tid);
    load_tile<VEC16>(as + kTileBytes, b, N, K, n0, kt * kBK, tid);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nkt) load_stage(s);
    cp_async_commit();  // empty groups keep the count uniform
  }

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; every warp is done with kt - 1
    if (kt + kStages - 1 < nkt) load_stage(kt + kStages - 1);
    cp_async_commit();

    const uint8_t* as = smem + (kt % kStages) * 2 * kTileBytes;
    const uint8_t* bs = as + kTileBytes;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
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

template <bool VEC16>
int launch_gemm(const void* xq, const void* xs, const void* wq, const void* ws,
                const void* bias, void* out, int M, int N, int K,
                cudaStream_t stream) {
  auto kern = int8_gemm_kernel<VEC16>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kern<<<grid, kGThreads, kGemmSmem, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wq), static_cast<const float*>(ws),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out),
      M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) bf16 → xq (M, K) int8, scale (M,) f32; contiguous. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int qie_quantize_rows_bf16(const void* x, void* xq, void* scale,
                                      int M, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = K % 8 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)xq % 8 == 0;
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  int8_t* qp = static_cast<int8_t*>(xq);
  float* sp = static_cast<float*>(scale);
  if (vec)
    quantize_rows_kernel<true><<<M, kQThreads, 0, s>>>(xp, qp, sp, K);
  else
    quantize_rows_kernel<false><<<M, kQThreads, 0, s>>>(xp, qp, sp, K);
  return (int)cudaGetLastError();
}

// xq (M, K) int8, xs (M,) f32, wq (N, K) int8, ws (N,) f32, bias (N,) bf16 or
// null → out (M, N) bf16; contiguous, K % 4 == 0, 4-byte aligned. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int qie_int8_gemm_bf16(const void* xq, const void* xs,
                                  const void* wq, const void* ws,
                                  const void* bias, void* out, int M, int N,
                                  int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 16 == 0 && ((uintptr_t)xq | (uintptr_t)wq) % 16 == 0)
    return launch_gemm<true>(xq, xs, wq, ws, bias, out, M, N, K, s);
  return launch_gemm<false>(xq, xs, wq, ws, bias, out, M, N, K, s);
}
