// Causal GQA flash attention forward for Hopper (sm_90a), bf16 in / bf16
// out, f32 softmax.
//
// Replaces the Pallas TPU kernel
//   K2  qwen_image_edit_streamdiffusion_tpu ops/flash_attention.py::
//       _flash_kernel_causal
// the causal GQA attention of the Qwen2.5-VL language model; q head h reads
// kv head h / (H / Hkv); key blocks above the diagonal are never read and
// only diagonal blocks apply the row >= col select. It takes no key mask:
// padding is a suffix, so every padded key lies above a real row's diagonal.
// (The non-causal roles, K1, K4 and K7, run on flash_fwd_sm90.cu.)
//
// Math (the Pallas kernel's rounding points): q is pre-scaled by d^-1/2 ·
// log2(e) and rounded to bf16, scores accumulate in f32, the online softmax
// runs in base 2 with f32 running max m, row sum l and output accumulator,
// P = bf16(exp2(bf16(S − m))) (the exp2 argument at the value precision, as
// the JAX kernel takes it), and l sums the rounded P.
//
// What bounds it on the H100: at the LM's shapes (28 q / 4 kv heads, L ≤
// 1k) a launch does a few GFLOP and is bound by launch latency and the
// tensor cores' fill: at L = 384 it runs at SDPA's time. It is the
// FlashAttention-2 shape on mma.sync: a CTA of 8 warps owns 128 query rows
// (16 per warp) and streams 64-key K/V blocks through a two-stage cp.async
// ring in shared memory; causal CTAs with more key blocks start first. Scores
// stay in registers: the m16n8k16 accumulator layout of S is the A-operand
// layout of P, so the softmax runs on registers with two quad shuffles per
// row and P never touches shared memory. Rows are padded by 16 bytes in
// shared memory so every ldmatrix is free of bank conflicts.

#include "mma_bf16.cuh"

namespace {

using namespace qie;

constexpr int kD = 128;           // head_dim
constexpr int kBQ = 128;          // query rows per CTA
constexpr int kBK = 64;           // keys per block
constexpr int kWarps = kBQ / 16;  // 8 warps, 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kD + 8;       // bf16 row stride of the Q/K/V tiles (272 B)
constexpr int kChunks = kD / 8;   // 16-byte chunks per row
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kQElems = kBQ * kLd;
constexpr int kKVElems = kBK * kLd;
constexpr int kSmemBytes = (kQElems + 4 * kKVElems) * 2;  // Q + 2 × (K, V)

__global__ void __launch_bounds__(kThreads, 2)
flash_causal_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out, int H, int Hkv, int Lq,
                    int Lk, float qscale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k_s = q_s + kQElems;       // two buffers
  __nv_bfloat16* v_s = k_s + 2 * kKVElems;  // two buffers

  // CTAs with more key blocks start first.
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hkv);
  const int q0 = qb * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int mat = lane >> 3;  // which 8x8 matrix this lane addresses
  const int r8 = lane & 7;    // and which of its rows

  const __nv_bfloat16* q_bh = q + (size_t)bh * Lq * kD;
  const __nv_bfloat16* k_bh = k + ((size_t)b * Hkv + kvh) * Lk * kD;
  const __nv_bfloat16* v_bh = v + ((size_t)b * Hkv + kvh) * Lk * kD;

  const int nkb = (Lk + kBK - 1) / kBK;
  const int last = (q0 + kBQ - 1) / kBK + 1;  // blocks any row here sees
  const int kb_end = last < nkb ? last : nkb;

  auto load_kv = [&](int kb, int buf) {
    const int k0 = kb * kBK;
    __nv_bfloat16* kd = k_s + buf * kKVElems;
    __nv_bfloat16* vd = v_s + buf * kKVElems;
    for (int i = tid; i < kBK * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * 8;
      const bool ok = k0 + r < Lk;
      const size_t off = (size_t)(ok ? k0 + r : 0) * kD + c;
      cp_async16(kd + r * kLd + c, k_bh + off, ok);
      cp_async16(vd + r * kLd + c, v_bh + off, ok);
    }
    cp_async_commit();
  };

  if (kb_end > 0) load_kv(0, 0);

  // Q tile, pre-scaled by d^-1/2 · log2(e) and rounded to bf16.
  for (int i = tid; i < kBQ * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Lq)
      raw = *reinterpret_cast<const uint4*>(q_bh + (size_t)(q0 + r) * kD + c);
    const __nv_bfloat162* in2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    uint4 scaled;
    uint32_t* out32 = reinterpret_cast<uint32_t*>(&scaled);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(in2[j]);
      out32[j] = as_u32(__floats2bfloat162_rn(f.x * qscale, f.y * qscale));
    }
    *reinterpret_cast<uint4*>(q_s + r * kLd + c) = scaled;
  }
  __syncthreads();

  // ldmatrix row address of this lane in the warp's 16 Q rows
  const __nv_bfloat16* q_w =
      q_s + (warp * 16 + (mat & 1) * 8 + r8) * kLd + (mat >> 1) * 8;

  const int wrow0 = q0 + warp * 16;  // first query row of this warp
  const int row_lo = wrow0 + g;      // this lane's two rows
  const int row_hi = row_lo + 8;
  float o[kD / 8][4];
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf;
  float l_lo = 0.f, l_hi = 0.f;  // this lane's part of the row sums

  for (int kb = 0; kb < kb_end; ++kb) {
    const int buf = kb & 1;
    if (kb + 1 < kb_end) {
      load_kv(kb + 1, buf ^ 1);  // the other buffer was freed last iteration
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = k_s + buf * kKVElems;
    const __nv_bfloat16* vt = v_s + buf * kKVElems;

    // S = Q_w (16 x 128) · K^T (128 x 64): eight 16x8 f32 tiles.
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t qa[4];
      ldmatrix_x4(qa, q_w + kk * 16);
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t bk[4];  // key tiles 2np, 2np+1 × d halves lo, hi
        ldmatrix_x4(bk, kt + (np * 16 + (mat >> 1) * 8 + r8) * kLd + kk * 16 +
                            (mat & 1) * 8);
        mma_bf16(s[2 * np], qa, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
      }
    }

    // The causal select only where this warp's rows meet the diagonal, and
    // keys past Lk on the ragged tail.
    const int k0 = kb * kBK;
    const bool tail = k0 + kBK > Lk;
    const bool diag = k0 + kBK - 1 > wrow0;
    if (tail || diag) {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + nt * 8 + 2 * t4 + (e & 1);
          const int row = (e < 2) ? row_lo : row_hi;
          const bool dead = col >= Lk || (diag && col > row);
          if (dead) s[nt][e] = kNegInf;
        }
      }
    }

    // Online softmax in base 2; a row's four lanes share its max.
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, d));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, d));
    }
    const float alpha_lo = exp2f(m_lo - mx_lo);
    const float alpha_hi = exp2f(m_hi - mx_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;

    // P = bf16(exp2(bf16(S − m))), packed straight into A fragments for P·V.
    uint32_t pf[kBK / 16][4];
    float ps_lo = 0.f, ps_hi = 0.f;
    auto ex2 = [](float x) {
      return exp2f(__bfloat162float(__float2bfloat16_rn(x)));
    };
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      const __nv_bfloat162 p_lo = __floats2bfloat162_rn(
          ex2(s[nt][0] - mx_lo), ex2(s[nt][1] - mx_lo));
      const __nv_bfloat162 p_hi = __floats2bfloat162_rn(
          ex2(s[nt][2] - mx_hi), ex2(s[nt][3] - mx_hi));
      ps_lo += __low2float(p_lo) + __high2float(p_lo);
      ps_hi += __low2float(p_hi) + __high2float(p_hi);
      pf[nt >> 1][(nt & 1) * 2 + 0] = as_u32(p_lo);
      pf[nt >> 1][(nt & 1) * 2 + 1] = as_u32(p_hi);
    }
    l_lo = l_lo * alpha_lo + ps_lo;
    l_hi = l_hi * alpha_hi + ps_hi;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      o[nt][0] *= alpha_lo;
      o[nt][1] *= alpha_lo;
      o[nt][2] *= alpha_hi;
      o[nt][3] *= alpha_hi;
    }

    // O (16 x 128) += P (16 x 64) · V (64 x 128).
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t bv[4];  // keys lo, hi × d tiles 2dp, 2dp+1
        ldmatrix_x4_trans(bv, vt + (kk * 16 + (mat & 1) * 8 + r8) * kLd +
                                  dp * 16 + (mat >> 1) * 8);
        mma_bf16(o[2 * dp], pf[kk], bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pf[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

#pragma unroll
  for (int d = 1; d <= 2; d <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, d);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, d);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  __nv_bfloat16* o_lo = out + ((size_t)bh * Lq + row_lo) * kD + 2 * t4;
  __nv_bfloat16* o_hi = o_lo + 8 * kD;
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt) {
    if (row_lo < Lq)
      *reinterpret_cast<__nv_bfloat162*>(o_lo + nt * 8) = __floats2bfloat162_rn(
          o[nt][0] * inv_lo, o[nt][1] * inv_lo);
    if (row_hi < Lq)
      *reinterpret_cast<__nv_bfloat162*>(o_hi + nt * 8) = __floats2bfloat162_rn(
          o[nt][2] * inv_hi, o[nt][3] * inv_hi);
  }
}

}  // namespace

// K2: q (B, H, L, 128), k/v (B, Hkv, L, 128) with H % Hkv == 0, out (B, H, L,
// 128), all bf16, contiguous and 16-byte aligned; scale = d^-1/2. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int qie_flash_causal_bf16(const void* q, const void* k,
                                     const void* v, void* out, int B, int H,
                                     int Hkv, int L, float scale,
                                     void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_causal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kBQ - 1) / kBQ, B * H);
  flash_causal_kernel<<<grid, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), H,
      Hkv, L, L, scale * kLog2e);
  return (int)cudaGetLastError();
}
