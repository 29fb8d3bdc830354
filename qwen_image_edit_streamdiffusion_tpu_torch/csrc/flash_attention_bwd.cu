// Flash-attention backward for Hopper (sm_90a): bf16 in, f32 gradients out.
//
// Replaces two Pallas TPU kernels of qwen_image_edit_streamdiffusion_tpu:
//   K8  ops/flash_attention.py::_flash_bwd_dq_kernel   → flash_bwd_dq_kernel
//   K9  ops/flash_attention.py::_flash_bwd_dkv_kernel  → flash_bwd_dkv_kernel
// the backward of the trainable joint attention (H == Hkv) whose forward is
// K7 (flash_attention.cu with LSE = true).
//
// Math (the JAX kernels'): q arrives pre-scaled by d^-1/2 · log2(e) and
// rounded to bf16 exactly as K7 rounds it, so S2 = Q_pre · K^T is the
// forward's score; P = exp2(S2 − LSE2) is recomputed per block from the saved
// LSE2 (never stored); dP = dO · V^T; dS = P ⊙ (dP − Δ) with Δ = rowsum(dO ⊙ O)
// computed outside; then
//   dQ = (dS · scale).bf16 · K          (K8, scale = d^-1/2)
//   dK = (dS · ln2).bf16^T · Q_pre      (K9; ln2 undoes the log2(e) of Q_pre)
//   dV = P.bf16^T · dO                  (K9)
// Masked keys get the score −1e30 as in the forward: the (B, Lk) key mask is
// read only where mask_applies (mma_bf16.cuh) says so, the rule K7
// (flash_fwd_sm90.cu) applies, so a masked key's P is exactly 0 and so are
// its dK and dV rows.
//
// Two kernels and no atomics, as in the JAX package, so the result is
// deterministic: K8 gives a CTA 64 query rows of one (batch, head) and loops
// over 64-key blocks; K9 gives a CTA 128 keys and loops over 32-row query
// blocks. Both run mma.sync m16n8k16 on bf16 with f32 accumulators in
// registers and a two-stage cp.async ring in shared memory; each product's f32
// accumulator, rounded to bf16, is the A operand of the next (mma_bf16.cuh),
// so S, P, dP and dS never leave registers.
//
// What bounds it on the H100: at the MMDiT's training shape (2 × 24 heads,
// L = 8448, d = 128) K8 does 6·L²·d and K9 8·L²·d flops per head on a few
// hundred MB, thousands of FLOP per byte of HBM: tensor-core bound, fed from
// L2 through shared memory at 128 FLOP per byte per re-read tile. K8 keeps
// dQ (16 × 128 f32 a warp) and K9 dK and dV (2 × 16 × 128 f32 a warp) in
// registers for the whole sweep; K9's 32-row inner block keeps S and dP
// small enough for that. wgmma, TMA and warp specialisation are later work.

#include "mma_bf16.cuh"

namespace {

using namespace qie;

constexpr int kD = 128;          // head_dim
constexpr int kLd = kD + 8;      // bf16 row stride of every tile (272 B)
constexpr int kChunks = kD / 8;  // 16-byte chunks per row
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// K8 geometry
constexpr int kQ8 = 64;                      // query rows per CTA
constexpr int kK8 = 64;                      // keys per block
constexpr int kThreads8 = (kQ8 / 16) * 32;   // 4 warps
constexpr int kSmem8 = (2 * kQ8 + 4 * kK8) * kLd * 2;  // Q, dO, 2 × (K, V)

// K9 geometry
constexpr int kK9 = 128;                     // keys per CTA
constexpr int kQ9 = 32;                      // query rows per block
constexpr int kThreads9 = (kK9 / 16) * 32;   // 8 warps
constexpr int kSmem9 =
    (2 * kK9 + 4 * kQ9) * kLd * 2 + 4 * kQ9 * 4;  // K, V, 2 × (Q, dO, LSE, Δ)

// Rows [r0, r0 + rows) of a (L, 128) bf16 matrix into a padded shared tile;
// rows past L are zero-filled.
template <int kRows, int kThreads>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int L, int tid) {
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = r0 + r < L;
    cp_async16(dst + r * kLd + c, src + (size_t)(ok ? r0 + r : 0) * kD + c, ok);
  }
}

// ---------------------------------------------------------------------------
// K8: dQ. Warp w owns query rows q0 + 16w .. +15; lane rows g and g + 8.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads8, 2)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,   // Q_pre
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,    // (B·H, Lq)
                    const float* __restrict__ delta,  // (B·H, Lq)
                    const uint8_t* __restrict__ mask,  // (B, Lk) or nullptr
                    float* __restrict__ dq, int H, int Lq, int Lk,
                    int mask_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* do_s = q_s + kQ8 * kLd;
  __nv_bfloat16* k_s = do_s + kQ8 * kLd;   // two buffers
  __nv_bfloat16* v_s = k_s + 2 * kK8 * kLd;  // two buffers

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * kQ8;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int mat = lane >> 3;
  const int r8 = lane & 7;

  const __nv_bfloat16* k_bh = k + (size_t)bh * Lk * kD;
  const __nv_bfloat16* v_bh = v + (size_t)bh * Lk * kD;
  const uint8_t* mask_b = mask ? mask + (size_t)b * Lk : nullptr;
  const int nkb = (Lk + kK8 - 1) / kK8;

  auto load_kv = [&](int kb, int buf) {
    load_rows<kK8, kThreads8>(k_s + buf * kK8 * kLd, k_bh, kb * kK8, Lk, tid);
    load_rows<kK8, kThreads8>(v_s + buf * kK8 * kLd, v_bh, kb * kK8, Lk, tid);
    cp_async_commit();
  };

  load_rows<kQ8, kThreads8>(q_s, q + (size_t)bh * Lq * kD, q0, Lq, tid);
  load_rows<kQ8, kThreads8>(do_s, dout + (size_t)bh * Lq * kD, q0, Lq, tid);
  load_kv(0, 0);  // one group: Q, dO and the first K/V block

  const int row_lo = q0 + warp * 16 + g;
  const int row_hi = row_lo + 8;
  const float* lse_bh = lse + (size_t)bh * Lq;
  const float* delta_bh = delta + (size_t)bh * Lq;
  const float lse_lo = row_lo < Lq ? lse_bh[row_lo] : 0.f;
  const float lse_hi = row_hi < Lq ? lse_bh[row_hi] : 0.f;
  const float dl_lo = row_lo < Lq ? delta_bh[row_lo] : 0.f;
  const float dl_hi = row_hi < Lq ? delta_bh[row_hi] : 0.f;

  const int woff = (warp * 16 + (mat & 1) * 8 + r8) * kLd + (mat >> 1) * 8;
  const __nv_bfloat16* q_w = q_s + woff;
  const __nv_bfloat16* do_w = do_s + woff;

  float acc[kD / 8][4];
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int kb = 0; kb < nkb; ++kb) {
    const int buf = kb & 1;
    if (kb + 1 < nkb) {
      load_kv(kb + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = k_s + buf * kK8 * kLd;
    const __nv_bfloat16* vt = v_s + buf * kK8 * kLd;

    // S = Q_pre · K^T and dP = dO · V^T: 16 x 64 f32 each.
    float s[kK8 / 8][4], dp[kK8 / 8][4];
#pragma unroll
    for (int nt = 0; nt < kK8 / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t qa[4], da[4];
      ldmatrix_x4(qa, q_w + kk * 16);
      ldmatrix_x4(da, do_w + kk * 16);
#pragma unroll
      for (int np = 0; np < kK8 / 16; ++np) {
        const int off = (np * 16 + (mat >> 1) * 8 + r8) * kLd + kk * 16 +
                        (mat & 1) * 8;
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, kt + off);
        ldmatrix_x4(bv, vt + off);
        mma_bf16(s[2 * np], qa, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
        mma_bf16(dp[2 * np], da, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], da, bv[2], bv[3]);
      }
    }

    const int k0 = kb * kK8;
    const bool tail = k0 + kK8 > Lk;
    const bool use_mask = mask_b != nullptr && mask_applies(k0, Lk, mask_len);

    // dS = P ⊙ (dP − Δ), scaled and rounded to bf16 into A fragments.
    uint32_t dsf[kK8 / 16][4];
#pragma unroll
    for (int nt = 0; nt < kK8 / 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sv = s[nt][e];
        if (tail || use_mask) {
          const int col = k0 + nt * 8 + 2 * t4 + (e & 1);
          if (col >= Lk || (use_mask && mask_b[col] == 0)) sv = kNegInf;
        }
        const bool lo = e < 2;
        const float p = exp2f(sv - (lo ? lse_lo : lse_hi));
        ds[e] = p * (dp[nt][e] - (lo ? dl_lo : dl_hi)) * scale;
      }
      dsf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ (16 x 128) += dS (16 x 64) · K (64 x 128).
#pragma unroll
    for (int kk = 0; kk < kK8 / 16; ++kk) {
#pragma unroll
      for (int dpi = 0; dpi < kD / 16; ++dpi) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, kt + (kk * 16 + (mat & 1) * 8 + r8) * kLd +
                                  dpi * 16 + (mat >> 1) * 8);
        mma_bf16(acc[2 * dpi], dsf[kk], bk[0], bk[1]);
        mma_bf16(acc[2 * dpi + 1], dsf[kk], bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  float* dq_lo = dq + ((size_t)bh * Lq + row_lo) * kD + 2 * t4;
  float* dq_hi = dq_lo + 8 * kD;
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt) {
    if (row_lo < Lq)
      *reinterpret_cast<float2*>(dq_lo + nt * 8) =
          make_float2(acc[nt][0], acc[nt][1]);
    if (row_hi < Lq)
      *reinterpret_cast<float2*>(dq_hi + nt * 8) =
          make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ---------------------------------------------------------------------------
// K9: dK and dV. Warp w owns keys k0 + 16w .. +15; the products run
// transposed, S^T = K · Q_pre^T and dP^T = V · dO^T (16 keys x 32 queries),
// so the lane's rows are keys g and g + 8 and its columns queries.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads9, 1)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,   // Q_pre
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,    // (B·H, Lq)
                     const float* __restrict__ delta,  // (B·H, Lq)
                     const uint8_t* __restrict__ mask,  // (B, Lk) or nullptr
                     float* __restrict__ dk, float* __restrict__ dv, int H,
                     int Lq, int Lk, int mask_len) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + kK9 * kLd;
  __nv_bfloat16* q_s = v_s + kK9 * kLd;      // two buffers
  __nv_bfloat16* do_s = q_s + 2 * kQ9 * kLd;  // two buffers
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kQ9 * kLd);  // two
  float* dl_s = lse_s + 2 * kQ9;                                   // two

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int k0 = blockIdx.x * kK9;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int mat = lane >> 3;
  const int r8 = lane & 7;

  const __nv_bfloat16* q_bh = q + (size_t)bh * Lq * kD;
  const __nv_bfloat16* do_bh = dout + (size_t)bh * Lq * kD;
  const float* lse_bh = lse + (size_t)bh * Lq;
  const float* delta_bh = delta + (size_t)bh * Lq;
  const int nqb = (Lq + kQ9 - 1) / kQ9;

  auto load_q = [&](int qb, int buf) {
    const int r0 = qb * kQ9;
    load_rows<kQ9, kThreads9>(q_s + buf * kQ9 * kLd, q_bh, r0, Lq, tid);
    load_rows<kQ9, kThreads9>(do_s + buf * kQ9 * kLd, do_bh, r0, Lq, tid);
    if (tid < 2 * kQ9) {
      const int r = tid % kQ9;
      const bool ok = r0 + r < Lq;
      const float* src = (tid < kQ9 ? lse_bh : delta_bh) + (ok ? r0 + r : 0);
      cp_async4((tid < kQ9 ? lse_s : dl_s) + buf * kQ9 + r, src, ok);
    }
    cp_async_commit();
  };

  load_rows<kK9, kThreads9>(k_s, k + (size_t)bh * Lk * kD, k0, Lk, tid);
  load_rows<kK9, kThreads9>(v_s, v + (size_t)bh * Lk * kD, k0, Lk, tid);
  load_q(0, 0);  // one group: K, V and the first query block

  // This lane's two keys are dead (masked, or past Lk) for the whole sweep.
  const int key_lo = k0 + warp * 16 + g;
  const int key_hi = key_lo + 8;
  const uint8_t* mask_b = mask ? mask + (size_t)b * Lk : nullptr;
  auto dead = [&](int key) {
    return key >= Lk || (mask_b != nullptr && mask_applies(key, Lk, mask_len) &&
                         mask_b[key] == 0);
  };
  const bool dead_lo = dead(key_lo);
  const bool dead_hi = dead(key_hi);

  const int woff = (warp * 16 + (mat & 1) * 8 + r8) * kLd + (mat >> 1) * 8;
  const __nv_bfloat16* k_w = k_s + woff;
  const __nv_bfloat16* v_w = v_s + woff;

  float dk_acc[kD / 8][4], dv_acc[kD / 8][4];
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.f;

  for (int qb = 0; qb < nqb; ++qb) {
    const int buf = qb & 1;
    if (qb + 1 < nqb) {
      load_q(qb + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qt = q_s + buf * kQ9 * kLd;
    const __nv_bfloat16* dot = do_s + buf * kQ9 * kLd;
    const float* lse_t = lse_s + buf * kQ9;
    const float* dl_t = dl_s + buf * kQ9;

    // S^T = K_w · Q_pre^T and dP^T = V_w · dO^T: 16 x 32 f32 each.
    float s[kQ9 / 8][4], dp[kQ9 / 8][4];
#pragma unroll
    for (int nt = 0; nt < kQ9 / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, k_w + kk * 16);
      ldmatrix_x4(va, v_w + kk * 16);
#pragma unroll
      for (int np = 0; np < kQ9 / 16; ++np) {
        const int off = (np * 16 + (mat >> 1) * 8 + r8) * kLd + kk * 16 +
                        (mat & 1) * 8;
        uint32_t bq[4], bd[4];
        ldmatrix_x4(bq, qt + off);
        ldmatrix_x4(bd, dot + off);
        mma_bf16(s[2 * np], ka, bq[0], bq[1]);
        mma_bf16(s[2 * np + 1], ka, bq[2], bq[3]);
        mma_bf16(dp[2 * np], va, bd[0], bd[1]);
        mma_bf16(dp[2 * np + 1], va, bd[2], bd[3]);
      }
    }

    // P^T and dS^T, each rounded to bf16 into A fragments.
    const bool q_tail = (qb + 1) * kQ9 > Lq;
    uint32_t pf[kQ9 / 16][4], dsf[kQ9 / 16][4];
#pragma unroll
    for (int nt = 0; nt < kQ9 / 8; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t4 + (e & 1);  // query within the block
        const float sv = ((e < 2) ? dead_lo : dead_hi) ? kNegInf : s[nt][e];
        p[e] = exp2f(sv - lse_t[c]);
        if (q_tail && qb * kQ9 + c >= Lq) p[e] = 0.f;
        ds[e] = p[e] * (dp[nt][e] - dl_t[c]) * kLn2;
      }
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV (16 x 128) += P^T (16 x 32) · dO (32 x 128);
    // dK (16 x 128) += dS^T (16 x 32) · Q_pre (32 x 128).
#pragma unroll
    for (int kk = 0; kk < kQ9 / 16; ++kk) {
#pragma unroll
      for (int dpi = 0; dpi < kD / 16; ++dpi) {
        const int off = (kk * 16 + (mat & 1) * 8 + r8) * kLd + dpi * 16 +
                        (mat >> 1) * 8;
        uint32_t bd[4], bq[4];
        ldmatrix_x4_trans(bd, dot + off);
        ldmatrix_x4_trans(bq, qt + off);
        mma_bf16(dv_acc[2 * dpi], pf[kk], bd[0], bd[1]);
        mma_bf16(dv_acc[2 * dpi + 1], pf[kk], bd[2], bd[3]);
        mma_bf16(dk_acc[2 * dpi], dsf[kk], bq[0], bq[1]);
        mma_bf16(dk_acc[2 * dpi + 1], dsf[kk], bq[2], bq[3]);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  const size_t lo = ((size_t)bh * Lk + key_lo) * kD + 2 * t4;
  const size_t hi = lo + 8 * kD;
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt) {
    if (key_lo < Lk) {
      *reinterpret_cast<float2*>(dk + lo + nt * 8) =
          make_float2(dk_acc[nt][0], dk_acc[nt][1]);
      *reinterpret_cast<float2*>(dv + lo + nt * 8) =
          make_float2(dv_acc[nt][0], dv_acc[nt][1]);
    }
    if (key_hi < Lk) {
      *reinterpret_cast<float2*>(dk + hi + nt * 8) =
          make_float2(dk_acc[nt][2], dk_acc[nt][3]);
      *reinterpret_cast<float2*>(dv + hi + nt * 8) =
          make_float2(dv_acc[nt][2], dv_acc[nt][3]);
    }
  }
}

}  // namespace

// Common arguments: q_pre, k, v, dout (B, H, L, 128) bf16, contiguous and
// 16-byte aligned (q_pre = (q · d^-1/2 · log2(e)).bf16 as K7 rounds it); lse
// and delta (B·H, Lq) f32; mask (B, Lk) uint8 (1 = attend) or null. Each
// returns cudaGetLastError() after its launch (0 = launched).

// K8: dq (B, H, Lq, 128) f32; scale = d^-1/2.
extern "C" int qie_flash_bwd_dq_bf16(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     const void* mask, void* dq, int B, int H,
                                     int Lq, int Lk, int mask_len, float scale,
                                     void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem8);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + kQ8 - 1) / kQ8, B * H);
  flash_bwd_dq_kernel<<<grid, kThreads8, kSmem8,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask),
      static_cast<float*>(dq), H, Lq, Lk, mask_len, scale);
  return (int)cudaGetLastError();
}

// K9: dk, dv (B, H, Lk, 128) f32.
extern "C" int qie_flash_bwd_dkv_bf16(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      const void* mask, void* dk, void* dv,
                                      int B, int H, int Lq, int Lk,
                                      int mask_len, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem9);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lk + kK9 - 1) / kK9, B * H);
  flash_bwd_dkv_kernel<<<grid, kThreads9, kSmem9,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Lq, Lk, mask_len);
  return (int)cudaGetLastError();
}
