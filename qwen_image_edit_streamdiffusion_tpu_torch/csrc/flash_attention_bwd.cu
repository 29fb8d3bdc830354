// Flash-attention backward for Hopper (sm_90a): wgmma, TMA, mbarriers and
// warp specialisation. bf16 in, f32 gradients out.
//
// Replaces two Pallas TPU kernels of qwen_image_edit_streamdiffusion_tpu:
//   K8  ops/flash_attention.py::_flash_bwd_dq_kernel   → flash_bwd_dq_kernel
//   K9  ops/flash_attention.py::_flash_bwd_dkv_kernel  → flash_bwd_dkv_kernel
// the backward of the trainable joint attention (H == Hkv) whose forward is
// K7 (flash_fwd_sm90.cu with LSE = true).
//
// Math (the Pallas kernels' rounding points): q arrives pre-scaled by
// d^-1/2 · log2(e) and rounded to bf16 exactly as K7 rounds it, so S2 =
// Q_pre · K^T is the forward's score; P = exp2(S2 − LSE2) in f32, recomputed
// per block from the saved LSE2 (never stored); dP = dO · V^T; dS = P ⊙ (dP −
// Δ) with Δ = rowsum(dO ⊙ O) computed outside; then
//   dQ = (dS · scale).bf16 · K          (K8, scale = d^-1/2)
//   dK = (dS · ln2).bf16^T · Q_pre      (K9; ln2 undoes the log2(e) of Q_pre)
//   dV = P.bf16^T · dO                  (K9)
// exp2 runs in f32 on the MUFU unit (ex2.approx.ftz), never on a rounded
// argument. Masked keys get the score −1e30 (K8) or P = 0 (K9): the (B, Lk)
// key mask is read only where mask_applies (mma_bf16.cuh) says so, the rule
// K7 applies, so a masked key's P is exactly 0 and so are its dK and dV
// rows. Two kernels and no atomics, as in the JAX package: every output
// element is written once, by one CTA, so the result is deterministic.
//
// What bounds it on the H100: at the MMDiT's training shape (2 × 24 heads,
// L = 8448, d = 128) K8 does 6·Lq·Lk·d and K9 8·Lq·Lk·d flops per head over
// the kept keys on a few hundred MB: tensor-core bound, 2.65 and 3.53 ms at
// 989 TFLOP/s. Beside the products, each (query, key) pair costs one exp2 on
// the MUFU unit (16 a clock per SM) in each kernel, about a quarter of the
// product time: the design keeps it under the other warpgroup's products.
//
// Design (the forward's skeleton): a CTA of 3 warpgroups. Warpgroup 2 is the
// producer: it gives up its registers (setmaxnreg) and one thread issues TMA
// loads into an mbarrier ring. Warpgroups 0 and 1 are consumers at 240
// registers; they issue their products in turns (a named-barrier ping-pong),
// so one warpgroup's exp2/dS work runs while the other's products are on the
// tensor cores. Within a turn a warpgroup first retires the last block's
// gradient product (its register operand dS or P^T is then free), then
// issues the next block's two score products and hands the turn over; it
// rounds the new dS or P^T into the register operands only after they
// retire, so ptxas never serialises a wgmma. Accumulators of the score
// products are zeroed (one mov each) just before they are issued, so they
// hold no register while the gradient product runs.
//   K8 — 128 query rows of one (batch, head), 64 a consumer warpgroup. Q_pre
//   and dO are loaded once (two 128 × 128 bf16 TMA tiles), LSE2 and Δ of the
//   thread's two rows sit in registers, and 128-key K and V tiles stream
//   through a 2-stage ring, as in the forward. Per key block: S = Q_pre · K^T
//   and dP = dO · V^T, each one m64n128k16 chain from shared memory (both
//   K-major); P and dS in registers; dQ += dS · K with dS as the register A
//   operand and K as the MN-major B. Registers: dQ 64, S 64, dP 64, dS 32.
//   Shared memory: 64 KB for Q_pre and dO, 128 KB for the ring.
//   K9 — 128 keys of one (batch, head), 64 a consumer warpgroup, in the
//   transposed form: K and V are loaded once, and 64-row Q_pre and dO tiles
//   stream through a 3-stage ring. Per query tile: S^T = K · Q_pre^T and
//   dP^T = V · dO^T as m64n64k16 chains from shared memory, the thread's rows
//   keys and its columns queries; P^T and dS^T in registers; dV += P^T · dO
//   and dK += dS^T · Q_pre with register A and MN-major B, so nothing is
//   transposed through shared memory. Registers: dK + dV 128, S^T + dP^T 64,
//   P^T + dS^T 32 (a 128-row query tile would not fit in 240). A second
//   producer warp copies each tile's 64 LSE2 and Δ values into shared memory
//   with plain loads, zero past Lq, and arrives on the tile's barrier: the
//   (B·H, Lq) f32 rows are not 16-byte aligned for a bulk copy or a TMA map
//   at every Lq. Columns past Lq get P = dS = 0 explicitly (the zero-filled
//   Q and dO rows would not do: 0 · inf is NaN).
// TMA's 3-D maps (128, L, heads) zero-fill rows past L without reading the
// next head. Grids (L / 128, B · H): 3168 CTAs each at the train shape, 24
// waves of one CTA per SM on 132 SMs.

#include <cuda.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using namespace qie;
using namespace qie::sm90;

constexpr int kD = 128;                // head_dim
constexpr int kThreads = 384;          // 2 consumer warpgroups + producer
constexpr int kConsumerArrivals = 8;   // one lane of each consumer warp
constexpr int kHalf128 = 128 * 128;    // 128 rows of one 64-wide half
constexpr int kTile128 = 2 * kHalf128;  // a 128 x 128 bf16 tile
constexpr int kHalf64 = 64 * 128;      // 64 rows of one 64-wide half
constexpr int kTile64 = 2 * kHalf64;   // a 64 x 128 bf16 tile
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// K8 geometry: Q_pre, dO, then the K and V rings; barriers q_full,
// k_full[kStages8], k_empty[..], v_full[..], v_empty[..]
constexpr int kBQ8 = 128;  // query rows per CTA
constexpr int kBK8 = 128;  // keys per block
constexpr int kStages8 = 2;
constexpr int kQOff8 = 0;
constexpr int kDoOff8 = kQOff8 + kTile128;
constexpr int kKOff8 = kDoOff8 + kTile128;
constexpr int kVOff8 = kKOff8 + kStages8 * kTile128;
constexpr int kBarOff8 = kVOff8 + kStages8 * kTile128;
constexpr int kSmem8 = kBarOff8 + 8 * (1 + 4 * kStages8) + 1024;  // + align

// K9 geometry: K, V, then the Q_pre and dO rings, LSE2 and Δ per stage;
// barriers kv_full, q_full[kStages9], q_empty[..]
constexpr int kBK9 = 128;  // keys per CTA
constexpr int kBQ9 = 64;   // query rows per tile
constexpr int kStages9 = 3;
constexpr int kKOff9 = 0;
constexpr int kVOff9 = kKOff9 + kTile128;
constexpr int kQOff9 = kVOff9 + kTile128;
constexpr int kDoOff9 = kQOff9 + kStages9 * kTile64;
constexpr int kLseOff9 = kDoOff9 + kStages9 * kTile64;
constexpr int kDlOff9 = kLseOff9 + kStages9 * kBQ9 * 4;
constexpr int kBarOff9 = kDlOff9 + kStages9 * kBQ9 * 4;
constexpr int kSmem9 = kBarOff9 + 8 * (1 + 2 * kStages9) + 1024;
constexpr int kLseArrivals = 32;  // the lanes of the LSE2/Δ producer warp

// Zeroes an accumulator right before the wgmma that overwrites it: volatile,
// so the compiler keeps it after the last wait and the registers hold
// nothing while an earlier product runs.
template <int N>
__device__ __forceinline__ void zero_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("mov.f32 %0, 0f00000000;\n" : "=f"(r[i]));
}

// ---------------------------------------------------------------------------
// K8: dQ.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,  // Q_pre
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const float* __restrict__ lse,    // (B·H, Lq)
                    const float* __restrict__ delta,  // (B·H, Lq)
                    const uint8_t* __restrict__ mask,  // (B, Lk) or nullptr
                    float* __restrict__ dq, int H, int Lq, int Lk,
                    int mask_len, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + kQOff8;
  const uint32_t do_s = base + kDoOff8;
  const uint32_t k_s = base + kKOff8;
  const uint32_t v_s = base + kVOff8;
  const uint32_t bars = base + kBarOff8;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + kStages8 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + 2 * kStages8 + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * kStages8 + s); };

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * kBQ8;
  const int nkb = (Lk + kBK8 - 1) / kBK8;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages8; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumerArrivals);
      mbar_init(v_empty(s), kConsumerArrivals);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer: one thread issues every TMA load ----------
    regs_dealloc<24>();
    if (threadIdx.x == 256) {
      tma_prefetch_map(&q_map);
      tma_prefetch_map(&do_map);
      tma_prefetch_map(&k_map);
      tma_prefetch_map(&v_map);
      mbar_arrive_expect_tx(q_full, 2 * kTile128);
      tma_load_3d(q_s, &q_map, q_full, 0, q0, bh);
      tma_load_3d(q_s + kHalf128, &q_map, q_full, 64, q0, bh);
      tma_load_3d(do_s, &do_map, q_full, 0, q0, bh);
      tma_load_3d(do_s + kHalf128, &do_map, q_full, 64, q0, bh);
      for (int kb = 0; kb < nkb; ++kb) {
        const int st = kb % kStages8;
        const uint32_t ph = (kb / kStages8) & 1;
        const uint32_t kd = k_s + st * kTile128;
        const uint32_t vd = v_s + st * kTile128;
        mbar_wait(k_empty(st), ph ^ 1);
        mbar_arrive_expect_tx(k_full(st), kTile128);
        tma_load_3d(kd, &k_map, k_full(st), 0, kb * kBK8, bh);
        tma_load_3d(kd + kHalf128, &k_map, k_full(st), 64, kb * kBK8, bh);
        mbar_wait(v_empty(st), ph ^ 1);
        mbar_arrive_expect_tx(v_full(st), kTile128);
        tma_load_3d(vd, &v_map, v_full(st), 0, kb * kBK8, bh);
        tma_load_3d(vd + kHalf128, &v_map, v_full(st), 64, kb * kBK8, bh);
      }
    }
    return;
  }

  // ---------------- consumers: 64 query rows each --------------------------
  regs_alloc<240>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const bool arriver = lane == 0;
  const uint8_t* mask_b = mask ? mask + (size_t)b * Lk : nullptr;

  const int row_lo = q0 + wg * 64 + warp * 16 + g;
  const int row_hi = row_lo + 8;
  const float* lse_bh = lse + (size_t)bh * Lq;
  const float* delta_bh = delta + (size_t)bh * Lq;
  const float lse_lo = row_lo < Lq ? lse_bh[row_lo] : 0.f;
  const float lse_hi = row_hi < Lq ? lse_bh[row_hi] : 0.f;
  const float dl_lo = row_lo < Lq ? delta_bh[row_lo] : 0.f;
  const float dl_hi = row_hi < Lq ? delta_bh[row_hi] : 0.f;

  // acc (this warpgroup's 64 rows x 128 keys) = A tile (Q_pre or dO) · B
  // tile^T (K or V): 8 k16 steps, four in each 64-wide half of d.
  auto issue_scores = [&](float (&acc)[64], uint32_t a_tile, uint32_t b_tile) {
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kHalf128 + (kk % 4) * 32;
      wgmma_ss_m64n128k16(acc, desc_sw128(a_tile + wg * 8192 + off, 16, 1024),
                          desc_sw128(b_tile + off, 16, 1024), kk > 0);
    }
  };
  float dqa[64], s[64], dp[64];
  uint32_t ds[8][4];  // the A operand of dS · K (ds[kk]: keys 16kk .. +15)
  // dQ += dS (64 x 128 keys, registers) · K (128 keys x 128): 8 k16 steps of
  // 16 keys, each 2048 bytes into the tile; the two halves of d are the
  // MN-major chunks (leading offset), 8-key groups the stride.
  auto issue_dq = [&](int st) {
    const uint32_t kt = k_s + st * kTile128;
#pragma unroll
    for (int kk = 0; kk < kBK8 / 16; ++kk)
      wgmma_rs_m64n128k16_tb(dqa, ds[kk],
                             desc_sw128(kt + kk * 2048, kHalf128, 1024));
  };
  auto retire_dq = [&](int st) {
    fence_regs(dqa);
    wgmma_fence();
    issue_dq(st);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
    if (arriver) mbar_arrive(k_empty(st));
  };
#pragma unroll
  for (int i = 0; i < 64; ++i) dqa[i] = 0.f;

  mbar_wait(q_full, 0);
  pingpong_open(wg);
  for (int kb = 0; kb < nkb; ++kb) {
    const int st = kb % kStages8;
    const uint32_t ph = (kb / kStages8) & 1;
    mbar_wait(k_full(st), ph);
    mbar_wait(v_full(st), ph);
    pingpong_turn(wg);
    if (kb > 0) retire_dq((kb - 1) % kStages8);
    zero_regs(s);
    zero_regs(dp);
    wgmma_fence();
    issue_scores(s, q_s, k_s + st * kTile128);
    issue_scores(dp, do_s, v_s + st * kTile128);
    wgmma_commit();
    pingpong_hand_over(wg, kb + 1 == nkb);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    if (arriver) mbar_arrive(v_empty(st));

    // Keys past Lk, and masked keys where the mask rule applies, score
    // -1e30 (P = 0); blocks of the unmasked bulk skip this entirely.
    const int k0 = kb * kBK8;
    const bool tail = k0 + kBK8 > Lk;
    const bool use_mask = mask_b != nullptr && (k0 < mask_len || tail);
    if (tail || use_mask) {
#pragma unroll
      for (int j = 0; j < kBK8 / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * t4 + e;
          const bool dead = col >= Lk ||
                            (use_mask && mask_applies(col, Lk, mask_len) &&
                             mask_b[col] == 0);
          if (dead) {
            s[4 * j + e] = kNegInf;
            s[4 * j + 2 + e] = kNegInf;
          }
        }
      }
    }
    // dS = exp2(S2 − LSE2) ⊙ (dP − Δ) · scale, rounded into the A fragments
    // (C tiles 2kk and 2kk + 1 make ds[kk]).
#pragma unroll
    for (int j = 0; j < kBK8 / 8; ++j) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        const float p = ex2_ftz(s[4 * j + e] - (lo ? lse_lo : lse_hi));
        d[e] = p * (dp[4 * j + e] - (lo ? dl_lo : dl_hi)) * scale;
      }
      ds[j >> 1][(j & 1) * 2 + 0] = pack_bf16(d[0], d[1]);
      ds[j >> 1][(j & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
    }
  }
  retire_dq((nkb - 1) % kStages8);

  float* dq_lo = dq + ((size_t)bh * Lq + row_lo) * kD + 2 * t4;
  float* dq_hi = dq_lo + 8 * kD;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    if (row_lo < Lq)
      *reinterpret_cast<float2*>(dq_lo + 8 * j) =
          make_float2(dqa[4 * j], dqa[4 * j + 1]);
    if (row_hi < Lq)
      *reinterpret_cast<float2*>(dq_hi + 8 * j) =
          make_float2(dqa[4 * j + 2], dqa[4 * j + 3]);
  }
}

// ---------------------------------------------------------------------------
// K9: dK and dV, transposed: the accumulators' rows are keys.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,  // Q_pre
                     const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const float* __restrict__ lse,    // (B·H, Lq)
                     const float* __restrict__ delta,  // (B·H, Lq)
                     const uint8_t* __restrict__ mask,  // (B, Lk) or nullptr
                     float* __restrict__ dk, float* __restrict__ dv, int H,
                     int Lq, int Lk, int mask_len) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t k_s = base + kKOff9;
  const uint32_t v_s = base + kVOff9;
  const uint32_t q_s = base + kQOff9;
  const uint32_t do_s = base + kDoOff9;
  float* lse_s = reinterpret_cast<float*>(smem + kLseOff9);  // [stage][64]
  float* dl_s = reinterpret_cast<float*>(smem + kDlOff9);
  const uint32_t bars = base + kBarOff9;
  const uint32_t kv_full = bars;
  auto q_full = [&](int s) { return bars + 8 * (1 + s); };
  auto q_empty = [&](int s) { return bars + 8 * (1 + kStages9 + s); };

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int k0 = blockIdx.x * kBK9;
  const int nqb = (Lq + kBQ9 - 1) / kBQ9;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages9; ++s) {
      mbar_init(q_full(s), 1 + kLseArrivals);
      mbar_init(q_empty(s), kConsumerArrivals);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer: warp 8 issues the TMA loads, warp 9 copies
    // LSE2 and Δ -------------------------------------------------------------
    regs_dealloc<24>();
    const int pwarp = threadIdx.x / 32 - 8;
    if (threadIdx.x == 256) {
      tma_prefetch_map(&q_map);
      tma_prefetch_map(&do_map);
      tma_prefetch_map(&k_map);
      tma_prefetch_map(&v_map);
      mbar_arrive_expect_tx(kv_full, 2 * kTile128);
      tma_load_3d(k_s, &k_map, kv_full, 0, k0, bh);
      tma_load_3d(k_s + kHalf128, &k_map, kv_full, 64, k0, bh);
      tma_load_3d(v_s, &v_map, kv_full, 0, k0, bh);
      tma_load_3d(v_s + kHalf128, &v_map, kv_full, 64, k0, bh);
      for (int qb = 0; qb < nqb; ++qb) {
        const int st = qb % kStages9;
        const uint32_t ph = (qb / kStages9) & 1;
        const uint32_t qd = q_s + st * kTile64;
        const uint32_t dd = do_s + st * kTile64;
        mbar_wait(q_empty(st), ph ^ 1);
        mbar_arrive_expect_tx(q_full(st), 2 * kTile64);
        tma_load_3d(qd, &q_map, q_full(st), 0, qb * kBQ9, bh);
        tma_load_3d(qd + kHalf64, &q_map, q_full(st), 64, qb * kBQ9, bh);
        tma_load_3d(dd, &do_map, q_full(st), 0, qb * kBQ9, bh);
        tma_load_3d(dd + kHalf64, &do_map, q_full(st), 64, qb * kBQ9, bh);
      }
    } else if (pwarp == 1) {
      const int lane = threadIdx.x % 32;
      const float* lse_bh = lse + (size_t)bh * Lq;
      const float* delta_bh = delta + (size_t)bh * Lq;
      for (int qb = 0; qb < nqb; ++qb) {
        const int st = qb % kStages9;
        const uint32_t ph = (qb / kStages9) & 1;
        mbar_wait(q_empty(st), ph ^ 1);
#pragma unroll
        for (int i = 0; i < kBQ9 / 32; ++i) {
          const int r = lane + 32 * i;
          const int row = qb * kBQ9 + r;
          const bool ok = row < Lq;
          lse_s[st * kBQ9 + r] = ok ? lse_bh[row] : 0.f;
          dl_s[st * kBQ9 + r] = ok ? delta_bh[row] : 0.f;
        }
        mbar_arrive(q_full(st));  // release: the stores above come first
      }
    }
    return;
  }

  // ---------------- consumers: 64 keys each --------------------------------
  regs_alloc<240>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const bool arriver = lane == 0;

  // This thread's two keys are dead (masked, or past Lk) for the whole sweep.
  const int key_lo = k0 + wg * 64 + warp * 16 + g;
  const int key_hi = key_lo + 8;
  const uint8_t* mask_b = mask ? mask + (size_t)b * Lk : nullptr;
  auto dead = [&](int key) {
    return key >= Lk || (mask_b != nullptr && mask_applies(key, Lk, mask_len) &&
                         mask_b[key] == 0);
  };
  const bool dead_lo = dead(key_lo);
  const bool dead_hi = dead(key_hi);

  // acc^T (this warpgroup's 64 keys x 64 queries) = A tile (K or V, rows
  // wg·64 ..) · B tile^T (Q_pre or dO, 64 rows): 8 k16 steps over d.
  auto issue_scores = [&](float (&acc)[32], uint32_t a_tile, uint32_t b_tile) {
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss_m64n64k16(
          acc, desc_sw128(a_tile + (kk / 4) * kHalf128 + wg * 8192 + col, 16, 1024),
          desc_sw128(b_tile + (kk / 4) * kHalf64 + col, 16, 1024), kk > 0);
    }
  };
  float dka[64], dva[64], s[32], dp[32];
  uint32_t pf[4][4], dsf[4][4];  // A operands (queries 16kk .. +15)
  // dV += P^T (64 keys x 64 queries, registers) · dO (64 queries x 128) and
  // dK += dS^T · Q_pre: 4 k16 steps of 16 query rows (2048 bytes) each; the
  // two halves of d are the MN-major chunks (leading offset).
  auto retire_dkv = [&](int st) {
    const uint32_t qt = q_s + st * kTile64;
    const uint32_t dt = do_s + st * kTile64;
    fence_regs(dka);
    fence_regs(dva);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ9 / 16; ++kk)
      wgmma_rs_m64n128k16_tb(dva, pf[kk], desc_sw128(dt + kk * 2048, kHalf64, 1024));
#pragma unroll
    for (int kk = 0; kk < kBQ9 / 16; ++kk)
      wgmma_rs_m64n128k16_tb(dka, dsf[kk], desc_sw128(qt + kk * 2048, kHalf64, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dka);
    fence_regs(dva);
    if (arriver) mbar_arrive(q_empty(st));
  };
#pragma unroll
  for (int i = 0; i < 64; ++i) dka[i] = dva[i] = 0.f;

  mbar_wait(kv_full, 0);
  pingpong_open(wg);
  for (int qb = 0; qb < nqb; ++qb) {
    const int st = qb % kStages9;
    const uint32_t ph = (qb / kStages9) & 1;
    mbar_wait(q_full(st), ph);
    pingpong_turn(wg);
    if (qb > 0) retire_dkv((qb - 1) % kStages9);
    zero_regs(s);
    zero_regs(dp);
    wgmma_fence();
    issue_scores(s, k_s, q_s + st * kTile64);
    issue_scores(dp, v_s, do_s + st * kTile64);
    wgmma_commit();
    pingpong_hand_over(wg, qb + 1 == nqb);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T = exp2(S2^T − LSE2) and dS^T = P^T ⊙ (dP^T − Δ) · ln2, rounded
    // into the A fragments; 0 for dead keys and for queries past Lq.
    const float* lse_t = lse_s + st * kBQ9;
    const float* dl_t = dl_s + st * kBQ9;
    const int q_left = Lq - qb * kBQ9;  // columns >= q_left lie past Lq
#pragma unroll
    for (int j = 0; j < kBQ9 / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
      const float2 d2 = *reinterpret_cast<const float2*>(dl_t + c);
      float p[4], d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        const bool off = (e < 2 ? dead_lo : dead_hi) || c + odd >= q_left;
        p[e] = off ? 0.f : ex2_ftz(s[4 * j + e] - (odd ? l2.y : l2.x));
        d[e] = p[e] * (dp[4 * j + e] - (odd ? d2.y : d2.x)) * kLn2;
      }
      pf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(d[0], d[1]);
      dsf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
    }
  }
  retire_dkv((nqb - 1) % kStages9);

  const size_t lo = ((size_t)bh * Lk + key_lo) * kD + 2 * t4;
  const size_t hi = lo + 8 * kD;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    if (key_lo < Lk) {
      *reinterpret_cast<float2*>(dk + lo + 8 * j) = make_float2(dka[4 * j], dka[4 * j + 1]);
      *reinterpret_cast<float2*>(dv + lo + 8 * j) = make_float2(dva[4 * j], dva[4 * j + 1]);
    }
    if (key_hi < Lk) {
      *reinterpret_cast<float2*>(dk + hi + 8 * j) =
          make_float2(dka[4 * j + 2], dka[4 * j + 3]);
      *reinterpret_cast<float2*>(dv + hi + 8 * j) =
          make_float2(dva[4 * j + 2], dva[4 * j + 3]);
    }
  }
}

// The four (B·H, L, 128) bf16 maps of a launch, with boxes of the given
// query and key rows; false when a map cannot be built.
bool make_maps(CUtensorMap (&m)[4], const void* q, const void* dout,
               const void* k, const void* v, int BH, int Lq, int Lk,
               int q_rows, int k_rows) {
  return make_map(&m[0], q, Lq, BH, q_rows) && make_map(&m[1], dout, Lq, BH, q_rows) &&
         make_map(&m[2], k, Lk, BH, k_rows) && make_map(&m[3], v, Lk, BH, k_rows);
}

}  // namespace

// Common arguments: q_pre, k, v, dout (B, H, L, 128) bf16, contiguous and
// 16-byte aligned (q_pre = (q · d^-1/2 · log2(e)).bf16 as K7 rounds it); lse
// and delta (B·H, Lq) f32; mask (B, Lk) uint8 (1 = attend) or null. Each
// returns cudaGetLastError() after its launch (0 = launched), or
// cudaErrorInvalidValue when a tensor map cannot be built.

// K8: dq (B, H, Lq, 128) f32; scale = d^-1/2.
extern "C" int qie_flash_bwd_dq_bf16(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     const void* mask, void* dq, int B, int H,
                                     int Lq, int Lk, int mask_len, float scale,
                                     void* stream) {
  CUtensorMap m[4];
  if (!make_maps(m, q, dout, k, v, B * H, Lq, Lk, kBQ8, kBK8))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem8);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + kBQ8 - 1) / kBQ8, B * H);
  flash_bwd_dq_kernel<<<grid, kThreads, kSmem8, static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
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
  CUtensorMap m[4];
  if (!make_maps(m, q, dout, k, v, B * H, Lq, Lk, kBQ9, kBK9))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem9);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lk + kBK9 - 1) / kBK9, B * H);
  flash_bwd_dkv_kernel<<<grid, kThreads, kSmem9, static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Lq, Lk, mask_len);
  return (int)cudaGetLastError();
}
