// Flash attention forward for Hopper (sm_90a): wgmma, TMA, mbarriers and
// warp specialisation. bf16 in / bf16 out, f32 softmax.
//
// Replaces four Pallas TPU kernels of qwen_image_edit_streamdiffusion_tpu:
//   K1  ops/flash_attention.py::_flash_kernel          (LSE = false)
//       joint [txt ⊕ img] attention of the MMDiT with a (B, Lk) key mask;
//   K4  ops/flash_attention.py::_flash_kernel_hbm      (LSE = false)
//       the same math for joint sequences past the TPU's VMEM budget (two
//       1024² condition images, Lk ≈ 12.5k) and GQA: K/V stream through
//       shared memory for any Lk, and q head h reads kv head h / (H / Hkv);
//   K7  ops/flash_attention.py::_flash_kernel_fwd_lse  (LSE = true)
//       the forward of the trainable attention: the same instance plus one
//       store per row of LSE2 = m + log2(l) for the backward kernels
//       (flash_attention_bwd.cu); its O is K1's bit for bit;
//   K2  ops/flash_attention.py::_flash_kernel_causal   (CAUSAL = true)
//       the causal GQA attention of the Qwen2.5-VL language model (28 q on 4
//       kv heads, L = 128..1024 in 128-token buckets): the producer never
//       loads a key block above the diagonal, only the diagonal block applies
//       the row >= col select, and the grid runs the query blocks with the
//       most key blocks first. It takes no key mask: padding is a suffix, so
//       every padded key lies above a real row's diagonal.
//
// Math (the Pallas kernels' rounding points): Q_pre = bf16(q · d^-1/2 ·
// log2 e); S2 = Q_pre · K^T in f32, dead keys at -1e30; online softmax in
// base 2 with f32 running max m, row sum l and output accumulator; P =
// bf16(exp2(bf16(S2 − m))), and l sums the rounded P; O = acc / max(l,
// 1e-30) rounded to bf16 (K2's Pallas kernel rounds at the same points).
// The key mask applies to a key when it lies below
// mask_len or in the ragged tail (mask_applies in mma_bf16.cuh, the rule K8
// and K9 apply too); keys past Lk are dead.
//
// What bounds it on the H100: K1 at (1, 24, 8448, 128) does 4·Lq·Lk·d =
// 872 GFLOP on about 207 MB of Q/K/V/O, so it is bound by the tensor cores:
// 0.882 ms at 989 TFLOP/s. K4 at Lk = 12544: 1.93 TFLOP (1.948 ms); K7 at
// (2, 24, 8448, 128): 1.74 TFLOP (1.763 ms). Beside the products, each
// score costs one exp2 on the MUFU unit (16 a clock per SM), which at d =
// 128 is about half the wgmma time: the design keeps it under the products.
//
// Design (FlashAttention-3's shape): a CTA of 3 warpgroups owns 128 query
// rows of one (batch, head). Warpgroup 2 is the producer: it gives up its
// registers (setmaxnreg) and one thread issues TMA loads, Q once and then
// 128-key K and V tiles into a 2-stage ring (160 KB of shared memory with
// Q), each stage with a full and an empty mbarrier for K and for V.
// Warpgroups 0 and 1 are consumers of 64 query rows each at 240 registers:
// S = Q_pre · K^T is one wgmma m64n128k16 chain from shared memory (Q and K
// both K-major), O += P · V one chain with P from registers (the softmax's
// own accumulator layout) and V from shared memory (MN-major, transposed).
// Within a warpgroup the next block's S is issued before this block's P · V
// and the softmax of S_j runs while P_{j−1} · V_{j−1} is still on the tensor
// cores; across the two warpgroups a named-barrier ping-pong lets one issue
// its products while the other runs its softmax, so the exp2 work overlaps
// the products. exp2 runs in f32 on the MUFU unit (ex2.approx.ftz) and P is
// rounded to bf16 after it. The bf16x2 form (ex2.approx.ftz.bf16x2, one MUFU
// operation for two scores) gave K1 no measurable gain on an H100 SXM and
// returns P biased low: K7's LSE2 0.0053 off the plain version instead of
// 0.0008, past chip_smoke.py's LSE limit.
// TMA's 3-D maps (128, L, heads) zero-fill rows past L without reading the
// next head, so no tile needs a bounds check. The grid (Lq / 128, B · H) is 1584 CTAs at K1's
// shape: 12 full waves of one CTA per SM on 132 SMs.
//
// K2's shapes are small: at (1, 28, 384, 128) the causal work is 28 · 6
// (query, key) block pairs of 128 × 128 (1.4 GFLOP, 1.4 µs at the
// tensor-core peak), and a CTA's time is set by its key blocks, 3 for the
// last query block, plus a fixed cost (launch, the Q and first K/V loads,
// the Q prescale, the epilogue) that is most of a launch's time at L <=
// 384. The causal grid is (B · H, query blocks) with the query block index
// reversed, so the CTAs with the most key blocks start first. Its CTA
// takes WGS consumer warpgroups of 64 rows: 128-row CTAs (WGS = 2, K1's
// shape with the ping-pong) give 84 CTAs on 132 SMs at L = 384, so the
// wrapper (ops/flash_attention.py::causal_block_q) takes 64-row CTAs (WGS
// = 1, 256 threads at 255 registers a thread from the launch, no
// setmaxnreg) whenever 128-row CTAs would not fill the SMs. On an H100 SXM
// (chip_smoke.py, graph-timed) 64-row CTAs read 6.3-6.6 / 12.5-12.7 /
// 36.8-37.3 µs at L = 128 / 384 / 1024 against 128-row CTAs' 8.2-8.5 /
// 12.1-12.7 / 27.0-27.4: a fifth less at 128, level at 384 (each row's
// chain of key blocks is the same length), a third more at 1024, where
// one warpgroup an SM leaves the tensor cores idle during its softmax.
// Neither a third K/V stage nor dropping the ping-pong made K2 faster.

#include <cuda.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using namespace qie;
using namespace qie::sm90;

constexpr int kD = 128;                   // head_dim
constexpr int kBK = 128;                  // keys per block
constexpr int kStages = 2;                // K/V ring depth
constexpr int kHalfBytes = 128 * 128;     // 128 rows of one 64-wide half
constexpr int kTileBytes = 2 * kHalfBytes;  // a 128 x 128 bf16 tile

// The CTA's shape for WGS consumer warpgroups of 64 query rows each (2: K1's
// 128-row CTA with the ping-pong; 1: a 64-row CTA) and one producer.
template <int WGS>
struct Tile {
  static constexpr int kBQ = 64 * WGS;              // query rows per CTA
  static constexpr int kThreads = 128 * (WGS + 1);
  static constexpr int kQHalfBytes = kBQ * 128;     // kBQ rows of one half
  static constexpr int kKOff = 2 * kQHalfBytes;     // Q at 0
  static constexpr int kVOff = kKOff + kStages * kTileBytes;
  static constexpr int kBarOff = kVOff + kStages * kTileBytes;
  // barriers: q_full, k_full[kStages], k_empty[..], v_full[..], v_empty[..]
  static constexpr int kSmemBytes = kBarOff + 8 * (1 + 4 * kStages) + 1024;
  static constexpr int kConsumerArrivals = 4 * WGS;  // a lane of each warp
};
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The two bf16 halves of a packed pair as f32 (exact).
__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

template <bool LSE, bool CAUSAL, int WGS>
__global__ void __launch_bounds__(Tile<WGS>::kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const uint8_t* __restrict__ mask,  // (B, Lk) or nullptr
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse,  // (B·H, Lq) when LSE
                      int H, int Hkv, int Lq, int Lk, int mask_len,
                      float qscale) {
  using T = Tile<WGS>;
  constexpr int kBQ = T::kBQ;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t q_s = base;
  const uint32_t k_s = base + T::kKOff;
  const uint32_t v_s = base + T::kVOff;
  const uint32_t bars = base + T::kBarOff;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * kStages + s); };

  // causal: (B · H, query blocks), the last query block first
  const int bh = CAUSAL ? blockIdx.x : blockIdx.y;
  const int qb = CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kv_bh = b * Hkv + h / (H / Hkv);
  const int q0 = qb * kBQ;
  // key blocks this CTA reads; causal: none above the diagonal
  const int nkb = CAUSAL ? min((Lk + kBK - 1) / kBK, (q0 + kBQ + kBK - 1) / kBK)
                         : (Lk + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), T::kConsumerArrivals);
      mbar_init(v_empty(s), T::kConsumerArrivals);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == WGS) {
    // ---------------- producer: one thread issues every TMA load ----------
    // 128-row CTAs move the producer's registers to the consumers; a
    // 64-row CTA of 256 threads has 255 a thread from its launch
    if (WGS == 2) regs_dealloc<24>();
    if (threadIdx.x == 128 * WGS) {
      tma_prefetch_map(&q_map);
      tma_prefetch_map(&k_map);
      tma_prefetch_map(&v_map);
      mbar_arrive_expect_tx(q_full, 2 * T::kQHalfBytes);
      tma_load_3d(q_s, &q_map, q_full, 0, q0, bh);
      tma_load_3d(q_s + T::kQHalfBytes, &q_map, q_full, 64, q0, bh);
      for (int kb = 0; kb < nkb; ++kb) {
        const int st = kb % kStages;
        const uint32_t ph = (kb / kStages) & 1;
        const uint32_t kd = k_s + st * kTileBytes;
        const uint32_t vd = v_s + st * kTileBytes;
        mbar_wait(k_empty(st), ph ^ 1);
        mbar_arrive_expect_tx(k_full(st), kTileBytes);
        tma_load_3d(kd, &k_map, k_full(st), 0, kb * kBK, kv_bh);
        tma_load_3d(kd + kHalfBytes, &k_map, k_full(st), 64, kb * kBK, kv_bh);
        mbar_wait(v_empty(st), ph ^ 1);
        mbar_arrive_expect_tx(v_full(st), kTileBytes);
        tma_load_3d(vd, &v_map, v_full(st), 0, kb * kBK, kv_bh);
        tma_load_3d(vd + kHalfBytes, &v_map, v_full(st), 64, kb * kBK, kv_bh);
      }
    }
  } else {
    // ---------------- consumers: 64 query rows each ------------------------
    if (WGS == 2) regs_alloc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const bool arriver = lane == 0;
    const uint8_t* mask_b = mask ? mask + (size_t)b * Lk : nullptr;

    // Q_pre: scale this warpgroup's 64 rows in place (both halves), then
    // make the generic-proxy writes visible to wgmma.
    mbar_wait(q_full, 0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int chunk = tid + 128 * i;  // 1024 16-byte chunks
      const int half = chunk / 512;
      unsigned char* p = smem + half * T::kQHalfBytes + wg * 8192 +
                         (chunk % 512) * 16;
      uint4 raw = *reinterpret_cast<uint4*>(p);
      uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[j]));
        w[j] = pack_bf16(f.x * qscale, f.y * qscale);
      }
      *reinterpret_cast<uint4*>(p) = raw;
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);

    // S = Q_pre (this warpgroup's 64 rows) · K^T (128 keys): 8 k16 steps,
    // four in each 64-wide half of d.
    auto issue_qk = [&](float (&s)[64], int st) {
      const uint32_t kt = k_s + st * kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss_m64n128k16(
            s, desc_sw128(q_s + (kk / 4) * T::kQHalfBytes + wg * 8192 + off,
                          16, 1024),
            desc_sw128(kt + (kk / 4) * kHalfBytes + off, 16, 1024), kk > 0);
      }
    };
    // O += P (64 x 128 keys, registers) · V (128 keys x 128): 8 k16 steps of
    // 16 keys, each 2048 bytes into the tile; the two halves of d are the
    // MN-major chunks (leading offset) and 8-key groups the stride.
    auto issue_pv = [&](float (&o)[64], const uint32_t (&p)[8][4], int st) {
      const uint32_t vt = v_s + st * kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs_m64n128k16_tb(o, p[kk],
                               desc_sw128(vt + kk * 2048, kHalfBytes, 1024));
    };

    const int row_lo = q0 + wg * 64 + warp * 16 + g;
    const int row_hi = row_lo + 8;
    float o[64], s[64];
    uint32_t p[8][4];  // the A operand of P · V
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m_lo = kNegInf, m_hi = kNegInf;
    float l_lo = 0.f, l_hi = 0.f;  // this lane's part of the row sums

    // Masks S of block kb in place: keys past Lk, masked keys where the
    // mask rule applies, and (causal) keys after the row on the diagonal
    // block; blocks of the unmasked bulk skip this entirely.
    auto mask_scores = [&](int kb) {
      const int k0 = kb * kBK;
      const bool tail = k0 + kBK > Lk;
      const bool use_mask =
          mask_b != nullptr && (k0 < mask_len || k0 + kBK > Lk);
      const bool diag = CAUSAL && k0 + kBK - 1 > q0 + wg * 64;
      if (!(tail || use_mask || diag)) return;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * t4 + e;
          const bool dead = col >= Lk ||
                            (use_mask && mask_applies(col, Lk, mask_len) &&
                             mask_b[col] == 0);
          if (dead || (diag && col > row_lo)) s[4 * j + e] = kNegInf;
          if (dead || (diag && col > row_hi)) s[4 * j + 2 + e] = kNegInf;
        }
      }
    };

    // Online softmax of S: new row max (two quad shuffles), alpha, and
    // P = bf16(exp2(bf16(S − m))) written back into s as f32 (exact bf16
    // values); row sums of the rounded P are added to l after alpha. Each
    // rounding is one packed conversion for two scores.
    auto softmax = [&](float& alpha_lo, float& alpha_hi) {
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int d = 1; d <= 2; d <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, d));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, d));
      }
      alpha_lo = exp2f(m_lo - mx_lo);
      alpha_hi = exp2f(m_hi - mx_hi);
      m_lo = mx_lo;
      m_hi = mx_hi;
      // two P values rounded to bf16, packed, and their sum
      auto p2 = [](float a, float b, float& sum) {
        const uint32_t x = pack_bf16(a, b);  // the argument at bf16
        const uint32_t y = pack_bf16(ex2_ftz(bf16_lo(x)), ex2_ftz(bf16_hi(x)));
        sum += bf16_lo(y) + bf16_hi(y);
        return y;
      };
      float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint32_t lo = p2(s[4 * j] - mx_lo, s[4 * j + 1] - mx_lo, ps_lo);
        const uint32_t hi =
            p2(s[4 * j + 2] - mx_hi, s[4 * j + 3] - mx_hi, ps_hi);
        s[4 * j] = bf16_lo(lo);
        s[4 * j + 1] = bf16_hi(lo);
        s[4 * j + 2] = bf16_lo(hi);
        s[4 * j + 3] = bf16_hi(hi);
      }
      l_lo = l_lo * alpha_lo + ps_lo;
      l_hi = l_hi * alpha_hi + ps_hi;
    };

    // P packed into the A fragments of P · V (p[kk]: keys 16kk .. 16kk + 15,
    // C tiles 2kk and 2kk + 1), once the last P · V has retired. The packing
    // must be a real conversion here: P written earlier (in the softmax,
    // while that product still reads p) or merely copied from s lets ptxas
    // give p and s one register range, and it then serialises every wgmma
    // (C7511/C7513): 1.93 against 1.50 ms at K1's shape on an H100 SXM.
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      fence_regs(p);  // defined here, before the next wgmma stage opens
    };
    // The softmax of one warpgroup runs under the other's products (WGS = 2).
    if (WGS == 2) pingpong_open(wg);

    // Block 0: S alone.
    float alpha_lo, alpha_hi;
    mbar_wait(k_full(0), 0);
    if (WGS == 2) pingpong_turn(wg);
    fence_regs(s);
    wgmma_fence();
    issue_qk(s, 0);
    wgmma_commit();
    if (WGS == 2) pingpong_hand_over(wg, nkb == 1);
    wgmma_wait<0>();
    fence_regs(s);
    if (arriver) mbar_arrive(k_empty(0));
    mask_scores(0);
    softmax(alpha_lo, alpha_hi);
    pack_p();

    // Block kb: S_kb issued, then P_{kb-1} · V_{kb-1}; the softmax of S_kb
    // runs while the second product is in flight.
    for (int kb = 1; kb < nkb; ++kb) {
      const int st = kb % kStages;
      const uint32_t ph = (kb / kStages) & 1;
      const int pst = (kb - 1) % kStages;
      const uint32_t pph = ((kb - 1) / kStages) & 1;
      mbar_wait(k_full(st), ph);
      mbar_wait(v_full(pst), pph);
      if (WGS == 2) pingpong_turn(wg);
      fence_regs(s);
      fence_regs(o);
      wgmma_fence();
      issue_qk(s, st);
      wgmma_commit();
      wgmma_fence();  // each product's stage opens after its inputs exist
      issue_pv(o, p, pst);
      wgmma_commit();
      if (WGS == 2) pingpong_hand_over(wg, kb + 1 == nkb);
      wgmma_wait<1>();
      fence_regs(s);
      if (arriver) mbar_arrive(k_empty(st));
      mask_scores(kb);
      softmax(alpha_lo, alpha_hi);
      wgmma_wait<0>();
      fence_regs(o);
      if (arriver) mbar_arrive(v_empty(pst));
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[4 * j] *= alpha_lo;
        o[4 * j + 1] *= alpha_lo;
        o[4 * j + 2] *= alpha_hi;
        o[4 * j + 3] *= alpha_hi;
      }
      pack_p();
    }

    // The last P · V.
    {
      const int pst = (nkb - 1) % kStages;
      const uint32_t pph = ((nkb - 1) / kStages) & 1;
      mbar_wait(v_full(pst), pph);
      fence_regs(o);
      wgmma_fence();
      issue_pv(o, p, pst);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (arriver) mbar_arrive(v_empty(pst));
    }

#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, d);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, d);
    }
    if (LSE && t4 == 0) {
      // LSE2 = m + log2(l); a row with no key at all gets +1e30 (P = 0)
      if (row_lo < Lq)
        lse[(size_t)bh * Lq + row_lo] = l_lo > 0.f ? m_lo + log2f(l_lo) : 1e30f;
      if (row_hi < Lq)
        lse[(size_t)bh * Lq + row_hi] = l_hi > 0.f ? m_hi + log2f(l_hi) : 1e30f;
    }
    const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
    const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
    __nv_bfloat16* o_lo = out + ((size_t)bh * Lq + row_lo) * kD + 2 * t4;
    __nv_bfloat16* o_hi = o_lo + 8 * kD;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (row_lo < Lq)
        *reinterpret_cast<uint32_t*>(o_lo + 8 * j) =
            pack_bf16(o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo);
      if (row_hi < Lq)
        *reinterpret_cast<uint32_t*>(o_hi + 8 * j) =
            pack_bf16(o[4 * j + 2] * inv_hi, o[4 * j + 3] * inv_hi);
    }
  }
}

template <bool LSE, bool CAUSAL, int WGS>
int launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
           const uint8_t* mask, void* out, float* lse, int B, int H, int Hkv,
           int Lq, int Lk, int mask_len, float scale, cudaStream_t stream) {
  using T = Tile<WGS>;
  auto kern = flash_fwd_sm90_kernel<LSE, CAUSAL, WGS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int nqb = (Lq + T::kBQ - 1) / T::kBQ;
  const dim3 grid = CAUSAL ? dim3(B * H, nqb) : dim3(nqb, B * H);
  kern<<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      qm, km, vm, mask, static_cast<__nv_bfloat16*>(out), lse, H, Hkv, Lq, Lk,
      mask_len, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// K1 / K4 (lse null) and K7 (lse (B·H, Lq) f32): q (B, H, Lq, 128), k/v (B,
// Hkv, Lk, 128) with H % Hkv == 0, out (B, H, Lq, 128), all bf16, contiguous
// and 16-byte aligned; Lq, Lk >= 1; mask (B, Lk) uint8 (1 = attend) or null;
// scale = d^-1/2. Returns cudaGetLastError() after the launch (0 = launched),
// or cudaErrorInvalidValue when a tensor map cannot be built.
extern "C" int qie_flash_fwd_sm90(const void* q, const void* k, const void* v,
                                  const void* mask, void* out, void* lse,
                                  int B, int H, int Hkv, int Lq, int Lk,
                                  int mask_len, float scale, void* stream) {
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, Lq, B * H, 128) || !make_map(&km, k, Lk, B * Hkv, kBK) ||
      !make_map(&vm, v, Lk, B * Hkv, kBK))
    return (int)cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lse != nullptr)
    return launch<true, false, 2>(qm, km, vm, m, out, static_cast<float*>(lse),
                                  B, H, Hkv, Lq, Lk, mask_len, scale, s);
  return launch<false, false, 2>(qm, km, vm, m, out, nullptr, B, H, Hkv, Lq,
                                 Lk, mask_len, scale, s);
}

// K2: q (B, H, L, 128), k/v (B, Hkv, L, 128) with H % Hkv == 0, out (B, H, L,
// 128), all bf16, contiguous and 16-byte aligned; L >= 1; scale = d^-1/2;
// block_q = 64 or 128 query rows per CTA. Causal, no key mask. Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue when a tensor map cannot be built or block_q is
// neither.
extern "C" int qie_flash_causal_sm90(const void* q, const void* k,
                                     const void* v, void* out, int B, int H,
                                     int Hkv, int L, float scale, int block_q,
                                     void* stream) {
  CUtensorMap qm, km, vm;
  if ((block_q != 64 && block_q != 128) ||
      !make_map(&qm, q, L, B * H, block_q) ||
      !make_map(&km, k, L, B * Hkv, kBK) || !make_map(&vm, v, L, B * Hkv, kBK))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_q == 64)
    return launch<false, true, 1>(qm, km, vm, nullptr, out, nullptr, B, H, Hkv,
                                  L, L, 0, scale, s);
  return launch<false, true, 2>(qm, km, vm, nullptr, out, nullptr, B, H, Hkv,
                                L, L, 0, scale, s);
}
