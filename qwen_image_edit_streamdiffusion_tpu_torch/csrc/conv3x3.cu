// Stride-1 SAME 3x3 convolution, NHWC activations, HWIO weights, fused bias,
// f32 accumulation; bf16 or f32 in and out.
//
// Replaces the Pallas TPU kernel
//   K3  ops/conv.py::_conv_kernel  (entry ops/conv.py::conv3x3)
// which the JAX VAE takes for every stride-1 SAME 3x3 conv with C_in <= 128 and
// C_in % 8 == 0. As on the TPU, the conv is nine per-tap products over C_in,
// accumulated in f32, the bias added in f32 and one cast to bf16.
//
// What bounds it on the H100: the flagship VAE's mix (20 launches a cache
// miss: 1024² 96→96 ×9, 96→48, 48→96, 96→3, 512² 96→96 ×6, 96→192, 128²
// 16→384) is 2.1 TFLOP, 2.1 ms at the bf16 tensor-core peak; 1024² 96→96 alone
// is 174 GFLOP (0.176 ms) on 2 × 201 MB of activations (0.120 ms at 3.35
// TB/s), so it is a tensor-core problem with a short reduction (K = C_in per
// tap, 16..128): each CTA must reuse what it stages, and copies must overlap
// the products. 96→3 (conv_out) is bound by reading its input.
//
// Design (bf16, the main path's type): an implicit GEMM on wgmma, M = 64
// output pixels (a 4 × 16 tile), N = all output channels of the CTA's slice
// (8, 48 or 96), K = 9 taps × C_in.
// - The halo by TMA: a 4-D map over (C_in, W, H, B) and a box of (ck + 8,
//   18, 6, 1) elements (ck = C_in rounded up to 16). Rows and columns outside
//   the image, and channels past C_in, are zero-filled by the copy engine, so
//   SAME padding and the K padding cost no code, and each pixel's channels
//   land (ck + 8) · 2 bytes apart: an odd multiple of 16 bytes, so the eight
//   row addresses of every ldmatrix fall in distinct banks.
// - A from registers. A tap shifted by dx is the halo shifted by dx pixel
//   rows, and a pixel row is (ck + 8) · 2 bytes: neither the 8-row core-matrix
//   alignment nor the 16-byte row pitch that a shared-memory wgmma
//   descriptor needs. ldmatrix takes any 16-byte row address, so each warp
//   loads its 16 pixels × 16 channels of the shifted window (one output row
//   of the tile) as the mma A fragment, which is wgmma's register A layout;
//   three dx-shifted copies of the halo would cost 3× its shared memory.
//   The 9 · ck / 16 k16 steps run in commit groups of 9 (any ck divides
//   them), and the A fragments of group g + 1 (36 registers) are loaded
//   while group g's products run (wgmma.wait_group 1 frees the older set).
//   A wgmma's latency is so paid once a group rather than once a step:
//   with one step a group, 96→3 (almost no MMA work) ran nearly as long as
//   96→96.
// - B from shared memory, resident: the CTA stages its N-column slice of all
//   nine taps once, as K-major core matrices (8 output channels × 8 input
//   channels, 128 contiguous bytes; no swizzle, leading offset N · 16 bytes
//   between channel octets, stride 128 bytes between output octets), and
//   the grid is persistent: one CTA per SM walks the tiles.
// - Warp specialisation: warp 8 is the producer (one thread issues every
//   TMA load into a ring of halo stages, full/empty mbarriers); warpgroups 0
//   and 1 take alternate tiles, each on its own stages, so one warpgroup's
//   products run while the other's next halo arrives.
// - Shared-memory budget (232,448 bytes a CTA): at C_in = 96, N = 96 the
//   weights are 9 · 96 · 96 · 2 = 165,888 bytes and a halo stage 6 · 18 ·
//   104 · 2 = 22,464 (22,528 aligned), so two stages fit (213,408 with the
//   barriers, the bias and the 1024-byte alignment) and four do not; N = 48 (C_in =
//   96) and the narrower C_in take four stages. C_in = 112 or 128 take
//   N = 48 (N = 96 would leave no room for two stages). F above the slice
//   width runs ceil(F / N) slices side by side (512² 96→192: 2; 128²
//   16→384: 4), each reading the halo (from L2 for the second).
// - Epilogue: bias in f32 (staged once a CTA in shared memory: nine warps
//   leave 168 registers a thread, too few to hold it), one rounding to bf16;
//   a quad transposes its accumulators with four xor shuffles so each thread
//   stores 8 consecutive channels of one pixel as one 16-byte store (F % 8
//   == 0). F = 3 (conv_out, N = 8) stores each pixel's channels as 2-byte
//   values: its 6 MB of output are 3 % of that launch's bytes. With the bias
//   read from global memory and the transpose by selects, the epilogue was
//   about a third of 96→96's time.
// - What holds it back (by count, at 1024² 96→96): shared-memory bandwidth,
//   as each m64n96k16 step reads 2 KB of A by ldmatrix and 3 KB of B, about
//   107 of the SM's 128 bytes a clock at the tensor-core peak; and the
//   epilogue, which a warpgroup runs between its own products.
// The f32 kernel (tests, f32 models) is a direct convolution on the CUDA cores:
// exact f32 FMAs from an 18x18 halo and a 9 x 16 x 32 weight slice per 16
// input channels.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using namespace qie;
using namespace qie::sm90;

// ---------------------------------------------------------------------------
// bf16: wgmma implicit GEMM
// ---------------------------------------------------------------------------

constexpr int kTH = 4;                    // output rows of a tile (one a warp)
constexpr int kTW = 16;                   // output columns of a tile
constexpr int kHH = kTH + 2;              // halo rows
constexpr int kHW = kTW + 2;              // halo columns
constexpr int kThreads = 288;             // warpgroups 0, 1 + producer warp 8
constexpr int kProducer = 256;            // the thread that issues TMA loads
constexpr int kSmemLimit = 232448;        // dynamic shared memory a CTA may use
constexpr int kGroup = 9;                 // k16 steps a wgmma commit group

// d (64 x N f32) (+)= A (64 x 16 bf16, registers: each warp's mma A fragment)
// · B (16 x N, shared memory, K-major, no swizzle)
__device__ __forceinline__ void wgmma_m64n8k16_rs(float (&d)[4], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n48k16_rs(float (&d)[24], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n96k16_rs(float (&d)[48], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  if constexpr (N == 8) wgmma_m64n8k16_rs(d, a, desc_b, scale_d);
  else if constexpr (N == 48) wgmma_m64n48k16_rs(d, a, desc_b, scale_d);
  else wgmma_m64n96k16_rs(d, a, desc_b, scale_d);
}

// Shared-memory descriptor of a K-major operand without swizzle: 8 x 16-byte
// core matrices, `lbo` bytes between the two channel octets of a k16 step,
// `sbo` bytes between consecutive 8-row groups.
__device__ __forceinline__ uint64_t desc_interleave(uint32_t addr, uint32_t lbo,
                                                    uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__host__ __device__ constexpr uint32_t round_up(uint32_t x, uint32_t m) {
  return (x + m - 1) / m * m;
}

__host__ __device__ constexpr uint32_t weight_bytes(int n, int ck) {
  return round_up(9u * ck * n * 2u, 1024u);
}

__host__ __device__ constexpr uint32_t stage_bytes(int ck) {
  return round_up((uint32_t)kHH * kHW * (ck + 8) * 2u, 128u);
}

__host__ __device__ constexpr uint32_t smem_bytes(int n, int ck, int stages) {
  return weight_bytes(n, ck) + stages * stage_bytes(ck) + 16u * stages + 4u * n +
         1024u;
}

// Shared memory (1024-byte aligned): the weight slice [9][ck / 8][N][8] bf16,
// `stages` halo stages [kHH][kHW][ck + 8] bf16, full[stages] and
// empty[stages] mbarriers, then the slice's bias [N] f32 (zero past F). The grid is nslices × (CTAs per slice); a CTA
// takes slice blockIdx.x % nslices and every (CTAs per slice)-th tile from
// blockIdx.x / nslices; tile j of the CTA goes to warpgroup j % 2 and stage
// j % stages (stages is even, so a stage always serves one warpgroup).
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_sm90_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __nv_bfloat16* __restrict__ w,
                    const __nv_bfloat16* __restrict__ bias,
                    __nv_bfloat16* __restrict__ y, int H, int W, int Cin,
                    int F, int ck, int stages, int nslices, int tiles_x,
                    int tiles_y, int ntiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const int ck8 = ck / 8;
  const int cs = ck + 8;  // halo channel pitch (elements)
  const uint32_t w_s = base;
  const uint32_t halo_s = base + weight_bytes(N, ck);
  const uint32_t sbytes = stage_bytes(ck);
  const uint32_t bars = halo_s + stages * sbytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (stages + s); };
  float* bias_s = reinterpret_cast<float*>(smem + (bars - base) + 16 * stages);

  const int f0 = (blockIdx.x % nslices) * N;
  const int cta = blockIdx.x / nslices;
  const int ncta = gridDim.x / nslices;
  const int my_tiles = cta < ntiles ? (ntiles - 1 - cta) / ncta + 1 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);  // one lane of each warp of the consumer
    }
    mbar_init_fence();
  }
  // The weight slice w[tap][c][f0 + n] → [tap][c / 8][n][c % 8], zero past
  // C_in and F: eight channels of one output channel a 16-byte store.
  for (int i = threadIdx.x; i < 9 * ck8 * N; i += kThreads) {
    const int n = i % N;
    const int c8 = (i / N) % ck8;
    const int tap = i / (N * ck8);
    const int f = f0 + n;
    uint32_t v[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int c = c8 * 8 + 2 * p;
      const uint32_t lo =
          (c < Cin && f < F)
              ? __bfloat16_as_ushort(w[((size_t)tap * Cin + c) * F + f]) : 0u;
      const uint32_t hi =
          (c + 1 < Cin && f < F)
              ? __bfloat16_as_ushort(w[((size_t)tap * Cin + c + 1) * F + f]) : 0u;
      v[p] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(smem + ((size_t)(tap * ck8 + c8) * N + n) * 16) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
  for (int n = threadIdx.x; n < N; n += kThreads)
    bias_s[n] = f0 + n < F ? __bfloat162float(bias[f0 + n]) : 0.f;
  fence_proxy_async();  // the weights are read by wgmma (the async proxy)
  __syncthreads();

  auto tile_origin = [&](int j, int& n, int& oy0, int& ox0) {
    const int t = cta + j * ncta;
    ox0 = (t % tiles_x) * kTW;
    oy0 = ((t / tiles_x) % tiles_y) * kTH;
    n = t / (tiles_x * tiles_y);
  };

  if (threadIdx.x >= kProducer) {
    // ---------------- producer: one thread issues every halo load ---------
    if (threadIdx.x == kProducer) {
      tma_prefetch_map(&x_map);
      const uint32_t box = (uint32_t)kHH * kHW * cs * 2;
      for (int j = 0; j < my_tiles; ++j) {
        const int s = j % stages;
        int n, oy0, ox0;
        tile_origin(j, n, oy0, ox0);
        mbar_wait(empty(s), ((j / stages) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), box);
        tma_load_4d(halo_s + s * sbytes, &x_map, full(s), 0, ox0 - 1, oy0 - 1, n);
      }
    }
    return;
  }

  // ---------------- consumers: warpgroup wg takes tiles wg, wg + 2, ... ---
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;  // = the tile row it computes
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int ks_n = ck / 16;   // k16 steps a tap
  const int groups = ks_n;    // 9 · ks_n steps in groups of kGroup = 9
  // ldmatrix row of this lane: pixel (lane & 8) + (lane & 7) of the warp's
  // row, channel octet lane / 16 of the k16 step
  const uint32_t a_lane =
      ((warp * kHW + (lane & 15)) * cs + (lane >> 4) * 8) * 2;

  // the bias of this lane's output channels f0 + 8jj + 2·t4 + {0, 1},
  // from shared memory in the epilogue (nine warps leave 168 registers a
  // thread: no room to hold it)
  auto bias_at = [&](int jj) {
    return *reinterpret_cast<const float2*>(bias_s + 8 * jj + 2 * t4);
  };

  for (int j = wg; j < my_tiles; j += 2) {
    const int s = j % stages;
    int n, oy0, ox0;
    tile_origin(j, n, oy0, ox0);
    const unsigned char* halo = smem + (halo_s - base) + s * sbytes + a_lane;
    // A of the kGroup steps from group gi: step st = (tap, k16 step) reads
    // the window shifted by (dy, dx) = (tap / 3, tap % 3)
    auto load_group = [&](uint32_t (&a)[kGroup][4], int gi) {
      int tap = gi * kGroup / ks_n;
      int ks = gi * kGroup - tap * ks_n;
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int dy = tap / 3;
        ldmatrix_x4(a[i], halo + ((tap + dy * (kHW - 3)) * cs + ks * 16) * 2);
        if (++ks == ks_n) {
          ks = 0;
          ++tap;
        }
      }
    };
    // the group's products; B of step st is 2 · st channel octets into the
    // slice
    auto issue_group = [&](float (&d)[N / 2], const uint32_t (&a)[kGroup][4],
                           int gi) {
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int st = gi * kGroup + i;
        wgmma_rs<N>(d, a[i],
                    desc_interleave(w_s + (uint32_t)st * 32u * N, N * 16, 128),
                    st > 0);
      }
      wgmma_commit();
    };

    // Group gi + 1's A loads while group gi's products run: two groups of
    // registers, wgmma.wait_group 1 frees the older one.
    float acc[N / 2];
    uint32_t a0[kGroup][4], a1[kGroup][4];
    mbar_wait(full(s), (j / stages) & 1);
    load_group(a0, 0);
    for (int gi = 0; gi < groups; gi += 2) {
      issue_group(acc, a0, gi);
      wgmma_wait<1>();  // group gi - 1 has retired: a1 is free
      if (gi + 1 < groups) {
        load_group(a1, gi + 1);
        issue_group(acc, a1, gi + 1);
        wgmma_wait<1>();  // group gi has retired: a0 is free
        if (gi + 2 < groups) load_group(a0, gi + 2);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));  // this warp has read the stage
    wgmma_wait<0>();
    fence_regs(acc);

    // Epilogue: register 4j + e is (tile pixel 16·warp + g + 8·(e / 2),
    // channel f0 + 8j + 2·t4 + e % 2).
    const int oy = oy0 + warp;
    const int px = ox0 + g;  // and px + 8
    __nv_bfloat16* y_row = y + ((size_t)n * H + oy) * W * F;
    if (F % 8 == 0 && (N / 8) % 2 == 0) {
      // Quad transpose: lane t4 holds x[q], the packed pairs of (row g,
      // octet 2i), (g + 8, 2i), (g, 2i + 1), (g + 8, 2i + 1); after it, x[k]
      // is lane k's pair t4, so the lane holds all eight channels of one
      // pixel. Two xor-shuffle stages: swap the off-diagonal 2 x 2 blocks
      // (lane bit 1), then transpose within each block (lane bit 0).
      const int hi = t4 >> 1, lo = t4 & 1;
      const int ox = px + 8 * lo;
#pragma unroll
      for (int i = 0; i < N / 16; ++i) {
        uint32_t x[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int jj = 2 * i + (q >> 1);
          const int e = 2 * (q & 1);
          const float2 b = bias_at(jj);
          x[q] = pack_bf16(acc[4 * jj + e] + b.x, acc[4 * jj + e + 1] + b.y);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t v = __shfl_xor_sync(0xffffffffu, hi ? x[r] : x[2 + r], 2);
          if (hi) x[r] = v; else x[2 + r] = v;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t v =
              __shfl_xor_sync(0xffffffffu, lo ? x[2 * r] : x[2 * r + 1], 1);
          if (lo) x[2 * r] = v; else x[2 * r + 1] = v;
        }
        const int f = f0 + 8 * (2 * i + hi);
        if (oy < H && ox < W && f < F)
          *reinterpret_cast<uint4*>(y_row + (size_t)ox * F + f) =
              make_uint4(x[0], x[1], x[2], x[3]);
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ox = px + 8 * (e >> 1);
          const int f = f0 + 8 * jj + 2 * t4 + (e & 1);
          const float2 b = bias_at(jj);
          if (oy < H && ox < W && f < F)
            y_row[(size_t)ox * F + f] =
                __float2bfloat16(acc[4 * jj + e] + ((e & 1) ? b.y : b.x));
        }
    }
  }
}

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <int N>
int launch_sm90_n(const CUtensorMap& map, const void* w, const void* b,
                  void* y, int B, int H, int W, int Cin, int F, int ck,
                  int stages, cudaStream_t stream) {
  auto kern = conv3x3_sm90_kernel<N>;
  const int smem = (int)smem_bytes(N, ck, stages);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + kTW - 1) / kTW;
  const int tiles_y = (H + kTH - 1) / kTH;
  const int ntiles = B * tiles_x * tiles_y;
  const int nslices = (F + N - 1) / N;
  int per_slice = num_sms() / nslices;
  per_slice = per_slice < 1 ? 1 : per_slice > ntiles ? ntiles : per_slice;
  kern<<<nslices * per_slice, kThreads, smem, stream>>>(
      map, static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(y), H,
      W, Cin, F, ck, stages, nslices, tiles_x, tiles_y, ntiles);
  return (int)cudaGetLastError();
}

int launch_sm90(const void* x, const void* w, const void* b, void* y, int B,
                int H, int W, int Cin, int F, cudaStream_t stream) {
  const int ck = (Cin + 15) / 16 * 16;
  // N: the slice width; 96 only where two halo stages fit beside its weights
  const int n = F <= 8 ? 8
                : (F <= 48 || smem_bytes(96, ck, 2) > (uint32_t)kSmemLimit) ? 48
                                                                          : 96;
  const int stages = smem_bytes(n, ck, 4) <= (uint32_t)kSmemLimit ? 4 : 2;
  CUtensorMap map;
  if (!make_map_nhwc(&map, x, B, H, W, Cin, ck + 8, kHW, kHH))
    return (int)cudaErrorInvalidValue;
  if (n == 8)
    return launch_sm90_n<8>(map, w, b, y, B, H, W, Cin, F, ck, stages, stream);
  if (n == 48)
    return launch_sm90_n<48>(map, w, b, y, B, H, W, Cin, F, ck, stages, stream);
  return launch_sm90_n<96>(map, w, b, y, B, H, W, Cin, F, ck, stages, stream);
}

// ---------------------------------------------------------------------------
// f32: direct convolution on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kTile = 16;          // 16 x 16 output pixels per CTA
constexpr int kHalo = kTile + 2;   // 18
constexpr int kCK = 16;            // input channels staged per pass
constexpr int kFB = 32;            // output channels per CTA
constexpr int kF32Threads = kTile * kTile;

__global__ void __launch_bounds__(kF32Threads)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int H, int W, int Cin, int F, int nfb) {
  __shared__ float in_s[kCK][kHalo][kHalo];
  __shared__ __align__(16) float w_s[9][kCK][kFB];

  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
  const int ox0 = blockIdx.x * kTile;
  const int oy0 = blockIdx.y * kTile;
  const int n = blockIdx.z / nfb;
  const int f0 = (blockIdx.z % nfb) * kFB;
  const float* x_n = x + (size_t)n * H * W * Cin;

  float acc[kFB];
#pragma unroll
  for (int f = 0; f < kFB; ++f) acc[f] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += kCK) {
    __syncthreads();
    // halo window, channel-fastest so global reads are contiguous
    for (int i = threadIdx.x; i < kHalo * kHalo * kCK; i += kF32Threads) {
      const int ci = i % kCK;
      const int p = i / kCK;
      const int xx = p % kHalo;
      const int yy = p / kHalo;
      const int gy = oy0 + yy - 1;
      const int gx = ox0 + xx - 1;
      float val = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + ci < Cin)
        val = x_n[((size_t)gy * W + gx) * Cin + c0 + ci];
      in_s[ci][yy][xx] = val;
    }
    // weight slice w[tap][c0 + ci][f0 + f]
    for (int i = threadIdx.x; i < 9 * kCK * kFB; i += kF32Threads) {
      const int f = i % kFB;
      const int ci = (i / kFB) % kCK;
      const int tap = i / (kFB * kCK);
      float val = 0.f;
      if (c0 + ci < Cin && f0 + f < F)
        val = w[((size_t)tap * Cin + c0 + ci) * F + f0 + f];
      w_s[tap][ci][f] = val;
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
#pragma unroll 4
      for (int ci = 0; ci < kCK; ++ci) {
        const float xv = in_s[ci][ty + dy][tx + dx];
        const float4* wv = reinterpret_cast<const float4*>(&w_s[tap][ci][0]);
#pragma unroll
        for (int f4 = 0; f4 < kFB / 4; ++f4) {
          const float4 ww = wv[f4];
          acc[4 * f4 + 0] += xv * ww.x;
          acc[4 * f4 + 1] += xv * ww.y;
          acc[4 * f4 + 2] += xv * ww.z;
          acc[4 * f4 + 3] += xv * ww.w;
        }
      }
    }
  }

  const int oy = oy0 + ty;
  const int ox = ox0 + tx;
  if (oy < H && ox < W) {
    float* y_p = y + (((size_t)n * H + oy) * W + ox) * F;
#pragma unroll
    for (int f = 0; f < kFB; ++f) {
      if (f0 + f < F) y_p[f0 + f] = acc[f] + bias[f0 + f];
    }
  }
}

int launch_f32(const void* x, const void* w, const void* b, void* y, int B,
               int H, int W, int Cin, int F, cudaStream_t stream) {
  const int nfb = (F + kFB - 1) / kFB;
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B * nfb);
  conv3x3_f32_kernel<<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(y), H, W, Cin, F, nfb);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, H, W, Cin), w (3, 3, Cin, F), b (F,), y (B, H, W, F), contiguous and
// 16-byte aligned; Cin % 8 == 0, Cin <= 128; dtype 0 = f32, 1 = bf16.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue when
// the tensor map cannot be built.
extern "C" int qie_conv3x3(const void* x, const void* w, const void* b,
                           void* y, int B, int H, int W, int Cin, int F,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_sm90(x, w, b, y, B, H, W, Cin, F, s);
  return launch_f32(x, w, b, y, B, H, W, Cin, F, s);
}
