// Shared device helpers of the bf16 kernels: ldmatrix (the conv's A
// fragments, conv3x3.cu), bf16 packing, and the key-mask rule of the forward
// and backward flash kernels (flash_fwd_sm90.cu, flash_attention_bwd.cu).
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4), which is
// each warp's slice of the wgmma register A operand and accumulator:
//   A regs 0..3: (row g, cols 2t..2t+1), (g+8, 2t), (g, 2t+8), (g+8, 2t+8);
//   B regs 0..1: (k 2t..2t+1, col g), (k 2t+8.., col g);
//   C/D 0..3:    (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1).
// So the f32 accumulator of one product, rounded to bf16 pairs, is the A
// operand of the next: two adjacent 16x8 C tiles make one 16x16 A tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qie {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8 (any 16-byte aligned address).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return as_u32(__floats2bfloat162_rn(lo, hi));
}

// The key-mask rule of the forward (K1, K4, K7) and backward (K8, K9)
// kernels, key by key: the (B, Lk) mask applies to key `col` when its
// 64-key group lies below mask_len or holds the ragged tail; elsewhere the
// key is taken as valid. The same rule in all of them, whatever their block
// sizes, so a key the forward masks has P = 0, dK = 0 and dV = 0.
constexpr int kMaskGroup = 64;

__device__ __forceinline__ bool mask_applies(int col, int Lk, int mask_len) {
  const int k0 = col & ~(kMaskGroup - 1);
  return k0 < mask_len || k0 + kMaskGroup > Lk;
}

}  // namespace qie
