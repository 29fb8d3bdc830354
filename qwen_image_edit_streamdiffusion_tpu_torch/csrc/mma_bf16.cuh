// Shared device helpers of the flash-attention kernels: cp.async copies,
// ldmatrix and mma.sync m16n8k16 on bf16 with f32 accumulators (K2,
// flash_attention.cu), bf16 packing, and the key-mask rule of the forward
// and backward kernels (flash_fwd_sm90.cu, flash_attention_bwd.cu).
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
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

// 16-byte global → shared copy; zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d (16x8 f32) += a (16x16 bf16, row) · b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
