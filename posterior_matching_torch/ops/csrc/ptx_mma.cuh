// The PTX helpers of the hand-written kernels, shared by the gated chain's
// core (gated_common.cuh), the VDVAE chains' core (vdvae_gemm.cuh), the
// codebook search (vq_search.cu) and the sampler kernels (sampler_common.cuh):
// TF32 rounding and its 3xTF32 split, the tensor cores' mma.sync in TF32 and
// in bf16 with the bf16 rounding its operands need, cp.async copies into
// shared memory, and shared-memory addresses. Device functions only, no
// kernels. The CPU emulation of the kernels (tests/cuda_emulation) replaces
// the body of each helper that holds inline PTX.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// x rounded to TF32 (10 fraction bits, to nearest, ties away from zero),
// as its bits: cvt.rna.tf32.f32's rounding for finite x and infinities, in
// two integer operations (half an ulp added to the magnitude, the low 13
// bits cleared). The conversion instruction itself runs on a slower pipe;
// with it, B's split in the gated chain's MMA loop cost ~0.9 ms more a
// stream backward on the H100.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// An operand element split for 3xTF32: big = x rounded to TF32, small =
// x - big, exact in float32 and at most half an ulp of big. small is not
// rounded: the tensor cores read its top 11 significant bits, which leaves
// an error of at most 2^-21 |x| (rounding it first: 2^-22).
__device__ __forceinline__ float2 split_tf32(float x) {
  const float big = __uint_as_float(to_tf32(x));
  return make_float2(big, x - big);
}

// d += A B for one m16n8k8 TF32 fragment (warp-collective): a[4], b[2] and
// d[4] in the PTX ISA's fragment layout.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// lo and hi rounded to bf16 (to nearest even), packed: lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d += A B for one m16n8k16 bf16 fragment with float32 accumulators
// (warp-collective): a[4] (rows g, g + 8 at k 2t, 2t + 1, then at k 2t + 8,
// 2t + 9), b[2] (k 2t, 2t + 1 and 2t + 8, 2t + 9 at n = g), d[4] as
// mma_tf32's, each register two bf16 values, the lower k in the low half.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copies `bytes` (0 or 16) from global `src` to shared `dst`, zero-filling
// the rest of the 16.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
// The same for 4 bytes (0 or 4), for rows that are not 16-byte aligned.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most NS - 2 of this thread's committed groups are
// pending: the oldest chunk of a ring of NS stages has landed.
template <int NS>
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NS - 2) : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
