// Shared pieces of the PixelCNN sampler kernels (sampler_vrow.cu,
// sampler_row.cu): the compute dtype's element, the elementwise functions
// and the PTX both kernels' weight streams are built from (mbarriers,
// cp.async.bulk copies into shared memory, shared-memory loads at 32-bit
// addresses).
//
// Each kernel is built twice: for float32, and with PM_CORE_BF16 = 1 for
// the JAX kernels' compute dtype bfloat16 (ops/sampler_chain.py:124-330).
// In the bf16 build the tensors of the compute dtype (cdt: the weight
// matrices, the code embedding, the conditional projections and the row
// state in and out) are bf16, the biases, the Gumbel noise and the logits
// float32; every product multiplies bf16 values (the A operand rounded as
// it is gathered, into float shared memory; the weights unpacked from bf16
// in registers) and sums in float32 FMAs, which is what JAX's
// preferred_element_type float32 dot computes (a product of two bf16
// values is exact in float32).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx_mma.cuh"

namespace pmk {

#ifndef PM_CORE_BF16
#define PM_CORE_BF16 0
#endif
constexpr bool kBF16 = PM_CORE_BF16;

// The compute dtype's element: bf16 (its bits) in a build with
// PM_CORE_BF16 = 1, else float; kCdtPerFloat of them take a float's bytes.
template <bool BF>
struct Elem {
  using T = float;
};
template <>
struct Elem<true> {
  using T = uint16_t;
};
using cdt = Elem<kBF16>::T;
constexpr int kCdtPerFloat = kBF16 ? 2 : 1;

// num_filters the kernels are built for: 128 (configs/pm_vqvae_celeb_a.py,
// pm_vqvae_mnist.py) and 64 (pm_vqvae_digits16.py). `return call` with F a
// constant equal to `f`, one of the built widths; cudaErrorInvalidValue for
// any other.
#define PMK_DISPATCH_WIDTHS(f, call)   \
  do {                                 \
    if ((f) == 128) {                  \
      constexpr int F = 128;           \
      return call;                     \
    }                                  \
    if ((f) == 64) {                   \
      constexpr int F = 64;            \
      return call;                     \
    }                                  \
    return (int)cudaErrorInvalidValue; \
  } while (0)

// elu in the exp(min(z, 0)) - 1 form of the JAX package's _elu
// (ops/gated_block.py:58-66), which the plain PyTorch version also uses.
__device__ __forceinline__ float elu(float z) {
  return z > 0.f ? z : expf(fminf(z, 0.f)) - 1.f;
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// An element of the compute dtype as a float (exact).
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}
// v rounded to the compute dtype (to nearest even), as a float.
__device__ __forceinline__ float round_c(float v) {
  return kBF16 ? __uint_as_float(pack_bf16(v, 0.f) << 16) : v;
}
__device__ __forceinline__ float4 round_c4(float4 v) {
  return make_float4(round_c(v.x), round_c(v.y), round_c(v.z), round_c(v.w));
}
// Four consecutive elements of the compute dtype as floats: a float4, or
// four bf16 values in one 8-byte load.
__device__ __forceinline__ float4 unpack4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 ldc4(const float* p) { return ld4(p); }
__device__ __forceinline__ float4 ldc4(const uint16_t* p) {
  return unpack4(*reinterpret_cast<const uint2*>(p));
}
// The same through the read-only path.
__device__ __forceinline__ float4 ldgc4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldgc4(const uint16_t* p) {
  return unpack4(__ldg(reinterpret_cast<const uint2*>(p)));
}
// Stores four consecutive values (rounded to bf16 where the element is).
__device__ __forceinline__ void stc4(float* p, float4 v) { st4(p, v); }
__device__ __forceinline__ void stc4(uint16_t* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// ---- mbarriers, bulk copies and shared-memory loads (PTX; smem_u32 is
// ptx_mma.cuh's)

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// Waits for the phase of the given parity to complete. A wait that never
// ends (a parity mistake) traps, so it surfaces as a launch error.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0; !mbar_try_wait(bar, parity);)
    if (++spins == (1u << 30)) __trap();
}
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// Orders this thread's earlier shared-memory accesses before its later
// bulk copies (the async proxy), e.g. other warps' reads of a slot, made
// visible to it through an atomic, before the copy that overwrites it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// A float4 at a 32-bit shared-memory address (one register where a
// generic pointer takes two).
__device__ __forceinline__ float4 lds4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}
}  // namespace pmk

extern "C" const char* pm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
