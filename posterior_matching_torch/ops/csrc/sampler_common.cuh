// Shared pieces of the PixelCNN sampler kernels (sampler_vrow.cu,
// sampler_row.cu): the elementwise functions and a block-wide float32 GEMM
// whose A operand is produced element by element by a caller's functor, so
// each level's concat_elu / shifted-tap prologue is fused into the operand
// load instead of being written out.
#pragma once

#include <cuda_runtime.h>

namespace pmk {

constexpr int kThreads = 256;  // threads per block, both kernels
constexpr int kF = 128;        // num_filters the kernels are built for
constexpr int kKC = 16;        // depth of one staged K chunk

// elu in the exp(min(z, 0)) - 1 form of the JAX package's _elu
// (ops/gated_block.py:58-66), which the plain PyTorch version also uses.
__device__ __forceinline__ float elu(float z) {
  return z > 0.f ? z : expf(fminf(z, 0.f)) - 1.f;
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

// Element k of concat_elu(x) for a C-wide row x: elu(x[k]) for k < C,
// elu(-x[k - C]) after.
__device__ __forceinline__ float celu_at(const float* x, int k, int C) {
  return k < C ? elu(x[k]) : elu(-x[k - C]);
}

// Register tile of a block-wide [M, N] product. Thread t owns rows
// (t / TC) * TM + i and columns col(u): the first TN/2 in the left half of
// N, the other TN/2 at the same offsets in the right half, so a gated
// epilogue finds act column j and gate column j + N/2 in one thread.
template <int M, int N, int TM, int TN>
struct Tile {
  static constexpr int TC = N / TN;
  static_assert((M / TM) * TC == kThreads, "tile must cover the block");
  static_assert(M % TM == 0 && TN % 2 == 0 && (N / 2) % (TN / 2) == 0, "");
  __device__ static int row(int i) { return (threadIdx.x / TC) * TM + i; }
  __device__ static int col(int u) {
    return (u < TN / 2 ? 0 : N / 2) + (threadIdx.x % TC) * (TN / 2) +
           u % (TN / 2);
  }
};

// V consecutive shared-memory floats into registers, as 16- or 8-byte loads
// where V allows (src is aligned to them at every call site).
template <int V>
__device__ __forceinline__ void load_run(float* dst, const float* src) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int v = 0; v < V; v += 4) {
      const float4 q = *reinterpret_cast<const float4*>(src + v);
      dst[v] = q.x;
      dst[v + 1] = q.y;
      dst[v + 2] = q.z;
      dst[v + 3] = q.w;
    }
  } else if constexpr (V % 2 == 0) {
#pragma unroll
    for (int v = 0; v < V; v += 2) {
      const float2 q = *reinterpret_cast<const float2*>(src + v);
      dst[v] = q.x;
      dst[v + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) dst[v] = src[v];
  }
}

// acc += A[M, K] @ W[K, N] in float32 (no tensor cores, no TF32).
// A[r][k] = aload(r, k); W is row-major with leading dimension ldw and must
// be 16-byte aligned with N and ldw multiples of 4; K a multiple of kKC.
// sA holds kKC * (M + 4) floats, sW kKC * N floats. Every thread of the
// block must call it; it synchronises the block before it returns.
template <int M, int N, int TM, int TN, class ALoad>
__device__ __forceinline__ void gemm_acc(float (&acc)[TM][TN],
                                         const ALoad& aload, int K,
                                         const float* __restrict__ W, int ldw,
                                         float* sA, float* sW) {
  using T = Tile<M, N, TM, TN>;
  constexpr int LDA = M + 4;
  const int tid = threadIdx.x;
  const int tr = tid / T::TC, tc = tid % T::TC;
  float4* sW4 = reinterpret_cast<float4*>(sW);
  for (int k0 = 0; k0 < K; k0 += kKC) {
    for (int i = tid; i < M * kKC; i += kThreads) {
      const int kk = i % kKC, r = i / kKC;
      sA[kk * LDA + r] = aload(r, k0 + kk);
    }
    for (int i = tid; i < kKC * (N / 4); i += kThreads) {
      const int kk = i / (N / 4), c4 = i % (N / 4);
      sW4[i] = __ldg(reinterpret_cast<const float4*>(
                         W + (size_t)(k0 + kk) * ldw) + c4);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKC; ++kk) {
      float a[TM], w[TN];
      load_run<TM>(a, sA + kk * LDA + tr * TM);
      load_run<TN / 2>(w, sW + kk * N + tc * (TN / 2));
      load_run<TN / 2>(w + TN / 2, sW + kk * N + N / 2 + tc * (TN / 2));
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int u = 0; u < TN; ++u) acc[i][u] = fmaf(a[i], w[u], acc[i][u]);
    }
    __syncthreads();
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int u = 0; u < TN; ++u) acc[i][u] = 0.f;
}

}  // namespace pmk

extern "C" const char* pm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
