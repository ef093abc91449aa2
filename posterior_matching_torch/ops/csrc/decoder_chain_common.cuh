// Shared pieces of the VDVAE decoder-chain kernels (decoder_chain_fwd.cu,
// decoder_chain_bwd.cu): the geometry and pointer layout of their C entry
// points, the per-level strides of the 34 weight stacks, and the softplus
// of the z sample. The products themselves run on vdvae_gemm.cuh's core.
//
// A level of a run has four bottleneck Blocks, in the order of
// ops/decoder_chain.py::NAMES: p (posterior, on [x, acts], 2 LD outputs),
// m (masked posterior, on [x, macts], LD + TRIL), q (prior, on x, 2 LD + C:
// the prior's head and the tail that joins the state) and r (the residual
// resnet, on u, C); then the z projection wz [LD, C], bz [C]. The
// encoder-activation width equals the state width C.
//
// Each source is built twice: in float32 and with -DPM_CORE_BF16=1 for
// compute_dtype bfloat16 (ops/_build.py's *_bf16 libraries), where, as in
// the Pallas kernels (decoder_chain.py:148-218, :298-299), the four
// Blocks' c1..c3 and their gradients are bf16 products with float32 sums
// (their weights and the twelve h saves bf16), and every c4, the z path,
// the state and every gradient stay float32.
#pragma once

#define PM_CORE_NS dck
#include "vdvae_gemm.cuh"

namespace dck {

// Integer arguments: (L, B, H, W, C, M, K), then the latent width, in the
// order of ops/decoder_chain.py::_GEOMETRY.
enum DecInt { I_LD = I_COUNT, I_DCOUNT };

inline bool dec_geometry_ok(const int* ints) {
  return geometry_ok(ints) && ints[I_LD] >= 1;
}

// The Blocks of a level and the eight stacks of each.
enum Blk { BP = 0, BM = 1, BQ = 2, BR = 3 };
enum Wi { W1 = 0, B1, W2, B2, W3, B3, W4, B4 };
constexpr int kWeights = 34;  // 4 Blocks x 8, then wz and bz
constexpr int WZ = 32, BZ = 33;
constexpr int kZThreads = 256;  // threads of the z step's kernels

// (width, bottleneck, latent) triples the kernels are built for: PM-VDVAE
// MNIST (configs/pm_vdvae_mnist.py: 192, 0.25, 16) and digits16
// (configs/pm_vdvae_digits16.py: 64, 0.25, 8). `return run<C, M, LD>(...)`
// for the geometry's triple, cudaErrorInvalidValue for any other.
#define DCK_DISPATCH_WIDTHS(ints, call)                                   \
  do {                                                                    \
    const int c_ = (ints)[I_C], m_ = (ints)[I_M], ld_ = (ints)[I_LD];     \
    if (c_ == 192 && m_ == 48 && ld_ == 16) {                             \
      constexpr int C = 192, M = 48, LD = 16;                             \
      return call;                                                        \
    }                                                                     \
    if (c_ == 64 && m_ == 16 && ld_ == 8) {                               \
      constexpr int C = 64, M = 16, LD = 8;                               \
      return call;                                                        \
    }                                                                     \
    return (int)cudaErrorInvalidValue;                                    \
  } while (0)

template <int C, int M, int LD>
struct Dims {
  static constexpr int MW = LD + LD * (LD + 1) / 2;  // masked posterior's outputs
  static constexpr int QW = 2 * LD + C;               // prior's outputs
  static constexpr int cin(int b) { return b == BP || b == BM ? 2 * C : C; }
  static constexpr int cout(int b) {
    return b == BP ? 2 * LD : b == BM ? MW : b == BQ ? QW : C;
  }
  // floats of one level of weight stack i (0 .. 33), k x k taps in c2, c3
  static size_t stride(int i, int k) {
    if (i == WZ) return (size_t)LD * C;
    if (i == BZ) return C;
    const int b = i / 8;
    switch (i % 8) {
      case W1: return (size_t)cin(b) * M;
      case W2: case W3: return (size_t)k * k * M * M;
      case W4: return (size_t)M * cout(b);
      case B4: return cout(b);
      default: return M;  // b1, b2, b3
    }
  }
};

// softplus(x) = max(x, 0) + log1p(exp(-|x|)), stable for every x
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// u[r][c] += bz[c] + sum_j z[r][j] wz[j][c], with z = loc + (softplus(raw)
// + 1e-5) eps from the level's posterior outputs [loc | raw] and noise.
// A block: kZRows rows, their z staged in shared memory.
constexpr int kZRows = 8;

template <int C, int LD>
__global__ void __launch_bounds__(kZThreads)
    z_into_state(const float* __restrict__ post, const float* __restrict__ eps,
                 const float* __restrict__ wz, const float* __restrict__ bz,
                 float* __restrict__ u, int R) {
  extern __shared__ __align__(16) float smem[];
  float* sz = smem;  // [kZRows][LD]
  const int r0 = blockIdx.x * kZRows;
  for (int i = threadIdx.x; i < kZRows * LD; i += kZThreads) {
    const int r = r0 + i / LD, j = i % LD;
    float z = 0.f;
    if (r < R) {
      const size_t o = (size_t)r * 2 * LD;
      z = post[o + j] + (softplus(post[o + LD + j]) + 1e-5f) * eps[(size_t)r * LD + j];
    }
    sz[i] = z;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kZRows * C; i += kZThreads) {
    const int rr = i / C, c = i % C, r = r0 + rr;
    if (r >= R) break;
    float acc = bz[c];
#pragma unroll
    for (int j = 0; j < LD; ++j) acc = fmaf(sz[rr * LD + j], wz[j * C + c], acc);
    u[(size_t)r * C + c] += acc;
  }
}

}  // namespace dck

extern "C" const char* pm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
