// Shared pieces of the VDVAE block-chain kernels (block_chain_fwd.cu,
// block_chain_bwd.cu): tanh-gelu and its derivative, the argument layout of
// the C entry points, and `chain_gemm`, a block-tiled float32 GEMM over the
// B*H*W rows of a run whose A operand is gathered term by term (a conv tap
// is a term: a source tensor read at a shifted position, zero outside the
// image, optionally through gelu) and whose epilogue is the bias, the bias
// and the residual, or gelu's derivative times the product.
//
// The chain width C and bottleneck width M are template parameters; the
// entry points instantiate the pairs of the repo's PM-VDVAE configs (see
// BCK_DISPATCH_WIDTHS).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bck {

constexpr int kThreads = 256;     // threads per block of every GEMM kernel
constexpr int kKC = 16;           // depth of one staged K chunk
constexpr int kMaxTaps = 9;
constexpr int kSplitRows = 1024;  // rows summed by one weight-gradient block

// Integer arguments, in the order of ops/block_chain.py::_GEOMETRY.
enum GeoInt { I_L, I_B, I_H, I_W, I_C, I_M, I_K, I_COUNT };

struct Geo {
  int R, B, H, W, HW;
};

inline Geo make_geo(const int* ints) {
  Geo g;
  g.B = ints[I_B];
  g.H = ints[I_H];
  g.W = ints[I_W];
  g.HW = g.H * g.W;
  g.R = g.B * g.HW;
  return g;
}

inline bool geometry_ok(const int* ints) {
  return ints[I_L] >= 1 && ints[I_B] >= 1 && ints[I_H] >= 1 &&
         ints[I_W] >= 1 && (ints[I_K] == 1 || ints[I_K] == 3);
}

// Weight-gradient row splits of a run of g.R rows.
inline int n_splits(const Geo& g) { return (g.R + kSplitRows - 1) / kSplitRows; }

// (width, bottleneck) pairs the kernels are built for: PM-VDVAE MNIST
// (configs/pm_vdvae_mnist.py, 192 x 0.25) and digits16
// (configs/pm_vdvae_digits16.py, 64 x 0.25). `return run<C, M>(...)` for the
// geometry's pair, cudaErrorInvalidValue for any other.
#define BCK_DISPATCH_WIDTHS(ints, call)           \
  do {                                            \
    const int c_ = (ints)[I_C], m_ = (ints)[I_M]; \
    if (c_ == 192 && m_ == 48) {                  \
      constexpr int C = 192, M = 48;              \
      return call;                                \
    }                                             \
    if (c_ == 64 && m_ == 16) {                   \
      constexpr int C = 64, M = 16;               \
      return call;                                \
    }                                             \
    return (int)cudaErrorInvalidValue;            \
  } while (0)

// A product with N output columns: each thread owns 4 rows x TN adjacent
// columns; NCG column groups x TM / 4 row groups fill the 256 threads.
template <int N>
struct Tile {
  static constexpr int NCG = N > 64 ? 32 : 16;   // column groups
  static constexpr int TN = N / NCG;             // 6 (N = 192) ... 1 (N = 16)
  static constexpr int TM = kThreads / NCG * 4;  // 32 or 64 rows a block
  static constexpr int LDA = TM + 4;             // row pitch of the staged A
  static_assert(N % NCG == 0 && TM % 16 == 0, "tile");
};

// ---- tanh-gelu (jax.nn.gelu's default, F.gelu(approximate="tanh")) -----
constexpr float kGeluC = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluA = 0.044715f;

__device__ __forceinline__ float gelu(float z) {
  const float t = tanhf(kGeluC * (z + kGeluA * z * z * z));
  return 0.5f * z * (1.f + t);
}

// d gelu / dz, as ops/block_chain.py::_gelu_grad of the JAX package.
__device__ __forceinline__ float gelu_grad(float z) {
  const float t = tanhf(kGeluC * (z + kGeluA * z * z * z));
  const float du = kGeluC * (1.f + 3.f * kGeluA * z * z);
  return 0.5f * (1.f + t) + 0.5f * z * (1.f - t * t) * du;
}

// ---- chain_gemm ----------------------------------------------------------

enum AMode { A_IDENT = 0, A_GELU = 1 };
enum Epi { E_BIAS = 0, E_BIAS_RES = 1, E_GELU_BWD = 2 };

// One term: acc[r, n] += sum_k A(r, k) B(k, n), where A(r, k) is row r of
// `src` (K wide) read at r's position shifted by (dy, dx), zero off the
// image, through gelu with A_GELU; B(k, n) = w[k * ld + n], or w[n * ld + k]
// with `trans`.
struct Term {
  const float* src;
  const float* w;
  int K, dy, dx, ld, trans;
};

struct GemmArgs {
  Term t[kMaxTaps];
  int nt, amode, epi;
  Geo g;
  const float* bias;  // [N] (E_BIAS, E_BIAS_RES)
  const float* res;   // [R, N] residual addend (E_BIAS_RES)
  const float* z;     // [R, N] gelu's argument (E_GELU_BWD)
  const float* base;  // [R, N] addend (E_GELU_BWD), or null
  float* out;         // [R, N]
};

// acc[i][u] += the staged chunk's product; thread (tr, tc) owns rows
// tr * 4 + i and columns tc * TN + u.
template <int N>
__device__ __forceinline__ void mma_chunk(float (&acc)[4][Tile<N>::TN],
                                          const float* sA, const float* sB) {
  using T = Tile<N>;
  const int tr = threadIdx.x / T::NCG, tc = threadIdx.x % T::NCG;
#pragma unroll 4
  for (int k = 0; k < kKC; ++k) {
    const float4 a4 = *reinterpret_cast<const float4*>(sA + k * T::LDA + tr * 4);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    float b[T::TN];
#pragma unroll
    for (int u = 0; u < T::TN; ++u) b[u] = sB[k * N + tc * T::TN + u];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < T::TN; ++u) acc[i][u] = fmaf(a[i], b[u], acc[i][u]);
  }
}

// out = epilogue(sum_terms A_t @ B_t) for rows [TM * blockIdx.x, + TM) and
// all N columns.
template <int N>
__global__ void __launch_bounds__(kThreads) chain_gemm(const GemmArgs p) {
  using T = Tile<N>;
  constexpr int TN = T::TN, TM = T::TM, LDA = T::LDA;
  constexpr int HS = TM / 16;  // A rows this thread stages per chunk
  __shared__ __align__(16) float sA[kKC * LDA];
  __shared__ __align__(16) float sB[kKC * N];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * TM;
  const Geo g = p.g;
  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < TN; ++u) acc[i][u] = 0.f;

  // this thread stages A rows m0 + 16 h at chunk column kk
  const int kk = tid % kKC, m0 = tid / kKC;
  for (int ti = 0; ti < p.nt; ++ti) {
    const Term tm = p.t[ti];
    long srow[HS];
#pragma unroll
    for (int h = 0; h < HS; ++h) {
      const int r = r0 + m0 + 16 * h;
      srow[h] = -1;
      if (r < g.R) {
        const int pos = r % g.HW;
        const int yy = pos / g.W + tm.dy, xx = pos % g.W + tm.dx;
        if (yy >= 0 && yy < g.H && xx >= 0 && xx < g.W)
          srow[h] = r + tm.dy * g.W + tm.dx;
      }
    }
    for (int k0 = 0; k0 < tm.K; k0 += kKC) {
      const int k = k0 + kk;
#pragma unroll
      for (int h = 0; h < HS; ++h) {
        float v = 0.f;
        if (srow[h] >= 0 && k < tm.K) {
          v = tm.src[srow[h] * tm.K + k];
          if (p.amode == A_GELU) v = gelu(v);
        }
        sA[kk * LDA + m0 + 16 * h] = v;
      }
      for (int i = tid; i < kKC * N; i += kThreads) {
        int kr, n;
        size_t idx;
        if (!tm.trans) {
          kr = i / N;
          n = i % N;
          idx = (size_t)(k0 + kr) * tm.ld + n;
        } else {
          kr = i % kKC;
          n = i / kKC;
          idx = (size_t)n * tm.ld + k0 + kr;
        }
        sB[kr * N + n] = k0 + kr < tm.K ? __ldg(tm.w + idx) : 0.f;
      }
      __syncthreads();
      mma_chunk<N>(acc, sA, sB);
      __syncthreads();
    }
  }

  const int tr = tid / T::NCG, tc = tid % T::NCG;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + tr * 4 + i;
    if (r >= g.R) continue;
#pragma unroll
    for (int u = 0; u < TN; ++u) {
      const int c = tc * TN + u;
      const size_t o = (size_t)r * N + c;
      float v = acc[i][u];
      if (p.epi == E_BIAS) {
        v += p.bias[c];
      } else if (p.epi == E_BIAS_RES) {
        v += p.bias[c] + p.res[o];
      } else {  // E_GELU_BWD
        v *= gelu_grad(p.z[o]);
        if (p.base) v += p.base[o];
      }
      p.out[o] = v;
    }
  }
}

template <int N>
inline void launch_gemm(const GemmArgs& a, cudaStream_t stream) {
  chain_gemm<N><<<(a.g.R + Tile<N>::TM - 1) / Tile<N>::TM, kThreads, 0, stream>>>(a);
}

// A term per tap of a k x k SAME conv over `src` (K wide) with the tap-major
// kernel `w` ([k * k * K, ld] rows, tap t = (t / k, t % k)); `sign` -1
// mirrors the taps (the input gradient).
inline void add_taps(GemmArgs& a, int k, int sign, const float* src, int K,
                     const float* w, int ld, int trans) {
  const int pad = k / 2;
  for (int t = 0; t < k * k; ++t)
    a.t[a.nt++] = Term{src, w + (size_t)t * K * ld, K,
                       sign * (t / k - pad), sign * (t % k - pad), ld, trans};
}

}  // namespace bck

extern "C" const char* pm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
