// Shared pieces of the VDVAE chain kernels (block_chain_{fwd,bwd}.cu and
// decoder_chain_{fwd,bwd}.cu): tanh-gelu and its derivative, the argument
// layout of the block chain's C entry points, `chain_gemm`, a block-tiled
// float32 GEMM over the B*H*W rows of a run whose A operand is gathered term
// by term (a conv tap is a term: a source tensor read at a shifted position,
// zero outside the image, optionally through gelu) and whose epilogue is the
// bias, the bias and the residual, or gelu's derivative times the product;
// and `wgrad`, the weight gradients of all levels of a run in one launch,
// summed over row splits in a fixed order.
//
// The chain width C and bottleneck width M are template parameters; the
// entry points instantiate the pairs of the repo's PM-VDVAE configs (see
// BCK_DISPATCH_WIDTHS). Everything lives in namespace PM_CHAIN_NS: bck, or
// what the including file defines (the decoder chain's dck), so that a
// profile tells the two libraries' kernels apart by name.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef PM_CHAIN_NS
#define PM_CHAIN_NS bck
#endif

namespace PM_CHAIN_NS {

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
// columns; NCG column groups x TM / 4 row groups fill the 256 threads. NCG
// is 32 (N > 64) or 16 where that divides N, else 8 or 4: the decoder
// chain's masked-posterior heads (152 = 8 x 19, 44 = 4 x 11 columns).
template <int N>
struct Tile {
  static constexpr int NCG0 = N > 64 ? 32 : 16;
  static constexpr int NCG = N % NCG0 == 0 ? NCG0 : (N % 8 == 0 ? 8 : 4);
  static constexpr int TN = N / NCG;             // 6 (N = 192) ... 1 (N = 16)
  static constexpr int TM = kThreads / NCG * 4;  // 32 ... 256 rows a block
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

// ---- weight gradients ------------------------------------------------------

// One weight-gradient product of every level: rows orow + t * Kin + i,
// columns ocol + n of level l's dW (a stack of `rows` rows of ldo floats a
// level; ldo 0 means N) get
//   sum_r A_l(r + shift_t, i) * G_l[r][n]
// over the rows of split s, for i in the block's tile. A_l is src at
// src + l * lsrc (lsrc 0: the same for every level), or with src0 level l's
// input (src0 at l = 0, else src's level l - 1); through gelu with `gelu`.
struct WgArgs {
  const float* src0;
  const float* src;
  size_t lsrc;
  const float* gs;   // [L, R, N]
  int Kin, k, S, gelu;
  int rows, orow, ldo, ocol;
  float* out;        // S == 1: dW [L, rows, ldo]; else partials [L, S, k*k*Kin, N]
  Geo g;
};

template <int N>
__global__ void __launch_bounds__(kThreads) wgrad(const WgArgs p) {
  using T = Tile<N>;
  constexpr int TM = T::TM, LDA = T::LDA, TN = T::TN;
  constexpr int RP = kThreads / TM;  // rows staged per pass
  __shared__ __align__(16) float sA[kKC * LDA];
  __shared__ __align__(16) float sB[kKC * N];
  const Geo g = p.g;
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * TM, t = blockIdx.y;
  const int l = blockIdx.z / p.S, s = blockIdx.z % p.S;
  const float* src = p.src0 ? (l ? p.src + (l - 1) * p.lsrc : p.src0) : p.src + l * p.lsrc;
  const float* gl = p.gs + (size_t)l * g.R * N;
  const int pad = p.k / 2;
  const int dy = t / p.k - pad, dx = t % p.k - pad;
  const int rbeg = s * kSplitRows;
  const int rend = min(g.R, rbeg + kSplitRows);
  const int m = tid % TM, kk0 = tid / TM;
  const int i = i0 + m;
  float acc[4][TN];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int u = 0; u < TN; ++u) acc[a][u] = 0.f;

  for (int k0 = rbeg; k0 < rend; k0 += kKC) {
#pragma unroll
    for (int h = 0; h < kKC / RP; ++h) {
      const int kk = kk0 + h * RP;
      const int r = k0 + kk;
      float v = 0.f;
      if (r < rend && i < p.Kin) {
        const int pos = r % g.HW;
        const int yy = pos / g.W + dy, xx = pos % g.W + dx;
        if (yy >= 0 && yy < g.H && xx >= 0 && xx < g.W) {
          v = src[(size_t)(r + dy * g.W + dx) * p.Kin + i];
          if (p.gelu) v = gelu(v);
        }
      }
      sA[kk * LDA + m] = v;
    }
    for (int q = tid; q < kKC * N; q += kThreads) {
      const int kr = q / N, n = q % N;
      const int r = k0 + kr;
      sB[kr * N + n] = r < rend ? gl[(size_t)r * N + n] : 0.f;
    }
    __syncthreads();
    mma_chunk<N>(acc, sA, sB);
    __syncthreads();
  }
  const int tr = tid / T::NCG, tc = tid % T::NCG;
  const size_t per = (size_t)p.k * p.k * p.Kin * N;
  // S == 1: straight into dW, rows of ldo floats; else the split's partials
  float* out = p.S == 1
      ? p.out + ((size_t)l * p.rows + p.orow + (size_t)t * p.Kin) * p.ldo + p.ocol
      : p.out + ((size_t)l * p.S + s) * per + (size_t)t * p.Kin * N;
  const size_t pitch = p.S == 1 ? p.ldo : N;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = i0 + tr * 4 + a;
    if (row >= p.Kin) continue;
#pragma unroll
    for (int u = 0; u < TN; ++u) out[row * pitch + tc * TN + u] = acc[a][u];
  }
}

// out[l * lout + (j / N) * ldo + j % N] = sum_s part[l][s][j], in order of
// s, for the n = rows x N partial entries j of a level.
__global__ void reduce_splits(const float* __restrict__ part, float* __restrict__ out,
                              int L, int S, size_t n, size_t lout, int N, int ldo) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)L * n) return;
  const size_t l = idx / n, j = idx % n;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += part[(l * S + s) * n + j];
  out[l * lout + (j / N) * ldo + j % N] = acc;
}

// db[l * ldb + c] = sum_r G[l][r][c]: block (32 columns, level), 8 row
// lanes each summing every 8th row, then the lanes in order.
__global__ void bias_grad(const float* __restrict__ gs, float* __restrict__ db,
                          int R, int N, int ldb) {
  __shared__ float part[8][32];
  const int col = threadIdx.x % 32, lane = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + col, l = blockIdx.y;
  float acc = 0.f;
  if (c < N)
    for (int r = lane; r < R; r += 8) acc += gs[((size_t)l * R + r) * N + c];
  part[lane][col] = acc;
  __syncthreads();
  if (lane == 0 && c < N) {
    float s = 0.f;
    for (int j = 0; j < 8; ++j) s += part[j][col];
    db[(size_t)l * ldb + c] = s;
  }
}

// Bias gradients of all L levels: N columns of rows ldb apart (0: N).
inline void launch_bias_grad(const float* gs, float* db, int L, int R, int N,
                             cudaStream_t stream, int ldb = 0) {
  bias_grad<<<dim3((N + 31) / 32, L), 256, 0, stream>>>(gs, db, R, N, ldb ? ldb : N);
}

// One weight-gradient product of all L levels into the stacks at dw; `part`
// holds the row splits' partial sums when there is more than one.
template <int N>
void weight_grad(const WgArgs& base, float* dw, float* part, int L,
                 cudaStream_t stream) {
  WgArgs a = base;
  a.S = n_splits(a.g);
  if (!a.ldo) a.ldo = N;
  a.out = a.S == 1 ? dw : part;
  const dim3 grid((a.Kin + Tile<N>::TM - 1) / Tile<N>::TM, a.k * a.k, L * a.S);
  wgrad<N><<<grid, kThreads, 0, stream>>>(a);
  if (a.S > 1) {
    const size_t n = (size_t)a.k * a.k * a.Kin * N;
    const size_t total = (size_t)L * n;
    reduce_splits<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        part, dw + (size_t)a.orow * a.ldo + a.ocol, L, a.S, n,
        (size_t)a.rows * a.ldo, N, a.ldo);
  }
}

}  // namespace PM_CHAIN_NS

extern "C" const char* pm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
