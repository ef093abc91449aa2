// Shared pieces of the gated-chain training kernels (gated_levels.cuh and
// the stream, pair and segment entry points): the dropout hash, the
// elementwise functions, the argument layout of the C entry points, and
// `data_gemm`, a block-tiled
// float32 GEMM over the B*H*W rows of a pass whose A operand is gathered
// term by term (a conv tap is a term: a source tensor read at a shifted
// position, optionally through concat_elu and the dropout mask) and whose
// epilogue is one of the gated block's: bias, the gate and residual, or
// concat_elu's derivative.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gsk {

constexpr int kF = 128;        // num_filters the kernels are built for
constexpr int kThreads = 256;  // threads per block of every GEMM kernel
constexpr int kM = 32;         // rows of a block tile
constexpr int kKC = 16;        // depth of one staged K chunk
constexpr int kLda = kM + 4;   // row pitch of the staged A chunk
constexpr int kMaxTerms = 12;
constexpr int kMaxTaps = 9;

// ---- the dropout hash (ops/gated_chain.py::dropout_keep_mask) ----------
// "lowbias32" mixer; key = mix(mix(seed) ^ block_id); an element (image b,
// position p, channel c) of a 2F-wide block is kept when
// mix(mix(key ^ b) ^ (p * 2F + c)) < thresh.
__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__host__ __device__ __forceinline__ uint32_t stream_key(uint32_t seed,
                                                        uint32_t block_id) {
  return mix32(mix32(seed) ^ block_id);
}

__device__ __forceinline__ bool kept(uint32_t kimg, uint32_t elem,
                                     uint32_t thresh) {
  return mix32(kimg ^ elem) < thresh;
}

// elu in the exp(min(z, 0)) - 1 form of the JAX package's _elu, which the
// plain PyTorch version also uses.
__device__ __forceinline__ float elu(float z) {
  return z > 0.f ? z : expf(fminf(z, 0.f)) - 1.f;
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

// ---- arguments of the C entry points -----------------------------------
// Integer arguments, in the order of ops/gated_chain.py::_GEOMETRY.
enum GeoInt {
  I_L, I_B, I_H, I_W, I_CD,
  I_TV_SKH, I_TV_SKW, I_TV_PT, I_TV_PL,
  I_TH_SKH, I_TH_SKW, I_TH_PT, I_TH_PL,
  I_SEED, I_BASE, I_THRESH, I_DROP, I_COUNT
};

struct Geo {
  int R, B, H, W, HW;
};

struct Taps {
  int n;
  int dy[kMaxTaps], dx[kMaxTaps];
};

// Tap (i, j) of output position (y, x) reads (y + i - pad_top,
// x + j - pad_left): ops/gated_block.py::TapPlan.shifts.
inline Taps make_taps(int skh, int skw, int pad_top, int pad_left) {
  Taps t{};
  t.n = skh * skw;
  for (int i = 0; i < skh; ++i)
    for (int j = 0; j < skw; ++j) {
      t.dy[i * skw + j] = i - pad_top;
      t.dx[i * skw + j] = j - pad_left;
    }
  return t;
}

inline Geo make_geo(const int* ints) {
  Geo g;
  g.B = ints[I_B];
  g.H = ints[I_H];
  g.W = ints[I_W];
  g.HW = g.H * g.W;
  g.R = g.B * g.HW;
  return g;
}

inline bool taps_ok(int skh, int skw, int pad_top, int pad_left) {
  return skh >= 1 && skw >= 1 && skh * skw <= kMaxTaps && pad_top >= 0 &&
         pad_top < skh && pad_left >= 0 && pad_left < skw;
}

// ---- data_gemm ---------------------------------------------------------

enum AMode { A_IDENT = 0, A_CELU = 1, A_CELU_DROP = 2 };
enum Epi { E_BIAS = 0, E_GATE = 1, E_CELU_BWD = 2 };

// One term of the A operand: acc[r, n] += sum_k A(r, k) * B(k, n), where
// A(r, k) reads row `src` at r's position shifted by (dy, dx) (zero off the
// grid): the row itself (A_IDENT, K = C), or its concat_elu (K = 2C), times
// the dropout keep mask / keep (A_CELU_DROP). B(k, n) = w[k * ld + n], or
// w[n * ld + k] with `trans`.
struct Term {
  const float* src;
  const float* w;
  int C, K, mode, dy, dx, ld, trans;
};

struct DataArgs {
  Term t[kMaxTerms];
  int nt;
  Geo g;
  // dropout: the block's key, the threshold, 1 / keep; `drop` turns the
  // mask on for A_CELU_DROP loads and the E_CELU_BWD epilogue
  uint32_t key, thresh;
  float inv_keep;
  int drop;
  int epi;
  const float* bias;   // [N]
  const float* proj;   // [B, N] per-image addend (E_GATE)
  const float* xres;   // [R, F] residual input (E_GATE)
  const float* z;      // [R, F] concat_elu's argument (E_CELU_BWD)
  const float* base1;  // [R, F] addends of the E_CELU_BWD output, or null
  const float* base2;
  float* out;          // E_BIAS, E_GATE: [R, N]; E_CELU_BWD: [R, F]
  float* out2;         // E_GATE: the gated residual [R, F]
};

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
  } else {
#pragma unroll
    for (int v = 0; v < V; v += 2) {
      const float2 q = *reinterpret_cast<const float2*>(src + v);
      dst[v] = q.x;
      dst[v + 1] = q.y;
    }
  }
}

// Stages kKC x N of B (rows k0.. of the product's B operand) into sB.
template <int N>
__device__ __forceinline__ void stage_b(float* sB, const float* w, int ld,
                                        int trans, int k0) {
  const int tid = threadIdx.x;
  if (!trans) {
    for (int i = tid; i < kKC * N / 4; i += kThreads) {
      const int kr = i / (N / 4), c4 = i % (N / 4);
      reinterpret_cast<float4*>(sB)[i] = __ldg(
          reinterpret_cast<const float4*>(w + (size_t)(k0 + kr) * ld) + c4);
    }
  } else {
    for (int i = tid; i < kKC * N / 4; i += kThreads) {
      const int kq = i % (kKC / 4), n = i / (kKC / 4);
      const float4 q = __ldg(
          reinterpret_cast<const float4*>(w + (size_t)n * ld + k0) + kq);
      sB[(4 * kq + 0) * N + n] = q.x;
      sB[(4 * kq + 1) * N + n] = q.y;
      sB[(4 * kq + 2) * N + n] = q.z;
      sB[(4 * kq + 3) * N + n] = q.w;
    }
  }
}

// acc[i][u] += sum over the staged chunk; thread (tr, tc) owns rows
// tr * 4 + i and columns col(u): TN / 2 in the left half of N and the same
// offsets in the right half, so a gated epilogue finds act column j and
// gate column j + N / 2 in one thread.
template <int N>
__device__ __forceinline__ void mma_chunk(float (&acc)[4][N / 32],
                                          const float* sA, const float* sB) {
  constexpr int TN = N / 32;
  const int tr = threadIdx.x / 32, tc = threadIdx.x % 32;
#pragma unroll 4
  for (int k = 0; k < kKC; ++k) {
    float a[4], b[TN];
    load_run<4>(a, sA + k * kLda + tr * 4);
    load_run<TN / 2>(b, sB + k * N + tc * (TN / 2));
    load_run<TN / 2>(b + TN / 2, sB + k * N + N / 2 + tc * (TN / 2));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < TN; ++u) acc[i][u] = fmaf(a[i], b[u], acc[i][u]);
  }
}

template <int N>
__device__ __forceinline__ int tile_col(int u) {
  constexpr int TN = N / 32;
  return (u < TN / 2 ? 0 : N / 2) + (threadIdx.x % 32) * (TN / 2) +
         u % (TN / 2);
}

// out = epilogue(sum_terms A_t @ B_t) for rows [32 * blockIdx.x, + 32) and
// all N columns. N is F (conv_a) or 2F (conv_b, and every product whose
// epilogue pairs column j with j + F).
template <int N>
__global__ void __launch_bounds__(kThreads) data_gemm(const DataArgs p) {
  constexpr int TN = N / 32;
  constexpr int F = kF;
  __shared__ __align__(16) float sA[kKC * kLda];
  __shared__ __align__(16) float sB[kKC * N];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kM;
  const Geo g = p.g;
  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < TN; ++u) acc[i][u] = 0.f;

  // this thread stages A rows m0 and m0 + 16 at chunk column kk
  const int kk = tid % kKC, m0 = tid / kKC;
  for (int ti = 0; ti < p.nt; ++ti) {
    const Term T = p.t[ti];
    long srow[2];
    uint32_t kimg[2], spos[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + m0 + 16 * h;
      srow[h] = -1;
      kimg[h] = spos[h] = 0;
      if (r < g.R) {
        const int b = r / g.HW, pos = r % g.HW;
        const int yy = pos / g.W + T.dy, xx = pos % g.W + T.dx;
        if (yy >= 0 && yy < g.H && xx >= 0 && xx < g.W) {
          srow[h] = r + T.dy * g.W + T.dx;
          spos[h] = (uint32_t)(yy * g.W + xx);
          kimg[h] = mix32(p.key ^ (uint32_t)b);
        }
      }
    }
    for (int k0 = 0; k0 < T.K; k0 += kKC) {
      const int k = k0 + kk;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = 0.f;
        if (srow[h] >= 0) {
          const float* row = T.src + srow[h] * T.C;
          if (T.mode == A_IDENT) {
            v = row[k];
          } else {
            v = k < T.C ? elu(row[k]) : elu(-row[k - T.C]);
            if (T.mode == A_CELU_DROP)
              v = kept(kimg[h], spos[h] * (uint32_t)(2 * T.C) + k, p.thresh)
                      ? v * p.inv_keep
                      : 0.f;
          }
        }
        sA[kk * kLda + m0 + 16 * h] = v;
      }
      stage_b<N>(sB, T.w, T.ld, T.trans, k0);
      __syncthreads();
      mma_chunk<N>(acc, sA, sB);
      __syncthreads();
    }
  }

  const int tr = tid / 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + tr * 4 + i;
    if (r >= g.R) continue;
    const int b = r / g.HW;
    if (p.epi == E_BIAS) {
#pragma unroll
      for (int u = 0; u < TN; ++u) {
        const int c = tile_col<N>(u);
        p.out[(size_t)r * N + c] = acc[i][u] + (p.bias ? p.bias[c] : 0.f);
      }
    } else if (p.epi == E_GATE) {
#pragma unroll
      for (int u = 0; u < TN / 2; ++u) {
        const int j = tile_col<N>(u);  // act column; its gate is j + F
        const float act = acc[i][u] + p.bias[j] + p.proj[(size_t)b * N + j];
        const float gate =
            acc[i][u + TN / 2] + p.bias[j + F] + p.proj[(size_t)b * N + j + F];
        p.out[(size_t)r * N + j] = act;
        p.out[(size_t)r * N + j + F] = gate;
        p.out2[(size_t)r * F + j] =
            p.xres[(size_t)r * F + j] + sigmoid(gate) * act;
      }
    } else {  // E_CELU_BWD
      const uint32_t kimg = mix32(p.key ^ (uint32_t)b);
      const uint32_t pos = (uint32_t)(r % g.HW);
#pragma unroll
      for (int u = 0; u < TN / 2; ++u) {
        const int j = tile_col<N>(u);
        float gp = acc[i][u], gn = acc[i][u + TN / 2];
        if (p.drop) {
          gp = kept(kimg, pos * (2 * F) + j, p.thresh) ? gp * p.inv_keep : 0.f;
          gn = kept(kimg, pos * (2 * F) + j + F, p.thresh) ? gn * p.inv_keep
                                                           : 0.f;
        }
        const float z = p.z[(size_t)r * F + j];
        const float dpos = z > 0.f ? 1.f : expf(z);
        const float dneg = -z > 0.f ? 1.f : expf(-z);
        float s = 0.f;
        if (p.base1) s += p.base1[(size_t)r * F + j];
        if (p.base2) s += p.base2[(size_t)r * F + j];
        p.out[(size_t)r * F + j] = s + (gp * dpos - gn * dneg);
      }
    }
  }
}

// Launches data_gemm over all rows on `stream`.
template <int N>
inline void launch_data_gemm(const DataArgs& a, cudaStream_t stream) {
  data_gemm<N><<<(a.g.R + kM - 1) / kM, kThreads, 0, stream>>>(a);
}

// A term per tap of `taps` over `src`, appended to a.
inline void add_tap_terms(DataArgs& a, const Taps& taps, int sign,
                          const float* src, int C, int mode, const float* w,
                          size_t wtap, int ld, int trans) {
  const int K = mode == A_IDENT ? C : 2 * C;
  for (int t = 0; t < taps.n; ++t)
    a.t[a.nt++] = Term{src, w + t * wtap, C, K, mode,
                       sign * taps.dy[t], sign * taps.dx[t], ld, trans};
}

}  // namespace gsk

extern "C" const char* pm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
