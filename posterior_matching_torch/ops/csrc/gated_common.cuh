// Shared pieces of the gated-chain training kernels (gated_levels.cuh and
// the stream, pair and segment entry points): the dropout hash, the
// elementwise functions, the argument layout of the C entry points, and the
// GEMM core both of the chain's GEMM kernels run on: `data_gemm` here (every
// conv and data gradient, over the B*H*W rows of a pass) and `wgrad` in
// gated_levels.cuh (every weight gradient, over the input channels). The A
// operand of `data_gemm` is gathered term by term (a conv tap is a term: a
// source tensor read at a shifted position, optionally through concat_elu
// and the dropout mask); its epilogue is one of the gated block's: bias, the
// gate and residual, or concat_elu's derivative.
//
// The core. Tensor cores through `mma.sync.m16n8k8` in TF32 with the 3xTF32
// split (CUTLASS's OpMultiplyAddFastF32): an operand x is big = rna_tf32(x)
// plus small = x - big (read by the tensor cores as TF32), and each product
// is a_small b_big + a_big b_small + a_big b_big, in that order, which keeps
// ~21 of float32's 24 significand bits (one TF32 pass keeps 11). Each
// 64-deep chunk's MMAs start from zero and are added into the float32
// accumulator: the tensor cores' own accumulation truncates, and left to
// run over a whole K it costs ~20x float32's rounding.
//
// A block of 16 warps owns a 64-row tile and all N columns; a warp owns
// 32 rows x N/8 columns as 2 x N/64 m16n8 fragments, its columns half in
// [0, N/2) and half at the same offsets in [N/2, N), so that one thread
// holds column j and column j + F of a gated epilogue (N = 64, conv_a's N
// at 64 filters, is one fragment column a warp: no gated epilogue runs at
// that N). The kernels are built for the widths of GSK_DISPATCH_WIDTHS;
// every F-sized shape is a template parameter. 16 warps of at most
// 128 registers (4 a scheduler) hide the MMAs' and loads' latencies. The K
// loop walks 64-deep chunks with one barrier each: B (weights, or
// cotangent rows for wgrad) lands by 16-byte cp.async copies in one of two
// stages, a chunk ahead; A is gathered into registers a chunk ahead (its
// global loads in flight during the current chunk's MMAs), transformed,
// split once and stored in the MMA fragment order (big and small planes),
// so a lane's A registers are one 16-byte load each and need no moves
// before the MMA (moves were half the MMA loop's instructions in the
// pair layout first built). B is split in registers at the fragment load,
// as CUTLASS does (cp.async lands its bytes without passing through
// registers; a split pass in shared memory, tried, cost more than it
// saved). Fragment loads are free of bank conflicts where the operands
// land (the transposed B as [n][k], no scalar scatter).
//
// Bound: operations. 3 TF32 products per float32 product at the card's
// 495 TFLOP/s dense TF32 rate: 165 TFLOP/s of float32 work (the float32
// FMA rate outside the tensor cores is 67).
//
// bf16 (compute_dtype bfloat16, a build with PM_CORE_BF16 = 1, the JAX
// chain at cdtype bf16, ops/gated_chain.py:164-260): every product is
// mma.sync.m16n8k16 with bf16 operands and float32 accumulators, one MMA a
// 16-deep step (a product of two bf16 values is exact in float32, as JAX's
// preferred_element_type float32 dot). A is rounded to bf16 (to nearest
// even) as it is staged, after concat_elu and the dropout mask, into a bf16
// plane in the m16n8k16 fragment order (frag16_at); the weights are bf16
// in global memory and land by cp.async as they are; a weight gradient's B
// (float32 cotangent rows) is rounded at the fragment load. The tensors of
// the compute dtype (cdt: the activations, the saves a1 and b1, the level
// outputs, the cotangents of the activations, the weight matrices) are
// bf16 and every epilogue rounds what it stores there; the biases, cond,
// the scratch and every gradient of a weight or of cond stay float32. Bound
// at the dense bf16 rate, 989 TFLOP/s.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx_mma.cuh"

namespace gsk {

#ifndef PM_CORE_BF16
#define PM_CORE_BF16 0
#endif
constexpr bool kBF16 = PM_CORE_BF16;

// The compute dtype's element: bf16 (its bits) in a build with
// PM_CORE_BF16 = 1, else float.
template <bool BF>
struct Elem {
  using T = float;
};
template <>
struct Elem<true> {
  using T = uint16_t;
};
using cdt = Elem<kBF16>::T;

// An element of the compute dtype as a float (exact).
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}
// v rounded to the compute dtype (to nearest even), as a float.
__device__ __forceinline__ float round_c(float v) {
  return kBF16 ? __uint_as_float(pack_bf16(v, 0.f) << 16) : v;
}
// Stores v (rounded to bf16 where the element is bf16).
__device__ __forceinline__ void store_c(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_c(uint16_t* p, float v) {
  *p = static_cast<uint16_t>(pack_bf16(v, 0.f) & 0xffffu);
}
// Stores the two consecutive values (a, b) at p.
__device__ __forceinline__ void store_c2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_c2(uint16_t* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

constexpr int kThreads = 512;  // threads per block of every GEMM kernel
constexpr int kWarpsN = kThreads / 32 / 2;  // a block's warps across N (2 across its rows)
constexpr int kBM = 64;        // rows (data_gemm) or channels (wgrad) of a block tile
constexpr int kKC = 64;        // depth of one staged K chunk
constexpr int kStages = 2;     // B's ring: copies run kStages - 1 chunks ahead
// An A stage is two planes, big and small, of kBM x kKC floats in the MMA
// fragment order (frag_at): a lane's four A registers of an m16 x k8 tile
// are one 16-byte load, with no moves between the load and the MMA. B lands
// as it is in memory: [k][N + 8], or transposed [n][kBPitchT], pitches that
// spread a fragment load's lanes over distinct banks.
constexpr int kAPlane = kBM * kKC;
constexpr int kBPitchT = kKC + 4;
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
  I_SEED, I_BASE, I_THRESH, I_DROP, I_BF, I_F, I_COUNT
};

// num_filters the kernels are built for: 128 (configs/pm_vqvae_celeb_a.py,
// pm_vqvae_mnist.py) and 64 (pm_vqvae_digits16.py).
__host__ __device__ constexpr bool width_built(int f) { return f == 128 || f == 64; }

// `return call` with F a constant equal to `f`, one of the built widths;
// cudaErrorInvalidValue for any other.
#define GSK_DISPATCH_WIDTHS(f, call)   \
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

// ---- the GEMM core -----------------------------------------------------------

// Floats of a B stage: a [kKC][N + 8] or an [N][kBPitchT] chunk (equal at
// N = 128; the first is larger at N = 64, the second at N = 256).
template <int N>
__host__ __device__ constexpr int b_stage() {
  return kKC * (N + 8) > N * kBPitchT ? kKC * (N + 8) : N * kBPitchT;
}

// Dynamic shared memory of data_gemm<N> and wgrad<N>: two A stages of two
// planes, then kStages B stages.
template <int N>
constexpr int smem_bytes() {
  return (2 * 2 * kAPlane + kStages * b_stage<N>()) * 4;
}

// n8 tiles of a warp, and the accumulators of a thread: 2 m16 tiles x NT
// n8 tiles x 4.
template <int N>
__host__ __device__ constexpr int n_tiles() {
  return N / (8 * kWarpsN);
}
template <int N>
using Acc = float[2][n_tiles<N>()][4];

// The first column of n8 tile u of this thread's warp: NT / 2 tiles at
// warp column wn * N / (2 kWarpsN) in each half of N; with one tile a warp
// (N = 64), tile wn.
template <int N>
__device__ __forceinline__ int tile_n0(int u) {
  constexpr int NT = n_tiles<N>();
  static_assert(N % (8 * kWarpsN) == 0 && (NT == 1 || NT % 2 == 0), "whole n8 tiles a warp");
  const int wn = threadIdx.x / 32 % kWarpsN;
  if constexpr (NT == 1)
    return wn * 8;
  else
    return (u < NT / 2 ? 0 : N / 2) + wn * (N / (2 * kWarpsN)) + (u % (NT / 2)) * 8;
}

// The first row of m16 tile mt of this thread's warp.
__device__ __forceinline__ int tile_m0(int mt) {
  return (threadIdx.x / 32 / kWarpsN) * 32 + mt * 16;
}

// The offset in an A plane of element (m, k): m16 x k8 tiles, m-major, 32
// lanes of 4 floats each (lane 4g + t holds (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4), its a0..a3). A lane's slot is its index XOR a swizzle of
// the tile's k8 index and the lane's fifth bit, which spreads the gathers'
// scalar stores over all banks and keeps every 8-lane phase of a fragment
// load on 8 distinct 16-byte slots.
__device__ __forceinline__ int frag_at(int m, int k) {
  const int mi = m & 15, ki = k & 7, kt = k >> 3;
  const int lane = (mi & 7) * 4 + (ki & 3);
  const int slot = lane ^ (kt & 7) ^ ((lane >> 4) << 2);
  return (((m >> 4) * (kKC / 8) + kt) * 32 + slot) * 4 + (mi >> 3) + 2 * (ki >> 2);
}

// Stores element (m, k) of A, split, into stage `sA` (big plane, then small).
__device__ __forceinline__ void store_split(float* sA, int m, int k, float v) {
  const float2 x = split_tf32(v);
  const int at = frag_at(m, k);
  sA[at] = x.x;
  sA[kAPlane + at] = x.y;
}

// acc += the staged chunk: A from stage `sA` (fragment order, big and small
// planes), B(k, n) = sB[k * BSK + n * BSN]. Each 8-deep step loads every
// fragment it needs first (B split in registers), then issues its MMAs pass
// by pass over all the warp's tiles (small-big, big-small, big-big: 2 x NT
// independent accumulators between dependent MMAs). The chunk's products
// accumulate in `part` from zero and are added into acc with one float32
// add: the tensor cores' own accumulation truncates each sum to its largest
// term's exponent, which over a long K (hundreds of MMAs into one
// accumulator) costs ~20x float32's rounding; a chunk's MMAs lose about
// what float32's adds lose.
template <int N, int BSK, int BSN>
__device__ __forceinline__ void mma_chunk(Acc<N>& acc, const float* sA, const float* sB) {
  constexpr int NT = n_tiles<N>();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int mt0 = threadIdx.x / 32 / kWarpsN * 2;  // the warp's first m16 tile
  const float* bp = sB + t * BSK + g * BSN;
  Acc<N> part = {};
#pragma unroll
  for (int k8 = 0; k8 < kKC; k8 += 8) {
    uint32_t ab[2][4], as[2][4], bb[NT][2], bs[NT][2];
    const int kt = k8 / 8, slot = lane ^ (kt & 7) ^ ((lane >> 4) << 2);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int at = (((mt0 + mt) * (kKC / 8) + kt) * 32 + slot) * 4;
      const float4 vb = *reinterpret_cast<const float4*>(sA + at);
      const float4 vs = *reinterpret_cast<const float4*>(sA + kAPlane + at);
      ab[mt][0] = __float_as_uint(vb.x);
      ab[mt][1] = __float_as_uint(vb.y);
      ab[mt][2] = __float_as_uint(vb.z);
      ab[mt][3] = __float_as_uint(vb.w);
      as[mt][0] = __float_as_uint(vs.x);
      as[mt][1] = __float_as_uint(vs.y);
      as[mt][2] = __float_as_uint(vs.z);
      as[mt][3] = __float_as_uint(vs.w);
    }
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // b0 (k = t, n = g), b1 (t + 4, g)
        const float2 x = split_tf32(bp[(k8 + 4 * i) * BSK + tile_n0<N>(u) * BSN]);
        bb[u][i] = __float_as_uint(x.x);
        bs[u][i] = __float_as_uint(x.y);
      }
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(part[mt][u], as[mt], bb[u]);
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(part[mt][u], ab[mt], bs[u]);
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(part[mt][u], ab[mt], bb[u]);
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][u][i] += part[mt][u][i];
}

// The offset, in bf16 values, of element (m, k) of a bf16 A stage: m16 x
// k16 tiles, m-major, 32 lanes of 4 words each (lane 4g + t holds (g, 2t |
// 2t + 1), (g + 8, 2t | 2t + 1), (g, 2t + 8 | 2t + 9), (g + 8, 2t + 8 |
// 2t + 9), its a0..a3, the lower k in a word's low half), so a lane's A
// registers of a step are one 16-byte load. A stage is kAPlane bf16 values.
__device__ __forceinline__ int frag16_at(int m, int k) {
  const int mi = m & 15, ki = k & 15;
  const int lane = (mi & 7) * 4 + ((ki & 7) >> 1);
  const int word = (((m >> 4) * (kKC / 16) + (k >> 4)) * 32 + lane) * 4 + (mi >> 3) + 2 * (ki >> 3);
  return 2 * word + (ki & 1);
}

// B's values (k, n) and (k + 1, n) as the two halves of an MMA register:
// from a bf16 stage (B(k, n) = sB[k * BSK + n * BSN]), or from a float32
// stage rounded to bf16.
template <int BSK, int BSN>
__device__ __forceinline__ uint32_t b_pair(const uint16_t* sB, int k, int n) {
  const uint16_t* p = sB + k * BSK + n * BSN;
  if constexpr (BSK == 1)
    return *reinterpret_cast<const uint32_t*>(p);
  else
    return p[0] | static_cast<uint32_t>(p[BSK]) << 16;
}
template <int BSK, int BSN>
__device__ __forceinline__ uint32_t b_pair(const float* sB, int k, int n) {
  const float* p = sB + k * BSK + n * BSN;
  return pack_bf16(p[0], p[BSK]);
}

// acc += the staged chunk in bf16: A from the bf16 stage `sA` (frag16_at's
// order), B(k, n) = sB[k * BSK + n * BSN] (bf16, or float32 rounded as it
// is read). One m16n8k16 MMA per tile a 16-deep step; the chunk's products
// accumulate in `part` from zero and are added into acc, as mma_chunk's.
template <int N, int BSK, int BSN, typename TB>
__device__ __forceinline__ void mma_chunk_bf(Acc<N>& acc, const uint16_t* sA, const TB* sB) {
  constexpr int NT = n_tiles<N>();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int mt0 = threadIdx.x / 32 / kWarpsN * 2;  // the warp's first m16 tile
  Acc<N> part = {};
#pragma unroll
  for (int kt = 0; kt < kKC / 16; ++kt) {
    uint32_t a[2][4], b[NT][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          sA + (((mt0 + mt) * (kKC / 16) + kt) * 32 + lane) * 8);
      a[mt][0] = v.x;
      a[mt][1] = v.y;
      a[mt][2] = v.z;
      a[mt][3] = v.w;
    }
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      const int n = tile_n0<N>(u) + g;
      b[u][0] = b_pair<BSK, BSN>(sB, 16 * kt + 2 * t, n);
      b[u][1] = b_pair<BSK, BSN>(sB, 16 * kt + 2 * t + 8, n);
    }
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_bf16(part[mt][u], a[mt], b[u]);
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][u][i] += part[mt][u][i];
}

// ---- data_gemm ---------------------------------------------------------

enum AMode { A_IDENT = 0, A_CELU = 1, A_CELU_DROP = 2 };
enum Epi { E_BIAS = 0, E_GATE = 1, E_CELU_BWD = 2 };

// One term of the A operand: acc[r, n] += sum_k A(r, k) * B(k, n), where
// A(r, k) reads row `src` at r's position shifted by (dy, dx) (zero off the
// grid): the row itself (A_IDENT, K = C), or its concat_elu (K = 2C), times
// the dropout keep mask / keep (A_CELU_DROP). B(k, n) = w[k * ld + n], or
// w[n * ld + k] with `trans`. K, C and ld are multiples of kKC. An A_IDENT
// source is float32 scratch, the others are of the compute dtype (cdt), as
// w is.
struct Term {
  const void* src;
  const void* w;
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
  const cdt* xres;     // [R, F] residual input (E_GATE)
  const cdt* z;        // [R, F] concat_elu's argument (E_CELU_BWD)
  const float* base1;  // [R, F] addends of the E_CELU_BWD output, or null
  const cdt* base2;
  cdt* outc;           // E_BIAS, E_GATE: [R, N]; E_CELU_BWD: [R, F], or null
  cdt* out2;           // E_GATE: the gated residual [R, F]
  float* out;          // E_CELU_BWD where outc is null: [R, F] float32 ...
  int round;           // ... rounded to the compute dtype with `round`
};

// A walk over the chunks of the terms: term ti, K offset k0.
struct Cursor {
  int ti, k0;
  __device__ __forceinline__ void next(const DataArgs& p) {
    if (ti == p.nt) return;
    k0 += kKC;
    if (k0 == p.t[ti].K) {
      ++ti;
      k0 = 0;
    }
  }
};

// Issues the cp.async copies of B's chunk at `c` into stage `dst` (none
// past the last term), and commits a group either way.
template <int N>
__device__ __forceinline__ void stage_b(float* dst, const DataArgs& p, const Cursor& c) {
  if (kBF16 && c.ti < p.nt) {
    // bf16 weights: [k][N + 8] or [n][kKC + 8] bf16 values, 8 a copy
    const Term& T = p.t[c.ti];
    const uint16_t* w = static_cast<const uint16_t*>(T.w);
    uint16_t* d16 = reinterpret_cast<uint16_t*>(dst);
    if (!T.trans) {
      constexpr int P = N / 8, STEP = kThreads / P;
      const int kr = threadIdx.x / P, c8 = threadIdx.x % P;
#pragma unroll
      for (int j = 0; j < kKC / STEP; ++j)
        cp_async16(smem_u32(d16 + (kr + j * STEP) * (N + 8) + 8 * c8),
                   w + (size_t)(c.k0 + kr + j * STEP) * T.ld + 8 * c8, 16);
    } else {
      constexpr int P = kKC / 8, STEP = kThreads / P;
      const int n = threadIdx.x / P, kq = threadIdx.x % P;
#pragma unroll
      for (int j = 0; j < N / STEP; ++j)
        cp_async16(smem_u32(d16 + (n + j * STEP) * (kKC + 8) + 8 * kq),
                   w + (size_t)(n + j * STEP) * T.ld + c.k0 + 8 * kq, 16);
    }
  } else if (c.ti < p.nt) {
    const Term& T = p.t[c.ti];
    // a thread's pieces: rows kThreads / (pieces a row) apart
    if (!T.trans) {
      constexpr int P = N / 4, STEP = kThreads / P;
      const int kr = threadIdx.x / P, c4 = threadIdx.x % P;
      const float* src = static_cast<const float*>(T.w) + (size_t)(c.k0 + kr) * T.ld + 4 * c4;
      uint32_t d = smem_u32(dst + kr * (N + 8) + 4 * c4);
      const size_t sstep = (size_t)STEP * T.ld;
#pragma unroll
      for (int j = 0; j < kKC / STEP; ++j, src += sstep, d += STEP * (N + 8) * 4)
        cp_async16(d, src, 16);
    } else {
      constexpr int P = kKC / 4, STEP = kThreads / P;
      const int n = threadIdx.x / P, kq = threadIdx.x % P;
      const float* src = static_cast<const float*>(T.w) + (size_t)n * T.ld + c.k0 + 4 * kq;
      uint32_t d = smem_u32(dst + n * kBPitchT + 4 * kq);
      const size_t sstep = (size_t)STEP * T.ld;
#pragma unroll
      for (int j = 0; j < N / STEP; ++j, src += sstep, d += STEP * kBPitchT * 4)
        cp_async16(d, src, 16);
    }
  }
  cp_async_commit();
}

// out = epilogue(sum_terms A_t @ B_t) for rows [kBM * blockIdx.x, + kBM) and
// all N columns. N is F (conv_a: E_BIAS) or 2F (conv_b, and every product
// whose epilogue, E_GATE or E_CELU_BWD, pairs column j with j + F).
template <int N>
__global__ void __launch_bounds__(kThreads, 1) data_gemm(const __grid_constant__ DataArgs p) {
  constexpr int NT = n_tiles<N>();
  // a thread gathers kAR rows, kAStep apart, at chunk columns 4q .. 4q + 3;
  // the two rows of a warp are 8 apart, so its stores spread over the banks
  constexpr int kAStep = kThreads / (kKC / 4), kAR = kBM / kAStep;
  static_assert(kAStep % 16 == 0, "a row pass covers whole m16 tiles");
  constexpr int F = N / 2;  // of the paired epilogues
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;
  float* sB = smem + 4 * kAPlane;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kBM;
  const Geo g = p.g;
  Acc<N> acc;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][u][i] = 0.f;

  const int q = tid % (kKC / 4), rs = tid / (kKC / 4);
  const int m = rs / 16 * 16 + (rs / 2) % 8 + 8 * (rs % 2);
  int ry[kAR], rx[kAR];
  uint32_t kimg[kAR];
#pragma unroll
  for (int h = 0; h < kAR; ++h) {
    const int r = r0 + m + kAStep * h;
    const int pos = r % g.HW;
    ry[h] = r < g.R ? pos / g.W : -(1 << 20);  // rows past R read nothing
    rx[h] = pos % g.W;
    kimg[h] = mix32(p.key ^ (uint32_t)(r / g.HW));
  }
  float va[kAR][4];
  uint32_t spos[kAR];
  bool ok[kAR];
  // global loads of A's chunk at `c` into va
  auto load_a = [&](const Cursor& c) {
    const Term& T = p.t[c.ti];
    const int k = c.k0 + 4 * q;
    const int col = T.mode == A_IDENT || k < T.C ? k : k - T.C;
#pragma unroll
    for (int h = 0; h < kAR; ++h) {
      const int yy = ry[h] + T.dy, xx = rx[h] + T.dx;
      ok[h] = yy >= 0 && yy < g.H && xx >= 0 && xx < g.W;
      spos[h] = (uint32_t)(yy * g.W + xx);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok[h]) {
        const int r = r0 + m + kAStep * h;
        const size_t at = (size_t)(r + T.dy * g.W + T.dx) * T.C + col;
        if (kBF16 && T.mode != A_IDENT) {
          const uint2 x = __ldg(reinterpret_cast<const uint2*>(static_cast<const cdt*>(T.src) + at));
          v = make_float4(__uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u),
                          __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xffff0000u));
        } else {
          v = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(T.src) + at));
        }
      }
      va[h][0] = v.x;
      va[h][1] = v.y;
      va[h][2] = v.z;
      va[h][3] = v.w;
    }
  };
  // va through the term's concat_elu and mask, split, into A stage `s`
  auto store_a = [&](const Cursor& c, int s) {
    const Term& T = p.t[c.ti];
    const int k = c.k0 + 4 * q;
#pragma unroll
    for (int h = 0; h < kAR; ++h) {
      if (ok[h] && T.mode != A_IDENT) {
        const bool neg = k >= T.C;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v = elu(neg ? -va[h][j] : va[h][j]);
          if (T.mode == A_CELU_DROP)
            v = kept(kimg[h], spos[h] * (uint32_t)(2 * T.C) + k + j, p.thresh) ? v * p.inv_keep
                                                                            : 0.f;
          va[h][j] = v;
        }
      }
      if constexpr (kBF16) {
        uint32_t* sw = reinterpret_cast<uint32_t*>(reinterpret_cast<uint16_t*>(sA) + s * kAPlane);
        sw[frag16_at(m + kAStep * h, 4 * q) / 2] = pack_bf16(va[h][0], va[h][1]);
        sw[frag16_at(m + kAStep * h, 4 * q + 2) / 2] = pack_bf16(va[h][2], va[h][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          store_split(sA + s * 2 * kAPlane, m + kAStep * h, 4 * q + j, va[h][j]);
      }
    }
  };

  int nc = 0;
  for (int ti = 0; ti < p.nt; ++ti) nc += p.t[ti].K / kKC;
  Cursor ca{0, 0}, cb{0, 0}, cc{0, 0};  // A's next chunk, B's, the MMAs'
  for (int s = 0; s < kStages - 1; ++s) {
    stage_b<N>(sB + s * b_stage<N>(), p, cb);
    cb.next(p);
  }
  load_a(ca);
  store_a(ca, 0);
  ca.next(p);
  for (int c = 0; c < nc; ++c) {
    cp_async_wait_ring<kStages>();  // this thread's copies of chunk c landed
    __syncthreads();   // everyone's, and A stage c % 2; B stage c - 1 is free
    stage_b<N>(sB + (c + kStages - 1) % kStages * b_stage<N>(), p, cb);
    cb.next(p);
    const bool more = c + 1 < nc;
    if (more) load_a(ca);
    const float* b = sB + c % kStages * b_stage<N>();
    if constexpr (kBF16) {
      const uint16_t* a = reinterpret_cast<const uint16_t*>(sA) + (c % 2) * kAPlane;
      const uint16_t* b16 = reinterpret_cast<const uint16_t*>(b);
      if (p.t[cc.ti].trans)
        mma_chunk_bf<N, 1, kKC + 8>(acc, a, b16);
      else
        mma_chunk_bf<N, N + 8, 1>(acc, a, b16);
    } else {
      const float* a = sA + (c % 2) * 2 * kAPlane;
      if (p.t[cc.ti].trans)
        mma_chunk<N, 1, kBPitchT>(acc, a, b);
      else
        mma_chunk<N, N + 8, 1>(acc, a, b);
    }
    cc.next(p);
    if (more) {
      store_a(ca, (c + 1) % 2);
      ca.next(p);
    }
  }

  const int lane = tid % 32, gq = lane / 4, t2 = 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + tile_m0(mt) + gq + 8 * hh;
      if (r >= g.R) continue;
      const int b = r / g.HW;
      if (p.epi == E_BIAS) {
#pragma unroll
        for (int u = 0; u < NT; ++u) {
          const int c = tile_n0<N>(u) + t2;
          const float2 bias = p.bias ? make_float2(p.bias[c], p.bias[c + 1])
                                     : make_float2(0.f, 0.f);
          store_c2(p.outc + (size_t)r * N + c, acc[mt][u][2 * hh] + bias.x,
                   acc[mt][u][2 * hh + 1] + bias.y);
        }
      } else if (p.epi == E_GATE) {
#pragma unroll
        for (int u = 0; u < NT / 2; ++u)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = tile_n0<N>(u) + t2 + e;  // act column; its gate is j + F
            // b1 as saved (rounded to the compute dtype), and the gate on it
            const float act =
                round_c(acc[mt][u][2 * hh + e] + p.bias[j] + p.proj[(size_t)b * N + j]);
            const float gate = round_c(acc[mt][u + NT / 2][2 * hh + e] + p.bias[j + F] +
                                       p.proj[(size_t)b * N + j + F]);
            store_c(p.outc + (size_t)r * N + j, act);
            store_c(p.outc + (size_t)r * N + j + F, gate);
            store_c(p.out2 + (size_t)r * F + j,
                    to_f(p.xres[(size_t)r * F + j]) + sigmoid(gate) * act);
          }
      } else {  // E_CELU_BWD
        const uint32_t ki = mix32(p.key ^ (uint32_t)b);
        const uint32_t pos = (uint32_t)(r % g.HW);
#pragma unroll
        for (int u = 0; u < NT / 2; ++u)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = tile_n0<N>(u) + t2 + e;
            float gp = acc[mt][u][2 * hh + e], gn = acc[mt][u + NT / 2][2 * hh + e];
            if (p.drop) {
              gp = kept(ki, pos * (2 * F) + j, p.thresh) ? gp * p.inv_keep : 0.f;
              gn = kept(ki, pos * (2 * F) + j + F, p.thresh) ? gn * p.inv_keep : 0.f;
            }
            const float z = to_f(p.z[(size_t)r * F + j]);
            const float dpos = z > 0.f ? 1.f : expf(z);
            const float dneg = -z > 0.f ? 1.f : expf(-z);
            float s = 0.f;
            if (p.base1) s += p.base1[(size_t)r * F + j];
            if (p.base2) s += to_f(p.base2[(size_t)r * F + j]);
            const float v = s + (gp * dpos - gn * dneg);
            if (p.outc)
              store_c(p.outc + (size_t)r * F + j, v);
            else
              p.out[(size_t)r * F + j] = p.round ? round_c(v) : v;
          }
      }
    }
}

// A term per tap of `taps` over `src`, appended to a.
inline void add_tap_terms(DataArgs& a, const Taps& taps, int sign,
                          const void* src, int C, int mode, const cdt* w,
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
