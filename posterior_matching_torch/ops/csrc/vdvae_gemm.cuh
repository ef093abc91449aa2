// The GEMM core of the VDVAE chain kernels (the decoder's
// decoder_chain_{fwd,bwd}.cu and the encoder's block_chain_{fwd,bwd}.cu):
// tanh-gelu, the geometry of a run, and the kernels, on Hopper's tensor
// cores. The including file names the namespace, PM_CORE_NS, before the
// include (dck for the decoder chain, bck for the block chain), so that a
// profile tells the two libraries' kernels apart and no two libraries define
// the same symbols.
//
// - `dgemm`: every data product of a run (the Blocks' c1..c4 and their
//   data gradients), over the B*H*W rows. One launch computes a group of
//   independent products ("jobs": p, m and q of a phase; a wide output's
//   column tiles), blockIdx.y selecting the job and blockIdx.x a tile of
//   TM rows; every job's terms travel in one __grid_constant__ argument.
//   A term is a source read through gelu (or as it is) against a weight
//   slab (or its transpose); a k x k conv is one term of k*k taps.
// - `wgrad`, `wgrad_taps`: the weight gradients of all levels of a group
//   of stacks in one launch, the rows of the run as their K axis, summed
//   over fixed row splits whose partials `reduce_parts` adds in split
//   order; `wgrad_taps` takes the k x k stacks, all nine taps a block.
// - `bias_sums`: the column sums of every bias gradient of a run in one
//   launch, in a fixed order.
//
// Products. mma.sync.m16n8k8 in TF32 with the 3xTF32 split: an operand x is
// big = x rounded to TF32 plus small = x - big, and each product is
// a_small b_big + a_big b_small + a_big b_big, in that order (about 21 of
// float32's 24 significand bits; one TF32 pass keeps 11). Each chunk's MMAs
// start from zero and are added into the float32 accumulator: the tensor
// cores' own accumulation truncates, and over a whole K it costs ~20x
// float32's rounding. A warp owns one m16 tile and NW8 n8 tiles of the
// block's BN columns; BN is the bottleneck width M (48, or 16 for the
// digits16 geometry), and wider outputs are column tiles of BN (a head of
// 44 columns is one of 48 whose last 4 are masked).
//
// Operands. A's chunk is a slab of staged rows x KS channels (KS = BN) in
// shared memory, transformed (gelu) and split once, each 8-channel group
// stored as [big(t), big(t + 4), small(t), small(t + 4)] for t = 0..3, so a
// lane's A fragment of one row is one 16-byte load (rows of PA floats,
// PA = 16 mod 32: the 8 lanes of a load phase hit distinct banks). A conv
// term stages the rows [r0 - (W + 1), r0 + TM + W + 1) once, with its halo,
// and reads each tap as the same slab shifted by dy * W + dx rows, a lane
// zeroing its row where the tap leaves the image (the Pallas kernel's
// _row_coords masks): each element of the source is read and put through
// gelu (TM + 2W + 2) / TM times instead of k*k. wgrad_taps does the same
// for a weight gradient: the source's chunk is gathered once for the nine
// taps, and each tap reads the cotangent rows, staged once with their halo,
// shifted under a per-row mask. B (weights, or the cotangent rows of a
// weight gradient) lands by 16-byte cp.async copies in a ring of stages,
// as [k][BN + 8] or, for a transposed weight, [n][KS + 4] (pitches whose
// fragment loads hit distinct banks), and is split in registers at the
// fragment load. dgemm: a ring of kNS = 3 stages, and a slab of a 1x1
// term gathered into registers a chunk ahead (its global loads in flight
// during the current chunk's MMAs), stored after them into the other of
// two slab buffers. The weight gradients: a ring of kWNS = 4 stages, their
// A chunks carried two chunks ahead (one in wgrad_taps). One block barrier
// a chunk. (Measured on an NVIDIA H100 80GB HBM3 at 700 W: a dgemm with the
// weight gradients' depths, or with B loaded into registers a chunk ahead
// and split once into shared memory, or a job of one slab looping over its
// column tiles, or 16-row tiles with 6 B stages, or warps of two m16 tiles
// (B split once for both), was no faster.)
//
// bf16 (compute_dtype bfloat16, a build with PM_CORE_BF16 = 1): the kernels'
// template argument BF makes a product mma.sync.m16n8k16 with bf16 operands
// and float32 accumulators, one MMA a 16-deep step, as JAX's bf16 x bf16 dot
// with preferred_element_type float32 (each product of two bf16 values is
// exact in float32). A is rounded to bf16 (to nearest even) as it is staged,
// after gelu: each 16-deep step of a row holds the pairs (2t, 2t + 1) and
// (2t + 8, 2t + 9) side by side, so a lane's fragment of a row is one 8-byte
// load. B is bf16 in global memory (the c1..c3 weights, [k][n] or [n][k] in
// the ring) or float32 rounded at the fragment load (the cotangent rows of a
// weight gradient). The products JAX keeps in float32 (every c4 and its
// gradients) stay on the 3xTF32 path in the same build. A source may be a
// tensor of bf16 values (a term's or weight-gradient job's s16: the h saves),
// and an epilogue may write a bf16 copy of its output (out16: the saves) and
// read gelu's input as bf16 (z16).
//
// Determinism: fixed chunk, fragment, split and lane orders, no atomics, so
// equal inputs give equal outputs on every run.
//
// Everything from "---- launches" on is host code that launches kernels
// (through launch_kernel, which the CPU emulation of tests/cuda_emulation
// replaces).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx_mma.cuh"

#ifndef PM_CORE_NS
#error "define PM_CORE_NS, the core's namespace, before including vdvae_gemm.cuh"
#endif

namespace PM_CORE_NS {

// ---- geometry ------------------------------------------------------------

// Integer arguments of the C entry points, in the order of
// ops/block_chain.py::_GEOMETRY and ops/decoder_chain.py::_GEOMETRY (whose
// latent width follows, see decoder_chain_common.cuh). I_BF is 1 for a run
// in bf16, which only a build with PM_CORE_BF16 = 1 takes.
enum GeoInt { I_L, I_B, I_H, I_W, I_C, I_M, I_K, I_BF, I_COUNT };

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

#ifndef PM_CORE_BF16
#define PM_CORE_BF16 0
#endif
constexpr bool kBF16 = PM_CORE_BF16;

inline bool geometry_ok(const int* ints) {
  return ints[I_L] >= 1 && ints[I_B] >= 1 && ints[I_H] >= 1 && ints[I_W] >= 1 &&
         (ints[I_K] == 1 || ints[I_K] == 3) && ints[I_BF] == (kBF16 ? 1 : 0);
}

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

// ---- compute dtype ---------------------------------------------------------

// The element type of the c1..c3 weights and of the h saves: bf16 (its bits)
// in a build with PM_CORE_BF16 = 1, else float.
template <bool BF>
struct Elem {
  using T = float;
};
template <>
struct Elem<true> {
  using T = uint16_t;
};
using cdt = Elem<kBF16>::T;

// A bf16 value (its bits) as a float (exact).
__device__ __forceinline__ float from_bf16(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// Element i of a source of floats, or of bf16 values with s16 (only a bf16
// build has such sources: a float32 build compiles the float path alone).
__device__ __forceinline__ float src_at(const void* p, size_t i, int s16) {
  return kBF16 && s16 ? from_bf16(static_cast<const uint16_t*>(p)[i])
                      : __ldg(static_cast<const float*>(p) + i);
}

// ---- B's rings (the PTX helpers are ptx_mma.cuh's) ----------------------

// Stages of B's ring, copies running NS - 1 chunks ahead: the data
// products' (kNS) and the weight gradients' (kWNS, whose A is carried two
// chunks ahead too).
constexpr int kNS = 3, kWNS = 4;

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// ---- the MMA core ----------------------------------------------------------

// A warp's columns: NW8 n8 tiles (3 of BN = 48, 2 of BN = 16), WN warps
// across BN.
template <int BN>
struct Cols {
  static constexpr int NW8 = BN >= 48 ? 3 : BN / 8;
  static constexpr int WN = BN / (8 * NW8);
  static constexpr int PB = BN + 8;  // pitch of a [k][n] B stage
  static_assert(BN % 16 == 0 && BN == 8 * NW8 * WN, "columns");
};

// Stores 8 consecutive values of a row (channels 8j .. 8j + 7 of a chunk)
// split, in the fragment order of the 8-channel group at `dst`.
__device__ __forceinline__ void store_group(float* dst, const float (&v)[8]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 lo = split_tf32(v[t]), hi = split_tf32(v[t + 4]);
    *reinterpret_cast<float4*>(dst + 4 * t) = make_float4(lo.x, hi.x, lo.y, hi.y);
  }
}

// Stores 8 consecutive values of a row (K index 8q .. 8q + 7 of a chunk)
// rounded to bf16 into the row's words at `row`, in the m16n8k16 order: the
// 16-deep step q / 2 is 8 words, its pair (2t, 2t + 1) at word 2t and
// (2t + 8, 2t + 9) at word 2t + 1.
__device__ __forceinline__ void store_group_bf(uint32_t* row, int q, const float (&v)[8]) {
  uint32_t* dst = row + 8 * (q / 2) + q % 2;
#pragma unroll
  for (int t = 0; t < 4; ++t) dst[2 * t] = pack_bf16(v[2 * t], v[2 * t + 1]);
}

// part += the 16-deep step k16 of a chunk in bf16 for one m16 tile and NW8
// n8 tiles: A's rows g and g + 8 as loaded (va0, va1: the lane's two words
// of the step, zero where masked), B(k, n) = sB[k * BSK + n * BSN] (bf16) at
// the warp's columns nw.
template <int NW8, int BSK, int BSN>
__device__ __forceinline__ void mma_step_bf(float (&part)[NW8][4], const uint2& va0,
                                            const uint2& va1, const uint16_t* sB, int k16,
                                            int nw) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const uint32_t a[4] = {va0.x, va1.x, va0.y, va1.y};
#pragma unroll
  for (int u = 0; u < NW8; ++u) {
    const uint16_t* p = sB + (k16 + 2 * t) * BSK + (nw + 8 * u + g) * BSN;
    const uint32_t b[2] = {p[0] | static_cast<uint32_t>(p[BSK]) << 16,
                           p[8 * BSK] | static_cast<uint32_t>(p[9 * BSK]) << 16};
    mma_bf16(part[u], a, b);
  }
}

// part += the 8-deep step k8 of a chunk for one m16 tile and NW8 n8 tiles:
// A's rows g and g + 8 as loaded (va0, va1: the lane's group slots, zero
// where masked), B(k, n) = sB[k * BSK + n * BSN] at the warp's columns nw.
template <int NW8, int BSK, int BSN>
__device__ __forceinline__ void mma_step(float (&part)[NW8][4], const float4& va0,
                                         const float4& va1, const float* sB, int k8,
                                         int nw) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const uint32_t ab[4] = {__float_as_uint(va0.x), __float_as_uint(va1.x),
                          __float_as_uint(va0.y), __float_as_uint(va1.y)};
  const uint32_t as[4] = {__float_as_uint(va0.z), __float_as_uint(va1.z),
                          __float_as_uint(va0.w), __float_as_uint(va1.w)};
  uint32_t bb[NW8][2], bs[NW8][2];
#pragma unroll
  for (int u = 0; u < NW8; ++u)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // b0 (k = t, n = g), b1 (t + 4, g)
      const float2 x = split_tf32(sB[(k8 + t + 4 * i) * BSK + (nw + 8 * u + g) * BSN]);
      bb[u][i] = __float_as_uint(x.x);
      bs[u][i] = __float_as_uint(x.y);
    }
#pragma unroll
  for (int u = 0; u < NW8; ++u) mma_tf32(part[u], as, bb[u]);
#pragma unroll
  for (int u = 0; u < NW8; ++u) mma_tf32(part[u], ab, bs[u]);
#pragma unroll
  for (int u = 0; u < NW8; ++u) mma_tf32(part[u], ab, bb[u]);
}

// ---- dgemm -----------------------------------------------------------------

constexpr int kMaxJobs = 12;  // jobs of one dgemm launch (column tiles counted)

enum Epi { E_BIAS = 0, E_BIAS_RES = 1, E_GELU_BWD = 2 };

// One term: acc[r, n] += sum_tap sum_k A(r + shift_tap, k) B_tap(k, n), where
// A is `src` (K floats a row) read at r's position shifted by tap (dy, dx)
// = sign * (tap / 3 - 1, tap % 3 - 1) for a 3x3 conv (taps 9) and (0, 0)
// for a 1x1 (taps 1), zero off the image, through gelu with `gelu`;
// B_tap(k, n) = w[tap * K * ld + k * ld + n], or with `trans`
// w[tap * K * ld + n * ld + k]. K and ld are multiples of 4 (of 8 in a bf16
// product, whose w holds bf16 values), w 16-byte aligned. With s16 the
// source holds bf16 values (K a multiple of 8).
struct DTerm {
  const void* src;
  const void* w;
  int K, taps, sign, gelu, ld, trans, s16;
};

// One job: columns [n0, n0 + BN) (those below N) of
//   out[r, n] = epilogue(sum_terms)
// E_BIAS: + bias[n]; E_BIAS_RES: + bias[n] + res[r, n]; E_GELU_BWD:
// gelu'(z[r, n]) * sum (+ base[r, n] where base is given). out, res, z and
// base have rows of ldo floats; z16 stands for z where z is a bf16 save, and
// out16, where given, gets a bf16 copy of out (rows of ldo values).
struct DJob {
  DTerm t[2];
  int nt, n0, N, epi, ldo;
  const float* bias;
  const float* res;
  const float* z;
  const uint16_t* z16;
  const float* base;
  float* out;
  uint16_t* out16;
};

struct DArgs {
  DJob job[kMaxJobs];
  Geo g;
  int halo;  // rows staged above and below a tile: W + 1 where a term has taps, else 0
  int nbuf;  // A slab buffers: 2 where a job has more than one slab
};

// A 1x1 or k x k term of a Block's product (see DTerm), its source float32
// or, as a save of a bf16 build, bf16.
inline DTerm term(const float* src, int K, int gelu, const void* w, int ld, int trans,
                  int taps = 1, int sign = 1) {
  return DTerm{src, w, K, taps, sign, gelu, ld, trans, 0};
}
inline DTerm term(const uint16_t* src, int K, int gelu, const void* w, int ld, int trans,
                  int taps = 1, int sign = 1) {
  return DTerm{src, w, K, taps, sign, gelu, ld, trans, 1};
}

// gelu's input in a job's E_GELU_BWD epilogue: a float32 tensor or a bf16
// save.
inline void set_z(DJob& j, const float* z) { j.z = z; }
inline void set_z(DJob& j, const uint16_t* z) { j.z16 = z; }

// A product that fills a save: in float32 its output is the save; in bf16
// (a save of uint16_t) the output is float32 scratch, which the next
// product reads unrounded as the Pallas kernels do, and the save its copy
// rounded to bf16.
inline void set_save(DJob&, float*) {}
inline void set_save(DJob& j, uint16_t* save) { j.out16 = save; }

// A product of N columns into out (rows of ldo floats), its terms added.
inline DJob job(int N, int epi, float* out, int ldo, DTerm t0) {
  DJob j{};
  j.t[0] = t0;
  j.nt = 1;
  j.N = N;
  j.epi = epi;
  j.out = out;
  j.ldo = ldo;
  return j;
}

// Threads and tiles of dgemm<BN, TM>: a warp per (m16 row tile, NW8 n8
// tiles); a thread carries NREG of a slab's (row, 8-channel group) items
// ahead.
template <int BN, int TM>
struct DTile {
  using Cl = Cols<BN>;
  static constexpr int KS = BN;                  // depth of a chunk
  static constexpr int WM = TM / 16;
  static constexpr int kThreads = 32 * WM * Cl::WN;
  static constexpr int PA = 2 * KS + 16;         // pitch of a staged A row
  static constexpr int PT = KS + 4;              // pitch of an [n][k] B stage
  static constexpr int BSTAGE = KS * Cl::PB > BN * PT ? KS * Cl::PB : BN * PT;
  static constexpr int GROUPS = KS / 8;          // 8-channel groups of a slab row
  static constexpr int NREG = (TM * GROUPS + kThreads - 1) / kThreads;
  // bf16 products: words of a staged A row (8 or 24: the 8 lanes of a load
  // phase hit distinct banks), bf16 pitches of [k][n] and [n][k] B stages
  static constexpr int PAH = KS / 2, PBH = BN + 8, PTH = KS + 8;
  static_assert(TM % 16 == 0 && PA % 32 == 16 && KS % 16 == 0, "tile");
};

// Floats of dgemm<BN, TM>'s dynamic shared memory.
template <int BN, int TM>
__host__ __device__ constexpr int dgemm_smem_floats(int halo, int nbuf) {
  using T = DTile<BN, TM>;
  return nbuf * (TM + 2 * halo) * T::PA + kNS * T::BSTAGE;
}

// The chunks of a job: term ti, channel offset kc, tap.
struct Cursor {
  int ti, kc, tap;
  template <int KS>
  __device__ __forceinline__ void next(const DJob& J) {
    if (ti >= J.nt) return;
    if (++tap < J.t[ti].taps) return;
    tap = 0;
    kc += KS;
    if (kc < J.t[ti].K) return;
    kc = 0;
    ++ti;
  }
};

template <int BN, int TM, bool BF>
__global__ void __launch_bounds__(DTile<BN, TM>::kThreads) dgemm(const __grid_constant__ DArgs p) {
  using T = DTile<BN, TM>;
  using Cl = Cols<BN>;
  constexpr int KS = T::KS, NW8 = Cl::NW8, PA = T::PA, PB = Cl::PB, PT = T::PT;
  constexpr int PAH = T::PAH, PBH = T::PBH, PTH = T::PTH;
  constexpr int NT = T::kThreads, GROUPS = T::GROUPS, NREG = T::NREG;
  extern __shared__ __align__(16) float smem[];
  const DJob& J = p.job[blockIdx.y];
  const Geo g = p.g;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / Cl::WN, nw = warp % Cl::WN * NW8 * 8;
  const int r0 = blockIdx.x * TM;
  const int arows = TM + 2 * p.halo;
  float* sA = smem;
  float* sB = smem + p.nbuf * arows * PA;

  // this lane's output rows m0 (fragment rows g) and m0 + 8, and their
  // image positions (rows past R lie off every image)
  const int m0 = wm * 16 + lane / 4;
  int py[2], px[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + m0 + 8 * h, pos = r % g.HW;
    py[h] = r < g.R ? pos / g.W : -(1 << 20);
    px[h] = pos % g.W;
  }

  int nc = 0;
  for (int ti = 0; ti < J.nt; ++ti) nc += (J.t[ti].K + KS - 1) / KS * J.t[ti].taps;

  // A slab items: (staged row j, 8-channel group q) = (it / GROUPS, it % GROUPS)
  float va[NREG][8];
  auto halo_of = [&](const DTerm& t) { return t.taps > 1 ? g.W + 1 : 0; };
  auto load_items = [&](const Cursor& c, int base) {
    const DTerm& t = J.t[c.ti];
    const int h = halo_of(t), rows = TM + 2 * h;
#pragma unroll
    for (int n = 0; n < NREG; ++n) {
      const int it = base + tid + n * NT, j = it / GROUPS;
      const int rr = r0 - h + j, col = c.kc + 8 * (it % GROUPS);
      const bool ok = j < rows && rr >= 0 && rr < g.R;
      const int lim = t.K - col;
      if (kBF16 && t.s16) {
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (ok && lim > 0)
          x = __ldg(reinterpret_cast<const uint4*>(static_cast<const uint16_t*>(t.src) +
                                                   (size_t)rr * t.K + col));
        const uint32_t w4[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          va[n][2 * v] = __uint_as_float(w4[v] << 16);
          va[n][2 * v + 1] = __uint_as_float(w4[v] & 0xffff0000u);
        }
        continue;
      }
#pragma unroll
      for (int v = 0; v < 8; v += 4) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok && v < lim) x = ldg4(static_cast<const float*>(t.src) + (size_t)rr * t.K + col + v);
        va[n][v] = x.x;
        va[n][v + 1] = x.y;
        va[n][v + 2] = x.z;
        va[n][v + 3] = x.w;
      }
    }
  };
  auto store_items = [&](const Cursor& c, int base, float* buf) {
    const DTerm& t = J.t[c.ti];
    const int rows = TM + 2 * halo_of(t);
#pragma unroll
    for (int n = 0; n < NREG; ++n) {
      const int it = base + tid + n * NT, j = it / GROUPS;
      if (j >= rows) continue;
      if (t.gelu)
#pragma unroll
        for (int v = 0; v < 8; ++v) va[n][v] = gelu(va[n][v]);
      if constexpr (BF)
        store_group_bf(reinterpret_cast<uint32_t*>(buf) + j * PAH, it % GROUPS, va[n]);
      else
        store_group(buf + j * PA + 16 * (it % GROUPS), va[n]);
    }
  };
  // the slab of chunk c into buf, in passes of NREG items a thread
  auto gather = [&](const Cursor& c, float* buf) {
    const int items = (TM + 2 * halo_of(J.t[c.ti])) * GROUPS;
    for (int base = 0; base < items; base += NREG * NT) {
      load_items(c, base);
      store_items(c, base, buf);
    }
  };
  // B's chunk at c into stage dst (zeros past K and N); a group either way
  auto stage_b = [&](float* dst, const Cursor& c) {
    if (BF && c.ti < J.nt) {
      const DTerm& t = J.t[c.ti];
      const uint16_t* w = static_cast<const uint16_t*>(t.w) + (size_t)c.tap * t.K * t.ld;
      uint16_t* d = reinterpret_cast<uint16_t*>(dst);
      if (!t.trans) {
        constexpr int P = BN / 8;
        for (int it = tid; it < KS * P; it += NT) {
          const int k = c.kc + it / P, n = J.n0 + 8 * (it % P);
          const bool ok = k < t.K && n < J.N;
          cp_async16(smem_u32(d + it / P * PBH + 8 * (it % P)),
                     ok ? w + (size_t)k * t.ld + n : w, ok ? 16 : 0);
        }
      } else {
        constexpr int P = KS / 8;
        for (int it = tid; it < BN * P; it += NT) {
          const int n = J.n0 + it / P, k = c.kc + 8 * (it % P);
          const bool ok = k < t.K && n < J.N;
          cp_async16(smem_u32(d + it / P * PTH + 8 * (it % P)),
                     ok ? w + (size_t)n * t.ld + k : w, ok ? 16 : 0);
        }
      }
    } else if (c.ti < J.nt) {
      const DTerm& t = J.t[c.ti];
      const float* w = static_cast<const float*>(t.w) + (size_t)c.tap * t.K * t.ld;
      if (!t.trans) {
        constexpr int P = BN / 4;
        for (int it = tid; it < KS * P; it += NT) {
          const int k = c.kc + it / P, n = J.n0 + 4 * (it % P);
          const bool ok = k < t.K && n < J.N;
          cp_async16(smem_u32(dst + it / P * PB + 4 * (it % P)),
                     ok ? w + (size_t)k * t.ld + n : w, ok ? 16 : 0);
        }
      } else {
        constexpr int P = KS / 4;
        for (int it = tid; it < BN * P; it += NT) {
          const int n = J.n0 + it / P, k = c.kc + 4 * (it % P);
          const bool ok = k < t.K && n < J.N;
          cp_async16(smem_u32(dst + it / P * PT + 4 * (it % P)),
                     ok ? w + (size_t)n * t.ld + k : w, ok ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };

  float acc[NW8][4];
#pragma unroll
  for (int u = 0; u < NW8; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[u][i] = 0.f;

  Cursor ca{0, 0, 0}, cb{0, 0, 0}, cc{0, 0, 0};  // A's next chunk, B's, the MMAs'
  for (int s = 0; s < kNS - 1; ++s) {
    stage_b(sB + s * T::BSTAGE, cb);
    cb.next<KS>(J);
  }
  gather(ca, sA);
  ca.next<KS>(J);
  int slab = 0;
  for (int c = 0; c < nc; ++c) {
    cp_async_wait_ring<kNS>();
    __syncthreads();  // chunk c's B stage and slab are in; B stage c - 1 is free
    stage_b(sB + (c + kNS - 1) % kNS * T::BSTAGE, cb);
    cb.next<KS>(J);
    const bool fresh = c + 1 < nc && ca.tap == 0;  // chunk c + 1 starts a slab
    const bool ahead = fresh && halo_of(J.t[ca.ti]) == 0;
    if (ahead) load_items(ca, 0);

    // chunk c: the tap's shift and this lane's masks
    const DTerm& t = J.t[cc.ti];
    const int h = halo_of(t);
    const int dy = t.taps > 1 ? t.sign * (cc.tap / 3 - 1) : 0;
    const int dx = t.taps > 1 ? t.sign * (cc.tap % 3 - 1) : 0;
    const bool ok0 = (unsigned)(py[0] + dy) < (unsigned)g.H &&
                     (unsigned)(px[0] + dx) < (unsigned)g.W;
    const bool ok1 = (unsigned)(py[1] + dy) < (unsigned)g.H &&
                     (unsigned)(px[1] + dx) < (unsigned)g.W;
    const float* slab_a = sA + (slab % p.nbuf) * arows * PA;
    const int arow = h + m0 + dy * g.W + dx;
    const float* b = sB + c % kNS * T::BSTAGE;
    float part[NW8][4];
#pragma unroll
    for (int u = 0; u < NW8; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[u][i] = 0.f;
    if constexpr (BF) {
      const uint32_t* a0 = reinterpret_cast<const uint32_t*>(slab_a) + arow * PAH + 2 * (lane % 4);
      const uint16_t* b16 = reinterpret_cast<const uint16_t*>(b);
      const uint2 zero = make_uint2(0u, 0u);
#pragma unroll
      for (int k16 = 0; k16 < KS; k16 += 16) {
        const uint2 v0 = ok0 ? *reinterpret_cast<const uint2*>(a0 + k16 / 2) : zero;
        const uint2 v1 = ok1 ? *reinterpret_cast<const uint2*>(a0 + 8 * PAH + k16 / 2) : zero;
        if (t.trans)
          mma_step_bf<NW8, 1, PTH>(part, v0, v1, b16, k16, nw);
        else
          mma_step_bf<NW8, PBH, 1>(part, v0, v1, b16, k16, nw);
      }
    } else {
      const float* a0 = slab_a + arow * PA + 4 * (lane % 4);
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k8 = 0; k8 < KS; k8 += 8) {
        const float4 v0 = ok0 ? *reinterpret_cast<const float4*>(a0 + 2 * k8) : zero;
        const float4 v1 = ok1 ? *reinterpret_cast<const float4*>(a0 + 8 * PA + 2 * k8) : zero;
        if (t.trans)
          mma_step<NW8, 1, PT>(part, v0, v1, b, k8, nw);
        else
          mma_step<NW8, PB, 1>(part, v0, v1, b, k8, nw);
      }
    }
#pragma unroll
    for (int u = 0; u < NW8; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[u][i] += part[u][i];
    cc.next<KS>(J);

    if (fresh) {
      ++slab;
      float* buf = sA + (slab % p.nbuf) * arows * PA;
      if (ahead)
        store_items(ca, 0, buf);
      else
        gather(ca, buf);
    }
    ca.next<KS>(J);
  }

  const int t2 = 2 * (lane % 4);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + m0 + 8 * hh;
    if (r >= g.R) continue;
#pragma unroll
    for (int u = 0; u < NW8; ++u) {
      const int col = J.n0 + nw + 8 * u + t2;
      if (col >= J.N) continue;
      const size_t o = (size_t)r * J.ldo + col;
      float2 v = make_float2(acc[u][2 * hh], acc[u][2 * hh + 1]);
      if (J.epi == E_GELU_BWD) {
        const float2 z = kBF16 && J.z16 ? make_float2(from_bf16(J.z16[o]), from_bf16(J.z16[o + 1]))
                               : *reinterpret_cast<const float2*>(J.z + o);
        v.x *= gelu_grad(z.x);
        v.y *= gelu_grad(z.y);
        if (J.base) {
          const float2 b2 = *reinterpret_cast<const float2*>(J.base + o);
          v.x += b2.x;
          v.y += b2.y;
        }
      } else {
        v.x += J.bias[col];
        v.y += J.bias[col + 1];
        if (J.epi == E_BIAS_RES) {
          const float2 r2 = *reinterpret_cast<const float2*>(J.res + o);
          v.x += r2.x;
          v.y += r2.y;
        }
      }
      *reinterpret_cast<float2*>(J.out + o) = v;
      if (kBF16 && J.out16) *reinterpret_cast<uint32_t*>(J.out16 + o) = pack_bf16(v.x, v.y);
    }
  }
}

// ---- weight gradients ------------------------------------------------------

constexpr int kMaxWJobs = 8;  // stacks of one wgrad launch
constexpr int kWRows = 64;    // rows (the K axis) of a wgrad chunk

// One weight-gradient product of every level: rows t * Kin + i, columns n of
// level l's dW (at out + l * lout, rows of ldo floats) get
//   sum_r A_l(r + shift_t, i) * G_l[r, n]
// for the Kin input channels i, the N columns n and taps t (shift as a
// DTerm's with sign +1). A_l is src at src + l * lsrc, or with src0 level
// l's input (src0 at l = 0, else src + (l - 1) * lsrc), through gelu with
// `gelu`; G_l the rows of ldg floats at gs + l * lg. With S > 1 the rows are
// cut into S splits of `rows` rows, each split's sum written to part (at
// `pofs`: [L][S][taps * Kin][N]) for reduce_parts. With s16 the sources hold
// bf16 values (the saves of a bf16 build).
struct WJob {
  const void* src0;
  const void* src;
  const float* gs;
  float* out;
  size_t lsrc, lg, lout, pofs;
  int Kin, taps, gelu, ldg, N, ldo, S, rows, s16;
  int nb;  // blocks: L x taps x channel tiles x column tiles x S
};

// The source n elements past p (floats, or bf16 values with s16).
__host__ __device__ inline const void* elem_off(const void* p, size_t n, int s16) {
  return kBF16 && s16 ? static_cast<const void*>(static_cast<const uint16_t*>(p) + n)
             : static_cast<const void*>(static_cast<const float*>(p) + n);
}

// B(k, n) of a bf16 weight-gradient step, from float32 rows at `b` (rows of
// PB floats, the lane's column at b): the rows 2t, 2t + 1 and 2t + 8, 2t + 9
// of the 16-deep step k16, rounded, zero where `ok` (a row's bit) is clear.
template <int PB>
__device__ __forceinline__ void b_frag_bf(uint32_t (&bf)[2], const float* b, int k16,
                                          unsigned ok) {
  const int t = threadIdx.x % 4;
  const float* r = b + (k16 + 2 * t) * PB;
  bf[0] = pack_bf16(ok & 1u ? r[0] : 0.f, ok & 2u ? r[PB] : 0.f);
  bf[1] = pack_bf16(ok & 4u ? r[8 * PB] : 0.f, ok & 8u ? r[9 * PB] : 0.f);
}

struct WArgs {
  WJob job[kMaxWJobs];
  Geo g;
  float* part;
};

// Threads and tiles of wgrad<BN>: a block owns BN channels x BN columns of
// one tap, level and split; a warp one m16 channel tile x NW8 n8 tiles.
template <int BN>
struct WTile {
  using Cl = Cols<BN>;
  static constexpr int TMW = BN;                    // channels of a block
  static constexpr int WM = TMW / 16;
  static constexpr int kThreads = 32 * WM * Cl::WN;
  static constexpr int PW = 2 * kWRows + 16;        // pitch of a staged channel
  static constexpr int ITEMS = TMW * kWRows / 8;    // (channel, 8-row group) items
  static constexpr int NREG = (ITEMS + kThreads - 1) / kThreads;
  static constexpr int SMEM_FLOATS = 2 * TMW * PW + kWNS * kWRows * Cl::PB;
  static constexpr int PWH = kWRows / 2 + 8;       // words of a staged bf16 channel
  static_assert(PW % 32 == 16 && PWH % 32 == 8, "tile");
};

template <int BN, bool BF>
__global__ void __launch_bounds__(WTile<BN>::kThreads) wgrad(const __grid_constant__ WArgs p) {
  using T = WTile<BN>;
  using Cl = Cols<BN>;
  constexpr int NW8 = Cl::NW8, PW = T::PW, PB = Cl::PB, NT = T::kThreads, NREG = T::NREG;
  constexpr int PWH = T::PWH;
  constexpr int TMW = T::TMW, KR = kWRows;
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;
  float* sB = smem + 2 * TMW * PW;
  const Geo g = p.g;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / Cl::WN, nw = warp % Cl::WN * NW8 * 8;

  // this block's job, then (level, tap, channel tile, column tile, split)
  int b = blockIdx.x, jj = 0;
  while (b >= p.job[jj].nb) b -= p.job[jj++].nb;
  const WJob& J = p.job[jj];
  const int S = J.S, sp = b % S;
  b /= S;
  const int ncol = (J.N + BN - 1) / BN, nch = (J.Kin + TMW - 1) / TMW;
  const int n0 = b % ncol * BN;
  b /= ncol;
  const int i0 = b % nch * TMW;
  b /= nch;
  const int tap = b % J.taps, l = b / J.taps;
  const int dy = J.taps > 1 ? tap / 3 - 1 : 0, dx = J.taps > 1 ? tap % 3 - 1 : 0;
  const void* src = J.src0 ? (l ? elem_off(J.src, (l - 1) * J.lsrc, J.s16) : J.src0)
                           : elem_off(J.src, l * J.lsrc, J.s16);
  const float* gl = J.gs + l * J.lg;
  const int rbeg = sp * J.rows, rend = min(g.R, rbeg + J.rows);

  // A items: (channel i, 8-row group q) = (it % TMW, it / TMW); va holds
  // the next chunk's, vb the one after
  using Items = float[NREG][8];
  Items va, vb;
  auto load_a = [&](Items& vx, int k0) {
#pragma unroll
    for (int n = 0; n < NREG; ++n) {
      const int it = tid + n * NT, i = it % TMW, q = it / TMW;
      const bool chan = it < T::ITEMS && i0 + i < J.Kin;
      int r = k0 + 8 * q;
      const int pos = r % g.HW;
      int y = pos / g.W, x = pos % g.W;
#pragma unroll
      for (int v = 0; v < 8; ++v, ++r) {
        const bool ok = chan && r < rend && (unsigned)(y + dy) < (unsigned)g.H &&
                        (unsigned)(x + dx) < (unsigned)g.W;
        float a = 0.f;
        if (ok) a = src_at(src, (size_t)(r + dy * g.W + dx) * J.Kin + i0 + i, J.s16);
        vx[n][v] = a;
        if (++x == g.W) {
          x = 0;
          if (++y == g.H) y = 0;
        }
      }
    }
  };
  auto store_a = [&](Items& vx, float* buf) {
#pragma unroll
    for (int n = 0; n < NREG; ++n) {
      const int it = tid + n * NT;
      if (it >= T::ITEMS) continue;
      if (J.gelu)
#pragma unroll
        for (int v = 0; v < 8; ++v) vx[n][v] = gelu(vx[n][v]);
      if constexpr (BF)
        store_group_bf(reinterpret_cast<uint32_t*>(buf) + it % TMW * PWH, it / TMW, vx[n]);
      else
        store_group(buf + it % TMW * PW + 16 * (it / TMW), vx[n]);
    }
  };
  // cotangent rows k0 .. k0 + KR into B stage dst, zeros past rend and N
  auto stage_b = [&](float* dst, int k0) {
    if (k0 < rend) {
      constexpr int P = BN / 4;
      for (int it = tid; it < KR * P; it += NT) {
        const int r = k0 + it / P, n = n0 + 4 * (it % P);
        const bool ok = r < rend && n < J.N;
        cp_async16(smem_u32(dst + it / P * PB + 4 * (it % P)),
                   ok ? gl + (size_t)r * J.ldg + n : gl, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[NW8][4];
#pragma unroll
  for (int u = 0; u < NW8; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[u][i] = 0.f;
  const int nc = (rend - rbeg + KR - 1) / KR;
  for (int s = 0; s < kWNS - 1; ++s) stage_b(sB + s * KR * PB, rbeg + s * KR);
  load_a(vb, rbeg);
  store_a(vb, sA);
  if (nc > 1) load_a(va, rbeg + KR);
  const float* a0 = sA + (wm * 16 + lane / 4) * PW + 4 * (lane % 4);
  for (int c = 0; c < nc; ++c) {
    const int k0 = rbeg + c * KR;
    cp_async_wait_ring<kWNS>();
    __syncthreads();  // chunk c's B stage and A are in; B stage c - 1 is free
    stage_b(sB + (c + kWNS - 1) % kWNS * KR * PB, k0 + (kWNS - 1) * KR);
    const bool more = c + 1 < nc, more2 = c + 2 < nc;
    if (more2) load_a(vb, k0 + 2 * KR);
    const float* bs = sB + c % kWNS * KR * PB;
    float part[NW8][4];
#pragma unroll
    for (int u = 0; u < NW8; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[u][i] = 0.f;
    if constexpr (BF) {
      const uint32_t* a = reinterpret_cast<const uint32_t*>(sA + c % 2 * TMW * PW) +
                          (wm * 16 + lane / 4) * PWH + 2 * (lane % 4);
#pragma unroll
      for (int k16 = 0; k16 < KR; k16 += 16) {
        const uint2 v0 = *reinterpret_cast<const uint2*>(a + k16 / 2);
        const uint2 v1 = *reinterpret_cast<const uint2*>(a + 8 * PWH + k16 / 2);
        const uint32_t af[4] = {v0.x, v1.x, v0.y, v1.y};
#pragma unroll
        for (int u = 0; u < NW8; ++u) {
          uint32_t bf[2];
          b_frag_bf<PB>(bf, bs + nw + 8 * u + lane / 4, k16, 15u);
          mma_bf16(part[u], af, bf);
        }
      }
    } else {
      const float* a = a0 + c % 2 * TMW * PW;
#pragma unroll
      for (int k8 = 0; k8 < KR; k8 += 8) {
        const float4 v0 = *reinterpret_cast<const float4*>(a + 2 * k8);
        const float4 v1 = *reinterpret_cast<const float4*>(a + 8 * PW + 2 * k8);
        mma_step<NW8, PB, 1>(part, v0, v1, bs, k8, nw);
      }
    }
#pragma unroll
    for (int u = 0; u < NW8; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[u][i] += part[u][i];
    if (more) store_a(va, sA + (c + 1) % 2 * TMW * PW);
    if (more2)
#pragma unroll
      for (int n = 0; n < NREG; ++n)
#pragma unroll
        for (int v = 0; v < 8; ++v) va[n][v] = vb[n][v];
  }

  const size_t per = (size_t)J.taps * J.Kin * J.N;  // one level's dW entries
  const int t2 = 2 * (lane % 4);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = i0 + wm * 16 + lane / 4 + 8 * hh;
    if (i >= J.Kin) continue;
    const size_t row = (size_t)tap * J.Kin + i;
#pragma unroll
    for (int u = 0; u < NW8; ++u) {
      const int n = n0 + nw + 8 * u + t2;
      if (n >= J.N) continue;
      float* o = S == 1 ? J.out + l * J.lout + row * J.ldo + n
                        : p.part + J.pofs + ((size_t)l * S + sp) * per + row * J.N + n;
      *reinterpret_cast<float2*>(o) = make_float2(acc[u][2 * hh], acc[u][2 * hh + 1]);
    }
  }
}

// The weight gradients of k x k stacks (taps 9): a block owns 16 input
// channels x BN columns of one level and split, and all nine taps, a warp
// per (tap, column group). With r' = r + shift_t,
//   dW_t[i, n] = sum_r' A(r', i) * G(r' - shift_t, n) * valid(r', t),
// valid where r' - shift_t is r''s position moved by -(dy, dx) inside the
// image: each chunk's source rows are gathered through gelu once for the
// nine taps, and each tap reads the cotangent rows staged once with their
// halo of W + 1 rows, shifted, under a per-row mask of the taps.
template <int BN>
struct TTile {
  using Cl = Cols<BN>;
  static constexpr int kTaps = 9, TMW = 16;
  static constexpr int kThreads = 32 * kTaps * Cl::WN;
  static constexpr int PW = 2 * kWRows + 16;        // pitch of a staged channel
  static constexpr int ITEMS = TMW * kWRows / 8;    // (channel, 8-row group) items
  static constexpr int PWH = kWRows / 2 + 8;       // words of a staged bf16 channel
  static_assert(ITEMS <= kThreads && kWRows <= kThreads, "gather");
};

// Floats of wgrad_taps<BN>'s dynamic shared memory at image width W: two
// A chunks, two chunks' tap masks, kWNS stages of cotangent rows with
// their halo.
template <int BN>
__host__ __device__ constexpr int taps_smem_floats(int W) {
  using T = TTile<BN>;
  return 2 * T::TMW * T::PW + 2 * kWRows + kWNS * (kWRows + 2 * (W + 1)) * Cols<BN>::PB;
}

template <int BN, bool BF>
__global__ void __launch_bounds__(TTile<BN>::kThreads, 1)
    wgrad_taps(const __grid_constant__ WArgs p) {
  using T = TTile<BN>;
  using Cl = Cols<BN>;
  constexpr int NW8 = Cl::NW8, PW = T::PW, PB = Cl::PB, TMW = T::TMW, KR = kWRows;
  constexpr int PWH = T::PWH;
  extern __shared__ __align__(16) float smem[];
  const Geo g = p.g;
  const int halo = g.W + 1, grows = KR + 2 * halo;
  float* sA = smem;
  uint32_t* sM = reinterpret_cast<uint32_t*>(smem + 2 * TMW * PW);
  float* sG = smem + 2 * TMW * PW + 2 * KR;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tap = warp / Cl::WN, nw = warp % Cl::WN * NW8 * 8;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;

  // this block's job, then (level, channel tile, column tile, split)
  int b = blockIdx.x, jj = 0;
  while (b >= p.job[jj].nb) b -= p.job[jj++].nb;
  const WJob& J = p.job[jj];
  const int S = J.S, sp = b % S;
  b /= S;
  const int ncol = (J.N + BN - 1) / BN, nch = (J.Kin + TMW - 1) / TMW;
  const int n0 = b % ncol * BN;
  b /= ncol;
  const int i0 = b % nch * TMW, l = b / nch;
  const void* src = elem_off(J.src, l * J.lsrc, J.s16);
  const float* gl = J.gs + l * J.lg;
  const int rbeg = sp * J.rows, rend = min(g.R, rbeg + J.rows);

  // A items (threads below ITEMS): channel tid % TMW, rows 8 (tid / TMW) ..
  float va[8];
  uint32_t mask = 0;
  auto load_a = [&](int k0) {
    const int i = tid % TMW, r = k0 + 8 * (tid / TMW);
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const bool ok = tid < T::ITEMS && r + v < rend && i0 + i < J.Kin;
      va[v] = ok ? src_at(src, (size_t)(r + v) * J.Kin + i0 + i, J.s16) : 0.f;
    }
    // the taps' mask of row k0 + tid (threads below KR)
    const int rm = k0 + tid, pos = rm % g.HW, y = pos / g.W, x = pos % g.W;
    mask = 0;
#pragma unroll
    for (int t = 0; t < 9; ++t)
      if ((unsigned)(y - t / 3 + 1) < (unsigned)g.H && (unsigned)(x - t % 3 + 1) < (unsigned)g.W)
        mask |= 1u << t;
  };
  auto store_a = [&](int s) {
    if (tid < T::ITEMS) {
      if (J.gelu)
#pragma unroll
        for (int v = 0; v < 8; ++v) va[v] = gelu(va[v]);
      if constexpr (BF)
        store_group_bf(reinterpret_cast<uint32_t*>(sA + s * TMW * PW) + tid % TMW * PWH,
                       tid / TMW, va);
      else
        store_group(sA + s * TMW * PW + tid % TMW * PW + 16 * (tid / TMW), va);
    }
    if (tid < KR) sM[s * KR + tid] = mask;
  };
  // cotangent rows k0 - halo .. k0 + KR + halo into stage dst, zeros off
  // [0, R) and past N
  auto stage_g = [&](float* dst, int k0) {
    if (k0 < rend) {
      constexpr int P = BN / 4;
      for (int it = tid; it < grows * P; it += T::kThreads) {
        const int r = k0 - halo + it / P, n = n0 + 4 * (it % P);
        const bool ok = r >= 0 && r < g.R && n < J.N;
        cp_async16(smem_u32(dst + it / P * PB + 4 * (it % P)),
                   ok ? gl + (size_t)r * J.ldg + n : gl, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[NW8][4];
#pragma unroll
  for (int u = 0; u < NW8; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[u][i] = 0.f;
  const int nc = (rend - rbeg + KR - 1) / KR, gstage = grows * PB;
  for (int s = 0; s < kWNS - 1; ++s) stage_g(sG + s * gstage, rbeg + s * KR);
  load_a(rbeg);
  store_a(0);
  const int t4 = lane % 4;
  // B(k, n) of this warp's tap: the staged row k + halo - shift
  const int brow = halo - (dy * g.W + dx) + t4;
  for (int c = 0; c < nc; ++c) {
    const int k0 = rbeg + c * KR;
    cp_async_wait_ring<kWNS>();
    __syncthreads();  // chunk c's cotangent stage and A are in; stage c - 1 is free
    stage_g(sG + (c + kWNS - 1) % kWNS * gstage, k0 + (kWNS - 1) * KR);
    const bool more = c + 1 < nc;
    if (more) load_a(k0 + KR);
    float part[NW8][4];
#pragma unroll
    for (int u = 0; u < NW8; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[u][i] = 0.f;
    if constexpr (BF) {
      const uint32_t* a = reinterpret_cast<const uint32_t*>(sA + c % 2 * TMW * PW) +
                          lane / 4 * PWH + 2 * t4;
      const uint32_t* m = sM + c % 2 * KR + 2 * t4;
      // B(k, n) of this warp's tap: the staged row k + halo - shift
      const float* bg = sG + c % kWNS * gstage + (halo - (dy * g.W + dx)) * PB + nw + lane / 4;
#pragma unroll
      for (int k16 = 0; k16 < KR; k16 += 16) {
        const uint2 v0 = *reinterpret_cast<const uint2*>(a + k16 / 2);
        const uint2 v1 = *reinterpret_cast<const uint2*>(a + 8 * PWH + k16 / 2);
        const uint32_t af[4] = {v0.x, v1.x, v0.y, v1.y};
        const unsigned ok = (m[k16] >> tap & 1u) | (m[k16 + 1] >> tap & 1u) << 1 |
                            (m[k16 + 8] >> tap & 1u) << 2 | (m[k16 + 9] >> tap & 1u) << 3;
#pragma unroll
        for (int u = 0; u < NW8; ++u) {
          uint32_t bf[2];
          b_frag_bf<PB>(bf, bg + 8 * u, k16, ok);
          mma_bf16(part[u], af, bf);
        }
      }
    } else {
      const float* a = sA + c % 2 * TMW * PW + lane / 4 * PW + 4 * t4;
      const uint32_t* m = sM + c % 2 * KR + t4;
      const float* bg = sG + c % kWNS * gstage + brow * PB + nw + lane / 4;
#pragma unroll
      for (int k8 = 0; k8 < KR; k8 += 8) {
        const float4 v0 = *reinterpret_cast<const float4*>(a + 2 * k8);
        const float4 v1 = *reinterpret_cast<const float4*>(a + 8 * PW + 2 * k8);
        const bool ok0 = m[k8] >> tap & 1u, ok1 = m[k8 + 4] >> tap & 1u;
        const uint32_t ab[4] = {__float_as_uint(v0.x), __float_as_uint(v1.x),
                                __float_as_uint(v0.y), __float_as_uint(v1.y)};
        const uint32_t as[4] = {__float_as_uint(v0.z), __float_as_uint(v1.z),
                                __float_as_uint(v0.w), __float_as_uint(v1.w)};
        uint32_t bb[NW8][2], bs[NW8][2];
#pragma unroll
        for (int u = 0; u < NW8; ++u) {
          // b0 (k = t, n = g), b1 (t + 4, g), zero where the tap is masked
          const float2 x0 = split_tf32(ok0 ? bg[k8 * PB + 8 * u] : 0.f);
          const float2 x1 = split_tf32(ok1 ? bg[(k8 + 4) * PB + 8 * u] : 0.f);
          bb[u][0] = __float_as_uint(x0.x);
          bs[u][0] = __float_as_uint(x0.y);
          bb[u][1] = __float_as_uint(x1.x);
          bs[u][1] = __float_as_uint(x1.y);
        }
#pragma unroll
        for (int u = 0; u < NW8; ++u) mma_tf32(part[u], as, bb[u]);
#pragma unroll
        for (int u = 0; u < NW8; ++u) mma_tf32(part[u], ab, bs[u]);
#pragma unroll
        for (int u = 0; u < NW8; ++u) mma_tf32(part[u], ab, bb[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < NW8; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[u][i] += part[u][i];
    if (more) store_a((c + 1) % 2);
  }

  const size_t per = (size_t)J.taps * J.Kin * J.N;  // one level's dW entries
  const int t2 = 2 * t4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = i0 + lane / 4 + 8 * hh;
    if (i >= J.Kin) continue;
    const size_t row = (size_t)tap * J.Kin + i;
#pragma unroll
    for (int u = 0; u < NW8; ++u) {
      const int n = n0 + nw + 8 * u + t2;
      if (n >= J.N) continue;
      float* o = S == 1 ? J.out + l * J.lout + row * J.ldo + n
                        : p.part + J.pofs + ((size_t)l * S + sp) * per + row * J.N + n;
      *reinterpret_cast<float2*>(o) = make_float2(acc[u][2 * hh], acc[u][2 * hh + 1]);
    }
  }
}

// out_l[(j / N) * ldo + j % N] = sum_s part[l][s][j], in the order of s, for
// every entry j of every level of the jobs with S > 1; one thread an entry.
struct RArgs {
  WJob job[3 * kMaxWJobs];
  int nj, L;
  const float* part;
};

__global__ void reduce_parts(const __grid_constant__ RArgs p) {
  size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int jj = 0; jj < p.nj; ++jj) {
    const WJob& J = p.job[jj];
    const size_t per = (size_t)J.taps * J.Kin * J.N, n = per * p.L;
    if (idx >= n) {
      idx -= n;
      continue;
    }
    const size_t l = idx / per, j = idx % per;
    const float* src = p.part + J.pofs + l * J.S * per + j;
    float acc = 0.f;
    for (int s = 0; s < J.S; ++s) acc += src[s * per];
    J.out[l * J.lout + j / J.N * J.ldo + j % J.N] = acc;
    return;
  }
}

// ---- bias gradients --------------------------------------------------------

constexpr int kMaxBJobs = 20;
constexpr int kBiasThreads = 512;  // 32 columns x 16 row lanes

// db_l[c] = sum_r G_l[r, c] for the N columns of each job (G_l at gs + l * lg,
// rows of ldg floats; db_l at out + l * lout).
struct BJob {
  const float* gs;
  float* out;
  size_t lg, lout;
  int ldg, N;
};

struct BArgs {
  BJob job[kMaxBJobs];
  int nj, L, R;
};

// A block per (job, level, 32 columns): each of 16 row lanes sums every 16th
// row, then the lanes are added in order.
__global__ void __launch_bounds__(kBiasThreads) bias_sums(const __grid_constant__ BArgs p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LANES = kBiasThreads / 32;
  int b = blockIdx.x, jj = 0;
  for (;; ++jj) {
    const int nb = p.L * ((p.job[jj].N + 31) / 32);
    if (b < nb) break;
    b -= nb;
  }
  const BJob& J = p.job[jj];
  const int ncol = (J.N + 31) / 32, l = b / ncol;
  const int col = threadIdx.x % 32, lane = threadIdx.x / 32;
  const int c = b % ncol * 32 + col;
  float acc = 0.f;
  if (c < J.N) {
    const float* gl = J.gs + l * J.lg + c;
    for (int r = lane; r < p.R; r += LANES) acc += gl[(size_t)r * J.ldg];
  }
  smem[lane * 32 + col] = acc;
  __syncthreads();
  if (lane == 0 && c < J.N) {
    float s = 0.f;
    for (int i = 0; i < LANES; ++i) s += smem[i * 32 + col];
    J.out[l * J.lout + c] = s;
  }
}

// ---- launches --------------------------------------------------------------

// Launches kernel k over `grid` on `stream`. Above 48 KB of dynamic shared
// memory the limit is set at every launch, not once behind a function-local
// static: such a static is one object across every loaded library that
// includes this header. A refusal shows as the launch's error.
template <class T>
struct Same {
  using type = T;
};

template <class... A>
inline void launch_kernel(void (*k)(A...), dim3 grid, int threads, int smem_bytes,
                          cudaStream_t stream, typename Same<A>::type... args) {
  if (smem_bytes > 48 * 1024)
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  k<<<grid, threads, smem_bytes, stream>>>(args...);
}

// Blocks a launch should have to fill a wave of the H100's 132 SMs (a
// build may set fewer: the CPU emulation's tests give their small runs
// 64-row tiles).
#ifndef PM_CORE_WAVE_BLOCKS
#define PM_CORE_WAVE_BLOCKS 132
#endif
constexpr int kWaveBlocks = PM_CORE_WAVE_BLOCKS;

template <int BN, int TM, bool BF>
inline void launch_dgemm_tm(const DArgs& a, int nj, cudaStream_t s) {
  const int smem = dgemm_smem_floats<BN, TM>(a.halo, a.nbuf) * 4;
  launch_kernel(dgemm<BN, TM, BF>, dim3((a.g.R + TM - 1) / TM, nj), DTile<BN, TM>::kThreads,
                smem, s, a);
}

// One dgemm launch of the `np` products `prob` (each job's n0 ignored: its
// column tiles become jobs of their own). The row tile is the largest of
// 64, 32 and 16 whose grid fills a wave of SMs, else 16. BF: the products in
// bf16 (every term's w holding bf16 values).
template <int BN, bool BF = false>
inline void launch_dgemm(const Geo& g, const DJob* prob, int np, cudaStream_t s) {
  DArgs a{};
  a.g = g;
  a.nbuf = 1;
  int nj = 0;
  for (int i = 0; i < np; ++i) {
    int slabs = 0;
    for (int ti = 0; ti < prob[i].nt; ++ti) {
      const DTerm& t = prob[i].t[ti];
      if (t.taps > 1) a.halo = g.W + 1;
      slabs += (t.K + BN - 1) / BN;
    }
    if (slabs > 1) a.nbuf = 2;
    for (int n0 = 0; n0 < prob[i].N && nj < kMaxJobs; n0 += BN) {
      a.job[nj] = prob[i];
      a.job[nj++].n0 = n0;
    }
  }
  const int tiles64 = (g.R + 63) / 64, tiles32 = (g.R + 31) / 32;
  if (tiles64 * nj >= kWaveBlocks)
    launch_dgemm_tm<BN, 64, BF>(a, nj, s);
  else if (tiles32 * nj >= kWaveBlocks)
    launch_dgemm_tm<BN, 32, BF>(a, nj, s);
  else
    launch_dgemm_tm<BN, 16, BF>(a, nj, s);
}

// Blocks a weight-gradient launch aims for (two blocks a SM, two waves),
// the fewest rows a split sums (a build may set fewer: the CPU emulation's
// tests cut their small runs into splits).
constexpr int kWgradBlocks = 4 * 132;
#ifndef PM_CORE_MIN_SPLIT_ROWS
#define PM_CORE_MIN_SPLIT_ROWS 512
#endif
constexpr int kMinSplitRows = PM_CORE_MIN_SPLIT_ROWS;

// Blocks of one split of job J: a block per (level, tap, BN channels, BN
// columns) in wgrad, per (level, 16 channels, BN columns) with the taps
// folded in wgrad_taps (`taps`).
template <int BN>
inline int wgrad_blocks(const WJob& J, int L, bool taps) {
  const int tmw = taps ? TTile<BN>::TMW : BN;
  return L * (taps ? 1 : J.taps) * ((J.Kin + tmw - 1) / tmw) * ((J.N + BN - 1) / BN);
}

// Sets the row splits (S, rows, nb) of the `nj` jobs of one weight-gradient
// launch over L levels (wgrad_taps's with `taps`), their partials' offsets
// from *pofs on (advanced past them); returns the launch's blocks.
template <int BN>
inline int plan_wgrad(const Geo& g, int L, WJob* job, int nj, bool taps, size_t* pofs) {
  int blocks = 0;
  for (int i = 0; i < nj; ++i) blocks += wgrad_blocks<BN>(job[i], L, taps);
  int S = (kWgradBlocks + blocks - 1) / blocks;
  const int most = g.R / kMinSplitRows;
  S = S < most ? S : most;
  int rows = g.R;
  if (S > 1) {
    rows = (g.R + S - 1) / S;
    rows = (rows + kWRows - 1) / kWRows * kWRows;
    S = (g.R + rows - 1) / rows;
  } else {
    S = 1;
  }
  for (int i = 0; i < nj; ++i) {
    WJob& J = job[i];
    J.S = S;
    J.rows = rows;
    J.nb = wgrad_blocks<BN>(J, L, taps) * S;
    J.pofs = *pofs;
    if (S > 1) *pofs += (size_t)L * S * J.taps * J.Kin * J.N;
  }
  return blocks * S;
}

// One weight-gradient launch of the `nj` jobs (wgrad_taps's with `taps`;
// BF: the products in bf16; see launch_wgrad_dt).
template <int BN, bool BF = false>
inline void launch_wgrad(const Geo& g, const WJob* job, int nj, int blocks, bool taps,
                         float* part, cudaStream_t s) {
  WArgs a{};
  a.g = g;
  a.part = part;
  for (int i = 0; i < nj; ++i) a.job[i] = job[i];
  if (taps)
    launch_kernel(wgrad_taps<BN, BF>, dim3(blocks), TTile<BN>::kThreads,
                  taps_smem_floats<BN>(g.W) * 4, s, a);
  else
    launch_kernel(wgrad<BN, BF>, dim3(blocks), WTile<BN>::kThreads, WTile<BN>::SMEM_FLOATS * 4,
                  s, a);
}

// launch_wgrad with the products in bf16 where `bf` is set, which only a
// bf16 build instantiates.
template <int BN>
inline void launch_wgrad_dt(bool bf, const Geo& g, const WJob* job, int nj, int blocks,
                            bool taps, float* part, cudaStream_t s) {
  if constexpr (kBF16) {
    if (bf) {
      launch_wgrad<BN, true>(g, job, nj, blocks, taps, part, s);
      return;
    }
  }
  launch_wgrad<BN, false>(g, job, nj, blocks, taps, part, s);
}

}  // namespace PM_CORE_NS
