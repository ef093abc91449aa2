// The launch sequences of the gated-chain training kernels over consecutive
// levels, shared by gated_stream_{fwd,bwd}.cu (a whole pass, weights and
// saves stacked [L, ...]) and gated_levels_{fwd,bwd}.cu (the pair's one
// level and the segment's L, every tensor its own): each entry point hands
// these sequences one pointer set per level.
//
// Forward, per level: conv_a (+ aux) of the vertical block, then conv_b with
// the gate and residual in the epilogue, then the same for the horizontal
// block with the new vertical as aux (gated_common.cuh's data_gemm, one
// launch over all B*H*W rows each), after one launch for every level's cond
// projection. Backward, top level first: the gate's derivative, then the
// transposed conv_b, aux and conv_a products with concat_elu's derivative
// and the dropout mask in their epilogues; a level's external cotangents are
// added into the carried ones (a null pointer is a zero cotangent). The
// weight gradients of all levels then run as one launch per weight kind
// (wgrad, on data_gemm's tensor-core core: one block per (64 input
// channels, tap, level, row split), the rows of the pass as its K axis),
// the bias and cond gradients as small reductions. A weight kind whose grid
// is small (the pair's: 4-24 blocks at one level) has its rows cut into S
// splits, so that its launch has ~kWgradBlocks blocks; each split's block
// writes a partial sum, and reduce_splits adds the S partials in split
// order. No atomics: each output is summed in a fixed order (the chunks,
// then the fragments, then the splits), so equal inputs give equal
// gradients on every run.
//
// Everything from "---- launches" on launches kernels; the part above is
// device code and host helpers only (the CPU emulation of the kernels,
// tests/cuda_emulation, compiles that part).
#pragma once

#include "gated_common.cuh"

namespace gsk {

constexpr int kMaxLevels = 32;  // ops/gated_chain.py MAX_LEVELS
// Blocks of 64 channels a weight-gradient launch aims for (two waves over
// the H100's 132 SMs), the fewest rows a split sums, and what a split's
// rows are a multiple of: the same splits as 4 x 132 blocks of 32 channels.
constexpr int kWgradBlocks = 2 * 132;
constexpr int kMinSplitRows = 128;
constexpr int kSplitAlign = 16;

// Per-level pointers passed by value in a kernel's parameters.
template <typename T>
struct PerLevelT {
  T p[kMaxLevels];
};
using PerLevel = PerLevelT<const float*>;
using PerLevelC = PerLevelT<const cdt*>;  // tensors of the compute dtype
using PerLevelOut = PerLevelT<float*>;

// One level's tensors in the forward, in the order of
// ops/gated_chain.py::_LEVEL_FWD (the skips and skip weights null on the up
// pass).
enum LevelFwdPtr {
  LF_SKV, LF_SKH,
  LF_WAV, LF_BAV, LF_WBV, LF_BBV, LF_WCV, LF_WXV,
  LF_WAH, LF_BAH, LF_WBH, LF_BBH, LF_WCH, LF_WXHU, LF_WXHS,
  LF_XVO, LF_XHO, LF_A1V, LF_A1H, LF_B1V, LF_B1H, LF_COUNT
};

// ... and in the backward (ops/gated_chain.py::_LEVEL_BWD): the external
// cotangents of the level's outputs (null: zero), its saves, its weights,
// its skips' and weights' gradients.
enum LevelBwdPtr {
  LB_GV, LB_GH, LB_XVO, LB_XHO, LB_SKV, LB_SKH, LB_A1V, LB_A1H, LB_B1V, LB_B1H,
  LB_WAV, LB_WBV, LB_WCV, LB_WXV, LB_WAH, LB_WBH, LB_WCH, LB_WXHU, LB_WXHS,
  LB_DSKV, LB_DSKH,
  LB_DWAV, LB_DBAV, LB_DWBV, LB_DBBV, LB_DWCV, LB_DWXV,
  LB_DWAH, LB_DBAH, LB_DWBH, LB_DBBH, LB_DWCH, LB_DWXHU, LB_DWXHS, LB_COUNT
};

// A level's pointers: in / out for the float32 ones (biases and
// gradients), act / act_out for those of the compute dtype (activations,
// saves, their cotangents, the weight matrices).
template <int N>
struct Level {
  const void* p[N];
  const float* in(int i) const { return static_cast<const float*>(p[i]); }
  float* out(int i) const { return static_cast<float*>(const_cast<void*>(p[i])); }
  const cdt* act(int i) const { return static_cast<const cdt*>(p[i]); }
  cdt* act_out(int i) const { return static_cast<cdt*>(const_cast<void*>(p[i])); }
};
using LevelFwd = Level<LF_COUNT>;
using LevelBwd = Level<LB_COUNT>;

// The settings every level shares: geometry, width, taps, dropout, and
// whether the backward's carries between levels are rounded to the compute
// dtype (the stream's rule in bf16; a segment keeps them float32).
struct Chain {
  Geo g;
  Taps tv, th;
  int L, CD, F, base;
  bool drop, round_carry;
  uint32_t seed, thresh;
  float inv_keep;
};

// Reads the _GEOMETRY ints; false unless they describe a chain the kernels
// take.
inline bool make_chain(const int* ints, int nints, float inv_keep, Chain& c) {
  if (nints != I_COUNT ||
      !taps_ok(ints[I_TV_SKH], ints[I_TV_SKW], ints[I_TV_PT], ints[I_TV_PL]) ||
      !taps_ok(ints[I_TH_SKH], ints[I_TH_SKW], ints[I_TH_PT], ints[I_TH_PL]))
    return false;
  c.g = make_geo(ints);
  c.L = ints[I_L];
  c.CD = ints[I_CD];
  c.F = ints[I_F];
  if (c.L < 1 || c.L > kMaxLevels || c.g.R < 1 || c.CD < 1 || !width_built(c.F) ||
      ints[I_BF] != (kBF16 ? 1 : 0))
    return false;
  c.tv = make_taps(ints[I_TV_SKH], ints[I_TV_SKW], ints[I_TV_PT], ints[I_TV_PL]);
  c.th = make_taps(ints[I_TH_SKH], ints[I_TH_SKW], ints[I_TH_PT], ints[I_TH_PL]);
  c.base = ints[I_BASE];
  c.drop = ints[I_DROP] != 0;
  c.round_carry = false;
  c.seed = (uint32_t)ints[I_SEED];
  c.thresh = (uint32_t)ints[I_THRESH];
  c.inv_keep = inv_keep;
  return true;
}

// Level-major pointer lists (the pair's and segment's entry points): `lv[l]`
// takes the `n` pointers after `head` of level l.
template <int N>
inline void unpack_levels(const void* const* ptrs, int head, int L, Level<N>* lv) {
  for (int l = 0; l < L; ++l)
    for (int i = 0; i < N; ++i) lv[l].p[i] = ptrs[head + l * N + i];
}

// ---- kernels -------------------------------------------------------------

// proj[l][s][b][c] = sum_k cond[b][k] * wc_s,l[k][c] (s = 0 vertical,
// 1 horizontal; cond rounded to the compute dtype); one thread per
// (l, s, b, c).
template <int F>
__global__ void proj_kernel(const float* __restrict__ cond, const PerLevelC wcv,
                            const PerLevelC wch, float* __restrict__ proj, int B, int CD) {
  constexpr int N = 2 * F;
  const int c = threadIdx.x, b = blockIdx.x, s = blockIdx.y, l = blockIdx.z;
  const cdt* wc = s == 0 ? wcv.p[l] : wch.p[l];
  float acc = 0.f;
  for (int k = 0; k < CD; ++k)
    acc = fmaf(round_c(cond[(size_t)b * CD + k]), to_f(wc[(size_t)k * N + c]), acc);
  proj[(((size_t)l * 2 + s) * B + b) * N + c] = acc;
}

// The gate's derivative: g = carry + ext (either may be null),
// db1 = [g * sg, g * act * sg * (1 - sg)] with act, gate = b1[:F], b1[F:].
template <int F>
__global__ void gate_bwd(const float* __restrict__ carry, const cdt* __restrict__ ext,
                         const cdt* __restrict__ b1, float* __restrict__ gtot,
                         float* __restrict__ db1, int R) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)R * F) return;
  const size_t r = idx / F, j = idx % F;
  float g = 0.f;
  if (carry) g += carry[idx];
  if (ext) g += to_f(ext[idx]);
  if (gtot) gtot[idx] = g;
  const float act = to_f(b1[r * 2 * F + j]), gate = to_f(b1[r * 2 * F + F + j]);
  const float sg = sigmoid(gate);
  db1[r * 2 * F + j] = g * sg;
  db1[r * 2 * F + F + j] = g * act * sg * (1.f - sg);
}

// The row splits of one weight kind's reduction over R rows when its grid
// has `blocks` blocks a split: S splits of `rows` rows (a multiple of
// kSplitAlign, the last one shorter), S = 1 where the grid is already large.
struct Split {
  int S, rows;
};
inline Split wgrad_split(int R, int blocks) {
  int S = (kWgradBlocks + blocks - 1) / blocks;
  S = S < R / kMinSplitRows ? S : R / kMinSplitRows;
  if (S <= 1) return Split{1, R};
  int rows = (R + S - 1) / S;
  rows = (rows + kSplitAlign - 1) / kSplitAlign * kSplitAlign;
  return Split{(R + rows - 1) / rows, rows};
}

// dW_l[t * 2C + i][n] = sum_r A_l(r + shift_t, i) * G_l[r][n], where A_l is
// concat_elu of level l's source (times the dropout mask / keep with
// `drop`). Block (i-tile, tap, level * S + s) sums the rows of split s:
// straight into dW_l when S == 1, else into part[l][s] ([taps.n * 2C, N]
// each), which reduce_splits adds up.
struct WgArgs {
  PerLevelC src;    // level l's source [R, C]
  PerLevelOut out;  // level l's gradient [taps.n * 2C, N]
  const float* g;   // [L, R, N]
  float* part;      // [L, S, taps.n * 2C, N] when S > 1
  int C, drop, S, rows;
  Taps taps;
  Geo geo;
  uint32_t seed, thresh;
  int base, sub;
  float inv_keep;
};

template <int N>
__global__ void __launch_bounds__(kThreads, 1) wgrad(const __grid_constant__ WgArgs p) {
  constexpr int NT = n_tiles<N>();
  // a thread gathers channels i .. i + 3 of kWR rows, kWStep apart; a warp
  // takes 8 consecutive rows of 4 channel quads, so its stores spread over
  // the banks
  constexpr int kWStep = kThreads / (kBM / 4), kWR = kKC / kWStep;
  static_assert(kThreads / 32 == kBM / 16 * 4, "warps: 4 row groups x kBM / 16 quad groups");
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;
  float* sB = smem + 4 * kAPlane;
  const Geo g = p.geo;
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kBM, t = blockIdx.y;
  const int l = blockIdx.z / p.S, sp = blockIdx.z % p.S;
  const int rbeg = sp * p.rows, rend = min(g.R, rbeg + p.rows);
  const cdt* src = p.src.p[l];
  const float* gl = p.g + (size_t)l * g.R * N;
  const uint32_t key = stream_key(p.seed, (uint32_t)(2 * (p.base + l) + p.sub));
  const int dy = p.taps.dy[t], dx = p.taps.dx[t];
  // (a block's 64 channels lie in one half of concat_elu: C % 64 == 0)
  const int q = tid / 128 * 4 + tid % 32 / 8, rr = tid / 32 % 4 * 8 + tid % 8;
  const int i = i0 + 4 * q;
  const bool neg = i0 >= p.C;
  const int ch = neg ? i - p.C : i;
  Acc<N> acc;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][u][e] = 0.f;

  float va[kWR][4];
  uint32_t spos[kWR], kimg[kWR];
  bool ok[kWR];
  auto load_a = [&](int k0) {
#pragma unroll
    for (int h = 0; h < kWR; ++h) {
      const int r = k0 + rr + kWStep * h;
      const int b = r / g.HW, pos = r % g.HW;
      const int yy = pos / g.W + dy, xx = pos % g.W + dx;
      ok[h] = r < rend && yy >= 0 && yy < g.H && xx >= 0 && xx < g.W;
      spos[h] = (uint32_t)(yy * g.W + xx);
      kimg[h] = mix32(key ^ (uint32_t)b);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok[h]) {
        const size_t at = (size_t)(r + dy * g.W + dx) * p.C + ch;
        if constexpr (kBF16) {
          const uint2 x = __ldg(reinterpret_cast<const uint2*>(src + at));
          v = make_float4(__uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u),
                          __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xffff0000u));
        } else {
          v = __ldg(reinterpret_cast<const float4*>(src + at));
        }
      }
      va[h][0] = v.x;
      va[h][1] = v.y;
      va[h][2] = v.z;
      va[h][3] = v.w;
    }
  };
  auto store_a = [&](int s) {
#pragma unroll
    for (int h = 0; h < kWR; ++h) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = 0.f;
        if (ok[h]) {
          v[j] = elu(neg ? -va[h][j] : va[h][j]);
          if (p.drop)
            v[j] = kept(kimg[h], spos[h] * (uint32_t)(2 * p.C) + i + j, p.thresh)
                       ? v[j] * p.inv_keep
                       : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (kBF16) {
          // one bf16 value a channel: the row is the K axis here
          reinterpret_cast<uint16_t*>(sA)[s * kAPlane + frag16_at(4 * q + j, rr + kWStep * h)] =
              static_cast<uint16_t>(pack_bf16(v[j], 0.f) & 0xffffu);
        } else {
          const float2 w = split_tf32(v[j]);
          const int at = frag_at(4 * q + j, rr + kWStep * h);
          sA[s * 2 * kAPlane + at] = w.x;
          sA[s * 2 * kAPlane + kAPlane + at] = w.y;
        }
      }
    }
  };
  // cotangent rows k0 .. k0 + kKC into B stage `s`, zeros past rend
  auto stage_b = [&](int k0, int s) {
    if (k0 < rend) {
      float* dst = sB + s * b_stage<N>();
      constexpr int P = N / 4, STEP = kThreads / P;
      const int kr = tid / P, c4 = tid % P;
      uint32_t d = smem_u32(dst + kr * (N + 8) + 4 * c4);
#pragma unroll
      for (int j = 0; j < kKC / STEP; ++j, d += STEP * (N + 8) * 4) {
        const int r = k0 + kr + j * STEP;
        cp_async16(d, r < rend ? gl + (size_t)r * N + 4 * c4 : gl, r < rend ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  const int nc = (rend - rbeg + kKC - 1) / kKC;
  for (int s = 0; s < kStages - 1; ++s) stage_b(rbeg + s * kKC, s);
  load_a(rbeg);
  store_a(0);
  for (int c = 0; c < nc; ++c) {
    const int k0 = rbeg + c * kKC;
    cp_async_wait_ring<kStages>();
    __syncthreads();
    stage_b(k0 + (kStages - 1) * kKC, (c + kStages - 1) % kStages);
    const bool more = c + 1 < nc;
    if (more) load_a(k0 + kKC);
    if constexpr (kBF16)
      mma_chunk_bf<N, N + 8, 1>(acc, reinterpret_cast<const uint16_t*>(sA) + (c % 2) * kAPlane,
                                sB + c % kStages * b_stage<N>());
    else
      mma_chunk<N, N + 8, 1>(acc, sA + (c % 2) * 2 * kAPlane,
                             sB + c % kStages * b_stage<N>());
    if (more) store_a((c + 1) % 2);
  }

  const size_t per = (size_t)p.taps.n * 2 * p.C * N;  // one level's dW
  float* out = (p.S == 1 ? p.out.p[l] : p.part + ((size_t)l * p.S + sp) * per) +
               (size_t)t * 2 * p.C * N;
  const int lane = tid % 32, t2 = 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = i0 + tile_m0(mt) + lane / 4 + 8 * hh;
#pragma unroll
      for (int u = 0; u < NT; ++u)
        *reinterpret_cast<float2*>(out + (size_t)row * N + tile_n0<N>(u) + t2) =
            make_float2(acc[mt][u][2 * hh], acc[mt][u][2 * hh + 1]);
    }
}

// out_l[j] = sum_s part[l][s][j], in the order of s, for the n entries j of
// a level's dW; one thread per (l, j).
__global__ void reduce_splits(const float* __restrict__ part, const PerLevelOut out, int L,
                              int S, size_t n) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)L * n) return;
  const size_t l = idx / n, j = idx % n;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += part[(l * S + s) * n + j];
  out.p[l][j] = acc;
}

// out[lb][c] = sum over the image's positions of x[lb][pos][c]
// (lb = level * B + image); block lb, thread c.
__global__ void rowsum_images(const float* __restrict__ x, float* __restrict__ out,
                              int HW, int N) {
  const int c = threadIdx.x;
  const float* xb = x + (size_t)blockIdx.x * HW * N;
  float acc = 0.f;
  for (int pos = 0; pos < HW; ++pos) acc += xb[(size_t)pos * N + c];
  out[(size_t)blockIdx.x * N + c] = acc;
}

// out_l[c] = sum_b x[l][b][c]; block l, thread c.
__global__ void sum_images(const float* __restrict__ x, const PerLevelOut out, int B, int N) {
  const int c = threadIdx.x, l = blockIdx.x;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += x[((size_t)l * B + b) * N + c];
  out.p[l][c] = acc;
}

// dwc_l[k][c] = sum_b cond[b][k] * rs[l][b][c] (both rounded to the
// compute dtype); block (k, l), thread c.
template <int F>
__global__ void dwc_kernel(const float* __restrict__ cond, const float* __restrict__ rs,
                           const PerLevelOut dwc, int B, int CD) {
  constexpr int N = 2 * F;
  const int c = threadIdx.x, k = blockIdx.x, l = blockIdx.y;
  float acc = 0.f;
  for (int b = 0; b < B; ++b)
    acc = fmaf(round_c(cond[(size_t)b * CD + k]), round_c(rs[((size_t)l * B + b) * N + c]),
               acc);
  dwc.p[l][(size_t)k * N + c] = acc;
}

// dcond[b][k] = sum_l (rsv[l][b] . wcv_l[k] + rsh[l][b] . wch_l[k]) (the
// row sums rounded to the compute dtype); one warp per (b, k).
template <int F>
__global__ void dcond_kernel(const float* __restrict__ rsv, const PerLevelC wcv,
                             const float* __restrict__ rsh, const PerLevelC wch,
                             float* __restrict__ dcond, int L, int B, int CD) {
  constexpr int N = 2 * F;
  const int wid = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (wid >= B * CD) return;
  const int b = wid / CD, k = wid % CD;
  float acc = 0.f;
  for (int l = 0; l < L; ++l) {
    const float* v = rsv + ((size_t)l * B + b) * N;
    const float* h = rsh + ((size_t)l * B + b) * N;
    const cdt* wv = wcv.p[l] + (size_t)k * N;
    const cdt* wh = wch.p[l] + (size_t)k * N;
    for (int c = lane; c < N; c += 32)
      acc += round_c(v[c]) * to_f(wv[c]) + round_c(h[c]) * to_f(wh[c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dcond[(size_t)b * CD + k] = acc;
}

// The split of chain c's weight kind of `taps` taps.
inline Split wgrad_split(const Chain& c, int taps) {
  return wgrad_split(c.g.R, (2 * c.F / kBM) * taps * c.L);
}

// The row splits of chain c's weight kinds: the vertical convs', the
// horizontal convs', the aux products'.
inline void wgrad_splits(const Chain& c, int* splits) {
  const int taps[3] = {c.tv.n, c.th.n, 1};
  for (int i = 0; i < 3; ++i) splits[i] = wgrad_split(c, taps[i]).S;
}

// Floats of the partial sums the backward of chain `c` needs: the largest
// kind's, each counted at N = 2F (the kinds run one after another on one
// stream and share them).
inline long long wgrad_part_floats(const Chain& c) {
  const int taps[3] = {c.tv.n, c.th.n, 1};
  int splits[3];
  wgrad_splits(c, splits);
  long long most = 0;
  for (int i = 0; i < 3; ++i) {
    const long long n = splits[i] == 1 ? 0 : (long long)c.L * splits[i] * taps[i] * 4 * c.F * c.F;
    most = n > most ? n : most;
  }
  return most;
}

// ---- launches --------------------------------------------------------------

// Launches data_gemm over all rows on `stream`. The shared-memory limit is
// set at every launch, not once behind a function-local static: such a
// static is one object across every loaded library that includes this
// header, and each library's kernel needs its own setting. A refusal shows
// as the launch's error.
template <int N>
inline void launch_data_gemm(const DataArgs& a, cudaStream_t stream) {
  cudaFuncSetAttribute(data_gemm<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_bytes<N>());
  data_gemm<N><<<(a.g.R + kBM - 1) / kBM, kThreads, smem_bytes<N>(), stream>>>(a);
}

// Launches wgrad over `grid` on `stream`.
template <int N>
inline void launch_wgrad(const WgArgs& a, dim3 grid, cudaStream_t stream) {
  cudaFuncSetAttribute(wgrad<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<N>());
  wgrad<N><<<grid, kThreads, smem_bytes<N>(), stream>>>(a);
}

// ---- the forward -----------------------------------------------------------

// The L levels of `lv` from the chain inputs (level l's inputs are level
// l - 1's outputs) at c.F == F filters: each level's outputs and saves,
// through `proj` ([L, 2, B, 2F] scratch). Returns cudaGetLastError() after
// the launches.
template <int F>
inline int levels_fwd(const Chain& c, const cdt* xv0, const cdt* xh0, const float* cond,
                      const LevelFwd* lv, float* proj, cudaStream_t stream) {
  const Geo g = c.g;
  const bool down = lv[0].p[LF_SKV] != nullptr;
  PerLevelC wcv{}, wch{};
  for (int l = 0; l < c.L; ++l) {
    wcv.p[l] = lv[l].act(LF_WCV);
    wch.p[l] = lv[l].act(LF_WCH);
  }
  proj_kernel<F><<<dim3(g.B, 2, c.L), 2 * F, 0, stream>>>(cond, wcv, wch, proj, g.B, c.CD);

  const int bmode = c.drop ? A_CELU_DROP : A_CELU;
  for (int l = 0; l < c.L; ++l) {
    const LevelFwd& v = lv[l];
    const cdt* xv_in = l ? lv[l - 1].act(LF_XVO) : xv0;
    const cdt* xh_in = l ? lv[l - 1].act(LF_XHO) : xh0;
    for (int sub = 0; sub < 2; ++sub) {
      const bool vert = sub == 0;
      const Taps& tp = vert ? c.tv : c.th;
      const cdt* x_in = vert ? xv_in : xh_in;
      cdt* a1 = v.act_out(vert ? LF_A1V : LF_A1H);
      // conv_a (+ aux) + ba
      DataArgs a{};
      a.g = g;
      a.epi = E_BIAS;
      add_tap_terms(a, tp, 1, x_in, F, A_CELU, v.act(vert ? LF_WAV : LF_WAH),
                    (size_t)2 * F * F, F, 0);
      if (!vert) a.t[a.nt++] = Term{v.act(LF_XVO), v.act(LF_WXHU), F, 2 * F, A_CELU, 0, 0, F, 0};
      if (down)
        a.t[a.nt++] = Term{v.act(vert ? LF_SKV : LF_SKH), v.act(vert ? LF_WXV : LF_WXHS), F,
                           2 * F, A_CELU, 0, 0, F, 0};
      a.bias = v.in(vert ? LF_BAV : LF_BAH);
      a.outc = a1;
      launch_data_gemm<F>(a, stream);
      // conv_b(dropout(concat_elu(a1))) + bb + proj, gate, residual
      DataArgs b{};
      b.g = g;
      b.epi = E_GATE;
      b.key = stream_key(c.seed, (uint32_t)(2 * (c.base + l) + sub));
      b.thresh = c.thresh;
      b.inv_keep = c.inv_keep;
      b.drop = c.drop;
      add_tap_terms(b, tp, 1, a1, F, bmode, v.act(vert ? LF_WBV : LF_WBH), (size_t)4 * F * F,
                    2 * F, 0);
      b.bias = v.in(vert ? LF_BBV : LF_BBH);
      b.proj = proj + ((size_t)l * 2 + sub) * g.B * 2 * F;
      b.xres = x_in;
      b.outc = v.act_out(vert ? LF_B1V : LF_B1H);
      b.out2 = v.act_out(vert ? LF_XVO : LF_XHO);
      launch_data_gemm<2 * F>(b, stream);
    }
  }
  return (int)cudaGetLastError();
}

// ---- the backward ----------------------------------------------------------

// The backward's pass-wide tensors: the chain inputs and cond, their
// cotangents (out), and scratch.
struct BwdPass {
  const cdt *xv0, *xh0;
  const float* cond;
  cdt *dxv0, *dxh0;
  float* dcond;
  float *db1v, *db1h;  // [L, R, 2F]
  float *da1v, *da1h;  // [L, R, F]
  float *gtot, *gvtot; // [R, F]
  float *rsv, *rsh;    // [L, B, 2F]
  float *rav, *rah;    // [L, B, F]
  float* part;         // wgrad_part_floats(c) floats
  float *cv, *ch;      // [R, F]: the carries, the cotangents of level l's inputs (l > 0)
};

// The VJP of the L levels of `lv` at c.F == F filters. Returns
// cudaGetLastError() after the launches.
template <int F>
inline int levels_bwd(const Chain& c, const BwdPass& s, const LevelBwd* lv,
                      cudaStream_t stream) {
  const Geo g = c.g;
  const int L = c.L;
  const bool down = lv[0].p[LB_SKV] != nullptr;
  const size_t RF = (size_t)g.R * F;
  const int ew_blocks = (int)((RF + kThreads - 1) / kThreads);
  // the carries; level 0 writes the chain inputs' cotangents instead
  float* dv = s.cv;
  float* dh = s.ch;
  auto input = [&](int l, bool vert) {
    return l ? lv[l - 1].act(vert ? LB_XVO : LB_XHO) : (vert ? s.xv0 : s.xh0);
  };

  for (int l = L - 1; l >= 0; --l) {
    const LevelBwd& v = lv[l];
    const bool top = l == L - 1;
    for (int sub = 1; sub >= 0; --sub) {  // horizontal block first
      const bool vert = sub == 0;
      const Taps& tp = vert ? c.tv : c.th;
      float* db1 = (vert ? s.db1v : s.db1h) + 2 * l * RF;
      float* da1 = (vert ? s.da1v : s.da1h) + l * RF;
      // g = dv + gv_ext + daux_h for the vertical block (in gvtot), the
      // carry plus the level's external cotangent for the horizontal one
      if (vert)
        gate_bwd<F><<<ew_blocks, kThreads, 0, stream>>>(s.gvtot, nullptr, v.act(LB_B1V), nullptr,
                                                     db1, g.R);
      else
        gate_bwd<F><<<ew_blocks, kThreads, 0, stream>>>(top ? nullptr : dh, v.act(LB_GH),
                                                     v.act(LB_B1H), s.gtot, db1, g.R);
      // da1 = concat_elu'(a1) (conv_b^T(db1) * mask / keep)
      DataArgs d{};
      d.g = g;
      d.epi = E_CELU_BWD;
      d.key = stream_key(c.seed, (uint32_t)(2 * (c.base + l) + sub));
      d.thresh = c.thresh;
      d.inv_keep = c.inv_keep;
      d.drop = c.drop;
      add_tap_terms(d, tp, -1, db1, 2 * F, A_IDENT, v.act(vert ? LB_WBV : LB_WBH),
                    (size_t)4 * F * F, 2 * F, 1);
      d.z = v.act(vert ? LB_A1V : LB_A1H);
      d.out = da1;
      launch_data_gemm<2 * F>(d, stream);
      // the aux cotangents: dv + gv_ext + concat_elu'(xv') (da1h Wxh_u^T),
      // and the skips'
      // (into float32 `out`, or `outc` of the compute dtype)
      auto aux_bwd = [&](const cdt* w, const cdt* z, const float* base1, const cdt* base2,
                         float* out, cdt* outc) {
        DataArgs x{};
        x.g = g;
        x.epi = E_CELU_BWD;
        x.t[x.nt++] = Term{da1, w, F, F, A_IDENT, 0, 0, F, 1};
        x.z = z;
        x.base1 = base1;
        x.base2 = base2;
        x.out = out;
        x.outc = outc;
        launch_data_gemm<2 * F>(x, stream);
      };
      if (!vert)
        aux_bwd(v.act(LB_WXHU), v.act(LB_XVO), top ? nullptr : dv, v.act(LB_GV), s.gvtot,
                nullptr);
      if (down)
        aux_bwd(v.act(vert ? LB_WXV : LB_WXHS), v.act(vert ? LB_SKV : LB_SKH), nullptr, nullptr,
                nullptr, v.act_out(vert ? LB_DSKV : LB_DSKH));
      // the block input's cotangent: g + concat_elu'(x) (conv_a^T(da1)), a
      // carry (rounded with round_carry) or, at level 0, the chain input's
      DataArgs x{};
      x.g = g;
      x.epi = E_CELU_BWD;
      add_tap_terms(x, tp, -1, da1, F, A_IDENT, v.act(vert ? LB_WAV : LB_WAH), (size_t)2 * F * F,
                    F, 1);
      x.z = input(l, vert);
      x.base1 = vert ? s.gvtot : s.gtot;
      if (l) {
        x.out = vert ? dv : dh;
        x.round = c.round_carry;
      } else {
        x.outc = vert ? s.dxv0 : s.dxh0;
      }
      launch_data_gemm<2 * F>(x, stream);
    }
  }

  // weight gradients of every level: `src(l)` is level l's source rows
  auto wg = [&](auto src, bool drp, const Taps& taps, int sub, const float* gcot, int dst,
                bool wide) {
    WgArgs a{};
    for (int l = 0; l < L; ++l) {
      a.src.p[l] = src(l);
      a.out.p[l] = lv[l].out(dst);
    }
    a.C = F;
    a.drop = drp;
    a.taps = taps;
    a.g = gcot;
    a.geo = g;
    a.seed = c.seed;
    a.thresh = c.thresh;
    a.base = c.base;
    a.sub = sub;
    a.inv_keep = c.inv_keep;
    const Split sp = wgrad_split(c, taps.n);
    a.S = sp.S;
    a.rows = sp.rows;
    a.part = s.part;
    const dim3 grid(2 * F / kBM, taps.n, L * sp.S);
    if (wide)
      launch_wgrad<2 * F>(a, grid, stream);
    else
      launch_wgrad<F>(a, grid, stream);
    if (sp.S > 1) {
      const size_t n = (size_t)taps.n * 2 * F * (wide ? 2 * F : F);
      reduce_splits<<<(unsigned)((L * n + 255) / 256), 256, 0, stream>>>(s.part, a.out, L,
                                                                          sp.S, n);
    }
  };
  auto of = [&](int i) { return [&lv, i](int l) { return lv[l].act(i); }; };
  const Taps one = make_taps(1, 1, 0, 0);
  wg([&](int l) { return input(l, true); }, false, c.tv, 0, s.da1v, LB_DWAV, false);
  wg(of(LB_A1V), c.drop, c.tv, 0, s.db1v, LB_DWBV, true);
  wg([&](int l) { return input(l, false); }, false, c.th, 1, s.da1h, LB_DWAH, false);
  wg(of(LB_A1H), c.drop, c.th, 1, s.db1h, LB_DWBH, true);
  wg(of(LB_XVO), false, one, 1, s.da1h, LB_DWXHU, false);
  if (down) {
    wg(of(LB_SKV), false, one, 0, s.da1v, LB_DWXV, false);
    wg(of(LB_SKH), false, one, 1, s.da1h, LB_DWXHS, false);
  }

  // bias and cond gradients
  PerLevelOut dbbv{}, dbbh{}, dbav{}, dbah{}, dwcv{}, dwch{};
  PerLevelC wcv{}, wch{};
  for (int l = 0; l < L; ++l) {
    dbbv.p[l] = lv[l].out(LB_DBBV);
    dbbh.p[l] = lv[l].out(LB_DBBH);
    dbav.p[l] = lv[l].out(LB_DBAV);
    dbah.p[l] = lv[l].out(LB_DBAH);
    dwcv.p[l] = lv[l].out(LB_DWCV);
    dwch.p[l] = lv[l].out(LB_DWCH);
    wcv.p[l] = lv[l].act(LB_WCV);
    wch.p[l] = lv[l].act(LB_WCH);
  }
  const int LB = L * g.B;
  rowsum_images<<<LB, 2 * F, 0, stream>>>(s.db1v, s.rsv, g.HW, 2 * F);
  rowsum_images<<<LB, 2 * F, 0, stream>>>(s.db1h, s.rsh, g.HW, 2 * F);
  rowsum_images<<<LB, F, 0, stream>>>(s.da1v, s.rav, g.HW, F);
  rowsum_images<<<LB, F, 0, stream>>>(s.da1h, s.rah, g.HW, F);
  sum_images<<<L, 2 * F, 0, stream>>>(s.rsv, dbbv, g.B, 2 * F);
  sum_images<<<L, 2 * F, 0, stream>>>(s.rsh, dbbh, g.B, 2 * F);
  sum_images<<<L, F, 0, stream>>>(s.rav, dbav, g.B, F);
  sum_images<<<L, F, 0, stream>>>(s.rah, dbah, g.B, F);
  dwc_kernel<F><<<dim3(c.CD, L), 2 * F, 0, stream>>>(s.cond, s.rsv, dwcv, g.B, c.CD);
  dwc_kernel<F><<<dim3(c.CD, L), 2 * F, 0, stream>>>(s.cond, s.rsh, dwch, g.B, c.CD);
  dcond_kernel<F><<<(g.B * c.CD + 7) / 8, 256, 0, stream>>>(s.rsv, wcv, s.rsh, wch, s.dcond, L,
                                                         g.B, c.CD);
  return (int)cudaGetLastError();
}

}  // namespace gsk
