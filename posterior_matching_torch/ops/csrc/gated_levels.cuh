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
// (wgrad: one block per (32 input rows, tap, level) reducing over all rows),
// the bias and cond gradients as small reductions. No atomics: each output
// is summed by one thread in a fixed order, so equal inputs give equal
// gradients on every run.
#pragma once

#include "gated_common.cuh"

namespace gsk {

constexpr int kMaxLevels = 32;  // ops/gated_chain.py MAX_LEVELS

// Per-level pointers passed by value in a kernel's parameters.
struct PerLevel {
  const float* p[kMaxLevels];
};
struct PerLevelOut {
  float* p[kMaxLevels];
};

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

template <int N>
struct Level {
  const void* p[N];
  const float* in(int i) const { return static_cast<const float*>(p[i]); }
  float* out(int i) const { return static_cast<float*>(const_cast<void*>(p[i])); }
};
using LevelFwd = Level<LF_COUNT>;
using LevelBwd = Level<LB_COUNT>;

// The settings every level shares: geometry, taps, dropout.
struct Chain {
  Geo g;
  Taps tv, th;
  int L, CD, base;
  bool drop;
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
  if (c.L < 1 || c.L > kMaxLevels || c.g.R < 1 || c.CD < 1) return false;
  c.tv = make_taps(ints[I_TV_SKH], ints[I_TV_SKW], ints[I_TV_PT], ints[I_TV_PL]);
  c.th = make_taps(ints[I_TH_SKH], ints[I_TH_SKW], ints[I_TH_PT], ints[I_TH_PL]);
  c.base = ints[I_BASE];
  c.drop = ints[I_DROP] != 0;
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
// 1 horizontal); one thread per (l, s, b, c).
__global__ void proj_kernel(const float* __restrict__ cond, const PerLevel wcv,
                            const PerLevel wch, float* __restrict__ proj, int B, int CD) {
  constexpr int N = 2 * kF;
  const int c = threadIdx.x, b = blockIdx.x, s = blockIdx.y, l = blockIdx.z;
  const float* wc = s == 0 ? wcv.p[l] : wch.p[l];
  float acc = 0.f;
  for (int k = 0; k < CD; ++k) acc = fmaf(cond[(size_t)b * CD + k], wc[(size_t)k * N + c], acc);
  proj[(((size_t)l * 2 + s) * B + b) * N + c] = acc;
}

// The gate's derivative: g = carry + ext (either may be null),
// db1 = [g * sg, g * act * sg * (1 - sg)] with act, gate = b1[:F], b1[F:].
__global__ void gate_bwd(const float* __restrict__ carry, const float* __restrict__ ext,
                         const float* __restrict__ b1, float* __restrict__ gtot,
                         float* __restrict__ db1, int R) {
  constexpr int F = kF;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)R * F) return;
  const size_t r = idx / F, j = idx % F;
  float g = 0.f;
  if (carry) g += carry[idx];
  if (ext) g += ext[idx];
  if (gtot) gtot[idx] = g;
  const float act = b1[r * 2 * F + j], gate = b1[r * 2 * F + F + j];
  const float sg = sigmoid(gate);
  db1[r * 2 * F + j] = g * sg;
  db1[r * 2 * F + F + j] = g * act * sg * (1.f - sg);
}

// dW_l[t * 2C + i][n] = sum_r A_l(r + shift_t, i) * G_l[r][n], where A_l is
// concat_elu of level l's source (times the dropout mask / keep with
// `drop`). Block (i-tile, tap, level) reduces over all rows.
struct WgArgs {
  PerLevel src;     // level l's source [R, C]
  PerLevelOut out;  // level l's gradient [taps.n * 2C, N]
  const float* g;   // [L, R, N]
  int C, drop;
  Taps taps;
  Geo geo;
  uint32_t seed, thresh;
  int base, sub;
  float inv_keep;
};

template <int N>
__global__ void __launch_bounds__(kThreads) wgrad(const WgArgs p) {
  constexpr int TN = N / 32;
  __shared__ __align__(16) float sA[kKC * kLda];
  __shared__ __align__(16) float sB[kKC * N];
  const Geo g = p.geo;
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kM, t = blockIdx.y, l = blockIdx.z;
  const float* src = p.src.p[l];
  const float* gl = p.g + (size_t)l * g.R * N;
  const uint32_t key = stream_key(p.seed, (uint32_t)(2 * (p.base + l) + p.sub));
  const int dy = p.taps.dy[t], dx = p.taps.dx[t];
  const int m = tid % kM, kk0 = tid / kM;
  const int i = i0 + m;
  const bool neg = i >= p.C;
  const int ch = neg ? i - p.C : i;
  float acc[4][TN];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int u = 0; u < TN; ++u) acc[a][u] = 0.f;

  for (int k0 = 0; k0 < g.R; k0 += kKC) {
#pragma unroll
    for (int h = 0; h < kKC / (kThreads / kM); ++h) {
      const int kk = kk0 + h * (kThreads / kM);
      const int r = k0 + kk;
      float v = 0.f;
      if (r < g.R) {
        const int b = r / g.HW, pos = r % g.HW;
        const int yy = pos / g.W + dy, xx = pos % g.W + dx;
        if (yy >= 0 && yy < g.H && xx >= 0 && xx < g.W) {
          const float s = src[(size_t)(r + dy * g.W + dx) * p.C + ch];
          v = elu(neg ? -s : s);
          if (p.drop)
            v = kept(mix32(key ^ (uint32_t)b),
                     (uint32_t)(yy * g.W + xx) * (uint32_t)(2 * p.C) + i, p.thresh)
                    ? v * p.inv_keep
                    : 0.f;
        }
      }
      sA[kk * kLda + m] = v;
    }
    for (int q = tid; q < kKC * N / 4; q += kThreads) {
      const int kr = q / (N / 4), c4 = q % (N / 4);
      const int r = k0 + kr;
      reinterpret_cast<float4*>(sB)[q] =
          r < g.R ? __ldg(reinterpret_cast<const float4*>(gl + (size_t)r * N) + c4)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    mma_chunk<N>(acc, sA, sB);
    __syncthreads();
  }
  const int tr = tid / 32;
  float* out = p.out.p[l] + (size_t)t * 2 * p.C * N;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = i0 + tr * 4 + a;
#pragma unroll
    for (int u = 0; u < TN; ++u) out[(size_t)row * N + tile_col<N>(u)] = acc[a][u];
  }
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

// dwc_l[k][c] = sum_b cond[b][k] * rs[l][b][c]; block (k, l), thread c.
__global__ void dwc_kernel(const float* __restrict__ cond, const float* __restrict__ rs,
                           const PerLevelOut dwc, int B, int CD) {
  constexpr int N = 2 * kF;
  const int c = threadIdx.x, k = blockIdx.x, l = blockIdx.y;
  float acc = 0.f;
  for (int b = 0; b < B; ++b)
    acc = fmaf(cond[(size_t)b * CD + k], rs[((size_t)l * B + b) * N + c], acc);
  dwc.p[l][(size_t)k * N + c] = acc;
}

// dcond[b][k] = sum_l (rsv[l][b] . wcv_l[k] + rsh[l][b] . wch_l[k]); one
// warp per (b, k).
__global__ void dcond_kernel(const float* __restrict__ rsv, const PerLevel wcv,
                             const float* __restrict__ rsh, const PerLevel wch,
                             float* __restrict__ dcond, int L, int B, int CD) {
  constexpr int N = 2 * kF;
  const int wid = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (wid >= B * CD) return;
  const int b = wid / CD, k = wid % CD;
  float acc = 0.f;
  for (int l = 0; l < L; ++l) {
    const float* v = rsv + ((size_t)l * B + b) * N;
    const float* h = rsh + ((size_t)l * B + b) * N;
    const float* wv = wcv.p[l] + (size_t)k * N;
    const float* wh = wch.p[l] + (size_t)k * N;
    for (int c = lane; c < N; c += 32) acc += v[c] * wv[c] + h[c] * wh[c];
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dcond[(size_t)b * CD + k] = acc;
}

// ---- the forward -----------------------------------------------------------

// The L levels of `lv` from the chain inputs (level l's inputs are level
// l - 1's outputs): each level's outputs and saves, through `proj`
// ([L, 2, B, 2F] scratch). Returns cudaGetLastError() after the launches.
inline int levels_fwd(const Chain& c, const float* xv0, const float* xh0, const float* cond,
                      const LevelFwd* lv, float* proj, cudaStream_t stream) {
  constexpr int F = kF;
  const Geo g = c.g;
  const bool down = lv[0].p[LF_SKV] != nullptr;
  PerLevel wcv{}, wch{};
  for (int l = 0; l < c.L; ++l) {
    wcv.p[l] = lv[l].in(LF_WCV);
    wch.p[l] = lv[l].in(LF_WCH);
  }
  proj_kernel<<<dim3(g.B, 2, c.L), 2 * F, 0, stream>>>(cond, wcv, wch, proj, g.B, c.CD);

  const int bmode = c.drop ? A_CELU_DROP : A_CELU;
  for (int l = 0; l < c.L; ++l) {
    const LevelFwd& v = lv[l];
    const float* xv_in = l ? lv[l - 1].in(LF_XVO) : xv0;
    const float* xh_in = l ? lv[l - 1].in(LF_XHO) : xh0;
    for (int sub = 0; sub < 2; ++sub) {
      const bool vert = sub == 0;
      const Taps& tp = vert ? c.tv : c.th;
      const float* x_in = vert ? xv_in : xh_in;
      float* a1 = v.out(vert ? LF_A1V : LF_A1H);
      // conv_a (+ aux) + ba
      DataArgs a{};
      a.g = g;
      a.epi = E_BIAS;
      add_tap_terms(a, tp, 1, x_in, F, A_CELU, v.in(vert ? LF_WAV : LF_WAH),
                    (size_t)2 * F * F, F, 0);
      if (!vert) a.t[a.nt++] = Term{v.in(LF_XVO), v.in(LF_WXHU), F, 2 * F, A_CELU, 0, 0, F, 0};
      if (down)
        a.t[a.nt++] = Term{v.in(vert ? LF_SKV : LF_SKH), v.in(vert ? LF_WXV : LF_WXHS), F,
                           2 * F, A_CELU, 0, 0, F, 0};
      a.bias = v.in(vert ? LF_BAV : LF_BAH);
      a.out = a1;
      launch_data_gemm<F>(a, stream);
      // conv_b(dropout(concat_elu(a1))) + bb + proj, gate, residual
      DataArgs b{};
      b.g = g;
      b.epi = E_GATE;
      b.key = stream_key(c.seed, (uint32_t)(2 * (c.base + l) + sub));
      b.thresh = c.thresh;
      b.inv_keep = c.inv_keep;
      b.drop = c.drop;
      add_tap_terms(b, tp, 1, a1, F, bmode, v.in(vert ? LF_WBV : LF_WBH), (size_t)4 * F * F,
                    2 * F, 0);
      b.bias = v.in(vert ? LF_BBV : LF_BBH);
      b.proj = proj + ((size_t)l * 2 + sub) * g.B * 2 * F;
      b.xres = x_in;
      b.out = v.out(vert ? LF_B1V : LF_B1H);
      b.out2 = v.out(vert ? LF_XVO : LF_XHO);
      launch_data_gemm<2 * F>(b, stream);
    }
  }
  return (int)cudaGetLastError();
}

// ---- the backward ----------------------------------------------------------

// The backward's pass-wide tensors: the chain inputs and cond, their
// cotangents (out), and scratch.
struct BwdPass {
  const float *xv0, *xh0, *cond;
  float *dxv0, *dxh0, *dcond;
  float *db1v, *db1h;  // [L, R, 2F]
  float *da1v, *da1h;  // [L, R, F]
  float *gtot, *gvtot; // [R, F]
  float *rsv, *rsh;    // [L, B, 2F]
  float *rav, *rah;    // [L, B, F]
};

// The VJP of the L levels of `lv`. Returns cudaGetLastError() after the
// launches.
inline int levels_bwd(const Chain& c, const BwdPass& s, const LevelBwd* lv,
                      cudaStream_t stream) {
  constexpr int F = kF;
  const Geo g = c.g;
  const int L = c.L;
  const bool down = lv[0].p[LB_SKV] != nullptr;
  const size_t RF = (size_t)g.R * F;
  const int ew_blocks = (int)((RF + kThreads - 1) / kThreads);
  float* dv = s.dxv0;  // the carries end as the chain inputs' cotangents
  float* dh = s.dxh0;
  auto input = [&](int l, bool vert) {
    return l ? lv[l - 1].in(vert ? LB_XVO : LB_XHO) : (vert ? s.xv0 : s.xh0);
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
        gate_bwd<<<ew_blocks, kThreads, 0, stream>>>(s.gvtot, nullptr, v.in(LB_B1V), nullptr,
                                                     db1, g.R);
      else
        gate_bwd<<<ew_blocks, kThreads, 0, stream>>>(top ? nullptr : dh, v.in(LB_GH),
                                                     v.in(LB_B1H), s.gtot, db1, g.R);
      // da1 = concat_elu'(a1) (conv_b^T(db1) * mask / keep)
      DataArgs d{};
      d.g = g;
      d.epi = E_CELU_BWD;
      d.key = stream_key(c.seed, (uint32_t)(2 * (c.base + l) + sub));
      d.thresh = c.thresh;
      d.inv_keep = c.inv_keep;
      d.drop = c.drop;
      add_tap_terms(d, tp, -1, db1, 2 * F, A_IDENT, v.in(vert ? LB_WBV : LB_WBH),
                    (size_t)4 * F * F, 2 * F, 1);
      d.z = v.in(vert ? LB_A1V : LB_A1H);
      d.out = da1;
      launch_data_gemm<2 * F>(d, stream);
      // the aux cotangents: dv + gv_ext + concat_elu'(xv') (da1h Wxh_u^T),
      // and the skips'
      auto aux_bwd = [&](const float* w, const float* z, const float* base1,
                         const float* base2, float* dst) {
        DataArgs x{};
        x.g = g;
        x.epi = E_CELU_BWD;
        x.t[x.nt++] = Term{da1, w, F, F, A_IDENT, 0, 0, F, 1};
        x.z = z;
        x.base1 = base1;
        x.base2 = base2;
        x.out = dst;
        launch_data_gemm<2 * F>(x, stream);
      };
      if (!vert)
        aux_bwd(v.in(LB_WXHU), v.in(LB_XVO), top ? nullptr : dv, v.in(LB_GV), s.gvtot);
      if (down)
        aux_bwd(v.in(vert ? LB_WXV : LB_WXHS), v.in(vert ? LB_SKV : LB_SKH), nullptr, nullptr,
                v.out(vert ? LB_DSKV : LB_DSKH));
      // the block input's cotangent: g + concat_elu'(x) (conv_a^T(da1))
      DataArgs x{};
      x.g = g;
      x.epi = E_CELU_BWD;
      add_tap_terms(x, tp, -1, da1, F, A_IDENT, v.in(vert ? LB_WAV : LB_WAH), (size_t)2 * F * F,
                    F, 1);
      x.z = input(l, vert);
      x.base1 = vert ? s.gvtot : s.gtot;
      x.out = vert ? dv : dh;
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
    const dim3 grid(2 * F / kM, taps.n, L);
    if (wide)
      wgrad<2 * F><<<grid, kThreads, 0, stream>>>(a);
    else
      wgrad<F><<<grid, kThreads, 0, stream>>>(a);
  };
  auto of = [&](int i) { return [&lv, i](int l) { return lv[l].in(i); }; };
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
  PerLevel wcv{}, wch{};
  for (int l = 0; l < L; ++l) {
    dbbv.p[l] = lv[l].out(LB_DBBV);
    dbbh.p[l] = lv[l].out(LB_DBBH);
    dbav.p[l] = lv[l].out(LB_DBAV);
    dbah.p[l] = lv[l].out(LB_DBAH);
    dwcv.p[l] = lv[l].out(LB_DWCV);
    dwch.p[l] = lv[l].out(LB_DWCH);
    wcv.p[l] = lv[l].in(LB_WCV);
    wch.p[l] = lv[l].in(LB_WCH);
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
  dwc_kernel<<<dim3(c.CD, L), 2 * F, 0, stream>>>(s.cond, s.rsv, dwcv, g.B, c.CD);
  dwc_kernel<<<dim3(c.CD, L), 2 * F, 0, stream>>>(s.cond, s.rsh, dwch, g.B, c.CD);
  dcond_kernel<<<(g.B * c.CD + 7) / 8, 256, 0, stream>>>(s.rsv, wcv, s.rsh, wch, s.dcond, L,
                                                         g.B, c.CD);
  return (int)cudaGetLastError();
}

}  // namespace gsk
