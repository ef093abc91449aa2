// Backward (VJP) of one pass of the PixelCNN's gated resnet chain.
//
// Replaces posterior_matching_tpu/ops/gated_chain.py::
// _stream_bwd_kernel_factory (Pallas, grid (reversed level, batch chunk),
// pallas_call at :1660). From the forward's saves (level outputs, a1, b1 of
// both blocks) and the cotangents of every level's outputs it computes the
// cotangents of the chain inputs, of the skips and of cond, and every
// weight and bias gradient. Per level, top level first, as _block_bwd
// (:206-253): the horizontal block, then the vertical block with
// g_v = dv + daux_h (:1470-1493). The dropout masks are regenerated from the
// same hash as the forward's.
//
// Bound: operations. The VJP of a product costs two products (data and
// weight gradients), so at the flagship shapes a step's two passes are
// ~825 GFLOP of float32 FMAs (12.3 ms at 67 TFLOP/s) against ~1.5 GB read
// and written (0.45 ms at 3.35 TB/s).
//
// Design. The TPU kernel carries dv/dh through VMEM across a sequential
// grid and accumulates dW in a resident output block. On Hopper the
// data-gradient phases are launches over all 8192 rows per level, top level
// first (data_gemm: the gate's derivative as an elementwise pass, then the
// transposed conv_b with concat_elu's derivative and the mask in the
// epilogue, the aux and conv_a products the same way). They keep each
// level's db1 and da1 in scratch; the weight gradients of all levels then
// run as one launch per weight stack (wgrad: one block per
// (level, tap, 32 input rows) tile reducing over all 8192 rows), and the
// bias and cond gradients as small reductions. No atomics: each output is
// summed by one thread in a fixed order, so equal inputs give equal
// gradients on every run.
#include "gated_common.cuh"

namespace {

using namespace gsk;

enum BwdPtr {
  GV, GH, XV0, XH0, XVO, XHO, SKV, SKH, COND, A1V, A1H, B1V, B1H,
  WAV, WBV, WCV, WXV, WAH, WBH, WCH, WXHU, WXHS,
  DXV0, DXH0, DSKV, DSKH, DCOND,
  DWAV, DBAV, DWBV, DBBV, DWCV, DWXV, DWAH, DBAH, DWBH, DBBH, DWCH, DWXHU, DWXHS,
  DB1V, DB1H, DA1V, DA1H, GTOT, GVTOT, RSV, RSH, RAV, RAH, BWD_NPTR
};

// The gate's derivative: g = carry + ext (either may be null),
// db1 = [g * sg, g * act * sg * (1 - sg)] with act, gate = b1[:F], b1[F:].
__global__ void gate_bwd(const float* __restrict__ carry,
                         const float* __restrict__ ext,
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

// dW[l][t * 2C + i][n] = sum_r A_l(r + shift_t, i) * G_l[r][n], where A is
// concat_elu of the level's source (times the dropout mask / keep with
// `drop`). Block (i-tile, tap, level) reduces over all rows.
struct WgArgs {
  const float* src0;  // level 0's source when `src` holds the previous
                      // level's outputs (the level inputs), else null
  const float* src;
  int C, drop;
  Taps taps;
  const float* g;  // [L, R, N]
  float* out;      // [L, taps.n * 2C, N]
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
  const size_t RC = (size_t)g.R * p.C;
  const float* src = p.src0 ? (l ? p.src + (l - 1) * RC : p.src0) : p.src + l * RC;
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
  float* out = p.out + ((size_t)l * p.taps.n + t) * 2 * p.C * N;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = i0 + tr * 4 + a;
#pragma unroll
    for (int u = 0; u < TN; ++u) out[(size_t)row * N + tile_col<N>(u)] = acc[a][u];
  }
}

template <int N>
void launch_wgrad(const WgArgs& a, int L, cudaStream_t stream) {
  wgrad<N><<<dim3(2 * a.C / kM, a.taps.n, L), kThreads, 0, stream>>>(a);
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

// out[l][c] = sum_b x[l][b][c]; block l, thread c.
__global__ void sum_images(const float* __restrict__ x, float* __restrict__ out,
                           int B, int N) {
  const int c = threadIdx.x, l = blockIdx.x;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += x[((size_t)l * B + b) * N + c];
  out[(size_t)l * N + c] = acc;
}

// dwc[l][k][c] = sum_b cond[b][k] * rs[l][b][c]; block (k, l), thread c.
__global__ void dwc_kernel(const float* __restrict__ cond,
                           const float* __restrict__ rs, float* __restrict__ dwc,
                           int B, int CD) {
  constexpr int N = 2 * kF;
  const int c = threadIdx.x, k = blockIdx.x, l = blockIdx.y;
  float acc = 0.f;
  for (int b = 0; b < B; ++b)
    acc = fmaf(cond[(size_t)b * CD + k], rs[((size_t)l * B + b) * N + c], acc);
  dwc[((size_t)l * CD + k) * N + c] = acc;
}

// dcond[b][k] = sum_l (rsv[l][b] . wcv[l][k] + rsh[l][b] . wch[l][k]);
// one warp per (b, k).
__global__ void dcond_kernel(const float* __restrict__ rsv,
                             const float* __restrict__ wcv,
                             const float* __restrict__ rsh,
                             const float* __restrict__ wch,
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
    const float* wv = wcv + ((size_t)l * CD + k) * N;
    const float* wh = wch + ((size_t)l * CD + k) * N;
    for (int c = lane; c < N; c += 32) acc += v[c] * wv[c] + h[c] * wh[c];
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dcond[(size_t)b * CD + k] = acc;
}

}  // namespace

// The VJP of one pass. `ptrs` holds BWD_NPTR device pointers in the order
// of ops/gated_chain.py::_BWD_PTRS (the skip and skip-weight entries null
// on the up pass), `ints` the geometry of _GEOMETRY. Returns
// cudaGetLastError() after the launches.
extern "C" int pm_gated_stream_bwd(const void* const* ptrs, int nptrs,
                                   const int* ints, int nints, float inv_keep,
                                   void* stream_) {
  if (nptrs != BWD_NPTR || nints != I_COUNT) return (int)cudaErrorInvalidValue;
  auto in = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto out = [&](int i) { return static_cast<float*>(const_cast<void*>(ptrs[i])); };
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  constexpr int F = kF;
  const Geo g = make_geo(ints);
  const int L = ints[I_L], CD = ints[I_CD];
  if (!taps_ok(ints[I_TV_SKH], ints[I_TV_SKW], ints[I_TV_PT], ints[I_TV_PL]) ||
      !taps_ok(ints[I_TH_SKH], ints[I_TH_SKW], ints[I_TH_PT], ints[I_TH_PL]) ||
      L < 1 || g.R < 1 || CD < 1)
    return (int)cudaErrorInvalidValue;
  const Taps tv = make_taps(ints[I_TV_SKH], ints[I_TV_SKW], ints[I_TV_PT], ints[I_TV_PL]);
  const Taps th = make_taps(ints[I_TH_SKH], ints[I_TH_SKW], ints[I_TH_PT], ints[I_TH_PL]);
  const bool down = ptrs[SKV] != nullptr;
  const bool drop = ints[I_DROP] != 0;
  const uint32_t seed = (uint32_t)ints[I_SEED], thresh = (uint32_t)ints[I_THRESH];
  const int base = ints[I_BASE];
  const size_t RF = (size_t)g.R * F;
  const int ew_blocks = (int)((RF + kThreads - 1) / kThreads);
  float* dv = out(DXV0);  // the carries end as the chain inputs' cotangents
  float* dh = out(DXH0);

  for (int l = L - 1; l >= 0; --l) {
    const bool top = l == L - 1;
    const float* xv_in = l ? in(XVO) + (l - 1) * RF : in(XV0);
    const float* xh_in = l ? in(XHO) + (l - 1) * RF : in(XH0);
    for (int sub = 1; sub >= 0; --sub) {  // horizontal block first
      const bool vert = sub == 0;
      const Taps& tp = vert ? tv : th;
      float* db1 = out(vert ? DB1V : DB1H) + 2 * l * RF;
      float* da1 = out(vert ? DA1V : DA1H) + l * RF;
      // g = dv + gv_ext + daux_h for the vertical block (in GVTOT), the
      // carry plus the level's external cotangent for the horizontal one
      if (vert)
        gate_bwd<<<ew_blocks, kThreads, 0, stream>>>(in(GVTOT), nullptr, in(B1V) + 2 * l * RF,
                                                     nullptr, db1, g.R);
      else
        gate_bwd<<<ew_blocks, kThreads, 0, stream>>>(top ? nullptr : dh, in(GH) + l * RF,
                                                     in(B1H) + 2 * l * RF, out(GTOT), db1, g.R);
      // da1 = concat_elu'(a1) (conv_b^T(db1) * mask / keep)
      DataArgs d{};
      d.g = g;
      d.epi = E_CELU_BWD;
      d.key = stream_key(seed, (uint32_t)(2 * (base + l) + sub));
      d.thresh = thresh;
      d.inv_keep = inv_keep;
      d.drop = drop;
      add_tap_terms(d, tp, -1, db1, 2 * F, A_IDENT,
                    in(vert ? WBV : WBH) + (size_t)l * tp.n * 4 * F * F, (size_t)4 * F * F,
                    2 * F, 1);
      d.z = in(vert ? A1V : A1H) + l * RF;
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
        aux_bwd(in(WXHU) + (size_t)l * 2 * F * F, in(XVO) + l * RF, top ? nullptr : dv,
                in(GV) + l * RF, out(GVTOT));
      if (down)
        aux_bwd(in(vert ? WXV : WXHS) + (size_t)l * 2 * F * F,
                in(vert ? SKV : SKH) + l * RF, nullptr, nullptr,
                out(vert ? DSKV : DSKH) + l * RF);
      // the block input's cotangent: g + concat_elu'(x) (conv_a^T(da1))
      DataArgs x{};
      x.g = g;
      x.epi = E_CELU_BWD;
      add_tap_terms(x, tp, -1, da1, F, A_IDENT,
                    in(vert ? WAV : WAH) + (size_t)l * tp.n * 2 * F * F, (size_t)2 * F * F, F, 1);
      x.z = vert ? xv_in : xh_in;
      x.base1 = vert ? in(GVTOT) : in(GTOT);
      x.out = vert ? dv : dh;
      launch_data_gemm<2 * F>(x, stream);
    }
  }

  // weight gradients of every level
  auto wg = [&](const float* src0, const float* src, bool drp, const Taps& taps,
                int sub, const float* gcot, float* dst, bool wide) {
    WgArgs a{};
    a.src0 = src0;
    a.src = src;
    a.C = F;
    a.drop = drp;
    a.taps = taps;
    a.g = gcot;
    a.out = dst;
    a.geo = g;
    a.seed = seed;
    a.thresh = thresh;
    a.base = base;
    a.sub = sub;
    a.inv_keep = inv_keep;
    if (wide)
      launch_wgrad<2 * F>(a, L, stream);
    else
      launch_wgrad<F>(a, L, stream);
  };
  const Taps one = make_taps(1, 1, 0, 0);
  wg(in(XV0), in(XVO), false, tv, 0, in(DA1V), out(DWAV), false);
  wg(nullptr, in(A1V), drop, tv, 0, in(DB1V), out(DWBV), true);
  wg(in(XH0), in(XHO), false, th, 1, in(DA1H), out(DWAH), false);
  wg(nullptr, in(A1H), drop, th, 1, in(DB1H), out(DWBH), true);
  wg(nullptr, in(XVO), false, one, 1, in(DA1H), out(DWXHU), false);
  if (down) {
    wg(nullptr, in(SKV), false, one, 0, in(DA1V), out(DWXV), false);
    wg(nullptr, in(SKH), false, one, 1, in(DA1H), out(DWXHS), false);
  }

  // bias and cond gradients
  const int LB = L * g.B;
  rowsum_images<<<LB, 2 * F, 0, stream>>>(in(DB1V), out(RSV), g.HW, 2 * F);
  rowsum_images<<<LB, 2 * F, 0, stream>>>(in(DB1H), out(RSH), g.HW, 2 * F);
  rowsum_images<<<LB, F, 0, stream>>>(in(DA1V), out(RAV), g.HW, F);
  rowsum_images<<<LB, F, 0, stream>>>(in(DA1H), out(RAH), g.HW, F);
  sum_images<<<L, 2 * F, 0, stream>>>(in(RSV), out(DBBV), g.B, 2 * F);
  sum_images<<<L, 2 * F, 0, stream>>>(in(RSH), out(DBBH), g.B, 2 * F);
  sum_images<<<L, F, 0, stream>>>(in(RAV), out(DBAV), g.B, F);
  sum_images<<<L, F, 0, stream>>>(in(RAH), out(DBAH), g.B, F);
  dwc_kernel<<<dim3(CD, L), 2 * F, 0, stream>>>(in(COND), in(RSV), out(DWCV), g.B, CD);
  dwc_kernel<<<dim3(CD, L), 2 * F, 0, stream>>>(in(COND), in(RSH), out(DWCH), g.B, CD);
  dcond_kernel<<<(g.B * CD + 7) / 8, 256, 0, stream>>>(in(RSV), in(WCV), in(RSH), in(WCH),
                                                       out(DCOND), L, g.B, CD);
  return (int)cudaGetLastError();
}
