// Forward of one pass (up or down) of the PixelCNN's gated resnet chain.
//
// Replaces posterior_matching_tpu/ops/gated_chain.py::
// _stream_fwd_kernel_factory (Pallas, grid (level, batch chunk), pallas_call
// at :1595). Per level: the vertical gated block, then the horizontal one
// with the new vertical (and on down levels the skips) as aux:
//   a1 = conv_a(concat_elu(x)) + sum concat_elu(aux) @ Wx + ba,
//   d  = concat_elu(a1) * mask / keep,
//   b1 = conv_b(d) + bb + cond @ Wc,   x' = x + sigmoid(b1[F:]) * b1[:F].
// Saves for the backward: every level's x' (the next level's input), a1 and
// b1 of both blocks.
//
// Bound: operations. At the flagship shapes (B*H*W = 32*16*16 = 8192 rows,
// F = 128, L = 12, 2x3 vertical and 2x2 horizontal taps) a level is 2.03
// MFLOP per row on the up pass and 2.16 on the down pass: 200 + 213 GFLOP of
// float32 FMAs per training step (6.2 ms at 67 TFLOP/s) against ~0.4 GB of
// saves written per pass (0.12 ms at 3.35 TB/s).
//
// Design. The Pallas kernel walks (level, chunk) in order and carries the
// stacks in VMEM. On Hopper blocks run in parallel and unordered, and one
// block per image would fill 32 of 132 SMs, so each dependent phase is its
// own launch over all 8192 rows: per level conv_a then conv_b of the
// vertical block, then of the horizontal block (4 launches per level, after
// one launch for every level's cond projection). Each is data_gemm
// (gated_common.cuh): 256 blocks of 32 rows x all output columns, the
// shifted taps, concat_elu and the in-kernel dropout hash fused into the A
// operand's load, biases, cond projection, gate and residual in the
// epilogue. The carries are the saved level outputs in global memory.
// Float32 FMAs without tensor cores: fast kernels (wgmma, TMA, bf16) are
// later work.
#include "gated_common.cuh"

namespace {

using namespace gsk;

enum FwdPtr {
  XV0, XH0, SKV, SKH, COND,
  WAV, BAV, WBV, BBV, WCV, WXV, WAH, BAH, WBH, BBH, WCH, WXHU, WXHS,
  XVO, XHO, A1V, A1H, B1V, B1H, PROJ, FWD_NPTR
};

// proj[l][s][b][c] = sum_k cond[b][k] * wc_s[l][k][c] (s = 0 vertical,
// 1 horizontal); one thread per (l, s, b, c).
__global__ void proj_kernel(const float* __restrict__ cond,
                            const float* __restrict__ wcv,
                            const float* __restrict__ wch,
                            float* __restrict__ proj, int B, int CD) {
  constexpr int N = 2 * kF;
  const int c = threadIdx.x, b = blockIdx.x, s = blockIdx.y, l = blockIdx.z;
  const float* wc = (s == 0 ? wcv : wch) + (size_t)l * CD * N;
  float acc = 0.f;
  for (int k = 0; k < CD; ++k) acc = fmaf(cond[(size_t)b * CD + k], wc[(size_t)k * N + c], acc);
  proj[(((size_t)l * 2 + s) * B + b) * N + c] = acc;
}

}  // namespace

// One pass. `ptrs` holds FWD_NPTR device pointers in the order of
// ops/gated_chain.py::_FWD_PTRS (skv, skh, wxv, wxh_s null on the up pass),
// `ints` the geometry of _GEOMETRY. Returns cudaGetLastError() after the
// launches.
extern "C" int pm_gated_stream_fwd(const void* const* ptrs, int nptrs,
                                   const int* ints, int nints, float inv_keep,
                                   void* stream_) {
  if (nptrs != FWD_NPTR || nints != I_COUNT) return (int)cudaErrorInvalidValue;
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
  float* proj = out(PROJ);

  proj_kernel<<<dim3(g.B, 2, L), 2 * F, 0, stream>>>(in(COND), in(WCV), in(WCH), proj, g.B, CD);

  for (int l = 0; l < L; ++l) {
    const float* xv_in = l ? in(XVO) + (l - 1) * RF : in(XV0);
    const float* xh_in = l ? in(XHO) + (l - 1) * RF : in(XH0);
    float* xvo = out(XVO) + l * RF;
    float* xho = out(XHO) + l * RF;
    float* a1v = out(A1V) + l * RF;
    float* a1h = out(A1H) + l * RF;
    float* b1v = out(B1V) + 2 * l * RF;
    float* b1h = out(B1H) + 2 * l * RF;
    const int bmode = drop ? A_CELU_DROP : A_CELU;
    for (int sub = 0; sub < 2; ++sub) {
      const bool vert = sub == 0;
      const Taps& tp = vert ? tv : th;
      const float* x_in = vert ? xv_in : xh_in;
      float* a1 = vert ? a1v : a1h;
      // conv_a (+ aux) + ba
      DataArgs a{};
      a.g = g;
      a.epi = E_BIAS;
      add_tap_terms(a, tp, 1, x_in, F, A_CELU, in(vert ? WAV : WAH) + (size_t)l * tp.n * 2 * F * F,
                    (size_t)2 * F * F, F, 0);
      if (!vert)
        a.t[a.nt++] = Term{xvo, in(WXHU) + (size_t)l * 2 * F * F, F, 2 * F, A_CELU, 0, 0, F, 0};
      if (down)
        a.t[a.nt++] = Term{(vert ? in(SKV) : in(SKH)) + l * RF,
                           in(vert ? WXV : WXHS) + (size_t)l * 2 * F * F, F, 2 * F, A_CELU, 0, 0, F, 0};
      a.bias = in(vert ? BAV : BAH) + (size_t)l * F;
      a.out = a1;
      launch_data_gemm<F>(a, stream);
      // conv_b(dropout(concat_elu(a1))) + bb + proj, gate, residual
      DataArgs b{};
      b.g = g;
      b.epi = E_GATE;
      b.key = stream_key(seed, (uint32_t)(2 * (base + l) + sub));
      b.thresh = thresh;
      b.inv_keep = inv_keep;
      b.drop = drop;
      add_tap_terms(b, tp, 1, a1, F, bmode, in(vert ? WBV : WBH) + (size_t)l * tp.n * 2 * F * 2 * F,
                    (size_t)4 * F * F, 2 * F, 0);
      b.bias = in(vert ? BBV : BBH) + (size_t)l * 2 * F;
      b.proj = proj + ((size_t)l * 2 + sub) * g.B * 2 * F;
      b.xres = x_in;
      b.out = vert ? b1v : b1h;
      b.out2 = vert ? xvo : xho;
      launch_data_gemm<2 * F>(b, stream);
    }
  }
  return (int)cudaGetLastError();
}
