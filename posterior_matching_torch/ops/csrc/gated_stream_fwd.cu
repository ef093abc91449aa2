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
// F = 128, L = 12, 2x3 vertical and 2x2 horizontal taps, counting the taps
// that land inside the 16 x 16 image) a level is 1.90 MFLOP per row on the
// up pass and 2.03 on the down pass: 187 + 200 GFLOP of float32 FMAs per
// training step (5.8 ms at 67 TFLOP/s) against ~0.4 GB of saves written per
// pass (0.12 ms at 3.35 TB/s).
//
// Design. The Pallas kernel walks (level, chunk) in order and carries the
// stacks in VMEM. On Hopper blocks run in parallel and unordered, and one
// block per image would fill 32 of 132 SMs, so each dependent phase is its
// own launch over all 8192 rows: gated_levels.cuh's levels_fwd (4 launches
// per level after one for every level's cond projection; data_gemm with the
// shifted taps, concat_elu and the in-kernel dropout hash fused into the A
// operand's load, biases, cond projection, gate and residual in the
// epilogue). The stream's weights and saves are [L, ...] stacks; this entry
// point cuts them into per-level pointers. Float32 FMAs without tensor
// cores: fast kernels (wgmma, TMA, bf16) are later work.
#include "gated_levels.cuh"

namespace {

using namespace gsk;

enum FwdPtr {
  XV0, XH0, SKV, SKH, COND,
  WAV, BAV, WBV, BBV, WCV, WXV, WAH, BAH, WBH, BBH, WCH, WXHU, WXHS,
  XVO, XHO, A1V, A1H, B1V, B1H, PROJ, FWD_NPTR
};

}  // namespace

// One pass. `ptrs` holds FWD_NPTR device pointers in the order of
// ops/gated_chain.py::_FWD_PTRS (skv, skh, wxv, wxh_s null on the up pass),
// `ints` the geometry of _GEOMETRY. Returns cudaGetLastError() after the
// launches.
extern "C" int pm_gated_stream_fwd(const void* const* ptrs, int nptrs, const int* ints,
                                   int nints, float inv_keep, void* stream) {
  constexpr int F = kF;
  Chain c;
  if (nptrs != FWD_NPTR || !make_chain(ints, nints, inv_keep, c))
    return (int)cudaErrorInvalidValue;
  const size_t RF = (size_t)c.g.R * F, FF = (size_t)F * F;
  const size_t tv = c.tv.n, th = c.th.n, cd = c.CD;
  // each stack's [L, ...] level stride, in floats
  struct Cut { int from, to; size_t stride; };
  const Cut cuts[] = {
      {SKV, LF_SKV, RF}, {SKH, LF_SKH, RF},
      {WAV, LF_WAV, tv * 2 * FF}, {BAV, LF_BAV, F}, {WBV, LF_WBV, tv * 4 * FF},
      {BBV, LF_BBV, 2 * F}, {WCV, LF_WCV, cd * 2 * F}, {WXV, LF_WXV, 2 * FF},
      {WAH, LF_WAH, th * 2 * FF}, {BAH, LF_BAH, F}, {WBH, LF_WBH, th * 4 * FF},
      {BBH, LF_BBH, 2 * F}, {WCH, LF_WCH, cd * 2 * F}, {WXHU, LF_WXHU, 2 * FF},
      {WXHS, LF_WXHS, 2 * FF},
      {XVO, LF_XVO, RF}, {XHO, LF_XHO, RF}, {A1V, LF_A1V, RF}, {A1H, LF_A1H, RF},
      {B1V, LF_B1V, 2 * RF}, {B1H, LF_B1H, 2 * RF},
  };
  LevelFwd lv[kMaxLevels];
  for (int l = 0; l < c.L; ++l)
    for (const Cut& k : cuts)
      lv[l].p[k.to] = ptrs[k.from] ? static_cast<const float*>(ptrs[k.from]) + l * k.stride
                                   : nullptr;
  auto in = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  return levels_fwd(c, in(XV0), in(XH0), in(COND), lv,
                    static_cast<float*>(const_cast<void*>(ptrs[PROJ])),
                    static_cast<cudaStream_t>(stream));
}
