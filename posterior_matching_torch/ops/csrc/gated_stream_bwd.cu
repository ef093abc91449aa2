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
// ~773 GFLOP of float32 FMAs at the in-image taps (11.5 ms at 67 TFLOP/s)
// against ~1.5 GB read and written (0.45 ms at 3.35 TB/s).
//
// Design. The TPU kernel carries dv/dh through VMEM across a sequential
// grid and accumulates dW in a resident output block. On Hopper the
// data-gradient phases are launches over all 8192 rows per level, top level
// first, keeping each level's db1 and da1 in scratch; the weight gradients
// of all levels then run as one launch per weight kind: gated_levels.cuh's
// levels_bwd. The stream's weights, saves and gradients are [L, ...] stacks;
// this entry point cuts them into per-level pointers.
#include "gated_levels.cuh"

namespace {

using namespace gsk;

enum BwdPtr {
  GV, GH, XV0, XH0, XVO, XHO, SKV, SKH, COND, A1V, A1H, B1V, B1H,
  WAV, WBV, WCV, WXV, WAH, WBH, WCH, WXHU, WXHS,
  DXV0, DXH0, DSKV, DSKH, DCOND,
  DWAV, DBAV, DWBV, DBBV, DWCV, DWXV, DWAH, DBAH, DWBH, DBBH, DWCH, DWXHU, DWXHS,
  DB1V, DB1H, DA1V, DA1H, GTOT, GVTOT, RSV, RSH, RAV, RAH, BWD_NPTR
};

}  // namespace

// The VJP of one pass. `ptrs` holds BWD_NPTR device pointers in the order
// of ops/gated_chain.py::_BWD_PTRS (the skip and skip-weight entries null
// on the up pass), `ints` the geometry of _GEOMETRY. Returns
// cudaGetLastError() after the launches.
extern "C" int pm_gated_stream_bwd(const void* const* ptrs, int nptrs, const int* ints,
                                   int nints, float inv_keep, void* stream) {
  constexpr int F = kF;
  Chain c;
  if (nptrs != BWD_NPTR || !make_chain(ints, nints, inv_keep, c))
    return (int)cudaErrorInvalidValue;
  const size_t RF = (size_t)c.g.R * F, FF = (size_t)F * F;
  const size_t tv = c.tv.n, th = c.th.n, cd = c.CD;
  // each stack's [L, ...] level stride, in floats
  struct Cut { int from, to; size_t stride; };
  const Cut cuts[] = {
      {GV, LB_GV, RF}, {GH, LB_GH, RF}, {XVO, LB_XVO, RF}, {XHO, LB_XHO, RF},
      {SKV, LB_SKV, RF}, {SKH, LB_SKH, RF}, {A1V, LB_A1V, RF}, {A1H, LB_A1H, RF},
      {B1V, LB_B1V, 2 * RF}, {B1H, LB_B1H, 2 * RF},
      {WAV, LB_WAV, tv * 2 * FF}, {WBV, LB_WBV, tv * 4 * FF}, {WCV, LB_WCV, cd * 2 * F},
      {WXV, LB_WXV, 2 * FF}, {WAH, LB_WAH, th * 2 * FF}, {WBH, LB_WBH, th * 4 * FF},
      {WCH, LB_WCH, cd * 2 * F}, {WXHU, LB_WXHU, 2 * FF}, {WXHS, LB_WXHS, 2 * FF},
      {DSKV, LB_DSKV, RF}, {DSKH, LB_DSKH, RF},
      {DWAV, LB_DWAV, tv * 2 * FF}, {DBAV, LB_DBAV, F}, {DWBV, LB_DWBV, tv * 4 * FF},
      {DBBV, LB_DBBV, 2 * F}, {DWCV, LB_DWCV, cd * 2 * F}, {DWXV, LB_DWXV, 2 * FF},
      {DWAH, LB_DWAH, th * 2 * FF}, {DBAH, LB_DBAH, F}, {DWBH, LB_DWBH, th * 4 * FF},
      {DBBH, LB_DBBH, 2 * F}, {DWCH, LB_DWCH, cd * 2 * F}, {DWXHU, LB_DWXHU, 2 * FF},
      {DWXHS, LB_DWXHS, 2 * FF},
  };
  LevelBwd lv[kMaxLevels];
  for (int l = 0; l < c.L; ++l)
    for (const Cut& k : cuts)
      lv[l].p[k.to] = ptrs[k.from] ? static_cast<const float*>(ptrs[k.from]) + l * k.stride
                                   : nullptr;
  auto in = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto out = [&](int i) { return static_cast<float*>(const_cast<void*>(ptrs[i])); };
  const BwdPass s{in(XV0), in(XH0), in(COND), out(DXV0), out(DXH0), out(DCOND),
                  out(DB1V), out(DB1H), out(DA1V), out(DA1H), out(GTOT), out(GVTOT),
                  out(RSV), out(RSH), out(RAV), out(RAH)};
  return levels_bwd(c, s, lv, static_cast<cudaStream_t>(stream));
}
