// Backward (VJP) of one level ("pair") or of a segment of L consecutive
// levels of the PixelCNN's gated resnet chain: two entry points, one library.
//
// pm_gated_pair_bwd replaces posterior_matching_tpu/ops/gated_chain.py::
// _bwd_kernel_factory (Pallas, grid (batch chunk,), pallas_call at :649;
// gated_pair :723). From the cotangents gv, gh of the level's outputs, its
// inputs, the vertical output xv' and the saves a1v, a1h, b1v, b1h it
// computes dxv, dxh, (down) dskv, dskh, dcond and every weight and bias
// gradient of the level (:632-647), the dropout masks regenerated from the
// forward's hash.
//
// pm_gated_segment_bwd replaces _seg_bwd_kernel_factory (pallas_call at
// :1125; gated_segment :1215). It walks the levels in reverse and adds each
// level's external cotangents (those of its outputs that later code
// consumed; a null pointer is a zero) into the carried ones (:906-910),
// writes every level's skip and weight gradients, and sums dcond over the
// levels (:952-954).
//
// Bound: operations. Each product's VJP is two products (data and weight
// gradients): 31.1 / 33.3 GFLOP a flagship level up / down counting
// in-image taps (0.46 / 0.50 ms at 67 TFLOP/s) against ~70 MB read and
// written; a segment of 4 four times that.
//
// Design. gated_levels.cuh's levels_bwd over the levels: the data gradients
// a launch over all rows per phase and level, top level first, each level's
// db1 and da1 kept in scratch; then one wgrad launch per weight kind for all
// the levels, and the bias and cond reductions, without the stream's [L, ...]
// stacks. At one level wgrad's grid is (2F / 32) x taps blocks, 48 of them
// for the 2x3 vertical conv_a, on 132 SMs, so the pair's weight gradients
// leave SMs idle; splitting their 8192-row reductions is later work. The TPU
// kernels carry dv/dh in VMEM and accumulate dW per batch chunk; their batch
// chunks (bc_bwd) have no counterpart here.
#include "gated_levels.cuh"

namespace {

using namespace gsk;

enum LevelsBwdPtr {
  XV0, XH0, COND, DXV0, DXH0, DCOND, DB1V, DB1H, DA1V, DA1H, GTOT, GVTOT,
  RSV, RSH, RAV, RAH, HEAD
};

// `ptrs` holds HEAD pointers (ops/gated_chain.py::_SEG_BWD: the levels'
// inputs, cond, their cotangents (out), scratch) then LB_COUNT per level,
// level by level (_LEVEL_BWD); `ints` the geometry of _GEOMETRY, base_pair
// the first level's pair index; `max_levels` the most levels the entry
// point takes.
int run_levels_bwd(const void* const* ptrs, int nptrs, const int* ints, int nints,
                   float inv_keep, void* stream, int max_levels) {
  Chain c;
  if (!make_chain(ints, nints, inv_keep, c) || c.L > max_levels ||
      nptrs != HEAD + c.L * LB_COUNT)
    return (int)cudaErrorInvalidValue;
  LevelBwd lv[kMaxLevels];
  unpack_levels(ptrs, HEAD, c.L, lv);
  auto in = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto out = [&](int i) { return static_cast<float*>(const_cast<void*>(ptrs[i])); };
  const BwdPass s{in(XV0), in(XH0), in(COND), out(DXV0), out(DXH0), out(DCOND),
                  out(DB1V), out(DB1H), out(DA1V), out(DA1H), out(GTOT), out(GVTOT),
                  out(RSV), out(RSH), out(RAV), out(RAH)};
  return levels_bwd(c, s, lv, static_cast<cudaStream_t>(stream));
}

}  // namespace

// One level's VJP (L = 1, base_pair the pair index). Returns
// cudaGetLastError() after the launches.
extern "C" int pm_gated_pair_bwd(const void* const* ptrs, int nptrs, const int* ints,
                                 int nints, float inv_keep, void* stream) {
  return run_levels_bwd(ptrs, nptrs, ints, nints, inv_keep, stream, 1);
}

// The VJP of L levels (base_pair the segment's first pair index). Returns
// cudaGetLastError() after the launches.
extern "C" int pm_gated_segment_bwd(const void* const* ptrs, int nptrs, const int* ints,
                                    int nints, float inv_keep, void* stream) {
  return run_levels_bwd(ptrs, nptrs, ints, nints, inv_keep, stream, kMaxLevels);
}
