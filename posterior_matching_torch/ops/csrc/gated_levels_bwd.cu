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
// in-image taps against ~70 MB read and written; a segment of 4 four times
// that. As the GEMM core does it, 3 TF32 tensor-core products per float32
// product: 0.19 / 0.20 ms at 495 TFLOP/s (0.46 / 0.50 ms as float32 FMAs at
// 67 TFLOP/s). At digits16's shapes (512 rows of 4 x 4, F = 64: the
// 64-filter build) 0.40 / 0.43 GFLOP a level, 2.4 / 2.6 us: launch-bound.
//
// Design. gated_levels.cuh's levels_bwd over the levels: the data gradients
// a launch over all rows per phase and level, top level first, each level's
// db1 and da1 kept in scratch; then one wgrad launch per weight kind for all
// the levels, and the bias and cond reductions, without the stream's [L, ...]
// stacks. At one level wgrad's grid is (2F / 64) x taps blocks, 24 for the
// 2x3 vertical convs, 16 for the 2x2 horizontal ones and 4 for an aux
// product, too few for 132 SMs: each kind's 8192 rows are cut into 11, 17
// and 64 row splits (a segment of 4: 3, 5 and 17) whose partial sums
// reduce_splits adds in split order, through `part`
// (pm_gated_levels_bwd_part_floats floats). The TPU
// kernels carry dv/dh in VMEM and accumulate dW per batch chunk; their batch
// chunks (bc_bwd) have no counterpart here.
//
// bf16: built a second time with -DPM_CORE_BF16=1 (_build.SOURCES' *_bf16)
// for compute_dtype bfloat16: the JAX kernel at cdtype bf16 (gated_chain.py:
// 206-252), on the core's bf16 path (gated_common.cuh): the activations,
// saves and their cotangents bf16; a segment's carries between levels stay
// float32 within the launch, as the Pallas segment's do (:909); cond, dcond
// and the weights' gradients float32.
#include "gated_levels.cuh"

namespace {

using namespace gsk;

enum LevelsBwdPtr {
  XV0, XH0, COND, DXV0, DXH0, DCOND, DB1V, DB1H, DA1V, DA1H, GTOT, GVTOT,
  RSV, RSH, RAV, RAH, PART, CV, CH, HEAD
};

// `ptrs` holds HEAD pointers (ops/gated_chain.py::_SEG_BWD: the levels'
// inputs, cond, their cotangents (out), scratch, the last the weight
// gradients' partial sums) then LB_COUNT per level,
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
  auto act = [&](int i) { return static_cast<cdt*>(const_cast<void*>(ptrs[i])); };
  auto out = [&](int i) { return static_cast<float*>(const_cast<void*>(ptrs[i])); };
  const BwdPass s{act(XV0), act(XH0), out(COND), act(DXV0), act(DXH0), out(DCOND),
                  out(DB1V), out(DB1H), out(DA1V), out(DA1H), out(GTOT), out(GVTOT),
                  out(RSV), out(RSH), out(RAV), out(RAH), out(PART), out(CV), out(CH)};
  GSK_DISPATCH_WIDTHS(c.F, levels_bwd<F>(c, s, lv, static_cast<cudaStream_t>(stream)));
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

// Floats of the `part` scratch either entry point needs for a geometry (0
// when no weight kind is split); -1 for a geometry it refuses. `splits`, if
// not null, receives the row splits of the weight kinds of the vertical
// convs, the horizontal convs and the aux products.
extern "C" long long pm_gated_levels_bwd_part_floats(const int* ints, int nints, int* splits) {
  Chain c;
  if (!make_chain(ints, nints, 1.f, c)) return -1;
  if (splits) wgrad_splits(c, splits);
  return wgrad_part_floats(c);
}
