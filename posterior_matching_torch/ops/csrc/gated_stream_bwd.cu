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
// ~773 GFLOP at the in-image taps against ~1.5 GB read and written (0.45 ms
// at 3.35 TB/s). The GEMM core (gated_common.cuh) does each float32
// product as 3 TF32 tensor-core products: 4.7 ms at 495 TFLOP/s (11.5 ms as
// float32 FMAs at 67 TFLOP/s). At digits16's (512 rows of 4 x 4, F = 64,
// L = 6: the 64-filter build) 2.4 / 2.6 GFLOP a pass, 15 / 16 us:
// launch-bound.
//
// Design. The TPU kernel carries dv/dh through VMEM across a sequential
// grid and accumulates dW in a resident output block. On Hopper the
// data-gradient phases are launches over all 8192 rows per level, top level
// first, keeping each level's db1 and da1 in scratch; the weight gradients
// of all levels then run as one launch per weight kind: gated_levels.cuh's
// levels_bwd, every product on the tensor-core GEMM core. At the flagship's
// 12 levels the vertical convs' launches have 288 blocks of 64 channels and
// sum all 8192 rows each; the horizontal convs' (192 blocks) and the aux
// products' (48) are cut into 2 and 6 row splits, whose partial sums go
// through `part`. The stream's weights, saves and gradients are
// [L, ...] stacks; this entry point cuts them into per-level pointers.
//
// bf16: built a second time with -DPM_CORE_BF16=1 (_build.SOURCES' *_bf16)
// for compute_dtype bfloat16: the JAX kernel at cdtype bf16 (gated_chain.py:
// 206-252, 1407-1505), on the core's bf16 path (gated_common.cuh): the
// activations, saves and their cotangents bf16, the carries between levels
// rounded to bf16 as the Pallas kernel's dv_scr / dh_scr are (:1462, :1502);
// cond, dcond and the weights' gradients float32.
#include "gated_levels.cuh"

namespace {

using namespace gsk;

enum BwdPtr {
  GV, GH, XV0, XH0, XVO, XHO, SKV, SKH, COND, A1V, A1H, B1V, B1H,
  WAV, WBV, WCV, WXV, WAH, WBH, WCH, WXHU, WXHS,
  DXV0, DXH0, DSKV, DSKH, DCOND,
  DWAV, DBAV, DWBV, DBBV, DWCV, DWXV, DWAH, DBAH, DWBH, DBBH, DWCH, DWXHU, DWXHS,
  DB1V, DB1H, DA1V, DA1H, GTOT, GVTOT, RSV, RSH, RAV, RAH, PART, CV, CH, BWD_NPTR
};

// The VJP of one pass of chain c at c.F == F filters.
template <int F>
int run_bwd(const void* const* ptrs, Chain c, cudaStream_t stream) {
  const size_t RF = (size_t)c.g.R * F, FF = (size_t)F * F;
  const size_t tv = c.tv.n, th = c.th.n, cd = c.CD;
  c.round_carry = kBF16;  // the Pallas stream's carries are of the compute dtype
  // each stack's [L, ...] level stride, in elements: of the compute dtype
  // (cdt), or float32 (the gradients of the weights and biases)
  struct Cut { int from, to; size_t stride; bool f32; };
  const Cut cuts[] = {
      {GV, LB_GV, RF}, {GH, LB_GH, RF}, {XVO, LB_XVO, RF}, {XHO, LB_XHO, RF},
      {SKV, LB_SKV, RF}, {SKH, LB_SKH, RF}, {A1V, LB_A1V, RF}, {A1H, LB_A1H, RF},
      {B1V, LB_B1V, 2 * RF}, {B1H, LB_B1H, 2 * RF},
      {WAV, LB_WAV, tv * 2 * FF}, {WBV, LB_WBV, tv * 4 * FF}, {WCV, LB_WCV, cd * 2 * F},
      {WXV, LB_WXV, 2 * FF}, {WAH, LB_WAH, th * 2 * FF}, {WBH, LB_WBH, th * 4 * FF},
      {WCH, LB_WCH, cd * 2 * F}, {WXHU, LB_WXHU, 2 * FF}, {WXHS, LB_WXHS, 2 * FF},
      {DSKV, LB_DSKV, RF}, {DSKH, LB_DSKH, RF},
      {DWAV, LB_DWAV, tv * 2 * FF, true}, {DBAV, LB_DBAV, F, true},
      {DWBV, LB_DWBV, tv * 4 * FF, true}, {DBBV, LB_DBBV, 2 * F, true},
      {DWCV, LB_DWCV, cd * 2 * F, true}, {DWXV, LB_DWXV, 2 * FF, true},
      {DWAH, LB_DWAH, th * 2 * FF, true}, {DBAH, LB_DBAH, F, true},
      {DWBH, LB_DWBH, th * 4 * FF, true}, {DBBH, LB_DBBH, 2 * F, true},
      {DWCH, LB_DWCH, cd * 2 * F, true}, {DWXHU, LB_DWXHU, 2 * FF, true},
      {DWXHS, LB_DWXHS, 2 * FF, true},
  };
  LevelBwd lv[kMaxLevels];
  for (int l = 0; l < c.L; ++l)
    for (const Cut& k : cuts)
      lv[l].p[k.to] = ptrs[k.from] ? static_cast<const char*>(ptrs[k.from]) +
                                         l * k.stride * (k.f32 ? sizeof(float) : sizeof(cdt))
                                   : nullptr;
  auto act = [&](int i) { return static_cast<cdt*>(const_cast<void*>(ptrs[i])); };
  auto out = [&](int i) { return static_cast<float*>(const_cast<void*>(ptrs[i])); };
  const BwdPass s{act(XV0), act(XH0), out(COND), act(DXV0), act(DXH0), out(DCOND),
                  out(DB1V), out(DB1H), out(DA1V), out(DA1H), out(GTOT), out(GVTOT),
                  out(RSV), out(RSH), out(RAV), out(RAH), out(PART), out(CV), out(CH)};
  return levels_bwd<F>(c, s, lv, stream);
}

}  // namespace

// The VJP of one pass. `ptrs` holds BWD_NPTR device pointers in the order
// of ops/gated_chain.py::_BWD_PTRS (the skip and skip-weight entries null
// on the up pass; the last is the weight gradients' partial sums,
// pm_gated_stream_bwd_part_floats floats), `ints` the geometry of
// _GEOMETRY. Returns cudaGetLastError() after the launches.
extern "C" int pm_gated_stream_bwd(const void* const* ptrs, int nptrs, const int* ints,
                                   int nints, float inv_keep, void* stream) {
  Chain c;
  if (nptrs != BWD_NPTR || !make_chain(ints, nints, inv_keep, c))
    return (int)cudaErrorInvalidValue;
  GSK_DISPATCH_WIDTHS(c.F, run_bwd<F>(ptrs, c, static_cast<cudaStream_t>(stream)));
}

// Floats of the `part` scratch pm_gated_stream_bwd needs for a geometry (0
// when no weight kind is split); -1 for a geometry it refuses. `splits`, if
// not null, receives the row splits of the weight kinds of the vertical
// convs, the horizontal convs and the aux products.
extern "C" long long pm_gated_stream_bwd_part_floats(const int* ints, int nints, int* splits) {
  Chain c;
  if (!make_chain(ints, nints, 1.f, c)) return -1;
  if (splits) wgrad_splits(c, splits);
  return wgrad_part_floats(c);
}
