// Forward of one level ("pair") or of a segment of L consecutive levels of
// the PixelCNN's gated resnet chain: two entry points, one library.
//
// pm_gated_pair_fwd replaces posterior_matching_tpu/ops/gated_chain.py::
// _fwd_kernel_factory (Pallas, grid (batch chunk,), pallas_call at :586;
// gated_pair :723): the vertical gated block, then the horizontal one with
// the new vertical (and on a down level the skips) as aux. It emits the TPU
// kernel's six outputs (:573-585): xv', xh' and the saves a1v, a1h, b1v,
// b1h. The PixelCNN runs 2 * num_resnet of these a step with
// chain_segment = 1.
//
// pm_gated_segment_fwd replaces _seg_fwd_kernel_factory (pallas_call at
// :1046; gated_segment :1215): L levels back to back, level l's inputs level
// l - 1's outputs, with the dropout hash of block 2 (base + l) + sub as the
// pair and stream kernels draw it. Each level's skips and weights arrive as
// their own tensors, a pointer list in the order of JAX's level-major
// argument list (:972-973); it returns every level's outputs and saves, so
// that up outputs stay addressable as down skips. Any L >= 1 (the last
// segment of a pass may be shorter: pixelcnn.py:470-494).
//
// Bound: operations. One flagship level (8192 rows of 16 x 16, F = 128) is
// 15.6 / 16.6 GFLOP up / down of float32 FMAs counting the conv taps that
// land inside the image (0.23 / 0.25 ms at 67 TFLOP/s) against ~50 MB read
// and written; a segment of 4 four times that.
//
// Design. gated_levels.cuh's levels_fwd over the levels: one launch for
// every level's cond projection, then 4 launches a level over all rows
// (data_gemm); the carries between levels are the level outputs in device
// memory, which the backward needs anyway. The TPU kernels keep the carry in
// VMEM and all L levels' weights resident; their batch chunks (bc_fwd) tile
// VMEM and have no counterpart: each launch covers all B*H*W rows.
#include "gated_levels.cuh"

namespace {

using namespace gsk;

enum LevelsFwdPtr { XV0, XH0, COND, PROJ, HEAD };

// `ptrs` holds HEAD pointers (ops/gated_chain.py::_SEG_FWD: xv, xh, cond,
// proj scratch [L, 2, B, 2F]) then LF_COUNT per level, level by level
// (_LEVEL_FWD); `ints` the geometry of _GEOMETRY, base_pair the first
// level's pair index; `max_levels` the most levels the entry point takes.
int run_levels_fwd(const void* const* ptrs, int nptrs, const int* ints, int nints,
                   float inv_keep, void* stream, int max_levels) {
  Chain c;
  if (!make_chain(ints, nints, inv_keep, c) || c.L > max_levels ||
      nptrs != HEAD + c.L * LF_COUNT)
    return (int)cudaErrorInvalidValue;
  LevelFwd lv[kMaxLevels];
  unpack_levels(ptrs, HEAD, c.L, lv);
  auto in = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  return levels_fwd(c, in(XV0), in(XH0), in(COND), lv,
                    static_cast<float*>(const_cast<void*>(ptrs[PROJ])),
                    static_cast<cudaStream_t>(stream));
}

}  // namespace

// One level (L = 1, base_pair the pair index). Returns cudaGetLastError()
// after the launches.
extern "C" int pm_gated_pair_fwd(const void* const* ptrs, int nptrs, const int* ints,
                                 int nints, float inv_keep, void* stream) {
  return run_levels_fwd(ptrs, nptrs, ints, nints, inv_keep, stream, 1);
}

// L levels (base_pair the segment's first pair index). Returns
// cudaGetLastError() after the launches.
extern "C" int pm_gated_segment_fwd(const void* const* ptrs, int nptrs, const int* ints,
                                    int nints, float inv_keep, void* stream) {
  return run_levels_fwd(ptrs, nptrs, ints, nints, inv_keep, stream, kMaxLevels);
}
