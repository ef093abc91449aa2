// Forward of one run of the VDVAE encoder's residual bottleneck blocks.
//
// Replaces posterior_matching_tpu/ops/block_chain.py::_fwd_kernel_factory
// (Pallas, grid (batch chunk, level), pallas_call at :467). Per level l,
// with x the level's input (x0, then the previous level's output), C the
// chain width and M the bottleneck (192 and 48 in PM-VDVAE MNIST):
//   h1 = gelu(x) @ w1 + b1                  ([R, C] x [C, M])
//   h2 = conv_k(gelu(h1), w2) + b2          (k x k SAME, M -> M)
//   h3 = conv_k(gelu(h2), w3) + b3
//   xout[l] = x + gelu(h3) @ w4 + b4        ([R, M] x [M, C])
// gelu is the tanh approximation. Saves for the backward: every level's
// output xout and the pre-gelu h1, h2, h3.
//
// Bound: operations. A level is 2 x 192 x 48 x 2 FLOP per row for c1 and
// c4 and 48 x 48 x 2 per row and in-image tap for c2 and c3 (an
// out-of-image tap adds a zero): at the encoder's res-28 run of a training
// step (16 x 28 x 28 = 12544 rows, L = 6, 82 x 82 in-image taps an image
// where 9 x 28 x 28 = 84 x 84 would be all) 8.7 GFLOP: 0.053 ms as 3 TF32
// products at the H100's 495 TFLOP/s (NVIDIA's data sheet; the core's way),
// 0.13 ms as float32 FMAs at 67, against 0.11 GB of inputs and saves
// (0.033 ms at 3.35 TB/s).
//
// Design. The Pallas kernel walks (chunk, level) in order and carries the
// level's input in VMEM. On Hopper blocks run in parallel and unordered, so
// each dependent phase is its own launch over all rows of the run, on
// vdvae_gemm.cuh's tensor-core core (dgemm: 3xTF32 mma.sync, gelu and the
// TF32 split applied once as a slab is staged, B through a cp.async ring):
// c1 (K = C in slabs of M), c2 and c3 (one k x k term: the slab staged once
// with a halo of W + 1 rows, each tap read shifted under the image mask,
// the TPU's pltpu.roll and mask), c4 (N = C as column tiles of M, jobs of
// one launch) with the bias and the residual in the epilogue. 4 launches a
// level; the carry is the saved level output in global memory. In the bf16
// build c1..c3 run as bf16 products, each writing its float32 output into
// scratch (HS, [3, R, M]: the next product reads it unrounded, as the
// Pallas kernel's h1, h2, h3) and its bf16 save beside it; c4 reads
// gelu(h3) in float32 and runs on 3xTF32.
#include "block_chain_common.cuh"

namespace {

using namespace bck;

// HS, the bf16 build's float32 scratch, is not passed to the float32 build.
enum FwdPtr { X0, W1, B1, W2, B2, W3, B3, W4, B4, XOUT, H1, H2, H3, HS,
              FWD_NPTR = kBF16 ? HS + 1 : HS };

template <int C, int M>
int run_fwd(const void* const* ptrs, const int* ints, cudaStream_t s) {
  auto in = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto out = [&](int i) { return static_cast<float*>(const_cast<void*>(ptrs[i])); };
  // c1..c3's weights and the saves: of the compute dtype
  auto inc = [&](int i) { return static_cast<const cdt*>(ptrs[i]); };
  auto outc = [&](int i) { return static_cast<cdt*>(const_cast<void*>(ptrs[i])); };
  const Geo g = make_geo(ints);
  const int L = ints[I_L], k = ints[I_K], taps = k * k;
  const size_t RC = (size_t)g.R * C, RM = (size_t)g.R * M;

  for (int l = 0; l < L; ++l) {
    const float* x = l ? in(XOUT) + (l - 1) * RC : in(X0);
    cdt* sv[3] = {outc(H1) + l * RM, outc(H2) + l * RM, outc(H3) + l * RM};
    float* h[3];
    for (int i = 0; i < 3; ++i)
      h[i] = kBF16 ? out(HS) + i * RM : reinterpret_cast<float*>(sv[i]);

    // c1: h1 = gelu(x) @ w1 + b1
    DJob c1 = job(M, E_BIAS, h[0], M, term(x, C, 1, inc(W1) + (size_t)l * C * M, M, 0));
    c1.bias = in(B1) + (size_t)l * M;
    set_save(c1, sv[0]);
    launch_dgemm<M, kBF16>(g, &c1, 1, s);
    // c2, c3: k x k convolutions through gelu
    const int ws[2] = {W2, W3}, bs[2] = {B2, B3};
    for (int c = 0; c < 2; ++c) {
      DJob cv = job(M, E_BIAS, h[c + 1], M,
                    term(h[c], M, 1, inc(ws[c]) + (size_t)l * taps * M * M, M, 0, taps));
      cv.bias = in(bs[c]) + (size_t)l * M;
      set_save(cv, sv[c + 1]);
      launch_dgemm<M, kBF16>(g, &cv, 1, s);
    }
    // c4: xout[l] = x + gelu(h3) @ w4 + b4
    DJob c4 = job(C, E_BIAS_RES, out(XOUT) + l * RC, C,
                  term(h[2], M, 1, in(W4) + (size_t)l * M * C, C, 0));
    c4.bias = in(B4) + (size_t)l * C;
    c4.res = x;
    launch_dgemm<M>(g, &c4, 1, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One run. `ptrs` holds FWD_NPTR device pointers in the order of
// ops/block_chain.py::_FWD_PTRS (and, in the bf16 build, the scratch HS),
// `ints` the geometry of _GEOMETRY. Returns cudaGetLastError() after the
// launches.
extern "C" int pm_block_chain_fwd(const void* const* ptrs, int nptrs,
                                  const int* ints, int nints, void* stream_) {
  if (nptrs != FWD_NPTR || nints != I_COUNT || !geometry_ok(ints))
    return (int)cudaErrorInvalidValue;
  BCK_DISPATCH_WIDTHS(ints, (run_fwd<C, M>(ptrs, ints, static_cast<cudaStream_t>(stream_))));
}
