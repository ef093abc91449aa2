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
// where 9 x 28 x 28 = 84 x 84 would be all) 8.7 GFLOP (0.13 ms at 67
// TFLOP/s) against 0.17 GB of inputs and saves (0.05 ms at 3.35 TB/s).
//
// Design. The Pallas kernel walks (chunk, level) in order and carries the
// level's input in VMEM. On Hopper blocks run in parallel and unordered, so
// each dependent phase is its own launch over all rows of the run (4 per
// level): chain_gemm (block_chain_common.cuh) tiles the rows 64 (N <= 64) or
// 32 (N = 192) a block, with the conv taps (the image-bounds test replaces
// the TPU's pltpu.roll and mask) and gelu fused into the A operand's load,
// and the bias and residual into the epilogue. The carry is the saved level
// output in global memory. Float32 FMAs without tensor cores: fast kernels
// (wgmma, TMA, bf16) are later work.
#include "block_chain_common.cuh"

namespace {

using namespace bck;

enum FwdPtr { X0, W1, B1, W2, B2, W3, B3, W4, B4, XOUT, H1, H2, H3, FWD_NPTR };

template <int C, int M>
int run_fwd(const void* const* ptrs, const int* ints, cudaStream_t stream) {
  auto in = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto out = [&](int i) { return static_cast<float*>(const_cast<void*>(ptrs[i])); };
  const Geo g = make_geo(ints);
  const int L = ints[I_L], k = ints[I_K];
  const size_t RC = (size_t)g.R * C, RM = (size_t)g.R * M;

  for (int l = 0; l < L; ++l) {
    const float* x_in = l ? in(XOUT) + (l - 1) * RC : in(X0);
    float* h1 = out(H1) + l * RM;
    float* h2 = out(H2) + l * RM;
    float* h3 = out(H3) + l * RM;

    GemmArgs a{};
    a.g = g;
    a.amode = A_GELU;
    a.epi = E_BIAS;
    a.t[a.nt++] = Term{x_in, in(W1) + (size_t)l * C * M, C, 0, 0, M, 0};
    a.bias = in(B1) + (size_t)l * M;
    a.out = h1;
    launch_gemm<M>(a, stream);

    const float* srcs[2] = {h1, h2};
    const float* ws[2] = {in(W2), in(W3)};
    const float* bs[2] = {in(B2), in(B3)};
    float* dsts[2] = {h2, h3};
    for (int c = 0; c < 2; ++c) {
      GemmArgs b{};
      b.g = g;
      b.amode = A_GELU;
      b.epi = E_BIAS;
      add_taps(b, k, 1, srcs[c], M, ws[c] + (size_t)l * k * k * M * M, M, 0);
      b.bias = bs[c] + (size_t)l * M;
      b.out = dsts[c];
      launch_gemm<M>(b, stream);
    }

    GemmArgs d{};
    d.g = g;
    d.amode = A_GELU;
    d.epi = E_BIAS_RES;
    d.t[d.nt++] = Term{h3, in(W4) + (size_t)l * M * C, M, 0, 0, C, 0};
    d.bias = in(B4) + (size_t)l * C;
    d.res = x_in;
    d.out = out(XOUT) + l * RC;
    launch_gemm<C>(d, stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One run. `ptrs` holds FWD_NPTR device pointers in the order of
// ops/block_chain.py::_FWD_PTRS, `ints` the geometry of _GEOMETRY. Returns
// cudaGetLastError() after the launches.
extern "C" int pm_block_chain_fwd(const void* const* ptrs, int nptrs,
                                  const int* ints, int nints, void* stream_) {
  if (nptrs != FWD_NPTR || nints != I_COUNT || !geometry_ok(ints))
    return (int)cudaErrorInvalidValue;
  BCK_DISPATCH_WIDTHS(ints, (run_fwd<C, M>(ptrs, ints, static_cast<cudaStream_t>(stream_))));
}
