// Backward (VJP) of one run of the VDVAE encoder's residual bottleneck
// blocks.
//
// Replaces posterior_matching_tpu/ops/block_chain.py::_bwd_kernel_factory
// (Pallas, grid (batch chunk, reversed level), pallas_call at :509). From
// the forward's saves (level outputs xout, pre-gelu h1, h2, h3) and the
// cotangent g of the run's output it computes dx0 and every weight and bias
// gradient. Per level, top level first, as the Pallas kernel (:334-383),
// with d = the cotangent of the level's output and x its input (xout[l - 1],
// or x0):
//   dh3 = gelu'(h3) * (d @ w4^T)
//   dh2 = gelu'(h2) * convT_k(dh3, w3)      (mirrored taps, w3[t]^T)
//   dh1 = gelu'(h1) * convT_k(dh2, w2)
//   dx  = d + gelu'(x) * (dh1 @ w1^T)       (the next level's d)
// and the weight gradients dw4 = gelu(h3)^T d, dw3[t] = shift_t(gelu(h2))^T
// dh3, dw2[t] = shift_t(gelu(h1))^T dh2, dw1 = gelu(x)^T dh1, db = sums of
// the same cotangents over rows.
//
// Bound: operations. The VJP of a product costs two products (data and
// weight gradients), each over the forward's in-image taps: 17.4 GFLOP at
// the encoder's res-28 run of a training step (0.26 ms at 67 TFLOP/s)
// against ~0.3 GB read and written (0.09 ms at 3.35 TB/s).
//
// Design. The TPU kernel carries d through VMEM across its sequential grid
// and accumulates dW in resident output blocks. On Hopper the data-gradient
// phases are launches over all rows, level by level, top level first
// (chain_gemm, gelu's derivative recomputed from the saves in the
// epilogue), keeping every level's dh1, dh2, dh3 and d in scratch. The
// weight gradients of all levels then run as one launch per weight stack
// (wgrad: one block per (input-row tile, tap, level, split of 1024 rows)),
// whose partial sums a second launch adds in a fixed order, and the bias
// gradients as column sums. No atomics: each output is summed in a fixed
// order, so equal inputs give equal gradients on every run.
#include "block_chain_common.cuh"

namespace {

using namespace bck;

enum BwdPtr {
  G, X0, XOUT, H1, H2, H3, W1, W2, W3, W4,
  DX0, DW1, DB1, DW2, DB2, DW3, DB3, DW4, DB4,
  DXS, DH1, DH2, DH3, PART, BWD_NPTR
};

template <int C, int M>
int run_bwd(const void* const* ptrs, const int* ints, cudaStream_t stream) {
  auto in = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto out = [&](int i) { return static_cast<float*>(const_cast<void*>(ptrs[i])); };
  const Geo g = make_geo(ints);
  const int L = ints[I_L], k = ints[I_K];
  const size_t RC = (size_t)g.R * C, RM = (size_t)g.R * M;
  float* dxs = out(DXS);

  // d of the top level is the external cotangent
  cudaError_t err = cudaMemcpyAsync(dxs + (L - 1) * RC, in(G), RC * sizeof(float),
                                    cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return (int)err;

  for (int l = L - 1; l >= 0; --l) {
    const float* d = dxs + l * RC;
    const float* x_in = l ? in(XOUT) + (l - 1) * RC : in(X0);
    float* dh1 = out(DH1) + l * RM;
    float* dh2 = out(DH2) + l * RM;
    float* dh3 = out(DH3) + l * RM;

    GemmArgs a{};  // dh3 = gelu'(h3) * (d @ w4^T)
    a.g = g;
    a.amode = A_IDENT;
    a.epi = E_GELU_BWD;
    a.t[a.nt++] = Term{d, in(W4) + (size_t)l * M * C, C, 0, 0, C, 1};
    a.z = in(H3) + l * RM;
    a.out = dh3;
    launch_gemm<M>(a, stream);

    const float* srcs[2] = {dh3, dh2};
    const float* ws[2] = {in(W3), in(W2)};
    const float* zs[2] = {in(H2) + l * RM, in(H1) + l * RM};
    float* dsts[2] = {dh2, dh1};
    for (int c = 0; c < 2; ++c) {
      GemmArgs b{};  // dh_{i-1} = gelu'(h_{i-1}) * convT(dh_i, w_i)
      b.g = g;
      b.amode = A_IDENT;
      b.epi = E_GELU_BWD;
      add_taps(b, k, -1, srcs[c], M, ws[c] + (size_t)l * k * k * M * M, M, 1);
      b.z = zs[c];
      b.out = dsts[c];
      launch_gemm<M>(b, stream);
    }

    GemmArgs e{};  // dx = d + gelu'(x) * (dh1 @ w1^T)
    e.g = g;
    e.amode = A_IDENT;
    e.epi = E_GELU_BWD;
    e.t[e.nt++] = Term{dh1, in(W1) + (size_t)l * C * M, M, 0, 0, M, 1};
    e.z = x_in;
    e.base = d;
    e.out = l ? dxs + (l - 1) * RC : out(DX0);
    launch_gemm<C>(e, stream);
  }

  WgArgs w{};
  w.g = g;
  w.gelu = 1;
  // dw1: gelu(level input)^T dh1
  w.src0 = in(X0); w.src = in(XOUT); w.lsrc = RC; w.gs = out(DH1);
  w.Kin = C; w.k = 1; w.rows = C;
  weight_grad<M>(w, out(DW1), out(PART), L, stream);
  // dw2, dw3: shifted gelu(h1), gelu(h2) against dh2, dh3
  w.src0 = nullptr; w.src = in(H1); w.lsrc = RM; w.gs = out(DH2);
  w.Kin = M; w.k = k; w.rows = k * k * M;
  weight_grad<M>(w, out(DW2), out(PART), L, stream);
  w.src = in(H2); w.gs = out(DH3);
  weight_grad<M>(w, out(DW3), out(PART), L, stream);
  // dw4: gelu(h3)^T d
  w.src = in(H3); w.gs = dxs; w.k = 1; w.rows = M;
  weight_grad<C>(w, out(DW4), out(PART), L, stream);

  launch_bias_grad(out(DH1), out(DB1), L, g.R, M, stream);
  launch_bias_grad(out(DH2), out(DB2), L, g.R, M, stream);
  launch_bias_grad(out(DH3), out(DB3), L, g.R, M, stream);
  launch_bias_grad(dxs, out(DB4), L, g.R, C, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// One run's VJP. `ptrs` holds BWD_NPTR device pointers in the order of
// ops/block_chain.py::_BWD_PTRS (the last five are scratch: the level
// cotangents d [L, R, C], dh1..dh3 [L, R, M] and the weight gradients'
// partial sums, pm_block_chain_bwd_part_floats floats), `ints` the geometry
// of _GEOMETRY. Returns cudaGetLastError() after the launches.
extern "C" int pm_block_chain_bwd(const void* const* ptrs, int nptrs,
                                  const int* ints, int nints, void* stream_) {
  if (nptrs != BWD_NPTR || nints != I_COUNT || !geometry_ok(ints))
    return (int)cudaErrorInvalidValue;
  BCK_DISPATCH_WIDTHS(ints, (run_bwd<C, M>(ptrs, ints, static_cast<cudaStream_t>(stream_))));
}

// Floats of the `part` scratch pm_block_chain_bwd needs for a geometry: one
// weight stack's partial sums per row split; -1 for a geometry it refuses.
extern "C" long long pm_block_chain_bwd_part_floats(const int* ints, int nints) {
  if (nints != I_COUNT || !geometry_ok(ints)) return -1;
  const long long c = ints[I_C], m = ints[I_M], kk = ints[I_K] * ints[I_K];
  const long long widest = c * m > kk * m * m ? c * m : kk * m * m;
  return ints[I_L] * n_splits(make_geo(ints)) * widest;
}
