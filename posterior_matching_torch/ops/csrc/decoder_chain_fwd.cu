// Forward of one run of the VDVAE's posterior-matching decoder blocks.
//
// Replaces posterior_matching_tpu/ops/decoder_chain.py::_fwd_kernel_factory
// (Pallas, grid (batch chunk, level), pallas_call at :479). Per level l,
// with x the level's input (x0, then the previous level's output) and
// Block(in) = gelu -> c1 (1x1) -> gelu -> c2 (k x k) -> gelu -> c3 (k x k)
// -> gelu -> c4 (1x1), c1..c3 M wide, tanh-gelu:
//   post[l]   = Block_p([x, acts])                [R, 2 LD]: loc | raw
//   masked[l] = Block_m([x, macts])               [R, LD + TRIL]
//   q         = Block_q(x)                        [R, 2 LD + C]
//   prior[l]  = q[:, :2 LD]
//   z         = loc + (softplus(raw) + 1e-5) eps[l]
//   u         = x + q[:, 2 LD:] + z @ wz + bz
//   xout[l]   = u + Block_r(u)
// Saves for the backward: xout, u and the pre-gelu h1, h2, h3 of the four
// Blocks (the Pallas kernel recomputes u and z from its saves; here u is
// kept, one [R, C] stream a level, and z is rebuilt from post and eps).
//
// Bound: operations. A level is c1 of p and m (2 C x M), of q and r (C x
// M), c4 of all four (M x (2 LD + LD + TRIL + 2 LD + C + C)) at every row,
// and 4 x 2 k x k convolutions (M x M) at each row's in-image taps: at the
// res-28 run of a PM-VDVAE MNIST training step (16 x 28 x 28 rows, L = 7,
// C = 192, M = 48, LD = 16) about 43 GFLOP: 0.26 ms as 3 TF32 products at
// the H100's 495 TFLOP/s (NVIDIA's data sheet; the core's way), 0.64 ms as
// float32 FMAs at 67, against ~0.4 GB of inputs, outputs and saves (0.12 ms
// at 3.35 TB/s).
//
// Design. The Pallas kernel walks (chunk, level) in order with the state in
// VMEM. On Hopper each dependent phase is a launch over all rows of the run
// on vdvae_gemm.cuh's tensor-core core (dgemm: 3xTF32 mma.sync, conv
// operands staged once with their halo, B through a cp.async ring), and the
// p, m and q Blocks, independent given x, share each launch: c1, c2, c3,
// then c4 with the posterior's and masked posterior's heads, the prior's
// head and its tail plus x into u (column tiles of 48). z_into_state adds
// the z projection to u; the resnet Block r's four phases follow. 9
// launches a level (the previous design: 18). In the bf16 build c1..c3 are
// bf16 products, each writing its float32 output into scratch (HS, [12, R,
// M]: the next product reads it unrounded, as the Pallas kernel) and its
// bf16 save beside it; every c4 reads gelu(h3) in float32 on 3xTF32.
#include "decoder_chain_common.cuh"

namespace {

using namespace dck;

constexpr int WBASE = 4;  // the 34 weight stacks follow x0, acts, macts, eps
enum FwdPtr {
  X0, ACTS, MACTS, EPS,
  XOUT = WBASE + kWeights, POST, PRIOR, MASKED, U,
  SBASE,  // h1, h2, h3 of p, m, q, r
  HS = SBASE + 12,  // the bf16 build's float32 scratch, not passed to the float32 build
  FWD_NPTR = kBF16 ? HS + 1 : HS
};

template <int C, int M, int LD>
int run_fwd(const void* const* ptrs, const int* ints, cudaStream_t s) {
  using D = Dims<C, M, LD>;
  auto in = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto out = [&](int i) { return static_cast<float*>(const_cast<void*>(ptrs[i])); };
  // c1..c3's weights and the saves: of the compute dtype
  auto inc = [&](int i) { return static_cast<const cdt*>(ptrs[i]); };
  auto outc = [&](int i) { return static_cast<cdt*>(const_cast<void*>(ptrs[i])); };
  const Geo g = make_geo(ints);
  const int L = ints[I_L], k = ints[I_K], taps = k * k;
  const size_t R = g.R, RC = R * C, RM = R * M;

  for (int l = 0; l < L; ++l) {
    // level l's eight stacks of Block b (wc: c1..c3's, of the compute
    // dtype), its h1..h3 saves sv and the products' outputs h
    const float* w[4][8];
    const cdt* wc[4][8];
    cdt* sv[4][3];
    float* h[4][3];
    for (int b = 0; b < 4; ++b) {
      for (int i = 0; i < 8; ++i) {
        w[b][i] = in(WBASE + 8 * b + i) + l * D::stride(8 * b + i, k);
        wc[b][i] = inc(WBASE + 8 * b + i) + l * D::stride(8 * b + i, k);
      }
      for (int i = 0; i < 3; ++i) {
        sv[b][i] = outc(SBASE + 3 * b + i) + l * RM;
        h[b][i] = kBF16 ? out(HS) + (3 * b + i) * RM : reinterpret_cast<float*>(sv[b][i]);
      }
    }
    const float* x = l ? in(XOUT) + (l - 1) * RC : in(X0);
    float* post = out(POST) + l * R * 2 * LD;
    float* u = out(U) + l * RC;

    // c1 of p, m, q: h1 = gelu(x) @ w1[:C] (+ gelu(a) @ w1[C:]) + b1; the
    // masked posterior reads x too (its backward never returns to x)
    const float* acts[3] = {in(ACTS), in(MACTS), nullptr};
    DJob c1[3];
    for (int b = BP; b <= BQ; ++b) {
      c1[b] = job(M, E_BIAS, h[b][0], M, term(x, C, 1, wc[b][W1], M, 0));
      if (acts[b]) c1[b].t[c1[b].nt++] = term(acts[b], C, 1, wc[b][W1] + (size_t)C * M, M, 0);
      c1[b].bias = w[b][B1];
      set_save(c1[b], sv[b][0]);
    }
    launch_dgemm<M, kBF16>(g, c1, 3, s);
    // c2, c3 of p, m, q: k x k convolutions through gelu
    for (int c = 0; c < 2; ++c) {
      DJob cv[3];
      for (int b = BP; b <= BQ; ++b) {
        cv[b] = job(M, E_BIAS, h[b][c + 1], M,
                    term(h[b][c], M, 1, wc[b][W2 + 2 * c], M, 0, taps));
        cv[b].bias = w[b][B2 + 2 * c];
        set_save(cv[b], sv[b][c + 1]);
      }
      launch_dgemm<M, kBF16>(g, cv, 3, s);
    }
    // c4: the heads of p, m and q, and q's tail plus x into u
    DJob c4[4] = {
        job(2 * LD, E_BIAS, post, 2 * LD, term(h[BP][2], M, 1, w[BP][W4], 2 * LD, 0)),
        job(D::MW, E_BIAS, out(MASKED) + l * R * D::MW, D::MW,
            term(h[BM][2], M, 1, w[BM][W4], D::MW, 0)),
        job(2 * LD, E_BIAS, out(PRIOR) + l * R * 2 * LD, 2 * LD,
            term(h[BQ][2], M, 1, w[BQ][W4], D::QW, 0)),
        job(C, E_BIAS_RES, u, C, term(h[BQ][2], M, 1, w[BQ][W4] + 2 * LD, D::QW, 0))};
    c4[0].bias = w[BP][B4];
    c4[1].bias = w[BM][B4];
    c4[2].bias = w[BQ][B4];
    c4[3].bias = w[BQ][B4] + 2 * LD;
    c4[3].res = x;
    launch_dgemm<M>(g, c4, 4, s);
    launch_kernel(z_into_state<C, LD>, dim3((g.R + kZRows - 1) / kZRows), kZThreads,
                  kZRows * LD * 4, s, post, in(EPS) + l * R * LD,
                  in(WBASE + WZ) + l * D::stride(WZ, k), in(WBASE + BZ) + l * D::stride(BZ, k),
                  u, g.R);

    // the resnet Block on u; its c4 adds u
    DJob r1 = job(M, E_BIAS, h[BR][0], M, term(u, C, 1, wc[BR][W1], M, 0));
    r1.bias = w[BR][B1];
    set_save(r1, sv[BR][0]);
    launch_dgemm<M, kBF16>(g, &r1, 1, s);
    for (int c = 0; c < 2; ++c) {
      DJob rc = job(M, E_BIAS, h[BR][c + 1], M,
                    term(h[BR][c], M, 1, wc[BR][W2 + 2 * c], M, 0, taps));
      rc.bias = w[BR][B2 + 2 * c];
      set_save(rc, sv[BR][c + 1]);
      launch_dgemm<M, kBF16>(g, &rc, 1, s);
    }
    DJob r4 = job(C, E_BIAS_RES, out(XOUT) + l * RC, C, term(h[BR][2], M, 1, w[BR][W4], C, 0));
    r4.bias = w[BR][B4];
    r4.res = u;
    launch_dgemm<M>(g, &r4, 1, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One run. `ptrs` holds FWD_NPTR device pointers in the order of
// ops/decoder_chain.py::_FWD_PTRS (and, in the bf16 build, the scratch HS),
// `ints` the geometry of _GEOMETRY. Returns cudaGetLastError() after the
// launches.
extern "C" int pm_decoder_chain_fwd(const void* const* ptrs, int nptrs,
                                    const int* ints, int nints, void* stream_) {
  if (nptrs != FWD_NPTR || nints != I_DCOUNT || !dec_geometry_ok(ints))
    return (int)cudaErrorInvalidValue;
  DCK_DISPATCH_WIDTHS(ints, (run_fwd<C, M, LD>(ptrs, ints, static_cast<cudaStream_t>(stream_))));
}
