// Backward (VJP) of one run of the VDVAE's posterior-matching decoder
// blocks.
//
// Replaces posterior_matching_tpu/ops/decoder_chain.py::_bwd_kernel_factory
// (Pallas, grid (batch chunk, reversed level), pallas_call at :532). From
// the forward's saves (level outputs xout, the states u, post, the pre-gelu
// h1..h3 of the four Blocks), the noise and the cotangents of the run's
// outputs (g of x_final, and gpost, gprior, gmask of every level's heads,
// which the decoder's KL and pm_kl feed back) it computes dx0, dacts,
// dmacts and the 34 weight gradients. Per level, top level first, as the
// Pallas kernel (:332-378), with d the cotangent of the level's output:
//   r:  dh3..dh1 of Block_r from d;   du = d + gelu'(u) (dh1_r @ r_w1^T)
//   z:  dz = du @ wz^T;   dpost = gpost + [dz | dz eps sigmoid(raw)]
//   p:  dh3..dh1 of Block_p from dpost;   dacts += gelu'(acts) (dh1_p @ p_w1[C:]^T)
//   m:  dh3..dh1 of Block_m from gmask;   dmacts += gelu'(macts) (dh1_m @ m_w1[C:]^T)
//       (the masked Block's x cotangent is dropped: a structural stop-gradient)
//   q:  dh3..dh1 of Block_q from [gprior | du]
//   dx = du + gelu'(x) (dh1_p @ p_w1[:C]^T + dh1_q @ q_w1^T)   (the next d)
// where each dh3 = gelu'(h3) (c4 cotangent @ w4^T) and dh2, dh1 pass back
// through the mirrored taps of c3, c2. Then the weight gradients: dw1 =
// gelu(input)^T dh1 (for p and m the state rows and the activation rows),
// dw2, dw3 from the shifted gelu(h1), gelu(h2), dw4 = gelu(h3)^T (c4
// cotangent), dwz = z^T du, the biases as column sums.
//
// Bound: operations. Every forward product has a data and a weight
// gradient (the masked Block's x-side data gradient excepted), about 2x
// the forward's ~43 GFLOP at the res-28 run of a PM-VDVAE MNIST training
// step (1.3 ms at 67 TFLOP/s), against ~0.6 GB of saves, cotangents and
// gradients (0.2 ms at 3.35 TB/s).
//
// Design. As block_chain_bwd.cu: the data-gradient phases are launches over
// all rows, level by level (chain_gemm, gelu's derivative recomputed from
// the saves in the epilogue, dacts and dmacts accumulated in place, the
// top level's write starting them); every level's dh1..dh3, du and d stay
// in scratch. z_bwd does the z step in one launch a level. The weight
// gradients of all levels then run as one wgrad launch per stack (two for
// the stacks whose rows or columns come from two sources), summed over
// 1024-row splits in a fixed order, and the bias gradients as column sums:
// no atomics, so equal inputs give equal gradients on every run.
#include <initializer_list>

#include "decoder_chain_common.cuh"

namespace {

using namespace dck;

constexpr int SBASE = 11;              // h1, h2, h3 of p, m, q, r
constexpr int WBASE = SBASE + 12;      // the 34 weight stacks
constexpr int GBASE = WBASE + kWeights + 3;  // their gradients, after dx0, dacts, dmacts
enum BwdPtr {
  G, GPOST, GPRIOR, GMASK, X0, ACTS, MACTS, EPS, XOUT, POST, U,
  DX0 = WBASE + kWeights, DACTS, DMACTS,
  DXS = GBASE + kWeights, DUS, DPOST, ZS,
  DHBASE,  // scratch dh1, dh2, dh3 of p, m, q, r
  PART = DHBASE + 12, BWD_NPTR
};

// dh3 = gelu'(h3) * (sum of the c4-cotangent terms `top`), then dh2 and
// dh1 back through the mirrored taps of c3 and c2.
template <int M>
void block_back(const Geo& g, int k, const Term* top, int n_top, const float* const* h,
                const float* const* w, float* const* dh, cudaStream_t s) {
  GemmArgs a{};
  a.g = g;
  a.amode = A_IDENT;
  a.epi = E_GELU_BWD;
  for (int i = 0; i < n_top; ++i) a.t[a.nt++] = top[i];
  a.z = h[2];
  a.out = dh[2];
  launch_gemm<M>(a, s);
  for (int c = 1; c >= 0; --c) {  // c3 then c2
    GemmArgs b{};
    b.g = g;
    b.amode = A_IDENT;
    b.epi = E_GELU_BWD;
    add_taps(b, k, -1, dh[c + 1], M, w[W2 + 2 * c], M, 1);
    b.z = h[c];
    b.out = dh[c];
    launch_gemm<M>(b, s);
  }
}

// out = gelu'(z) * (sum of the terms) + base (base may be null).
template <int N>
void gelu_bwd_gemm(const Geo& g, std::initializer_list<Term> terms, const float* z,
                   const float* base, float* out, cudaStream_t s) {
  GemmArgs e{};
  e.g = g;
  e.amode = A_IDENT;
  e.epi = E_GELU_BWD;
  for (const Term& t : terms) e.t[e.nt++] = t;
  e.z = z;
  e.base = base;
  e.out = out;
  launch_gemm<N>(e, s);
}

// The z step's VJP for a block of kThreads / LD rows, a thread per (row,
// latent j): dz = du @ wz^T, dpost = gpost + [dz | dz eps sigmoid(raw)]
// (softplus' = sigmoid), and z = loc + (softplus(raw) + 1e-5) eps for dwz.
// du's rows and wz are staged in shared memory (rows padded by one float).
template <int C, int LD>
__global__ void __launch_bounds__(kThreads)
    z_bwd(const float* __restrict__ du, const float* __restrict__ wz,
          const float* __restrict__ post, const float* __restrict__ eps,
          const float* __restrict__ gpost, float* __restrict__ dpost,
          float* __restrict__ z, int R) {
  constexpr int RB = kThreads / LD, P = C + 1;
  __shared__ float sw[LD * P];
  __shared__ float sd[RB * P];
  const int tid = threadIdx.x, r0 = blockIdx.x * RB;
  for (int i = tid; i < LD * C; i += kThreads) sw[(i / C) * P + i % C] = wz[i];
  for (int i = tid; i < RB * C; i += kThreads) {
    const int r = r0 + i / C;
    sd[(i / C) * P + i % C] = r < R ? du[(size_t)r0 * C + i] : 0.f;
  }
  __syncthreads();
  const int rr = tid / LD, j = tid % LD, r = r0 + rr;
  if (r >= R) return;
  float dz = 0.f;
  for (int c = 0; c < C; ++c) dz = fmaf(sd[rr * P + c], sw[j * P + c], dz);
  const size_t o = (size_t)r * 2 * LD;
  const float raw = post[o + LD + j], e = eps[(size_t)r * LD + j];
  dpost[o + j] = gpost[o + j] + dz;
  dpost[o + LD + j] = gpost[o + LD + j] + dz * e * sigmoid(raw);
  z[(size_t)r * LD + j] = post[o + j] + (softplus(raw) + 1e-5f) * e;
}

template <int C, int M, int LD>
int run_bwd(const void* const* ptrs, const int* ints, cudaStream_t s) {
  using D = Dims<C, M, LD>;
  auto in = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto out = [&](int i) { return static_cast<float*>(const_cast<void*>(ptrs[i])); };
  const Geo g = make_geo(ints);
  const int L = ints[I_L], k = ints[I_K];
  const size_t R = g.R, RC = R * C, RM = R * M, RP = R * 2 * LD, RZ = R * LD;
  float* dxs = out(DXS);
  float* dus = out(DUS);

  // d of the top level is the external cotangent
  cudaError_t err = cudaMemcpyAsync(dxs + (L - 1) * RC, in(G), RC * sizeof(float),
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;

  for (int l = L - 1; l >= 0; --l) {
    const float* w[4][8];
    const float* h[4][3];
    float* dh[4][3];
    for (int b = 0; b < 4; ++b) {
      for (int i = 0; i < 8; ++i)
        w[b][i] = in(WBASE + 8 * b + i) + l * D::stride(8 * b + i, k);
      for (int i = 0; i < 3; ++i) {
        h[b][i] = in(SBASE + 3 * b + i) + l * RM;
        dh[b][i] = out(DHBASE + 3 * b + i) + l * RM;
      }
    }
    const float* d = dxs + l * RC;
    const float* x = l ? in(XOUT) + (l - 1) * RC : in(X0);
    float* du = dus + l * RC;
    float* dpost = out(DPOST) + l * RP;
    const bool first = l == L - 1;

    // resnet: its c4 cotangent is d, which the residual also hands to u
    const Term tr[1] = {Term{d, w[BR][W4], C, 0, 0, C, 1}};
    block_back<M>(g, k, tr, 1, h[BR], w[BR], dh[BR], s);
    gelu_bwd_gemm<C>(g, {Term{dh[BR][0], w[BR][W1], M, 0, 0, M, 1}}, in(U) + l * RC, d, du, s);

    constexpr int RB = kThreads / LD;
    z_bwd<C, LD><<<(g.R + RB - 1) / RB, kThreads, 0, s>>>(
        du, in(WBASE + WZ) + l * D::stride(WZ, k), in(POST) + l * RP, in(EPS) + l * RZ,
        in(GPOST) + l * RP, dpost, out(ZS) + l * RZ, g.R);

    const Term tp[1] = {Term{dpost, w[BP][W4], 2 * LD, 0, 0, 2 * LD, 1}};
    block_back<M>(g, k, tp, 1, h[BP], w[BP], dh[BP], s);
    gelu_bwd_gemm<C>(g, {Term{dh[BP][0], w[BP][W1] + (size_t)C * M, M, 0, 0, M, 1}},
                     in(ACTS), first ? nullptr : out(DACTS), out(DACTS), s);

    const Term tm[1] = {Term{in(GMASK) + l * R * D::MW, w[BM][W4], D::MW, 0, 0, D::MW, 1}};
    block_back<M>(g, k, tm, 1, h[BM], w[BM], dh[BM], s);
    gelu_bwd_gemm<C>(g, {Term{dh[BM][0], w[BM][W1] + (size_t)C * M, M, 0, 0, M, 1}},
                     in(MACTS), first ? nullptr : out(DMACTS), out(DMACTS), s);

    const Term tq[2] = {Term{in(GPRIOR) + l * RP, w[BQ][W4], 2 * LD, 0, 0, D::QW, 1},
                        Term{du, w[BQ][W4] + 2 * LD, C, 0, 0, D::QW, 1}};
    block_back<M>(g, k, tq, 2, h[BQ], w[BQ], dh[BQ], s);

    gelu_bwd_gemm<C>(g, {Term{dh[BP][0], w[BP][W1], M, 0, 0, M, 1},
                         Term{dh[BQ][0], w[BQ][W1], M, 0, 0, M, 1}},
                     x, du, l ? dxs + (l - 1) * RC : out(DX0), s);
  }

  // ---- weight gradients of all levels, one stack at a time --------------
  float* part = out(PART);
  auto gw = [&](int i) { return out(GBASE + i); };
  auto wg = [&](const float* src0, const float* src, size_t lsrc, int gelu,
                const float* gs, int Kin, int kk, int rows, int orow, int ldo, int ocol) {
    WgArgs a{};
    a.g = g;
    a.src0 = src0; a.src = src; a.lsrc = lsrc; a.gelu = gelu; a.gs = gs;
    a.Kin = Kin; a.k = kk; a.rows = rows; a.orow = orow; a.ldo = ldo; a.ocol = ocol;
    return a;
  };
  const float* acts[4] = {in(ACTS), in(MACTS), nullptr, nullptr};
  for (int b = 0; b < 4; ++b) {
    const float* dhb[3] = {in(DHBASE + 3 * b), in(DHBASE + 3 * b + 1), in(DHBASE + 3 * b + 2)};
    // dw1: gelu(the Block's input)^T dh1: the state rows (the run's level
    // inputs, or u for the resnet), then for p and m the activation rows
    const WgArgs w1 = b == BR ? wg(nullptr, in(U), RC, 1, dhb[0], C, 1, C, 0, 0, 0)
                              : wg(in(X0), in(XOUT), RC, 1, dhb[0], C, 1, D::cin(b), 0, 0, 0);
    weight_grad<M>(w1, gw(8 * b + W1), part, L, s);
    if (acts[b])
      weight_grad<M>(wg(nullptr, acts[b], 0, 1, dhb[0], C, 1, 2 * C, C, 0, 0),
                     gw(8 * b + W1), part, L, s);
    // dw2, dw3: shifted gelu(h1), gelu(h2) against dh2, dh3
    for (int c = 0; c < 2; ++c)
      weight_grad<M>(wg(nullptr, in(SBASE + 3 * b + c), RM, 1, dhb[c + 1], M, k, k * k * M, 0, 0, 0),
                     gw(8 * b + W2 + 2 * c), part, L, s);
    for (int i = 0; i < 3; ++i) launch_bias_grad(dhb[i], gw(8 * b + B1 + 2 * i), L, g.R, M, s);
  }
  // dw4: gelu(h3)^T (c4 cotangent), db4 its column sums
  auto h3 = [&](int b) { return in(SBASE + 3 * b + 2); };
  weight_grad<2 * LD>(wg(nullptr, h3(BP), RM, 1, out(DPOST), M, 1, M, 0, 0, 0), gw(8 * BP + W4), part, L, s);
  launch_bias_grad(out(DPOST), gw(8 * BP + B4), L, g.R, 2 * LD, s);
  weight_grad<D::MW>(wg(nullptr, h3(BM), RM, 1, in(GMASK), M, 1, M, 0, 0, 0), gw(8 * BM + W4), part, L, s);
  launch_bias_grad(in(GMASK), gw(8 * BM + B4), L, g.R, D::MW, s);
  // the prior's c4: the head's columns against gprior, the tail's against du
  weight_grad<2 * LD>(wg(nullptr, h3(BQ), RM, 1, in(GPRIOR), M, 1, M, 0, D::QW, 0),
                      gw(8 * BQ + W4), part, L, s);
  weight_grad<C>(wg(nullptr, h3(BQ), RM, 1, dus, M, 1, M, 0, D::QW, 2 * LD),
                 gw(8 * BQ + W4), part, L, s);
  launch_bias_grad(in(GPRIOR), gw(8 * BQ + B4), L, g.R, 2 * LD, s, D::QW);
  launch_bias_grad(dus, gw(8 * BQ + B4) + 2 * LD, L, g.R, C, s, D::QW);
  weight_grad<C>(wg(nullptr, h3(BR), RM, 1, dxs, M, 1, M, 0, 0, 0), gw(8 * BR + W4), part, L, s);
  launch_bias_grad(dxs, gw(8 * BR + B4), L, g.R, C, s);
  // dwz = z^T du, dbz = column sums of du
  weight_grad<C>(wg(nullptr, in(ZS), RZ, 0, dus, LD, 1, LD, 0, 0, 0), gw(WZ), part, L, s);
  launch_bias_grad(dus, gw(BZ), L, g.R, C, s);
  return (int)cudaGetLastError();
}

}  // namespace

// One run's VJP. `ptrs` holds BWD_NPTR device pointers in the order of
// ops/decoder_chain.py::_BWD_PTRS (the last 17 are scratch: every level's
// d and du [L, R, C], the posterior heads' cotangents [L, R, 2 LD], z
// [L, R, LD], the twelve dh [L, R, M] and the weight gradients' partial
// sums, pm_decoder_chain_bwd_part_floats floats), `ints` the geometry of
// _GEOMETRY. Returns cudaGetLastError() after the launches.
extern "C" int pm_decoder_chain_bwd(const void* const* ptrs, int nptrs,
                                    const int* ints, int nints, void* stream_) {
  if (nptrs != BWD_NPTR || nints != I_DCOUNT || !dec_geometry_ok(ints))
    return (int)cudaErrorInvalidValue;
  DCK_DISPATCH_WIDTHS(ints, (run_bwd<C, M, LD>(ptrs, ints, static_cast<cudaStream_t>(stream_))));
}

// Floats of the `part` scratch pm_decoder_chain_bwd needs for a geometry:
// the widest weight stack's partial sums per row split; -1 for a geometry
// it refuses.
extern "C" long long pm_decoder_chain_bwd_part_floats(const int* ints, int nints) {
  if (nints != I_DCOUNT || !dec_geometry_ok(ints)) return -1;
  const long long c = ints[I_C], m = ints[I_M], kk = ints[I_K] * ints[I_K];
  const long long ld = ints[I_LD], mw = ld + ld * (ld + 1) / 2;
  long long widest = c * m;
  for (long long v : {kk * m * m, m * mw, m * c, ld * c}) widest = v > widest ? v : widest;
  return ints[I_L] * n_splits(make_geo(ints)) * widest;
}
