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
// step: 84.5 GFLOP, 0.51 ms as 3 TF32 products at the H100's 495 TFLOP/s
// (NVIDIA's data sheet; the core's way), 1.26 ms as float32 FMAs at 67,
// against ~0.5 GB of saves, cotangents and gradients (0.15 ms at 3.35
// TB/s).
//
// Design. The data-gradient phases run level by level, each a launch over
// all rows on vdvae_gemm.cuh's core (dgemm: 3xTF32 mma.sync, the
// mirrored conv taps read from one staged slab with its halo, gelu's
// derivative recomputed from the saves in the epilogue): the resnet
// Block's dh3, dh2, dh1 and du, the z step (z_bwd), then p, m and q, which
// are independent given du, as grouped launches of dh3, dh2 and dh1, and
// one launch of dacts, dmacts (accumulated in place, the top level's write
// starting them) and the next d: 9 launches a level (the previous design:
// 17). Every level's dh1..dh3, du and d stay in scratch. The weight
// gradients of all levels then run as three launches, one per kind of
// stack: the eight c2/c3 stacks (wgrad_taps: a block's source chunk
// gathered through gelu once for the nine taps, the cotangent rows staged
// with their halo); the c1 stacks with p's and m's activation rows; the c4
// stacks and wz (wgrad). Their row splits are added by one reduce_parts
// launch, and every bias gradient is one bias_sums launch: fixed splits
// and orders, no atomics, so equal inputs give equal gradients on every
// run. In the bf16 build, as the Pallas kernel (:330-378), gelu and its
// derivative are recomputed from the rounded saves, u and the posterior's
// outputs (whence z) are rebuilt from them at each level (_recompute_uz:
// two c4 jobs on 3xTF32 and z_into_state, into the U and POST scratch the
// wrapper passes in place of the forward's), and the c1..c3 data and weight
// gradients are bf16 products (the cotangent rounded to bf16 as it enters
// one) with float32 sums; the c4 and z gradients stay float32.
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

// The z step's VJP for a block of kZThreads / LD rows, a thread per (row,
// latent j): dz = du @ wz^T, dpost = gpost + [dz | dz eps sigmoid(raw)]
// (softplus' = sigmoid), and z = loc + (softplus(raw) + 1e-5) eps for dwz.
// du's rows and wz are staged in shared memory (rows padded by one float).
template <int C, int LD>
__global__ void __launch_bounds__(kZThreads)
    z_bwd(const float* __restrict__ du, const float* __restrict__ wz,
          const float* __restrict__ post, const float* __restrict__ eps,
          const float* __restrict__ gpost, float* __restrict__ dpost,
          float* __restrict__ z, int R) {
  constexpr int RB = kZThreads / LD, P = C + 1;
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;           // [LD][P]
  float* sd = smem + LD * P;  // [RB][P]
  const int tid = threadIdx.x, r0 = blockIdx.x * RB;
  for (int i = tid; i < LD * C; i += kZThreads) sw[(i / C) * P + i % C] = wz[i];
  for (int i = tid; i < RB * C; i += kZThreads) {
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

// The weight-gradient products of a run in three kinds of stack (0: the
// c2/c3 stacks, 1: the c1 stacks, 2: the c4 stacks and wz) and its bias
// gradients, from the entry point's pointers `p` (any non-null stand-ins
// where only the sizes are wanted). Returns the floats of `part` the row
// splits need.
struct Grads {
  WJob w[3][kMaxWJobs];
  int nw[3], blocks[3];
  BArgs bias;
  // a 3x3 run's c2/c3 stacks go through wgrad_taps (every tap a block)
  static bool taps(int kind, int k) { return kind == 0 && k == 3; }
  // the c1..c3 stacks are bf16 products in the bf16 build
  static bool bf(int kind) { return kBF16 && kind < 2; }
};

template <int C, int M, int LD>
size_t plan_grads(const Geo& g, int L, int k, float* const* p, Grads& gr) {
  using D = Dims<C, M, LD>;
  const size_t R = g.R, RC = R * C, RM = R * M, RP = R * 2 * LD;
  const int taps = k * k;
  // the h saves, of the compute dtype, are sources with s16 in the bf16 build
  auto wj = [&](int kind, const float* src0, const void* src, size_t lsrc, int gelu, int Kin,
                int tp, const float* gs, size_t lg, int N, float* out, size_t lout, int ldo,
                int s16 = 0) {
    WJob j{};
    j.src0 = src0;
    j.src = src;
    j.s16 = s16;
    j.lsrc = lsrc;
    j.gelu = gelu;
    j.Kin = Kin;
    j.taps = tp;
    j.gs = gs;
    j.lg = lg;
    j.ldg = (int)(lg / R);
    j.N = N;
    j.out = out;
    j.lout = lout;
    j.ldo = ldo;
    gr.w[kind][gr.nw[kind]++] = j;
  };
  auto dw = [&](int i) { return p[GBASE + i]; };
  auto st = [&](int i) { return D::stride(i, k); };
  gr.nw[0] = gr.nw[1] = gr.nw[2] = 0;
  for (int b = 0; b < 4; ++b) {
    // dw2, dw3: the shifted gelu(h1), gelu(h2) against dh2, dh3
    for (int c = 0; c < 2; ++c)
      wj(0, nullptr, p[SBASE + 3 * b + c], RM, 1, M, taps, p[DHBASE + 3 * b + c + 1], RM, M,
         dw(8 * b + W2 + 2 * c), st(8 * b + W2 + 2 * c), M, kBF16);
    // dw1: gelu(the Block's input)^T dh1: the state rows (the run's level
    // inputs, or u for the resnet), then for p and m the activation rows
    const float* dh1 = p[DHBASE + 3 * b];
    if (b == BR)
      wj(1, nullptr, p[U], RC, 1, C, 1, dh1, RM, M, dw(8 * b + W1), st(8 * b + W1), M);
    else
      wj(1, p[X0], p[XOUT], RC, 1, C, 1, dh1, RM, M, dw(8 * b + W1), st(8 * b + W1), M);
    if (b == BP || b == BM)
      wj(1, nullptr, p[b == BP ? ACTS : MACTS], 0, 1, C, 1, dh1, RM, M,
         dw(8 * b + W1) + (size_t)C * M, st(8 * b + W1), M);
  }
  // dw4: gelu(h3)^T (c4 cotangent); the prior's head against gprior, its
  // tail against du; dwz = z^T du
  auto h3 = [&](int b) { return p[SBASE + 3 * b + 2]; };
  wj(2, nullptr, h3(BP), RM, 1, M, 1, p[DPOST], RP, 2 * LD, dw(8 * BP + W4), st(8 * BP + W4),
     2 * LD, kBF16);
  wj(2, nullptr, h3(BM), RM, 1, M, 1, p[GMASK], R * D::MW, D::MW, dw(8 * BM + W4),
     st(8 * BM + W4), D::MW, kBF16);
  wj(2, nullptr, h3(BQ), RM, 1, M, 1, p[GPRIOR], RP, 2 * LD, dw(8 * BQ + W4), st(8 * BQ + W4),
     D::QW, kBF16);
  wj(2, nullptr, h3(BQ), RM, 1, M, 1, p[DUS], RC, C, dw(8 * BQ + W4) + 2 * LD, st(8 * BQ + W4),
     D::QW, kBF16);
  wj(2, nullptr, h3(BR), RM, 1, M, 1, p[DXS], RC, C, dw(8 * BR + W4), st(8 * BR + W4), C,
     kBF16);
  wj(2, nullptr, p[ZS], R * LD, 0, LD, 1, p[DUS], RC, C, dw(WZ), st(WZ), C);

  size_t pofs = 0;
  for (int kind = 0; kind < 3; ++kind)
    gr.blocks[kind] = plan_wgrad<M>(g, L, gr.w[kind], gr.nw[kind], gr.taps(kind, k), &pofs);

  // the biases: column sums of dh1..dh3, of the c4 cotangents and of du
  BArgs& ba = gr.bias;
  ba = BArgs{};
  ba.L = L;
  ba.R = g.R;
  auto bj = [&](const float* gs, size_t lg, int N, float* out, size_t lout) {
    ba.job[ba.nj++] = BJob{gs, out, lg, lout, (int)(lg / R), N};
  };
  for (int b = 0; b < 4; ++b)
    for (int i = 0; i < 3; ++i) bj(p[DHBASE + 3 * b + i], RM, M, dw(8 * b + B1 + 2 * i), M);
  bj(p[DPOST], RP, 2 * LD, dw(8 * BP + B4), 2 * LD);
  bj(p[GMASK], R * D::MW, D::MW, dw(8 * BM + B4), D::MW);
  bj(p[GPRIOR], RP, 2 * LD, dw(8 * BQ + B4), D::QW);
  bj(p[DUS], RC, C, dw(8 * BQ + B4) + 2 * LD, D::QW);
  bj(p[DXS], RC, C, dw(8 * BR + B4), C);
  bj(p[DUS], RC, C, dw(BZ), C);
  return pofs;
}

template <int C, int M, int LD>
int run_bwd(const void* const* ptrs, const int* ints, cudaStream_t s) {
  using D = Dims<C, M, LD>;
  auto in = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto out = [&](int i) { return static_cast<float*>(const_cast<void*>(ptrs[i])); };
  // c1..c3's weights and the saves: of the compute dtype
  auto inc = [&](int i) { return static_cast<const cdt*>(ptrs[i]); };
  const Geo g = make_geo(ints);
  const int L = ints[I_L], k = ints[I_K], taps = k * k;
  const size_t R = g.R, RC = R * C, RM = R * M, RP = R * 2 * LD, RZ = R * LD;
  float* dxs = out(DXS);
  float* dus = out(DUS);

  // d of the top level is the external cotangent
  cudaError_t err = cudaMemcpyAsync(dxs + (L - 1) * RC, in(G), RC * sizeof(float),
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;

  for (int l = L - 1; l >= 0; --l) {
    const float* w[4][8];
    const cdt* wc[4][8];  // c1..c3's, of the compute dtype
    const cdt* h[4][3];
    float* dh[4][3];
    for (int b = 0; b < 4; ++b) {
      for (int i = 0; i < 8; ++i) {
        w[b][i] = in(WBASE + 8 * b + i) + l * D::stride(8 * b + i, k);
        wc[b][i] = inc(WBASE + 8 * b + i) + l * D::stride(8 * b + i, k);
      }
      for (int i = 0; i < 3; ++i) {
        h[b][i] = inc(SBASE + 3 * b + i) + l * RM;
        dh[b][i] = out(DHBASE + 3 * b + i) + l * RM;
      }
    }
    const float* d = dxs + l * RC;
    const float* x = l ? in(XOUT) + (l - 1) * RC : in(X0);
    float* du = dus + l * RC;
    float* dpost = out(DPOST) + l * RP;
    const bool first = l == L - 1;
    if constexpr (kBF16) {
      // the level's posterior outputs and u from the rounded saves (the
      // Pallas kernel's _recompute_uz), into this build's POST and U scratch
      float* post = out(POST) + l * RP;
      float* u = out(U) + l * RC;
      DJob rc[2] = {job(2 * LD, E_BIAS, post, 2 * LD, term(h[BP][2], M, 1, w[BP][W4], 2 * LD, 0)),
                    job(C, E_BIAS_RES, u, C, term(h[BQ][2], M, 1, w[BQ][W4] + 2 * LD, D::QW, 0))};
      rc[0].bias = w[BP][B4];
      rc[1].bias = w[BQ][B4] + 2 * LD;
      rc[1].res = x;
      launch_dgemm<M>(g, rc, 2, s);
      launch_kernel(z_into_state<C, LD>, dim3((g.R + kZRows - 1) / kZRows), kZThreads,
                    kZRows * LD * 4, s, static_cast<const float*>(post), in(EPS) + l * RZ,
                    in(WBASE + WZ) + l * D::stride(WZ, k), in(WBASE + BZ) + l * D::stride(BZ, k),
                    u, g.R);
    }
    // dh3 = gelu'(h3) (the c4 cotangent terms), then dh2 and dh1 back
    // through the mirrored taps of c3 and c2, of the Blocks in `bs`
    auto back = [&](const int* bs, int nb, DJob* top) {
      for (int i = 0; i < nb; ++i) set_z(top[i], h[bs[i]][2]);
      launch_dgemm<M>(g, top, nb, s);
      for (int c = 1; c >= 0; --c) {
        DJob j[3];
        for (int i = 0; i < nb; ++i) {
          const int b = bs[i];
          j[i] = job(M, E_GELU_BWD, dh[b][c], M,
                     term(dh[b][c + 1], M, 0, wc[b][W2 + 2 * c], M, 1, taps, -1));
          set_z(j[i], h[b][c]);
        }
        launch_dgemm<M, kBF16>(g, j, nb, s);
      }
    };

    // resnet: its c4 cotangent is d, which the residual also hands to u
    const int br[1] = {BR};
    DJob tr = job(M, E_GELU_BWD, dh[BR][2], M, term(d, C, 0, w[BR][W4], C, 1));
    back(br, 1, &tr);
    DJob ju = job(C, E_GELU_BWD, du, C, term(dh[BR][0], M, 0, wc[BR][W1], M, 1));
    ju.z = in(U) + l * RC;
    ju.base = d;
    launch_dgemm<M, kBF16>(g, &ju, 1, s);

    constexpr int RB = kZThreads / LD;
    launch_kernel(z_bwd<C, LD>, dim3((g.R + RB - 1) / RB), kZThreads, (LD + RB) * (C + 1) * 4,
                  s, du, in(WBASE + WZ) + l * D::stride(WZ, k), in(POST) + l * RP,
                  in(EPS) + l * RZ, in(GPOST) + l * RP, dpost, out(ZS) + l * RZ, g.R);

    // p, m, q, independent given du and dpost
    const int bpmq[3] = {BP, BM, BQ};
    DJob top[3] = {
        job(M, E_GELU_BWD, dh[BP][2], M, term(dpost, 2 * LD, 0, w[BP][W4], 2 * LD, 1)),
        job(M, E_GELU_BWD, dh[BM][2], M,
            term(in(GMASK) + l * R * D::MW, D::MW, 0, w[BM][W4], D::MW, 1)),
        job(M, E_GELU_BWD, dh[BQ][2], M,
            term(in(GPRIOR) + l * RP, 2 * LD, 0, w[BQ][W4], D::QW, 1))};
    top[2].t[top[2].nt++] = term(du, C, 0, w[BQ][W4] + 2 * LD, D::QW, 1);
    back(bpmq, 3, top);

    // dacts, dmacts and the next d
    DJob da[3] = {
        job(C, E_GELU_BWD, out(DACTS), C,
            term(dh[BP][0], M, 0, wc[BP][W1] + (size_t)C * M, M, 1)),
        job(C, E_GELU_BWD, out(DMACTS), C,
            term(dh[BM][0], M, 0, wc[BM][W1] + (size_t)C * M, M, 1)),
        job(C, E_GELU_BWD, l ? dxs + (l - 1) * RC : out(DX0), C,
            term(dh[BP][0], M, 0, wc[BP][W1], M, 1))};
    da[0].z = in(ACTS);
    da[0].base = first ? nullptr : out(DACTS);
    da[1].z = in(MACTS);
    da[1].base = first ? nullptr : out(DMACTS);
    da[2].t[da[2].nt++] = term(dh[BQ][0], M, 0, wc[BQ][W1], M, 1);
    da[2].z = x;
    da[2].base = du;
    launch_dgemm<M, kBF16>(g, da, 3, s);
  }

  // ---- weight gradients of all levels, three launches, then the splits'
  // sums and the bias gradients, one launch each
  float* p[BWD_NPTR];
  for (int i = 0; i < BWD_NPTR; ++i) p[i] = out(i);
  Grads gr;
  plan_grads<C, M, LD>(g, L, k, p, gr);
  RArgs ra{};
  ra.L = L;
  ra.part = out(PART);
  size_t entries = 0;
  for (int kind = 0; kind < 3; ++kind) {
    launch_wgrad_dt<M>(Grads::bf(kind), g, gr.w[kind], gr.nw[kind], gr.blocks[kind],
                       Grads::taps(kind, k), out(PART), s);
    for (int i = 0; i < gr.nw[kind]; ++i)
      if (gr.w[kind][i].S > 1) {
        const WJob& j = gr.w[kind][i];
        ra.job[ra.nj++] = j;
        entries += (size_t)L * j.taps * j.Kin * j.N;
      }
  }
  if (entries)
    launch_kernel(reduce_parts, dim3((unsigned)((entries + 255) / 256)), 256, 0, s, ra);
  int bias_blocks = 0;
  for (int i = 0; i < gr.bias.nj; ++i) bias_blocks += L * ((gr.bias.job[i].N + 31) / 32);
  launch_kernel(bias_sums, dim3(bias_blocks), kBiasThreads, kBiasThreads * 4, s, gr.bias);
  return (int)cudaGetLastError();
}

template <int C, int M, int LD>
long long part_floats(const int* ints) {
  // sizes only: every pointer a stand-in
  static float stand_in[4];
  float* p[BWD_NPTR];
  for (int i = 0; i < BWD_NPTR; ++i) p[i] = stand_in;
  Grads gr;
  return (long long)plan_grads<C, M, LD>(make_geo(ints), ints[I_L], ints[I_K], p, gr);
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
// the row splits' partial sums of every weight gradient that has more than
// one split; -1 for a geometry it refuses.
extern "C" long long pm_decoder_chain_bwd_part_floats(const int* ints, int nints) {
  if (nints != I_DCOUNT || !dec_geometry_ok(ints)) return -1;
  const int c = ints[I_C], m = ints[I_M], ld = ints[I_LD];
  if (c == 192 && m == 48 && ld == 16) return part_floats<192, 48, 16>(ints);
  if (c == 64 && m == 16 && ld == 8) return part_floats<64, 16, 8>(ints);
  return -1;
}
