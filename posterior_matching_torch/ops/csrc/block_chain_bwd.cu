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
// the encoder's res-28 run of a training step, 0.11 ms as 3 TF32 products
// at the H100's 495 TFLOP/s (NVIDIA's data sheet; the core's way), 0.26 ms
// as float32 FMAs at 67, against ~0.13 GB read and written (0.04 ms at
// 3.35 TB/s).
//
// Design. The TPU kernel carries d through VMEM across its sequential grid
// and accumulates dW in resident output blocks. On Hopper the data-gradient
// phases are launches over all rows, level by level, top level first, on
// vdvae_gemm.cuh's core (dgemm: 3xTF32 mma.sync, the mirrored conv taps
// read from one slab staged with its halo, gelu's derivative recomputed
// from the saves in the epilogue; d's K = C in slabs of M, dx's N = C as
// column tiles of M): 4 launches a level, every level's dh1, dh2, dh3 and d
// kept in scratch. The weight gradients of all levels then run as two
// launches: the c2/c3 stacks (wgrad_taps at k = 3: a block's source chunk
// gathered through gelu once for the nine taps, the cotangent rows staged
// with their halo) and the c1/c4 stacks (wgrad; at k = 1 the c2/c3 stacks
// join them), over fixed row splits that one reduce_parts launch adds, and
// every bias gradient is one bias_sums launch: fixed splits and orders, no
// atomics, so equal inputs give equal gradients on every run. In the bf16
// build, as the Pallas kernel (:334-383), gelu and its derivative are
// recomputed from the rounded h saves, the c1..c3 data and weight gradients
// are bf16 products (the cotangent rounded to bf16 as it enters one) with
// float32 sums, and d @ w4^T and dw4 stay float32 (3xTF32); dw4 then has a
// launch of its own, apart from the bf16 1x1 stacks.
#include "block_chain_common.cuh"

namespace {

using namespace bck;

enum BwdPtr {
  G, X0, XOUT, H1, H2, H3, W1, W2, W3, W4,
  DX0, DW1, DB1, DW2, DB2, DW3, DB3, DW4, DB4,
  DXS, DH1, DH2, DH3, PART, BWD_NPTR
};

// The weight-gradient products of a run in two launches (0: the c2/c3
// stacks, through wgrad_taps at k = 3; 1: the c1/c4 stacks, and at k = 1
// the c2/c3 stacks too; in the bf16 build the float32 c4 stack is launch 2)
// and its bias gradients, from the entry point's pointers `p` (any
// non-null stand-ins where only the sizes are wanted). Returns the floats
// of `part` the row splits need.
struct Grads {
  WJob w[3][kMaxWJobs];
  int nw[3], blocks[3];
  BArgs bias;
  // launches 0 and 1 are bf16 products in the bf16 build
  static bool bf(int kind) { return kBF16 && kind < 2; }
};

template <int C, int M>
size_t plan_grads(const Geo& g, int L, int k, float* const* p, Grads& gr) {
  const size_t R = g.R, RC = R * C, RM = R * M;
  const int taps = k * k;
  auto wj = [&](int kind, const float* src0, const void* src, int s16, size_t lsrc, int Kin,
                int tp, const float* gs, size_t lg, int N, float* out) {
    WJob j{};
    j.src0 = src0;
    j.src = src;
    j.s16 = s16;
    j.lsrc = lsrc;
    j.gelu = 1;
    j.Kin = Kin;
    j.taps = tp;
    j.gs = gs;
    j.lg = lg;
    j.ldg = (int)(lg / R);
    j.N = N;
    j.out = out;
    j.lout = (size_t)tp * Kin * N;
    j.ldo = N;
    gr.w[kind][gr.nw[kind]++] = j;
  };
  gr.nw[0] = gr.nw[1] = gr.nw[2] = 0;
  // dw2, dw3: the shifted gelu(h1), gelu(h2) against dh2, dh3
  const int kt = k == 3 ? 0 : 1;
  wj(kt, nullptr, p[H1], kBF16, RM, M, taps, p[DH2], RM, M, p[DW2]);
  wj(kt, nullptr, p[H2], kBF16, RM, M, taps, p[DH3], RM, M, p[DW3]);
  // dw1: gelu(level input)^T dh1, the input x0 at level 0, else xout[l - 1];
  // dw4: gelu(h3)^T d
  wj(1, p[X0], p[XOUT], 0, RC, C, 1, p[DH1], RM, M, p[DW1]);
  wj(kBF16 ? 2 : 1, nullptr, p[H3], kBF16, RM, M, 1, p[DXS], RC, C, p[DW4]);

  size_t pofs = 0;
  for (int kind = 0; kind < 3; ++kind)
    gr.blocks[kind] =
        gr.nw[kind] ? plan_wgrad<M>(g, L, gr.w[kind], gr.nw[kind], kind == 0, &pofs) : 0;

  // the biases: column sums of dh1..dh3 and of d
  BArgs& ba = gr.bias;
  ba = BArgs{};
  ba.L = L;
  ba.R = g.R;
  auto bj = [&](const float* gs, size_t lg, int N, float* out) {
    ba.job[ba.nj++] = BJob{gs, out, lg, (size_t)N, (int)(lg / R), N};
  };
  bj(p[DH1], RM, M, p[DB1]);
  bj(p[DH2], RM, M, p[DB2]);
  bj(p[DH3], RM, M, p[DB3]);
  bj(p[DXS], RC, C, p[DB4]);
  return pofs;
}

template <int C, int M>
int run_bwd(const void* const* ptrs, const int* ints, cudaStream_t s) {
  auto in = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto out = [&](int i) { return static_cast<float*>(const_cast<void*>(ptrs[i])); };
  // c1..c3's weights and the saves: of the compute dtype
  auto inc = [&](int i) { return static_cast<const cdt*>(ptrs[i]); };
  const Geo g = make_geo(ints);
  const int L = ints[I_L], k = ints[I_K], taps = k * k;
  const size_t RC = (size_t)g.R * C, RM = (size_t)g.R * M;
  float* dxs = out(DXS);

  // d of the top level is the external cotangent
  cudaError_t err = cudaMemcpyAsync(dxs + (L - 1) * RC, in(G), RC * sizeof(float),
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;

  for (int l = L - 1; l >= 0; --l) {
    const float* d = dxs + l * RC;
    const float* x = l ? in(XOUT) + (l - 1) * RC : in(X0);
    const cdt* h[3] = {inc(H1) + l * RM, inc(H2) + l * RM, inc(H3) + l * RM};
    float* dh[3] = {out(DH1) + l * RM, out(DH2) + l * RM, out(DH3) + l * RM};

    // dh3 = gelu'(h3) * (d @ w4^T)
    DJob j3 = job(M, E_GELU_BWD, dh[2], M, term(d, C, 0, in(W4) + (size_t)l * M * C, C, 1));
    set_z(j3, h[2]);
    launch_dgemm<M>(g, &j3, 1, s);
    // dh2, dh1 back through the mirrored taps of c3, c2
    const int ws[2] = {W2, W3};
    for (int c = 1; c >= 0; --c) {
      DJob jc = job(M, E_GELU_BWD, dh[c], M,
                    term(dh[c + 1], M, 0, inc(ws[c]) + (size_t)l * taps * M * M, M, 1, taps, -1));
      set_z(jc, h[c]);
      launch_dgemm<M, kBF16>(g, &jc, 1, s);
    }
    // dx = d + gelu'(x) * (dh1 @ w1^T): the next level's d (dxs[l - 1], a
    // slice apart from d's dxs[l]), or dx0
    DJob jx = job(C, E_GELU_BWD, l ? dxs + (l - 1) * RC : out(DX0), C,
                  term(dh[0], M, 0, inc(W1) + (size_t)l * C * M, M, 1));
    jx.z = x;
    jx.base = d;
    launch_dgemm<M, kBF16>(g, &jx, 1, s);
  }

  // ---- weight gradients of all levels, two launches (three in the bf16
  // build), then the splits' sums and the bias gradients, one launch each
  float* p[BWD_NPTR];
  for (int i = 0; i < BWD_NPTR; ++i) p[i] = out(i);
  Grads gr;
  plan_grads<C, M>(g, L, k, p, gr);
  RArgs ra{};
  ra.L = L;
  ra.part = out(PART);
  size_t entries = 0;
  for (int kind = 0; kind < 3; ++kind) {
    if (!gr.nw[kind]) continue;
    launch_wgrad_dt<M>(Grads::bf(kind), g, gr.w[kind], gr.nw[kind], gr.blocks[kind], kind == 0,
                       out(PART), s);
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

template <int C, int M>
long long part_floats(const int* ints) {
  // sizes only: every pointer a stand-in
  static float stand_in[4];
  float* p[BWD_NPTR];
  for (int i = 0; i < BWD_NPTR; ++i) p[i] = stand_in;
  Grads gr;
  return (long long)plan_grads<C, M>(make_geo(ints), ints[I_L], ints[I_K], p, gr);
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

// Floats of the `part` scratch pm_block_chain_bwd needs for a geometry: the
// row splits' partial sums of every weight gradient that has more than one
// split; -1 for a geometry it refuses.
extern "C" long long pm_block_chain_bwd_part_floats(const int* ints, int nints) {
  if (nints != I_COUNT || !geometry_ok(ints)) return -1;
  const int c = ints[I_C], m = ints[I_M];
  if (c == 192 && m == 48) return part_floats<192, 48>(ints);
  if (c == 64 && m == 16) return part_floats<64, 16>(ints);
  return -1;
}
