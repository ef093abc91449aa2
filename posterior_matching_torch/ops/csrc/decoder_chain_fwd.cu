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
// C = 192, M = 48, LD = 16) about 43 GFLOP, 0.64 ms at 67 TFLOP/s, against
// ~0.4 GB of inputs, outputs and saves (0.12 ms at 3.35 TB/s).
//
// Design. The Pallas kernel walks (chunk, level) in order with the state
// in VMEM. On Hopper each dependent phase is a launch over all rows of the
// run, as in block_chain_fwd.cu: chain_gemm (block_chain_common.cuh) with
// the conv taps and gelu fused into the A operand's load, [x, acts] as two
// terms (no concatenated tensor), and the bias or bias-plus-residual in the
// epilogue. The prior's c4 is two products over column ranges of w4 (the
// head into prior, the tail plus x into u); z_into_state adds the z
// projection to u in place. 18 launches a level. Float32 FMAs without
// tensor cores: fast kernels are later work.
#include "decoder_chain_common.cuh"

namespace {

using namespace dck;

constexpr int WBASE = 4;  // the 34 weight stacks follow x0, acts, macts, eps
enum FwdPtr {
  X0, ACTS, MACTS, EPS,
  XOUT = WBASE + kWeights, POST, PRIOR, MASKED, U,
  SBASE,  // h1, h2, h3 of p, m, q, r
  FWD_NPTR = SBASE + 12
};

// c1..c3 of a Block: h1 = gelu(x) @ w1[:C] (+ gelu(a) @ w1[C:]) + b1, then
// the two k x k convolutions through gelu.
template <int C, int M>
void block_front(const Geo& g, int k, const float* x, const float* a,
                 const float* const* w, float* const* h, cudaStream_t s) {
  GemmArgs p{};
  p.g = g;
  p.amode = A_GELU;
  p.epi = E_BIAS;
  p.t[p.nt++] = Term{x, w[W1], C, 0, 0, M, 0};
  if (a) p.t[p.nt++] = Term{a, w[W1] + (size_t)C * M, C, 0, 0, M, 0};
  p.bias = w[B1];
  p.out = h[0];
  launch_gemm<M>(p, s);
  for (int c = 0; c < 2; ++c) {
    GemmArgs q{};
    q.g = g;
    q.amode = A_GELU;
    q.epi = E_BIAS;
    add_taps(q, k, 1, h[c], M, w[W2 + 2 * c], M, 0);
    q.bias = w[B2 + 2 * c];
    q.out = h[c + 1];
    launch_gemm<M>(q, s);
  }
}

// c4 over N columns of w4 (rows ld wide, starting at w4 and b4): out =
// gelu(h3) @ w4 + b4, plus res when given.
template <int N, int M>
void block_c4(const Geo& g, const float* h3, const float* w4, const float* b4,
              int ld, const float* res, float* out, cudaStream_t s) {
  GemmArgs p{};
  p.g = g;
  p.amode = A_GELU;
  p.epi = res ? E_BIAS_RES : E_BIAS;
  p.t[p.nt++] = Term{h3, w4, M, 0, 0, ld, 0};
  p.bias = b4;
  p.res = res;
  p.out = out;
  launch_gemm<N>(p, s);
}

// u[r][c] += bz[c] + sum_j z[r][j] wz[j][c], with z = loc + (softplus(raw)
// + 1e-5) eps from the level's posterior outputs [loc | raw] and noise.
// A block: kZRows rows, their z staged in shared memory.
constexpr int kZRows = 8;

template <int C, int LD>
__global__ void __launch_bounds__(kThreads)
    z_into_state(const float* __restrict__ post, const float* __restrict__ eps,
                 const float* __restrict__ wz, const float* __restrict__ bz,
                 float* __restrict__ u, int R) {
  __shared__ float sz[kZRows][LD];
  const int r0 = blockIdx.x * kZRows;
  for (int i = threadIdx.x; i < kZRows * LD; i += kThreads) {
    const int r = r0 + i / LD, j = i % LD;
    float z = 0.f;
    if (r < R) {
      const size_t o = (size_t)r * 2 * LD;
      z = post[o + j] + (softplus(post[o + LD + j]) + 1e-5f) * eps[(size_t)r * LD + j];
    }
    sz[i / LD][j] = z;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kZRows * C; i += kThreads) {
    const int rr = i / C, c = i % C, r = r0 + rr;
    if (r >= R) break;
    float acc = bz[c];
#pragma unroll
    for (int j = 0; j < LD; ++j) acc = fmaf(sz[rr][j], wz[j * C + c], acc);
    u[(size_t)r * C + c] += acc;
  }
}

template <int C, int M, int LD>
int run_fwd(const void* const* ptrs, const int* ints, cudaStream_t s) {
  using D = Dims<C, M, LD>;
  auto in = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto out = [&](int i) { return static_cast<float*>(const_cast<void*>(ptrs[i])); };
  const Geo g = make_geo(ints);
  const int L = ints[I_L], k = ints[I_K];
  const size_t R = g.R, RC = R * C, RM = R * M;

  for (int l = 0; l < L; ++l) {
    // level l's eight stacks of Block b, its h1..h3 saves
    const float* w[4][8];
    float* h[4][3];
    for (int b = 0; b < 4; ++b) {
      for (int i = 0; i < 8; ++i)
        w[b][i] = in(WBASE + 8 * b + i) + l * D::stride(8 * b + i, k);
      for (int i = 0; i < 3; ++i) h[b][i] = out(SBASE + 3 * b + i) + l * RM;
    }
    const float* x = l ? in(XOUT) + (l - 1) * RC : in(X0);
    float* post = out(POST) + l * R * 2 * LD;
    float* u = out(U) + l * RC;

    block_front<C, M>(g, k, x, in(ACTS), w[BP], h[BP], s);
    block_c4<2 * LD, M>(g, h[BP][2], w[BP][W4], w[BP][B4], 2 * LD, nullptr, post, s);

    // the masked posterior reads x too; its backward never returns to x
    block_front<C, M>(g, k, x, in(MACTS), w[BM], h[BM], s);
    block_c4<D::MW, M>(g, h[BM][2], w[BM][W4], w[BM][B4], D::MW, nullptr,
                       out(MASKED) + l * R * D::MW, s);

    block_front<C, M>(g, k, x, nullptr, w[BQ], h[BQ], s);
    block_c4<2 * LD, M>(g, h[BQ][2], w[BQ][W4], w[BQ][B4], D::QW, nullptr,
                        out(PRIOR) + l * R * 2 * LD, s);
    block_c4<C, M>(g, h[BQ][2], w[BQ][W4] + 2 * LD, w[BQ][B4] + 2 * LD, D::QW, x, u, s);
    z_into_state<C, LD><<<(g.R + kZRows - 1) / kZRows, kThreads, 0, s>>>(
        post, in(EPS) + l * R * LD, in(WBASE + WZ) + l * D::stride(WZ, k),
        in(WBASE + BZ) + l * D::stride(BZ, k), u, g.R);

    block_front<C, M>(g, k, u, nullptr, w[BR], h[BR], s);
    block_c4<C, M>(g, h[BR][2], w[BR][W4], w[BR][B4], C, u, out(XOUT) + l * RC, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One run. `ptrs` holds FWD_NPTR device pointers in the order of
// ops/decoder_chain.py::_FWD_PTRS, `ints` the geometry of _GEOMETRY.
// Returns cudaGetLastError() after the launches.
extern "C" int pm_decoder_chain_fwd(const void* const* ptrs, int nptrs,
                                    const int* ints, int nints, void* stream_) {
  if (nptrs != FWD_NPTR || nints != I_DCOUNT || !dec_geometry_ok(ints))
    return (int)cudaErrorInvalidValue;
  DCK_DISPATCH_WIDTHS(ints, (run_fwd<C, M, LD>(ptrs, ints, static_cast<cudaStream_t>(stream_))));
}
