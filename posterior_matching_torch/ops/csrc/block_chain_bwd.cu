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

// dW[l][t * Kin + i][n] = sum_r gelu(A_l)(r + shift_t, i) * G_l[r][n] over
// the rows of split s, for i in the block's tile; A_l is src's level l (or
// with src0, level l's input: src0 at l = 0, else src's level l - 1).
struct WgArgs {
  const float* src0;
  const float* src;  // [L, R, Kin]
  const float* gs;   // [L, R, N]
  int Kin, k, S;
  float* out;        // S == 1: [L, k*k*Kin, N]; else partials [L, S, ...]
  Geo g;
};

template <int N>
__global__ void __launch_bounds__(kThreads) wgrad(const WgArgs p) {
  using T = Tile<N>;
  constexpr int TM = T::TM, LDA = T::LDA, TN = T::TN;
  constexpr int RP = kThreads / TM;  // rows staged per pass
  __shared__ __align__(16) float sA[kKC * LDA];
  __shared__ __align__(16) float sB[kKC * N];
  const Geo g = p.g;
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * TM, t = blockIdx.y;
  const int l = blockIdx.z / p.S, s = blockIdx.z % p.S;
  const size_t RK = (size_t)g.R * p.Kin;
  const float* src = p.src0 ? (l ? p.src + (l - 1) * RK : p.src0) : p.src + l * RK;
  const float* gl = p.gs + (size_t)l * g.R * N;
  const int pad = p.k / 2;
  const int dy = t / p.k - pad, dx = t % p.k - pad;
  const int rbeg = s * kSplitRows;
  const int rend = min(g.R, rbeg + kSplitRows);
  const int m = tid % TM, kk0 = tid / TM;
  const int i = i0 + m;
  float acc[4][TN];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int u = 0; u < TN; ++u) acc[a][u] = 0.f;

  for (int k0 = rbeg; k0 < rend; k0 += kKC) {
#pragma unroll
    for (int h = 0; h < kKC / RP; ++h) {
      const int kk = kk0 + h * RP;
      const int r = k0 + kk;
      float v = 0.f;
      if (r < rend && i < p.Kin) {
        const int pos = r % g.HW;
        const int yy = pos / g.W + dy, xx = pos % g.W + dx;
        if (yy >= 0 && yy < g.H && xx >= 0 && xx < g.W)
          v = gelu(src[(size_t)(r + dy * g.W + dx) * p.Kin + i]);
      }
      sA[kk * LDA + m] = v;
    }
    for (int q = tid; q < kKC * N; q += kThreads) {
      const int kr = q / N, n = q % N;
      const int r = k0 + kr;
      sB[kr * N + n] = r < rend ? gl[(size_t)r * N + n] : 0.f;
    }
    __syncthreads();
    mma_chunk<N>(acc, sA, sB);
    __syncthreads();
  }
  const int tr = tid / T::NCG, tc = tid % T::NCG;
  const size_t per = (size_t)p.k * p.k * p.Kin * N;
  float* out = p.out + ((size_t)l * p.S + s) * per + (size_t)t * p.Kin * N;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = i0 + tr * 4 + a;
    if (row >= p.Kin) continue;
#pragma unroll
    for (int u = 0; u < TN; ++u) out[(size_t)row * N + tc * TN + u] = acc[a][u];
  }
}

// out[l][j] = sum_s part[l][s][j], in order of s.
__global__ void reduce_splits(const float* __restrict__ part,
                              float* __restrict__ out, int L, int S, size_t n) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)L * n) return;
  const size_t l = idx / n, j = idx % n;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += part[(l * S + s) * n + j];
  out[idx] = acc;
}

// db[l][c] = sum_r G[l][r][c]: block (32 columns, level), 8 row lanes each
// summing every 8th row, then the lanes in order.
__global__ void bias_grad(const float* __restrict__ gs, float* __restrict__ db,
                          int R, int N) {
  __shared__ float part[8][32];
  const int col = threadIdx.x % 32, lane = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + col, l = blockIdx.y;
  float acc = 0.f;
  if (c < N)
    for (int r = lane; r < R; r += 8) acc += gs[((size_t)l * R + r) * N + c];
  part[lane][col] = acc;
  __syncthreads();
  if (lane == 0 && c < N) {
    float s = 0.f;
    for (int j = 0; j < 8; ++j) s += part[j][col];
    db[(size_t)l * N + c] = s;
  }
}

template <int N>
void weight_grad(const WgArgs& base, float* dw, float* part, int L,
                 cudaStream_t stream) {
  WgArgs a = base;
  a.out = a.S == 1 ? dw : part;
  const dim3 grid((a.Kin + Tile<N>::TM - 1) / Tile<N>::TM, a.k * a.k, L * a.S);
  wgrad<N><<<grid, kThreads, 0, stream>>>(a);
  if (a.S > 1) {
    const size_t n = (size_t)a.k * a.k * a.Kin * N;
    const size_t total = (size_t)L * n;
    reduce_splits<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(part, dw, L, a.S, n);
  }
}

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
  w.S = n_splits(g);
  // dw1: gelu(level input)^T dh1
  w.src0 = in(X0); w.src = in(XOUT); w.gs = out(DH1); w.Kin = C; w.k = 1;
  weight_grad<M>(w, out(DW1), out(PART), L, stream);
  // dw2, dw3: shifted gelu(h1), gelu(h2) against dh2, dh3
  w.src0 = nullptr; w.src = in(H1); w.gs = out(DH2); w.Kin = M; w.k = k;
  weight_grad<M>(w, out(DW2), out(PART), L, stream);
  w.src = in(H2); w.gs = out(DH3);
  weight_grad<M>(w, out(DW3), out(PART), L, stream);
  // dw4: gelu(h3)^T d
  w.src = in(H3); w.gs = dxs; w.k = 1;
  weight_grad<C>(w, out(DW4), out(PART), L, stream);

  bias_grad<<<dim3((M + 31) / 32, L), 256, 0, stream>>>(out(DH1), out(DB1), g.R, M);
  bias_grad<<<dim3((M + 31) / 32, L), 256, 0, stream>>>(out(DH2), out(DB2), g.R, M);
  bias_grad<<<dim3((M + 31) / 32, L), 256, 0, stream>>>(out(DH3), out(DB3), g.R, M);
  bias_grad<<<dim3((C + 31) / 32, L), 256, 0, stream>>>(dxs, out(DB4), g.R, C);
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
