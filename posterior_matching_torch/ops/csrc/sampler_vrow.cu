// Vertical-stack kernel of the PixelCNN row sampler.
//
// Replaces posterior_matching_tpu/ops/sampler_chain.py::_vrow_kernel_factory
// (Pallas, grid (L,), pallas_call at :557). For one image row it computes
// v_init and h_init_up from the code embeddings of rows r-2 and r-1, then the
// L gated vertical levels: a = [shift3(celu(in_prev)), shift3(celu(in_cur))]
// @ wav (+ celu(skip) @ waux on down levels), m = celu(a),
// b = [shift3(m_prev), shift3(m)] @ wbv + cond projection,
// out = in_cur + sigmoid(gate) * act.
//
// Bound: operations. At the flagship shapes (rows W*n = 16*320, F = 128,
// L = 24) one launch is 2*W*n*L*(12F*F + 12F*2F + 2F*F) ~ 153 GFLOP of float32
// FMAs against ~25 MB of weights and ~200 MB of row tensors.
//
// Design. The Pallas kernel walks levels as a sequential grid and keeps the
// carry and skip stack in VMEM. Here the n sample chains are independent, so
// each block owns TS = 32 / W samples across all W columns (32 row slots) and
// runs the level loop itself: the +-1 column shifts stay inside the block.
// Each level is two (three on down levels) block GEMMs whose A operand is
// built on the fly from the shifted, concat_elu'd rows. Carries and the skip
// stack are the kernel's own outputs in global memory (L2-resident at these
// sizes), written and re-read by the same block between __syncthreads, so
// they are read with plain loads, never through the read-only path.
#include "sampler_common.cuh"

namespace {

using namespace pmk;

constexpr int F = kF;
constexpr int M = 32;  // row slots per block: slot r = column (r / TS), sample (r % TS)

struct VrowArgs {
  const float *e2, *e1, *pv0, *pv, *pm, *cpv;
  const float *viw, *vib, *huw, *hub, *wav, *bav, *wbv, *bbv, *waux;
  float *outv, *outm, *v0, *hup;
  int L, W, n, TS;
};

__global__ void __launch_bounds__(kThreads) vrow_kernel(const VrowArgs p) {
  __shared__ __align__(16) float sA[kKC * (M + 4)];
  __shared__ __align__(16) float sW[kKC * 2 * F];
  using T1 = Tile<M, F, 4, 4>;      // N = F products
  using T2 = Tile<M, 2 * F, 4, 8>;  // N = 2F products
  const int TS = p.TS, W = p.W, n = p.n, L = p.L, R = p.L / 2;
  const int j0 = blockIdx.x * TS;
  const size_t lvF = (size_t)W * n * F;  // one level of an [L, W, n, F] tensor

  // Slot r's sample, clamped into range for loads (unused slots compute
  // throw-away values; samples never interact).
  auto smp = [&](int r) { return min(j0 + r % TS, n - 1); };
  auto stored = [&](int r) { return r / TS < W && j0 + r % TS < n; };
  // Offset of (column c, sample j) in a [W, n, C] tensor.
  auto off = [&](int c, int j, int C) { return ((size_t)c * n + j) * C; };
  // Element k of a [W, n, C] tensor at slot r's column + dx; zero off the row.
  auto at = [&](const float* X, int C, int r, int dx, int k) -> float {
    const int c = r / TS + dx;
    return (c < 0 || c >= W) ? 0.f : X[off(c, smp(r), C) + k];
  };
  // concat_elu of a [W, n, F] tensor's row at slot r's column + dx.
  auto celu = [&](const float* X, int r, int dx, int k) -> float {
    const int c = r / TS + dx;
    return (c < 0 || c >= W) ? 0.f : celu_at(X + off(c, smp(r), F), k, F);
  };

  // ---- v_init (rows r-2, r-1) and h_init_up (row r-1) --------------------
  {
    float acc[4][4];
    zero(acc);
    gemm_acc<M, F, 4, 4>(
        acc,
        [&](int r, int k) {
          const int seg = k / F;  // taps (-2,-1..1), (-1,-1..1)
          return at(seg < 3 ? p.e2 : p.e1, F, r, seg % 3 - 1, k % F);
        },
        6 * F, p.viw, F, sA, sW);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = T1::row(i);
      if (!stored(r)) continue;
      float* dst = p.v0 + off(r / TS, j0 + r % TS, F);
#pragma unroll
      for (int u = 0; u < 4; ++u) dst[T1::col(u)] = acc[i][u] + p.vib[T1::col(u)];
    }
    zero(acc);
    gemm_acc<M, F, 4, 4>(
        acc,
        [&](int r, int k) { return at(p.e1, F, r, k / F - 1, k % F); },
        3 * F, p.huw, F, sA, sW);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = T1::row(i);
      if (!stored(r)) continue;
      float* dst = p.hup + off(r / TS, j0 + r % TS, F);
#pragma unroll
      for (int u = 0; u < 4; ++u) dst[T1::col(u)] = acc[i][u] + p.hub[T1::col(u)];
    }
  }
  __syncthreads();

  // ---- the L gated vertical levels ----------------------------------------
  for (int l = 0; l < L; ++l) {
    const float* in_prev = l == 0 ? p.pv0 : p.pv + (l - 1) * lvF;
    const float* in_cur = l == 0 ? p.v0 : p.outv + (l - 1) * lvF;
    const float* m_prev = p.pm + l * 2 * lvF;
    float* outv_l = p.outv + l * lvF;
    float* outm_l = p.outm + l * 2 * lvF;

    float a[4][4];
    zero(a);
    gemm_acc<M, F, 4, 4>(
        a,
        [&](int r, int k) {
          const int seg = k / (2 * F);  // taps (-1,-1..1), (0,-1..1)
          return celu(seg < 3 ? in_prev : in_cur, r, seg % 3 - 1, k % (2 * F));
        },
        12 * F, p.wav + (size_t)l * 12 * F * F, F, sA, sW);
    if (l >= R) {
      // down level: skip = the vertical stack entry 2R-1-l of this row
      // (entry 0 is v0, entry k >= 1 the output of level k-1)
      const int s = 2 * R - 1 - l;
      const float* skip = s == 0 ? p.v0 : p.outv + (s - 1) * lvF;
      gemm_acc<M, F, 4, 4>(
          a, [&](int r, int k) { return celu(skip, r, 0, k); }, 2 * F,
          p.waux + (size_t)l * 2 * F * F, F, sA, sW);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = T1::row(i);
      if (!stored(r)) continue;
      float* dst = outm_l + off(r / TS, j0 + r % TS, 2 * F);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = T1::col(u);
        const float v = a[i][u] + p.bav[l * F + c];
        dst[c] = elu(v);
        dst[c + F] = elu(-v);
      }
    }
    __syncthreads();

    float b[4][8];
    zero(b);
    gemm_acc<M, 2 * F, 4, 8>(
        b,
        [&](int r, int k) {
          const int seg = k / (2 * F);
          return at(seg < 3 ? m_prev : outm_l, 2 * F, r, seg % 3 - 1,
                    k % (2 * F));
        },
        12 * F, p.wbv + (size_t)l * 12 * F * 2 * F, 2 * F, sA, sW);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = T2::row(i);
      if (!stored(r)) continue;
      const int j = j0 + r % TS;
      const size_t o = off(r / TS, j, F);
      const float* cp = p.cpv + ((size_t)l * n + j) * 2 * F;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = T2::col(u);  // act column; its gate is c + F
        const float act = b[i][u] + p.bbv[l * 2 * F + c] + cp[c];
        const float gate = b[i][u + 4] + p.bbv[l * 2 * F + c + F] + cp[c + F];
        outv_l[o + c] = in_cur[o + c] + sigmoid(gate) * act;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Launches one image row. Tensors are float32, contiguous, on the device of
// `stream`; shapes as in posterior_matching_torch/ops/sampler_chain.py::
// vrow_plain with F = 128. Returns cudaGetLastError() after the launch.
extern "C" int pm_sampler_vrow(
    const float* e2, const float* e1, const float* pv0, const float* pv,
    const float* pm, const float* cpv, const float* viw, const float* vib,
    const float* huw, const float* hub, const float* wav, const float* bav,
    const float* wbv, const float* bbv, const float* waux, float* outv,
    float* outm, float* v0, float* hup, int L, int W, int n, void* stream) {
  if (W < 1 || W > M || n < 1 || L < 2 || L % 2) return (int)cudaErrorInvalidValue;
  VrowArgs p{e2,  e1,  pv0, pv,   pm,   cpv,  viw, vib, huw, hub, wav,
             bav, wbv, bbv, waux, outv, outm, v0,  hup, L,   W,   n,   M / W};
  const int blocks = (n + p.TS - 1) / p.TS;
  vrow_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
