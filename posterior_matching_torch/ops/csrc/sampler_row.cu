// Horizontal per-row kernel of the PixelCNN row sampler.
//
// Replaces posterior_matching_tpu/ops/sampler_chain.py::_row_kernel_factory
// (Pallas, grid (W, L / lpg), pallas_call at :693). For one image row it
// walks the pixels left to right; at each pixel it runs h_init_left, the L
// gated horizontal levels on cached taps (previous image row at columns c-1
// and c, previous pixel), the logits head, argmax(logits + gumbel), and
// embeds the sample for the next pixel.
//
// Bound: operations. At the flagship shapes (n = 320 chains, W = 16,
// F = 128, L = 24, K = 512) one launch is 2*n*W*L*(12F*F + 8F*2F) ~ 113
// GFLOP of float32 FMAs (plus 0.7 GFLOP of logits), on ~45 MB of weights
// read once per pixel-level by every block from L2.
//
// Design. The chain is sequential in pixels and levels but the n sample
// chains are independent, so each block owns TS = 8 samples and runs the
// whole pixel x level loop itself, with the chain value, this level's m and
// the previous sample's embedding in shared memory. Each level is two block
// GEMMs ([8, 12F] @ [12F, F], [8, 8F] @ [8F, 2F]) whose A operand is built
// on the fly from the cached taps with concat_elu fused in. The per-level
// chain inputs and intermediates are the kernel's outputs (outh, outm): they
// are the next pixel's (0,-1) taps, the skips of later levels in the same
// pixel, and the next image row's (-1, *) taps. They are written and re-read
// by the same block between __syncthreads, so they are read with plain
// loads. With n = 320 only 40 blocks run: the launch is far from the card's
// peak, and is kept simple and right first.
#include <climits>
#include <cmath>

#include "sampler_common.cuh"

namespace {

using namespace pmk;

constexpr int F = kF;
constexpr int TS = 8;    // samples per block
constexpr int NC = 256;  // logits columns per GEMM chunk

struct RowArgs {
  const float *wa, *ba, *wb, *bb, *cp, *prevh, *prevm, *aux, *hup, *e1,
      *gumbel, *emb, *lw, *lb, *hlw, *hlb;
  float *outh, *outm;
  int* outs;
  float* outl;  // logits out, or null
  int L, W, n, K;
};

using TA = Tile<TS, F, 2, 2>;       // N = F products
using TB = Tile<TS, 2 * F, 2, 4>;   // N = 2F products
using TL = Tile<TS, NC, 2, 4>;      // logits chunks

__global__ void __launch_bounds__(kThreads) row_kernel(const RowArgs p) {
  __shared__ __align__(16) float sA[kKC * (TS + 4)];
  __shared__ __align__(16) float sW[kKC * 2 * F];
  __shared__ float s_x[TS][F];      // the chain: this level's input
  __shared__ float s_m[TS][2 * F];  // this level's m = concat_elu(a)
  __shared__ float s_e[TS][F];      // embedding of the previous pixel's sample
  __shared__ float s_bv[TS][TL::TC];
  __shared__ int s_bi[TS][TL::TC];
  __shared__ int s_y[TS];
  static_assert(NC <= 2 * F, "sW holds kKC x 2F floats");

  const int W = p.W, n = p.n, L = p.L, R = p.L / 2, K = p.K;
  const int j0 = blockIdx.x * TS;
  const int tid = threadIdx.x;
  // Slot s's sample, clamped into range for loads (unused slots compute
  // throw-away values; samples never interact).
  auto smp = [&](int s) { return min(j0 + s, n - 1); };
  // Offset of (level l, column c, sample j) in an [L, W, n, C] tensor.
  auto off = [&](int l, int c, int j, int C) {
    return (((size_t)l * W + c) * n + j) * C;
  };
  // Offset of (column c, sample j) in a [W, n, C] tensor.
  auto off2 = [&](int c, int j, int C) { return ((size_t)c * n + j) * C; };

  for (int c = 0; c < W; ++c) {
    // ---- T_0 = h_init_up (from the vrow kernel) + h_init_left's taps
    // (-1,-1) on the previous row's embedding and (0,-1) on the previous
    // sample's, both zero at the first column
    {
      float acc[2][2];
      zero(acc);
      gemm_acc<TS, F, 2, 2>(
          acc,
          [&](int s, int k) -> float {
            if (c == 0) return 0.f;
            return k < F ? p.e1[off2(c - 1, smp(s), F) + k] : s_e[s][k - F];
          },
          2 * F, p.hlw, F, sA, sW);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int s = TA::row(i);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = TA::col(u);
          s_x[s][col] =
              p.hup[off2(c, smp(s), F) + col] + acc[i][u] + p.hlb[col];
        }
      }
    }
    __syncthreads();

    for (int l = 0; l < L; ++l) {
      // this level's input at this pixel: the next pixel's (0,-1) tap, and
      // the skip of level 2R-1-l later in this pixel
      for (int i = tid; i < TS * F; i += kThreads) {
        const int s = i / F, k = i % F;
        if (j0 + s < n) p.outh[off(l, c, j0 + s, F) + k] = s_x[s][k];
      }

      float a[2][2];
      zero(a);
      gemm_acc<TS, F, 2, 2>(
          a,
          [&](int s, int k) -> float {
            const int j = smp(s);
            if (k < 8 * F) {  // taps (-1,-1), (-1,0), (0,-1), (0,0)
              const int kk = k % (2 * F);
              switch (k / (2 * F)) {
                case 0:
                  return c > 0 ? celu_at(p.prevh + off(l, c - 1, j, F), kk, F)
                               : 0.f;
                case 1:
                  return celu_at(p.prevh + off(l, c, j, F), kk, F);
                case 2:
                  return c > 0 ? celu_at(p.outh + off(l, c - 1, j, F), kk, F)
                               : 0.f;
                default:
                  return celu_at(s_x[s], kk, F);
              }
            }
            // aux slot: [elu(p), elu(q), elu(-p), elu(-q)] with p the
            // vertical output and q the skip (zero on up levels)
            const int q = (k - 8 * F) / F, e = (k - 8 * F) % F;
            float v;
            if (q & 1) {
              if (l < R) return 0.f;
              v = p.outh[off(2 * R - 1 - l, c, j, F) + e];
            } else {
              v = p.aux[off(l, c, j, F) + e];
            }
            return elu(q < 2 ? v : -v);
          },
          12 * F, p.wa + (size_t)l * 12 * F * F, F, sA, sW);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int s = TA::row(i);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = TA::col(u);
          const float v = a[i][u] + p.ba[l * F + col];
          s_m[s][col] = elu(v);
          s_m[s][col + F] = elu(-v);
        }
      }
      __syncthreads();
      for (int i = tid; i < TS * 2 * F; i += kThreads) {
        const int s = i / (2 * F), k = i % (2 * F);
        if (j0 + s < n) p.outm[off(l, c, j0 + s, 2 * F) + k] = s_m[s][k];
      }

      float b[2][4];
      zero(b);
      gemm_acc<TS, 2 * F, 2, 4>(
          b,
          [&](int s, int k) -> float {
            const int j = smp(s);
            const int kk = k % (2 * F);
            switch (k / (2 * F)) {
              case 0:
                return c > 0 ? p.prevm[off(l, c - 1, j, 2 * F) + kk] : 0.f;
              case 1:
                return p.prevm[off(l, c, j, 2 * F) + kk];
              case 2:
                return c > 0 ? p.outm[off(l, c - 1, j, 2 * F) + kk] : 0.f;
              default:
                return s_m[s][kk];
            }
          },
          8 * F, p.wb + (size_t)l * 8 * F * 2 * F, 2 * F, sA, sW);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int s = TB::row(i);
        const float* cp = p.cp + ((size_t)l * n + smp(s)) * 2 * F;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = TB::col(u);  // act column; its gate is col + F
          const float act = b[i][u] + p.bb[l * 2 * F + col] + cp[col];
          const float gate =
              b[i][u + 2] + p.bb[l * 2 * F + col + F] + cp[col + F];
          s_x[s][col] += sigmoid(gate) * act;
        }
      }
      __syncthreads();
    }

    // ---- logits head and the Gumbel-argmax sample (ties to the lower index)
    float best[2] = {-INFINITY, -INFINITY};
    int bidx[2] = {INT_MAX, INT_MAX};
    for (int n0 = 0; n0 < K; n0 += NC) {
      float acc[2][4];
      zero(acc);
      gemm_acc<TS, NC, 2, 4>(
          acc, [&](int s, int k) { return elu(s_x[s][k]); }, F, p.lw + n0, K,
          sA, sW);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int s = TL::row(i);
        const size_t o = off2(c, smp(s), K);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int col = n0 + TL::col(u);
          const float lg = acc[i][u] + p.lb[col];
          if (p.outl != nullptr && j0 + s < n) p.outl[o + col] = lg;
          const float v = lg + p.gumbel[o + col];
          if (v > best[i] || (v == best[i] && col < bidx[i])) {
            best[i] = v;
            bidx[i] = col;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s_bv[TL::row(i)][tid % TL::TC] = best[i];
      s_bi[TL::row(i)][tid % TL::TC] = bidx[i];
    }
    __syncthreads();
    if (tid < TS) {
      float bv = s_bv[tid][0];
      int bi = s_bi[tid][0];
      for (int t = 1; t < TL::TC; ++t) {
        const float v = s_bv[tid][t];
        const int ix = s_bi[tid][t];
        if (v > bv || (v == bv && ix < bi)) {
          bv = v;
          bi = ix;
        }
      }
      bi = bi < K ? bi : 0;  // only non-finite logits leave no winner
      s_y[tid] = bi;
      if (j0 + tid < n) p.outs[(size_t)c * n + j0 + tid] = bi;
    }
    __syncthreads();
    for (int i = tid; i < TS * F; i += kThreads) {
      const int s = i / F, k = i % F;
      s_e[s][k] = p.emb[(size_t)s_y[s] * F + k];
    }
    __syncthreads();
  }
}

}  // namespace

// Launches one image row. Tensors are float32 (outs int32), contiguous, on
// the device of `stream`; shapes as in posterior_matching_torch/ops/
// sampler_chain.py::row_plain with F = 128 and K % 256 == 0; outl may be
// null. Returns cudaGetLastError() after the launch.
extern "C" int pm_sampler_row(
    const float* wa, const float* ba, const float* wb, const float* bb,
    const float* cp, const float* prevh, const float* prevm, const float* aux,
    const float* hup, const float* e1, const float* gumbel, const float* emb,
    const float* lw, const float* lb, const float* hlw, const float* hlb,
    float* outh, float* outm, int* outs, float* outl, int L, int W, int n,
    int K, void* stream) {
  if (W < 1 || n < 1 || L < 2 || L % 2 || K < NC || K % NC)
    return (int)cudaErrorInvalidValue;
  RowArgs p{wa,  ba,  wb,  bb,  cp,   prevh, prevm, aux,  hup, e1, gumbel,
            emb, lw,  lb,  hlw, hlb,  outh,  outm,  outs, outl, L,  W,
            n,   K};
  const int blocks = (n + TS - 1) / TS;
  row_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
