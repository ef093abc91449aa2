// Runs the gated chain's GEMM kernels (gated_common.cuh's data_gemm,
// gated_levels.cuh's wgrad and reduce_splits), emulated, over every block of
// a launch, each block as kThreads std::threads; a build with
// -DPM_CORE_BF16=1 runs their bf16 path. The headers here are the
// emulated copies (PTX helpers replaced, dynamic shared memory the array
// below, gated_levels.cuh cut before its launches).
#include <cuda_runtime.h>

alignas(64) float smem[232448 / 4];

#include "gated_levels.cuh"

EMU_GLOBALS(smem)

using namespace gsk;

// data_gemm<N> over all rows of a B x H x W grid; term i reads srcs[i] and
// ws[i] with (C, K, mode, dy, dx, ld, trans) = ints[7 i .. 7 i + 6]. N is
// F or 2F of a built width: 64, 128 or 256. xres, z, base2, out2, the
// weights and the sources of concat_elu terms are of the build's compute
// dtype (cdt), as out is with out_c (always for E_BIAS and E_GATE); else out
// is float32, rounded to the compute dtype with `round`.
extern "C" int emu_data_gemm(int N, int B, int H, int W, int nt, const void* const* srcs,
                             const void* const* ws, const int* ints, uint32_t key,
                             uint32_t thresh, float inv_keep, int drop, int epi,
                             const float* bias, const float* proj, const void* xres,
                             const void* z, const float* base1, const void* base2,
                             void* out, void* out2, int out_c, int round) {
  if ((N != 64 && N != 128 && N != 256) || nt < 1 || nt > kMaxTerms) return 1;
  DataArgs a{};
  a.g = Geo{B * H * W, B, H, W, H * W};
  for (int i = 0; i < nt; ++i) {
    const int* t = ints + 7 * i;
    a.t[i] = Term{srcs[i], ws[i], t[0], t[1], t[2], t[3], t[4], t[5], t[6]};
  }
  a.nt = nt;
  a.key = key;
  a.thresh = thresh;
  a.inv_keep = inv_keep;
  a.drop = drop;
  a.epi = epi;
  a.bias = bias;
  a.proj = proj;
  a.xres = static_cast<const cdt*>(xres);
  a.z = static_cast<const cdt*>(z);
  a.base1 = base1;
  a.base2 = static_cast<const cdt*>(base2);
  if (out_c)
    a.outc = static_cast<cdt*>(out);
  else
    a.out = static_cast<float*>(out);
  a.round = round;
  a.out2 = static_cast<cdt*>(out2);
  const int blocks = (a.g.R + kBM - 1) / kBM;
  if (N == 64)
    emu_launch(blocks, kThreads, kThreads, smem_bytes<64>(), [&a] { data_gemm<64>(a); });
  else if (N == 128)
    emu_launch(blocks, kThreads, kThreads, smem_bytes<128>(), [&a] { data_gemm<128>(a); });
  else
    emu_launch(blocks, kThreads, kThreads, smem_bytes<256>(), [&a] { data_gemm<256>(a); });
  return 0;
}

// wgrad<N> for L levels of C = F channels (a built width; N = F or 2F)
// over a B x H x W grid with the taps (skh, skw, pad_top, pad_left) =
// taps4, in S splits of `rows` rows; with S > 1 the partials go through
// `part` and reduce_splits (run serially: it has no barriers).
extern "C" int emu_wgrad(int F, int N, int L, int B, int H, int W, const int* taps4, int drop,
                         uint32_t seed, uint32_t thresh, int base, int sub, float inv_keep,
                         const void* const* srcs, float* const* outs, const float* g,
                         float* part, int S, int rows) {
  if (!width_built(F) || (N != F && N != 2 * F) || L < 1 || L > kMaxLevels || S < 1 ||
      !taps_ok(taps4[0], taps4[1], taps4[2], taps4[3]))
    return 1;
  WgArgs a{};
  for (int l = 0; l < L; ++l) {
    a.src.p[l] = static_cast<const cdt*>(srcs[l]);
    a.out.p[l] = outs[l];
  }
  a.g = g;
  a.part = part;
  a.C = F;
  a.drop = drop;
  a.S = S;
  a.rows = rows;
  a.taps = make_taps(taps4[0], taps4[1], taps4[2], taps4[3]);
  a.geo = Geo{B * H * W, B, H, W, H * W};
  a.seed = seed;
  a.thresh = thresh;
  a.base = base;
  a.sub = sub;
  a.inv_keep = inv_keep;
  const int gx = 2 * F / kBM, gy = a.taps.n, gz = L * S;
  if (N == 64)
    emu_launch_grid(gx, gy, gz, kThreads, kThreads, smem_bytes<64>(), [&a] { wgrad<64>(a); });
  else if (N == 128)
    emu_launch_grid(gx, gy, gz, kThreads, kThreads, smem_bytes<128>(),
                    [&a] { wgrad<128>(a); });
  else
    emu_launch_grid(gx, gy, gz, kThreads, kThreads, smem_bytes<256>(),
                    [&a] { wgrad<256>(a); });
  if (S > 1) {
    const size_t n = (size_t)a.taps.n * 2 * F * N;
    blockDim = Dim{256, 1, 1};
    for (size_t idx = 0; idx < (size_t)L * n; ++idx) {
      blockIdx = Dim{unsigned(idx / 256), 0, 0};
      threadIdx = Dim{unsigned(idx % 256), 0, 0};
      reduce_splits(part, a.out, L, S, n);
    }
  }
  return 0;
}
