// Runs the emulated row kernel (sampler_row_emulated.cpp, the kernel source
// without its entry point, against the emulated sampler_common.cuh) over
// every block of a launch, each block as kBlock std::threads. Entry point as
// pm_sampler_row (F 64 or 128, K a multiple of 128, lpg a divisor of L;
// the build's compute dtype, bf16 where PM_CORE_BF16 = 1), without the
// stream.
#include "sampler_row_emulated.cpp"

EMU_GLOBALS(smem)

using pmk::cdt;

extern "C" int emu_sampler_row(
    const cdt* wa, const float* ba, const cdt* wb, const float* bb,
    const cdt* cp, const cdt* prevh, const cdt* prevm, const cdt* aux,
    const cdt* hup, const cdt* e1, const float* gumbel, const cdt* emb,
    const cdt* lw, const float* lb, const cdt* hlw, const float* hlb,
    cdt* outh, cdt* outm, int* outs, float* outl, int L, int W, int n,
    int K, int F, int lpg) {
  if (W < 1 || n < 1 || L < 2 || L % 2 || K < 128 || K % 128 || (F != 64 && F != 128) ||
      lpg < 1 || L % lpg)
    return 1;
  const RowArgs p{wa,  ba,  wb,  bb,  cp,   prevh, prevm, aux,  hup, e1, gumbel,
                  emb, lw,  lb,  hlw, hlb,  outh,  outm,  outs, outl, L,  W,
                  n,   K,  lpg};
  const int blocks = (n + TS - 1) / TS;
  auto run = [&](auto kernel) {
    emu_launch(blocks, kBlock, kConsumers, sizeof(smem), [&p, kernel] { kernel(p); });
  };
  const bool wide = K % 256 == 0;
  if (F == 64)
    wide ? run(row_kernel<64, 256>) : run(row_kernel<64, 128>);
  else
    wide ? run(row_kernel<128, 256>) : run(row_kernel<128, 128>);
  return 0;
}
