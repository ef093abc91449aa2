// Runs the emulated row kernel (sampler_row_emulated.cpp, the kernel source
// without its entry point, against the emulated sampler_common.cuh) over
// every block of a launch, each block as kBlock std::threads. Entry point as
// pm_sampler_row (F 64 or 128, K a multiple of 128), without the stream.
#include "sampler_row_emulated.cpp"

EMU_GLOBALS(smem)

extern "C" int emu_sampler_row(
    const float* wa, const float* ba, const float* wb, const float* bb,
    const float* cp, const float* prevh, const float* prevm, const float* aux,
    const float* hup, const float* e1, const float* gumbel, const float* emb,
    const float* lw, const float* lb, const float* hlw, const float* hlb,
    float* outh, float* outm, int* outs, float* outl, int L, int W, int n,
    int K, int F) {
  if (W < 1 || n < 1 || L < 2 || L % 2 || K < 128 || K % 128 || (F != 64 && F != 128))
    return 1;
  const RowArgs p{wa,  ba,  wb,  bb,  cp,   prevh, prevm, aux,  hup, e1, gumbel,
                  emb, lw,  lb,  hlw, hlb,  outh,  outm,  outs, outl, L,  W,
                  n,   K};
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
