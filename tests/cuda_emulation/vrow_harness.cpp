// Runs the emulated vertical-stack kernel (sampler_vrow_emulated.cpp, the
// kernel source without its entry point, against the emulated
// sampler_common.cuh) over every block of a launch, each block as kBlock
// std::threads. Entry point as pm_sampler_vrow (F 64 or 128), without the
// stream.
#include "sampler_vrow_emulated.cpp"

EMU_GLOBALS(smem)

extern "C" int emu_sampler_vrow(
    const float* e2, const float* e1, const float* pv0, const float* pv,
    const float* pm, const float* cpv, const float* viw, const float* vib,
    const float* huw, const float* hub, const float* wav, const float* bav,
    const float* wbv, const float* bbv, const float* waux, float* outv,
    float* outm, float* v0, float* hup, int L, int W, int n, int F) {
  if (W < 1 || W > 32 || n < 1 || L < 2 || L % 2 || (F != 64 && F != 128)) return 1;
  const int ts = samples_per_block(W);
  const VrowArgs p{e2,  e1,  pv0, pv,   pm,   cpv,  viw, vib, huw, hub, wav,
                   bav, wbv, bbv, waux, outv, outm, v0,  hup, L,   W,   n,   ts};
  if (F == 64)
    emu_launch((n + ts - 1) / ts, kBlock, kBlock, sizeof(smem), [&p] { vrow_kernel<64>(p); });
  else
    emu_launch((n + ts - 1) / ts, kBlock, kBlock, sizeof(smem), [&p] { vrow_kernel<128>(p); });
  return 0;
}
