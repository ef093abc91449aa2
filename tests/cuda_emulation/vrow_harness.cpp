// Runs the emulated vertical-stack kernel (sampler_vrow_emulated.cpp, the
// kernel source without its entry point, against the emulated
// sampler_common.cuh) over every block of a launch, each block as kBlock
// std::threads. Entry point as pm_sampler_vrow (F 64 or 128; the build's
// compute dtype, bf16 where PM_CORE_BF16 = 1), without the stream.
#include "sampler_vrow_emulated.cpp"

EMU_GLOBALS(smem)

using pmk::cdt;

extern "C" int emu_sampler_vrow(
    const cdt* e2, const cdt* e1, const cdt* pv0, const cdt* pv,
    const cdt* pm, const cdt* cpv, const cdt* viw, const float* vib,
    const cdt* huw, const float* hub, const cdt* wav, const float* bav,
    const cdt* wbv, const float* bbv, const cdt* waux, cdt* outv,
    cdt* outm, cdt* v0, cdt* hup, int L, int W, int n, int F) {
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
