// Runs the emulated row kernel (sampler_row_emulated.cpp, the kernel source
// with its PTX helpers replaced) over every block of a launch, each block as
// kBlock std::threads. Entry point as pm_sampler_row, without the stream.
#include "sampler_row_emulated.cpp"

#include <vector>

thread_local Dim threadIdx, blockIdx;
std::barrier<>* g_block_bar;
std::barrier<>* g_consumer_bar;
std::barrier<>* g_warp_bar[32];
char* g_smem_base = reinterpret_cast<char*>(smem);
float g_shfl[1024 * 2];
EmuBar g_bars[64];
std::mutex g_bar_mu;

extern "C" int emu_sampler_row(
    const float* wa, const float* ba, const float* wb, const float* bb,
    const float* cp, const float* prevh, const float* prevm, const float* aux,
    const float* hup, const float* e1, const float* gumbel, const float* emb,
    const float* lw, const float* lb, const float* hlw, const float* hlb,
    float* outh, float* outm, int* outs, float* outl, int L, int W, int n,
    int K) {
  if (W < 1 || n < 1 || L < 2 || L % 2 || K < NC || K % NC) return 1;
  const RowArgs p{wa,  ba,  wb,  bb,  cp,   prevh, prevm, aux,  hup, e1, gumbel,
                  emb, lw,  lb,  hlw, hlb,  outh,  outm,  outs, outl, L,  W,
                  n,   K};
  for (int b = 0; b < (n + TS - 1) / TS; ++b) {
    std::memset(smem, 0xff, sizeof(smem));  // NaNs: stale reads show
    std::barrier<> block(kBlock), consumers(kConsumers);
    std::vector<std::barrier<>*> warps;
    for (int w = 0; w < kBlock / 32; ++w) warps.push_back(g_warp_bar[w] = new std::barrier<>(32));
    g_block_bar = &block;
    g_consumer_bar = &consumers;
    std::vector<std::thread> threads;
    for (int t = 0; t < kBlock; ++t)
      threads.emplace_back([&p, t, b] {
        threadIdx.x = t;
        blockIdx.x = b;
        row_kernel(p);
      });
    for (auto& t : threads) t.join();
    for (auto* w : warps) delete w;
  }
  return 0;
}
