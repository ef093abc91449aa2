// A CPU stand-in for the CUDA pieces that csrc/sampler_row.cu uses, so the
// kernel's indexing, barriers and weight ring can be tested without a GPU
// (tests/test_torch_row_kernel_emulated.py). A block runs as one
// std::thread per CUDA thread, one block at a time: __syncthreads, the named
// barrier and __syncwarp are std::barriers; an mbarrier is a side-table entry
// keyed by its shared-memory offset; a bulk copy lands when it is issued and
// counts its bytes against the mbarrier. The PTX helpers of the kernel are
// replaced by calls to the emu_* functions here before it is compiled.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x)
#define __shared__

struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct Dim { unsigned x; };
typedef int cudaError_t;
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

extern thread_local Dim threadIdx, blockIdx;
extern std::barrier<>* g_block_bar;     // every thread of the block
extern std::barrier<>* g_consumer_bar;  // the named barrier's threads
extern std::barrier<>* g_warp_bar[32];  // one per warp
extern char* g_smem_base;               // the kernel's shared memory

inline void __syncthreads() { g_block_bar->arrive_and_wait(); }
inline void __syncwarp() { g_warp_bar[threadIdx.x / 32]->arrive_and_wait(); }
inline void emu_consumer_sync() { g_consumer_bar->arrive_and_wait(); }
inline float __ldg(const float* p) { return *p; }
inline float4 __ldg(const float4* p) { return *p; }
inline int min(int a, int b) { return a < b ? a : b; }
inline void __trap() {
  std::fprintf(stderr, "emulated kernel: trap\n");
  std::abort();
}

extern float g_shfl[1024 * 2];
template <class T>
T __shfl_xor_sync(unsigned, T v, int d) {
  T* buf = reinterpret_cast<T*>(g_shfl);
  buf[threadIdx.x] = v;
  __syncwarp();
  const T r = buf[(threadIdx.x & ~31u) | ((threadIdx.x & 31u) ^ d)];
  __syncwarp();
  return r;
}

inline size_t __cvta_generic_to_shared(const void* p) {
  return static_cast<const char*>(p) - g_smem_base;
}

// An mbarrier: arrivals pending in this phase, bytes pending, the phase.
struct EmuBar {
  int count = 0, pend = 0;
  long tx = 0;
  std::atomic<unsigned> phase{0};
};
extern EmuBar g_bars[64];
extern std::mutex g_bar_mu;
inline EmuBar& emu_bar(uint32_t off) { return g_bars[(off / 8) % 64]; }
inline void emu_flip_if_done(EmuBar& b) {
  if (b.pend == 0 && b.tx == 0) {
    b.pend = b.count;
    b.phase ^= 1u;
  }
}
inline void emu_mbar_init(uint32_t bar, uint32_t count) {
  std::lock_guard<std::mutex> g(g_bar_mu);
  EmuBar& b = emu_bar(bar);
  b.count = b.pend = static_cast<int>(count);
  b.tx = 0;
  b.phase = 0;
}
inline void emu_arrive(uint32_t bar) {
  std::lock_guard<std::mutex> g(g_bar_mu);
  EmuBar& b = emu_bar(bar);
  b.pend -= 1;
  emu_flip_if_done(b);
}
inline void emu_expect_tx(uint32_t bar, uint32_t bytes) {
  std::lock_guard<std::mutex> g(g_bar_mu);
  EmuBar& b = emu_bar(bar);
  b.tx += bytes;
  b.pend -= 1;
  emu_flip_if_done(b);
}
inline void emu_bulk(uint32_t dst, const float* src, uint32_t bytes, uint32_t bar) {
  std::memcpy(g_smem_base + dst, src, bytes);
  std::lock_guard<std::mutex> g(g_bar_mu);
  EmuBar& b = emu_bar(bar);
  b.tx -= bytes;
  emu_flip_if_done(b);
}
// mbarrier.try_wait.parity: true once the phase of that parity completed.
// A wait that lasts a minute (a parity mistake) aborts the test's process
// instead of hanging it.
inline bool emu_try_wait(uint32_t bar, uint32_t parity) {
  static thread_local bool waiting = false;
  static thread_local std::chrono::steady_clock::time_point since;
  if (emu_bar(bar).phase.load() != parity) {
    waiting = false;
    return true;
  }
  const auto now = std::chrono::steady_clock::now();
  if (!waiting) {
    waiting = true;
    since = now;
  } else if (now - since > std::chrono::seconds(60)) {
    std::fprintf(stderr, "emulated kernel: an mbarrier wait does not end\n");
    std::abort();
  }
  std::this_thread::yield();
  return false;
}
