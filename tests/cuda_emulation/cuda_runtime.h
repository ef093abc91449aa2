// A CPU stand-in for the CUDA pieces that csrc/sampler_row.cu,
// csrc/sampler_vrow.cu, csrc/vq_search.cu, the gated chain's GEMM kernels
// (csrc/gated_common.cuh, gated_levels.cuh) and the VDVAE chains' entry
// points (csrc/decoder_chain_{fwd,bwd}.cu and block_chain_{fwd,bwd}.cu on
// vdvae_gemm.cuh, whose launch_kernel the emulation turns into
// emu_launch_grid, with the host
// calls they make: stream copies, attributes) use, so the kernels' indexing,
// barriers, operand rings and fragment layouts can be tested without a GPU
// (tests/test_torch_*_kernel_emulated.py). A block runs one at a time, each
// CUDA thread a fiber (ucontext) of the launching thread, switched
// cooperatively: a fiber runs until it waits, at __syncthreads, the named
// barrier, __syncwarp (barriers counted by phase) or an mbarrier's
// try_wait, and the launch's fibers take turns in thread order. So a launch
// takes one CPU whatever its block size: as one std::thread per CUDA
// thread, a block's hundreds of threads met at a barrier every few
// operations and spun against one another and against the other test
// processes of a parallel run (on an 8-core host a wgrad case took 49-59 s
// on all cores, 17 s pinned to one; a decoder chain case 200 s against 27
// s; tests/test_torch_gated_wgrad_emulated.py and
// tests/test_torch_decoder_kernel_emulated.py alone). An mbarrier is a
// side-table entry keyed by its shared-memory offset; a bulk copy lands when
// it is issued and counts its bytes against the mbarrier; a cp.async copy
// lands when it is issued (its waits do nothing); mma.sync is
// warp-collective through a per-warp buffer and reads its operands as TF32
// (the low 13 bits ignored), or as bf16 pairs for m16n8k16; a conversion to
// bf16 rounds to nearest even. The PTX helpers of the kernel are replaced by
// calls to the emu_* functions here before it is compiled.
#pragma once
#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <vector>

#include <sys/mman.h>
#include <ucontext.h>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x)
#define __shared__
#define __grid_constant__

struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
struct Dim { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0, cudaErrorInvalidValue = 1;
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
enum cudaMemcpyKind { cudaMemcpyDeviceToDevice };
// a stream's copy happens at once: launches run as they are called
inline cudaError_t cudaMemcpyAsync(void* dst, const void* src, size_t bytes, cudaMemcpyKind,
                                   cudaStream_t) {
  std::memcpy(dst, src, bytes);
  return cudaSuccess;
}

// ---- fibers ----------------------------------------------------------------

// A CUDA thread of the running block: its context, and whether it ended.
struct EmuFiber {
  ucontext_t ctx;
  bool done;
};
// A barrier of `count` threads: a thread arrives, then waits (letting the
// other fibers run) until its phase completes.
struct EmuSync {
  int count = 0, arrived = 0;
  unsigned phase = 0;
};
constexpr int kEmuMaxThreads = 1024;
constexpr size_t kEmuStack = 256 << 10;   // bytes of a fiber's stack

extern thread_local Dim threadIdx, blockIdx, blockDim;
extern EmuSync* g_block_bar;     // every thread of the block
extern EmuSync* g_consumer_bar;  // the named barrier's threads
extern EmuSync* g_warp_bar[32];  // one per warp
extern char* g_smem_base;        // the kernel's shared memory
extern ucontext_t g_sched;       // the launching thread's context
extern EmuFiber g_fibers[kEmuMaxThreads];
extern int g_fiber;              // the running fiber's thread index
extern void (*g_body)(void*);    // the block's code and its argument
extern void* g_body_arg;
extern unsigned g_mma_turn[kEmuMaxThreads];

// The running fiber gives the launching thread its turn back.
inline void emu_yield() { swapcontext(&g_fibers[g_fiber].ctx, &g_sched); }

inline void emu_sync(EmuSync* s) {
  const unsigned phase = s->phase;
  if (++s->arrived == s->count) {
    s->arrived = 0;
    ++s->phase;
    return;
  }
  while (s->phase == phase) emu_yield();
}

inline void __syncthreads() { emu_sync(g_block_bar); }
inline void __syncwarp() { emu_sync(g_warp_bar[threadIdx.x / 32]); }
inline void emu_consumer_sync() { emu_sync(g_consumer_bar); }
inline float __ldg(const float* p) { return *p; }
inline uint16_t __ldg(const uint16_t* p) { return *p; }
inline float4 __ldg(const float4* p) { return *p; }
inline uint4 __ldg(const uint4* p) { return *p; }
inline uint2 __ldg(const uint2* p) { return *p; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
inline void __threadfence_block() { std::atomic_thread_fence(std::memory_order_seq_cst); }
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
template <class T>
T __shfl_sync(unsigned, T v, int src) {
  T* buf = reinterpret_cast<T*>(g_shfl);
  buf[threadIdx.x] = v;
  __syncwarp();
  const T r = buf[(threadIdx.x & ~31u) | (unsigned(src) & 31u)];
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
inline void emu_bulk(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
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
  if (emu_bar(bar).phase.load() != parity) return true;
  const auto since = std::chrono::steady_clock::now();
  while (emu_bar(bar).phase.load() == parity) {
    if (std::chrono::steady_clock::now() - since > std::chrono::seconds(60)) {
      std::fprintf(stderr, "emulated kernel: an mbarrier wait does not end\n");
      std::abort();
    }
    emu_yield();
  }
  return false;
}

// ---- mma.sync m16n8k8 .tf32, cp.async ------------------------------------

// A warp's fragments, deposited by its lanes; two slots used in turn, so a
// lane that runs ahead into the next MMA never overwrites what a slower lane
// still reads.
struct EmuMma {
  uint32_t a[32][4], b[32][2];
};
extern EmuMma g_mma[32][2];

// D = A B + C for an m16n8k8 TF32 fragment, by the PTX ISA's layout (lane =
// 4 group + t): A a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// B b0 (k = t, n = g), b1 (t + 4, g); C and D c0 (g, 2t), c1 (g, 2t + 1),
// c2 (g + 8, 2t), c3 (g + 8, 2t + 1). Operands are read as TF32 (the low 13
// bits ignored, as the tensor cores do); each output sums C, then k = 0..7,
// in float32.
inline void emu_mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  unsigned& turn = g_mma_turn[threadIdx.x];
  const int lane = threadIdx.x % 32;
  EmuMma& m = g_mma[threadIdx.x / 32][turn];
  turn ^= 1u;
  for (int i = 0; i < 4; ++i) m.a[lane][i] = a[i];
  for (int i = 0; i < 2; ++i) m.b[lane][i] = b[i];
  __syncwarp();
  auto tf = [](uint32_t u) { return __uint_as_float(u & 0xffffe000u); };
  const int g = lane / 4, t = lane % 4;
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
    float s = d[i];
    for (int k = 0; k < 8; ++k) {
      const float av = tf(m.a[(row % 8) * 4 + k % 4][(row >= 8) + 2 * (k >= 4)]);
      const float bv = tf(m.b[col * 4 + k % 4][k >= 4]);
      s += av * bv;
    }
    d[i] = s;
  }
}

// ---- mma.sync m16n8k16 .bf16, cvt.rn.bf16x2 ---------------------------------

// f rounded to bf16, to nearest even (as __float2bfloat16_rn): its bits.
inline uint32_t emu_bf16_rn(float f) {
  const uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;  // NaN
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}
// cvt.rn.bf16x2.f32: lo in the low half, hi in the high half.
inline uint32_t emu_pack_bf16(float lo, float hi) {
  return emu_bf16_rn(lo) | emu_bf16_rn(hi) << 16;
}
// The bf16 value in the low (half 0) or high (half 1) half of a register.
inline float emu_bf16_half(uint32_t reg, int half) {
  return __uint_as_float(half ? reg & 0xffff0000u : reg << 16);
}

// D = A B + C for an m16n8k16 bf16 fragment with float32 accumulators, by
// the PTX ISA's layout (lane = 4 g + t; each register two bf16 values, the
// lower k in the low half): A a0 (g, 2t..2t + 1), a1 (g + 8, 2t..), a2
// (g, 2t + 8..2t + 9), a3 (g + 8, 2t + 8..); B b0 (k = 2t..2t + 1, n = g),
// b1 (2t + 8..2t + 9, g); C and D as emu_mma_tf32's. Each output sums C,
// then k = 0..15, in float32 (a product of two bf16 values is exact).
inline void emu_mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  unsigned& turn = g_mma_turn[threadIdx.x];
  const int lane = threadIdx.x % 32;
  EmuMma& m = g_mma[threadIdx.x / 32][turn];
  turn ^= 1u;
  for (int i = 0; i < 4; ++i) m.a[lane][i] = a[i];
  for (int i = 0; i < 2; ++i) m.b[lane][i] = b[i];
  __syncwarp();
  const int g = lane / 4, t = lane % 4;
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
    float s = d[i];
    for (int k = 0; k < 16; ++k) {
      const float av =
          emu_bf16_half(m.a[(row % 8) * 4 + (k % 8) / 2][(row >= 8) + 2 * (k >= 8)], k % 2);
      const float bv = emu_bf16_half(m.b[col * 4 + (k % 8) / 2][k >= 8], k % 2);
      s += av * bv;
    }
    d[i] = s;
  }
}

// cp.async of 16 bytes: the first `bytes` from src, zeros after ...
inline void emu_cp_async16(uint32_t dst, const void* src, uint32_t bytes) {
  std::memset(g_smem_base + dst, 0, 16);
  std::memcpy(g_smem_base + dst, src, bytes);
}
// ... and of 4 bytes.
inline void emu_cp_async4(uint32_t dst, const void* src, uint32_t bytes) {
  std::memset(g_smem_base + dst, 0, 4);
  std::memcpy(g_smem_base + dst, src, bytes);
}

// A fiber's entry: the block's code, then back to the launching thread
// (uc_link) for good.
inline void emu_fiber_main() {
  g_body(g_body_arg);
  g_fibers[g_fiber].done = true;
}

// Fiber stacks, mapped once (pages committed as a stack first touches them).
inline char* emu_stacks() {
  static char* base = static_cast<char*>(mmap(nullptr, kEmuStack * kEmuMaxThreads,
                                              PROT_READ | PROT_WRITE,
                                              MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE,
                                              -1, 0));
  if (base == MAP_FAILED) {
    std::fprintf(stderr, "emulated kernel: no memory for the fibers' stacks\n");
    std::abort();
  }
  return base;
}

// Runs `kernel` (a callable taking no arguments) over a grid of gx x gy x gz
// blocks of `threads` threads, one block at a time (x fastest), the threads
// as fibers of this thread; `consumers` threads take the named barrier.
// Shared memory (`smem_bytes` at g_smem_base) starts each block as NaNs, so
// stale reads show.
template <class K>
void emu_launch_grid(int gx, int gy, int gz, int threads, int consumers, size_t smem_bytes,
                     K kernel) {
  if (threads > kEmuMaxThreads) {
    std::fprintf(stderr, "emulated kernel: %d threads a block\n", threads);
    std::abort();
  }
  char* stacks = emu_stacks();
  g_body = [](void* k) { (*static_cast<K*>(k))(); };
  g_body_arg = &kernel;
  std::fill(g_mma_turn, g_mma_turn + threads, 0u);
  blockDim = Dim{unsigned(threads), 1, 1};
  for (int b = 0; b < gx * gy * gz; ++b) {
    std::memset(g_smem_base, 0xff, smem_bytes);
    EmuSync block{threads}, cons{consumers}, warps[32];
    for (int w = 0; w < 32; ++w) g_warp_bar[w] = &(warps[w] = EmuSync{32});
    g_block_bar = &block;
    g_consumer_bar = &cons;
    blockIdx = Dim{unsigned(b % gx), unsigned(b / gx % gy), unsigned(b / (gx * gy))};
    for (int t = 0; t < threads; ++t) {
      EmuFiber& f = g_fibers[t];
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = stacks + size_t(t) * kEmuStack;
      f.ctx.uc_stack.ss_size = kEmuStack;
      f.ctx.uc_link = &g_sched;
      makecontext(&f.ctx, emu_fiber_main, 0);
      f.done = false;
    }
    for (int live = threads; live > 0;) {
      for (int t = 0; t < threads; ++t) {
        if (g_fibers[t].done) continue;
        g_fiber = t;
        threadIdx = Dim{unsigned(t), 0, 0};
        swapcontext(&g_sched, &g_fibers[t].ctx);
        live -= g_fibers[t].done;
      }
    }
  }
}

// The same over `blocks` blocks in x.
template <class K>
void emu_launch(int blocks, int threads, int consumers, size_t smem_bytes, K kernel) {
  emu_launch_grid(blocks, 1, 1, threads, consumers, smem_bytes, kernel);
}

// The stand-in's globals, defined once by each harness; `smem` is the
// emulated kernel's shared-memory array.
#define EMU_GLOBALS(smem)                                  \
  thread_local Dim threadIdx, blockIdx, blockDim;          \
  EmuSync* g_block_bar;                                    \
  EmuSync* g_consumer_bar;                                 \
  EmuSync* g_warp_bar[32];                                 \
  ucontext_t g_sched;                                      \
  EmuFiber g_fibers[kEmuMaxThreads];                       \
  int g_fiber;                                             \
  void (*g_body)(void*);                                   \
  void* g_body_arg;                                        \
  unsigned g_mma_turn[kEmuMaxThreads];                     \
  char* g_smem_base = reinterpret_cast<char*>(smem);       \
  float g_shfl[1024 * 2];                                  \
  EmuBar g_bars[64];                                       \
  EmuMma g_mma[32][2];                                     \
  std::mutex g_bar_mu;
