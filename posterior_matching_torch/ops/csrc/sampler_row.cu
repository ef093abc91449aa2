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
// whole pixel x level loop itself. A pixel is a fixed sequence of block
// GEMMs: h_init_left ([8, 2F] @ hlw [2F, F]), then per level conv_a
// ([8, 12F] @ wa [12F, F]) and conv_b ([8, 8F] @ wb [8F, 2F]), then the
// logits head in 256-column chunks ([8, F] @ lw [F, 256]).
//
// - The A operand of each GEMM is built once, by one parallel gather into
//   shared memory (k-major, the 8 samples of a row side by side): the four
//   cached taps with concat_elu applied and the aux slot [elu(p), elu(q),
//   elu(-p), elu(-q)] (q zero on up levels) for conv_a; the four taps of m
//   for conv_b. One memory latency a GEMM.
// - The weights a pixel reads do not depend on the data: hlw, wa[0], wb[0],
//   ..., wa[L-1], wb[L-1], lw. They are cut into 64 KB stages (128 rows of
//   an F-wide matrix, 64 rows of a 2F-wide one or of a 256-column chunk of
//   lw) and streamed through a ring of two slots by a producer warp of its
//   own: one thread issues each stage as 1-D bulk copies
//   (cp.async.bulk, one for a contiguous stage, one a row for lw) that
//   complete on the slot's "full" mbarrier, and refills a slot once the 8
//   consumer warps have arrived on its "empty" mbarrier. The producer never
//   waits on the consumers' GEMM, level or pixel boundaries, so the ring
//   keeps filling while they gather operands and run epilogues; a consumer
//   warp waits only for the stage it takes. Each stage costs the consumers
//   a handshake (~90 ns on an H100), so two 64 KB slots beat five of 32 KB;
//   a third 64 KB slot does not fit beside the 48 KB operand.
// - Register tile: lane l of a consumer warp owns columns 4l..4l+3 of a
//   128-column half for all 8 samples (32 accumulators). A weight float4
//   read once from shared memory feeds 32 FMAs; the A values are
//   broadcasts. The 8 warps split K inside the block (N = F: 8 ways;
//   N = 2F or 256: 4 ways x 2 column halves), each taking 16 rows of
//   every stage; the partial [8, N] sums are reduced through shared memory in a
//   fixed warp order, so results are bit-identical from launch to launch.
//
// The per-level chain inputs and intermediates are the kernel's outputs
// (outh, outm): they are the next pixel's (0,-1) taps, the skips of later
// levels in the same pixel, and the next image row's (-1, *) taps. They are
// written and re-read by the consumer warps between barriers (a named
// barrier over the 256 consumer threads), with plain loads; the bulk
// copies read only the weights.
//
// Shared memory (dynamic, floats): the weight ring 2 x 16384 (128 KB); the
// A operand 12F x 8 (48 KB), whose first 8192 floats also hold the partial
// sums once a GEMM's last stage is consumed, and whose floats [8192, 8192 +
// 8F) hold the logits operand; s_x [8, F], s_m [8, 2F], s_e [8, F] (16 KB);
// s_y [8]; 2 x 2 mbarriers. 196,672 bytes of the 232,448 a block may have.
// One block of 288 threads per SM; n = 320 fills 40 of the 132 SMs.
#include <climits>
#include <cmath>
#include <cstdint>

#include "sampler_common.cuh"

namespace {

using namespace pmk;

constexpr int F = kF;
constexpr int TS = 8;    // samples per block
constexpr int NC = 256;  // logits columns per GEMM chunk
constexpr int kHalf = 128;  // columns a warp covers (32 lanes x 4)
constexpr int kConsumers = kThreads;   // 8 warps: the products
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kBlock = kConsumers + 32;  // and one producer warp
static_assert(F == kHalf && kConsumers == 256, "the tile assumes F = 128, 8 warps");

// The weight stream.
constexpr int kStage = 16384;  // floats a stage (64 KB)
constexpr int kStages = 2;     // ring depth
constexpr int kHlwStages = 2 * F * F / kStage;     // 2
constexpr int kWaStages = 12 * F * F / kStage;     // 12
constexpr int kWbStages = 8 * F * 2 * F / kStage;  // 16
constexpr int kLevelStages = kWaStages + kWbStages;
constexpr int kLwStages = F * NC / kStage;  // 2 a logits chunk
// K rows of a stage each warp multiplies: 16 of 128 (N = F, 8 ways), 16 of
// 64 (N = 2F or 256, 4 ways x 2 column halves).
constexpr int kWarpRows = kStage / (kConsumerWarps * kHalf);
// Partial sums [groups][TS][N] of a product: 8 groups of [TS, F] or 4 of
// [TS, 2F].
constexpr int kPartials = kConsumerWarps * TS * kHalf;

// Shared memory layout, in floats.
constexpr int kOffA = kStages * kStage;
constexpr int kOffX = kOffA + 12 * F * TS;
constexpr int kOffM = kOffX + TS * F;
constexpr int kOffE = kOffM + TS * 2 * F;
constexpr int kOffY = kOffE + TS * F;
constexpr int kOffBar = kOffY + TS;  // full[kStages], empty[kStages]
constexpr size_t kSmemBytes = (size_t)(kOffBar + 4 * kStages) * sizeof(float);
static_assert(kSmemBytes <= 232448, "over the 227 KB a block may have");
static_assert(kOffBar % 2 == 0, "mbarriers are 8-byte aligned");
static_assert(kPartials + F * TS <= 12 * F * TS, "partials and logits operand");

struct RowArgs {
  const float *wa, *ba, *wb, *bb, *cp, *prevh, *prevm, *aux, *hup, *e1,
      *gumbel, *emb, *lw, *lb, *hlw, *hlb;
  float *outh, *outm;
  int* outs;
  float* outl;  // logits out, or null
  int L, W, n, K;
};

// ---- mbarriers, bulk copies and the consumers' barrier (PTX)

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// Waits for the phase of the given parity to complete. A wait that never
// ends (a parity mistake) traps, so it surfaces as a launch error.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0; !mbar_try_wait(bar, parity);)
    if (++spins == (1u << 30)) __trap();
}
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const float* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// __syncthreads over the consumer warps only (named barrier 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// ---- the weight ring

// Slot g % kStages holds stage g while phase g / kStages of its mbarriers
// runs: "full" (1 arrival, the producer's, plus the stage's bytes) and
// "empty" (one arrival from each consumer warp).
struct Ring {
  float* slots;
  uint64_t* full;
  uint64_t* empty;

  __device__ float* slot(int g) const { return slots + (g % kStages) * kStage; }
  __device__ uint32_t full_bar(int g) const { return smem_u32(full + g % kStages); }
  __device__ uint32_t empty_bar(int g) const { return smem_u32(empty + g % kStages); }
};

// The producer's walk over the launch's stages: hlw, then wa[l] and wb[l]
// for every level, then lw chunk by chunk, once per pixel.
__device__ void produce(const RowArgs& p, const Ring& ring, int per_pixel, int total) {
  for (int g = 0; g < total; ++g) {
    if (g >= kStages) mbar_wait(ring.empty_bar(g), (g / kStages + 1) & 1);
    const uint32_t bar = ring.full_bar(g), dst = smem_u32(ring.slot(g));
    mbar_expect_tx(bar, kStage * sizeof(float));
    const int q = g % per_pixel - kHlwStages;
    if (q < 0) {
      bulk_g2s(dst, p.hlw + (size_t)(q + kHlwStages) * kStage, kStage * 4, bar);
    } else if (q < p.L * kLevelStages) {
      const int l = q / kLevelStages, r = q % kLevelStages;
      const float* src = r < kWaStages
                             ? p.wa + ((size_t)l * kWaStages + r) * kStage
                             : p.wb + ((size_t)l * kWbStages + r - kWaStages) * kStage;
      bulk_g2s(dst, src, kStage * 4, bar);
    } else {
      // stage r of a chunk: kStage / NC rows of lw's columns [256 chunk,
      // 256 chunk + 256), one bulk copy a row
      const int chunk = (q - p.L * kLevelStages) / kLwStages;
      const int r = (q - p.L * kLevelStages) % kLwStages;
      const float* src = p.lw + (size_t)r * (kStage / NC) * p.K + chunk * NC;
      for (int i = 0; i < kStage / NC; ++i)
        bulk_g2s(dst + i * NC * 4, src + (size_t)i * p.K, NC * 4, bar);
    }
  }
}

// The consumers' side: take() waits for the next stage, release() hands
// its slot back once this warp is done reading it.
struct Stream {
  Ring ring;
  int next;

  __device__ const float* take() const {
    mbar_wait(ring.full_bar(next), (next / kStages) & 1);
    return ring.slot(next);
  }
  __device__ void release() {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(ring.empty_bar(next));
    ++next;
  }
};

// Row k of a k-major [K, TS] operand.
__device__ __forceinline__ void put(float* sA, int k, const float (&v)[TS]) {
  st4(sA + k * TS, make_float4(v[0], v[1], v[2], v[3]));
  st4(sA + k * TS + 4, make_float4(v[4], v[5], v[6], v[7]));
}

// Warp w's share of an N-column product: its K rows of each stage and its
// 128-column half. N = F: rows kWarpRows * [w, w + 1) of a stage; N = 256:
// rows kWarpRows * [w/2, w/2 + 1), columns 128(w%2) + ...
template <int N>
__device__ __forceinline__ int warp_group() {
  return N == F ? threadIdx.x / 32 : threadIdx.x / 64;
}
template <int N>
__device__ __forceinline__ int warp_col() {
  return (N == F ? 0 : kHalf * ((threadIdx.x / 32) % 2)) + 4 * (threadIdx.x % 32);
}

// acc[s][u] = sum over this warp's K rows of A[k][s] * W[k][col + u], the
// product's K taken from the next nst stages of the stream. The operand
// must be complete (a consumers_sync after it was written).
template <int N>
__device__ __forceinline__ void gemm(float (&acc)[TS][4], Stream& stream,
                                     const float* sA, int nst) {
  constexpr int R = kStage / N;  // K rows a stage
  const int row0 = kWarpRows * warp_group<N>(), col = warp_col<N>();
#pragma unroll
  for (int s = 0; s < TS; ++s)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[s][u] = 0.f;
  for (int st = 0; st < nst; ++st) {
    const float* ws = stream.take() + row0 * N + col;
    const float* as = sA + (st * R + row0) * TS;
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {
      const float4 w4 = ld4(ws + r * N);
      const float4 a0 = ld4(as + r * TS), a1 = ld4(as + r * TS + 4);
      const float a[TS] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int s = 0; s < TS; ++s)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[s][u] = fmaf(a[s], w[u], acc[s][u]);
    }
    stream.release();
  }
}

// Writes each warp's partial [TS, N] sums to P ([groups][TS][N]) once every
// warp is done with the operand P overlays.
template <int N>
__device__ __forceinline__ void store_partials(float* P, const float (&acc)[TS][4]) {
  const int g = warp_group<N>(), col = warp_col<N>();
  consumers_sync();
#pragma unroll
  for (int s = 0; s < TS; ++s)
    st4(P + (g * TS + s) * N + col,
        make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]));
  consumers_sync();
}

// The sum of the partials at (s, col..col + 3), in group order.
template <int N>
__device__ __forceinline__ float4 reduced(const float* P, int s, int col) {
  constexpr int G = kPartials / (TS * N);
  float4 r = ld4(P + s * N + col);
#pragma unroll
  for (int g = 1; g < G; ++g) r = add4(r, ld4(P + (g * TS + s) * N + col));
  return r;
}

__global__ void __launch_bounds__(kBlock, 1) row_kernel(const RowArgs p) {
  extern __shared__ __align__(16) float smem[];
  float* sA = smem + kOffA;
  float* sAL = sA + kPartials;  // the logits operand [F, TS]
  float(*s_x)[F] = reinterpret_cast<float(*)[F]>(smem + kOffX);  // the chain
  float(*s_m)[2 * F] = reinterpret_cast<float(*)[2 * F]>(smem + kOffM);  // m
  float(*s_e)[F] = reinterpret_cast<float(*)[F]>(smem + kOffE);  // embedding
  int* s_y = reinterpret_cast<int*>(smem + kOffY);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kOffBar);
  const Ring ring{smem, bars, bars + kStages};

  const int W = p.W, n = p.n, L = p.L, R = p.L / 2, K = p.K;
  const int tid = threadIdx.x;
  const int per_pixel = kHlwStages + L * kLevelStages + (K / NC) * kLwStages;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(smem_u32(ring.full + i), 1);
      mbar_init(smem_u32(ring.empty + i), kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid >= kConsumers) {  // the producer warp
    if (tid == kConsumers) produce(p, ring, per_pixel, W * per_pixel);
    return;
  }

  const int j0 = blockIdx.x * TS;
  // In every epilogue warp w owns sample w and lane l columns 4l..4l+3.
  const int es = tid / 32, ecol = 4 * (tid % 32);
  const bool evalid = j0 + es < n;
  // Slot s's sample, clamped into range for loads (unused slots compute
  // throw-away values and never write; samples never interact).
  const int ej = min(j0 + es, n - 1);
  int js[TS];
#pragma unroll
  for (int s = 0; s < TS; ++s) js[s] = min(j0 + s, n - 1);
  // Offset of (level l, column c, sample j) in an [L, W, n, C] tensor.
  auto off = [&](int l, int c, int j, int C) {
    return (((size_t)l * W + c) * n + j) * C;
  };
  // Offset of (column c, sample j) in a [W, n, C] tensor.
  auto off2 = [&](int c, int j, int C) { return ((size_t)c * n + j) * C; };

  Stream stream{ring, 0};
  // This thread's gather column: row tid of a 2F-wide tap block, i.e.
  // element e of the tap, negated for the second half of concat_elu.
  const int e = tid % F;
  const bool neg = tid >= F;
  float acc[TS][4];

  // The global loads of each GEMM's operand are issued one GEMM ahead, into
  // registers, so their latency hides behind the product before.
  // conv_a's at (l, c): taps (-1,-1), (-1,0), (0,-1) of this thread's
  // column, and its aux slot value: p for tid < F, the skip q after (zero on
  // up levels). The skip is this pixel's chain input at level 2R-1-l < l.
  float ta0[TS], ta1[TS], ta2[TS], taq[TS];
  auto load_a = [&](int l, int c) {
#pragma unroll
    for (int s = 0; s < TS; ++s) {
      const int j = js[s];
      ta0[s] = c > 0 ? __ldg(p.prevh + off(l, c - 1, j, F) + e) : 0.f;
      ta1[s] = __ldg(p.prevh + off(l, c, j, F) + e);
      ta2[s] = c > 0 ? p.outh[off(l, c - 1, j, F) + e] : 0.f;
      taq[s] = !neg ? __ldg(p.aux + off(l, c, j, F) + e)
               : l >= R ? p.outh[off(2 * R - 1 - l, c, j, F) + e]
                        : 0.f;
    }
  };
  // conv_b's at (l, c): taps (-1,-1), (-1,0), (0,-1) of m, row tid.
  float tb0[TS], tb1[TS], tb2[TS];
  auto load_b = [&](int l, int c) {
#pragma unroll
    for (int s = 0; s < TS; ++s) {
      const int j = js[s];
      tb0[s] = c > 0 ? __ldg(p.prevm + off(l, c - 1, j, 2 * F) + tid) : 0.f;
      tb1[s] = __ldg(p.prevm + off(l, c, j, 2 * F) + tid);
      tb2[s] = c > 0 ? p.outm[off(l, c - 1, j, 2 * F) + tid] : 0.f;
    }
  };

  for (int c = 0; c < W; ++c) {
    load_a(0, c);
    // ---- T_0 = h_init_up (from the vrow kernel) + h_init_left's taps
    // (-1,-1) on the previous row's embedding and (0,-1) on the previous
    // sample's, both zero at the first column
    {
      float v[TS];
#pragma unroll
      for (int s = 0; s < TS; ++s)
        v[s] = c == 0 ? 0.f : neg ? s_e[s][e] : p.e1[off2(c - 1, js[s], F) + e];
      put(sA, tid, v);
    }
    const float4 hup = ld4(p.hup + off2(c, ej, F) + ecol);
    const float4 hlb = ld4(p.hlb + ecol);
    consumers_sync();
    gemm<F>(acc, stream, sA, kHlwStages);
    store_partials<F>(sA, acc);
    {
      const float4 r = reduced<F>(sA, es, ecol);
      st4(&s_x[es][ecol], make_float4(hup.x + r.x + hlb.x, hup.y + r.y + hlb.y,
                                      hup.z + r.z + hlb.z, hup.w + r.w + hlb.w));
    }
    consumers_sync();

    for (int l = 0; l < L; ++l) {
      // this level's input at this pixel: the next pixel's (0,-1) tap, and
      // the skip of level 2R-1-l later in this pixel
      if (evalid) st4(p.outh + off(l, c, ej, F) + ecol, ld4(&s_x[es][ecol]));

      // ---- conv_a's operand [12F, TS]: taps (-1,-1), (-1,0), (0,-1),
      // (0,0) with concat_elu, then the aux slot rows 8F + tid and 10F +
      // tid, elu(+-p) for tid < F and elu(+-q) after
      {
        float v[TS];
#pragma unroll
        for (int s = 0; s < TS; ++s) v[s] = elu(neg ? -ta0[s] : ta0[s]);
        put(sA, tid, v);
#pragma unroll
        for (int s = 0; s < TS; ++s) v[s] = elu(neg ? -ta1[s] : ta1[s]);
        put(sA, 2 * F + tid, v);
#pragma unroll
        for (int s = 0; s < TS; ++s) v[s] = elu(neg ? -ta2[s] : ta2[s]);
        put(sA, 4 * F + tid, v);
#pragma unroll
        for (int s = 0; s < TS; ++s) v[s] = elu(neg ? -s_x[s][e] : s_x[s][e]);
        put(sA, 6 * F + tid, v);
#pragma unroll
        for (int s = 0; s < TS; ++s) v[s] = elu(taq[s]);
        put(sA, 8 * F + tid, v);
#pragma unroll
        for (int s = 0; s < TS; ++s) v[s] = elu(-taq[s]);
        put(sA, 10 * F + tid, v);
      }
      load_b(l, c);
      const float4 ba = ld4(p.ba + l * F + ecol);
      consumers_sync();
      gemm<F>(acc, stream, sA, kWaStages);
      store_partials<F>(sA, acc);
      {
        const float4 r = reduced<F>(sA, es, ecol);
        const float4 a = make_float4(r.x + ba.x, r.y + ba.y, r.z + ba.z, r.w + ba.w);
        const float4 mp = make_float4(elu(a.x), elu(a.y), elu(a.z), elu(a.w));
        const float4 mn = make_float4(elu(-a.x), elu(-a.y), elu(-a.z), elu(-a.w));
        st4(&s_m[es][ecol], mp);
        st4(&s_m[es][F + ecol], mn);
        if (evalid) {
          st4(p.outm + off(l, c, ej, 2 * F) + ecol, mp);
          st4(p.outm + off(l, c, ej, 2 * F) + F + ecol, mn);
        }
      }
      consumers_sync();

      // ---- conv_b's operand [8F, TS]: the four taps of m
      put(sA, tid, tb0);
      put(sA, 2 * F + tid, tb1);
      put(sA, 4 * F + tid, tb2);
      {
        float v[TS];
#pragma unroll
        for (int s = 0; s < TS; ++s) v[s] = s_m[s][tid];
        put(sA, 6 * F + tid, v);
      }
      if (l + 1 < L) load_a(l + 1, c);
      // act column ecol + u, its gate ecol + u + F
      const float* bb = p.bb + l * 2 * F;
      const float* cp = p.cp + ((size_t)l * n + ej) * 2 * F;
      const float4 b_a = ld4(bb + ecol), b_g = ld4(bb + F + ecol);
      const float4 c_a = ld4(cp + ecol), c_g = ld4(cp + F + ecol);
      consumers_sync();
      gemm<2 * F>(acc, stream, sA, kWbStages);
      store_partials<2 * F>(sA, acc);
      {
        const float4 ra = reduced<2 * F>(sA, es, ecol);
        const float4 rg = reduced<2 * F>(sA, es, F + ecol);
        float4 x = ld4(&s_x[es][ecol]);
        x.x += sigmoid(rg.x + b_g.x + c_g.x) * (ra.x + b_a.x + c_a.x);
        x.y += sigmoid(rg.y + b_g.y + c_g.y) * (ra.y + b_a.y + c_a.y);
        x.z += sigmoid(rg.z + b_g.z + c_g.z) * (ra.z + b_a.z + c_a.z);
        x.w += sigmoid(rg.w + b_g.w + c_g.w) * (ra.w + b_a.w + c_a.w);
        st4(&s_x[es][ecol], x);
      }
      consumers_sync();
    }

    // ---- logits head and the Gumbel-argmax sample (ties to the lower index)
    if (tid < F) {
      float v[TS];
#pragma unroll
      for (int s = 0; s < TS; ++s) v[s] = elu(s_x[s][tid]);
      put(sAL, tid, v);
    }
    consumers_sync();
    float best = -INFINITY;
    int bidx = INT_MAX;
    const size_t o = off2(c, ej, K);
    for (int n0 = 0; n0 < K; n0 += NC) {
      gemm<NC>(acc, stream, sAL, kLwStages);
      store_partials<NC>(sA, acc);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + h * kHalf + ecol;
        const float4 r = reduced<NC>(sA, es, h * kHalf + ecol);
        const float4 b = ld4(p.lb + col);
        const float4 lg = make_float4(r.x + b.x, r.y + b.y, r.z + b.z, r.w + b.w);
        if (p.outl != nullptr && evalid) st4(p.outl + o + col, lg);
        const float4 g = ld4(p.gumbel + o + col);
        const float v[4] = {lg.x + g.x, lg.y + g.y, lg.z + g.z, lg.w + g.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (v[u] > best || (v[u] == best && col + u < bidx)) {
            best = v[u];
            bidx = col + u;
          }
        }
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d /= 2) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, d);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx, d);
      if (ov > best || (ov == best && oi < bidx)) {
        best = ov;
        bidx = oi;
      }
    }
    if (tid % 32 == 0) {
      const int y = bidx < K ? bidx : 0;  // only non-finite logits leave no winner
      s_y[es] = y;
      if (evalid) p.outs[(size_t)c * n + ej] = y;
    }
    consumers_sync();
    st4(&s_e[es][ecol], __ldg(reinterpret_cast<const float4*>(
                            p.emb + (size_t)s_y[es] * F + ecol)));
    consumers_sync();
  }
}

}  // namespace

// Launches one image row. Tensors are float32 (outs int32), contiguous,
// 16-byte aligned, on the device of `stream`; shapes as in
// posterior_matching_torch/ops/sampler_chain.py::row_plain with F = 128 and
// K % 256 == 0; outl may be null. Returns cudaGetLastError() after the
// launch.
extern "C" int pm_sampler_row(
    const float* wa, const float* ba, const float* wb, const float* bb,
    const float* cp, const float* prevh, const float* prevm, const float* aux,
    const float* hup, const float* e1, const float* gumbel, const float* emb,
    const float* lw, const float* lb, const float* hlw, const float* hlb,
    float* outh, float* outm, int* outs, float* outl, int L, int W, int n,
    int K, void* stream) {
  if (W < 1 || n < 1 || L < 2 || L % 2 || K < NC || K % NC)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {wa,  ba,  wb, bb,     cp,  prevh, prevm, aux,  hup,  e1,
                        gumbel, emb, lw, lb, hlw, hlb,   outh,  outm, outs, outl};
  for (const void* q : ptrs)
    if (reinterpret_cast<uintptr_t>(q) % 16) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  RowArgs p{wa,  ba,  wb,  bb,  cp,   prevh, prevm, aux,  hup, e1, gumbel,
            emb, lw,  lb,  hlw, hlb,  outh,  outm,  outs, outl, L,  W,
            n,   K};
  const int blocks = (n + TS - 1) / TS;
  row_kernel<<<blocks, kBlock, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
