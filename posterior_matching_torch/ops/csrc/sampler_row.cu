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
// read once per pixel-level by every block from L2. At digits16's (W = 4,
// F = 64, L = 12, K = 128) it is 3.6 GFLOP: 0.053 ms at 67 TFLOP/s.
//
// Design. The chain is sequential in pixels and levels but the n sample
// chains are independent, so each block owns TS = 8 samples and runs the
// whole pixel x level loop itself. A pixel is a fixed sequence of block
// GEMMs: h_init_left ([8, 2F] @ hlw [2F, F]), then per level conv_a
// ([8, 12F] @ wa [12F, F]) and conv_b ([8, 8F] @ wb [8F, 2F]), then the
// logits head in NC-column chunks ([8, F] @ lw [F, NC]: NC = 256, or 128
// where K is an odd multiple of 128).
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
// - Widths. The kernel is a template over F (PMK_DISPATCH_WIDTHS: 128, and
//   digits16's 64) and NC. A stage is 128 F-wide rows (64 KB at F = 128, 32
//   KB at 64), so every weight matrix is whole stages. A K group is N / 4
//   consumer threads (at F = 128 a warp, or two for N = 256; at 64 half a
//   warp for conv_a, 16 groups of 8 rows a stage), so the product's
//   partial sums are 8192 floats at every N. The gathers write one 2F-wide
//   tap row a thread and the epilogues one float4 of an F-wide value a
//   lane: at F = 64 half the consumers idle in both. The A operand region
//   is 8192 + 8F floats where 12F x 8 is smaller.
//
// The per-level chain inputs and intermediates are the kernel's outputs
// (outh, outm): they are the next pixel's (0,-1) taps, the skips of later
// levels in the same pixel, and the next image row's (-1, *) taps. They are
// written and re-read by the consumer warps between barriers (a named
// barrier over the 256 consumer threads), with plain loads; the bulk
// copies read only the weights.
//
// bf16 (a build with PM_CORE_BF16 = 1, the JAX kernel at cdtype bf16;
// sampler_common.cuh). The weights are bf16 in global memory, so a 64 KB
// stage carries twice the rows (256 F-wide, 128 2F-wide or 128 of a
// 256-column logits chunk) and each K group takes twice the rows of a stage
// (32 at F = 128, 16 at 64); a matrix that is not whole stages ends in a
// part stage (h_init_left at F = 64: half of one; a 128-column logits
// chunk: half of one), which only the K groups whose rows it holds read.
// A thread unpacks four bf16 weights of a row from one 8-byte load. The A
// operand is rounded to bf16 as it is gathered (it stays float in shared
// memory). s_x holds the chain's float32 value, rounded at JAX's points:
// T_0 = round(hup + (hl + hlb)) at the pixel's start, then at the start of
// every lpg-th level (lpg divides L: the JAX kernel's levels per grid
// step), never before the logits, which read the last group's unrounded
// value; outh and outm are stored rounded, so the (0,-1) taps and the
// skips read the rounded values, as JAX's bf16 stack and mstack. s_m keeps
// m in float32 (the conv_b gather rounds it). Bound at the dense bf16 rate
// (989 TFLOP/s): 0.115 ms at the flagship shapes.
//
// Shared memory (dynamic, floats): the weight ring 2 x 16384 (128 KB); the
// A operand 12F x 8 (48 KB), whose first 8192 floats also hold the partial
// sums once a GEMM's last stage is consumed, and whose floats [8192, 8192 +
// 8F) hold the logits operand; s_x [8, F], s_m [8, 2F], s_e [8, F] (16 KB);
// s_y [8]; 2 x 2 mbarriers. 196,672 bytes of the 232,448 a block may have
// at F = 128, 108,608 at 64. One block of 288 threads per SM; n = 320
// fills 40 of the 132 SMs.
#include <climits>
#include <cmath>
#include <cstdint>

#include "sampler_common.cuh"

namespace {

using namespace pmk;

constexpr int TS = 8;    // samples per block
constexpr int kHalf = 128;  // columns a warp covers (32 lanes x 4)
constexpr int kConsumers = 256;  // 8 warps: the products
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kBlock = kConsumers + 32;  // and one producer warp
constexpr int kStages = 2;     // ring depth
// Partial sums [groups][TS][N] of a product: the consumers' 1024 columns
// of float4s, in N / 4 lanes a K group, e.g. 8 groups of [TS, 128] or 4 of
// [TS, 256].
constexpr int kPartials = kConsumers * 4 * TS;

// cdt: the compute dtype's tensors (bf16 in a bf16 build); the biases, the
// noise and the logits are float32.
struct RowArgs {
  const cdt *wa;
  const float* ba;
  const cdt* wb;
  const float* bb;
  const cdt *cp, *prevh, *prevm, *aux, *hup, *e1;
  const float* gumbel;
  const cdt* emb;
  const cdt* lw;
  const float* lb;
  const cdt* hlw;
  const float* hlb;
  cdt *outh, *outm;
  int* outs;
  float* outl;  // logits out, or null
  int L, W, n, K, lpg;
};

// ---- the consumers' barrier

// __syncthreads over the consumer warps only (named barrier 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Row k of a k-major [K, TS] operand, rounded to the compute dtype.
__device__ __forceinline__ void put(float* sA, int k, const float (&v)[TS]) {
  st4(sA + k * TS, round_c4(make_float4(v[0], v[1], v[2], v[3])));
  st4(sA + k * TS + 4, round_c4(make_float4(v[4], v[5], v[6], v[7])));
}

// A consumer's share of an N-column product: K group tid / (N / 4), which
// takes kStage / 1024 K rows of each stage, and columns 4 (tid % (N / 4))
// .. + 3. N = 128: a warp a group; N = 256: two warps, one a column half;
// N = 64: half a warp.
template <int N>
__device__ __forceinline__ int group() {
  return threadIdx.x / (N / 4);
}
template <int N>
__device__ __forceinline__ int group_col() {
  return 4 * (threadIdx.x % (N / 4));
}

// The kernel at F filters (a built width: sampler_common.cuh
// PMK_DISPATCH_WIDTHS) and NC logits columns a GEMM chunk (256, or 128
// where K is an odd multiple of 128).
template <int F, int NC>
struct Row {
  // The weight stream.
  static constexpr int kStage = 128 * F;  // floats a stage (64 KB at F = 128)
  static constexpr int kStageElems = kStage * kCdtPerFloat;  // weights a stage
  // Stages of each matrix (the last one part of a stage where its weights
  // are not whole stages).
  static constexpr int kHlwStages = ceil_div(2 * F * F, kStageElems);     // 2 at F = 128 (1 in bf16)
  static constexpr int kWaStages = ceil_div(12 * F * F, kStageElems);     // 12 (6)
  static constexpr int kWbStages = ceil_div(8 * F * 2 * F, kStageElems);  // 16 (8)
  static constexpr int kLevelStages = kWaStages + kWbStages;
  static constexpr int kLwStages = ceil_div(F * NC, kStageElems);  // 2 a logits chunk (1)
  // K rows of a stage each K group multiplies (16 at F = 128, 32 in bf16).
  static constexpr int kGroupRows = kStageElems / (kConsumers * 4);
  static_assert(F % 64 == 0 && F <= kHalf && NC % kHalf == 0 && NC <= 2 * kHalf,
                "the tiles take F = 64 or 128, NC = 128 or 256");
  // F-wide values a consumer warp holds in an epilogue: its sample's F
  // columns over its lanes' first F / 4 (all at F = 128).
  static constexpr bool kAllLanes = F == kHalf;
  // The gathers write a 2F-wide tap block a thread a row (all consumers at
  // F = 128).
  static constexpr bool kAllGather = 2 * F == kConsumers;

  // Shared memory layout, in floats: the ring, the A operand (its first
  // kPartials floats also the partial sums, the F x TS after them the
  // logits operand), s_x, s_m, s_e, s_y, the mbarriers.
  static constexpr int kOpFloats =
      12 * F * TS > kPartials + F * TS ? 12 * F * TS : kPartials + F * TS;
  static constexpr int kOffA = kStages * kStage;
  static constexpr int kOffX = kOffA + kOpFloats;
  static constexpr int kOffM = kOffX + TS * F;
  static constexpr int kOffE = kOffM + TS * 2 * F;
  static constexpr int kOffY = kOffE + TS * F;
  static constexpr int kOffBar = kOffY + TS;  // full[kStages], empty[kStages]
  static constexpr size_t kSmemBytes = (size_t)(kOffBar + 4 * kStages) * sizeof(float);
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may have");
  static_assert(kOffBar % 2 == 0, "mbarriers are 8-byte aligned");

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

  // Stage st of a matrix of ELEMS weights at m: one bulk copy of a stage,
  // or of the part of one that ends a matrix not whole stages (a constant
  // in the float32 build, where every matrix is whole stages).
  template <int ELEMS>
  static __device__ __forceinline__ void copy_stage(uint32_t dst, const cdt* m, int st,
                                                    uint32_t bar) {
    constexpr int kLast = ELEMS - (ceil_div(ELEMS, kStageElems) - 1) * kStageElems;
    const int count = st + 1 < ceil_div(ELEMS, kStageElems) ? kStageElems : kLast;
    mbar_expect_tx(bar, count * sizeof(cdt));
    bulk_g2s(dst, m + (size_t)st * kStageElems, count * sizeof(cdt), bar);
  }

  // The producer's walk over the launch's stages: hlw, then wa[l] and wb[l]
  // for every level, then lw chunk by chunk, once per pixel.
  static __device__ void produce(const RowArgs& p, const Ring& ring, int per_pixel, int total) {
    for (int g = 0; g < total; ++g) {
      if (g >= kStages) mbar_wait(ring.empty_bar(g), (g / kStages + 1) & 1);
      const uint32_t bar = ring.full_bar(g), dst = smem_u32(ring.slot(g));
      const int q = g % per_pixel - kHlwStages;
      if (q < 0) {
        copy_stage<2 * F * F>(dst, p.hlw, q + kHlwStages, bar);
      } else if (q < p.L * kLevelStages) {
        const int l = q / kLevelStages, r = q % kLevelStages;
        if (r < kWaStages)
          copy_stage<12 * F * F>(dst, p.wa + (size_t)l * 12 * F * F, r, bar);
        else
          copy_stage<16 * F * F>(dst, p.wb + (size_t)l * 16 * F * F, r - kWaStages, bar);
      } else {
        // stage r of a chunk: kStageElems / NC rows of lw's columns [NC
        // chunk, NC chunk + NC), or the chunk's last rows, one bulk copy a row
        constexpr int kRows = kStageElems / NC;
        constexpr int kLastRows = F - (kLwStages - 1) * kRows;
        const int chunk = (q - p.L * kLevelStages) / kLwStages;
        const int r = (q - p.L * kLevelStages) % kLwStages;
        const int rows = r + 1 < kLwStages ? kRows : kLastRows;
        mbar_expect_tx(bar, rows * NC * sizeof(cdt));
        const cdt* src = p.lw + (size_t)r * kRows * p.K + chunk * NC;
        for (int i = 0; i < rows; ++i)
          bulk_g2s(dst + i * NC * sizeof(cdt), src + (size_t)i * p.K, NC * sizeof(cdt), bar);
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

  // acc[s][u] = sum over this thread's K rows of A[k][s] * W[k][col + u],
  // the product's KR rows of K taken from the next stages of the stream.
  // The operand must be complete (a consumers_sync after it was written).
  template <int N, int KR>
  static __device__ __forceinline__ void gemm(float (&acc)[TS][4], Stream& stream,
                                              const float* sA) {
    constexpr int R = kStageElems / N;  // K rows a stage
    constexpr int nst = (KR + R - 1) / R;
    constexpr int kLast = KR - (nst - 1) * R;  // rows of the last stage
    static_assert(kLast % kGroupRows == 0, "a part stage holds whole K groups");
    const int row0 = kGroupRows * group<N>(), col = group_col<N>();
#pragma unroll
    for (int s = 0; s < TS; ++s)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[s][u] = 0.f;
    for (int st = 0; st < nst; ++st) {
      const cdt* ws = reinterpret_cast<const cdt*>(stream.take()) + row0 * N + col;
      const float* as = sA + (st * R + row0) * TS;
      if (kLast == R || st + 1 < nst || row0 < kLast) {
#pragma unroll
      for (int r = 0; r < kGroupRows; ++r) {
        const float4 w4 = ldc4(ws + r * N);
        const float4 a0 = ld4(as + r * TS), a1 = ld4(as + r * TS + 4);
        const float a[TS] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int s = 0; s < TS; ++s)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[s][u] = fmaf(a[s], w[u], acc[s][u]);
      }
      }
      stream.release();
    }
  }

  // Writes each thread's partial [TS, 4] sums to P ([groups][TS][N]) once
  // every warp is done with the operand P overlays.
  template <int N>
  static __device__ __forceinline__ void store_partials(float* P, const float (&acc)[TS][4]) {
    const int g = group<N>(), col = group_col<N>();
    consumers_sync();
#pragma unroll
    for (int s = 0; s < TS; ++s)
      st4(P + (g * TS + s) * N + col,
          make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]));
    consumers_sync();
  }

  // The sum of the partials at (s, col..col + 3), in group order.
  template <int N>
  static __device__ __forceinline__ float4 reduced(const float* P, int s, int col) {
    constexpr int G = kPartials / (TS * N);
    float4 r = ld4(P + s * N + col);
#pragma unroll
    for (int g = 1; g < G; ++g) r = add4(r, ld4(P + (g * TS + s) * N + col));
    return r;
  }

  static __device__ __forceinline__ void run(const RowArgs& p) {
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
    // In every epilogue warp w owns sample w and lane l columns 4l..4l+3
    // (of an F-wide value where ef: all lanes at F = 128, half at 64).
    const int es = tid / 32, ecol = 4 * (tid % 32);
    const bool ef = kAllLanes || ecol < F;
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
    // element e of the tap, negated for the second half of concat_elu
    // (threads from 2F on gather nothing).
    const int e = tid % F;
    const bool neg = tid >= F;
    const bool gth = kAllGather || tid < 2 * F;
    float acc[TS][4];

    // The global loads of each GEMM's operand are issued one GEMM ahead, into
    // registers, so their latency hides behind the product before.
    // conv_a's at (l, c): taps (-1,-1), (-1,0), (0,-1) of this thread's
    // column, and its aux slot value: p for tid < F, the skip q after (zero on
    // up levels). The skip is this pixel's chain input at level 2R-1-l < l.
    float ta0[TS], ta1[TS], ta2[TS], taq[TS];
    auto load_a = [&](int l, int c) {
      if (!gth) return;
#pragma unroll
      for (int s = 0; s < TS; ++s) {
        const int j = js[s];
        ta0[s] = c > 0 ? to_f(__ldg(p.prevh + off(l, c - 1, j, F) + e)) : 0.f;
        ta1[s] = to_f(__ldg(p.prevh + off(l, c, j, F) + e));
        ta2[s] = c > 0 ? to_f(p.outh[off(l, c - 1, j, F) + e]) : 0.f;
        taq[s] = !neg ? to_f(__ldg(p.aux + off(l, c, j, F) + e))
                 : l >= R ? to_f(p.outh[off(2 * R - 1 - l, c, j, F) + e])
                          : 0.f;
      }
    };
    // conv_b's at (l, c): taps (-1,-1), (-1,0), (0,-1) of m, row tid.
    float tb0[TS], tb1[TS], tb2[TS];
    auto load_b = [&](int l, int c) {
      if (!gth) return;
#pragma unroll
      for (int s = 0; s < TS; ++s) {
        const int j = js[s];
        tb0[s] = c > 0 ? to_f(__ldg(p.prevm + off(l, c - 1, j, 2 * F) + tid)) : 0.f;
        tb1[s] = to_f(__ldg(p.prevm + off(l, c, j, 2 * F) + tid));
        tb2[s] = c > 0 ? to_f(p.outm[off(l, c - 1, j, 2 * F) + tid]) : 0.f;
      }
    };

    for (int c = 0; c < W; ++c) {
      load_a(0, c);
      // ---- T_0 = h_init_up (from the vrow kernel) + h_init_left's taps
      // (-1,-1) on the previous row's embedding and (0,-1) on the previous
      // sample's, both zero at the first column
      if (gth) {
        float v[TS];
#pragma unroll
        for (int s = 0; s < TS; ++s)
          v[s] = c == 0 ? 0.f : neg ? s_e[s][e] : to_f(p.e1[off2(c - 1, js[s], F) + e]);
        put(sA, tid, v);
      }
      float4 hup = {}, hlb = {};
      if (ef) {
        hup = ldc4(p.hup + off2(c, ej, F) + ecol);
        hlb = ld4(p.hlb + ecol);
      }
      consumers_sync();
      gemm<F, 2 * F>(acc, stream, sA);
      store_partials<F>(sA, acc);
      if (ef) {
        const float4 r = reduced<F>(sA, es, ecol);
        if constexpr (kBF16)  // JAX's order: hup + (hl + hlb), rounded
          st4(&s_x[es][ecol],
              round_c4(make_float4(hup.x + (r.x + hlb.x), hup.y + (r.y + hlb.y),
                                   hup.z + (r.z + hlb.z), hup.w + (r.w + hlb.w))));
        else
          st4(&s_x[es][ecol], make_float4(hup.x + r.x + hlb.x, hup.y + r.y + hlb.y,
                                          hup.z + r.z + hlb.z, hup.w + r.w + hlb.w));
      }
      consumers_sync();

      for (int l = 0; l < L; ++l) {
        // this level's input at this pixel: the next pixel's (0,-1) tap, and
        // the skip of level 2R-1-l later in this pixel
        if (evalid && ef) stc4(p.outh + off(l, c, ej, F) + ecol, ld4(&s_x[es][ecol]));

        // ---- conv_a's operand [12F, TS]: taps (-1,-1), (-1,0), (0,-1),
        // (0,0) with concat_elu, then the aux slot rows 8F + tid and 10F +
        // tid, elu(+-p) for tid < F and elu(+-q) after
        if (gth) {
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
        const float4 ba = ef ? ld4(p.ba + l * F + ecol) : float4{};
        consumers_sync();
        gemm<F, 12 * F>(acc, stream, sA);
        store_partials<F>(sA, acc);
        if (ef) {
          const float4 r = reduced<F>(sA, es, ecol);
          const float4 a = make_float4(r.x + ba.x, r.y + ba.y, r.z + ba.z, r.w + ba.w);
          const float4 mp = make_float4(elu(a.x), elu(a.y), elu(a.z), elu(a.w));
          const float4 mn = make_float4(elu(-a.x), elu(-a.y), elu(-a.z), elu(-a.w));
          st4(&s_m[es][ecol], mp);
          st4(&s_m[es][F + ecol], mn);
          if (evalid) {
            stc4(p.outm + off(l, c, ej, 2 * F) + ecol, mp);
            stc4(p.outm + off(l, c, ej, 2 * F) + F + ecol, mn);
          }
        }
        consumers_sync();

        // ---- conv_b's operand [8F, TS]: the four taps of m
        if (gth) {
          put(sA, tid, tb0);
          put(sA, 2 * F + tid, tb1);
          put(sA, 4 * F + tid, tb2);
          float v[TS];
#pragma unroll
          for (int s = 0; s < TS; ++s) v[s] = s_m[s][tid];
          put(sA, 6 * F + tid, v);
        }
        if (l + 1 < L) load_a(l + 1, c);
        // act column ecol + u, its gate ecol + u + F
        const float* bb = p.bb + l * 2 * F;
        const cdt* cp = p.cp + ((size_t)l * n + ej) * 2 * F;
        float4 b_a = {}, b_g = {}, c_a = {}, c_g = {};
        if (ef) {
          b_a = ld4(bb + ecol), b_g = ld4(bb + F + ecol);
          c_a = ldc4(cp + ecol), c_g = ldc4(cp + F + ecol);
        }
        consumers_sync();
        gemm<2 * F, 8 * F>(acc, stream, sA);
        store_partials<2 * F>(sA, acc);
        if (ef) {
          const float4 ra = reduced<2 * F>(sA, es, ecol);
          const float4 rg = reduced<2 * F>(sA, es, F + ecol);
          float4 x = ld4(&s_x[es][ecol]);
          x.x += sigmoid(rg.x + b_g.x + c_g.x) * (ra.x + b_a.x + c_a.x);
          x.y += sigmoid(rg.y + b_g.y + c_g.y) * (ra.y + b_a.y + c_a.y);
          x.z += sigmoid(rg.z + b_g.z + c_g.z) * (ra.z + b_a.z + c_a.z);
          x.w += sigmoid(rg.w + b_g.w + c_g.w) * (ra.w + b_a.w + c_a.w);
          // bf16: the next level starts a group of lpg (the logits read
          // the last level's value unrounded)
          if (kBF16 && (l + 1) % p.lpg == 0 && l + 1 < L) x = round_c4(x);
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
        gemm<NC, F>(acc, stream, sAL);
        store_partials<NC>(sA, acc);
#pragma unroll
        for (int h = 0; h < NC / kHalf; ++h) {
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
      if (ef) st4(&s_e[es][ecol], ldgc4(p.emb + (size_t)s_y[es] * F + ecol));
      consumers_sync();
    }
  }
};

template <int F, int NC>
__global__ void __launch_bounds__(kBlock, 1) row_kernel(const RowArgs p) {
  Row<F, NC>::run(p);
}

}  // namespace

// Launches one image row. Tensors are contiguous, 16-byte aligned, on the
// device of `stream`, cdt (bf16 in a bf16 build) or float32 as RowArgs says
// (outs int32); shapes as in posterior_matching_torch/ops/sampler_chain.py::
// row_plain with F a built width (PMK_DISPATCH_WIDTHS) and K % 128 == 0;
// outl may be null. `bf16` must be this build's (1 for the bf16 build),
// lpg (the bf16 chain's rounding cadence) a divisor of L. Returns
// cudaGetLastError() after the launch.
extern "C" int pm_sampler_row(
    const cdt* wa, const float* ba, const cdt* wb, const float* bb,
    const cdt* cp, const cdt* prevh, const cdt* prevm, const cdt* aux,
    const cdt* hup, const cdt* e1, const float* gumbel, const cdt* emb,
    const cdt* lw, const float* lb, const cdt* hlw, const float* hlb,
    cdt* outh, cdt* outm, int* outs, float* outl, int L, int W, int n,
    int K, int filters, int bf16, int lpg, void* stream) {
  if (W < 1 || n < 1 || L < 2 || L % 2 || K < kHalf || K % kHalf || bf16 != (int)kBF16 ||
      lpg < 1 || L % lpg)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {wa,  ba,  wb, bb,     cp,  prevh, prevm, aux,  hup,  e1,
                        gumbel, emb, lw, lb, hlw, hlb,   outh,  outm, outs, outl};
  for (const void* q : ptrs)
    if (reinterpret_cast<uintptr_t>(q) % 16) return (int)cudaErrorInvalidValue;
  const RowArgs p{wa,  ba,  wb,  bb,  cp,   prevh, prevm, aux,  hup, e1, gumbel,
                  emb, lw,  lb,  hlw, hlb,  outh,  outm,  outs, outl, L,  W,
                  n,   K,  lpg};
  const int blocks = (n + TS - 1) / TS;
  // one (width, logits chunk)'s kernel, with its shared memory
  auto launch = [&](void (*kernel)(RowArgs), size_t smem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return (int)cudaGetLastError();
  };
  if (K % 256 == 0)
    PMK_DISPATCH_WIDTHS(filters, launch(row_kernel<F, 256>, Row<F, 256>::kSmemBytes));
  PMK_DISPATCH_WIDTHS(filters, launch(row_kernel<F, 128>, Row<F, 128>::kSmemBytes));
}
