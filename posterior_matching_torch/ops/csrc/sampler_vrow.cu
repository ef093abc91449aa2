// Vertical-stack kernel of the PixelCNN row sampler.
//
// Replaces posterior_matching_tpu/ops/sampler_chain.py::_vrow_kernel_factory
// (Pallas, grid (L,), pallas_call at :557). For one image row it computes
// v_init and h_init_up from the code embeddings of rows r-2 and r-1, then the
// L gated vertical levels: a = [shift3(celu(in_prev)), shift3(celu(in_cur))]
// @ wav (+ celu(skip) @ waux on down levels), m = celu(a),
// b = [shift3(m_prev), shift3(m)] @ wbv + cond projection,
// out = in_cur + sigmoid(gate) * act.
//
// Bound: operations. At the flagship shapes (rows W*n = 16*320, F = 128,
// L = 24) one launch is 2*W*n*(9F*F + L*36F*F + (L/2)*2F*F) ~ 150.5 GFLOP of
// float32 FMAs against ~460 MB of row tensors in and out; the weights are
// (9F*F + L*36F*F + (L/2)*2F*F) * 4 B = 58.8 MB. At digits16's (W*n =
// 4*320, F = 64, L = 12) it is 4.75 GFLOP: 0.071 ms at 67 TFLOP/s.
//
// Design. The Pallas kernel walks levels as a sequential grid and keeps the
// carry and skip stack in VMEM. Here the n sample chains are independent, so
// each block owns TS samples across all W columns (TS*W <= 48 row slots,
// TS = 3 at W = 16: 107 blocks for n = 320, one wave on the 132 SMs, 81% of
// them busy) and runs the level loop itself; the +-1 column shifts stay
// inside the block. Each level is a fixed sequence of block GEMMs with
// M = 48 rows: conv_a ([48, 12F] @ wav [12F, F]), the skip product on down
// levels ([48, 2F] @ waux [2F, F]) into the same sums, conv_b ([48, 12F] @
// wbv [12F, 2F]); before them v_init and h_init_up.
//
// - Operands in shared memory, built once a GEMM. A GEMM's two sources
//   (in_prev and in_cur through concat_elu for conv_a; m_prev and m for
//   conv_b; e2 and e1 for v_init) are stored row-major, kSlots rows of 2F
//   floats: TS samples x (W + 2) columns, a zero column on each side. The
//   three column taps of a source are the same buffer read one row up,
//   level or down, so concat_elu runs once an element; m and the next
//   level's celu(in_cur) are written from the epilogue's registers.
// - The weights do not depend on the data: viw, huw, then wav[l], waux[l]
//   (down levels) and wbv[l] for each level. They are cut into 32 KB stages
//   (64 K rows of an F-wide matrix, 32 of a 2F-wide one), each one bulk
//   copy (cp.async.bulk) into a ring of three slots, each with a "full"
//   mbarrier. There is no producer warp: the last of the 12 warps to finish
//   a slot's stage (a shared-memory count) issues the stage that goes into
//   it next. A thirteenth warp would cap a thread at 128 registers (four
//   warps on one of the SM's four register files) where 12 allow 168;
//   measured, the producer warp's version was 3% slower and spilled more.
//   Three 32 KB slots fit beside the 108 KB operand; six of 16 KB were
//   slower (twice the handshakes).
// - Register tile: a thread holds 16 rows x 4 columns (N = F: the 12 warps
//   are 3 row thirds x 4 K groups) or 8 rows x 8 columns, act column j and
//   gate column j + F side by side (N = 2F: 6 row sixths x 2 K groups).
//   A thread reads A as float4s along K (32-bit shared addresses; broadcasts:
//   a warp's lanes share their rows) and four K rows of weights at a time,
//   so a float4 from shared memory feeds 16 or 32 FMAs. Each warp takes 16 K
//   rows of every stage; the partial sums are reduced through shared memory
//   (over the operand, once the GEMM's last stage is consumed) in a fixed
//   group order, so results are bit-identical from launch to launch.
// - Widths. The kernel is a template over F (PMK_DISPATCH_WIDTHS: 128, and
//   digits16's 64). A stage is 64 F-wide K rows (32 KB at F = 128, 16 KB at
//   64), so every weight matrix is whole stages and a warp takes 16 K rows
//   of each at both widths. A thread's float4 columns of an F-wide group
//   take F / 4 lanes: at F = 64 a warp's two half-warps take rows of their
//   own, a thread holds 8 x 4 or 4 x 8 accumulators (half the 128 build's)
//   and an epilogue thread 2 rows. At digits16's W = 4 a block owns 9
//   samples (36 of its 48 row slots).
//
// The level outputs (outv, outm) and v0, hup are written to global memory;
// outv and v0 are re-read, with plain loads, as the next level's carry (by
// the thread that wrote them) and as down levels' skips (after a
// __syncthreads).
//
// bf16 (a build with PM_CORE_BF16 = 1, the JAX kernel at cdtype bf16;
// sampler_common.cuh). The weights are bf16 in global memory, so a 32 KB
// stage carries twice the rows (128 F-wide or 64 2F-wide) and each warp
// takes 32 K rows of a stage; h_init_up at F = 64 (192 rows) ends in half
// a stage, which the first two K groups read. A thread unpacks four bf16
// weights of a row from one 8-byte load. Every operand value is rounded to
// bf16 as it is built (the operand stays float in shared memory). outv,
// outm, v0 and hup are stored rounded, and the down levels' skips read
// them so, as JAX's bf16 vstack; the carry (rounded in outv) stays float32
// in the epilogue threads' registers, as JAX's float32 carry: a thread's
// epilogue rows and columns are the same at every level. The skip product adds into conv_a's sums, where JAX
// adds a separately summed product: a difference of float32 summation
// order, like the split over K groups. Bound at the dense bf16 rate (989
// TFLOP/s): 0.152 ms at the flagship shapes.
//
// Shared memory (dynamic, floats): the ring 3 x 8192 (96 KB), the operand
// 2 x kSlots x 2F (108 KB), 3 mbarriers and 3 counts, the rows' operand
// rows (48 ints): 209,124 bytes of the 232,448 a block may have at F =
// 128, 104,676 at 64. One block of 384 threads per SM.
#include <cmath>
#include <cstdint>

#include "sampler_common.cuh"

namespace {

using namespace pmk;

constexpr int kRows = 48;     // row slots of a block's GEMMs (TS * W of them used)
constexpr int kSlots = 54;    // operand rows of a source: TS x (W + 2) columns
constexpr int kStages = 3;    // ring depth
constexpr int kWarpK = 16 * kCdtPerFloat;  // K rows of a stage each warp multiplies
constexpr int kBlock = 384;  // 12 warps
constexpr int kWarps = kBlock / 32;

// Samples a block owns at width W.
__host__ __device__ constexpr int samples_per_block(int W) {
  return kRows / W < kSlots / (W + 2) ? kRows / W : kSlots / (W + 2);
}

// K of a GEMM in segments of kseg rows: segment i reads source src0 + i /
// ntap at column shift i % 3 - 1 (ntap 3) or 0 (ntap 1).
struct Segs {
  int kseg, src0, ntap;
};

// cdt: the compute dtype's tensors (bf16 in a bf16 build); the biases are
// float32.
struct VrowArgs {
  const cdt *e2, *e1, *pv0, *pv, *pm, *cpv, *viw;
  const float* vib;
  const cdt* huw;
  const float* hub;
  const cdt* wav;
  const float* bav;
  const cdt* wbv;
  const float* bbv;
  const cdt* waux;
  cdt *outv, *outm, *v0, *hup;
  int L, W, n, TS;
};

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The block's rows: slot r < TS * W is (sample r / W, column r % W).
struct Rows {
  int W, n, TS, j0;
  __device__ int used() const { return TS * W; }
  // row r's row in an operand source (1 for an unused row: never kept)
  __device__ int slot(int r) const {
    return r < used() ? (r / W) * (W + 2) + r % W + 1 : 1;
  }
  // row r's offset in rows of a [W, n, C] tensor, its sample clamped into range
  __device__ size_t grow(int r) const {
    return (size_t)(r % W) * n + min(j0 + r / W, n - 1);
  }
  __device__ bool stored(int r) const { return r < used() && j0 + r / W < n; }
};

// The kernel at F filters (a built width: sampler_common.cuh
// PMK_DISPATCH_WIDTHS). A thread's columns are float4s of an F-wide group:
// kColLanes lanes cover the group, the warp's kRowLanes lane groups take
// rows of their own (one at F = 128, two at 64).
template <int F>
struct Vrow {
  static constexpr int kSrc = kSlots * 2 * F;  // floats of one operand source (rows of 2F)
  static constexpr int kStage = 64 * F;        // floats a stage (32 KB at F = 128)
  static constexpr int kStageElems = kStage * kCdtPerFloat;  // weights a stage
  static constexpr int kColLanes = F / 4;
  static constexpr int kRowLanes = 32 / kColLanes;
  static_assert(F % 64 == 0 && F <= 128, "the tiles take F = 64 or 128");

  // Shared memory layout, in floats.
  static constexpr int kOffOp = kStages * kStage;
  static constexpr int kOffBar = kOffOp + 2 * kSrc;      // uint64_t full[kStages]
  static constexpr int kOffDone = kOffBar + 2 * kStages;  // int done[kStages]
  static constexpr int kOffSlot = kOffDone + kStages;     // int [kRows]: each row's operand row
  static constexpr size_t kSmemBytes = (size_t)(kOffSlot + kRows) * sizeof(float);
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may have");
  static_assert(kOffBar % 2 == 0, "mbarriers are 8-byte aligned");

  // A product's register tile and its K split (see the header): G K groups
  // of warps, RW rows a warp, RT rows x CT columns a thread.
  template <int N>
  struct Tile {
    static constexpr int G = N == F ? 4 : 2;  // K groups
    static constexpr int RW = kRows / (kWarps / G);
    static constexpr int RT = RW / kRowLanes;
    static constexpr int CT = N == F ? 4 : 8;
    static constexpr int SR = kStageElems / N;  // K rows a stage
    static_assert(G * kWarpK == SR && RT * CT * kRowLanes == 64, "");
    static_assert(G * kRows * N <= 2 * kSrc, "the partials overlay the operand");
  };

  // Stages of the weight sequence: viw, huw, then wav[l], waux[l] (down
  // levels) and wbv[l] of each level (a matrix not whole stages ends in a
  // part of one).
  static constexpr int kViwStages = ceil_div(6 * F * F, kStageElems);
  static constexpr int kHuwStages = ceil_div(3 * F * F, kStageElems);
  static constexpr int kWavStages = ceil_div(12 * F * F, kStageElems);
  static constexpr int kAuxStages = ceil_div(2 * F * F, kStageElems);
  static constexpr int kWbvStages = ceil_div(12 * F * 2 * F, kStageElems);
  static constexpr int kUpStages = kWavStages + kWbvStages;
  static constexpr int kDownStages = kUpStages + kAuxStages;

  static __device__ __forceinline__ int total_stages(int L) {
    return kViwStages + kHuwStages + (L / 2) * (kUpStages + kDownStages);
  }

  // Stage st of a matrix of ELEMS weights at m: where it starts and its
  // weights, a stage or the part of one that ends a matrix not whole
  // stages (a constant in the float32 build, where every matrix is whole
  // stages).
  struct Span {
    const cdt* src;
    int count;
  };
  template <int ELEMS>
  static __device__ __forceinline__ Span span(const cdt* m, int st) {
    constexpr int kLast = ELEMS - (ceil_div(ELEMS, kStageElems) - 1) * kStageElems;
    return {m + (size_t)st * kStageElems,
            st + 1 < ceil_div(ELEMS, kStageElems) ? kStageElems : kLast};
  }

  // Stage g of the weight sequence.
  static __device__ Span stage_span(const VrowArgs& p, int g) {
    if (g < kViwStages) return span<6 * F * F>(p.viw, g);
    g -= kViwStages;
    if (g < kHuwStages) return span<3 * F * F>(p.huw, g);
    g -= kHuwStages;
    const int R = p.L / 2;
    int l;
    if (g < R * kUpStages) {
      l = g / kUpStages;
      g -= l * kUpStages;
    } else {
      g -= R * kUpStages;
      l = R + g / kDownStages;
      g -= (l - R) * kDownStages;
    }
    if (g < kWavStages) return span<12 * F * F>(p.wav + (size_t)l * 12 * F * F, g);
    g -= kWavStages;
    if (l >= R) {
      if (g < kAuxStages) return span<2 * F * F>(p.waux + (size_t)l * 2 * F * F, g);
      g -= kAuxStages;
    }
    return span<24 * F * F>(p.wbv + (size_t)l * 24 * F * F, g);
  }

  // The weight stream, without a producer warp: slot g % kStages holds stage
  // g while phase g / kStages of its "full" mbarrier runs (one arrival and
  // the stage's bytes); done[] counts the warps finished with a slot's
  // stage, and the last of them issues stage g + kStages into the slot.
  struct VStream {
    const VrowArgs* p;
    float* slots;
    uint64_t* full;
    int* done;
    int total, next;

    __device__ float* slot(int g) const { return slots + (g % kStages) * kStage; }
    // One thread: stage g's bulk copy into its slot.
    __device__ void issue(int g) const {
      const uint32_t bar = smem_u32(full + g % kStages);
      const Span s = stage_span(*p, g);
      mbar_expect_tx(bar, s.count * sizeof(cdt));
      bulk_g2s(smem_u32(slot(g)), s.src, s.count * sizeof(cdt), bar);
    }
    __device__ const float* take() const {
      mbar_wait(smem_u32(full + next % kStages), (next / kStages) & 1);
      return slot(next);
    }
    // This warp is done reading stage `next`.
    __device__ void release() {
      __syncwarp();
      if (threadIdx.x % 32 == 0) {
        __threadfence_block();
        if (atomicAdd(done + next % kStages, 1) == kWarps - 1) {
          done[next % kStages] = 0;
          __threadfence_block();
          fence_proxy_async();
          if (next + kStages < total) issue(next + kStages);
        }
      }
      ++next;
    }
  };

  // This thread's first row of Tile<N> and its columns' first: RT rows of
  // its warp's row group and lane group, columns col (+ F).
  template <int N>
  static __device__ __forceinline__ int tile_row0() {
    using T = Tile<N>;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    return (warp / T::G) * T::RW + (lane / kColLanes) * T::RT;
  }
  static __device__ __forceinline__ int tile_col() { return 4 * (threadIdx.x % 32 % kColLanes); }

  // acc (+)= the block's rows of A @ W over the KR rows of K the next stages
  // of the stream hold, A read from the operand as `sg` says (row r of a
  // source at operand row slot[r]); this thread's share: its Tile<N> rows
  // and columns, K group warp % G. The operand must be complete (a
  // __syncthreads after it was written).
  template <int N, int KR>
  static __device__ __forceinline__ void gemm(float (&acc)[Tile<N>::RT][Tile<N>::CT],
                                              VStream& stream, const float* op,
                                              const int* slot, Segs sg) {
    using T = Tile<N>;
    constexpr int nst = ceil_div(KR, T::SR);
    constexpr int kLast = KR - (nst - 1) * T::SR;  // rows of the last stage
    static_assert(kLast % kWarpK == 0, "a part stage holds whole K groups");
    const int col = tile_col(), grp = threadIdx.x / 32 % T::G, row0 = tile_row0<N>();
    for (int st = 0; st < nst; ++st) {
      if (kLast != T::SR && st + 1 == nst && grp * kWarpK >= kLast) {
        stream.take();
        stream.release();
        continue;
      }
      const int k = st * T::SR + grp * kWarpK;
      const int seg = k / sg.kseg, kc = k % sg.kseg;
      const int dx = sg.ntap == 3 ? seg % 3 - 1 : 0;
      const uint32_t a0 = smem_u32(op + (sg.src0 + seg / sg.ntap) * kSrc + dx * 2 * F + kc);
      uint32_t ar[T::RT];
#pragma unroll
      for (int i = 0; i < T::RT; ++i) ar[i] = a0 + slot[row0 + i] * 2 * F * sizeof(float);
      const cdt* ws = reinterpret_cast<const cdt*>(stream.take()) + grp * kWarpK * N + col;
#pragma unroll
      for (int k4 = 0; k4 < kWarpK; k4 += 4) {
        float w[4][T::CT];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 w0 = ldc4(ws + (k4 + j) * N);
          w[j][0] = w0.x, w[j][1] = w0.y, w[j][2] = w0.z, w[j][3] = w0.w;
          if constexpr (T::CT == 8) {
            const float4 w1 = ldc4(ws + (k4 + j) * N + F);
            w[j][4] = w1.x, w[j][5] = w1.y, w[j][6] = w1.z, w[j][7] = w1.w;
          }
        }
#pragma unroll
        for (int i = 0; i < T::RT; ++i) {
          const float4 a4 = lds4(ar[i] + k4 * sizeof(float));
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int u = 0; u < T::CT; ++u) acc[i][u] = fmaf(a[j], w[j][u], acc[i][u]);
        }
      }
      stream.release();
    }
  }

  template <int N>
  static __device__ __forceinline__ void zero(float (&acc)[Tile<N>::RT][Tile<N>::CT]) {
#pragma unroll
    for (int i = 0; i < Tile<N>::RT; ++i)
#pragma unroll
      for (int u = 0; u < Tile<N>::CT; ++u) acc[i][u] = 0.f;
  }

  // Writes each warp's partial sums to P ([G][kRows][N]) once every warp is
  // done with the operand P overlays.
  template <int N>
  static __device__ __forceinline__ void store_partials(
      float* P, const float (&acc)[Tile<N>::RT][Tile<N>::CT]) {
    using T = Tile<N>;
    const int col = tile_col(), grp = threadIdx.x / 32 % T::G, row0 = tile_row0<N>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < T::RT; ++i) {
      float* dst = P + (grp * kRows + row0 + i) * N + col;
      st4(dst, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      if constexpr (T::CT == 8)
        st4(dst + F, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
    }
    __syncthreads();
  }

  // The sum of the partials at (row r, columns col..col + 3), in group order.
  template <int N>
  static __device__ __forceinline__ float4 reduced(const float* P, int r, int col) {
    float4 s = ld4(P + r * N + col);
#pragma unroll
    for (int g = 1; g < Tile<N>::G; ++g) s = add4(s, ld4(P + (g * kRows + r) * N + col));
    return s;
  }

  // Zeros in channels [0, CH) of the halo rows of operand source dst.
  template <int CH>
  static __device__ __forceinline__ void zero_halo(float* dst, const Rows& rw) {
    for (int idx = threadIdx.x; idx < CH * 2 * rw.TS; idx += kBlock) {
      const int h = idx / CH, e = idx % CH;
      dst[((h / 2) * (rw.W + 2) + (h % 2 ? rw.W + 1 : 0)) * 2 * F + e] = 0.f;
    }
  }

  // Operand source dst from C-wide rows of X ([W, n, C]): the raw values
  // (channels [0, C)) or their concat_elu (channels [0, 2C)), rounded to the
  // compute dtype, and zeros in the halo rows. Every load is issued before the first store. X is read through
  // the read-only path when `kRo`; outputs of this kernel are not. (The outer
  // loop runs once; written out without it, ptxas spilled more and the kernel
  // took 11% longer on an H100.)
  template <int C, bool kCelu, bool kRo>
  static __device__ __forceinline__ void build(float* dst, const cdt* X, const Rows& rw) {
    constexpr int kBatch = kRows * C / kBlock;  // every element in one batch
    const int tid = threadIdx.x, total = rw.used() * C;
    for (int base = tid; base < total; base += kBatch * kBlock) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kBlock;
        v[u] = 0.f;
        if (idx < total) {
          const cdt* src = X + rw.grow(idx / C) * C + idx % C;
          v[u] = to_f(kRo ? __ldg(src) : *src);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kBlock;
        if (idx >= total) continue;
        float* d = dst + rw.slot(idx / C) * 2 * F + idx % C;
        if (kCelu) {
          d[0] = round_c(elu(v[u]));
          d[C] = round_c(elu(-v[u]));
        } else {
          d[0] = v[u];  // a value of the compute dtype
        }
      }
    }
    zero_halo<kCelu ? 2 * C : C>(dst, rw);
  }

  // In every epilogue thread t owns rows t / kColLanes + (kBlock /
  // kColLanes) q (q < kEpiRows) and columns 4 (t % kColLanes)..+3: a level's
  // a and its output are float4 x[kEpiRows] in these.
  static constexpr int kEpiRows = kRows * kColLanes / kBlock;
  static constexpr int kEpiStep = kBlock / kColLanes;
  static __device__ __forceinline__ int epi_row(int q) {
    return threadIdx.x / kColLanes + kEpiStep * q;
  }
  static __device__ __forceinline__ int epi_col() { return 4 * (threadIdx.x % kColLanes); }

  // Operand source dst = concat_elu of the epilogue's values x, rounded to the
  // compute dtype, with zero halo rows.
  static __device__ __forceinline__ void build_celu(float* dst, const float4 (&x)[kEpiRows],
                                                    const Rows& rw) {
    const int col = epi_col();
#pragma unroll
    for (int q = 0; q < kEpiRows; ++q) {
      const int r = epi_row(q);
      if (r >= rw.used()) continue;
      float* d = dst + rw.slot(r) * 2 * F + col;
      st4(d, round_c4(make_float4(elu(x[q].x), elu(x[q].y), elu(x[q].z), elu(x[q].w))));
      st4(d + F,
          round_c4(make_float4(elu(-x[q].x), elu(-x[q].y), elu(-x[q].z), elu(-x[q].w))));
    }
    zero_halo<2 * F>(dst, rw);
  }

  static __device__ __forceinline__ void run(const VrowArgs& p) {
    extern __shared__ __align__(16) float smem[];
    float* op = smem + kOffOp;  // operand sources 0 and 1, or the partial sums
    float* op1 = op + kSrc;
    int* slot = reinterpret_cast<int*>(smem + kOffSlot);
    VStream stream{&p, smem, reinterpret_cast<uint64_t*>(smem + kOffBar),
                   reinterpret_cast<int*>(smem + kOffDone), total_stages(p.L), 0};
    const int tid = threadIdx.x;
    const int W = p.W, n = p.n, L = p.L, R = p.L / 2;
    const Rows rw{W, n, p.TS, (int)blockIdx.x * p.TS};
    if (tid == 0) {
      for (int i = 0; i < kStages; ++i) {
        mbar_init(smem_u32(stream.full + i), 1);
        stream.done[i] = 0;
      }
      mbar_fence_init();
      for (int g = 0; g < kStages; ++g) stream.issue(g);
    }
    if (tid < kRows) slot[tid] = rw.slot(tid);
    __syncthreads();

    const size_t lvF = (size_t)W * n * F;  // one level of an [L, W, n, F] tensor
    const int ecol = epi_col();
    int erow[kEpiRows];
#pragma unroll
    for (int q = 0; q < kEpiRows; ++q) erow[q] = epi_row(q);

    // the carry: v0, then each level's output (float32 in either build)
    float4 x[kEpiRows];

    // ---- v_init (rows r-2, r-1) and h_init_up (row r-1) --------------------
    {
      build<F, false, true>(op, p.e2, rw);
      build<F, false, true>(op1, p.e1, rw);
      __syncthreads();
      float acc[Tile<F>::RT][Tile<F>::CT];
      zero<F>(acc);
      gemm<F, 6 * F>(acc, stream, op, slot, Segs{F, 0, 3});
      store_partials<F>(op, acc);
      const float4 vb = ld4(p.vib + ecol);
#pragma unroll
      for (int q = 0; q < kEpiRows; ++q) {
        x[q] = add4(reduced<F>(op, erow[q], ecol), vb);
        if (rw.stored(erow[q])) stc4(p.v0 + rw.grow(erow[q]) * F + ecol, x[q]);
      }
      __syncthreads();
      build<F, false, true>(op1, p.e1, rw);
      __syncthreads();
      zero<F>(acc);
      gemm<F, 3 * F>(acc, stream, op, slot, Segs{F, 1, 3});
      store_partials<F>(op, acc);
      const float4 hb = ld4(p.hub + ecol);
#pragma unroll
      for (int q = 0; q < kEpiRows; ++q)
        if (rw.stored(erow[q]))
          stc4(p.hup + rw.grow(erow[q]) * F + ecol, add4(reduced<F>(op, erow[q], ecol), hb));
      __syncthreads();
      build<F, true, true>(op, p.pv0, rw);
      build_celu(op1, x, rw);
      __syncthreads();
    }

    // ---- the L gated vertical levels ----------------------------------------
    for (int l = 0; l < L; ++l) {
      cdt* outv_l = p.outv + l * lvF;
      cdt* outm_l = p.outm + l * 2 * lvF;

      // conv_a (+ the skip product) and m = concat_elu(a)
      float4 a[kEpiRows];
      {
        float acc[Tile<F>::RT][Tile<F>::CT];
        zero<F>(acc);
        gemm<F, 12 * F>(acc, stream, op, slot, Segs{2 * F, 0, 3});
        if (l >= R) {
          // down level: skip = the vertical stack entry 2R-1-l of this row
          // (entry 0 is v0, entry k >= 1 the output of level k-1)
          const int s = 2 * R - 1 - l;
          __syncthreads();
          build<F, true, false>(op, s == 0 ? p.v0 : p.outv + (s - 1) * lvF, rw);
          __syncthreads();
          gemm<F, 2 * F>(acc, stream, op, slot, Segs{2 * F, 0, 1});
        }
        store_partials<F>(op, acc);
        const float4 ba = ld4(p.bav + l * F + ecol);
#pragma unroll
        for (int q = 0; q < kEpiRows; ++q) a[q] = add4(reduced<F>(op, erow[q], ecol), ba);
      }
      __syncthreads();
      build_celu(op1, a, rw);
#pragma unroll
      for (int q = 0; q < kEpiRows; ++q) {
        if (!rw.stored(erow[q])) continue;
        cdt* dst = outm_l + rw.grow(erow[q]) * 2 * F + ecol;
        stc4(dst, make_float4(elu(a[q].x), elu(a[q].y), elu(a[q].z), elu(a[q].w)));
        stc4(dst + F, make_float4(elu(-a[q].x), elu(-a[q].y), elu(-a[q].z), elu(-a[q].w)));
      }
      build<2 * F, false, true>(op, p.pm + l * 2 * lvF, rw);
      __syncthreads();

      // conv_b, the gate and the residual
      {
        float acc[Tile<2 * F>::RT][Tile<2 * F>::CT];
        zero<2 * F>(acc);
        gemm<2 * F, 12 * F>(acc, stream, op, slot, Segs{2 * F, 0, 3});
        store_partials<2 * F>(op, acc);
      }
      const float* bb = p.bbv + l * 2 * F;
      const float4 b_a = ld4(bb + ecol), b_g = ld4(bb + F + ecol);
      if constexpr (!kBF16) {
        // the carry in_cur, as this thread wrote it (v0 or the last level's
        // outv; kept in registers in bf16, where those are rounded)
        const cdt* in_cur = l == 0 ? p.v0 : p.outv + (l - 1) * lvF;
#pragma unroll
        for (int q = 0; q < kEpiRows; ++q) x[q] = ldc4(in_cur + rw.grow(erow[q]) * F + ecol);
      }
#pragma unroll
      for (int q = 0; q < kEpiRows; ++q) {
        const int r = erow[q];
        const cdt* cp = p.cpv + ((size_t)l * n + min(rw.j0 + r / W, n - 1)) * 2 * F;
        const float4 ra = add4(add4(reduced<2 * F>(op, r, ecol), b_a), ldc4(cp + ecol));
        const float4 rg = add4(add4(reduced<2 * F>(op, r, F + ecol), b_g), ldc4(cp + F + ecol));
        x[q].x += sigmoid(rg.x) * ra.x;
        x[q].y += sigmoid(rg.y) * ra.y;
        x[q].z += sigmoid(rg.z) * ra.z;
        x[q].w += sigmoid(rg.w) * ra.w;
        if (rw.stored(r)) stc4(outv_l + rw.grow(r) * F + ecol, x[q]);
      }
      __syncthreads();
      if (l + 1 < L) {
        build<F, true, true>(op, p.pv + l * lvF, rw);
        build_celu(op1, x, rw);
        __syncthreads();
      }
    }
  }
};

template <int F>
__global__ void __launch_bounds__(kBlock, 1) vrow_kernel(const VrowArgs p) {
  Vrow<F>::run(p);
}

}  // namespace

// Launches one image row. Tensors are contiguous, 16-byte aligned, on the
// device of `stream`, cdt (bf16 in a bf16 build) or float32 as VrowArgs
// says; shapes as in posterior_matching_torch/ops/sampler_chain.py::
// vrow_plain with F a built width (PMK_DISPATCH_WIDTHS), 1 <= W <= 32.
// `bf16` must be this build's (1 for the bf16 build). Returns
// cudaGetLastError() after the launch.
extern "C" int pm_sampler_vrow(
    const cdt* e2, const cdt* e1, const cdt* pv0, const cdt* pv,
    const cdt* pm, const cdt* cpv, const cdt* viw, const float* vib,
    const cdt* huw, const float* hub, const cdt* wav, const float* bav,
    const cdt* wbv, const float* bbv, const cdt* waux, cdt* outv,
    cdt* outm, cdt* v0, cdt* hup, int L, int W, int n, int filters, int bf16,
    void* stream) {
  if (W < 1 || W > 32 || n < 1 || L < 2 || L % 2 || bf16 != (int)kBF16)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {e2,  e1,  pv0, pv,   pm,   cpv,  viw, vib, huw, hub,
                        wav, bav, wbv, bbv, waux, outv, outm, v0,  hup};
  for (const void* q : ptrs)
    if (reinterpret_cast<uintptr_t>(q) % 16) return (int)cudaErrorInvalidValue;
  const int ts = samples_per_block(W);
  const VrowArgs p{e2,  e1,  pv0, pv,   pm,   cpv,  viw, vib, huw, hub, wav,
                   bav, wbv, bbv, waux, outv, outm, v0,  hup, L,   W,   n,   ts};
  const int blocks = (n + ts - 1) / ts;
  // one width's kernel, with its shared memory
  auto launch = [&](void (*kernel)(VrowArgs), size_t smem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return (int)cudaGetLastError();
  };
  PMK_DISPATCH_WIDTHS(filters, launch(vrow_kernel<F>, Vrow<F>::kSmemBytes));
}

// Blocks of a launch at width W and n samples (0 for a width it refuses).
extern "C" int pm_sampler_vrow_blocks(int W, int n) {
  if (W < 1 || W > 32 || n < 1) return 0;
  return (n + samples_per_block(W) - 1) / samples_per_block(W);
}
