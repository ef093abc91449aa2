// Nearest-codebook search of the VQ-VAE encoder.
//
// Replaces posterior_matching_tpu/ops/vq.py::_vq_kernel (Pallas, grid over
// 1024-row tiles of z, pallas_call at :68): idx[n] = argmax_k (2 z_n.e_k -
// |e_k|^2), ties to the lower index, without writing the [N, K] scores out.
//
// Bound: operations. At the PM-VQVAE training shapes (N = 32*16*16 = 8192
// latents, K = 512 codes, D = 64) the scores are 2*N*K*D = 0.54 GFLOP:
// 3.3 us as 3 TF32 products at 495 TFLOP/s (8.0 us as float32 FMAs at 67
// TFLOP/s) against 2.3 MB of inputs and output (0.7 us at 3.35 TB/s).
//
// Design: one launch a call, nothing before or after it.
// - A block owns TM rows of z and sweeps all K codes: WN x WR warps, each
//   MT m16 row tiles x 2 n8 tiles (16 codes) of one of WN code groups. TM
//   is the largest of 128, 64 and 32 rows (MT = 2) whose grid fills 7/8 of
//   a wave of SMs, else 16 (MT = 1): 64 at 8192 latents, 128 at 16,384.
//   WN is 8 (chunks of 128 codes), or 4 (chunks of 64) for the 128-row
//   blocks and the wide codes, so an SM holds 16 warps at both training
//   shapes. z's tile is staged once, split into TF32 big + small parts and
//   stored in the mma fragment order (a lane's A fragment of one row is
//   one 16-byte load).
// - The codebook streams through a cp.async ring of NS stages of a chunk
//   (rows of DP + 4 floats, so a warp's B fragment loads hit distinct
//   banks; codes past K and dims past D land as zeros). D is padded to a
//   compile-time depth DP (64, or 256 for wider codes), so the loops over
//   it unroll.
// - Scores on the tensor cores: mma.sync.m16n8k8 TF32 with the 3xTF32 split
//   (a_small b_big + a_big b_small + a_big b_big; about 21 significand
//   bits). Each 16-deep step's MMAs start from zero and are added into a
//   float32 accumulator, so the tensor cores' truncating sums span 6 MMAs.
//   A B fragment, loaded and split once, feeds both m16 tiles of a warp.
// - |e_k|^2 comes from the B fragments as they are loaded: a lane squares
//   the dims of its code congruent to its t mod 4 in order, and the quad's
//   four partial sums are added by two xor shuffles. The arithmetic for a
//   code is the same wherever the code sits, so equal codes give bit-equal
//   scores and exact ties stay exact.
// - The argmax stays in registers: each lane walks its codes in increasing
//   order with a strict '>' (rows g and g + 8 of each m16 tile); then the
//   quad is merged by shuffles and the WN code groups through shared
//   memory, comparing indices on equal scores, so ties go to the lowest
//   index.
// (Measured on an NVIDIA H100 80GB HBM3 at 700 W, at 8192 latents: 18.2 us.
// Warps of one m16 tile on 32-row blocks with 8-deep partial sums and a
// runtime depth took 25.5; the same with two m16 tiles, a compile-time
// depth and 16-deep partial sums but 4 code groups (8 warps an SM) 20.4;
// rings of 5 or 8 stages were no faster. vq_breakdown.py times the parts.)
//
// Everything from "---- launches" on is host code (the CPU emulation of
// tests/cuda_emulation replaces the launch line).
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx_mma.cuh"

namespace {

constexpr int kMaxD = 256;
constexpr int kNW8 = 2;             // n8 tiles a warp holds
constexpr int kCW = 8 * kNW8;       // codes of a warp a chunk
constexpr unsigned kFull = 0xffffffffu;

// ---- geometry ----------------------------------------------------------------

// Pitch of a staged code row: DP + 4 floats, so the 8 codes x 4 dims of a
// warp's B fragment load hit 32 distinct banks.
__host__ __device__ constexpr int code_pitch(int DP) { return DP + 4; }
// Pitch of a staged, split z row (2 DP floats): 16 mod 32, so the two rows
// of a quarter-warp's 16-byte loads hit distinct banks.
__host__ __device__ constexpr int row_pitch(int DP) {
  return 2 * DP + (2 * DP % 32 == 16 ? 0 : 16);
}
// Floats of the dynamic shared memory of a block of TM rows, WN code
// groups, NS stages and depth DP: the code ring (chunks of 16 WN codes),
// z's tile, and each code group's best score and index per row.
__host__ __device__ constexpr int smem_floats(int TM, int WN, int NS, int DP) {
  return NS * kCW * WN * code_pitch(DP) + TM * row_pitch(DP) + 2 * WN * TM;
}

// ---- the kernel ------------------------------------------------------------

// Stores 8 consecutive values of a row (dims 8j .. 8j + 7) split, in the
// fragment order of the 8-dim group at `dst`: [big(t), big(t + 4),
// small(t), small(t + 4)] for t = 0..3.
__device__ __forceinline__ void store_group(float* dst, const float (&v)[8]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 lo = split_tf32(v[t]), hi = split_tf32(v[t + 4]);
    *reinterpret_cast<float4*>(dst + 4 * t) = make_float4(lo.x, hi.x, lo.y, hi.y);
  }
}

// Stages codes [k0, k0 + KC) into `dst` (rows of DP + 4 floats; zeros past
// K and past D), as one committed cp.async group of this thread.
template <int KC, int DP, int NT>
__device__ __forceinline__ void stage_codes(float* dst, const float* cb, int k0, int K, int D,
                                            int vec) {
  constexpr int PB = code_pitch(DP);
  if (vec) {
    constexpr int segs = DP / 4;
    for (int i = threadIdx.x; i < KC * segs; i += NT) {
      const int c = i / segs, q = 4 * (i % segs);
      const bool ok = k0 + c < K && q < D;
      cp_async16(smem_u32(dst + c * PB + q), ok ? cb + (size_t)(k0 + c) * D + q : cb,
                 ok ? 16u : 0u);
    }
  } else {
    for (int i = threadIdx.x; i < KC * DP; i += NT) {
      const int c = i / DP, d = i % DP;
      const bool ok = k0 + c < K && d < D;
      cp_async4(smem_u32(dst + c * PB + d), ok ? cb + (size_t)(k0 + c) * D + d : cb,
                ok ? 4u : 0u);
    }
  }
  cp_async_commit();
}

// Takes (s, k) where it beats (best, bk): a higher score, or an equal one
// at a lower index.
__device__ __forceinline__ void merge(float& best, int& bk, float s, int k) {
  if (s > best || (s == best && k < bk)) {
    best = s;
    bk = k;
  }
}

// z [N, D], cb [K, D] float32, out [N] int32; `vec`: D % 4 == 0 and both
// inputs 16-byte aligned. A block: TM = 16 MT WR rows, WN x WR warps, a
// warp MT m16 tiles (rows m0 + 16 mt + g, + 8) x kNW8 n8 tiles of its code
// group; chunks of KC = 16 WN codes; D padded with zeros to DP = 8 DG.
template <int MT, int WR, int WN, int NS, int DG>
__global__ void __launch_bounds__(32 * WN * WR)
    vq_search_kernel(const float* __restrict__ z, const float* __restrict__ cb,
                     int* __restrict__ out, int N, int K, int D, int vec) {
  constexpr int TM = 16 * MT * WR, NT = 32 * WN * WR, DP = 8 * DG, KC = kCW * WN;
  constexpr int PB = code_pitch(DP), PA = row_pitch(DP);
  static_assert(DG % 2 == 0, "the partial sums span 16-deep steps");
  extern __shared__ __align__(16) float smem[];
  float* sB = smem;                       // [NS][KC][PB]
  float* sA = sB + NS * KC * PB;          // [TM][PA], split, fragment order
  float* sS = sA + TM * PA;               // [WN][TM] best scores
  int* sK = reinterpret_cast<int*>(sS + WN * TM);  // [WN][TM] their codes
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = 16 * MT * (warp / WN), wn = warp % WN;
  const int n0 = blockIdx.x * TM;
  const int chunks = (K + KC - 1) / KC;

  // the ring's first NS - 1 chunks in flight while z's tile is staged
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < chunks) stage_codes<KC, DP, NT>(sB + s * KC * PB, cb, s * KC, K, D, vec);
    else cp_async_commit();
  }
  for (int i = tid; i < TM * DG; i += NT) {
    const int r = i / DG, d0 = 8 * (i % DG);
    const float* src = z + (size_t)(n0 + r) * D + d0;
    float v[8];
    if (n0 + r >= N || d0 >= D) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    } else if (vec) {
      const float4 lo = *reinterpret_cast<const float4*>(src);
      const float4 hi = d0 + 4 < D ? *reinterpret_cast<const float4*>(src + 4)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
      v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
      v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = d0 + e < D ? src[e] : 0.f;
    }
    store_group(sA + r * PA + 16 * (i % DG), v);
  }

  // best[2 mt + h]: row m0 + 16 mt + g + 8 h over this lane's codes
  float best[2 * MT];
  int bk[2 * MT];
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) best[r] = -INFINITY, bk[r] = 0;
  const float* a0 = sA + (m0 + g) * PA + 4 * t;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait_ring<NS>();
    __syncthreads();  // chunk c landed for all; chunk c - 1's stage is free
    const int nxt = c + NS - 1;
    if (nxt < chunks) stage_codes<KC, DP, NT>(sB + (nxt % NS) * KC * PB, cb, nxt * KC, K, D, vec);
    else cp_async_commit();
    const int kc = c * KC + wn * kCW;  // this warp's first code
    if (kc >= K) continue;              // warp-uniform: none of its codes is real
    const float* b = sB + (c % NS) * KC * PB + (wn * kCW + g) * PB + t;
    float acc[MT][kNW8][4] = {}, nrm[kNW8] = {};
#pragma unroll
    for (int j2 = 0; j2 < DG; j2 += 2) {
      // each 16-deep step's MMAs start from zero
      float part[MT][kNW8][4] = {};
#pragma unroll
      for (int j = j2; j < j2 + 2; ++j) {
        uint32_t bb[kNW8][2], bs[kNW8][2];
#pragma unroll
        for (int u = 0; u < kNW8; ++u)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            // b0 (k = t, n = g), b1 (t + 4, g) of code tile u
            const float x = b[u * 8 * PB + 8 * j + 4 * i];
            nrm[u] = fmaf(x, x, nrm[u]);
            const float2 sp = split_tf32(x);
            bb[u][i] = __float_as_uint(sp.x);
            bs[u][i] = __float_as_uint(sp.y);
          }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float4 va0 = *reinterpret_cast<const float4*>(a0 + 16 * mt * PA + 16 * j);
          const float4 va1 = *reinterpret_cast<const float4*>(a0 + (16 * mt + 8) * PA + 16 * j);
          const uint32_t ab[4] = {__float_as_uint(va0.x), __float_as_uint(va1.x),
                                  __float_as_uint(va0.y), __float_as_uint(va1.y)};
          const uint32_t as[4] = {__float_as_uint(va0.z), __float_as_uint(va1.z),
                                  __float_as_uint(va0.w), __float_as_uint(va1.w)};
#pragma unroll
          for (int u = 0; u < kNW8; ++u) mma_tf32(part[mt][u], as, bb[u]);
#pragma unroll
          for (int u = 0; u < kNW8; ++u) mma_tf32(part[mt][u], ab, bs[u]);
#pragma unroll
          for (int u = 0; u < kNW8; ++u) mma_tf32(part[mt][u], ab, bb[u]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int u = 0; u < kNW8; ++u)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][u][i] += part[mt][u][i];
    }
#pragma unroll
    for (int u = 0; u < kNW8; ++u) {
      // the quad's partial norms of code 8u + g, then those of this lane's
      // columns 2t and 2t + 1 (from the quads of lanes 8t and 8t + 4)
      float q = nrm[u];
      q += __shfl_xor_sync(kFull, q, 1);
      q += __shfl_xor_sync(kFull, q, 2);
      const float ne = __shfl_sync(kFull, q, 8 * t);
      const float no = __shfl_sync(kFull, q, 8 * t + 4);
      const int ce = kc + 8 * u + 2 * t;
      // c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (ce < K) {
          const float s0 = 2.f * acc[mt][u][0] - ne, s2 = 2.f * acc[mt][u][2] - ne;
          if (s0 > best[2 * mt]) best[2 * mt] = s0, bk[2 * mt] = ce;
          if (s2 > best[2 * mt + 1]) best[2 * mt + 1] = s2, bk[2 * mt + 1] = ce;
        }
        if (ce + 1 < K) {
          const float s1 = 2.f * acc[mt][u][1] - no, s3 = 2.f * acc[mt][u][3] - no;
          if (s1 > best[2 * mt]) best[2 * mt] = s1, bk[2 * mt] = ce + 1;
          if (s3 > best[2 * mt + 1]) best[2 * mt + 1] = s3, bk[2 * mt + 1] = ce + 1;
        }
      }
    }
  }

  // the quad's four lanes, then the WN code groups in order
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
#pragma unroll
    for (int off = 1; off <= 2; off *= 2)
      merge(best[r], bk[r], __shfl_xor_sync(kFull, best[r], off),
            __shfl_xor_sync(kFull, bk[r], off));
    if (t == 0) {
      const int row = m0 + 16 * (r / 2) + 8 * (r % 2) + g;
      sS[wn * TM + row] = best[r], sK[wn * TM + row] = bk[r];
    }
  }
  __syncthreads();
  if (tid < TM && n0 + tid < N) {
    float s = sS[tid];
    int k = sK[tid];
    for (int w = 1; w < WN; ++w) merge(s, k, sS[w * TM + tid], sK[w * TM + tid]);
    out[n0 + tid] = k;
  }
}

// ---- launches ----------------------------------------------------------------

constexpr int kSmemMax = 232448;  // bytes of shared memory a block may have
constexpr int kNS64 = 3;          // ring stages of the 64-deep builds

// Blocks a launch counts as filling a wave of the H100's 132 SMs: 7/8 of
// them (so 8192 latents take 128 blocks of 64 rows). A build may set
// fewer: the CPU emulation's tests give toy runs each row tile.
#ifndef PM_VQ_WAVE_BLOCKS
#define PM_VQ_WAVE_BLOCKS 116
#endif

// Devices on which each kernel instance has its shared-memory limit raised
// (a bit per device), set once per instance and device: this file's own,
// as every kernel library is loaded on its own.
unsigned long long g_smem_limit_set[6];

template <int MT, int WR, int WN, int NS, int DG, int Which>
int launch(const float* z, const float* cb, int* out, int N, int K, int D, int vec,
           cudaStream_t stream) {
  constexpr int TM = 16 * MT * WR;
  constexpr int smem_bytes = 4 * smem_floats(TM, WN, NS, 8 * DG);
  static_assert(smem_bytes <= kSmemMax, "shared memory");
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev % 64);
  if (!(g_smem_limit_set[Which] & bit)) {
    err = cudaFuncSetAttribute(vq_search_kernel<MT, WR, WN, NS, DG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return (int)err;
    g_smem_limit_set[Which] |= bit;
  }
  const dim3 grid((N + TM - 1) / TM);
  const int threads = 32 * WN * WR;
  vq_search_kernel<MT, WR, WN, NS, DG><<<grid, threads, smem_bytes, stream>>>(z, cb, out, N, K, D, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// z [N, D], codebook [K, D] float32, out [N] int32, all contiguous on the
// device of `stream`. One kernel launch; returns cudaGetLastError() after it.
// D <= 64 runs 64 deep (3 ring stages), wider D 256 deep (2 stages). The row
// tile is the largest of 128, 64 and 32 rows (warps of two m16 tiles; 32
// only where D > 64) whose grid fills a wave, else 16 (warps of one).
extern "C" int pm_vq_search(const float* z, const float* cb, int* out, int N, int K, int D,
                            void* stream) {
  if (N < 1 || K < 1 || D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  const int vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(cb) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int wave = PM_VQ_WAVE_BLOCKS;
  auto fills = [&](int tm) { return (N + tm - 1) / tm >= wave; };
  if (D <= 64) {
    if (fills(128)) return launch<2, 4, 4, kNS64, 8, 0>(z, cb, out, N, K, D, vec, s);
    if (fills(64)) return launch<2, 2, 8, kNS64, 8, 1>(z, cb, out, N, K, D, vec, s);
    if (fills(32)) return launch<2, 1, 8, kNS64, 8, 2>(z, cb, out, N, K, D, vec, s);
    return launch<1, 1, 8, kNS64, 8, 3>(z, cb, out, N, K, D, vec, s);
  }
  if (fills(32)) return launch<2, 1, 4, 2, 32, 4>(z, cb, out, N, K, D, vec, s);
  return launch<1, 1, 4, 2, 32, 5>(z, cb, out, N, K, D, vec, s);
}

extern "C" const char* pm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
