// Nearest-codebook search of the VQ-VAE encoder.
//
// Replaces posterior_matching_tpu/ops/vq.py::_vq_kernel (Pallas, grid over
// 1024-row tiles of z, pallas_call at :68): idx[n] = argmax_k (2 z_n.e_k -
// |e_k|^2), ties to the lower index, without writing the [N, K] scores out.
//
// Bound: operations. At the flagship shapes (N = 32*16*16 = 8192 latents,
// K = 512 codes, D = 64) the scores are 2*N*K*D = 0.54 GFLOP of float32
// FMAs (8 us at 67 TFLOP/s) against 2.2 MB of inputs (0.7 us at 3.35 TB/s).
//
// Design. Each block owns kRows = 32 rows of z, staged in shared memory
// once, and sweeps the codebook in chunks of kCodes = 64 codes (staged with
// their norms; both row-padded to D + 1 floats so the lanes of a warp hit
// different banks). Thread t scores row t / 8 against codes t % 8 + 8 j of
// each chunk, so every thread visits its codes in increasing order and a
// strict '>' keeps the lowest index among its equal maxima. The 8 threads
// of a row then reduce through warp shuffles, comparing indices on equal
// scores, so ties go to the lowest index overall. Scores are
// 2.f * dot - norm, the plain version's arithmetic; the dot product runs
// over d in order, so near-ties (gaps at float32 rounding) may resolve
// differently from the plain version's matmul, exact ties never do.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;                 // z rows per block
constexpr int kLanes = kThreads / kRows;  // threads per row
constexpr int kCodes = 64;                // codes per staged chunk
constexpr int kMaxD = 256;

__global__ void __launch_bounds__(kThreads)
    vq_search_kernel(const float* __restrict__ z, const float* __restrict__ cb,
                     const float* __restrict__ cb_norm, int* __restrict__ out,
                     int N, int K, int D) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sz = smem;                   // [kRows][D + 1]
  float* se = sz + kRows * ld;        // [kCodes][D + 1]
  float* sn = se + kCodes * ld;       // [kCodes]
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kRows;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    sz[r * ld + d] = n0 + r < N ? z[(size_t)(n0 + r) * D + d] : 0.f;
  }
  const int row = tid / kLanes, lane = tid % kLanes;
  const float* zr = sz + row * ld;
  float best = -INFINITY;
  int best_k = 0;
  for (int k0 = 0; k0 < K; k0 += kCodes) {
    __syncthreads();  // the previous chunk is consumed (and z is staged)
    for (int i = tid; i < kCodes * D; i += kThreads) {
      const int c = i / D, d = i % D;
      se[c * ld + d] = k0 + c < K ? cb[(size_t)(k0 + c) * D + d] : 0.f;
    }
    for (int c = tid; c < kCodes; c += kThreads)
      sn[c] = k0 + c < K ? cb_norm[k0 + c] : 0.f;
    __syncthreads();
    for (int c = lane; c < kCodes && k0 + c < K; c += kLanes) {
      const float* ec = se + c * ld;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(zr[d], ec[d], dot);
      const float s = 2.f * dot - sn[c];
      if (s > best) {
        best = s;
        best_k = k0 + c;
      }
    }
  }
  // the kLanes threads of a row are consecutive lanes of one warp
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) {
    const float os = __shfl_xor_sync(0xffffffffu, best, off);
    const int ok = __shfl_xor_sync(0xffffffffu, best_k, off);
    if (os > best || (os == best && ok < best_k)) {
      best = os;
      best_k = ok;
    }
  }
  if (lane == 0 && n0 + row < N) out[n0 + row] = best_k;
}

}  // namespace

// z [N, D], codebook [K, D], cb_norm [K] (|e_k|^2) float32, out [N] int32,
// all contiguous on the device of `stream`. Returns cudaGetLastError()
// after the launch.
extern "C" int pm_vq_search(const float* z, const float* cb,
                            const float* cb_norm, int* out, int N, int K,
                            int D, void* stream) {
  if (N < 1 || K < 1 || D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)(kRows + kCodes) * (D + 1) + kCodes);
  cudaError_t err = cudaFuncSetAttribute(
      vq_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + kRows - 1) / kRows;
  vq_search_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      z, cb, cb_norm, out, N, K, D);
  return (int)cudaGetLastError();
}

extern "C" const char* pm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
