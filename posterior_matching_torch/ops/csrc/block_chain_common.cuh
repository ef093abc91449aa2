// Shared pieces of the VDVAE encoder's block-chain kernels
// (block_chain_fwd.cu, block_chain_bwd.cu, each with its pointer layout):
// the (width, bottleneck) pairs they are built for and the error string of
// their C entry points. The products run on vdvae_gemm.cuh's tensor-core
// core, here in namespace bck (the decoder chain's copy is dck).
//
// A level of a run is one bottleneck Block, gelu -> c1 (1x1, C -> M) ->
// gelu -> c2 (k x k) -> gelu -> c3 (k x k) -> gelu -> c4 (1x1, M -> C),
// plus the level's input.
//
// Each source is built twice: in float32 and with -DPM_CORE_BF16=1 for
// compute_dtype bfloat16 (ops/_build.py's *_bf16 libraries), where, as in
// the Pallas kernels (block_chain.py:282-301, 345-347), c1..c3 and their
// gradients are bf16 products with float32 sums (w1..w3 and the h1..h3
// saves bf16), and c4, the residual stream, the biases and every gradient
// stay float32.
#pragma once

#define PM_CORE_NS bck
#include "vdvae_gemm.cuh"

// (width, bottleneck) pairs the kernels are built for: PM-VDVAE MNIST
// (configs/pm_vdvae_mnist.py, 192 x 0.25) and digits16
// (configs/pm_vdvae_digits16.py, 64 x 0.25). `return run<C, M>(...)` for the
// geometry's pair, cudaErrorInvalidValue for any other.
#define BCK_DISPATCH_WIDTHS(ints, call)           \
  do {                                            \
    const int c_ = (ints)[I_C], m_ = (ints)[I_M]; \
    if (c_ == 192 && m_ == 48) {                  \
      constexpr int C = 192, M = 48;              \
      return call;                                \
    }                                             \
    if (c_ == 64 && m_ == 16) {                   \
      constexpr int C = 64, M = 16;               \
      return call;                                \
    }                                             \
    return (int)cudaErrorInvalidValue;            \
  } while (0)

extern "C" const char* pm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
