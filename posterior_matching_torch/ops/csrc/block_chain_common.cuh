// Shared pieces of the VDVAE encoder's block-chain kernels
// (block_chain_fwd.cu, block_chain_bwd.cu, each with its pointer layout):
// the (width, bottleneck) pairs they are built for and the error string of
// their C entry points. The products run on vdvae_gemm.cuh's tensor-core
// core, here in namespace bck (the decoder chain's copy is dck).
//
// A level of a run is one bottleneck Block, gelu -> c1 (1x1, C -> M) ->
// gelu -> c2 (k x k) -> gelu -> c3 (k x k) -> gelu -> c4 (1x1, M -> C),
// plus the level's input.
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
