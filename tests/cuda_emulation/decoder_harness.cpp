// Runs one of the decoder chain's C entry points (DECODER_SOURCE:
// decoder_chain_fwd.cu or decoder_chain_bwd.cu, with vdvae_gemm.cuh),
// emulated, on CPU pointers: every launch runs its blocks one at a time,
// each block as its threads' std::threads. The sources here are the
// emulated copies (PTX helpers replaced, launch_kernel a call of
// emu_launch_grid, dynamic shared memory the array below).
#include <cuda_runtime.h>

alignas(64) float smem[232448 / 4];

#include DECODER_SOURCE

EMU_GLOBALS(smem)
