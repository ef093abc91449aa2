// Runs the codebook search's C entry point (csrc/vq_search.cu, pm_vq_search)
// emulated, on CPU pointers: its launch runs the blocks one at a time, each
// block as its threads' std::threads. The source here is the emulated copy
// (PTX helpers replaced, the launch a call of emu_launch_grid, dynamic
// shared memory the array below).
#include <cuda_runtime.h>

alignas(64) float smem[232448 / 4];

#include "vq_search.cu"

EMU_GLOBALS(smem)
