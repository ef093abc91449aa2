// Runs one of the gated chain's C entry points (GATED_SOURCE:
// gated_stream_{fwd,bwd}.cu or gated_levels_{fwd,bwd}.cu, with
// gated_levels.cuh and gated_common.cuh), emulated, on CPU pointers: every
// launch runs its blocks one at a time, each block as its threads'
// std::threads. The sources here are the emulated copies (PTX helpers
// replaced, each <<<...>>> launch a call of emu_launch_grid, dynamic shared
// memory the array below); -DPM_CORE_BF16=1 gives the bf16 build.
#include <cuda_runtime.h>

alignas(64) float smem[232448 / 4];

#include GATED_SOURCE

EMU_GLOBALS(smem)
