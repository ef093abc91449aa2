"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at
700 W). Float32 work is held to the dense TF32 rate: no way of multiplying
float32 inputs on this card runs faster, so no implementation can read over
100%."""
FLOAT32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, peak: float = FLOAT32_FLOPS) -> float:
    """The least seconds the work can take: operations at ``peak`` against
    bytes at the memory rate, whichever is longer."""
    return max(flops / peak, nbytes / HBM_BYTES)
