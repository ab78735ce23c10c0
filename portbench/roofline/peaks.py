"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  A card set below that limit runs
slower under load; the harness prints the card's limit beside each
share."""

HBM_BYTES_PER_S = 3.35e12      # device memory bandwidth
FP32_FLOPS_PER_S = 67e12       # float32 outside the tensor cores


def bound_s(nbytes, nflops):
    """The least time the card could take for a call: the larger of its
    bytes over the memory bandwidth and its operations over the peak."""
    return max(nbytes / HBM_BYTES_PER_S, nflops / FP32_FLOPS_PER_S)
