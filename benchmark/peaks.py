"""The card's published peaks (NVIDIA H100 SXM data sheet, dense rates,
at the full 700 W power limit): FP32 outside the tensor cores, and device
memory bandwidth.  A roofline share is stated against these, with the
card's power limit printed beside it."""

FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12


def bound_s(flops: float, n_bytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the memory rate."""
    return max(flops / FP32_FLOPS, n_bytes / HBM_BYTES)
