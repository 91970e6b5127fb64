"""The chip's published peaks (NVIDIA H100 SXM data sheet, dense, at the
700 W power limit): the roofline's denominators."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12    # float32 outside the tensor cores


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the chip could take: bytes over the memory bandwidth
    or float32 operations over the float32 peak, whichever is larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS_PER_S)
