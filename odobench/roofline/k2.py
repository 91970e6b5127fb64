"""K2, `kernels/jtwj.cu` (`gn_step_kernel`): one Gauss-Newton step. Least
traffic per lane: 37 bytes a query row (source point, plane point, normal,
valid), the pose and guess in, 42 sums and the pose and step out.
Operations: ~100 per row, 300 for the solve."""

KERNEL = "gn_step_kernel"


def bytes_ops(Q: int, B: int, **_):
    return B * (Q * 37 + 40 + 42 * 4 + 32), B * (100.0 * Q + 300)
