"""The step's front end, `kernels/prepare.cu`: one call is one launch each of
its four CUDA functions, for every lane. Least traffic per lane: the raw
scan in (xyz, ring, time, valid: 21 bytes a point), then out the range
image's points, normals, planar mask and both downsample key arrays (33
bytes a cell). Operations: ~80 a point (deskew, cell), ~135 a cell
(curvature, normal, keys)."""

KERNELS = ("lane_kernel", "point_kernel", "image_kernel", "planar_kernel")


def bytes_ops(B: int, N: int, R: int, W: int, **_):
    """B lanes of N raw points and an R x W range image."""
    return B * (21.0 * N + 33.0 * R * W), B * (80.0 * N + 135.0 * R * W)
