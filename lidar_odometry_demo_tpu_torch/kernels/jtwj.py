"""Kernel K2 (``jtwj.cu``): the robust point-to-plane normal equations of one
Gauss-Newton step, its plain PyTorch version, and its launch counter.

Replaces the TPU kernel ``lidar_odometry_demo_tpu/ops/pallas/jtwj.py``
(``_jtwj_kernel`` / ``jtwj_accumulate``). It runs at every Gauss-Newton
step, four per ICP outer round. One call moves ~0.3 MB at full width, so
its time is bound by the launch, not by bytes or flops; the kernel is two
small launches with a fixed-order, atomic-free reduction, so its result is
bitwise repeatable (see the source's note).

On CPU tensors `jtwj_accumulate` runs the plain version; on CUDA tensors it
launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from lidar_odometry_demo_tpu_torch.kernels import _build
from lidar_odometry_demo_tpu_torch.kernels._build import check_tensor
from lidar_odometry_demo_tpu_torch.ops.se3 import rot_pts


def jtwj_plain(source_local, plane_origin, plane_normal, valid, R, t, *,
               huber_delta: float):
    """(H (6, 6), b (6,)) without the translation prior: the JAX package's
    XLA formulation (``icp._normal_equations``) in float32."""
    rp = rot_pts(source_local, R)
    p_w = rp + t
    r = torch.sum((p_w - plane_origin) * plane_normal, dim=-1)
    absr = torch.abs(r)
    # a tensor numerator: `float / tensor` would multiply by a reciprocal
    w = torch.where(absr <= huber_delta, 1.0,
                    torch.full_like(absr, huber_delta) / torch.clamp_min(absr, 1e-30))
    w = torch.where(valid, w, 0.0)
    n = plane_normal
    j_rot = torch.stack([rp[:, 1] * n[:, 2] - rp[:, 2] * n[:, 1],
                         rp[:, 2] * n[:, 0] - rp[:, 0] * n[:, 2],
                         rp[:, 0] * n[:, 1] - rp[:, 1] * n[:, 0]], dim=-1)
    J = torch.cat([j_rot, n], dim=-1)
    Jw = J * w[:, None]
    return J.T @ Jw, Jw.T @ r


def jtwj_accumulate(source_local, plane_origin, plane_normal, valid, R, t, *,
                    huber_delta: float):
    """K2: the plain version on CPU tensors, the CUDA kernel on CUDA ones.

    source_local / plane_origin / plane_normal (Q, 3) float32, valid (Q,)
    bool, R (3, 3) and t (3,) float32; any Q.
    """
    if source_local.device.type == "cpu":
        return jtwj_plain(source_local, plane_origin, plane_normal, valid, R, t,
                          huber_delta=huber_delta)
    Q = source_local.shape[0]
    for name, x in (("source_local", source_local), ("plane_origin", plane_origin),
                    ("plane_normal", plane_normal)):
        check_tensor(x, name, torch.float32, (Q, 3))
    check_tensor(valid, "valid", torch.bool, (Q,))
    check_tensor(R, "R", torch.float32, (3, 3))
    check_tensor(t, "t", torch.float32, (3,))
    blocks = _build.c_function("jtwj", "jtwj_blocks", [ctypes.c_int])
    fn = _build.c_function("jtwj", "jtwj_launch",
                           [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_float]
                           + [ctypes.c_void_p] * 4)
    dev = source_local.device
    partials = torch.empty((blocks(Q) * 27,), dtype=torch.float32, device=dev)
    H = torch.empty((6, 6), dtype=torch.float32, device=dev)
    b = torch.empty((6,), dtype=torch.float32, device=dev)
    _build.launch(fn, dev, source_local.data_ptr(), plane_origin.data_ptr(),
                  plane_normal.data_ptr(), valid.data_ptr(), R.data_ptr(),
                  t.data_ptr(), Q, float(huber_delta), partials.data_ptr(),
                  H.data_ptr(), b.data_ptr())
    jtwj_accumulate.launches += 1
    return H, b


jtwj_accumulate.launches = 0
