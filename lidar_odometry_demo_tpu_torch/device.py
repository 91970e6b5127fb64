"""Device resolution, numpy <-> torch conversion, and float32 numerics.

The port's entry points run on the card. They run on the CPU only when the
caller asks for it (``device="cpu"``), as the tests do; asking for nothing on
a machine without CUDA raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

# TF32 keeps ~10 mantissa bits: Hopper's version of the bf16-on-MXU trap the
# JAX package documents (ops/icp.py _rot_pts, ops/pallas/jtwj.py). Geometry
# stays exact float32 everywhere in the port.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device to run on: ``"cuda"`` unless the caller names another.

    Raises when CUDA is asked for (explicitly or by default) and absent.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def to_torch(x, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """numpy array (or scalar) -> tensor on `device`, copying."""
    t = torch.from_numpy(np.array(x, copy=True))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def true_div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s as an IEEE division on every device.

    PyTorch's CUDA division by a host scalar multiplies by the scalar's
    reciprocal, which rounds differently from the JAX package's division
    (voxel keys must match bitwise); a 0-dim tensor on x's device keeps it
    a true division.
    """
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)
