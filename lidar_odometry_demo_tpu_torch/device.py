"""Device resolution, numpy <-> torch conversion, and float32 numerics.

The port's entry points run on the card. They run on the CPU only when the
caller asks for it (``device="cpu"``), as the tests do; asking for nothing on
a machine without CUDA raises instead of quietly running on the CPU.
"""

from __future__ import annotations

from collections.abc import Hashable

import numpy as np
import torch

from lidar_odometry_demo_tpu_torch.utils import profiling

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


_CONSTANTS: dict[tuple, torch.Tensor] = {}


def constant(values: Hashable, dtype: torch.dtype, device) -> torch.Tensor:
    """A tensor of `values` (a number, or nested tuples of them) on
    `device`, made once per (values, dtype, device) and shared by every
    caller, who must not write to it.

    Making a tensor from host data copies it from pageable memory, which
    PyTorch makes synchronous with the stream and which a CUDA graph cannot
    capture; the step's constants are made this way on their first use,
    before any capture (pipeline/graphs.py), and never again.
    """
    key = (values, dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


def true_div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s as an IEEE division on every device.

    PyTorch's CUDA division by a host scalar multiplies by the scalar's
    reciprocal, which rounds differently from the JAX package's division
    (voxel keys must match bitwise); a 0-dim tensor on x's device keeps it
    a true division.
    """
    return x / constant(float(s), x.dtype, x.device)


class HostFlags:
    """A host copy of a small device tensor, for a decision the host takes:
    `write` enqueues the copy (pinned memory and no synchronisation on a
    CUDA device, so a CUDA graph can capture it), `mark` records when it is
    done (after the work that writes it has been enqueued, outside any
    capture), and `read` waits for that and returns the values as lists.
    `write` takes any tensor of the buffer's size, in the buffer's shape.
    Each wait on the device counts in `HostFlags.waits`: the step's
    synchronising calls, which torch's sync debug mode does not see; with
    spans on, each is a `step.wait` span (utils/profiling.py)."""

    waits = 0

    def __init__(self, shape: tuple, dtype: torch.dtype, device):
        cuda = torch.device(device).type == "cuda"
        self.host = torch.zeros(shape, dtype=dtype, pin_memory=cuda)
        self.event = torch.cuda.Event() if cuda else None

    def write(self, x: torch.Tensor) -> None:
        self.host.copy_(x.reshape(self.host.shape), non_blocking=self.event is not None)

    def mark(self) -> None:
        if self.event is not None:
            self.event.record()

    def read(self) -> list:
        if self.event is not None:
            if profiling.ON:
                profiling.wait_begin()
            self.event.synchronize()
            HostFlags.waits += 1
            if profiling.ON:
                profiling.wait_end()
        return self.host.tolist()
