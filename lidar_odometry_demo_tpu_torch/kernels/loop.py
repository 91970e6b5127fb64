"""The ICP loop's condition (``loop.cu``): the JAX step's `lax.while_loop`
`cond` (``lidar_odometry_demo_tpu/ops/icp.py:267-283``) as a kernel, its
plain PyTorch version, its launch counter, and the graph that runs the
loop on the device.

Not the port of a TPU kernel: on the TPU the loop is XLA's while, and here
its condition is a kernel that sets a CUDA graph's conditional WHILE node
(see the source's note). Per lane, from the loop's carry (rounds run,
rounds without improvement, the last Gauss-Newton step norm):

    i < max_outer & (step_norm >= tol | i <= min_outer - 1) & stall < stall_exit

`loop_condition` writes it per lane (over lanes the round's `active`
mask): the plain version on CPU tensors, one launch on CUDA ones, counted
in `loop_condition.launches`. `LoopGraph` builds, from a captured round and
a captured tail, one graph of the condition, a WHILE node over the round
and the condition, and the tail, and launches it; the condition nodes it
holds count at every launch (`LoopGraph.count`), one per round the device
ran, read from the device's round total.
"""

from __future__ import annotations

import ctypes

import torch

from lidar_odometry_demo_tpu_torch.kernels import _build
from lidar_odometry_demo_tpu_torch.kernels._build import check_tensors, lanes


def _limits(cfg) -> tuple:
    """(max_outer, min_outer, stall_exit, tol) of the loop of `cfg`."""
    return (int(cfg.icp_max_outer_iterations), int(cfg.icp_min_outer_iterations),
            int(cfg.icp_stall_exit_rounds), float(cfg.icp_convergence_step_norm))


def loop_condition_plain(iters: torch.Tensor, stall: torch.Tensor, step_norm: torch.Tensor,
                         cfg) -> torch.Tensor:
    """The condition per lane (bool, the carry's shape), as the JAX `cond`
    computes it (float32 step norm against the float32 tolerance)."""
    max_outer, min_outer, stall_exit, tol = _limits(cfg)
    not_converged = (step_norm >= tol) | (iters <= min_outer - 1)
    return (iters < max_outer) & not_converged & (stall < stall_exit)


def _carry_args(iters, stall, step_norm, go, cfg) -> tuple:
    """The launcher's carry arguments, after the carry's checks."""
    lead = tuple(iters.shape)
    check_tensors((iters, "iters", torch.int32, lead), (stall, "stall", torch.int32, lead),
                  (step_norm, "step_norm", torch.float32, lead, len(lead)),
                  (go, "go", torch.bool, lead))
    return (iters.data_ptr(), stall.data_ptr(), step_norm.data_ptr(),
            step_norm.stride(0) if lead else 0, go.data_ptr(), lanes(lead), *_limits(cfg))


def loop_condition(iters: torch.Tensor, stall: torch.Tensor, step_norm: torch.Tensor, cfg, *,
                   out: torch.Tensor) -> torch.Tensor:
    """The loop's condition per lane of the carry (iters, stall: int32;
    step_norm: float32, any lane stride), written to `out` (bool, the
    carry's shape) and returned: the plain version on CPU tensors, one
    kernel launch on CUDA ones."""
    if iters.device.type == "cpu":
        return out.copy_(loop_condition_plain(iters, stall, step_norm, cfg))
    fn = _build.c_function("loop", "loop_condition_launch",
                           [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
                           + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p,
                                                   ctypes.c_void_p])
    _build.launch(fn, iters.device, *_carry_args(iters, stall, step_norm, out, cfg), None)
    loop_condition.launches += 1
    return out


loop_condition.launches = 0


class LoopGraph:
    """One instantiated graph: the condition, a WHILE node (while any lane
    goes: the round graph, then the condition), then the tail graph.
    `round_graph` and `tail_graph` are captured `torch.cuda.CUDAGraph`s
    made with `keep_graph=True` (cloned into this graph; they keep the pool
    memory its nodes address, so the caller keeps them); the carry tensors
    are those the round reads and writes. Raises if the build or the
    instantiation fails."""

    def __init__(self, round_graph, tail_graph, iters, stall, step_norm, go, cfg):
        self.device = iters.device
        # the round total: one per round the device ran, read by `count`
        self.rounds = torch.zeros((), dtype=torch.int64, device=self.device)
        self.counted = 0
        fn = _build.c_function("loop", "loop_graph_build",
                               [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
                               + [ctypes.c_int] * 4 + [ctypes.c_float]
                               + [ctypes.c_void_p] * 2)
        exec_ = ctypes.c_void_p()
        with torch.cuda.device(self.device):
            status = fn(round_graph.raw_cuda_graph(), tail_graph.raw_cuda_graph(),
                        *_carry_args(iters, stall, step_norm, go, cfg), self.rounds.data_ptr(),
                        ctypes.byref(exec_))
        if status != 0:
            raise RuntimeError(f"loop_graph_build: CUDA error {status}")
        self._exec = exec_.value
        self._launch = _build.c_function("loop", "loop_graph_launch", [ctypes.c_void_p] * 2)
        self._destroy = _build.c_function("loop", "loop_graph_destroy", [ctypes.c_void_p])

    def launch(self) -> None:
        """The graph, on the device's current stream."""
        _build.launch(self._launch, self.device, self._exec)

    def count(self) -> int:
        """The rounds the device ran since the last count (waits for the
        device): the body's launches, one condition each, are that many."""
        total = int(self.rounds)
        new, self.counted = total - self.counted, total
        return new

    def __del__(self):
        exec_, self._exec = getattr(self, "_exec", None), None
        if exec_ is not None:
            self._destroy(exec_)
