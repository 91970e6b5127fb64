"""The per-scan step captured as CUDA graphs: the port's counterpart of the
JAX package's `jax.jit` of its step (pipeline/odometry.py there: "the
whole step is one jit program").

The eager step (pipeline/odometry.py `ScanStep`) issues ~1,400 launches
per scan from Python. `CapturedStep` captures its parts once, as three
graphs that share one memory pool, and replays them:

  (a) `prepare` (time-normalize .. the two downsample grids and the guess)
      and ICP's `begin` (K3's neighbourhood lookup on the cached path, the
      loop's carry);
  (b) one ICP round (`Align.round`: K1, on the exact path K3 before it,
      the round's cost, the best-pose bookkeeping, the four K2 steps, the
      exit flags copied to pinned host memory);
  (c) ICP's `finish` (the best-pose exit), the divergence guard, the map
      update (K3's group lookup; its new table gathered straight into the
      state's table buffer), the diagnostics, the rest of the new state
      copied into the state buffers (a)-(c) read, and the next scan's
      first-scan test copied to pinned host memory.

A scan is (a), then (b) until the JAX loop's condition, evaluated on the
host from (b)'s flags (ops/icp.py `RoundSchedule`), says stop, then (c):
one wait on the device per round, and one for the first-scan test, which
(c) of the scan before wrote and which is read once (a) is queued (that
of a state copied in is read before).

The rule: the captured step runs where the step's tensors are on a CUDA
device. A step with an sp or spatial group (parallel/mesh.py) has
collectives inside its rounds and is built eager (`make_process_scan`),
and so is every step on CPU tensors (`CapturedStep` calls the eager step
there). On the card the eager step also runs the first two scans of each
lane count (the warm-up: kernels built, K2's cluster opt-in made, every
constant of the step made) and every scan where some lane's map is empty
(the first-scan selection); capture happens at the first scan after that.
A failed capture or replay raises; the step never carries on eagerly.

The state a captured step returns is its own buffers, which its next call
rewrites. The contract is the eager step's too: a returned state is valid
until the step's next call, and a caller that keeps one longer takes
`step.own(state)` (a copy here, the state itself from the eager step);
`LidarOdometry.state` reads through it. A state passed in that is not those buffers (a fresh
state, a checkpoint) is copied into them. The diagnostics are cloned out
of the graph's memory after every scan.

Launch counts: the kernels' Python counters count at capture, not at
replay. Each graph records what its capture counted and adds it to the
counters on every replay, so the counters read as the eager step's do.
"""

from __future__ import annotations

import gc

import torch

from lidar_odometry_demo_tpu_torch.config import OdometryConfig
from lidar_odometry_demo_tpu_torch.device import HostFlags
from lidar_odometry_demo_tpu_torch.kernels.correspondence import match_rows
from lidar_odometry_demo_tpu_torch.kernels.jtwj import gn_epilogue, gn_sum_step, jtwj_accumulate
from lidar_odometry_demo_tpu_torch.kernels.search import search_sorted
from lidar_odometry_demo_tpu_torch.ops import voxel_map as vm
from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan
from lidar_odometry_demo_tpu_torch.pipeline.odometry import (
    OdometryState, ScanStep, make_process_scan)

# eager scans of each lane count before the capture
WARM_UP_SCANS = 2
# the launch-counted kernel wrappers
COUNTED = (match_rows, jtwj_accumulate, gn_sum_step, gn_epilogue, search_sorted)


def _leaves(x) -> list:
    """The tensors of a (nested) tuple, in field order (anything else
    skipped)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if not isinstance(x, tuple):
        return []
    return [t for item in x for t in _leaves(item)]


def _map(fn, x):
    """fn on every tensor of a (nested) named tuple, the structure and
    anything else kept."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if not isinstance(x, tuple):
        return x
    items = [_map(fn, item) for item in x]
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)


def copy_state(dst: OdometryState, src: OdometryState) -> None:
    """src into the buffers of dst, leaf by leaf (a leaf that is dst's
    buffer already is left as it is). `previous` is copied before
    `current`, so a src whose previous pose is dst's current one (every
    step's) reads it before it is overwritten."""
    for part in ("previous", "current", "keyframe"):
        for d, s in zip(_leaves(getattr(dst, part)), _leaves(getattr(src, part))):
            if d.shape != s.shape or d.dtype != s.dtype:
                raise ValueError(f"state {part}: {tuple(s.shape)} {s.dtype} does not fit "
                                 f"the step's buffer {tuple(d.shape)} {d.dtype}")
            if d is not s:
                d.copy_(s)


class _Segment:
    """One part of the step. On a CUDA device its captured graph, what the
    capture returned (tensors in the graph's memory, rewritten by every
    replay) and the kernel launches its capture counted, added on every
    replay; on the CPU (no pool) the part itself, called by every replay,
    `out` what the last call returned."""

    def __init__(self, fn, pool):
        self.fn, self.out, self.graph = fn, None, None
        if pool is None:
            return
        before = [fn_.launches for fn_ in COUNTED]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
            self.out = fn()
        self.launches = [fn_.launches - b for fn_, b in zip(COUNTED, before)]
        for fn_, b in zip(COUNTED, before):  # the capture launched nothing
            fn_.launches = b

    def replay(self) -> None:
        if self.graph is None:
            self.out = self.fn()
            return
        self.graph.replay()
        for fn_, n in zip(COUNTED, self.launches):
            fn_.launches += n


class _LaneGraphs:
    """The captured step of one lane count: the state and scan buffers the
    graphs read and write, and the graphs once captured. On CPU tensors
    the same schedule calls the parts instead of replaying graphs (the
    segments composed eagerly, which the CPU tests hold to the eager
    step); `CapturedStep` runs the eager step there."""

    def __init__(self, step: ScanStep, state: OdometryState, scan: LidarScan):
        self.step = step
        self.state = _map(torch.empty_like, state)  # filled by the first call
        self.scan = _map(torch.empty_like, scan)
        lead = tuple(state.current.t.shape[:-1])
        self.initialized = HostFlags((lead[0] if lead else 1,), torch.bool, scan.xyz.device)
        self.eager_scans = 0
        self.segments = None

    def _publish(self) -> None:
        """The first-scan test of the state in the buffers, to the host."""
        self.initialized.write(vm.map_size(self.state.keyframe) > 0)
        self.initialized.mark()

    def _all_initialized(self) -> bool:
        return all(self.initialized.read())

    def segment_a(self):
        """(a): the scan's preparation and ICP's start, from the buffers.
        Returns (Prepared, IcpLoop)."""
        prep = self.step.prepare(self.state, self.scan)
        return prep, self.step.align.begin(self.state.keyframe, prep.q_xyz, prep.q_valid,
                                           prep.guess)

    def segment_b(self, loop) -> None:
        """(b): one ICP round on the carry of (a)'s loop."""
        self.step.align.round(self.state.keyframe, loop)

    def segment_c(self, prep, loop):
        """(c): ICP's end, the map update and the diagnostics, the new state
        written into the buffers and its first-scan test to the host (every
        lane initialized, as the captured step runs only then)."""
        step, S = self.step, self.state
        new, diag = step.update(S, prep, *step.outcome(S, prep, step.align.finish(loop)),
                                tab_out=S.keyframe.tab)
        copy_state(S, new)  # the table is in place already
        self.initialized.write(diag.map_voxels > 0)
        return diag

    def _capture(self) -> None:
        dev = self.scan.xyz.device
        self.step.align.host_buffers(tuple(self.state.current.t.shape[:-1]), dev)
        pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
        # a collection during a capture may free garbage that owns CUDA
        # resources (an earlier step's graphs and events), a call a capture
        # refuses (seen: the process aborted); torch.cuda.graph collects
        # before each capture, and none runs during one
        automatic = gc.isenabled()
        gc.disable()
        try:
            a = _Segment(self.segment_a, pool)
            b = _Segment(lambda: self.segment_b(a.out[1]), pool)
            self.segments = (a, b, _Segment(lambda: self.segment_c(*a.out), pool))
        finally:
            if automatic:
                gc.enable()

    def __call__(self, state: OdometryState, scan: LidarScan):
        initialized = None  # known before (a) is queued: a state copied in, a capture
        if any(d is not s for d, s in zip(_leaves(self.state), _leaves(state))):
            copy_state(self.state, state)
            self._publish()
            initialized = self._all_initialized()
        for d, s in zip(self.scan, scan):
            d.copy_(s, non_blocking=True)
        if self.segments is None and self.eager_scans >= WARM_UP_SCANS and (
                initialized if initialized is not None else self._all_initialized()):
            self._capture()
            initialized = True
        if self.segments is not None and initialized is not False:
            a, b, c = self.segments
            a.replay()  # queued before the host waits for the first-scan test
            if initialized or self._all_initialized():
                self.step.align.run_rounds(a.out[1], b.replay)
                c.replay()
                self.initialized.mark()
                return self.state, _map(torch.clone, c.out)
        new, diag = self.step(self.state, self.scan)
        diag = _map(torch.clone, diag)  # it may hold the buffers' pose (a first scan's)
        copy_state(self.state, new)
        self._publish()
        self.eager_scans += 1
        return self.state, diag


class CapturedStep:
    """The per-scan step (state, scan) -> (state, diagnostics) of
    `make_process_scan(cfg, return_deskewed)`, replayed from CUDA graphs
    on CUDA tensors (see the module's docstring) and the eager step itself
    on CPU tensors; bitwise the eager step either way. One capture per lane
    count (no lane axis, or B)."""

    def __init__(self, cfg: OdometryConfig, return_deskewed: bool = False):
        self.eager = make_process_scan(cfg, return_deskewed)
        self._lanes: dict[tuple, _LaneGraphs] = {}

    def __call__(self, state: OdometryState, scan: LidarScan):
        dev = scan.xyz.device
        if dev.type != "cuda":
            return self.eager(state, scan)
        lead = tuple(state.current.t.shape[:-1])
        with torch.cuda.device(dev):
            graphs = self._lanes.get(lead)
            if graphs is None:
                graphs = self._lanes[lead] = _LaneGraphs(self.eager, state, scan)
            return graphs(state, scan)

    def own(self, state: OdometryState) -> OdometryState:
        """`state`, copied where it is this step's buffers (which the next
        call rewrites)."""
        mine = any(_leaves(g.state)[0] is _leaves(state)[0] for g in self._lanes.values())
        return _map(torch.clone, state) if mine else state
