"""The per-scan step captured as CUDA graphs: the port's counterpart of the
JAX package's `jax.jit` of its step (pipeline/odometry.py there: "the
whole step is one jit program"), its ICP `lax.while_loop` included.

The eager step (pipeline/odometry.py `ScanStep`) issues ~1,400 launches
per scan from Python. `CapturedStep` captures its parts once, as three
graphs that share one memory pool:

  (a) `prepare` (time-normalize .. the two downsample grids and the guess)
      and ICP's `begin` (K3's neighbourhood lookup on the cached path, the
      loop's carry);
  (b) one ICP round (`Align.round`: K1, on the exact path K3 before it,
      the round's cost, the best-pose and stall bookkeeping, the four K2
      steps);
  (c) ICP's `finish` (the best-pose exit), the divergence guard, the map
      update (K3's group lookup; its new table gathered straight into the
      state's table buffer), the diagnostics, the rest of the new state
      copied into the state buffers (a)-(c) read, and the next scan's
      first-scan test copied to pinned host memory.

(b) and (c) are composed into one more graph (kernels/loop.py `LoopGraph`):
the ICP loop's condition (kernels/loop.cu, from the carry alone), a
conditional WHILE node whose body is (b) and the condition, then (c). A
scan is (a), replayed by torch, then that graph: two graph launches and
one wait on the device, for the first-scan test, which (c) of the scan
before wrote and which is read once (a) is queued (that of a state copied
in is read before). The rounds run on the device with no host read, as
the JAX loop does.

The rule: the step is captured where its tensors are on a CUDA device,
with no group or with an NCCL group, and is eager otherwise: on CPU
tensors, and under a gloo group, whose collectives a graph cannot hold
(`CapturedStep` calls the eager step there; that is the design, not a
fallback). Under an NCCL sp or spatial group (parallel/mesh.py) the
step's graphs hold the group's collectives: (b) the round's gathers, and
for spatial (a) the halo exchange and the first-scan sum, (c) the
map_voxels sum. Its rounds are driven from the host, as the eager group
step's are (one wait per round, every rank reading the same flags, since
the sums are added in rank order): (a), (b) per round, (c). On the card
the eager step also runs the first two scans of each lane count (the
warm-up: kernels built, K2's cluster opt-in made, every constant of the
step made, every collective's communicator set up) and, without a group,
every scan where some lane's map is empty (the first-scan selection; a
group's step selects on the device); capture happens at the first scan
after that. A failed capture, graph build or launch raises; the step
never carries on eagerly, and never runs host-driven rounds on the card
without a group.

The state a captured step returns is its own buffers, which its next call
rewrites. The contract is the eager step's too: a returned state is valid
until the step's next call, and a caller that keeps one longer takes
`step.own(state)` (a copy here, the state itself from the eager step);
`LidarOdometry.state` reads through it. A state passed in that is not those buffers (a fresh
state, a checkpoint) is copied into them. The diagnostics are cloned out
of the graph's memory after every scan.

Launch counts: the kernels' Python counters count at capture, not at
replay. Each graph records what its capture counted and adds it to the
counters at every launch, so the counters read as the eager step's do. The
rounds the device ran are not known on the host: `settle_launches()` reads
each loop's round total on the device and adds the body's launches that
many times (and one condition each). A caller calls it before it reads or
zeroes a counter, never once per scan.

Spans (utils/profiling.py; off by default): a call marks its stages as
host spans (`step.copy_in`, `step.capture`, `step.replay_a`,
`step.launch_loop`, `step.clone_diag`, `step.eager`; a host wait is
`step.wait`) and as device stages between CUDA events recorded outside
the graphs (`dev.copy_in`, `dev.a`, `dev.loop`: the rounds and (c),
`dev.clone_diag`, `dev.eager`).
"""

from __future__ import annotations

import gc

import torch

from lidar_odometry_demo_tpu_torch.config import OdometryConfig
from lidar_odometry_demo_tpu_torch.device import HostFlags
from lidar_odometry_demo_tpu_torch.kernels.correspondence import match_rows
from lidar_odometry_demo_tpu_torch.kernels.jtwj import gn_epilogue, gn_sum_step, jtwj_accumulate
from lidar_odometry_demo_tpu_torch.kernels.loop import LoopGraph, loop_condition
from lidar_odometry_demo_tpu_torch.kernels.search import search_sorted
from lidar_odometry_demo_tpu_torch.ops import voxel_map as vm
from lidar_odometry_demo_tpu_torch.ops.cloud import LidarScan
from lidar_odometry_demo_tpu_torch.parallel.mesh import CommStats
from lidar_odometry_demo_tpu_torch.pipeline.odometry import (
    OdometryState, ScanStep, make_process_scan)
from lidar_odometry_demo_tpu_torch.utils import profiling

# eager scans of each lane count before the capture
WARM_UP_SCANS = 2
# the launch-counted kernel wrappers of the step
COUNTED = (match_rows, jtwj_accumulate, gn_sum_step, gn_epilogue, search_sorted)
# the loop graphs launched since the last settle_launches, each with its
# body's captured launches (held past their step's life: a few bytes each)
_UNSETTLED: dict[int, tuple] = {}
# graph launches from the host so far (torch's replays and the loop graphs')
graph_launches = 0


def settle_launches() -> None:
    """Add to the launch counters what every loop graph ran on the device
    since the last call: per round, its body's launches (the round's
    kernels and one condition). Waits for the device."""
    for loop_graph, body in list(_UNSETTLED.values()):
        rounds = loop_graph.count()
        for fn_, n in zip(COUNTED, body):
            fn_.launches += n * rounds
        loop_condition.launches += rounds
    _UNSETTLED.clear()


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


# a side stream per device to capture on (a capture may not use the default stream)
_CAPTURE_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


class _Segment:
    """One part of the step. On a CUDA device its captured graph, what the
    capture returned (tensors in the graph's memory, rewritten by every
    replay) and the kernel launches its capture counted, added on every
    replay; on the CPU (no pool) the part itself, called by every replay,
    `out` what the last call returned. `keep_graph`: the graph is kept for
    the loop graph to clone, and torch never instantiates it.

    The capture runs on a side stream as `torch.cuda.graph` does, without
    its emptying of the device and pinned-host allocators' caches first:
    that frees every cached block of the process, and after other work it
    stalled a capture for 0.39 s on an NVIDIA H100 80GB HBM3 at 700 W (a
    live stream dropped packets meanwhile; without it the capturing scan
    took 27 ms).

    `group`: the step's group (parallel/mesh.py), whose collectives the part
    may hold: while capturing, its stats are a fresh CommStats (no device
    timing, so no event inside the graph); what they counted is added to
    the group's at every replay like the launches, the replay timed as a
    whole (`graph_device_ms`)."""

    def __init__(self, fn, pool, group=None, keep_graph: bool = False):
        self.fn, self.out, self.graph, self.stats, self.comm = fn, None, None, None, None
        if pool is None:
            return
        before = [fn_.launches for fn_ in COUNTED]
        if group is not None:
            stats, group.stats = group.stats, CommStats()
        self.graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
        dev = torch.device("cuda", torch.cuda.current_device())
        stream = _CAPTURE_STREAMS.get(dev)
        if stream is None:
            stream = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
        torch.cuda.synchronize(dev)  # nothing of the eager scans in flight, as torch.cuda.graph
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                self.out = fn()
            finally:
                self.graph.capture_end()
                if group is not None:
                    captured, group.stats = group.stats, stats
        self.launches = [fn_.launches - b for fn_, b in zip(COUNTED, before)]
        for fn_, b in zip(COUNTED, before):  # the capture launched nothing
            fn_.launches = b
        if group is not None and (captured.collectives or captured.exchanges):
            self.stats, self.comm = stats, captured.counts()

    def count(self) -> None:
        """Add the capture's launches (and collectives) to the counters."""
        for fn_, n in zip(COUNTED, self.launches):
            fn_.launches += n
        if self.comm is not None:
            self.stats.add_counts(self.comm)

    def replay(self) -> None:
        if self.graph is None:
            self.out = self.fn()
            return
        global graph_launches
        timed = self.comm is not None and self.stats.device_timing
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        self.graph.replay()
        graph_launches += 1
        if timed:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.stats.add_span("graph_device_ms", start, end)
        self.count()


class _LaneGraphs:
    """The captured step of one lane count: the state and scan buffers the
    graphs read and write, and the graphs once captured. On CPU tensors
    the same schedule calls the parts instead of launching graphs (the
    segments composed eagerly, the loop's condition read on the host, which
    the CPU tests hold to the eager step); `CapturedStep` runs the eager
    step there.

    Under a group (`grouped`: the step's sp or spatial group) the step runs
    as the eager group step does: ICP on every scan, each lane selecting its
    result on the device (no first-scan test on the host), the rounds
    driven from the host with one wait each (`Align.run_rounds`, (b)
    replayed per round, its gathers in it: every rank reads the same flags),
    then (c); the spatial step's halo exchange and first-scan sum sit in
    (a), its map_voxels sum in (c)."""

    def __init__(self, step: ScanStep, state: OdometryState, scan: LidarScan):
        self.step = step
        self.grouped = step.group is not None
        self.state = _map(torch.empty_like, state)  # filled by the first call
        self.scan = _map(torch.empty_like, scan)
        lead = tuple(state.current.t.shape[:-1])
        self.initialized = HostFlags((lead[0] if lead else 1,), torch.bool, scan.xyz.device)
        self.eager_scans = 0
        self.segments = None
        self.loop_graph = None

    def _publish(self) -> None:
        """The first-scan test of the state in the buffers, to the host."""
        self.initialized.write(vm.map_size(self.state.keyframe) > 0)
        self.initialized.mark()

    def _all_initialized(self) -> bool:
        return all(self.initialized.read())

    def segment_a(self):
        """(a): the scan's preparation and ICP's start, from the buffers.
        Returns (Prepared, IcpLoop, the first-scan test per lane (under a
        group; else None), the map ICP searches)."""
        step, S = self.step, self.state
        prep = step.prepare(S, self.scan)
        initialized, icp_map = None, S.keyframe
        if step.spatial_group is not None:  # the shards' sum; ICP searches the halo's view
            from lidar_odometry_demo_tpu_torch.parallel import spatial

            initialized = step.spatial_group.psum(vm.map_size(S.keyframe), "initialized") > 0
            icp_map = spatial.build_halo_view(S.keyframe, step.spatial_group)
        elif self.grouped:
            initialized = vm.map_size(S.keyframe) > 0
        return (prep, step.align.begin(icp_map, prep.q_xyz, prep.q_valid, prep.guess),
                initialized, icp_map)

    def segment_b(self, loop, icp_map) -> None:
        """(b): one ICP round on the carry of (a)'s loop; without a group
        the WHILE node's body, the round and then the loop's condition (on
        the card the captured round and the loop graph's condition node)."""
        self.step.align.round(icp_map, loop)
        if not self.grouped:
            self.step.align.condition(loop)

    def segment_c(self, prep, loop, initialized, icp_map):
        """(c): ICP's end, the map update and the diagnostics, the new state
        written into the buffers; without a group its first-scan test to
        the host (every lane initialized, as the captured step runs only
        then), under a group each lane's selection by (a)'s test."""
        step, S = self.step, self.state
        res = step.outcome(S, prep, step.align.finish(loop), initialized)
        new, diag = step.update(S, prep, *res, tab_out=S.keyframe.tab)
        copy_state(S, new)  # the table is in place already (spatial: copied here)
        if not self.grouped:
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
        group = self.step.group
        loop_graph = pool is not None and not self.grouped
        automatic = gc.isenabled()
        gc.disable()
        try:
            a = _Segment(self.segment_a, pool, group)
            if loop_graph:  # the round alone: the loop graph adds the condition
                b = _Segment(lambda: self.step.align.round(a.out[3], a.out[1]), pool,
                             keep_graph=True)
            else:
                b = _Segment(lambda: self.segment_b(a.out[1], a.out[3]), pool, group)
            c = _Segment(lambda: self.segment_c(*a.out), pool, group, keep_graph=loop_graph)
            self.segments = (a, b, c)
        finally:
            if automatic:
                gc.enable()
        if loop_graph:
            loop = a.out[1]
            self.loop_graph = LoopGraph(b.graph, c.graph, loop.iters, loop.stall,
                                        loop.step_norm, loop.go, self.step.cfg)

    def _run_loop(self) -> None:
        """The rounds while the loop's condition holds, then (c): on the
        card one launch of the loop graph, counted as (c) and the first
        condition (the rounds at `settle`); on the CPU the parts called;
        under a group the host's loop over (b)."""
        a, b, c = self.segments
        if self.grouped:
            self.step.align.run_rounds(a.out[1], b.replay)
            c.replay()
            return
        if self.loop_graph is not None:
            global graph_launches
            self.loop_graph.launch()
            graph_launches += 1
            c.count()
            loop_condition.launches += 1
            _UNSETTLED[id(self.loop_graph)] = (self.loop_graph, b.launches)
            return
        loop = a.out[1]
        self.step.align.condition(loop)
        while bool(loop.go.any()):
            b.replay()
        c.replay()

    def __call__(self, state: OdometryState, scan: LidarScan):
        # known before (a) is queued: a state copied in, a capture; a group's
        # step selects on the device and tests nothing on the host
        initialized = True if self.grouped else None
        if profiling.ON:
            profiling.begin("step.copy_in", "dev.copy_in")
        if any(d is not s for d, s in zip(_leaves(self.state), _leaves(state))):
            copy_state(self.state, state)
            if not self.grouped:
                self._publish()
                initialized = self._all_initialized()
        for d, s in zip(self.scan, scan):
            d.copy_(s, non_blocking=True)
        if profiling.ON:
            profiling.end()
        if self.segments is None and self.eager_scans >= WARM_UP_SCANS and (
                initialized if initialized is not None else self._all_initialized()):
            if profiling.ON:
                profiling.device_end()
                profiling.begin("step.capture")
            self._capture()
            if profiling.ON:
                profiling.end()
            initialized = True
        if self.segments is not None and initialized is not False:
            if profiling.ON:
                profiling.begin("step.replay_a", "dev.a")
            self.segments[0].replay()  # queued before the host waits for the first-scan test
            if profiling.ON:
                profiling.end(dev_end=True)
            if initialized or self._all_initialized():
                if profiling.ON:
                    profiling.begin("step.launch_loop", "dev.loop")
                self._run_loop()
                if not self.grouped:
                    self.initialized.mark()
                if profiling.ON:
                    profiling.end()
                    profiling.begin("step.clone_diag", "dev.clone_diag")
                diag = _map(torch.clone, self.segments[2].out)
                if profiling.ON:
                    profiling.end(dev_end=True)
                return self.state, diag
        if profiling.ON:
            profiling.begin("step.eager", "dev.eager")
        new, diag = self.step(self.state, self.scan)
        diag = _map(torch.clone, diag)  # it may hold the buffers' pose (a first scan's)
        copy_state(self.state, new)
        if not self.grouped:
            self._publish()
        self.eager_scans += 1
        if profiling.ON:
            profiling.end(dev_end=True)
        return self.state, diag


class CapturedStep:
    """The per-scan step (state, scan) -> (state, diagnostics) of
    `make_process_scan(cfg, return_deskewed, sp_group, spatial_group)`,
    replayed from CUDA graphs on CUDA tensors (see the module's docstring)
    and the eager step itself on CPU tensors and under a group on gloo,
    whose collectives a graph cannot hold; bitwise the eager step either
    way. One capture per lane count (no lane axis, or B)."""

    def __init__(self, cfg: OdometryConfig, return_deskewed: bool = False, sp_group=None,
                 spatial_group=None):
        self.eager = make_process_scan(cfg, return_deskewed, sp_group, spatial_group)
        group = self.eager.group
        self.capturable = group is None or not group.live or group.backend == "nccl"
        self._lanes: dict[tuple, _LaneGraphs] = {}

    def __call__(self, state: OdometryState, scan: LidarScan):
        dev = scan.xyz.device
        if dev.type != "cuda" or not self.capturable:
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
