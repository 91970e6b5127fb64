"""The (dp, sp) device mesh as torch.distributed process groups (port of
the JAX ``parallel/mesh.py``), and `run_ranks`, which starts one process
per rank.

The JAX package writes its sharded modes as SPMD programs with
``shard_map`` over a ``Mesh`` of named axes:

- dp: data parallelism over independent sequences (lanes);
- sp: inside one sequence, the ICP loop sharded over query points (or,
  in the spatial mode, the keyframe map sharded over map columns), with
  one sum of the 6x6 normal equations per Gauss-Newton step.

Here every rank is one process, and the program is the same on every
rank. Rank r sits at (r // sp, r % sp). The ranks of one dp index form an
sp group (`dist.new_group`); the sp axis's collectives run on it:

- `psum(x)`: an all-reduce with SUM over the sp group, in place;
- `gather_parts(x)`: every rank's x in group order, (n, *x.shape), for a
  sum the caller takes in a stated order (the split Gauss-Newton step and
  ICP's round sums add their parts in rank order, so every rank and every
  backend gives the same bits; an all-reduce adds in an order of its own);
- `ppermute_from(xs, offset)`: receive from sp rank (r + offset) mod n
  what it sends, through `dist.batch_isend_irecv`.

The backend follows the topology (`choose_backend`; the CLI's `fleet` and
the multi-process demo print it); it is never a fallback:

- gloo for CPU tensors;
- NCCL when every rank has a card of its own;
- gloo when ranks share a card: NCCL refuses two ranks on one device.
  Gloo all-reduces and all-gathers CUDA tensors, but it does not send or
  receive them, so on gloo `ppermute_from` stages a CUDA tensor through
  pinned host memory (device -> host, the exchange, host -> device), and
  counts and times the staging. The tensors and every kernel stay on the
  card.

Every group is created with a timeout (120 s by default), so a
mismatched collective raises instead of hanging.
"""

from __future__ import annotations

import datetime
import gc
import os
import pickle
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from lidar_odometry_demo_tpu_torch.device import resolve_device
from lidar_odometry_demo_tpu_torch.utils.profiling import PendingSpans

GROUP_TIMEOUT_S = 120.0

# this process's rank device, set by init_process_group beside the default
# group (itself one per process): the device a mesh over that group lays its
# tensors on unless its caller names one
_rank_device: torch.device | None = None


def choose_backend(device: torch.device, world_size: int, local_world_size: int | None = None
                   ) -> str:
    """gloo for CPU tensors or ranks that share a card; nccl when each of
    the node's `local_world_size` ranks (default: all of them) has a card of
    its own."""
    if device.type != "cuda":
        return "gloo"
    local = world_size if local_world_size is None else local_world_size
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """Local rank r's device: the CPU, or card r mod the node's card count
    (every rank on cuda:0 on a one-card node)."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def _stream_event(device: torch.device) -> torch.cuda.Event:
    """A timing event recorded now on `device`'s current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


_COUNTS = ("collectives", "gathers", "exchanges", "exchanged_bytes", "staged_bytes")


@dataclass
class CommStats:
    """What one group's collectives cost this process: counts (in
    `collectives` the all-reduces and the gathers, in `gathers` the gathers
    alone), host ms and
    device ms, and the bytes and ms of the host staging of CUDA tensors on
    gloo.

    Host ms (`collective_host_ms`, `exchange_host_ms`) are the host's clock
    around the call. On gloo that covers the transfer: a gloo collective or
    exchange of CUDA tensors first waits for the device work queued before
    it (its copy to the host would), and that wait is taken apart into
    `wait_ms`, so the host ms cover the collective, the exchange and the
    copies alone. On NCCL the call returns once the work is queued, so the
    host ms are the enqueue. The device ms (`collective_device_ms`,
    `exchange_device_ms`) are taken only while `device_timing` is on
    (`reset(device_timing=True)`), and only on NCCL: CUDA events recorded
    on the rank's current stream just before the call and just after it
    (after the stream's wait for NCCL's), the time from the stream reaching
    the collective, the wait for the peers included, to its end. They are
    kept as the span recorder's device spans are (utils/profiling.py
    `PendingSpans`) and read in `settle()`, which waits for the last event
    once: call it once per scan (as_dict calls it too), never per
    collective. Otherwise no
    event is made and they stay 0.

    A captured step (pipeline/graphs.py) records no event inside a graph:
    a graph that holds collectives adds the counts its capture made at
    every replay (`counts`, `add_counts`), no host ms, and while
    `device_timing` is on the device ms of the whole replay, the compute
    around the collectives included, to `graph_device_ms`."""

    collectives: int = 0
    gathers: int = 0
    collective_host_ms: float = 0.0
    collective_device_ms: float = 0.0
    wait_ms: float = 0.0
    exchanges: int = 0
    exchange_host_ms: float = 0.0
    exchange_device_ms: float = 0.0
    exchanged_bytes: int = 0
    staged_bytes: int = 0
    staging_ms: float = 0.0
    graph_device_ms: float = 0.0
    by_kind: dict = field(default_factory=dict)
    device_timing: bool = False
    # (field, start event, end event) of the device spans not read yet
    pending: PendingSpans = field(default_factory=PendingSpans, repr=False)

    def reset(self, device_timing: bool = False) -> None:
        """Every count and time to 0; device spans taken from now on only
        with `device_timing`."""
        for f in ("collectives", "gathers", "exchanges", "exchanged_bytes", "staged_bytes"):
            setattr(self, f, 0)
        for f in ("collective_host_ms", "collective_device_ms", "wait_ms", "exchange_host_ms",
                  "exchange_device_ms", "staging_ms", "graph_device_ms"):
            setattr(self, f, 0.0)
        self.by_kind = {}
        self.device_timing = device_timing
        self.pending = PendingSpans()

    def add_span(self, name: str, start, end) -> None:
        """Keep a device span (start, end events) for `name` (the field of
        device ms it adds to) until the next settle()."""
        self.pending.add(name, start, end)

    def settle(self) -> None:
        """Wait for the last pending span's end and add every pending span's
        device ms to its field."""
        for name, start, end in self.pending.take(wait=True):
            setattr(self, name, getattr(self, name) + start.elapsed_time(end))

    def counts(self) -> dict:
        """The counts (not the times) so far, `by_kind` copied."""
        return {f: getattr(self, f) for f in _COUNTS} | {"by_kind": dict(self.by_kind)}

    def add_counts(self, counts: dict) -> None:
        """Add counts (as `counts` returns them)."""
        for f in _COUNTS:
            setattr(self, f, getattr(self, f) + counts[f])
        for kind, n in counts["by_kind"].items():
            self.by_kind[kind] = self.by_kind.get(kind, 0) + n

    def as_dict(self) -> dict:
        self.settle()
        return {f: getattr(self, f) for f in (
            "collectives", "gathers", "collective_host_ms", "collective_device_ms", "wait_ms",
            "exchanges", "exchange_host_ms", "exchange_device_ms", "exchanged_bytes",
            "staged_bytes", "staging_ms", "graph_device_ms")} | {"by_kind": dict(self.by_kind)}


class Group:
    """One mesh axis's process group as this rank sees it: its size, this
    rank's index in it, and its collectives. `live`: the group has a
    process group behind it (its own, or the default group when it holds
    every rank, a world of one included). A group that is not live runs no
    collective: `psum` returns x, `gather_parts` a copy of x as the one
    part and `ppermute_from` its inputs (one rank of a larger world, or one
    process with no group at all)."""

    def __init__(self, pg, ranks: list[int], rank: int, backend: str, stats: CommStats,
                 live: bool = False):
        self.pg = pg
        self.ranks = ranks              # global ranks, in group order
        self.size = len(ranks)
        self.rank = ranks.index(rank)   # this rank's index in the group
        self.backend = backend
        self.stats = stats
        self.live = live

    def _count(self, kind: str) -> None:
        self.stats.by_kind[kind] = self.stats.by_kind.get(kind, 0) + 1

    def _wait_for_queued(self, x: torch.Tensor) -> None:
        """On gloo, wait for x's device work queued so far (the host copy
        of a CUDA tensor would wait for it anyway), timed as wait_ms."""
        if x.is_cuda and self.backend == "gloo":
            t0 = time.perf_counter()
            torch.cuda.current_stream(x.device).synchronize()
            self.stats.wait_ms += (time.perf_counter() - t0) * 1e3

    def _device_timed(self, x: torch.Tensor) -> bool:
        """NCCL runs on the device: while the stats ask for it, its
        collectives are timed by CUDA events on the current stream as well
        (CommStats)."""
        return self.stats.device_timing and x.is_cuda and self.backend == "nccl"

    def psum(self, x: torch.Tensor, kind: str = "psum") -> torch.Tensor:
        """All-reduce x with SUM over the group, in place; returns x. Every
        rank gets the same bits (each element is reduced once and shared)."""
        if not self.live:
            return x
        self._wait_for_queued(x)
        on_device = self._device_timed(x)
        if on_device:
            start = _stream_event(x.device)
        t0 = time.perf_counter()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.pg)
        self.stats.collectives += 1
        self.stats.collective_host_ms += (time.perf_counter() - t0) * 1e3
        if on_device:
            self.stats.add_span("collective_device_ms", start,
                                _stream_event(x.device))
        self._count(kind)
        return x

    def gather_parts(self, x: torch.Tensor, kind: str = "gather") -> torch.Tensor:
        """Every group rank's x (same shape and dtype on every rank), stacked
        in group order: (n, *x.shape), the parts exactly as each rank sent
        them, so a sum of them in a stated order has the same bits on every
        rank. One all_gather_into_tensor on every backend (gloo takes CUDA
        tensors as well), counted and timed as `psum`. A group that is not
        live returns a copy of x as the one part, (1, *x.shape)."""
        if not self.live:
            return x.unsqueeze(0).clone()
        self._wait_for_queued(x)
        on_device = self._device_timed(x)
        if on_device:
            start = _stream_event(x.device)
        t0 = time.perf_counter()
        out = torch.empty((self.size, *x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out.view(-1), x.contiguous().view(-1), group=self.pg)
        self.stats.collectives += 1
        self.stats.gathers += 1
        self.stats.collective_host_ms += (time.perf_counter() - t0) * 1e3
        if on_device:
            self.stats.add_span("collective_device_ms", start, _stream_event(x.device))
        self._count(kind)
        return out

    def ppermute_from(self, xs, offset: int):
        """Receive from group rank (r + offset) mod n the tensors it passes
        here (same shapes and dtypes on every rank); send this rank's to
        (r - offset) mod n. `xs` is a tensor or a list of tensors; returns
        the received one(s). A group that is not live returns its inputs as
        they are (no exchange), and so does a group of one on gloo, which
        pairs no rank with itself; on NCCL a group of one sends to itself."""
        single = isinstance(xs, torch.Tensor)
        xs = [xs] if single else list(xs)
        if not self.live or (self.size == 1 and self.backend == "gloo"):
            return xs[0] if single else xs
        src = self.ranks[(self.rank + offset) % self.size]
        dst = self.ranks[(self.rank - offset) % self.size]
        self._wait_for_queued(xs[0])
        on_device = self._device_timed(xs[0])
        if on_device:
            start = _stream_event(xs[0].device)
        t0 = time.perf_counter()
        stage = self.backend == "gloo" and xs[0].is_cuda
        if stage:  # gloo sends no CUDA tensor: through pinned host memory
            t_s = time.perf_counter()
            send = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in xs]
            for h, x in zip(send, xs):
                h.copy_(x, non_blocking=True)
            torch.cuda.current_stream(xs[0].device).synchronize()
            staged_ms = (time.perf_counter() - t_s) * 1e3
            recv = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in xs]
        else:
            send = [x.contiguous() for x in xs]
            recv = [torch.empty_like(x) for x in send]
        ops = [dist.P2POp(dist.isend, s, dst, self.pg) for s in send]
        ops += [dist.P2POp(dist.irecv, r, src, self.pg) for r in recv]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        n_bytes = sum(x.numel() * x.element_size() for x in xs)
        if stage:
            t_s = time.perf_counter()
            out = [r.to(x.device, non_blocking=True) for r, x in zip(recv, xs)]
            torch.cuda.current_stream(xs[0].device).synchronize()
            staged_ms += (time.perf_counter() - t_s) * 1e3
            self.stats.staged_bytes += 2 * n_bytes
            self.stats.staging_ms += staged_ms
        else:
            out = recv
        self.stats.exchanges += 1
        self.stats.exchanged_bytes += 2 * n_bytes
        self.stats.exchange_host_ms += (time.perf_counter() - t0) * 1e3
        if on_device:
            self.stats.add_span("exchange_device_ms", start,
                                _stream_event(xs[0].device))
        self._count("ppermute")
        return out[0] if single else out


class Mesh:
    """A (dp, sp) layout of the ranks of the default process group (or of
    one process, dp = sp = 1, with no group at all).

    rank, world_size, dp_index, sp_index: this rank's place; `sp` is the sp
    axis's Group (its collectives), `axis("dp")` the dp axis's; `device`
    the rank's device; `backend` the default group's backend ("none"
    without a group); `stats` the collectives' costs on this rank."""

    def __init__(self, dp: int, sp: int, device: torch.device, rank: int, backend: str,
                 groups: dict):
        self.dp, self.sp_size = dp, sp
        self.world_size = dp * sp
        self.rank = rank
        self.dp_index, self.sp_index = divmod(rank, sp)
        self.device = device
        self.backend = backend
        self.groups = groups
        self.sp = groups["sp"]
        self.stats = self.sp.stats

    def axis(self, name: str) -> Group:
        """The Group of this rank along mesh axis "dp" or "sp"."""
        return self.groups[name]

    def lanes(self, batch: int) -> slice:
        """This rank's lanes of a batch of `batch` sequences: its dp index's
        share (every rank of one sp group steps the same lanes)."""
        if batch % self.dp:
            raise ValueError(f"batch {batch} is not divisible by dp={self.dp}")
        n = batch // self.dp
        return slice(self.dp_index * n, (self.dp_index + 1) * n)

    def all_gather_object(self, obj) -> list:
        """Every rank's `obj`, in rank order (pickled; for results, not the
        hot path)."""
        if self.world_size == 1:
            return [obj]
        out = [None] * self.world_size
        dist.all_gather_object(out, obj)
        return out


def make_mesh(dp: int = 1, sp: int = 1, device=None) -> Mesh:
    """The (dp, sp) mesh over the default process group, which must hold
    dp x sp ranks; dp = sp = 1 needs no group. Every rank must call this,
    in the same order as every other group it creates: each sp group is
    created by every rank (`dist.new_group` is collective).

    `device`: the rank's device. None takes the one `init_process_group`
    gave this process's rank, or, with no group, the port's default
    (device.resolve_device: the card, raising without one)."""
    n = dp * sp
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    if world != n:
        raise ValueError(f"a dp={dp} x sp={sp} mesh needs {n} ranks, the process group has "
                         f"{world}")
    rank = dist.get_rank() if initialized else 0
    backend = str(dist.get_backend()) if initialized else "none"
    if device is None:
        device = _rank_device if initialized and _rank_device is not None else None
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    stats = CommStats()
    groups = {}
    # every rank creates every group, in one order: the sp groups (ranks of
    # one dp index), then the dp groups (ranks of one sp index); an axis
    # over all ranks uses the default group
    for name, members in (("sp", [[d * sp + j for j in range(sp)] for d in range(dp)]),
                          ("dp", [[d * sp + j for d in range(dp)] for j in range(sp)])):
        for ranks in members:
            pg = None
            if initialized and 1 < len(ranks) < n:
                pg = dist.new_group(ranks, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
            if rank in ranks:
                live = initialized and (pg is not None or len(ranks) == n)
                groups[name] = Group(pg, ranks, rank, backend, stats, live)
    return Mesh(dp, sp, torch.device(device), rank, backend, groups)


def default_mesh(device=None) -> Mesh:
    """All ranks on the dp axis."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return make_mesh(dp=world, sp=1, device=device)


def init_process_group(rank: int, world_size: int, device: torch.device, init_method: str,
                       local_world_size: int | None = None,
                       timeout_s: float = GROUP_TIMEOUT_S) -> str:
    """Initialise the default group with the backend the topology picks
    (`choose_backend`), `device` this rank's (`make_mesh`'s default from
    now on); returns the backend."""
    global _rank_device
    backend = choose_backend(device, world_size, local_world_size)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    _rank_device = device
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def _to_host(x):
    """Tensors -> numpy, through tuples, lists and dicts (NamedTuples too)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_host(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def destroy_process_group() -> None:
    """Destroy the default group once the garbage is collected: a captured
    step's graphs that hold the group's NCCL collectives (pipeline/graphs.py)
    must be gone before its communicators are (with them still alive, two
    ranks on H100s hung at the group's destruction), and a step's graphs
    refer to one another, so only a collection frees them."""
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dist.destroy_process_group()


def _rank_main(fn, rank: int, world_size: int, device_type: str, init_method: str,
               results, args) -> None:
    """One rank: join the group, run fn(*args), send back its result (or
    the traceback)."""
    try:
        device = rank_device(device_type, rank)
        if device.type == "cpu":  # ranks share the host's cores: one thread each
            torch.set_num_threads(1)
        init_process_group(rank, world_size, device, init_method)
        try:
            out = _to_host(fn(*args))
        finally:
            destroy_process_group()
        results.put((rank, "ok", pickle.dumps(out)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))  # the parent raises it
        raise


def run_ranks(fn, world_size: int, *args, device: str | None = None,
              timeout: float = 600.0) -> list:
    """Run fn(*args) in `world_size` spawned processes, one rank each, and
    return each rank's result (tensors as numpy), in rank order.

    Each rank joins a default group of `world_size` through a `file://`
    store in a fresh temporary directory (so concurrent callers never
    collide on a port), on the backend `choose_backend` picks for
    `device` ("cuda", the default: rank r on card r mod the card count,
    raising where there is no card; or "cpu" where the caller asks). `fn`
    must be importable (a module-level function) and builds its mesh with
    `make_mesh`. Raises RuntimeError with the failing rank's traceback when
    a rank fails, and when `timeout` seconds pass before every rank is done;
    every process is stopped before this returns."""
    import torch.multiprocessing as mp

    device = resolve_device(device).type
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, device, f"file://{os.path.join(tmp, 'store')}",
                               results, args), daemon=True)
             for r in range(world_size)]
    out: list = [None] * world_size
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        pending = set(range(world_size))
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"run_ranks: ranks {sorted(pending)} not done after "
                                   f"{timeout} s")
            try:
                rank, status, payload = results.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                dead = [r for r in pending if procs[r].exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"run_ranks: rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result") from None
                continue
            if status == "error":
                raise RuntimeError(f"run_ranks: rank {rank} failed:\n{payload}")
            out[rank] = pickle.loads(payload)
            pending.discard(rank)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
