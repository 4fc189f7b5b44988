"""Master node: the serving loop and the HTTP control surface.

The port's twin of misaka_tpu/runtime/master.py.  One `MasterNode` serves
one network instance (batch=None, the reference's default: strict FIFO on
one instance) or B independent instances in lockstep.  A device-loop
thread cuts the pending values into each instance's input ring, runs one
chunk through the serve call (core/engine.py::make_serve unbatched,
make_batched_serve batched: feed, chunk and pack, one host read) and
hands every instance's outputs back to its waiting caller.

Kept from the JAX master, with the same behaviour:

- the lifecycle (run / pause / reset / load, compile-first) and status;
- the three compute lanes: `compute_many` (one instance, strict FIFO),
  `compute_spread` (contiguous stripes over free instances) and
  `compute_coalesced` (the `ServeBatcher`: concurrent callers fuse into
  shared passes over free instances; MISAKA_SERVE_BATCH=0 turns it off and
  the lane falls back to `compute_spread`);
- per-slot FIFO pairing with stale tracking across timeouts and the epoch
  wipe on reset/load/restore, the feed cut (_build_feed / _cut_pending);
- stack autogrow: a request stalled on a full stack doubles the stack
  capacity, up to a byte budget (the reference's stacks are unbounded);
- `.npz` checkpoints in the reference's format (runtime/checkpoint.py),
  snapshot / restore, and the restore flush that keeps a resurrected
  in-flight value from pairing with a new request;
- the instruction trace ring (`trace_cap`, core/trace.py): the debug path
  records every tick of one instance and `trace()` decodes it.

`make_http_server` keeps POST /run /pause /reset /load /compute
/compute_batch /compute_raw /checkpoint /restore /profile/start
/profile/stop /fleet/drain and GET /status, /metrics, /healthz,
/debug/requests, /debug/perfetto, /debug/isa_trace and /trace (its
deprecated alias) with the JAX server's bodies and status codes, the
request trace around every handler (`X-Misaka-Trace` in and out,
`Server-Timing`), the fast request parser (MISAKA_FAST_HTTP), TLS
(MISAKA_TLS_CERT/KEY) and the edge chain before every route body
(runtime/edge.py: API keys, tenant quotas, admission on the ServeBatcher's
waiting values, signed tenant tokens at POST /edge/token, usage gossip at
POST /edge/gossip, the /healthz `edge` block).  With a program registry
(runtime/registry.py) it also keeps POST/GET /programs, GET
/programs/<name> and program-addressed compute (/programs/<name>/<op>, or
X-Misaka-Program on the legacy routes), each compute request served by the
engine a registry lease resolves; without one a named program is the
reference's typed 404.  /healthz carries the canary's block when the app
runs one (runtime/canary.py).  The telemetry planes: GET /debug/usage and
/usage/export (the usage ledger, runtime/usage.py, booked by every pass),
GET /debug/alerts and the /healthz `slo` state (the SLO burn-rate engine,
utils/slo.py, observing every compute route), GET and POST /debug/faults
(utils/faults.py), and GET /debug/captures with POST
/captures/start|stop|rotate|export (the wire recorder, runtime/capture.py,
noting every compute route while it records).  The always-on planes,
started by every server: GET /debug/flamegraph (the stack sampler,
utils/sampler.py), GET /debug/series and /debug/dashboard (the TSDB,
utils/tsdb.py and utils/dashboard.py; its history rides the checkpoints
as `__tsdb__`), and the watchdog's rules (utils/watchdog.py: /healthz
`watchdog`, the `watchdog` block of /debug/alerts).  MISAKA_TSDB_DIR arms
the durable tier: the TSDB's spooled history, the usage ledger's spool
and the always-on capture spool.

Observability (the reference's, for what the port runs): the `M_*`
series below under the reference's names, types and labels, served at GET
/metrics (utils/metrics.py); the request spans `http.parse`,
`serve.queue`, `serve.pass` and the `engine.chunk` tier event
(utils/tracespan.py); profiles through torch.profiler, begun and ended on
the device-loop thread (utils/profiling.py::LoopCapture); the
`misaka_usage_*`, `misaka_slo_*`, `misaka_capture_*`, `misaka_tsdb_*`
and `misaka_spool_errors_total` series; with a native engine the
`misaka_native_*` series (core/native_serve.py), GET /debug/native_trace
(its flight recorder's rings) and its worker spans in /debug/perfetto.
Left out: the series and hooks of the distributed mode (A.5).

`AutoCheckpointer` (MISAKA_AUTOCKPT) snapshots the live state on an
interval, rotates, and restores the newest valid snapshot at boot.

Engines (`engine=`): "auto" runs every untraced chunk through the fused
CUDA kernel on a card (the full kernel unbatched; batched, the elided
variant under MISAKA_FUSED_ELIDE_HI=1); on the CPU it serves through the
host C++ tier below where the reference's does (`_use_native_auto`:
untraced, no mesh, a batch of at most MISAKA_NATIVE_AUTO_MAX_BATCH,
MISAKA_NATIVE_AUTO not "0", the interpreter builds), else through the
kernel's plain torch version; "scan" runs the plain version on any
device; "fused" requires the kernel.  A traced master runs the plain
version with recording, as the reference's traced masters run its scan
engine.  "native" serves on the host C++ tier (core/native_serve.py)
whatever the device: NativeServe unbatched, NativeServePool batched,
whose tick ladder (jit, specialized, avx2 or generic, scalar) is climbed
only at batch >= 8 with a `native_spec_dir`.  The state is then CPU tensors that the engine may hold
resident in C++ between chunks: every reader of the state's content
exports it first (`_sync_native_state`), and the batched loop ticks only
the replicas that have work (`_native_active`).

Mesh serving (`data_parallel=D`, `model_parallel=M`, the reference's mesh
master): a [D, M] mesh of devices (parallel/mesh.py).  The batch is cut
into D contiguous rows; with M > 1 each row's program lanes are cut into M
slices whose shards agree every tick through the collectives of
core/axis.py (the routed engine, parallel/routed.py, or under
engine="gather" parallel/sharded.py), while the stacks and rings are
replicated over the row's shards.  The network compiles to a
`ShardedNetwork` whose serving members take the global feed (written into
every replica) and give global counters and slots, so the device loop, the
slot locks and the scheduler are the same for one device and for D x M.
`self._state` is then the list of shard states, row-major; status reads
the shards on the host, and checkpoints, `snapshot` and `restore` carry
the global [B, ...] arrays, as the JAX mesh master writes them, so a
checkpoint moves between any D x M and the JAX package at the same B.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import logging
import os
import queue
import re
import ssl
import threading
import time
import weakref
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

import numpy as np
import torch

from misaka_tpu_torch.core import fused
from misaka_tpu_torch.core.state import (
    NetworkState,
    clone_state,
    init_state,
    state_from_numpy,
    state_to_numpy,
)
from misaka_tpu_torch.core.trace import TraceRing, decode_trace
from misaka_tpu_torch.parallel.mesh import ShardedNetwork, gather_state, make_mesh, shard_state
from misaka_tpu_torch.runtime import canary as canary_mod
from misaka_tpu_torch.runtime import capture as capture_mod
from misaka_tpu_torch.runtime import checkpoint as ckpt
from misaka_tpu_torch.runtime import edge as edge_mod
from misaka_tpu_torch.runtime import usage
from misaka_tpu_torch.runtime.registry import ProgramNotFound, RegistryError, ReplayDivergence
from misaka_tpu_torch.runtime.topology import Topology, TopologyError
from misaka_tpu_torch.tis.lower import TISLowerError
from misaka_tpu_torch.tis.parser import TISParseError
from misaka_tpu_torch.utils import (buildinfo, faults, metrics, profiling, slo, textcodec,
                                    tracespan, wire)
from misaka_tpu_torch.utils import dashboard as dashboard_mod
from misaka_tpu_torch.utils import sampler as sampler_mod
from misaka_tpu_torch.utils import tsdb as tsdb_mod
from misaka_tpu_torch.utils import watchdog as watchdog_mod
from misaka_tpu_torch.utils.httpfast import fast_parse_request as _fast_parse_request
from misaka_tpu_torch.utils.textcodec import dec_to_ints, ints_to_dec

log = logging.getLogger("misaka_tpu_torch.master")

# --- the metrics plane (utils/metrics.py; served at GET /metrics) ----------
# Process-global series under the reference's names, types, help and labels
# (misaka_tpu/runtime/master.py), for what the port runs.  Every MasterNode
# and HTTP server in this process accumulates into the same registry; the
# per-master live values (queue depths) are callback gauges holding
# weakrefs: the last-constructed master wins, a dead one reads 0.
M_TICKS = metrics.counter(
    "misaka_device_loop_ticks_total", "Network ticks advanced by the device loop"
)
M_LOOP_ITERS = metrics.counter(
    "misaka_device_loop_iterations_total",
    "Device-loop iterations by kind (serve = fed or drained, idle = nothing moved)",
    ("kind",),
)
M_CHUNK_SECONDS = metrics.histogram(
    "misaka_device_loop_chunk_seconds",
    "Wall time of one device-loop iteration (feed + chunk + drain)",
)
# children resolved once: no label lookup per iteration
M_ITER_SERVE = M_LOOP_ITERS.labels(kind="serve")
M_ITER_IDLE = M_LOOP_ITERS.labels(kind="idle")
M_SLOT_OCCUPANCY = metrics.histogram(
    "misaka_device_loop_fed_slots",
    "Batch slots fed per serve iteration (batch-slot occupancy)",
    buckets=metrics.pow2_buckets(1, 65536),
)
M_SUBMIT_DEPTH = metrics.gauge(
    "misaka_submit_queue_depth",
    "Request chunks waiting in the submission queue (live master)",
)
M_OUT_DEPTH = metrics.gauge(
    "misaka_out_queue_depth",
    "Output chunks waiting across per-slot output queues (live master)",
)
M_WARM_TOTAL = metrics.counter(
    "misaka_engine_warm_total",
    "Engine warm-ups COMPLETED (first-call jit compiles forced)",
)
M_WARM_FAILED = metrics.counter(
    "misaka_engine_warm_failed_total",
    "Engine warm-ups that raised (the device loop then compiles under lock)",
)
M_WARM_SECONDS = metrics.histogram(
    "misaka_engine_warm_seconds",
    "Completed engine warm-up duration (jit compile + dummy chunk)",
)
M_AUTOGROW = metrics.counter(
    "misaka_stack_autogrow_total", "Successful stack-capacity doublings"
)
M_AUTOGROW_BLOCKED = metrics.counter(
    "misaka_stack_autogrow_blocked_total",
    "Stack wedges auto-grow could not repair (byte budget or engine limits)",
)
M_ENGINE_SWAPS = metrics.counter(
    "misaka_engine_swap_total",
    "Runner replacements by cause (load / restore / autogrow)",
    ("reason",),
)
M_CKPT_SAVE_SECONDS = metrics.histogram(
    "misaka_checkpoint_save_seconds", "save_checkpoint duration"
)
M_CKPT_RESTORE_SECONDS = metrics.histogram(
    "misaka_checkpoint_restore_seconds", "load_checkpoint duration (recompile + swap)"
)
M_CKPT_AGE = metrics.gauge(
    "misaka_checkpoint_age_seconds",
    "Seconds since the live master's last successful checkpoint save "
    "(-1 until one lands; alert when this exceeds the MISAKA_AUTOCKPT "
    "interval by a safety factor)",
)
M_CKPT_REJECTED = metrics.counter(
    "misaka_checkpoint_rejected_total",
    "Checkpoints that failed durability verification (truncated, checksum "
    "mismatch, CRC-corrupt) and were rejected before any state swap",
)
M_COMPUTE_REQS = metrics.counter(
    "misaka_compute_requests_total", "compute/compute_many/compute_spread calls"
)
M_COMPUTE_VALUES = metrics.counter(
    "misaka_compute_values_total", "Values submitted through the compute lanes"
)
M_COMPUTE_TIMEOUTS = metrics.counter(
    "misaka_compute_timeouts_total", "Compute calls that raised ComputeTimeout"
)
M_SERVE_COALESCED_VALUES = metrics.histogram(
    "misaka_serve_coalesced_values",
    "Values fused into one serve-scheduler pass (cross-request batching)",
    buckets=metrics.pow2_buckets(1, 1 << 20),
)
M_SERVE_COALESCED_REQS = metrics.histogram(
    "misaka_serve_coalesced_requests",
    "Requests fused into one serve-scheduler pass",
    buckets=metrics.pow2_buckets(1, 4096),
)
M_SERVE_QUEUE_DELAY = metrics.histogram(
    "misaka_serve_queue_delay_seconds",
    "Time a request waited in the serve-scheduler queue before its first "
    "dispatch (the coalescing latency tax — near zero when the engine is "
    "idle, bounded by pass time under load)",
)
M_SERVE_WAITING = metrics.gauge(
    "misaka_serve_waiting_requests",
    "Requests queued in the serve scheduler, not yet dispatched (live master)",
)
M_SERVE_PASSES = metrics.counter(
    "misaka_serve_passes_total", "Fused serve-scheduler passes dispatched"
)
M_SERVE_LANE_ENTRIES = metrics.counter(
    "misaka_serve_lane_entries_total",
    "Serve-scheduler entries by priority lane (hot = latency-class small "
    "requests, cut into passes ahead of the bulk lane's backlog)",
    ("lane",),
)
M_HTTP_REQS = metrics.counter(
    "misaka_http_requests_total", "HTTP requests by route and method",
    ("route", "method"),
)
M_HTTP_ERRORS = metrics.counter(
    "misaka_http_errors_total", "HTTP responses with status >= 400",
    ("route", "code"),
)
M_HTTP_INFLIGHT = metrics.gauge(
    "misaka_http_inflight", "HTTP requests currently being handled"
)
M_HTTP_LATENCY = metrics.histogram(
    "misaka_http_request_duration_seconds", "HTTP request handling time by route",
    ("route",),
)
M_DEBUG_MEM = metrics.gauge(
    "misaka_debug_mem_bytes",
    "Debug-plane ring memory by plane (trace/flight/capture)",
    ("plane",),
)

# Bounded route-label cardinality, the reference's set: unknown paths
# collapse to "other" (a client must not mint unbounded label values).
_METRIC_ROUTES = frozenset({
    "/run", "/pause", "/reset", "/load", "/compute", "/compute_batch",
    "/compute_raw", "/checkpoint", "/restore", "/profile/start",
    "/profile/stop", "/status", "/trace", "/metrics", "/healthz",
    "/debug/requests", "/debug/perfetto", "/debug/isa_trace",
    "/debug/usage", "/debug/alerts", "/debug/flamegraph",
    "/debug/series", "/debug/dashboard", "/debug/faults",
    "/debug/native_trace", "/debug/captures",
    "/captures/start", "/captures/stop", "/captures/export",
    "/captures/rotate", "/usage/export",
})


# The routes whose outcomes feed the per-program SLO windows (utils/slo.py):
# compute traffic only, never scrapes or debug reads.
_SLO_ROUTES = frozenset({
    "/compute", "/compute_batch", "/compute_raw",
    "/programs/compute", "/programs/compute_batch", "/programs/compute_raw",
})


# Program-addressed compute (the registry surface, runtime/registry.py):
# the <name> segment collapses out of the route label.  Program names are
# client-chosen, so they live in the registry's own `program`-labelled
# series, with their own cardinality guard, never in the route label.
_PROGRAM_OPS = ("compute", "compute_batch", "compute_raw")
_PROGRAM_COMPUTE_RE = re.compile(r"^/programs/([^/]+)/(compute|compute_batch|compute_raw)$")


def _route_label(path: str) -> str:
    route = path.split("?", 1)[0]
    if route.startswith("/debug/requests/"):
        return "/debug/requests"  # per-trace lookups share one label
    if route.startswith("/programs"):
        parts = route.split("/")
        if len(parts) >= 4 and parts[3] in _PROGRAM_OPS:
            return "/programs/" + parts[3]
        return "/programs"
    return route if route in _METRIC_ROUTES else "other"


class ComputeTimeout(RuntimeError):
    """A compute request's outputs did not all arrive before its deadline."""


# wakes collectors parked on a wiped queue (reset/load); never a real output
_WIPED = np.empty((0,), np.int32)
# an unbatched iteration with nothing to feed
_NO_VALUES = np.empty((0,), np.int32)


# --- the serve scheduler ------------------------------------------------------


class _BatchEntry:
    """One request in the serve scheduler: values in, outputs back.
    `taken`/`filled` are guarded by the scheduler's condition lock; each
    pass writes a disjoint slice of `out`."""

    __slots__ = ("arr", "out", "taken", "filled", "deadline", "event",
                 "error", "enqueued", "dispatched", "cancelled", "traces")

    def __init__(self, arr: np.ndarray, deadline: float, traces=()):
        self.arr = arr
        self.out = np.empty((arr.size,), np.int32)
        self.taken = 0       # values cut into passes so far
        self.filled = 0      # values scattered back so far
        self.deadline = deadline
        self.event = threading.Event()
        self.error: BaseException | None = None
        self.enqueued = time.monotonic()
        self.dispatched = False  # first-dispatch latch (queue-delay metric)
        self.cancelled = False   # the waiter gave up: skip the remainder
        # the request traces riding this entry (utils/tracespan.py), passed
        # explicitly: the scheduler's workers are other threads, where the
        # handler's contextvar does not reach.  () = untraced.
        self.traces = traces


class _BatcherShared:
    """The queue state a parked worker holds.  It references no master, so
    an idle worker never keeps a dropped master alive."""

    __slots__ = ("cond", "pending", "hot", "inflight", "closed", "passes")

    def __init__(self):
        self.cond = threading.Condition()
        # two priority lanes: `hot` (small entries) is cut into passes
        # before `pending` (bulk)
        self.pending: collections.deque[_BatchEntry] = collections.deque()
        self.hot: collections.deque[_BatchEntry] = collections.deque()
        self.inflight = 0   # passes currently executing
        self.closed = False
        self.passes = 0     # passes dispatched (/status serve_passes)

    def waiting(self) -> int:
        """Values enqueued but not yet cut into a pass.  Call under `cond`."""
        return sum(e.arr.size - e.taken for q in (self.hot, self.pending) for e in q)


def _batcher_worker(shared: _BatcherShared, ref) -> None:
    """Dispatcher loop: takes a strong batcher reference only while there is
    work; exits when the scheduler closes or its master is collected."""
    while True:
        with shared.cond:
            if shared.closed:
                return
            if not shared.pending and not shared.hot:
                shared.cond.wait(0.5)
            if shared.closed:
                return
            empty = not shared.pending and not shared.hot
        batcher = ref()
        if batcher is None:
            with shared.cond:
                shared.closed = True
                shared.cond.notify_all()
            return
        if not empty:
            try:
                batcher._pass_once()
            except Exception:  # a crashed pass must not kill the pool
                log.exception("serve-scheduler pass crashed")
        del batcher


class ServeBatcher:
    """Cross-request micro-batching between the HTTP handlers and the engine
    (the port of misaka_tpu/runtime/master.py::ServeBatcher).

    Callers enqueue (values, event) entries; a small pool of workers each
    packs everything waiting (FIFO, large entries split) into contiguous
    stripes over free instance slots, submits the pass as one
    submission-queue entry, collects each stripe in order and scatters the
    outputs back.  Per-slot FIFO plus contiguous striping makes the flat
    input order the flat output order, so pairing is exact by construction.

    An idle engine dispatches the first arrival at once; entries coalesce
    only while passes are in flight.  Knobs (the reference's):
    MISAKA_BATCH_WINDOW_US (an explicit coalesce window while a pass is in
    flight, default 0), MISAKA_BATCH_MAX (values per pass, default
    B x in_cap), MISAKA_BATCH_PASSES (workers, default min(4, B)),
    MISAKA_LANE_SMALL (entries up to this many values ride the hot lane,
    default 8192; 0 puts everything in the bulk lane).  Timeouts, stale
    marking and the epoch wipe ride the master's per-slot machinery.
    """

    def __init__(self, master: "MasterNode", n_slots: int, in_cap: int):
        # a proxy, not a reference: the master owns its batcher, and a
        # cycle between them would keep a dropped engine's device state
        # alive until the next garbage collection
        self._master = weakref.proxy(master)
        self._n_slots = int(n_slots)
        self._in_cap = max(1, int(in_cap))
        self._max_values = int(
            os.environ.get("MISAKA_BATCH_MAX", "") or 0
        ) or self._n_slots * self._in_cap
        self._window_s = float(os.environ.get("MISAKA_BATCH_WINDOW_US", "") or 0) / 1e6
        self._n_workers = int(
            os.environ.get("MISAKA_BATCH_PASSES", "") or 0
        ) or min(4, self._n_slots)
        self._hot_max = int(os.environ.get("MISAKA_LANE_SMALL", "") or 8192)
        self._shared = _BatcherShared()
        self._workers: list[threading.Thread] = []
        ref = weakref.ref(self)
        M_SERVE_WAITING.set_function(
            lambda: (len(b._shared.pending) + len(b._shared.hot)
                     if (b := ref()) is not None else 0))

    @property
    def passes(self) -> int:
        with self._shared.cond:
            return self._shared.passes

    def waiting_values(self) -> int:
        with self._shared.cond:
            return self._shared.waiting()

    def compute(self, arr: np.ndarray, timeout: float, traces=()) -> np.ndarray:
        """Enqueue one request's values and wait for its outputs (len(arr)
        in, len(arr) out, order kept).  Entries of at most
        MISAKA_LANE_SMALL values ride the hot lane.  `traces`: the request
        traces that get this entry's serve.queue and serve.pass spans."""
        self._ensure_workers()
        entry = _BatchEntry(arr, time.monotonic() + timeout, traces=traces)
        shared = self._shared
        lane = "hot" if 0 < arr.size <= self._hot_max else "bulk"
        M_SERVE_LANE_ENTRIES.labels(lane=lane).inc()
        with shared.cond:
            if shared.closed:
                raise ComputeTimeout("the serve scheduler is closed")
            (shared.hot if lane == "hot" else shared.pending).append(entry)
            shared.cond.notify()
        with self._master._waiters_lock:
            self._master._requests_total += 1
        M_COMPUTE_REQS.inc()
        M_COMPUTE_VALUES.inc(arr.size)
        usage.add_request(self._master.program_label, arr.size)
        if not entry.event.wait(timeout):
            with shared.cond:
                entry.cancelled = True  # skip the undispatched remainder
                missing = entry.arr.size - entry.filled
            M_COMPUTE_TIMEOUTS.inc()
            raise ComputeTimeout(
                f"no output for {missing}/{entry.arr.size} value(s) after {timeout}s"
            )
        if entry.error is not None:
            if isinstance(entry.error, ComputeTimeout):
                M_COMPUTE_TIMEOUTS.inc()
            raise entry.error
        return entry.out

    def _ensure_workers(self) -> None:
        """Start the worker pool on first use: a master that never serves
        coalesced traffic owns no threads."""
        if self._workers:
            return
        with self._shared.cond:
            if self._workers:
                return
            ref = weakref.ref(self)
            for i in range(self._n_workers):
                t = threading.Thread(target=_batcher_worker, args=(self._shared, ref),
                                     daemon=True, name=f"misaka-torch-batcher-{i}")
                t.start()
                self._workers.append(t)

    def begin_close(self) -> None:
        """Refuse new work and fail every queued entry at once."""
        failed: list[_BatchEntry] = []
        with self._shared.cond:
            self._shared.closed = True
            for q in (self._shared.hot, self._shared.pending):
                while q:
                    e = q.popleft()
                    if e.error is None:
                        e.error = ComputeTimeout("the serve scheduler was closed")
                    failed.append(e)
            self._shared.cond.notify_all()
        for e in failed:
            e.event.set()

    def join(self, timeout: float) -> bool:
        """Wait for every worker to exit; True when all did."""
        deadline = time.monotonic() + timeout
        for t in self._workers:
            t.join(max(0.0, deadline - time.monotonic()))
        return not any(t.is_alive() for t in self._workers)

    # --- the dispatcher side (worker threads) --------------------------------

    def _acquire_slots(self, want: int) -> list[int]:
        """Try-acquire up to `want` free instance slots from the master's
        rotating start (never blocking, so a pass cannot deadlock against
        direct compute_many/compute_spread callers)."""
        master = self._master
        n = self._n_slots
        with master._rr_lock:
            start = master._rr
            master._rr = (master._rr + 1) % n
        slots: list[int] = []
        for i in range(n):
            s = (start + i) % n
            if master._compute_locks[s].acquire(blocking=False):
                slots.append(s)
                if len(slots) >= want:
                    break
        return slots

    def _pass_once(self) -> None:
        """Pack everything waiting into one pass, run it, scatter outputs."""
        master = self._master
        shared = self._shared
        if self._window_s > 0:  # explicit coalesce window, only mid-flight
            with shared.cond:
                if shared.inflight and (shared.pending or shared.hot):
                    deadline = time.monotonic() + self._window_s
                    while shared.waiting() < self._max_values:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        shared.cond.wait(remaining)
        with shared.cond:
            waiting = shared.waiting()
        if waiting <= 0:
            return
        want = min(self._n_slots, -(-min(waiting, self._max_values) // self._in_cap))
        slots = self._acquire_slots(want)
        if not slots:
            # every instance is busy: wait for a pass to finish (it notifies)
            with shared.cond:
                if (shared.pending or shared.hot) and not shared.closed:
                    shared.cond.wait(0.05)
            return
        # cut FIFO segments off the waiting entries, hot lane first; when
        # both lanes wait the hot lane gets at most 3/4 of the pass, so a
        # sustained hot stream cannot starve an admitted bulk entry
        budget = min(len(slots) * self._in_cap, self._max_values)
        segs: list[tuple[_BatchEntry, int, int]] = []
        with shared.cond:
            # the queue-delay clock reads inside the lock: an entry enqueued
            # between an outside read and the acquisition would observe a
            # negative delay
            now = time.monotonic()
            reserve = max(1, budget // 4) if (shared.hot and shared.pending) else 0
            caps = (max(1, budget - reserve), budget)
            for q, cap in zip((shared.hot, shared.pending), caps):
                while q and budget > 0 and cap > 0:
                    e = q[0]
                    if e.cancelled:
                        q.popleft()
                        continue
                    take = min(budget, cap, e.arr.size - e.taken)
                    if not e.dispatched:
                        e.dispatched = True
                        M_SERVE_QUEUE_DELAY.observe(now - e.enqueued)
                        usage.add_queue(master.program_label, now - e.enqueued)
                        for tr in e.traces:
                            tracespan.add_span(tr, "serve.queue", e.enqueued,
                                               now - e.enqueued)
                    segs.append((e, e.taken, take))
                    e.taken += take
                    budget -= take
                    cap -= take
                    if e.taken >= e.arr.size:
                        q.popleft()
            if segs:
                shared.inflight += 1
                shared.passes += 1
        if not segs:  # another worker drained the queue first
            for s in slots:
                master._compute_locks[s].release()
            return
        try:
            self._run_pass(slots, segs)
        finally:
            with shared.cond:
                shared.inflight -= 1
                shared.cond.notify_all()  # slots freed; window waiters wake

    def _run_pass(self, slots: list[int], segs: list[tuple[_BatchEntry, int, int]]) -> None:
        """One pass: stripe, submit, collect, scatter.  Releases `slots`."""
        master = self._master
        shared = self._shared
        if faults.armed():
            # chaos (utils/faults.py): `serve_delay` delays every pass,
            # `serve_delay:<program>` only that program's
            delay = faults.fire("serve_delay")
            if delay is None:
                delay = faults.fire(
                    f"serve_delay:{master.program_label or usage.DEFAULT_LABEL}")
            if delay is not None:
                time.sleep(max(0.0, delay))
        t_pass = time.monotonic()
        if len(segs) == 1:
            e0, s0, ln = segs[0]
            flat = e0.arr[s0:s0 + ln]
        else:
            flat = np.concatenate([e.arr[s0:s0 + ln] for e, s0, ln in segs])
        total = int(flat.size)
        n_used = min(len(slots), -(-total // self._in_cap))
        used, unused = slots[:n_used], slots[n_used:]
        for s in unused:
            master._compute_locks[s].release()
        stripes = np.array_split(flat, n_used)
        M_SERVE_COALESCED_VALUES.observe(total)
        M_SERVE_COALESCED_REQS.observe(len(segs))
        M_SERVE_PASSES.inc()
        deadline = max(e.deadline for e, _, _ in segs)
        timeout_s = max(0.0, deadline - time.monotonic())
        with master._waiters_lock:
            master._waiters += 1
        token = master._trace_ids_enter(tr for e, _, _ in segs for tr in e.traces)

        def record_pass_spans(bill: bool = True) -> None:
            # one serve.pass span per traced request of the pass (coalesced
            # requests share its timing).  Before any event.set(): a woken
            # waiter builds its Server-Timing header from the spans so far.
            dur = time.monotonic() - t_pass
            if bill:
                # the usage ledger (runtime/usage.py): this batcher serves
                # one program, so the whole pass bills to it; a failed
                # pass bills nothing, the anchor included (conservation)
                usage.note_pass(dur)
                usage.add_cpu(master.program_label, dur)
            attrs = {"requests": len(segs), "values": total, "slots": n_used}
            if master.program_label is not None:
                # which registry program this pass served (the trace-side
                # twin of the registry series' `program` label)
                attrs["program"] = master.program_label
            for e, _, _ in segs:
                for tr in e.traces:
                    tracespan.add_span(tr, "serve.pass", t_pass, dur, attrs)

        try:
            with master._epoch_lock:
                if shared.closed:  # atomic against close()'s queue wipe
                    raise ComputeTimeout("the serve scheduler was closed")
                epoch = master._epoch
                master._out_qs.make(used)
                master._submit_q.put(list(zip(used, stripes)))
            master._work_event.set()
            parts: list[np.ndarray] = []
            try:
                for i, (s, stripe) in enumerate(zip(used, stripes)):
                    parts.extend(master._collect_slot(s, stripe.size, deadline, epoch, timeout_s))
            except ComputeTimeout:
                # the stripes never collected will surface outputs too: mark
                # those slots stale so their pairing survives
                with master._epoch_lock:
                    if master._epoch == epoch:
                        for s2, st2 in list(zip(used, stripes))[i + 1:]:
                            master._stale[s2] += st2.size
                raise
            flat_out = np.concatenate(parts)
            record_pass_spans()  # before any waiter wakes
            # per-slot FIFO + contiguous striping: segment j's outputs are
            # flat_out[pos_j : pos_j + len_j]
            pos = 0
            done: list[_BatchEntry] = []
            with shared.cond:
                for e, s0, ln in segs:
                    e.out[s0:s0 + ln] = flat_out[pos:pos + ln]
                    pos += ln
                    e.filled += ln
                    if e.filled >= e.arr.size:
                        done.append(e)
            for e in done:
                e.event.set()
        except Exception as exc:
            record_pass_spans(bill=False)  # before the failed waiters wake
            msg = f"{exc} (coalesced pass: {len(segs)} request(s), {total} values)"
            failed: list[_BatchEntry] = []
            with shared.cond:
                for e, _, _ in segs:
                    if e.error is None:
                        e.error = ComputeTimeout(msg) if isinstance(exc, ComputeTimeout) else exc
                    e.cancelled = True  # its caller already fails: stop serving it
                    failed.append(e)
            for e in failed:
                e.event.set()
        finally:
            master._trace_ids_exit(token)
            with master._waiters_lock:
                master._waiters -= 1
            for s in used:
                master._compute_locks[s].release()


# --- the master ---------------------------------------------------------------


class _SlotQueues(dict):
    """The per-slot output queues, each made on its slot's first use.  A
    master of B instances would otherwise build B queue.Queue objects at
    construction (seconds of host time at B=262144, paid again by every
    registry activation) and walk them all at every wipe.  A submission
    makes its slots' queues under the epoch lock (`make`), so a wipe,
    which holds that lock, reaches every queue a pre-wipe request
    collects from."""

    __slots__ = ()

    def __missing__(self, slot: int) -> queue.Queue:
        # one atomic dict operation: threads that miss at once share a queue
        return self.setdefault(slot, queue.Queue())

    def make(self, slots) -> None:
        for s in slots:
            if s not in self:
                self.setdefault(s, queue.Queue())


_ENGINES = ("auto", "scan", "fused", "fused-interpret", "gather", "native")


class MasterNode:
    """Control plane + I/O gateway for one network."""

    def __init__(
        self,
        topology: Topology,
        chunk_steps: int = 128,
        trace_cap: int | None = None,
        batch: int | None = None,
        engine: str = "auto",
        trace_instance: int = 0,
        device: str | torch.device | list | None = None,
        stack_autogrow: bool = True,
        stack_grow_max_bytes: int = 256 * 1024 * 1024,
        data_parallel: int | None = None,
        model_parallel: int | None = None,
        native_spec_dir: str | None = None,
    ):
        """batch=None serves one network instance (every /compute strictly
        FIFO).  batch=B runs B independent instances in lockstep and hands
        concurrent requests to free instances, each instance's pairing
        strictly FIFO.  device=None serves on the card, which must exist.

        engine: "auto" (the fused kernel on a card for every untraced
        path; on the CPU the host C++ tier where `_use_native_auto` says
        so, else the plain version), "scan" (the plain torch loop
        on the given device), "fused" (require the kernel: batched,
        untraced, on a card) or "native" (the host C++ interpreter tier,
        core/native_serve.py, on the host whatever `device` says; refused
        with a trace or a mesh, as the reference's).  "fused-interpret"
        and "gather" raise as the reference's refusals do.

        native_spec_dir: the compile cache of the native tick ladder's top
        rungs (core/jit.py, core/specialize.py); None keeps a native pool
        on the avx2 / generic rung, so a direct construction never runs
        the compiler.

        trace_cap=N records every tick of one instance (`trace_instance`
        when batched) in an N-tick ring, decoded by `trace()`; a traced
        master runs the plain version with recording (the debug path).

        data_parallel=D / model_parallel=M serve over a [D, M] mesh
        (parallel/mesh.py) of device=None the first D*M cards (raises when
        the host has fewer), "cpu" D*M shards on the CPU, or a list of D*M
        devices, row-major, which may repeat one card.  data: the batch in
        D contiguous rows (B must divide by D), one fused-kernel launch per
        row on a card; model: each row's lanes in M slices (the lane count
        must divide by M) that agree every tick through in-process
        collectives: engine "auto" or "scan" serves the routed engine
        (parallel/routed.py), "gather" the first-generation one
        (parallel/sharded.py), and "fused" raises, as the reference's.

        stack_autogrow: double a full stack's capacity when a request
        stalls on it, while the stacks' bytes stay within
        stack_grow_max_bytes (the reference's stacks are unbounded,
        intStack.go:9-45)."""
        if batch is not None and (not isinstance(batch, int) or batch < 1):
            raise ValueError(f"batch must be None or an int >= 1, got {batch!r}")
        if engine not in _ENGINES:
            raise ValueError(f"engine must be {'|'.join(_ENGINES)}, got {engine!r}")
        if engine == "native":
            # the host-interpreter tier: one instance (latency) or B
            # thread-pooled replicas (throughput); host, untraced
            if trace_cap:
                raise ValueError("tracing runs the scan engine (the debug "
                                 "path), not the native engine")
            if data_parallel or model_parallel:
                raise ValueError("engine='native' is single-chip (host) serving")
        if engine == "fused-interpret":
            raise ValueError(
                "engine='fused-interpret': the port has no kernel interpreter; the "
                "kernel's plain version is engine='scan'")
        if engine == "gather" and not (model_parallel and model_parallel > 1):
            raise ValueError("engine='gather' requires model_parallel > 1")
        if trace_cap and not (0 <= trace_instance < (batch or 1)):
            raise ValueError(
                f"trace_instance {trace_instance} out of range [0, {batch or 1})")
        self._mesh = None
        self._mp = 1
        if data_parallel or model_parallel:
            if batch is None:
                raise ValueError("mesh serving requires batch=N")
            dp = int(data_parallel or 1)
            mp = int(model_parallel or 1)
            if batch % dp:
                raise ValueError(f"batch {batch} not divisible by data_parallel={dp}")
            if trace_cap:
                raise ValueError("tracing is single-chip-only (the debug path)")
            if mp > 1 and engine in ("fused", "fused-interpret"):
                raise ValueError("model-parallel serving uses the routed engine "
                                 "(engine='auto', 'scan', or 'gather')")
            self._mesh = make_mesh(dp * mp, device, model_parallel=mp)
            self._mp = mp
        if engine == "fused" and (trace_cap or batch is None):
            raise ValueError("fused engine requires batch=N and no trace_cap "
                             "(tracing runs the scan engine)")
        self._topology = topology
        self._chunk = chunk_steps
        self._batch = batch
        self._engine = engine
        self._device = device
        # the instruction trace ring (core/trace.py): one instance's history
        self._trace_cap = trace_cap
        self._native = engine == "native" or (engine == "auto" and self._use_native_auto())
        self._native_spec_dir = native_spec_dir
        self._grow = bool(stack_autogrow)
        self._grow_max_bytes = int(stack_grow_max_bytes)
        self._stall_iters = 0
        # warn-once latch for a wedge growth cannot fix; cleared when
        # anything moves again or on reset/load
        self._grow_blocked = False
        self._net = self._compile(topology)
        if engine == "fused" and self._net.device.type != "cuda":
            raise ValueError("engine='fused' needs a CUDA device: on the CPU the "
                             "kernel's plain version serves (engine='auto' or 'scan')")
        self._state = self._net.init_state()
        self._trace_instance = trace_instance
        self._trace = self._net.init_trace(trace_cap) if trace_cap else None
        self._serve = self._make_serve(self._net)
        self._running = False
        self._loop: threading.Thread | None = None
        self._state_lock = threading.Lock()      # guards _state/_net swaps
        self._lifecycle_lock = threading.RLock() # serializes run/pause/reset/load
        n_slots = batch or 1
        self._n_slots = n_slots
        # the native tier's partial-fill bookkeeping (_native_active): fed
        # minus drained per slot, the replicas that retired instructions
        # last chunk, and whether a progress baseline exists yet
        self._inflight = np.zeros((n_slots,), np.int64)
        self._native_hot = np.zeros((n_slots,), bool)
        self._retired_prev = None
        # the request traces of the passes in flight, for the native flight
        # recorder's correlation (active_pass_trace_ids)
        self._pass_traces: dict[int, tuple] = {}
        self._pass_trace_next = 0
        self._pass_traces_lock = threading.Lock()
        self._compute_locks = [threading.Lock() for _ in range(n_slots)]
        # ONE submission queue for all slots (payload: a list of (slot,
        # int32-array) pairs); per-slot output queues, made on first use.
        self._submit_q: queue.Queue = queue.Queue()
        self._out_qs = _SlotQueues()
        # Device-loop-private spillover: submitted chunks that did not fit
        # the input ring yet, plus the set of slots that have any.
        self._in_pending: list[list[np.ndarray]] = [[] for _ in range(n_slots)]
        self._active: set[int] = set()
        # Surplus outputs beyond a request's expectation (non-1:1 networks),
        # held FIFO for the slot's next caller; guarded by the slot lock.
        self._out_leftover = [np.empty((0,), np.int32) for _ in range(n_slots)]
        self._rr = 0
        self._rr_lock = threading.Lock()
        # Outputs orphaned by timeouts are discarded on arrival; the epoch
        # invalidates that bookkeeping across reset/load (see _drain_queues).
        self._stale = [0] * n_slots
        self._epoch = 0
        self._epoch_lock = threading.Lock()
        self._work_event = threading.Event()
        self._waiters = 0
        self._waiters_lock = threading.Lock()
        self._ticks_done = 0
        self._rate: float | None = None
        self._rate_mark_tick = 0
        self._rate_mark_time = time.monotonic()
        self._created_mono = time.monotonic()
        self._requests_total = 0
        self._feed_vals: np.ndarray | None = None
        self._feed_counts: np.ndarray | None = None
        # Restore flush: a restored state can carry values that were in
        # flight when it was taken; the loop runs it to quiescence,
        # discarding outputs, before it ingests new work.
        self._restore_flush = False
        self._flush_iters = 0
        self._flush_quiet = 0
        # The serve scheduler; MISAKA_SERVE_BATCH=0 keeps the direct lanes.
        self._batcher: ServeBatcher | None = None
        if os.environ.get("MISAKA_SERVE_BATCH", "1") != "0":
            self._batcher = ServeBatcher(self, n_slots, self._net.in_cap)
        self._last_ckpt_mono: float | None = None
        # Which registry program this engine serves (runtime/registry.py
        # sets it; None outside the registry): the `program` attr of its
        # serve.pass spans.
        self.program_label: str | None = None
        # Profiles (utils/profiling.py): torch.profiler records the thread
        # that starts it, so a capture is begun and ended by the device
        # loop at an iteration boundary (or when it next starts).  The
        # callback holds this master weakly, as every callback below: a
        # dropped engine's device state is freed when the last reference
        # goes, not at the next garbage collection.
        ref = weakref.ref(self)
        self.profiling = profiling.LoopCapture(
            lambda: (m := ref()) is not None and m._loop is not None and m._loop.is_alive(),
            wake=self._work_event.set)
        M_SUBMIT_DEPTH.set_function(
            lambda: m._submit_q.qsize() if (m := ref()) is not None else 0)
        M_OUT_DEPTH.set_function(
            lambda: sum(q.qsize() for q in list(m._out_qs.values()))
            if (m := ref()) is not None else 0)
        M_CKPT_AGE.set_function(
            lambda: time.monotonic() - m._last_ckpt_mono
            if (m := ref()) is not None and m._last_ckpt_mono is not None else -1.0)

    def _use_native_auto(self) -> bool:
        """Does engine="auto" serve through the host C++ tier?  As the
        reference's (master.py `_use_native_auto`): when the engine's device
        is the CPU (the reference: no TPU attached; on a card `auto` stays
        the fused kernel), there is no trace and no mesh, MISAKA_NATIVE_AUTO
        is not "0", the interpreter builds, and the engine is unbatched or
        its batch is at most MISAKA_NATIVE_AUTO_MAX_BATCH (default 4096; an
        explicit engine="native" takes any batch)."""
        if self._trace_cap or self._mesh is not None:
            return False
        if os.environ.get("MISAKA_NATIVE_AUTO", "1") == "0":
            return False
        # None is the card; a card never flips
        if self._device is None or torch.device(self._device).type != "cpu":
            return False
        from misaka_tpu_torch.core import native_serve

        if not native_serve.available():
            return False
        max_batch = int(os.environ.get("MISAKA_NATIVE_AUTO_MAX_BATCH", "") or "4096")
        return self._batch is None or self._batch <= max_batch

    def _compile(self, topology: Topology):
        """`topology` compiled for this master: a CompiledNetwork, or on a
        mesh its sharded twin."""
        if self._mesh is None:
            device = "cpu" if self._native else self._device
            return topology.compile(batch=self._batch, device=device)
        return ShardedNetwork(
            topology.compile(batch=self._batch, device=self._mesh.devices[0]), self._mesh)

    def _shards(self) -> list[NetworkState]:
        """The live state as a list of shard states, row-major (one off a
        mesh)."""
        return self._state if self._mesh is not None else [self._state]

    def _gather(self) -> NetworkState:
        """The mesh's shards as one whole-batch state on the CPU."""
        return gather_state(self._state, self._mesh)

    def _place(self, state: NetworkState):
        """Owned copies of a whole-batch state where this master keeps it:
        on its device, or cut into the mesh's shards."""
        if self._mesh is not None:
            return shard_state(state, self._mesh)
        return NetworkState(*(t.to(self._net.device, copy=True) for t in state))

    def _make_serve(self, net):
        """What the device loop calls per chunk of `net`: unbatched, the
        one-call serve fn (core/engine.py::make_serve); batched, the
        (serve_fn, idle_fn) pair; traced, None (the piecewise loop).  One
        kernel launch per chunk on a card (batched: the elided variant under
        MISAKA_FUSED_ELIDE_HI=1, its lane mask computed from `net`'s
        programs), the plain version on the CPU or under engine="scan"."""
        if self._trace_cap:
            return None
        if self._native:
            return self._make_native(net)
        if self._batch is None:
            return net.make_serve(self._chunk, "scan" if self._engine == "scan" else "auto")
        if self._mp > 1:
            runner = net.lane_runner(self._chunk,
                                     "gather" if self._engine == "gather" else "routed")
            return net.make_batched_serve(runner, self._chunk)
        if self._engine == "scan":
            chunk = self._chunk
            return net.make_batched_serve(lambda s: net.run(s, chunk), chunk)
        return net.make_batched_serve(net.fused_runner(self._chunk), self._chunk)

    def _make_native(self, net):
        """The native engine of `net`: NativeServe unbatched, else a
        NativeServePool on the tick ladder's highest rung that builds.
        The top rungs (the copy-and-patch JIT, then the per-program
        specialized build) are tried only with a spec dir and a full SIMD
        group (batch >= 8); each failure drops one rung and is counted
        (misaka_native_jit_total, misaka_native_specialize_total)."""
        from misaka_tpu_torch.core import jit as jit_mod
        from misaka_tpu_torch.core import specialize
        from misaka_tpu_torch.core.native_serve import NativeServe, NativeServePool

        if self._batch is None:
            runner = NativeServe(net)
        else:
            spec_so = jit_prog = None
            if self._native_spec_dir is not None and self._batch >= 8:
                if jit_mod.enabled() and jit_mod.supported():
                    jit_prog = jit_mod.prepare(net, cache_dir=self._native_spec_dir)
                if jit_prog is None and specialize.enabled():
                    spec_so = specialize.build(net, cache_dir=self._native_spec_dir)
            runner = NativeServePool(net, chunk_steps=self._chunk, specialized=spec_so,
                                     jit_program=jit_prog)
        # usage attribution and flight-recorder correlation, read through a
        # weakref at call time: the registry names engines after
        # construction, and the runner must not keep a closed master alive
        mref = weakref.ref(self)
        runner.usage_label = lambda: (
            (m.program_label or usage.DEFAULT_LABEL)
            if (m := mref()) is not None else usage.DEFAULT_LABEL)
        if hasattr(runner, "active_trace_ids"):
            runner.active_trace_ids = lambda: (
                m.active_pass_trace_ids() if (m := mref()) is not None else ())
        return runner

    @staticmethod
    def _close_runner(serve) -> None:
        """Release a replaced native engine's C++ handles (its interpreter
        or its pool's OS threads) at once instead of at garbage collection;
        a no-op for the torch serve functions."""
        close = getattr(serve, "close", None)
        if close is None:
            return
        try:
            close()
        except Exception:
            log.warning("closing replaced engine failed", exc_info=True)

    def _sync_native_state(self) -> None:
        """Materialize a native engine's resident state into self._state.

        The native engines keep the state in C++ between chunks and hand
        back an identity anchor whose tensors are stale, so every path that
        reads the state's content (status, checkpoint, snapshot, autogrow,
        the loop's first counters, the idle ring drain) exports first.  The
        export is gated on the anchor: a state a lifecycle path replaced is
        left alone.  Caller holds _state_lock."""
        export = getattr(self._serve, "export_resident", None)
        if export is None:
            return
        st = export(self._state)
        if st is not None:
            self._state = st

    def _trace_ids_enter(self, traces) -> int | None:
        """Register a pass's request-trace IDs (None when untraced); pair
        with _trace_ids_exit in a finally."""
        ids = tuple(tr.trace_id for tr in traces if tr is not None)
        if not ids:
            return None
        with self._pass_traces_lock:
            token = self._pass_trace_next
            self._pass_trace_next += 1
            self._pass_traces[token] = ids
        return token

    def _trace_ids_exit(self, token: int | None) -> None:
        if token is not None:
            with self._pass_traces_lock:
                self._pass_traces.pop(token, None)

    def active_pass_trace_ids(self) -> tuple:
        """The union of the trace IDs of the passes in flight (read by the
        native pool once per call, core/native_serve.py)."""
        with self._pass_traces_lock:
            out: list = []
            for ids in self._pass_traces.values():
                out.extend(t for t in ids if t not in out)
            return tuple(out)

    @property
    def engine_name(self) -> str:
        """What runs the chunks: "fused" (the kernel), "plain" (its plain
        torch version), "plain-traced" (the plain version recording),
        "native" (the host C++ tier), or on a lane-sharded mesh "routed" or
        "gather", as the JAX master names them."""
        if self._native:
            return "native"
        if self._mp > 1:
            return "gather" if self._engine == "gather" else "routed"
        if self._trace_cap:
            return "plain-traced"
        if self._engine == "scan" or self._net.device.type != "cuda":
            return "plain"
        return "fused"

    @property
    def device(self) -> torch.device:
        """The device the chunks run on (a mesh's first)."""
        return self._net.device

    # --- lifecycle (the broadcastCommand surface, master.go:269-351) -------

    def run(self) -> None:
        with self._lifecycle_lock:
            if self._running:
                log.info("network is already running")
                return
            self._running = True
            self._loop = threading.Thread(target=self._device_loop, daemon=True)
            self._loop.start()
            log.info("network was run")

    def pause(self) -> None:
        with self._lifecycle_lock:
            if not self._running:
                log.info("network is already paused")
                return
            self._running = False
            self._work_event.set()  # wake a parked loop so join is immediate
            if self._loop:
                self._loop.join()
            self._rate = None
            log.info("network was paused")

    def close(self) -> None:
        """Stop serving, fail every waiting request and end the scheduler's
        workers.  Nothing this master started (the loop, the scheduler's
        workers, metric callbacks) holds it afterwards, so the engine's
        device state is freed once its owner drops it (the program
        registry's eviction and retire path).  A native engine's state is
        exported first and its C++ handles released."""
        with self._lifecycle_lock:
            self.pause()
            if self._batcher is not None:
                self._batcher.begin_close()
            self._drain_queues()
            with self._state_lock:
                self._sync_native_state()
                self._close_runner(self._serve)
        if self._batcher is not None and not self._batcher.join(10.0):
            log.warning("serve-scheduler workers still running 10 s after close")

    def warm(self) -> None:
        """Pay the first chunk's one-time costs on throwaway state, before
        run(), so the first request does not (the program registry warms
        every engine it builds: untraced, on one device).  One serve
        iteration, fed nothing, on a fresh state of this network that is
        then dropped: on a card that is one launch of the kernel (counted
        in fused.launch_counts, and once in misaka_engine_warm_total),
        whose first call in the process loads the kernel's module and
        sizes the allocator's pools; the library load and the line records
        (`fused.decode_lines`) were paid when the runner was built.
        Best-effort: a failure is logged and counted, and serving goes
        on."""
        if self._native:
            return  # the host tier pays its one-time costs (the build) at construction
        t0 = time.perf_counter()
        try:
            with self._state_lock:
                net, serve = self._net, self._serve
            if self._batch is None:
                _, packed = serve(net.init_state(), _NO_VALUES, 0)
            else:
                serve_fn, _ = serve
                _, packed = serve_fn(net.init_state(),
                                     np.zeros((self._batch, net.in_cap), np.int32),
                                     np.zeros((self._batch,), np.int32))
            packed.reshape(-1)[:1].cpu()  # one element read: waits for the device
            M_WARM_TOTAL.inc()
            M_WARM_SECONDS.observe(time.perf_counter() - t0)
        except Exception as e:  # warm-up is best-effort
            M_WARM_FAILED.inc()
            log.warning("engine warm-up failed (continuing): %s", e)

    def reset(self) -> None:
        """Stop + zero all state and queues (stopNode/resetNode, master.go:252-266)."""
        with self._lifecycle_lock:
            self.pause()
            with self._state_lock:
                self._state = self._net.init_state()
                if self._trace_cap:
                    self._trace = self._net.init_trace(self._trace_cap)
            self._drain_queues()
            log.info("network was reset")

    def load(self, target: str, program: str) -> None:
        """Reprogram one node; resets the whole network (master.go:145-195).

        Compile-first, as the JAX master: the new program is validated,
        lowered and its runner built before anything stops, so a bad
        program leaves the running network untouched.
        """
        with self._lifecycle_lock:
            new_topology = self._topology.with_program(target, program)  # validates target
            new_net = self._compile(new_topology)
            new_serve = self._make_serve(new_net)
            self.pause()
            with self._state_lock:
                self._topology = new_topology
                self._net = new_net
                self._state = new_net.init_state()
                if self._trace_cap:
                    self._trace = new_net.init_trace(self._trace_cap)
                old_serve, self._serve = self._serve, new_serve
            self._close_runner(old_serve)
            self._drain_queues()
            M_ENGINE_SWAPS.labels(reason="load").inc()
            log.info("successfully loaded program")

    # --- the compute lanes --------------------------------------------------

    def compute(self, value: int, timeout: float = 30.0) -> int:
        """One value in, one value out — correlated (fixes quirk #2)."""
        return self.compute_many([value], timeout=timeout)[0]

    def compute_many(self, values, timeout: float = 30.0, return_array: bool = False):
        """A FIFO stream of values through ONE instance: len(values) in,
        len(values) out, pairing strictly ordered.

        Prefers a FREE instance (try-acquire scan from a rotating start);
        only when every instance is busy does the caller block on one.  On
        timeout the request's missing outputs are recorded as stale and
        discarded when they surface, so later calls on that instance stay
        paired -- unless a reset/load wiped the request (epoch bump).
        """
        arr = np.asarray(values, dtype=np.int32)
        if arr.ndim != 1:
            raise ValueError(f"values must be a flat sequence, got shape {arr.shape}")
        if arr.size == 0:
            return np.empty((0,), np.int32) if return_array else []
        n = self._n_slots
        tr = tracespan.current()
        t_q = time.monotonic()  # queue clock: the slot-lock wait
        with self._rr_lock:
            start = self._rr
            self._rr = (self._rr + 1) % n
        slot = None
        for i in range(n):
            cand = (start + i) % n
            if self._compute_locks[cand].acquire(blocking=False):
                slot = cand
                break
        if slot is None:  # all instances busy: wait on the rotating one
            slot = start
            self._compute_locks[slot].acquire()
        with self._waiters_lock:
            self._waiters += 1
            self._requests_total += 1
        M_COMPUTE_REQS.inc()
        M_COMPUTE_VALUES.inc(arr.size)
        usage.add_request(self.program_label, arr.size)
        usage.add_queue(self.program_label, time.monotonic() - t_q)
        try:
            if tr is not None:  # the direct lane's queue phase
                tracespan.add_span(tr, "serve.queue", t_q, time.monotonic() - t_q)
            pass_attrs = {"values": int(arr.size)}
            if self.program_label is not None:
                pass_attrs["program"] = self.program_label
            t_pass = time.monotonic()
            token = self._trace_ids_enter((tr,))
            try:
                with tracespan.span("serve.pass", trace=tr, **pass_attrs):
                    with self._epoch_lock:
                        epoch = self._epoch
                        self._out_qs.make((slot,))
                        self._submit_q.put([(slot, arr)])
                    self._work_event.set()
                    deadline = time.monotonic() + timeout
                    parts = self._collect_slot(slot, arr.size, deadline, epoch, timeout)
            finally:
                self._trace_ids_exit(token)
            # the direct lane's submit-and-collect window is its pass;
            # billed on success only, as the scheduler's
            dur = time.monotonic() - t_pass
            usage.note_pass(dur)
            usage.add_cpu(self.program_label, dur)
            out = np.concatenate(parts)
            return out if return_array else out.tolist()
        finally:
            with self._waiters_lock:
                self._waiters -= 1
            self._compute_locks[slot].release()

    def compute_coalesced(self, values, timeout: float = 30.0, return_array: bool = False,
                          traces=None):
        """A value stream through the serve scheduler: len(values) in,
        len(values) out, order kept, and concurrent callers fuse into
        shared passes.  Falls back to compute_spread when the scheduler is
        off (MISAKA_SERVE_BATCH=0).  `traces`: the request traces that get
        the serve.queue and serve.pass spans (default: the handler
        thread's current trace; the compute plane passes a frame's)."""
        arr = np.asarray(values, dtype=np.int32)
        if arr.ndim != 1:
            raise ValueError(f"values must be a flat sequence, got shape {arr.shape}")
        if arr.size == 0:
            return np.empty((0,), np.int32) if return_array else []
        if self._batcher is None:
            return self.compute_spread(arr, timeout=timeout, return_array=return_array)
        if traces is None:
            # the handler's trace, handed across to the scheduler's workers
            tr = tracespan.current()
            traces = (tr,) if tr is not None else ()
        out = self._batcher.compute(arr, timeout, traces=traces)
        return out if return_array else out.tolist()

    def compute_spread(self, values, timeout: float = 30.0, return_array: bool = False):
        """A value stream STRIPED over free instances: len(values) in,
        len(values) out, order kept.  Contiguous stripes (one input ring's
        worth each) go to the free slots acquired from slot 0 up and run in
        parallel; per-instance FIFO makes the reassembly exact.  With no
        free slot, or a stream that fits one stripe, it is compute_many."""
        arr = np.asarray(values, dtype=np.int32)
        if arr.ndim != 1:
            raise ValueError(f"values must be a flat sequence, got shape {arr.shape}")
        if arr.size == 0:
            return np.empty((0,), np.int32) if return_array else []
        n = self._n_slots
        stripe = self._net.in_cap
        owned: list[int] = []
        if n > 1 and arr.size > stripe:
            want_slots = min(n, -(-arr.size // stripe))
            for s in range(n):
                if self._compute_locks[s].acquire(blocking=False):
                    owned.append(s)
                    if len(owned) >= want_slots:
                        break
        if not owned:
            return self.compute_many(arr, timeout=timeout, return_array=return_array)
        with self._waiters_lock:
            self._waiters += 1
            self._requests_total += 1
        M_COMPUTE_REQS.inc()
        M_COMPUTE_VALUES.inc(arr.size)
        usage.add_request(self.program_label, arr.size)
        t_pass = time.monotonic()
        token = self._trace_ids_enter((tracespan.current(),))
        try:
            pass_attrs = {"values": int(arr.size), "slots": len(owned)}
            if self.program_label is not None:
                pass_attrs["program"] = self.program_label
            with tracespan.span("serve.pass", **pass_attrs):
                stripes = np.array_split(arr, len(owned))
                with self._epoch_lock:
                    epoch = self._epoch
                    self._out_qs.make(owned)
                    self._submit_q.put(list(zip(owned, stripes)))
                self._work_event.set()
                deadline = time.monotonic() + timeout
                parts: list[np.ndarray] = []
                for i, (s, part) in enumerate(zip(owned, stripes)):
                    try:
                        parts.extend(self._collect_slot(s, part.size, deadline, epoch,
                                                        timeout))
                    except ComputeTimeout:
                        # slot s is marked; the stripes never collected will
                        # surface outputs too: mark them stale as well
                        with self._epoch_lock:
                            if self._epoch == epoch:
                                for s2, part2 in list(zip(owned, stripes))[i + 1:]:
                                    self._stale[s2] += part2.size
                        raise
            dur = time.monotonic() - t_pass  # billed on success only
            usage.note_pass(dur)
            usage.add_cpu(self.program_label, dur)
            out = np.concatenate(parts)
            return out if return_array else out.tolist()
        finally:
            self._trace_ids_exit(token)
            with self._waiters_lock:
                self._waiters -= 1
            for s in owned:
                self._compute_locks[s].release()

    def _collect_slot(
        self, slot: int, want: int, deadline: float, epoch: int, timeout: float
    ) -> list[np.ndarray]:
        """Collect `want` outputs from `slot` as array parts (caller holds
        its lock).  On timeout, marks the slot's missing outputs stale
        (unless a reset/load wiped the request) and raises ComputeTimeout."""
        parts: list[np.ndarray] = []
        got = 0
        try:
            while got < want:
                if self._out_leftover[slot].size:
                    chunk = self._out_leftover[slot]
                    self._out_leftover[slot] = chunk[:0]
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise queue.Empty
                    chunk = self._out_qs[slot].get(timeout=remaining)
                    if chunk is _WIPED:
                        # a reset/load drained the queues: nothing further is
                        # coming for a pre-wipe request -- fail now.  A
                        # sentinel from an epoch this request postdates is
                        # stale noise; discard it.
                        with self._epoch_lock:
                            if self._epoch != epoch:
                                raise queue.Empty
                        continue
                with self._epoch_lock:
                    if self._epoch != epoch:
                        raise queue.Empty
                    # outputs of earlier timed-out requests surface first
                    if self._stale[slot]:
                        k = min(self._stale[slot], len(chunk))
                        self._stale[slot] -= k
                        chunk = chunk[k:]
                    need = want - got
                    take, extra = chunk[:need], chunk[need:]
                    if take.size:
                        parts.append(take)
                        got += take.size
                    if extra.size:
                        # more outputs than asked (a non-1:1 network): hold
                        # them, FIFO, for the slot's next caller
                        self._out_leftover[slot] = extra
        except queue.Empty:
            with self._epoch_lock:  # atomic vs _drain_queues' epoch bump
                if self._epoch == epoch:
                    self._stale[slot] += want - got
            M_COMPUTE_TIMEOUTS.inc()
            raise ComputeTimeout(
                f"no output for {want - got}/{want} value(s) after {timeout}s"
            )
        return parts

    @property
    def is_running(self) -> bool:
        return self._running

    def status(self) -> dict:
        """Live metrics: totals across instances (tick is lockstep-identical,
        instance 0's is reported), the engine, its kernel launches per
        variant, the serve scheduler's passes, `batch` when batched and on
        a mesh its shape.  Each sum is taken per shard on its device and
        added on the host."""

        def per_lane(t):  # [N] (or [S]) of one instance or summed over B
            return t if self._batch is None else t.sum(dim=0)

        with self._state_lock:
            self._sync_native_state()
            shards = self._shards()
            mp = self._mp
            heads = shards[::mp]  # each row's first shard: its replicas are equal
            topo = self._topology
            tick = int(shards[0].tick.reshape(-1)[0])
            retired = sum(torch.cat([per_lane(s.retired).cpu() for s in shards[i:i + mp]])
                          for i in range(0, len(shards), mp)).tolist()
            stack_top = sum(per_lane(s.stack_top).cpu() for s in heads).tolist()
            in_depth = sum(int((s.in_wr - s.in_rd).sum()) for s in heads)
            out_depth = sum(int((s.out_wr - s.out_rd).sum()) for s in heads)
            stack_cap = self._net.stack_cap
        with self._submit_q.mutex:
            submitted = list(self._submit_q.queue)
        host_in = sum(len(c) for pairs in submitted for _, c in pairs) + sum(
            sum(len(c) for c in pend) for pend in self._in_pending
        )
        if self._batcher is not None:
            host_in += self._batcher.waiting_values()
        host_out = 0
        for q in list(self._out_qs.values()):
            with q.mutex:
                host_out += sum(len(c) for c in q.queue)
        with self._waiters_lock:
            requests_total = self._requests_total
        status = {
            "running": self._running,
            "engine": self.engine_name,
            "served_engine": self.engine_name,
            "device": str(self._net.device),
            "kernel_launches": dict(fused.launch_counts),
            "serve_passes": self._batcher.passes if self._batcher is not None else 0,
            "uptime_seconds": round(time.monotonic() - self._created_mono, 3),
            "requests_total": requests_total,
            "tick": tick,
            "ticks_per_sec": self._rate,
            "retired_per_lane": {name: int(retired[i]) for name, i in topo.lane_ids().items()},
            "stack_depth": {name: int(stack_top[i]) for name, i in topo.stack_ids().items()},
            "stack_cap": stack_cap,
            "in_queue": host_in + in_depth,
            "out_queue": host_out + out_depth,
            "nodes": dict(topo.node_info),
        }
        if self._batch is not None:
            status["batch"] = self._batch
        if self._mesh is not None:
            status["mesh"] = dict(self._mesh.shape)
        device = self._net.device
        if isinstance(device, torch.device) and device.type == "cuda":
            # this process's caching allocator on its card (the CUDA
            # context not counted): what a fleet roll's replacement must
            # hold again
            status["device_memory"] = {"allocated_bytes": torch.cuda.memory_allocated(device),
                                       "reserved_bytes": torch.cuda.memory_reserved(device)}
        serve = self._serve
        if self._native and hasattr(serve, "simd_info"):
            # the native tick ladder's live rung (group width, AVX2,
            # specialized, jit) and the process-wide specialization-cache
            # outcomes: "is this box running the fast paths" without a
            # /metrics parse
            try:
                from misaka_tpu_torch.core.specialize import M_SPECIALIZE

                status["native"] = {
                    **serve.simd_info(),
                    "specialize_cache": {
                        s: int(M_SPECIALIZE.labels(status=s).value)
                        for s in ("hit", "built", "error", "fallback", "disabled")},
                }
            except Exception:  # status must never 500 on telemetry
                pass
        return status

    def trace(self, last: int | None = None) -> list[dict]:
        """Decoded instruction history, oldest first (requires trace_cap):
        core/trace.py::decode_trace of the ring as it stands."""
        if self._trace is None:
            raise RuntimeError("tracing disabled (construct MasterNode with trace_cap)")
        with self._state_lock:
            ring = TraceRing(buf=self._trace.buf.cpu(), wr=self._trace.wr.cpu())
            net = self._net
            topo = self._topology
        return decode_trace(ring, net.code, net.prog_len, lane_names=list(topo.lane_ids()),
                            stack_names=list(topo.stack_ids()), last=last)

    # --- checkpoints, snapshot, restore -------------------------------------

    def save_checkpoint(self, path: str, include_history: bool = True) -> None:
        """Whole-network state + topology to one .npz in the JAX package's
        format, durably (runtime/checkpoint.py).  The fields are read to the
        host under the state lock (on a mesh: the global arrays, in shard
        order).  The TSDB's retained history (utils/tsdb.py) rides as
        `__tsdb__`, so a relaunch from this file answers /debug/series
        with the history before it; `include_history=False` (the
        registry's eviction checkpoints) leaves it out: history is
        process-wide, and the strictly-newer merge would discard each
        evicted program's copy anyway."""
        t0 = time.perf_counter()
        with self._state_lock:
            self._sync_native_state()
            state = self._state if self._mesh is None else self._gather()
            arrays = state_to_numpy(state)
            topo = self._topology
        arrays[ckpt.TOPOLOGY_KEY] = ckpt.topology_blob({
            "nodes": topo.node_info,
            "programs": topo.programs,
            "stack_cap": topo.stack_cap,
            "in_cap": topo.in_cap,
            "out_cap": topo.out_cap,
            "batch": self._batch,
        })
        if include_history:
            blob = tsdb_mod.snapshot_bytes()
            if blob:
                arrays[ckpt.TSDB_KEY] = np.frombuffer(blob, dtype=np.uint8)
        ckpt.write_checkpoint(path, arrays, self._batch, fault_points=True)
        self._last_ckpt_mono = time.monotonic()
        M_CKPT_SAVE_SECONDS.observe(time.perf_counter() - t0)

    def load_checkpoint(self, path: str) -> None:
        """Restore state + programs from a .npz written by either package.

        The durability gate runs first (CheckpointError for a torn or
        corrupt file), then the batch check, then the compile: nothing is
        swapped until all three pass.  Capacities travel in the checkpoint,
        and the arrays are global: any mesh of the same batch loads them.
        A `__tsdb__` history blob merges into the TSDB (strictly newer
        slots win), best effort: an unreadable blob never fails the
        restore.  Leaves the network paused, as the JAX master does."""
        t0 = time.perf_counter()
        try:
            meta, arrays = ckpt.read_checkpoint(path, (*NetworkState._fields, ckpt.TSDB_KEY))
        except ckpt.CheckpointError:
            M_CKPT_REJECTED.inc()
            raise
        blob = arrays.pop(ckpt.TSDB_KEY, None)
        if blob is not None:
            try:
                tsdb_mod.restore_bytes(blob.tobytes())
            except Exception:
                log.warning("checkpoint %s: tsdb history blob ignored (unreadable)", path)
        ckpt_batch = meta.get("batch")
        if ckpt_batch != self._batch:
            raise ValueError(
                f"checkpoint batch={ckpt_batch} does not match this master's "
                f"batch={self._batch} (request queues are per-instance)"
            )
        new_topology = Topology(
            node_info=meta["nodes"],
            programs=meta["programs"],
            stack_cap=int(meta.get("stack_cap", self._topology.stack_cap)),
            in_cap=int(meta.get("in_cap", self._topology.in_cap)),
            out_cap=int(meta.get("out_cap", self._topology.out_cap)),
        )
        with self._lifecycle_lock:
            self.pause()
            new_net = self._compile(new_topology)
            new_serve = self._make_serve(new_net)
            state = state_from_numpy(arrays)
            _check_shapes(state, _shapes_of(new_net, self._batch), "checkpoint")
            state = self._place(state)
            try:
                self._validate_native(new_serve, state)
            except ValueError:
                self._close_runner(new_serve)
                raise
            with self._state_lock:
                self._topology = new_topology
                self._net = new_net
                self._state = state
                if self._trace_cap:
                    self._trace = new_net.init_trace(self._trace_cap)
                old_serve, self._serve = self._serve, new_serve
            self._close_runner(old_serve)
            self._drain_queues()
            self._flush_iters = self._flush_quiet = 0
            self._restore_flush = True
        M_ENGINE_SWAPS.labels(reason="restore").inc()
        M_CKPT_RESTORE_SECONDS.observe(time.perf_counter() - t0)
        log.info("checkpoint restored from %s", path)

    def snapshot(self) -> NetworkState:
        """Whole-network state, deep-copied (programs are not included); on
        a mesh the shards gathered, on the CPU."""
        with self._state_lock:
            self._sync_native_state()
            if self._mesh is not None:
                return self._gather()
            return clone_state(self._state)

    def restore(self, state: NetworkState) -> None:
        """Reinstall a snapshot() state.  Programs do not roll back (use
        checkpoints for that).  A snapshot taken before a stack autogrow is
        zero-padded to the grown capacity; any other shape mismatch is
        refused.  The state is the whole batch's, on any device; on a mesh
        it is cut into owned shards.  A running master is paused for the
        swap and resumed."""
        with self._lifecycle_lock:
            resume = self._running
            if resume:
                self.pause()
            self._restore_locked(state)
            if resume:
                self.run()

    def _restore_locked(self, state: NetworkState) -> None:
        with self._state_lock:
            want_cap = self._net.stack_cap
            have_cap = state.stack_mem.shape[-1]
            if have_cap < want_cap:
                state = state._replace(stack_mem=torch.nn.functional.pad(
                    state.stack_mem, (0, want_cap - have_cap)))
            _check_shapes(state, _shapes_of(self._net, self._batch), "snapshot")
            state = self._place(state)
            self._validate_native(self._serve, state)
            self._state = state
        # a request submitted against the pre-restore state must fail, and
        # the snapshot's in-flight values are flushed before new work
        self._drain_queues()
        self._flush_iters = self._flush_quiet = 0
        self._restore_flush = True

    @staticmethod
    def _validate_native(serve, state: NetworkState) -> None:
        """A native engine rejects a state it cannot execute (pc beyond the
        program, stack_top beyond capacity, broken ring counters) at import:
        raise that here as ValueError, before the swap, instead of stopping
        the device loop later (the torch engines serve such a state)."""
        validate = getattr(serve, "validate_state", None)
        if validate is not None:
            validate(state)

    # --- the device loop ----------------------------------------------------

    def _drain_queues(self) -> None:
        # Called with the device loop stopped (after pause()), so the
        # loop-private spillover is safe to wipe here too.
        with self._epoch_lock:
            out_qs = list(self._out_qs.values())
            for q in (self._submit_q, *out_qs):
                while True:
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break
            for pend in self._in_pending:
                pend.clear()
            self._active.clear()
            for i in range(len(self._out_leftover)):
                self._out_leftover[i] = self._out_leftover[i][:0]
            self._stale = [0] * len(self._stale)
            self._inflight[:] = 0
            self._retired_prev = None  # the next native pass runs full-batch
            self._grow_blocked = False
            self._epoch += 1
            for q in out_qs:
                q.put(_WIPED)

    def _maybe_grow_stacks(self) -> None:
        """Double stack capacity when a full stack has wedged the network.

        Called from the device loop thread only.  The new network is
        compiled and its runner built outside _state_lock (/status and
        request ingestion stay responsive), then the references are swapped
        and stack_mem zero-padded under it: slot indices and occupancy do
        not change.  The kernel takes stack_cap as a run-time argument, so
        growth rebuilds nothing on the card.  Bounded by
        stack_grow_max_bytes over the whole batch (every shard of a mesh):
        past it the wedge is logged once and left parked."""
        with self._state_lock:
            self._sync_native_state()
            net = self._net
            if not any(bool((s.stack_top >= net.stack_cap).any()) for s in self._shards()):
                return  # stalled for another reason (e.g. starvation)
        new_cap = net.stack_cap * 2
        new_bytes = (self._batch or 1) * net.num_stacks * new_cap * 4
        if new_bytes > self._grow_max_bytes:
            log.warning(
                "stack at capacity %d but growing to %d would use %d bytes "
                "(> stack_grow_max_bytes=%d); leaving it parked",
                net.stack_cap, new_cap, new_bytes, self._grow_max_bytes,
            )
            M_AUTOGROW_BLOCKED.inc()
            self._grow_blocked = True
            return
        t0 = time.monotonic()
        new_topology = dataclasses.replace(self._topology, stack_cap=new_cap)
        new_net = self._compile(new_topology)
        new_serve = self._make_serve(new_net)
        with self._state_lock:
            if self._net is not net:  # a lifecycle swap got here first
                self._close_runner(new_serve)
                return
            self._sync_native_state()
            pad = new_cap - net.stack_cap
            grown = [s._replace(stack_mem=torch.nn.functional.pad(s.stack_mem, (0, pad)))
                     for s in self._shards()]
            self._state = grown if self._mesh is not None else grown[0]
            self._topology = new_topology
            self._net = new_net
            old_serve, self._serve = self._serve, new_serve
        self._close_runner(old_serve)
        M_AUTOGROW.inc()
        M_ENGINE_SWAPS.labels(reason="autogrow").inc()
        log.info("grew stack capacity %d -> %d in %.3fs",
                 net.stack_cap, new_cap, time.monotonic() - t0)

    def _mark_ticks(self) -> None:
        """Advance the tick-rate gauge by one chunk (device loop thread)."""
        self._ticks_done += self._chunk
        M_TICKS.inc(self._chunk)
        now = time.monotonic()
        if now - self._rate_mark_time > 2:
            self._rate = (self._ticks_done - self._rate_mark_tick) / (
                now - self._rate_mark_time
            )
            self._rate_mark_tick = self._ticks_done
            self._rate_mark_time = now

    def _device_loop(self) -> None:
        try:
            self._device_loop_inner()
        except Exception:
            # a crashed loop must not strand callers in a silent timeout
            log.exception("device loop crashed; network stopped")
            self._running = False
        finally:
            self.profiling.loop_exit()  # a capture this loop records ends here

    def _ingest_submissions(self) -> None:
        """Move submitted request chunks into per-slot spillover (loop thread)."""
        while True:
            try:
                pairs = self._submit_q.get_nowait()
            except queue.Empty:
                return
            for slot, arr in pairs:
                self._in_pending[slot].append(arr)
                self._active.add(slot)

    def _cut_pending(self, slot: int, budget: int) -> np.ndarray | None:
        """Cut up to `budget` values off the front of `slot`'s spillover —
        O(chunks) host work, never O(values) (loop thread only)."""
        pend = self._in_pending[slot]
        if not pend or budget <= 0:
            return None
        take, taken = [], 0
        while pend and taken < budget:
            c = pend[0]
            if len(c) <= budget - taken:
                take.append(pend.pop(0))
                taken += len(c)
            else:
                take.append(c[: budget - taken])
                pend[0] = c[budget - taken:]
                taken = budget
        if not pend:
            self._active.discard(slot)
        return np.concatenate(take) if take else None

    def _build_feed(self, ctrs):
        """Cut pending submissions into a [B, in_cap] feed matrix + counts
        (loop thread only).  Buffers are reused across iterations: the
        engine reads only the counts[b] leading entries of each row."""
        shape = (self._batch, self._net.in_cap)
        if self._feed_vals is None or self._feed_vals.shape != shape:
            self._feed_vals = np.zeros(shape, np.int32)
            self._feed_counts = np.zeros((self._batch,), np.int32)
        vals, counts = self._feed_vals, self._feed_counts
        counts[:] = 0
        free = self._net.in_cap - (ctrs[1] - ctrs[0])
        for b in list(self._active):
            got = self._cut_pending(b, int(free[b]))
            if got is not None:
                vals[b, : len(got)] = got
                counts[b] = len(got)
        # fed minus drained, for the native partial-fill active set: a slot
        # owes outputs until the loop's drain takes them back out
        self._inflight += counts
        return vals, counts

    def _native_active(self, ctrs, counts=None):
        """The native partial-fill active set of this iteration (loop
        thread only): the replicas that are fed now, hold input-ring
        content, owe outputs, or retired instructions last chunk (work in
        flight inside the network).  None runs the whole batch: the first
        pass after boot or a lifecycle swap (no progress baseline yet), or
        a set that covers every replica anyway."""
        if self._retired_prev is None:
            return None
        mask = (self._inflight > 0) | (ctrs[1] > ctrs[0]) | self._native_hot
        if counts is not None:
            mask |= counts > 0
        active = np.flatnonzero(mask)
        return None if active.size >= self._n_slots else active

    def _native_note_progress(self, state, active) -> None:
        """Refresh the hot set after a native chunk: a replica that retired
        nothing across a whole chunk waits for input and may be skipped
        until it is fed.  A resident pool reports measured per-replica
        progress flags (its state tensors are stale); the stateless path
        derives them from the exported `retired` counters."""
        prog = self._serve.consume_progress()
        if prog is not None:
            if active is None:
                self._native_hot = prog.astype(bool)
            else:
                self._native_hot[:] = False
                self._native_hot[active] = prog[active].astype(bool)
            self._retired_prev = True  # flags: the baseline is implicit
            return
        ret = state.retired.numpy().sum(axis=1)
        prev = self._retired_prev if isinstance(self._retired_prev, np.ndarray) else None
        if prev is None or active is None:
            # no baseline: every replica stays hot one pass so deltas form
            self._native_hot = ret > prev if prev is not None else np.ones(
                (self._n_slots,), bool)
        else:
            self._native_hot[:] = False
            self._native_hot[active] = ret[active] > prev[active]
        self._retired_prev = ret

    def _serve_unbatched(self, state, ctrs):
        """One unbatched iteration: feed, chunk and pack in one call, ONE
        host read (the reference's one-dispatch branch, master.py:2663-2691).
        Returns (state, counters [4], [(0, outputs)] or [], fed)."""
        got = self._cut_pending(0, self._net.in_cap - int(ctrs[1] - ctrs[0]))
        vals = _NO_VALUES if got is None else got
        if got is not None:
            M_SLOT_OCCUPANCY.observe(1)
        if self._native:  # the host tier: the packed row is host memory
            state, p = self._serve.serve_chunk(state, vals, vals.size, self._chunk)
            self._mark_ticks()
        else:
            state, packed = self._serve(state, vals, vals.size)
            self._mark_ticks()
            with profiling.mark("misaka.read"):
                p = packed.cpu().numpy()  # the single host read
        rd, wr = int(p[2]), int(p[3])
        per_slot = []
        if wr > rd:
            per_slot = [(0, p[4:][(rd + np.arange(wr - rd)) % self._net.out_cap])]
        return state, p[:4], per_slot, got is not None

    def _serve_batched(self, state, ctrs):
        """One batched iteration: the (serve_fn, idle_fn) pair, one host
        read of the packed snapshot (or of the counters when idle).
        Returns (state, counters [4, B], [(slot, outputs)], fed)."""
        serve_fn, idle_fn = self._serve
        fed = False
        if self._active:
            with profiling.mark("misaka.feed_cut"):
                vals, counts = self._build_feed(ctrs)
            fed = bool(counts.any())
        if fed:
            M_SLOT_OCCUPANCY.observe(int((counts > 0).sum()))
            # feed + chunk + per-instance counter/ring snapshot
            state, packed = serve_fn(state, vals, counts)
            self._mark_ticks()
            with profiling.mark("misaka.read"):
                ctrs, per_slot = self._net.read_packed(packed)
            return state, ctrs, per_slot, True
        # counters only; the ring is read only if outputs appeared
        state, c = idle_fn(state)
        self._mark_ticks()
        with profiling.mark("misaka.read"):
            p = c.cpu().numpy()
        per_slot = []
        if (p[:, 3] > p[:, 2]).any():
            state, per_slot = self._net.drain_batched(state, rd=p[:, 2], wr=p[:, 3])
        return state, p.T, per_slot, False

    def _serve_native(self, state, ctrs):
        """One batched iteration on a native pool: the serve/idle twins of
        _serve_batched over the partial-fill active set, and a fully
        quiescent batch (nothing fed, held, owed or moving) skips the
        engine call.  The packed rows are the pool's reused host buffers:
        what outlives the iteration is copied out."""
        pool = self._serve
        fed = False
        if self._active:
            vals, counts = self._build_feed(ctrs)
            fed = bool(counts.any())
        if fed:
            M_SLOT_OCCUPANCY.observe(int((counts > 0).sum()))
            active = self._native_active(ctrs, counts)
            state, p = pool.serve(state, vals, counts, active=active)
            self._native_note_progress(state, active)
            self._mark_ticks()
            per_slot = self._net.drain_from_snapshot(p[:, 4:], p[:, 2], p[:, 3],
                                                     self._net.out_cap)
            return state, p[:, :4].T.copy(), per_slot, True
        active = self._native_active(ctrs)
        if active is not None and active.size == 0:
            return state, ctrs, [], False
        state, p = pool.idle(state, active=active)
        self._native_note_progress(state, active)
        self._mark_ticks()
        ctrs = p.T.copy()
        per_slot = []
        if (ctrs[3] > ctrs[2]).any():
            # an unfed chunk emitted values: materialize the resident state
            # before the host-side ring drain reads out_buf
            exported = pool.export_resident(state)
            if exported is not None:
                state = exported
            state, per_slot = self._net.drain_batched(state, rd=ctrs[2], wr=ctrs[3])
        return state, ctrs, per_slot, False

    def _serve_traced(self, state, ctrs):
        """One traced iteration, piecewise (the reference's traced branch,
        master.py:2768-2810): feed, `run_traced` (of `trace_instance` when
        batched), counters, drain."""
        fed = False
        if self._batch is None:
            got = self._cut_pending(0, self._net.in_cap - int(ctrs[1] - ctrs[0]))
            if got is not None:
                M_SLOT_OCCUPANCY.observe(1)
                state, _ = self._net.feed(state, got)
                fed = True
        elif self._active:
            vals, counts = self._build_feed(ctrs)
            if counts.any():
                M_SLOT_OCCUPANCY.observe(int((counts > 0).sum()))
                state = self._net.feed_batched(state, vals, counts)
                fed = True
        state, self._trace = self._net.run_traced(
            state, self._trace, self._chunk,
            **({} if self._batch is None else {"instance": self._trace_instance}))
        self._mark_ticks()
        ctrs = self._net.counters(state)  # post-run, exact
        if self._batch is not None:
            state, per_slot = self._net.drain_batched(state, rd=ctrs[2], wr=ctrs[3])
        elif ctrs[3] > ctrs[2]:
            state, outs = self._net.drain(state)
            per_slot = [(0, np.asarray(outs, np.int32))]
        else:
            per_slot = []
        return state, ctrs, per_slot, fed

    def _device_loop_inner(self) -> None:
        # One counter read per iteration (post-run), reused for the next
        # iteration's feed decisions: between chunks nothing on the device
        # moves, so post-run counters are exact.
        with self._state_lock:
            self._sync_native_state()  # the one read of state content per run()
            ctrs = self._net.counters(self._state)  # [4] or [4, B]
        iteration = (self._serve_traced if self._trace_cap
                     else self._serve_unbatched if self._batch is None
                     else self._serve_native if self._native
                     else self._serve_batched)
        while self._running:
            if self.profiling.pending():  # a capture begins or ends here
                self.profiling.service()
            t_iter = time.perf_counter()
            # After a restore: run without ingesting new work and discard
            # what the network emits until it goes quiet, so a resurrected
            # in-flight value never pairs with a post-restore request.
            flushing = self._restore_flush
            with profiling.mark("misaka.iteration"):
                with self._state_lock:
                    if not flushing:
                        self._ingest_submissions()
                    self._state, ctrs, per_slot, busy = iteration(self._state, ctrs)
                for slot, outs in per_slot:
                    busy = True
                    if not flushing:  # a flush discards orphan outputs
                        self._out_qs[slot].put(outs)
                        # clamped: a non-1:1 network can over- or under-produce
                        self._inflight[slot] = max(0, self._inflight[slot] - len(outs))
            # The whole iteration, its one host read included: launches are
            # asynchronous, so a clock stopped at the launch would time the
            # launch, not the chunk.
            iter_dur = time.perf_counter() - t_iter
            M_CHUNK_SECONDS.observe(iter_dur)
            (M_ITER_SERVE if busy else M_ITER_IDLE).inc()
            if busy:  # engine-tier flight-recorder event; idle chunks skipped
                tracespan.note_tier("engine.chunk", iter_dur)
            if flushing:
                # quiescence: 8 chunks in a row with no output and empty
                # input rings; capped at 64 chunks so a generator network
                # cannot flush forever
                self._flush_iters += 1
                quiet = (not busy and not bool(np.any(ctrs[1] > ctrs[0]))
                         and not self._native_hot.any())
                self._flush_quiet = self._flush_quiet + 1 if quiet else 0
                if self._flush_quiet >= 8 or self._flush_iters >= 64:
                    self._restore_flush = False
                continue
            if busy:
                self._stall_iters = 0
                self._grow_blocked = False
                continue
            # Nothing moved.  A waiting compute means work is mid-flight:
            # keep chunking -- and after a few such chunks check the one
            # wedge the loop can repair, a stack at capacity.  Otherwise
            # park on the enqueue event.
            with self._waiters_lock:
                waiting = self._waiters
            if waiting:
                self._stall_iters += 1
                if self._grow and not self._grow_blocked and self._stall_iters >= 8:
                    self._stall_iters = 0
                    self._maybe_grow_stacks()
                continue
            self._work_event.clear()
            with self._waiters_lock:
                waiting = self._waiters
            if not waiting and self._submit_q.empty():
                self._work_event.wait(0.05)


def _flight_mem_bytes() -> int:
    """The native flight recorder's ring bytes across live pools; 0 while
    no native engine was ever built in this process (the module is not
    imported until then)."""
    import sys

    mod = sys.modules.get("misaka_tpu_torch.core.native_serve")
    return mod.flight_mem_bytes() if mod is not None else 0


def _shapes_of(net, batch: int | None) -> NetworkState:
    """A whole-batch state of `net`'s shapes, allocated nowhere (meta)."""
    return init_state(net.num_lanes, net.num_stacks, net.stack_cap, net.in_cap,
                      net.out_cap, batch=batch, device="meta")


def _check_shapes(state: NetworkState, ref: NetworkState, what: str) -> None:
    """Raise ValueError unless every field of `state` has `ref`'s shape."""
    mismatch = [f for f, a, b in zip(NetworkState._fields, state, ref) if a.shape != b.shape]
    if mismatch:
        raise ValueError(
            f"{what} shapes do not match the compiled network (fields "
            f"{mismatch}); reset/load first"
        )


_NAME_RE = re.compile(r"^[A-Za-z0-9._-]{1,128}$")


class AutoCheckpointer:
    """Periodic durable snapshots with rotation, plus boot-time restore (the
    port of misaka_tpu/runtime/master.py::AutoCheckpointer).

    MISAKA_AUTOCKPT=N seconds arms this on the serving master (app.py):
    every interval the live state is checkpointed into the checkpoint
    directory as `auto-<seq>.npz` under save_checkpoint's durability
    contract (tmp + fsync + atomic replace + manifest), and rotation keeps
    the newest `keep` snapshots (MISAKA_AUTOCKPT_KEEP, default 4).
    `restore_latest` is the boot half: walk the snapshots newest first and
    install the first that passes verify_checkpoint, so one torn snapshot
    costs one interval of history, never a boot.  The files are the JAX
    package's: either package restores the other's snapshots."""

    PREFIX = "auto-"
    _NAME_RE = re.compile(r"^auto-(\d+)\.npz$")

    def __init__(self, master, directory: str, interval_s: float, keep: int = 4):
        if interval_s <= 0:
            raise ValueError(f"interval must be > 0, got {interval_s}")
        self._master = master
        self._dir = directory
        self._interval = float(interval_s)
        self._keep = max(1, int(keep))
        existing = self.snapshots(directory)
        self._seq = (int(self._NAME_RE.match(os.path.basename(existing[0])).group(1))
                     if existing else 0)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="misaka-torch-autockpt")
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    @classmethod
    def snapshots(cls, directory: str) -> list[str]:
        """auto-*.npz paths in `directory`, newest (highest seq) first."""
        try:
            names = os.listdir(directory)
        except OSError:
            return []
        seqs = []
        for n in names:
            m = cls._NAME_RE.match(n)
            if m:
                seqs.append((int(m.group(1)), n))
        return [os.path.join(directory, n) for _, n in sorted(seqs, reverse=True)]

    def save_once(self) -> str:
        """One durable snapshot + rotation (also the thread's body)."""
        self._seq += 1
        os.makedirs(self._dir, exist_ok=True)
        path = os.path.join(self._dir, f"{self.PREFIX}{self._seq:08d}.npz")
        self._master.save_checkpoint(path)
        for old in self.snapshots(self._dir)[self._keep:]:
            for stale in (old, ckpt.manifest_path(old)):
                try:
                    os.unlink(stale)
                except OSError:
                    pass
        return path

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.save_once()
            except Exception:  # one failure is one interval of lost history
                log.exception("auto-checkpoint failed (retrying next interval)")

    @classmethod
    def restore_latest(cls, master, directory: str) -> str | None:
        """Install the newest valid auto snapshot; returns its path, or None
        when none exists or verifies (a fresh boot)."""
        for path in cls.snapshots(directory):
            try:
                master.load_checkpoint(path)
                return path
            except Exception as e:
                log.warning("auto-restore: skipping snapshot %s (%s); falling back",
                            path, e)
        return None


def make_http_server(master: MasterNode, port: int = 8000,
                     checkpoint_dir: str | None = None,
                     profile_dir: str | None = None,
                     tls=None, registry=None) -> ThreadingHTTPServer:
    """The reference's client routes (master.go:90-224) plus /compute_batch,
    /compute_raw, /checkpoint, /restore, /profile/start|stop, /fleet/drain,
    /edge/token, /edge/gossip, /captures/start|stop|rotate|export,
    /debug/faults, GET /status, /metrics, /healthz, /debug/requests,
    /debug/perfetto, /debug/isa_trace (with /trace, its deprecated alias),
    /debug/usage, /usage/export, /debug/alerts, /debug/faults,
    /debug/captures, /debug/series, /debug/dashboard and /debug/flamegraph,
    with the JAX server's bodies and status codes.  Starts the process-wide
    sampler, TSDB and watchdog, and arms the usage and capture spools
    under MISAKA_TSDB_DIR, as the reference's does.  The
    edge chain (runtime/edge.py), built from the env and installed for the
    compute plane too, runs before every route body; MISAKA_EDGE=0
    disarms it.  The app sets the server's
    `misaka_supervisor` (the frontend workers: /status and /healthz carry
    its `frontends` block), `misaka_native_edge` (the native C++ edge:
    /healthz `native_edge`) and `misaka_plane` (the compute plane
    /fleet/drain drains; 404 without one), as the reference's does.
    /checkpoint and /restore answer 403 unless `checkpoint_dir` is set,
    /profile/* unless `profile_dir` is;
    clients name a checkpoint or profile, never a path.  tls=None reads
    MISAKA_TLS_CERT/KEY (runtime/edge.py), False serves plain HTTP, an
    SSLContext wraps the listener with it.

    `registry` (runtime/registry.py::ProgramRegistry, seeded with
    `master`) arms the program routes: POST /programs (upload), GET
    /programs and /programs/<name>, program-addressed compute
    (/programs/<name>/compute|compute_batch|compute_raw, or the
    X-Misaka-Program header on the legacy routes) through a registry
    lease, /status `programs`, and the admission signal summed over the
    registry's engines.  registry=None keeps the single-program server,
    and a request that names a program gets the reference's typed 404."""
    max_body = int(os.environ.get("MISAKA_MAX_BODY", "") or 64 * 1024 * 1024)
    # requests over MISAKA_SLOW_REQ_MS log one warning with their trace ID
    _slow_ms = os.environ.get("MISAKA_SLOW_REQ_MS")
    slow_req_s = float(_slow_ms) / 1e3 if _slow_ms else None
    # the fast request parser; MISAKA_FAST_HTTP=0 keeps the stock one
    fast_http = os.environ.get("MISAKA_FAST_HTTP", "1") != "0"
    profiler = profiling.Profiler(master.profiling)
    boot_mono = time.monotonic()  # /healthz uptime anchor (server, not master)
    # the native decimal codec builds at its first use (about a second of
    # g++): here, so that the build never lands inside the first
    # /compute_batch
    textcodec.native_available()
    buildinfo.install_metric()

    # The always-on planes, process-wide (one thread each however many
    # servers a process builds): the stack sampler (GET /debug/flamegraph),
    # the TSDB's collector (GET /debug/series, /debug/dashboard, the
    # checkpoints' history) and the watchdog on its tick.  MISAKA_SAMPLER=0,
    # MISAKA_TSDB=0 and MISAKA_WATCHDOG=0 disarm them.
    sampler_mod.ensure_started()
    tsdb_mod.ensure_started()
    watchdog_mod.ensure_started()

    # The durable tier (MISAKA_TSDB_DIR, armed for the TSDB above): the
    # usage ledger's spool under <dir>/usage, and the always-on capture
    # spool under <dir>/capture, whose rotations cut fresh anchors with the
    # closure POST /captures/start uses.
    usage.ensure_spool()

    def live_anchors() -> dict:
        """One anchor per live program: the default's, then every active
        registry engine's."""
        label = (registry.default_name if registry is not None else None) or "default"
        anchors = {}
        a = capture_mod.anchor_from_master(label, master)
        if a is not None:
            anchors[label] = a
        if registry is not None:
            for name, m in registry.active_masters():
                if name not in anchors:
                    a = capture_mod.anchor_from_master(name, m)
                    if a is not None:
                        anchors[name] = a
        return anchors

    capture_mod.ensure_spool(anchor_fn=live_anchors)

    # The edge (runtime/edge.py): auth, quota and admission before every
    # route body.  The admission signal is the ServeBatcher's waiting
    # values, read at most every 25 ms (the read takes the scheduler's own
    # lock); the SLO page bit (utils/slo.py: a page halves the soft
    # watermark) at most every 0.25 s (it walks every program's windows).
    waiting_cache = [0.0, 0]  # (last read, waiting values)
    page_cache = [0.0, False]  # (last evaluation, page?)

    def edge_signals() -> tuple[int, bool]:
        now = time.monotonic()
        if now - waiting_cache[0] > 0.025:
            waiting_cache[0] = now
            if registry is not None:  # every engine; the seeded one is `master`
                waiting_cache[1] = registry.waiting_values()
            else:
                b = master._batcher
                waiting_cache[1] = b.waiting_values() if b is not None else 0
        if now - page_cache[0] > 0.25:
            page_cache[0] = now
            page_cache[1] = slo.overall_state() == "page"
        return waiting_cache[1], page_cache[1]

    # the default watermark clears two maximum-size legal bodies (int32
    # values x 4): what the body cap admits is never shed right after
    edge_chain = edge_mod.install(edge_mod.from_env(
        signals=edge_signals, cpu_reader=lambda label: usage.account(label).cpu_seconds,
        default_admission_high=max(65536, (max_body // 4) * 2)))
    if registry is not None:
        # persisted per-program quota overrides predate this chain (the
        # registry loads its store at construction, before any server)
        registry.install_quotas(edge_chain)

    @contextlib.contextmanager
    def resolved_master(ref, values=0):
        """The engine a compute request serves on: the registry lease (a
        program-addressed request, or the seeded default through the same
        lease), or the bare master on a server without a registry, where
        a named program is the typed 404."""
        if registry is not None:
            with registry.lease(ref, values=values) as m:
                yield m
            return
        if ref:
            raise ProgramNotFound(
                f"program registry disabled (set MISAKA_PROGRAMS_DIR); "
                f"cannot route to program {ref!r}"
            )
        yield master

    def resolve_name(directory: str | None, name: str, suffix: str = "") -> str | None:
        if not directory or not _NAME_RE.match(name) or ".." in name:
            return None
        return os.path.join(directory, name if name.endswith(suffix) else name + suffix)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # through logging, not stderr
            # getattr: a malformed request line reaches send_error(400)
            # before self.path is assigned
            log.debug(fmt, *args, extra={"route": _route_label(getattr(self, "path", ""))})

        def send_response(self, code, message=None):
            self._metrics_code = code  # read by _observed
            super().send_response(code, message)

        def handle_one_request(self):
            """The stock request loop with the fast parser swapped in; the
            stock parser stays the fallback for request shapes the fast
            path declines.  MISAKA_FAST_HTTP=0 keeps the stock loop."""
            if not fast_http:
                return super().handle_one_request()
            try:
                self.raw_requestline = self.rfile.readline(65537)
                if len(self.raw_requestline) > 65536:
                    self.requestline = ""
                    self.request_version = ""
                    self.command = ""
                    self.send_error(414, "Request-URI Too Long")
                    return
                if not self.raw_requestline:
                    self.close_connection = True
                    return
                # the http.parse clock starts after the request line: on a
                # keep-alive connection the readline blocks across idle time
                t_parse = time.monotonic()
                parsed = _fast_parse_request(self)
                if parsed is None:  # answered an error while parsing
                    return
                if not parsed and not self.parse_request():
                    return
                self._parse_mark = (t_parse, time.monotonic() - t_parse)
                mname = "do_" + self.command
                if not hasattr(self, mname):
                    self.send_error(501, f"Unsupported method ({self.command!r})")
                    return
                getattr(self, mname)()
                self.wfile.flush()
            except TimeoutError as e:
                self.log_error("Request timed out: %r", e)
                self.close_connection = True
            except ssl.SSLError as e:
                # the deferred TLS handshake (edge.wrap_server_tls) fails on
                # the handler thread's first read: a plaintext prober costs
                # one closed connection
                self.log_error("TLS handshake failed: %r", e)
                self.close_connection = True

        def _observed(self, method: str, inner) -> None:
            """Request counter, error counter by status, in-flight gauge and
            latency histogram around every handler, and the request trace:
            begun from the inbound X-Misaka-Trace header (minted otherwise),
            current on this thread for the whole request, ended into the
            flight recorder with the response status."""
            route = _route_label(self.path)
            self._metrics_code = None  # keep-alive reuses the handler
            self._extra_headers = []
            self._misaka_program = None  # set by _handle_post's resolution
            trace = tracespan.begin(self.headers.get(tracespan.TRACE_HEADER), route=route)
            self._misaka_trace = trace
            mark = getattr(self, "_parse_mark", None)
            self._parse_mark = None
            if trace is not None and mark is not None:
                tracespan.add_span(trace, "http.parse", mark[0], mark[1])
            M_HTTP_INFLIGHT.inc()
            t0 = time.perf_counter()
            try:
                inner()
            finally:
                dur = time.perf_counter() - t0
                M_HTTP_LATENCY.labels(route=route).observe(dur)
                M_HTTP_REQS.labels(route=route, method=method).inc()
                code = self._metrics_code or 500
                if code >= 400:
                    M_HTTP_ERRORS.labels(route=route, code=str(code)).inc()
                M_HTTP_INFLIGHT.dec()
                if route in _SLO_ROUTES and slo.armed() and (code < 400 or code >= 500):
                    # the whole handler window into the program's SLO
                    # windows: 5xx are service errors, 4xx the client's own
                    slo.observe(self._misaka_program, dur, error=code >= 500)
                if slow_req_s is not None and dur >= slow_req_s:
                    log.warning(
                        "slow request: %s %.1fms (threshold %.0fms)",
                        route, dur * 1e3, slow_req_s * 1e3,
                        extra={"route": route, "program": self._misaka_program,
                               "trace_id": trace.trace_id if trace is not None else None},
                    )
                self._misaka_trace = None
                tracespan.end(trace, status=code)

        def do_GET(self):
            self._observed("GET", self._handle_get)

        def do_POST(self):
            self._observed("POST", self._handle_post)

        def _trace_headers(self) -> None:
            """Between send_response and end_headers on every response:
            headers queued by the route, then the trace ID and the
            Server-Timing phases recorded so far."""
            for k, v in self._extra_headers:
                self.send_header(k, v)
            tr = self._misaka_trace
            if tr is not None:
                self.send_header(tracespan.TRACE_HEADER, tr.trace_id)
                st = tracespan.server_timing(tr)
                if st:
                    self.send_header("Server-Timing", st)

        def _text(self, code: int, body: str) -> None:
            self._send(code, body.encode(), "text/plain; charset=utf-8")

        def _send(self, code: int, data: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self._trace_headers()
            self.end_headers()
            self.wfile.write(data)

        def _json(self, obj, code: int = 200) -> None:
            self._send(code, (json.dumps(obj) + "\n").encode(), "application/json")

        def _capture_note(self, m, vals: bytes, resp: bytes, op: str) -> None:
            """One capture record (surface "http") for a request this route
            served; a valid inbound X-Misaka-Trace bypasses sampling."""
            inbound_id = tracespan.sanitize_id(self.headers.get(tracespan.TRACE_HEADER))
            tr = self._misaka_trace
            capture_mod.note("http", program=self._misaka_program,
                             trace=tr.trace_id if tr is not None else inbound_id,
                             inbound=inbound_id is not None, vals=vals, resp=resp,
                             status=200, tick=int(m._ticks_done), op=op)

        def _edge_check(self, route: str, method: str, program: str | None = None,
                        values: int = 1) -> bool:
            """The edge chain for this request; True = admitted.  A rejection
            answers its typed status and headers (the POST body drained or
            the connection closed) and puts an `edge.reject` span on the
            request trace."""
            if not edge_chain.armed:
                return True
            decision = edge_chain.check(route, method, key=edge_mod.key_from_headers(self.headers),
                                        program=program, values=values)
            rej = decision.reject
            if rej is None:
                return True
            if method == "POST":
                edge_mod.drain_or_close(self)  # keep-alive discipline
            self._extra_headers.extend(rej.headers())
            if self._misaka_trace is not None:
                tracespan.add_span(self._misaka_trace, "edge.reject", time.monotonic(), 0.0,
                                   {"tenant": decision.tenant, "reason": rej.reason})
            self._text(rej.status, rej.message)
            return False

        def _form(self) -> dict[str, str]:
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length).decode()
            return {k: v[0] for k, v in parse_qs(raw, keep_blank_values=True).items()}

        def _handle_get(self):
            try:
                parsed = urlparse(self.path)
                path = parsed.path
                if not self._edge_check(path, "GET", values=0):
                    return
                if path == "/status":
                    payload = master.status()
                    payload["build"] = buildinfo.info()
                    sup = getattr(self.server, "misaka_supervisor", None)
                    if sup is not None:
                        payload["frontends"] = sup.state()
                    if registry is not None:
                        payload["programs"] = registry.summary()
                    self._json(payload)
                elif path == "/programs":
                    if registry is None:
                        self._text(404, "program registry disabled (set MISAKA_PROGRAMS_DIR)")
                        return
                    self._json(registry.list_programs())
                elif path.startswith("/programs/"):
                    if _PROGRAM_COMPUTE_RE.match(path):
                        self._text(405, "method GET not allowed")
                        return
                    if registry is None:
                        self._text(404, "program registry disabled (set MISAKA_PROGRAMS_DIR)")
                        return
                    try:
                        self._json(registry.info(unquote(path[len("/programs/"):])))
                    except ProgramNotFound as e:
                        self._text(404, str(e))
                elif path == "/metrics":
                    slo.refresh_metrics()  # the misaka_slo_* gauges are results
                    self._send(200, metrics.render().encode(), metrics.CONTENT_TYPE)
                elif path == "/healthz":
                    self._json(self._healthz())
                elif path in ("/trace", "/debug/isa_trace"):
                    self._isa_trace(parsed)
                elif path == "/debug/requests":
                    # the flight recorder: recent ring + slowest-K reservoir
                    # (?slowest=1 for the reservoir alone)
                    payload = tracespan.debug_payload()
                    q = {k: v[0] for k, v in parse_qs(parsed.query).items()}
                    if q.get("slowest") == "1":
                        payload.pop("recent", None)
                    self._json(payload)
                elif path.startswith("/debug/requests/"):
                    tid = path[len("/debug/requests/"):]
                    tr = tracespan.RECORDER.get(tid)
                    if tr is None:
                        self._text(404, f"no completed trace {tid!r} in the flight recorder")
                        return
                    self._json(tr.to_dict())
                elif path == "/debug/perfetto":
                    # Chrome trace-event JSON of the recorder (Perfetto,
                    # chrome://tracing), one process per tier (the native
                    # pools' worker spans ride the native tier's source)
                    self._json(tracespan.perfetto())
                elif path == "/debug/native_trace":
                    # the native flight recorder's per-thread rings, decoded
                    # (core/native_serve.flight_payload); ?n= caps records
                    # per ring
                    from misaka_tpu_torch.core import native_serve

                    q = {k: v[0] for k, v in parse_qs(parsed.query).items()}
                    try:
                        max_records = int(q["n"]) if "n" in q else None
                    except ValueError:
                        max_records = None
                    self._json(native_serve.flight_payload(max_records))
                elif path == "/debug/usage":
                    self._json(usage.debug_payload())  # the per-program ledger
                elif path == "/usage/export":
                    self._usage_export(parsed)
                elif path == "/debug/alerts":
                    self._json(self._alerts())
                elif path == "/debug/faults":
                    self._json({"armed": sorted(faults.active())})  # what is armed
                elif path == "/debug/series":
                    self._series(parsed)
                elif path == "/debug/dashboard":
                    self._dashboard(parsed)
                elif path == "/debug/flamegraph":
                    # the continuous profiler (utils/sampler.py): folded
                    # stacks; ?html=1 answers the self-contained viewer
                    q = {k: v[0] for k, v in parse_qs(parsed.query).items()}
                    if q.get("html") == "1":
                        self._send(200, sampler_mod.render_html().encode(),
                                   "text/html; charset=utf-8")
                    else:
                        self._json(sampler_mod.debug_payload())
                elif path == "/debug/captures":
                    # the capture ring's status and newest records (payload
                    # heads only); ?n= caps the listing
                    q = {k: v[0] for k, v in parse_qs(parsed.query).items()}
                    try:
                        limit = int(q.get("n", "100"))
                    except ValueError:
                        limit = 100
                    self._json(capture_mod.debug_payload(limit))
                else:
                    self._text(405, "method GET not allowed")
            except Exception as e:  # a handler crash must not kill the server
                log.exception("handler error")
                self._text(500, f"internal error: {e}")

        def _usage_export(self, parsed) -> None:
            """The signed JSONL export of the ledger (runtime/usage.py);
            ?since= (unix seconds) bounds the periods."""
            q = parse_qs(parsed.query)
            try:
                since = float((q.get("since") or ["0"])[0])
            except ValueError:
                self._text(400, "bad since= (unix seconds)")
                return
            try:
                lines = usage.export_lines(since=since)
            except usage.UsageExportError as e:
                self._text(409, str(e))
                return
            body = "".join(json.dumps(line, separators=(",", ":")) + "\n" for line in lines)
            self._send(200, body.encode(), "application/x-ndjson")

        def _series(self, parsed) -> None:
            """GET /debug/series: the TSDB's retained history (utils/tsdb.py);
            ?name=<series>[&label=k=v...][&window=5m] queries one family, a
            bare GET lists the catalog."""
            try:
                name, labels, window_s = tsdb_mod.parse_query(parse_qs(parsed.query))
            except tsdb_mod.TSDBError as e:
                self._text(400, str(e))
                return
            if name is None:
                self._json(tsdb_mod.index_payload())
                return
            self._json(tsdb_mod.query_payload(name, labels, window_s))

        def _dashboard(self, parsed) -> None:
            """GET /debug/dashboard: golden-signal sparklines over the TSDB
            (utils/dashboard.py), one self-contained page."""
            q = {k: v[0] for k, v in parse_qs(parsed.query).items()}
            try:
                window_s = tsdb_mod.parse_window(q.get("window", "1h"))
            except tsdb_mod.TSDBError as e:
                self._text(400, str(e))
                return
            extra = {"watchdog": watchdog_mod.debug_payload()}
            cst = canary_mod.state_payload()
            if cst is not None:
                extra["canary"] = cst
            html = dashboard_mod.render_html(
                lambda n, w: tsdb_mod.query(n, window_s=w), window_s, extra)
            self._send(200, html.encode(), "text/html; charset=utf-8")

        def _alerts(self) -> dict:
            """GET /debug/alerts: the SLO engine's states and the watchdog's
            findings (utils/watchdog.py), each program or rule not ok with
            the slowest traces as exemplars."""
            payload = slo.debug_payload()
            for prog, row in payload.get("programs", {}).items():
                if row.get("state") != "ok":
                    row["exemplars"] = (tracespan.slowest_exemplars(program=prog)
                                        or tracespan.slowest_exemplars())
            wd = watchdog_mod.debug_payload()
            for rule in wd.get("rules", ()):
                if rule.get("state") != "ok":
                    prog = (rule.get("labels") or {}).get("program")
                    rule["exemplars"] = (tracespan.slowest_exemplars(program=prog)
                                         if prog else tracespan.slowest_exemplars())
            payload["watchdog"] = wd
            return payload

        def _healthz(self) -> dict:
            """Cheap liveness for load balancers: no state lock and no
            device read.  Only the planes the port runs report a block."""
            trace_b = tracespan.mem_bytes()
            M_DEBUG_MEM.labels(plane="trace").set(trace_b)
            payload = {
                "ok": True,
                "engine": master.engine_name,
                "running": master.is_running,
                "uptime_seconds": round(time.monotonic() - boot_mono, 3),
                # /compute_raw takes the headered binary form (utils/wire.py)
                "wire_binary": True,
            }
            # the frontend supervisor (runtime/app.py sets it): a shrunk or
            # crash-looping worker pool is never silent; `ok` stays liveness
            sup = getattr(self.server, "misaka_supervisor", None)
            degraded = None
            if sup is not None:
                payload["frontends"] = sup.state()
                degraded = payload["frontends"]["degraded"]
            # the native C++ edge (runtime/app.py sets it): its counters ride
            # the same probe, so one scrape shows which tier owns the port
            ne = getattr(self.server, "misaka_native_edge", None)
            if ne is not None:
                payload["native_edge"] = ne.state()
            # the SLO engine (utils/slo.py): a paging burn rate raises the
            # same `degraded` flag; `ok` stays liveness
            slo_state = slo.overall_state()
            if slo_state is not None:
                payload["slo"] = slo_state
                degraded = bool(degraded) or slo_state == "page"
            # the regression watchdog (utils/watchdog.py): a paging rule
            # raises the same flag
            wd_state = watchdog_mod.overall_state()
            if wd_state is not None:
                payload["watchdog"] = wd_state
                degraded = bool(degraded) or wd_state == "page"
            # the synthetic canary (runtime/canary.py), when this process
            # runs one: the last cycle's per-tier outcomes and the first
            # failing tier
            cst = canary_mod.state_payload()
            if cst is not None:
                payload["canary"] = {
                    "failing_tier": cst["failing_tier"],
                    "consecutive_full_failures": cst["consecutive_full_failures"],
                    "tiers": {t: v.get("ok") for t, v in cst["tiers"].items()},
                }
            # the debug rings' memory: the request tracer's, the native
            # flight recorder's (0 until a native pool serves) and the
            # capture ring's
            flight_b = _flight_mem_bytes()
            cap_b = capture_mod.mem_bytes()
            M_DEBUG_MEM.labels(plane="flight").set(flight_b)
            M_DEBUG_MEM.labels(plane="capture").set(cap_b)
            payload["debug_mem"] = {"trace_bytes": trace_b, "flight_bytes": flight_b,
                                    "capture_bytes": cap_b,
                                    "total_bytes": trace_b + flight_b + cap_b}
            if degraded is not None:
                payload["degraded"] = degraded
            if edge_chain.armed:
                payload["edge"] = edge_chain.debug_payload()  # the stages at the door
            return payload

        def _isa_trace(self, parsed) -> None:
            """The instruction history (core/trace.py).  /trace is the old
            name: the same body plus a Deprecation header."""
            if parsed.path == "/trace":
                self._extra_headers += [
                    ("Deprecation", "true"),
                    ("Link", '</debug/isa_trace>; rel="successor-version"')]
            q = {k: v[0] for k, v in parse_qs(parsed.query).items()}
            try:
                last = int(q["last"]) if "last" in q else None
            except ValueError:
                self._text(400, "cannot parse last")
                return
            try:
                entries = master.trace(last=last)
            except RuntimeError as e:
                # 409 (state conflict): tracing is a server configuration
                self._text(409, f"{e} (start the server with MISAKA_TRACE_CAP=N "
                                f"to enable tracing)")
                return
            self._json({"entries": entries})

        def _handle_post(self):
            try:
                # Program addressing: a /programs/<name>/<op> path or an
                # X-Misaka-Program header names the serving program; the op
                # then runs the same route body as its legacy twin against
                # the engine resolved for it.  Neither: the default.
                path = self.path.split("?", 1)[0]
                pm = _PROGRAM_COMPUTE_RE.match(path)
                if pm:
                    prog_ref = unquote(pm.group(1))
                    path = "/" + pm.group(2)
                else:
                    prog_ref = self.headers.get("X-Misaka-Program") or None
                # the program this request is for (edge allowlists and
                # quotas, the slow-request log line): the addressed name,
                # or the seeded default when a registry is armed
                self._misaka_program = (
                    prog_ref.partition("@")[0] if prog_ref
                    else registry.default_name if registry is not None else None)
                # the value estimate for quota and admission comes from the
                # wire size (raw int32s 4 bytes each, decimal text ~8)
                try:
                    clen = int(self.headers.get("Content-Length") or 0)
                except ValueError:
                    clen = 0
                est = (max(1, clen // 4) if path == "/compute_raw"
                       else max(1, clen // 8) if path == "/compute_batch" else 1)
                if not self._edge_check(path, "POST", program=self._misaka_program,
                                        values=est):
                    return
                self._post(path, prog_ref)
            except Exception as e:  # a handler crash must not kill the server
                log.exception("handler error")
                self.close_connection = True  # request state unknown
                self._text(500, f"internal error: {e}")

        def _post(self, path: str, prog_ref: str | None) -> None:
            if path in ("/run", "/pause", "/reset"):
                self._form()  # drain any body (keep-alive sync)
                getattr(master, path[1:])()
                self._text(200, "Success")
            elif path == "/load":
                form = self._form()
                target = form.get("targetURI", "")
                try:
                    master.load(target, form.get("program", ""))
                except (TopologyError, TISParseError, TISLowerError) as e:
                    self._text(400, f"error loading program on node {target}: {e}")
                    return
                self._text(200, "Success")
            elif path == "/compute":
                form = self._form()  # body first: keep-alive stays in sync
                try:
                    with resolved_master(prog_ref, values=1) as m:
                        if not m.is_running:
                            self._text(400, "network is not running")
                            return
                        try:
                            value = int(form.get("value", ""))
                        except ValueError:
                            self._text(400, "cannot parse value")
                            return
                        # through the serve scheduler
                        result = int(m.compute_coalesced([value])[0])
                except ProgramNotFound as e:
                    self._text(404, str(e))
                    return
                except ComputeTimeout as e:
                    self._text(500, str(e))
                    return
                if capture_mod.RECORDING:
                    self._capture_note(m, np.asarray([value], "<i4").tobytes(),
                                       np.asarray([result], "<i4").tobytes(), "coalesced")
                self._json({"value": result})
            elif path == "/compute_batch":
                # form `values`: comma/whitespace-separated ints; `spread=1`
                # stripes over free instances, the default pins one
                form = self._form()
                try:
                    values = dec_to_ints(form.get("values", ""))
                except (ValueError, UnicodeEncodeError):
                    self._text(400, "cannot parse values")
                    return
                try:
                    with resolved_master(prog_ref, values=len(values)) as m:
                        if not m.is_running:
                            self._text(400, "network is not running")
                            return
                        spread = form.get("spread") == "1"
                        if spread:
                            result = m.compute_coalesced(values, return_array=True)
                        else:
                            result = m.compute_many(values, return_array=True)
                except ProgramNotFound as e:
                    self._text(404, str(e))
                    return
                except ComputeTimeout as e:
                    self._text(500, str(e))
                    return
                if capture_mod.RECORDING:
                    self._capture_note(m, np.asarray(values, "<i4").tobytes(),
                                       result.astype("<i4").tobytes(),
                                       "coalesced" if spread else "many")
                # fixed-width padded tokens: legal JSON whitespace
                self._send(200, b'{"values": [' + ints_to_dec(result, b",") + b"]}\n",
                           "application/json")
            elif path == "/compute_raw":
                self._compute_raw(prog_ref)
            elif path == "/programs":
                # the registry's upload surface: publish one program version
                # (TIS source or topology JSON) under a name; a new version
                # over a live engine hot-swaps it
                form = self._form()  # body first (keep-alive)
                if registry is None:
                    self._text(404, "program registry disabled (set MISAKA_PROGRAMS_DIR)")
                    return
                query = {k: v[0] for k, v in parse_qs(urlparse(self.path).query).items()}
                try:
                    result = registry.publish(
                        form.get("name", ""), tis=form.get("program"),
                        topology_json=form.get("topology"), compose=form.get("compose"),
                        slo_spec=form.get("slo"), quota_spec=form.get("quota"),
                        verify=query.get("verify") or form.get("verify") or None)
                except ReplayDivergence as e:
                    # the candidate answered captured traffic otherwise: the
                    # swap was refused, the diffs are the body
                    self._json({"error": str(e), "diffs": e.diffs}, code=409)
                    return
                except (RegistryError, TopologyError, TISParseError, TISLowerError) as e:
                    self._text(400, f"error publishing program: {e}")
                    return
                self._json(result)
            elif path in ("/checkpoint", "/restore"):
                name = self._form().get("name", "")  # body first
                if not checkpoint_dir:
                    self._text(403, "checkpointing disabled (no checkpoint_dir configured)")
                    return
                target = resolve_name(checkpoint_dir, name, ".npz")
                if target is None:
                    self._text(400, "invalid checkpoint name")
                    return
                if path == "/checkpoint":
                    os.makedirs(checkpoint_dir, exist_ok=True)
                    master.save_checkpoint(target)
                else:
                    try:
                        master.load_checkpoint(target)
                    except (OSError, KeyError, ValueError, zipfile.BadZipFile) as e:
                        self._text(400, f"error restoring checkpoint: {e}")
                        return
                self._text(200, "Success")
            elif path == "/captures/start":
                # arm the wire recorder with one anchor (a state snapshot)
                # per live program: the default's, then every active
                # registry engine's
                self._form()  # drain any body (keep-alive sync)
                try:
                    capture_mod.start(anchors=live_anchors())
                except capture_mod.CaptureError as e:
                    self._text(409, str(e))
                    return
                self._json(capture_mod.status())
            elif path == "/captures/stop":
                self._form()  # drain any body (keep-alive sync)
                capture_mod.stop()
                self._json(capture_mod.status())
            elif path == "/captures/rotate":
                self._form()  # drain any body (keep-alive sync)
                try:
                    result = capture_mod.rotate_now()
                except capture_mod.CaptureError as e:
                    self._text(409, str(e))
                    return
                self._json(result if result is not None
                           else {"rotated": False, "reason": "empty ring"})
            elif path == "/captures/export":
                # the ring and its anchors to a segment on disk (admin-gated
                # at the edge: a caller-chosen path is an operator's call)
                form = self._form()
                try:
                    result = capture_mod.export(form.get("path") or None)
                except capture_mod.CaptureError as e:
                    self._text(409, str(e))
                    return
                self._json(result)
            elif path == "/debug/faults":
                # (re-)arm the chaos points on a running server (admin-gated
                # at the edge); spec="" clears them
                form = self._form()
                try:
                    faults.configure(form.get("spec") or None)
                except faults.FaultSpecError as e:
                    self._text(400, str(e))
                    return
                self._json({"armed": sorted(faults.active())})
            elif path == "/fleet/drain":
                # drain the compute plane (runtime/frontends.py): new frames
                # answer the reroute status; report quiescence
                form = self._form()  # body first (keep-alive)
                plane = getattr(self.server, "misaka_plane", None)
                if plane is None:
                    self._text(404, "no compute plane on this server (a fleet replica runs "
                                    "with MISAKA_PLANE_SERVE=1)")
                    return
                on = form.get("state", "on") != "off"
                plane.set_draining(on)
                # the in-flight gauge counts this request too
                self._json({"draining": on, "inflight": plane.inflight(),
                            "http_inflight": max(0, int(M_HTTP_INFLIGHT.value) - 1)})
            elif path == "/profile/start":
                # a torch.profiler capture of the live device loop
                name = self._form().get("name", "profile")  # body first
                if not profile_dir:
                    self._text(403, "profiling disabled (no profile_dir configured)")
                    return
                target = resolve_name(profile_dir, name)
                if target is None:
                    self._text(400, "invalid profile name")
                    return
                os.makedirs(profile_dir, exist_ok=True)
                try:
                    profiler.start(target, cuda=master.device.type == "cuda")
                except profiling.ProfilerError as e:
                    self._text(409, str(e))
                    return
                self._text(200, "Success")
            elif path == "/profile/stop":
                self._form()  # drain any body (keep-alive sync)
                if not profile_dir:
                    self._text(403, "profiling disabled (no profile_dir configured)")
                    return
                try:
                    out = profiler.stop()
                except profiling.ProfilerError as e:
                    self._text(409, str(e))
                    return
                self._text(200, out)
            elif path == "/edge/token":
                self._edge_token(self._form())  # body first (keep-alive)
            elif path == "/edge/gossip":
                # usage gossip: drain the local buckets by a sibling's
                # admissions, answer this replica's own snapshot
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b""
                try:
                    payload = json.loads(raw or b"{}")
                    drained = edge_chain.apply_remote_usage(
                        payload.get("usage") or {}, source=str(payload.get("source") or "peer"))
                except (ValueError, TypeError) as e:
                    edge_mod.M_EDGE_GOSSIP_ROUNDS.labels(status="error").inc()
                    self._text(400, f"bad gossip payload: {e}")
                    return
                edge_mod.M_EDGE_GOSSIP_ROUNDS.labels(status="ok" if drained else "stale").inc()
                self._json({"drained": drained, "usage": edge_chain.usage_snapshot()})
            else:
                # unknown POST: the body is unread -- close, don't desync
                self.close_connection = True
                self._text(404, "not found")

        def _edge_token(self, form: dict) -> None:
            """Mint a signed short-lived tenant token (form `tenant`, `ttl`
            seconds, `programs`, `admin`); 503 without a token secret."""
            if edge_chain.token_secret is None:
                self._text(503, "token minting disabled (set MISAKA_TOKEN_SECRET or "
                                "MISAKA_PLANE_SECRET)")
                return
            tenant = (form.get("tenant") or "").strip()
            if not tenant:
                self._text(400, "missing tenant")
                return
            try:
                ttl = float(form.get("ttl") or 300.0)
            except ValueError:
                self._text(400, "cannot parse ttl")
                return
            ttl = min(max(ttl, 1.0), 86400.0)
            programs = [p.strip() for p in (form.get("programs") or "").split(",")
                        if p.strip()] or None
            token, exp = edge_mod.mint_tenant_token(
                edge_chain.token_secret, tenant, ttl_s=ttl,
                admin=(form.get("admin") or "") in ("1", "true", "on"), programs=programs)
            self._json({"token": token, "tenant": tenant, "expires_at": exp, "ttl_s": ttl})

        def _compute_raw(self, prog_ref: str | None) -> None:
            """Body: raw little-endian int32 values (or the MSK1 framing);
            response: raw int32 outputs, order kept.  Striped over free
            instances by default, one instance under ?spread=0."""
            length_hdr = self.headers.get("Content-Length")
            if length_hdr is None:
                self.close_connection = True
                self._text(411, "Content-Length required")
                return
            try:
                length = int(length_hdr)
            except ValueError:
                self.close_connection = True
                self._text(400, "cannot parse Content-Length")
                return
            if length > max_body:
                self.close_connection = True
                self._text(413, f"body of {length} bytes exceeds the "
                                f"{max_body}-byte cap (MISAKA_MAX_BODY)")
                return
            raw = self.rfile.read(length)
            if wire.is_binary(self.headers.get("Content-Type")):
                try:
                    raw = wire.unpack(raw)
                except wire.WireError as e:
                    self._text(400, f"bad binary body: {e}")
                    return
            if len(raw) % 4:
                self._text(400, "body must be raw int32 values")
                return
            values = np.frombuffer(raw, dtype="<i4")
            query = {k: v[0] for k, v in parse_qs(urlparse(self.path).query).items()}
            try:
                with resolved_master(prog_ref, values=int(values.size)) as m:
                    if not m.is_running:
                        self._text(400, "network is not running")
                        return
                    spread = query.get("spread", "1") == "1"
                    if spread:
                        result = m.compute_coalesced(values, return_array=True)
                    else:
                        result = m.compute_many(values, return_array=True)
            except ProgramNotFound as e:
                self._text(404, str(e))
                return
            except ComputeTimeout as e:
                self._text(500, str(e))
                return
            payload = result.astype("<i4").tobytes()
            if capture_mod.RECORDING:  # the body is already little-endian int32
                self._capture_note(m, bytes(raw), payload,
                                   "coalesced" if spread else "many")
            if wire.accepts_binary(self.headers.get("Accept")):
                self._send(200, wire.header(len(payload) // 4) + payload, wire.CONTENT_TYPE)
            else:
                self._send(200, payload, "application/octet-stream")

    class _Server(ThreadingHTTPServer):
        request_queue_size = 128  # burst of concurrent client dials
        daemon_threads = True

    httpd = _Server(("0.0.0.0", port), Handler)
    if tls is False:
        ctx = None
    elif tls is None:
        ctx = edge_mod.tls_context_from_env()
    else:
        ctx = tls
    return edge_mod.wrap_server_tls(httpd, ctx)
