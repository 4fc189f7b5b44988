"""The native serving engine: the serve pair on the host C++ interpreter.

The port's copy of misaka_tpu/core/native_serve.py.  `MasterNode(engine=
"native")` serves a network entirely on the host, whatever device the
master was given: no kernel launch and no device read on the request path.
The reference calls this its interactive-latency tier: the C++ superstep
interpreter (csrc/native/interpreter.cpp, the same third implementation
the differential tests hold against the kernel's plain version) runs a
128-tick chunk in microseconds, so a quiet /compute costs queue hops
instead of a launch and a device read.

Design: the master's canonical state stays the NetworkState of (CPU)
torch tensors.  A call that is handed a state it did not produce imports
it (validated and copied into C++), feeds, runs the chunk and packs; on
the resident path (MISAKA_NATIVE_RESIDENT, default on) the state then
stays in C++ and the returned NetworkState is an identity anchor whose
tensors are stale until `export_resident` materializes them, which the
master does before every read of the state's content.  The serve
contract (feed `count` values, advance `num_steps`, return (state with a
drained output ring, packed [in_rd, in_wr, out_rd, out_wr, out_buf...]))
is byte-compatible with core/engine.py's `make_serve` pair, held by
tests/test_torch_native_engine.py; the packed rows come back as numpy
arrays (host memory: there is nothing to read back).

NativeServe is the unbatched latency tier (one instance, one host core);
NativeServePool the batched host tier: B replica interpreters sharded
across OS threads (cinterp.NativePool), the twin of the batched serve pair
(core/engine.py make_batched_serve), with the partial-fill `active`
argument, the tick ladder (jit, specialized, avx2 / generic, scalar:
core/jit.py, core/specialize.py, MISAKA_SIMD) and the flight recorder
(MISAKA_NATIVE_TRACE, _RING) below.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
import weakref

import numpy as np
import torch

from misaka_tpu_torch.core import cinterp
from misaka_tpu_torch.core import jit
from misaka_tpu_torch.core import specialize
from misaka_tpu_torch.core.state import BOOL_FIELDS, NetworkState
from misaka_tpu_torch.runtime import usage
from misaka_tpu_torch.utils import faults
from misaka_tpu_torch.utils import metrics
from misaka_tpu_torch.utils import tracespan

# Native-tier instrumentation (served at GET /metrics): one histogram for
# every host-interpreter call kind, plus pool-shape gauges.  The label
# children are resolved once — a pool serve costs single-digit us and must
# not pay per-call dict lookups for its own telemetry.
_H_SERVE = metrics.histogram(
    "misaka_native_serve_seconds",
    "Host C++ interpreter call duration by kind (chunk = unbatched "
    "serve_chunk, serve/idle = the thread-pooled batched twins)",
    ("kind",),
)
_H_SERVE_CHUNK = _H_SERVE.labels(kind="chunk")
_H_SERVE_POOL = _H_SERVE.labels(kind="serve")
_H_SERVE_IDLE = _H_SERVE.labels(kind="idle")
_C_CALLS = metrics.counter(
    "misaka_native_serve_calls_total", "Host C++ interpreter calls by kind",
    ("kind",),
)
_C_CALLS_CHUNK = _C_CALLS.labels(kind="chunk")
_C_CALLS_POOL = _C_CALLS.labels(kind="serve")
_C_CALLS_IDLE = _C_CALLS.labels(kind="idle")
_G_POOL_THREADS = metrics.gauge(
    "misaka_native_pool_threads", "OS threads in the live native replica pool"
)
_G_POOL_REPLICAS = metrics.gauge(
    "misaka_native_pool_replicas", "Replica interpreters in the live native pool"
)
_G_POOL_FILL = metrics.gauge(
    "misaka_native_pool_fill_ratio",
    "Fraction of replicas fed on the last pool serve (replica-batch fill)",
)
# The pool gauges aggregate over EVERY live pool at scrape time (the
# set_function bindings live below _live_pools) — the same multi-tenant
# discipline as pool_counters(): a last-constructed-pool binding reported
# the wrong tenant's pool after an activation or eviction, and a closed
# or collected pool must read 0, not its last live values.


def available() -> bool:
    return cinterp.available()


def state_arrays(state: NetworkState) -> dict:
    """A state's fields as numpy arrays (host memory of CPU tensors; the
    C++ side copies on import, so nothing of the caller's is written)."""
    return {f: getattr(state, f).detach().cpu().numpy() for f in NetworkState._fields}


def state_of(d: dict) -> NetworkState:
    """A NetworkState of CPU torch tensors over the arrays of `d` (export
    or serve output; the flag planes as bool)."""
    out = {}
    for f in NetworkState._fields:
        a = np.asarray(d[f])
        if f in BOOL_FIELDS:
            a = a.astype(bool)
        elif not a.flags.c_contiguous:
            a = a.copy()
        out[f] = torch.from_numpy(a)
    return NetworkState(**out)


# Every live pool, for the usage/flamegraph planes: a multi-tenant
# registry server runs one pool per active program engine, so the debug
# surfaces aggregate across ALL of them (a single last-constructed slot
# reported the wrong tenant's pool after an activation or eviction).
# Weakrefs only — this module must not keep a swapped-out engine alive;
# dead/closed entries are pruned on read.
_pool_refs: list = []
_pool_refs_lock = threading.Lock()


def _live_pools() -> list:
    with _pool_refs_lock:
        pools = []
        keep = []
        for r in _pool_refs:
            p = r()
            if p is not None and not p._closed:
                pools.append(p)
                keep.append(r)
        _pool_refs[:] = keep
    return pools


def _fill_ratio() -> float:
    # replica-weighted mean across pools: the per-pool value already is
    # "fraction of replicas fed on the last serve"
    pools = _live_pools()
    total = sum(p._replicas for p in pools)
    if not total:
        return 0.0
    return sum(p._last_fill * p._replicas for p in pools) / total


_G_POOL_THREADS.set_function(
    lambda: sum(p.threads for p in _live_pools())
)
_G_POOL_REPLICAS.set_function(
    lambda: sum(p._replicas for p in _live_pools())
)
_G_POOL_FILL.set_function(_fill_ratio)

# SIMD / specialization observability: lane width is the
# replica-group width of the widest live pool (8 = the AVX2 group path, 0
# = scalar per-replica ticks — MISAKA_SIMD=0 or no pool), specialized
# counts pools executing per-program baked tick functions.  The
# specialize-outcome counter lives in core/specialize.py.
_G_SIMD_WIDTH = metrics.gauge(
    "misaka_native_simd_lane_width",
    "Replicas stepped per SIMD group by the widest live native pool "
    "(0 = scalar per-replica path)",
)
_G_SPECIALIZED = metrics.gauge(
    "misaka_native_specialized_active",
    "Live native pools executing per-program specialized tick functions",
)
_G_JIT_ACTIVE = metrics.gauge(
    "misaka_native_jit_active",
    "Live native pools dispatching group ticks through copy-and-patch "
    "JIT fragment tables (r21; the splice/arm outcome counter is "
    "misaka_native_jit_total in core/jit.py)",
)
# Pack-row elision: quiescent replicas whose packed-row write was
# skipped because the caller's reused buffer already held the current row
# vs rows actually (re)written down the skip path.  elided / (elided +
# written) is the sparse-fill win ratio.
_C_ELIDED_ROWS = metrics.counter(
    "misaka_native_elided_rows_total",
    "Quiescent pack rows elided on resident serves (row write skipped: "
    "the reused packed buffer was already current)",
)
_C_SKIP_PACKED_ROWS = metrics.counter(
    "misaka_native_skip_packed_rows_total",
    "Quiescent pack rows written down the skipped-replica path (the "
    "rows elision did NOT cover)",
)
# Satellite: first-class per-rung tick counter (previously rung share was
# only derivable from flight-recorder exemplars).  Replica-ticks executed
# per ladder rung — sum across shapes of the recorder's reps aggregate —
# so JIT coverage is one PromQL query:
#   sum by (rung) (rate(misaka_native_tick_rung_total[5m]))
_C_TICK_RUNG = metrics.counter(
    "misaka_native_tick_rung_total",
    "Replica-ticks executed per native-ladder rung (scalar / generic / "
    "avx2 / spec-* / jit*)",
    ("rung",),
)


def _simd_width() -> float:
    width = 0
    for p in _live_pools():
        try:
            info = p.simd_info()
        except Exception:
            continue
        width = max(width, info["width"])
    return float(width)


def _specialized_active() -> float:
    count = 0
    for p in _live_pools():
        try:
            if p.simd_info()["specialized"]:
                count += 1
        except Exception:
            continue
    return float(count)


def _jit_active() -> float:
    count = 0
    for p in _live_pools():
        try:
            if p.simd_info().get("jit"):
                count += 1
        except Exception:
            continue
    return float(count)


_G_SIMD_WIDTH.set_function(_simd_width)
_G_SPECIALIZED.set_function(_specialized_active)
_G_JIT_ACTIVE.set_function(_jit_active)

_G_POOL_BUSY = metrics.gauge(
    "misaka_native_pool_busy_fraction",
    "Fraction of pool thread time spent executing (vs cv-parked) over "
    "the last ~1s window, from the C++ per-thread busy/idle counters — "
    "the dashboard's native-tier saturation signal (the since-boot "
    "fraction lives on /debug/usage)",
)


class _BusyWindow:
    """Windowed busy fraction from the cumulative C++ ns counters: the
    since-boot ratio converges and stops moving, so the gauge deltas the
    counters over >= 1 s between refreshes — every scraper inside that
    second sees one coherent value."""

    def __init__(self):
        self._lock = threading.Lock()
        self._prev: tuple[float, int, int] | None = None
        self._value = 0.0

    def read(self) -> float:
        work = total = 0
        for p in _live_pools():
            try:
                c = p._pool.counters()
            except Exception:
                continue
            w = c["work_ns"]  # the one derivation site: cinterp counters()
            work += w
            total += w + c["idle_ns"]
        now = time.monotonic()
        with self._lock:
            prev = self._prev
            if prev is None:
                self._prev = (now, work, total)
                return 0.0
            dt_total = total - prev[2]
            if now - prev[0] >= 1.0:
                if dt_total > 0:
                    self._value = max(
                        0.0, min(1.0, (work - prev[1]) / dt_total)
                    )
                elif total == 0:
                    self._value = 0.0  # pools closed: not busy
                self._prev = (now, work, total)
            return self._value


_G_POOL_BUSY.set_function(_BusyWindow().read)


# --- resident-state serving ------------------------------------------
#
# The native engines keep their state IN C++ between serve calls on the
# trusted-identity path: the device loop passes back the exact state
# object the engine returned last call, so as long as that identity holds
# nothing else touched the state and the per-call import/export round
# trip (~200us/call at B=256) is pure waste.  Lifecycle paths —
# checkpoint, /load, /restore, autogrow, registry eviction/hot-swap,
# /status — export lazily through export_resident() (MasterNode calls it
# before reading self._state's content).  MISAKA_NATIVE_RESIDENT=0 kills
# the layer (the stateless behaviour); the `resident_fallback`
# chaos point forces the stateless path per-call with a coherent export
# first.

def resident_enabled() -> bool:
    return os.environ.get("MISAKA_NATIVE_RESIDENT", "1") not in ("0", "off")


_C_RESIDENT = metrics.counter(
    "misaka_native_resident_total",
    "Resident-state serve events: hit = served on in-C++ state, miss = "
    "state replaced, re-imported + armed, export = a lifecycle path "
    "materialized the state, fallback = stateless serve while armed "
    "(kill switch / resident_fallback chaos) after a coherent export",
    ("event",),
)
_C_RES_HIT = _C_RESIDENT.labels(event="hit")
_C_RES_MISS = _C_RESIDENT.labels(event="miss")
_C_RES_EXPORT = _C_RESIDENT.labels(event="export")
_C_RES_FALLBACK = _C_RESIDENT.labels(event="fallback")

# module-level mirrors of hit/miss for the windowed ratio gauge (reading
# our own counter objects back is not part of the metrics API)
_res_events = {"hit": 0, "miss": 0}

_G_RES_ACTIVE = metrics.gauge(
    "misaka_native_resident_active",
    "Live native pools currently serving on in-C++ resident state",
)
_G_RES_RATIO = metrics.gauge(
    "misaka_native_resident_hit_ratio",
    "Resident-state hit ratio (hits / serve calls) over the last ~1s "
    "window — the dashboard's residency signal; 0 with residency "
    "disabled or the pool cold",
)


def _resident_active() -> float:
    count = 0
    for p in _live_pools():
        try:
            if p._pool.is_resident():
                count += 1
        except Exception:
            continue
    return float(count)


_G_RES_ACTIVE.set_function(_resident_active)


class _HitWindow:
    """Windowed hit ratio from the cumulative event mirrors (the
    _BusyWindow discipline: delta over >= 1 s, coherent within it)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._prev: tuple[float, int, int] | None = None
        self._value = 0.0

    def read(self) -> float:
        hit, miss = _res_events["hit"], _res_events["miss"]
        now = time.monotonic()
        with self._lock:
            prev = self._prev
            if prev is None:
                self._prev = (now, hit, miss)
                return 0.0
            if now - prev[0] >= 1.0:
                dh = hit - prev[1]
                dm = miss - prev[2]
                self._value = dh / (dh + dm) if dh + dm > 0 else 0.0
                self._prev = (now, hit, miss)
            return self._value


_G_RES_RATIO.set_function(_HitWindow().read)


# --- native flight recorder ------------------------------------------
#
# The C++ pool journals steady-clock-stamped events into bounded
# lock-free per-thread rings (csrc/native/interpreter.cpp, the flight-recorder block):
# serve-call lifecycle, dispenser wait phases, per-unit tick execution
# tagged by engine rung, residency import/export.  This layer exports it
# upward: derived metrics (dispenser wait, spin-vs-park, unit imbalance,
# per-rung tick share) pulled into the registry at a throttled cadence
# from the serve path, correlation of ring events with the request-trace
# IDs active during each pool call (the per-call windows below), the raw
# dump behind GET /debug/native_trace, and a tier source feeding native
# worker-thread spans into the GET /debug/perfetto export.  Always-on
# like the stack sampler; MISAKA_NATIVE_TRACE=0 kills the whole plane
# (C++ rings unallocated, every hook below a no-op) and set_trace()
# flips a built recorder at runtime for the overhead A/B.

def trace_enabled() -> bool:
    return os.environ.get("MISAKA_NATIVE_TRACE", "1") not in ("0", "off")


_TRACE_ON = trace_enabled()


def set_trace(on: bool) -> bool:
    """Arm/disarm the flight recorder at runtime: every live pool's C++
    emit flag plus the Python-side correlation/pull plumbing (the
    overhead A/B's toggle).  False when some pool was created
    under MISAKA_NATIVE_TRACE=0 and has no rings to arm."""
    global _TRACE_ON
    _TRACE_ON = bool(on)
    ok = True
    for p in _live_pools():
        try:
            ok = p._pool.trace_set(on) and ok
        except Exception:
            ok = False
    return ok


_H_DISP_WAIT = metrics.histogram(
    "misaka_native_dispenser_wait_seconds",
    "Caller-side dispenser wait per published pool call (time the "
    "calling thread waited on the done futex AFTER helping drain the "
    "unit list — the straggler tail the r17 flat dispenser replaced the "
    "~180us barrier with).  Sampled from the recorder at the ~50ms pull "
    "cadence: each observation is the mean wait of one pull window",
)
_H_UNIT_IMBALANCE = metrics.histogram(
    "misaka_native_unit_imbalance",
    "Units-drained spread (max - min) across worker threads on the last "
    "published pool call per pull window — sustained nonzero at full "
    "batch means one thread runs the tail while siblings wait",
)
_C_DISP_PHASE = metrics.counter(
    "misaka_native_dispenser_seconds_total",
    "Worker dispenser wait seconds by phase (spin = pause-spin, yield = "
    "yield-spin, park = futex) — the spin-vs-park split the "
    "MISAKA_POOL_SPIN_US budget trades on",
    ("phase",),
)
_C_DISP_SPIN = _C_DISP_PHASE.labels(phase="spin")
_C_DISP_YIELD = _C_DISP_PHASE.labels(phase="yield")
_C_DISP_PARK = _C_DISP_PHASE.labels(phase="park")
_C_UNITS = metrics.counter(
    "misaka_native_units_replicas_total",
    "Replicas ticked by dispensed pool units, by engine rung (scalar / "
    "generic / avx2 / spec-*) and unit shape (group / scalar remainder "
    "/ masked partial-fill) — the per-rung tick share",
    ("rung", "shape"),
)
_C_CALLER_UNITS = metrics.counter(
    "misaka_native_caller_inline_units_total",
    "Units drained on the CALLING thread (the zero-handoff inline path "
    "and the caller helping while workers tick) — the caller-inline "
    "lane's unit count",
)
_C_TRACE_DROPPED = metrics.counter(
    "misaka_native_trace_dropped_total",
    "Flight-recorder records overwritten before any reader saw them "
    "(bounded rings drop oldest-first; size with "
    "MISAKA_NATIVE_TRACE_RING)",
)
_G_SPIN_RATIO = metrics.gauge(
    "misaka_native_dispenser_spin_ratio",
    "Fraction of worker dispenser wait spent spinning (pause + yield) "
    "vs parked on the futex over the last ~1s window — ~1 under "
    "saturation (calls arrive inside the spin budget), ~0 idle",
)


class _SpinWindow:
    """Windowed spin-vs-park ratio from the cumulative phase counters
    (the _BusyWindow discipline: delta over >= 1 s, coherent within)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._prev: tuple[float, int, int] | None = None
        self._value = 0.0

    def read(self) -> float:
        spin = park = 0
        for p in _live_pools():
            try:
                s = p._pool.trace_stats()
            except Exception:
                continue
            spin += s["spin_ns"] + s["yield_ns"]
            park += s["park_ns"]
        now = time.monotonic()
        with self._lock:
            prev = self._prev
            if prev is None:
                self._prev = (now, spin, park)
                return 0.0
            if now - prev[0] >= 1.0:
                ds, dp = spin - prev[1], park - prev[2]
                self._value = ds / (ds + dp) if ds + dp > 0 else 0.0
                self._prev = (now, spin, park)
            return self._value


_G_SPIN_RATIO.set_function(_SpinWindow().read)

# decoded-event field extractors (arg layouts: interpreter.cpp TraceEv)
_EV_NAMES = cinterp.NativePool.TRACE_EVENTS
_RUNG_NAMES = cinterp.NativePool.TRACE_RUNGS
_SHAPE_NAMES = cinterp.NativePool.TRACE_SHAPES


def _decode_event(t0: int, dur: int, kind: int, arg: int) -> dict:
    k = _EV_NAMES.get(kind, str(kind))
    ev = {"t_ns": t0, "dur_ns": dur, "kind": k}
    if k == "unit":
        ev["replicas"] = arg & 0xFFFFFF
        shape = (arg >> 24) & 0x7
        rung = (arg >> 27) & 0x1F
        ev["shape"] = _SHAPE_NAMES.get(shape, f"shape{shape}")
        ev["rung"] = _RUNG_NAMES.get(rung, f"rung{rung}")
        ev["idx"] = arg >> 32
    elif k == "serve":
        ev["active"] = arg & 0xFFFFFFFF
        flags = arg >> 32
        ev["feeding"] = bool(flags & 1)
        ev["resident"] = bool(flags & 2)
        ev["inline"] = bool(flags & 4)
    elif k in ("import", "export", "discard"):
        ev["replicas"] = arg & 0xFFFFFFFF
        if k != "discard":
            ev["failed"] = bool(arg >> 32)
    return ev


def _window_index(pool) -> list[tuple[float, float, tuple]]:
    """The pool's recent (start, end, trace_ids) serve-call windows,
    sorted by start — C++ steady_clock and time.monotonic share
    CLOCK_MONOTONIC on Linux, so ring timestamps land inside them."""
    return sorted(pool._call_windows)


def _ids_for(windows, start_s: float, end_s: float) -> tuple:
    """Trace IDs active during [start_s, end_s] (one serializing caller
    per pool, so windows never overlap and a scan from bisect is
    bounded).  EXACT containment — ring stamps are taken inside the
    Python-measured call window on the same CLOCK_MONOTONIC, and any
    slop here would cross-attribute IDs between adjacent calls at high
    call rates (~50us apart at high call rates)."""
    import bisect

    if not windows:
        return ()
    i = bisect.bisect_right(windows, (start_s, float("inf"), ())) - 1
    out: list = []
    for j in range(max(0, i), len(windows)):
        w0, w1, ids = windows[j]
        if w0 > end_s:
            break
        if w1 >= start_s and w0 <= end_s:
            for tid in ids:
                if tid not in out:
                    out.append(tid)
    return tuple(out)


def _iter_flight_rings(max_records: int | None):
    """The shared ring walk behind both exporters: yields one tuple per
    readable ring — (pool, program label, ring index, role, cursor,
    dropped, decoded events) — with serve/unit events already carrying
    the request-trace IDs of the call windows they fell inside.  A pool
    or ring that fails to read is skipped (debug surfaces answer), and
    pools without rings (MISAKA_NATIVE_TRACE=0) yield nothing."""
    for p in _live_pools():
        try:
            info = p._pool.trace_info()
        except Exception:
            continue
        try:
            label = p.usage_label()
        except Exception:
            label = usage.DEFAULT_LABEL
        if not info["rings"]:
            yield p, label, info, None, None, None, None
            continue
        windows = _window_index(p)
        for ring in range(info["rings"]):
            try:
                recs, cursor, dropped = p._pool.trace_read(
                    ring, max_records
                )
            except Exception:
                continue
            role = "caller" if ring == p.threads else f"worker{ring}"
            events = []
            for t0, dur, kind, arg in recs.tolist():
                ev = _decode_event(t0, dur, kind, arg)
                if ev["kind"] in ("serve", "unit"):
                    ids = _ids_for(windows, t0 / 1e9, (t0 + dur) / 1e9)
                    if ids:
                        ev["trace_ids"] = list(ids)
                events.append(ev)
            yield p, label, info, ring, role, (cursor, dropped), events


def flight_mem_bytes() -> int:
    """Allocated flight-recorder ring memory across live pools (rings x
    capacity x 32 B records — interpreter.cpp's TraceRec layout), for
    the /healthz debug_mem budget surface shared with the request-trace
    recorder and the capture ring."""
    total = 0
    for p in _live_pools():
        try:
            info = p._pool.trace_info()
        except Exception:
            continue
        total += int(info.get("rings", 0)) * int(
            info.get("capacity", 0)
        ) * 32
    return total


def flight_payload(max_records: int | None = None) -> dict:
    """GET /debug/native_trace: the raw per-thread rings of every live
    pool, decoded, with serve/unit events carrying the request-trace IDs
    active during their pool call.  Reading also refreshes the derived
    metrics (an idle pool's counters stay fresh on scrape)."""
    entries: dict[int, dict] = {}
    pulled: set[int] = set()
    for p, label, info, ring, role, meta, events in \
            _iter_flight_rings(max_records):
        entry = entries.get(id(p))
        if entry is None:
            entry = entries[id(p)] = {
                "program": label,
                "threads": p.threads,
                "capacity": info["capacity"],
                "armed": info["armed"],
                "dropped": info["dropped"],
                "rings": [],
            }
        if ring is None:
            continue
        entry["rings"].append({
            "ring": ring,
            "role": role,
            "cursor": meta[0],
            "dropped": meta[1],
            "events": events,
        })
        if id(p) not in pulled:
            pulled.add(id(p))
            try:
                p._pull_trace_stats(force=True)
            except Exception:
                pass
    return {"enabled": _TRACE_ON, "pools": list(entries.values())}


def flight_spans(window_s: float = 15.0, max_per_ring: int = 512) -> list:
    """Recent flight-recorder events as tracespan.Span objects for the
    Perfetto export (registered as a tier source below): per-thread
    native lanes (attrs['_lane']) plus request-trace correlation
    (attrs['trace_ids']) so one trace ID reads as one timeline from
    http.parse down to the worker-thread units that served it."""
    spans: list = []
    now = time.monotonic()
    for _p, label, _info, ring, role, _meta, events in \
            _iter_flight_rings(max_per_ring):
        if ring is None:
            continue
        for ev in events:
            ev = dict(ev)
            t0 = ev.pop("t_ns")
            dur = ev.pop("dur_ns")
            start = t0 / 1e9
            if now - start > window_s:
                continue
            k = ev.pop("kind")
            ids = ev.pop("trace_ids", None)
            attrs = {"_lane": f"{label}/{role}", "pool": label}
            attrs.update(ev)
            if ids:
                attrs["trace_ids"] = ids
            spans.append(tracespan.Span(
                f"native.{k}", start, dur / 1e9, attrs
            ))
    return spans


tracespan.register_tier_source(flight_spans)


def pool_counters() -> dict | None:
    """Busy/idle nanosecond counters across every live native pool (None
    when no pool is serving): process-wide aggregate + a per-pool block
    per program, read lock-free from the C++ side
    (csrc/native/interpreter.cpp misaka_pool_counters).  `busy` includes the
    serial fast-path time (small passes run on the calling thread) — a
    box saturated in the partial-fill regime is busy, not idle."""
    pools = []
    for p in _live_pools():
        try:
            c = p._pool.counters()
            busy, idle = p._pool.thread_counters()
        except Exception:  # a closing pool must not 500 the debug surface
            continue
        try:
            label = p.usage_label()
        except Exception:
            label = usage.DEFAULT_LABEL
        c["program"] = label
        c["busy_ns_per_thread"] = [int(v) for v in busy]
        c["idle_ns_per_thread"] = [int(v) for v in idle]
        # The caller-inline lane, FIRST-CLASS: work booked on the
        # calling thread — the zero-handoff path runs EVERY unit
        # there on 1-worker pools, plus the caller-help and serial fast
        # paths everywhere.  cinterp counters() is the ONE place the
        # caller_inline_ns/work_ns fields are derived; this layer only
        # aggregates them.
        total = c["work_ns"] + c["idle_ns"]
        c["busy_fraction"] = round(c["work_ns"] / total, 6) if total else 0.0
        pools.append(c)
    if not pools:
        return None
    out = {
        "threads": sum(c["threads"] for c in pools),
        "busy_ns": sum(c["busy_ns"] for c in pools),
        "idle_ns": sum(c["idle_ns"] for c in pools),
        "serial_ns": sum(c["serial_ns"] for c in pools),
        "caller_inline_ns": sum(c["caller_inline_ns"] for c in pools),
        "busy_ns_per_thread": [
            v for c in pools for v in c["busy_ns_per_thread"]
        ],
        "idle_ns_per_thread": [
            v for c in pools for v in c["idle_ns_per_thread"]
        ],
    }
    out["work_ns"] = out["busy_ns"] + out["caller_inline_ns"]
    total = out["work_ns"] + out["idle_ns"]
    out["busy_fraction"] = round(out["work_ns"] / total, 6) if total else 0.0
    if len(pools) > 1:
        out["pools"] = pools  # the per-program split, one block per pool
    return out


class NativeServe:
    """serve_chunk twin for one CompiledNetwork, backed by NativeInterpreter."""

    is_native = True  # engine_name dispatch marker (runtime/master.py)

    def __init__(self, net):
        if net.batch is not None:
            raise ValueError("the native engine serves a single network instance")
        self._interp = cinterp.NativeInterpreter(
            np.asarray(net.code), np.asarray(net.prog_len),
            net.num_stacks, net.stack_cap, net.in_cap, net.out_cap,
        )
        self._out_cap = net.out_cap
        self._resident = resident_enabled()
        # Residency anchor: while set, the interpreter ITSELF holds the
        # authoritative state and `_last_state`'s array contents are
        # stale — only its identity matters.  None = the interpreter's
        # content mirrors whatever the last export produced (stateless).
        self._last_state: NetworkState | None = None
        # usage attribution: the unbatched interpreter runs synchronously
        # on the calling thread, so the call wall IS its busy time (the
        # pooled tier uses the C++ busy-ns counters instead)
        self.usage_label = lambda: usage.DEFAULT_LABEL

    def close(self) -> None:
        self._last_state = None  # nothing resident is left to export
        self._interp.close()

    def validate_state(self, state: NetworkState) -> None:
        """Raise ValueError on a state this engine cannot execute (pc beyond
        the program, stack_top beyond capacity, broken ring counters).
        Importing IS the validation — all-or-nothing on the C side, so a
        rejected state leaves the interpreter (and an armed residency
        anchor) untouched; a SUCCESSFUL import replaces the resident
        content, so the anchor is cleared (the next serve re-imports its
        own state)."""
        self._interp.import_arrays(state_arrays(state))
        self._last_state = None

    def export_resident(self, anchor=None) -> NetworkState | None:
        """Materialize the resident state (None when not armed — the
        caller's state object is already authoritative).  Residency stays
        armed, re-anchored on the returned object.  `anchor` (the caller's
        current state object) gates the export: when given and NOT this
        engine's identity anchor, the resident copy is superseded (a
        lifecycle path replaced the state) and None is returned."""
        if self._last_state is None:
            return None
        if anchor is not None and anchor is not self._last_state:
            return None
        st = state_of(self._interp.export_arrays())
        _C_RES_EXPORT.inc()
        self._last_state = st
        return st

    def serve_chunk(self, state: NetworkState, values, count, num_steps: int):
        """See core/engine.py serve_chunk — same contract, host execution.

        Resident fast path: when the caller hands back the exact
        state object this engine returned last chunk, the import is
        skipped (the interpreter already holds that state) and the export
        collapses to the packed row — the returned state is the SAME
        object, with lifecycle reads going through export_resident."""
        t0 = time.perf_counter()
        it = self._interp
        anchored = (
            self._last_state is not None and state is self._last_state
        )
        track = self._resident and faults.fire("resident_fallback") is None
        if not anchored:
            it.import_arrays(state_arrays(state))
        if track:
            (_C_RES_HIT if anchored else _C_RES_MISS).inc()
            _res_events["hit" if anchored else "miss"] += 1
        count = int(count)
        if count:
            fed = it.feed(np.asarray(values[:count], np.int32))
            if fed != count:  # caller cut to free space; a miss is a bug
                raise RuntimeError(f"native feed accepted {fed}/{count}")
        it.run(int(num_steps))
        # snapshot + INTERNAL drain: the interpreter's ring state stays
        # coherent whether or not the next call skips the import
        packed = it.pack(drain=True)
        if track:
            self._last_state = state
            out = state, packed
        else:
            if anchored:
                _C_RES_FALLBACK.inc()  # chaos/kill switch: export fresh
            d = it.export_arrays()  # rings already drained above
            self._last_state = None
            out = state_of(d), packed
        _C_CALLS_CHUNK.inc()
        dur = time.perf_counter() - t0
        usage.add_native(self.usage_label(), dur)
        _H_SERVE_CHUNK.observe(dur)
        return out


class NativeServePool:
    """Batched serve twins for one CompiledNetwork on the C++ thread pool.

    `serve`/`idle` are drop-in twins of the (serve_fn, idle_fn) pair built
    by CompiledNetwork.make_batched_serve — same signatures, same packed
    [B, 4+out_cap] snapshot layout, same drained-on-serve / untouched-on-
    idle ring discipline — so MasterNode's batched device loop drives this
    tier through the exact code path it drives the jitted engines through.
    B network replicas are embarrassingly parallel (independent instances,
    deterministic per request); the pool shards them across OS threads
    inside one GIL-releasing call.  The canonical state stays the
    NetworkState: each call imports/exports batch-major slices, so
    checkpoint/restore, /load, and stack auto-grow keep working unchanged.
    """

    is_native = True

    def __init__(self, net, chunk_steps: int = 128, threads: int | None = None,
                 specialized: str | None = None, jit_program=None):
        if net.batch is None:
            raise ValueError("NativeServePool serves a batched network "
                             "(use NativeServe for batch=None)")
        # `specialized` names a per-program interpreter .so built by
        # core/specialize.py.  The fallback ladder is total: a load
        # failure, a pool whose baked tables don't engage (C++-side
        # mismatch), or ANY other error serves on the generic library —
        # specialization may only ever add speed, never an outage.
        lib = None
        if specialized is not None:
            try:
                lib = cinterp.load_specialized(specialized)
            except Exception as e:
                specialize.M_SPECIALIZE.labels(status="fallback").inc()
                logging.getLogger("misaka.specialize").warning(
                    "specialized build %s failed to load (%s); "
                    "serving generic", specialized, e,
                )
                lib = None
        self._pool = cinterp.NativePool(
            np.asarray(net.code), np.asarray(net.prog_len),
            net.num_stacks, net.stack_cap, net.in_cap, net.out_cap,
            replicas=net.batch, threads=threads, lib=lib,
        )
        if lib is not None and not self._pool.simd_info()["specialized"]:
            # the .so loaded but its baked tables did not engage (key'd
            # wrong, SIMD off, or batch below the group width): count it
            # so a silent always-generic fleet is visible on /metrics
            specialize.M_SPECIALIZE.labels(status="fallback").inc()
        # Copy-and-patch JIT rung: `jit_program` is a core/jit.py
        # JitProgram spliced for this net.  Arm failure falls back ONE
        # rung (the pool keeps serving switch-threaded / generic) with a
        # logged reason and a counted outcome — never an error.
        if jit_program is not None:
            try:
                rc = self._pool.jit_arm(jit_program)
            except Exception as e:  # noqa: BLE001 - total fallback
                rc = -8
                logging.getLogger("misaka.jit").warning(
                    "jit: arm raised (%s); serving one rung down", e)
            if rc == 0:
                jit.M_JIT.labels(status="armed").inc()
            else:
                jit.M_JIT.labels(status="error").inc()
                logging.getLogger("misaka.jit").warning(
                    "jit: arm refused (rc %d); serving one rung down", rc)
        self.threads = self._pool.threads
        self._chunk = int(chunk_steps)
        self._replicas = net.batch
        self._closed = False
        self._last_fill = 0.0
        # Steady-state identity cache: the master's device loop passes back
        # the exact NetworkState this pool returned last call, whose dict
        # round-trips the exact arrays the C++ side exported — when that
        # identity holds, cinterp skips per-call re-validation (the trusted
        # fast path).  Any lifecycle path that builds a fresh state (load,
        # restore, autogrow pad, drain_batched's _replace) simply misses
        # the cache and takes the validated path.
        self._last_state = None
        self._last_dict = None
        # Resident-state mode: when armed, the identity cache proves
        # MORE — the batch state lives in C++ between calls and `state` is
        # just the anchor object, so serve/idle skip the import/export
        # round trip entirely.  _progress carries the last resident call's
        # per-replica hot flags for the device loop (the stateless path
        # leaves it None and the loop derives hotness from `retired`).
        self._resident = resident_enabled()
        self._progress = None
        # Usage attribution (runtime/usage.py): which program this pool's
        # busy time bills to.  MasterNode rebinds this to its live
        # program_label (through a weakref — the registry names engines
        # AFTER construction); direct constructions bill "default".
        self.usage_label = lambda: usage.DEFAULT_LABEL
        # busy-ns watermark for take_busy_ns deltas (device-loop thread
        # only — one serializing caller per pool by construction), plus
        # the elision-counter watermarks riding the same read
        self._busy_mark = 0
        self._elided_mark = 0
        self._skip_packed_mark = 0
        # Flight-recorder plumbing: per-call (start, end, trace_ids)
        # windows correlate ring events with the request traces the pass
        # served (MasterNode rebinds active_trace_ids like usage_label);
        # the stats watermark feeds the derived metrics at a throttled
        # cadence so the pull never taxes the per-call hot path.
        self._call_windows: collections.deque = collections.deque(maxlen=512)
        self.active_trace_ids = lambda: ()
        self._trace_marks: dict | None = None
        self._trace_last_pull = 0.0
        self._trace_pull_lock = threading.Lock()
        # prime the watermark with the pool's zero snapshot: the FIRST
        # real pull then reports deltas instead of discarding everything
        # ticked before it (a short-lived pool was invisible to the
        # per-rung counters otherwise)
        self._pull_trace_stats(force=True)
        with _pool_refs_lock:
            _pool_refs.append(weakref.ref(self))

    def close(self) -> None:
        self._closed = True
        self._pool.close()

    def simd_info(self) -> dict:
        """The pool's execution mode (cinterp.NativePool.simd_info)."""
        return self._pool.simd_info()

    def take_busy_ns(self) -> int:
        """Busy-ns accumulated since the last take (worker + serial-path
        time): the MEASURED native cost of the call(s) in between, which
        the device loop attributes to its program.  Device-loop thread
        only — one serializing caller per pool by construction."""
        c = self._pool.counters()
        busy = c["work_ns"]
        delta = busy - self._busy_mark
        self._busy_mark = busy
        # pack-row elision deltas ride the same counters read
        el, sk = c.get("elided_rows", 0), c.get("skip_packed_rows", 0)
        if el > self._elided_mark:
            _C_ELIDED_ROWS.inc(el - self._elided_mark)
            self._elided_mark = el
        if sk > self._skip_packed_mark:
            _C_SKIP_PACKED_ROWS.inc(sk - self._skip_packed_mark)
            self._skip_packed_mark = sk
        return max(0, delta)

    def _account_native(self) -> None:
        # ALWAYS advance the watermark — billing gated after.  Skipping
        # the take while the kill switch is off would leave the mark
        # stale, and re-enabling would bill the entire disabled period's
        # busy time to one call in a single bogus spike.
        delta = self.take_busy_ns()
        if usage.enabled():
            usage.add_native(self.usage_label(), delta * 1e-9)

    def _pull_trace_stats(self, force: bool = False) -> None:
        """Drain the C++ recorder aggregates into the metrics registry:
        counter deltas vs the per-pool watermark, one sampled histogram
        observation per pull window.  Callers race (the device-loop
        serve path vs scrape threads via flight_payload), and the
        read-delta-inc sequence is NOT atomic under the GIL (trace_stats
        releases it inside ctypes) — _trace_pull_lock serializes the
        watermark; a contended caller just skips (the winner already
        drained the same deltas)."""
        if not force and not _TRACE_ON:
            return
        if not self._trace_pull_lock.acquire(blocking=False):
            return
        try:
            self._pull_trace_stats_locked()
        finally:
            self._trace_pull_lock.release()

    def _pull_trace_stats_locked(self) -> None:
        try:
            s = self._pool.trace_stats()
        except Exception:
            return
        prev, self._trace_marks = self._trace_marks, s
        if prev is None:
            return
        d_spin = s["spin_ns"] - prev["spin_ns"]
        d_yield = s["yield_ns"] - prev["yield_ns"]
        d_park = s["park_ns"] - prev["park_ns"]
        if d_spin > 0:
            _C_DISP_SPIN.inc(d_spin * 1e-9)
        if d_yield > 0:
            _C_DISP_YIELD.inc(d_yield * 1e-9)
        if d_park > 0:
            _C_DISP_PARK.inc(d_park * 1e-9)
        d_caller = s["caller_units"] - prev["caller_units"]
        if d_caller > 0:
            _C_CALLER_UNITS.inc(d_caller)
        d_drop = s["dropped"] - prev["dropped"]
        if d_drop > 0:
            _C_TRACE_DROPPED.inc(d_drop)
        d_calls = s["dispatch_calls"] - prev["dispatch_calls"]
        if d_calls > 0:
            d_wait = s["dispatch_wait_ns"] - prev["dispatch_wait_ns"]
            _H_DISP_WAIT.observe(max(0.0, d_wait / d_calls) * 1e-9)
            _H_UNIT_IMBALANCE.observe(float(s["last_unit_imbalance"]))
        for key, v in s["reps"].items():
            dv = v - prev["reps"].get(key, 0)
            if dv > 0:
                rung, shape = key
                _C_UNITS.labels(rung=rung, shape=shape).inc(dv)
                # first-class per-rung tick counter: the same reps
                # aggregate summed across shapes, so ladder coverage is
                # one PromQL query instead of an exemplar join
                _C_TICK_RUNG.labels(rung=rung).inc(dv)

    def _note_trace_call(self, t0: float, t1: float) -> None:
        """Per-serve-call recorder bookkeeping: the correlation window
        (only when request traces are active — an untraced call costs
        one lambda call) and the throttled stats pull."""
        if not _TRACE_ON:
            return
        ids = self.active_trace_ids()
        if ids:
            self._call_windows.append((t0, t1, tuple(ids)))
        if t1 - self._trace_last_pull >= 0.05:
            self._trace_last_pull = t1
            self._pull_trace_stats()

    def _to_dict(self, state: NetworkState) -> dict:
        return state_arrays(state)

    def _to_state(self, d: dict) -> NetworkState:
        # the int32 tensors share the dict's arrays, which the next trusted
        # call writes in place: the master keeps only the newest state,
        # and every reader that keeps one (snapshot, checkpoint, capture
        # anchor, registry park) copies it
        return state_of(d)

    def validate_state(self, state: NetworkState) -> None:
        """Raise ValueError on a state this engine cannot execute (pc beyond
        the program, stack_top beyond capacity, broken ring counters) —
        a zero-tick idle round trip; importing IS the validation.  Runs on
        the pool's stateless scratch interpreters, so an armed resident
        state is never touched (a restore whose validation fails must
        leave the live network serving its current state)."""
        self._pool.idle(self._to_dict(state), 0)

    def export_resident(self, anchor=None) -> NetworkState | None:
        """Materialize the in-C++ resident state into a fresh NetworkState
        and re-anchor the identity cache on it (residency stays armed, so
        the next serve with the returned state is still a resident hit).
        None when residency is not armed — the caller's state object is
        already authoritative.  `anchor` (the caller's current state
        object) gates the export: when given and NOT the identity anchor,
        the resident copy is superseded by a lifecycle replacement and
        None is returned (exporting would clobber the fresh state).
        MasterNode calls this before any path that READS state content:
        checkpoint, snapshot/restore, autogrow, /status, the loop's boot
        counters."""
        if self._closed or (anchor is not None and anchor is not self._last_state):
            return None
        d = self._pool.export_state()
        if d is None:
            return None
        _C_RES_EXPORT.inc()
        st = self._to_state(d)
        self._last_state, self._last_dict = st, d
        return st

    def consume_progress(self):
        """Per-replica progress flags ([B] uint8) from the last resident
        serve/idle — the device loop's hot-set signal; None when the last
        call went down the stateless path (the loop falls back to
        exported retired deltas)."""
        return self._progress

    def _serve_resident(self, state, values, counts, ticks, active):
        """The resident fast path: serve on the in-C++ state with no
        import/export.  Returns (packed, progress), or None when this
        call cannot be served resident (import validation refused the
        state) — the caller falls back to the stateless ladder."""
        pool = self._pool
        if state is self._last_state and pool.is_resident():
            _C_RES_HIT.inc()
            _res_events["hit"] += 1
        else:
            # a lifecycle path replaced the state: the resident copy (if
            # any) is superseded — discard and re-arm from the new state
            pool.discard_resident()
            if not pool.import_state(self._to_dict(state)):
                return None
            _C_RES_MISS.inc()
            _res_events["miss"] += 1
        # reuse_out: the pool hands back the same packed/progress buffers
        # every call, enabling quiescent pack-row elision.  The
        # device loop's consumption pattern is compatible: it re-reads
        # `packed` after every call and copies what survives the
        # iteration (drain_from_snapshot fancy-indexes into new arrays).
        return pool.serve_resident(values, counts, ticks, active=active,
                                   reuse_out=True)

    def _stateless_input(self, state):
        """(trusted, d_in) for the stateless ladder.  If residency is
        armed on this state's identity, the state object's arrays are
        STALE — export the authoritative copy first and serve trusted on
        it (the resident_fallback chaos point and the kill switch land
        here)."""
        pool = self._pool
        if pool.is_resident():
            if state is self._last_state:
                d = pool.export_state()
                if d is not None:
                    _C_RES_FALLBACK.inc()
                    pool.discard_resident()
                    self._last_dict = d
                    return True, d
            pool.discard_resident()
        trusted = state is self._last_state and self._last_dict is not None
        return trusted, (self._last_dict if trusted else self._to_dict(state))

    def _resident_ok(self) -> bool:
        return self._resident and faults.fire("resident_fallback") is None

    def serve(self, state: NetworkState, values, counts,
              num_steps: int | None = None, active=None):
        """serve_fn twin: feed counts[b] leading entries of values[b] into
        replica b, advance the chunk, return (state, packed [B, 4+out_cap])
        with the returned state's output rings drained.

        `active` (optional, strictly increasing replica indices covering
        every fed replica) is the partial-fill fast path: only those
        replicas tick — an underfilled pass pays for the replicas doing
        work, not the whole batch (cinterp.NativePool.serve).

        Resident fast path: on the trusted-identity path the state
        stays in C++ — the returned state is the SAME object handed in
        (its array contents are stale; export_resident materializes them
        for lifecycle reads) and the packed rows carry everything the
        device loop consumes per chunk."""
        t0 = time.perf_counter()
        ticks = self._chunk if num_steps is None else num_steps
        res = self._serve_resident(state, values, counts, ticks, active) \
            if self._resident_ok() else None
        if res is not None:
            packed, self._progress = res
            new_state = state
            self._last_state = state
        else:
            trusted, d_in = self._stateless_input(state)
            d, packed = self._pool.serve(
                d_in, values, counts, ticks, active=active, trusted=trusted,
            )
            new_state = self._to_state(d)
            self._last_state, self._last_dict = new_state, d
            self._progress = None
        out = new_state, packed
        self._account_native()
        _C_CALLS_POOL.inc()
        dur = time.perf_counter() - t0
        _H_SERVE_POOL.observe(dur)
        self._note_trace_call(t0, t0 + dur)
        # native-tier flight-recorder event (one deque append): the pool
        # call underlying a fused pass, visible in GET /debug/perfetto
        tracespan.note_tier(
            "native.tick",
            dur,
            attrs={"replicas": self._replicas if active is None
                   else int(len(active))},
        )
        self._last_fill = (
            float((np.asarray(counts) > 0).sum()) / max(1, self._replicas)
        )
        return out

    def idle(self, state: NetworkState, num_steps: int | None = None,
             active=None):
        """idle_fn twin: advance the chunk with no feed, return
        (state, ctrs [B, 4]); output rings left undrained.  `active`
        restricts the pass to the given replica indices (partial fill).
        Same resident fast path as serve()."""
        t0 = time.perf_counter()
        ticks = self._chunk if num_steps is None else num_steps
        res = self._serve_resident(state, None, None, ticks, active) \
            if self._resident_ok() else None
        if res is not None:
            ctrs, self._progress = res
            new_state = state
            self._last_state = state
        else:
            trusted, d_in = self._stateless_input(state)
            d, ctrs = self._pool.idle(
                d_in, ticks, active=active, trusted=trusted,
            )
            new_state = self._to_state(d)
            self._last_state, self._last_dict = new_state, d
            self._progress = None
        out = new_state, ctrs
        self._account_native()
        _C_CALLS_IDLE.inc()
        t1 = time.perf_counter()
        _H_SERVE_IDLE.observe(t1 - t0)
        self._note_trace_call(t0, t1)
        return out
