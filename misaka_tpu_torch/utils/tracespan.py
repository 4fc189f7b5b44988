"""Per-request tracing: trace IDs, span trees, and a bounded in-memory
flight recorder with Perfetto export.

The port's own copy of misaka_tpu/utils/tracespan.py (stdlib only).  Every
request entering an HTTP route gets a trace ID (an inbound
``X-Misaka-Trace`` header is honored, otherwise one is minted) and a list
of spans with monotonic start/duration, recorded into a ring of the last N
completed traces plus a reservoir of the slowest K.  The recorder exports
as Chrome trace-event JSON (``GET /debug/perfetto``) with one "process"
per tier.

Span catalog (the tier is the name's dotted prefix).  The port records:

  http.parse          request line + headers parsed (fast parser)
  serve.queue         wait in the serve scheduler before first dispatch
                      (the slot-lock wait on the direct lanes)
  serve.pass          one engine pass serving this request (ServeBatcher),
                      or the submit+collect window on the direct
                      compute_many/compute_spread lanes
  engine.chunk        one busy device-loop iteration (tier event: the loop
                      serves many requests at once)

The other tiers of the catalog (frontend, plane, native, rpc) belong to
planes the port has not taken yet; their pids stay reserved so exports of
both packages line up.

Cost: spans append to per-trace lists and completed traces swap into the
ring under one short lock; everything no-ops on a None trace.
``MISAKA_TRACE_SAMPLE`` (default 1.0) thins root traces, and
``MISAKA_TRACE_REQUESTS=0`` turns ``begin`` into a constant ``return None``.
"""

from __future__ import annotations

import contextlib
import contextvars
import heapq
import itertools
import os
import random
import re
import threading
import time
from collections import deque

# The header carrying the trace ID on every HTTP hop (inbound honored,
# outbound always set on traced responses); lowercase twin for gRPC
# metadata keys, which grpc requires to be lowercase.
TRACE_HEADER = "X-Misaka-Trace"
RPC_METADATA_KEY = "x-misaka-trace"

# Inbound IDs are attacker-controlled (an unauthenticated header): accept
# only a short hex/dash token so the recorder and logs can't be made to
# store arbitrary bytes.
_ID_RE = re.compile(r"^[0-9a-zA-Z-]{4,64}$")

# Tier -> Perfetto pid.  Stable small ints so exports from different
# rounds diff cleanly; unknown prefixes collapse to "other".
TIER_PIDS = {
    "http": 1, "frontend": 2, "plane": 3, "serve": 4,
    "engine": 5, "native": 6, "rpc": 7, "other": 8,
}


def tier_of(name: str) -> str:
    t = name.split(".", 1)[0]
    return t if t in TIER_PIDS else "other"


class Span:
    """One timed operation inside a trace: monotonic start + duration.

    ``start`` is time.monotonic() seconds (CLOCK_MONOTONIC — comparable
    across processes on one host, which is what lets the frontend forward
    its spans to the engine over the plane with no clock translation)."""

    __slots__ = ("name", "start", "dur", "attrs")

    def __init__(self, name: str, start: float, dur: float, attrs=None):
        self.name = name
        self.start = start
        self.dur = dur
        self.attrs = attrs

    def to_dict(self, base: float) -> dict:
        d = {
            "name": self.name,
            "tier": tier_of(self.name),
            "start_ms": round((self.start - base) * 1e3, 3),
            "dur_ms": round(self.dur * 1e3, 3),
        }
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class Trace:
    """One request's span collection.

    Spans are appended with ``list.append`` from whichever thread served
    part of the request (handler thread, batcher worker) — atomic under
    the GIL, so the hot path takes no lock; the one short recorder lock
    runs at completion only."""

    __slots__ = ("trace_id", "route", "status", "start_mono", "start_unix",
                 "dur", "spans", "inbound", "_token")

    def __init__(self, trace_id: str, route: str | None = None):
        self.trace_id = trace_id
        self.route = route
        self.status: int | None = None
        self.start_mono = time.monotonic()
        self.start_unix = time.time()
        self.dur: float | None = None  # set at end()
        self.spans: list[Span] = []
        self.inbound = False  # ID honored from the request (vs minted) —
        # the capture plane's sampling bypass rides on this
        self._token = None  # contextvar reset token (activating begin only)

    def add(self, name: str, start: float, dur: float, attrs=None) -> None:
        self.spans.append(Span(name, start, dur, attrs))

    @property
    def duration_ms(self) -> float:
        dur = self.dur if self.dur is not None \
            else time.monotonic() - self.start_mono
        return round(dur * 1e3, 3)

    def summary(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "route": self.route,
            "status": self.status,
            "start_unix": round(self.start_unix, 3),
            "duration_ms": self.duration_ms,
            "spans": len(self.spans),
        }

    def to_dict(self) -> dict:
        d = self.summary()
        d["spans"] = [s.to_dict(self.start_mono) for s in self.spans]
        return d


class FlightRecorder:
    """Bounded storage for completed traces: a ring of the last N plus a
    min-heap reservoir of the slowest K (so the request worth debugging
    is still there after N fast ones pushed it out of the ring).  One
    short lock guards the swap; readers copy under it."""

    def __init__(self, ring: int = 256, slowest: int = 32):
        self._lock = threading.Lock()
        self._seq = itertools.count()  # heap tiebreaker
        self.resize(ring, slowest)

    def resize(self, ring: int, slowest: int) -> None:
        with self._lock:
            self._ring: deque[Trace] = deque(maxlen=max(1, int(ring)))
            self._slow: list[tuple[float, int, Trace]] = []
            self._k = max(1, int(slowest))

    def record(self, trace: Trace) -> None:
        with self._lock:
            self._ring.append(trace)
            item = (trace.dur or 0.0, next(self._seq), trace)
            if len(self._slow) < self._k:
                heapq.heappush(self._slow, item)
            elif item[0] > self._slow[0][0]:
                heapq.heapreplace(self._slow, item)

    def recent(self) -> list[Trace]:
        with self._lock:
            return list(self._ring)

    def slowest(self) -> list[Trace]:
        with self._lock:
            items = list(self._slow)
        return [t for _, _, t in sorted(items, reverse=True)]

    def get(self, trace_id: str) -> Trace | None:
        """The completed trace for an ID — MERGED when several share it:
        one request crossing an in-process hop (frontend tier driven in
        one process, the loopback test cluster) completes once per hop,
        and the union of their spans is the whole story.  In production
        each process holds its own half; its recorder then has exactly
        one."""
        with self._lock:
            matches = [t for t in self._ring if t.trace_id == trace_id]
            matches += [
                t for _, _, t in self._slow
                if t.trace_id == trace_id and t not in matches
            ]
        if not matches:
            return None
        if len(matches) == 1:
            return matches[0]
        return merge_traces(matches)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._slow.clear()


def mem_bytes() -> int:
    """Approximate recorder footprint for the /healthz debug_mem block
    (one budget surface with the native flight rings and the capture
    ring): per-trace object overhead plus ~112 bytes per span."""
    total = 0
    with RECORDER._lock:
        traces = list(RECORDER._ring) + [t for _, _, t in RECORDER._slow]
    for t in traces:
        total += 240 + 112 * len(t.spans)
    return total


def merge_traces(traces: list[Trace]) -> Trace:
    """One Trace unioning several completions of the same ID (dedup by
    (name, start): a span the frontend forwarded over the plane appears
    in both halves)."""
    first = min(traces, key=lambda t: t.start_mono)
    merged = Trace(first.trace_id, route=first.route)
    merged.start_mono = first.start_mono
    merged.start_unix = first.start_unix
    end_mono = max(t.start_mono + (t.dur or 0.0) for t in traces)
    merged.dur = end_mono - first.start_mono
    merged.status = max(
        (t.status for t in traces if t.status is not None), default=None
    )
    seen = set()
    for t in sorted(traces, key=lambda t: t.start_mono):
        for s in t.spans:
            key = (s.name, round(s.start, 6))
            if key not in seen:
                seen.add(key)
                merged.spans.append(s)
    return merged


RECORDER = FlightRecorder()

# Tier events: spans that belong to a TIER rather than one request (a
# device-loop chunk or native-pool call serves many coalesced requests
# at once — attributing it to each would multiply hot-path work).  A
# lock-free bounded deque; merged into the Perfetto export so a fused
# pass visually underlies the request spans stacked above it.
_TIER_EVENTS: deque[Span] = deque(maxlen=1024)

_current: contextvars.ContextVar[Trace | None] = contextvars.ContextVar(
    "misaka_trace", default=None
)

_ENABLED = True
_SAMPLE = 1.0


def configure(environ=os.environ) -> None:
    """(Re-)read the env knobs — called at import; tests and the bench
    A/B call it again after toggling the environment.

      MISAKA_TRACE_REQUESTS=0   kill switch: begin() returns None always
      MISAKA_TRACE_SAMPLE       root-trace sampling rate (default 1.0;
                                inbound-ID requests are always traced —
                                the upstream hop already decided)
      MISAKA_TRACE_RING         completed-trace ring size (default 256)
      MISAKA_TRACE_SLOWEST      slowest-K reservoir size (default 32)
    """
    global _ENABLED, _SAMPLE
    _ENABLED = environ.get("MISAKA_TRACE_REQUESTS", "1") != "0"
    try:
        _SAMPLE = min(1.0, max(0.0, float(
            environ.get("MISAKA_TRACE_SAMPLE", "") or 1.0
        )))
    except ValueError:
        _SAMPLE = 1.0
    # malformed knobs fall back to defaults: configure() runs at import,
    # and a typo'd env var must not take down every process that imports
    # this module (engine, frontend workers, jsonlog)
    try:
        ring = int(environ.get("MISAKA_TRACE_RING", "") or 256)
    except ValueError:
        ring = 256
    try:
        slowest = int(environ.get("MISAKA_TRACE_SLOWEST", "") or 32)
    except ValueError:
        slowest = 32
    RECORDER.resize(ring, slowest)


configure()


def enabled() -> bool:
    return _ENABLED


def mint() -> str:
    # random.getrandbits, not os.urandom: an ID is minted per request on
    # the serving hot path, and urandom is a SYSCALL — a preemption
    # point that measurably stretches closed-loop latency on a saturated
    # box.  Trace IDs need uniqueness, not unpredictability.
    return f"{random.getrandbits(64):016x}"


def sanitize_id(raw) -> str | None:
    """An inbound trace ID, or None when it isn't one we accept."""
    if not raw or not isinstance(raw, str):
        return None
    raw = raw.strip()
    return raw if _ID_RE.match(raw) else None


def begin(trace_id=None, route: str | None = None,
          activate: bool = True) -> Trace | None:
    """Start a trace for one request; returns None when tracing is off or
    the request sampled out (every later call no-ops on None).

    An acceptable inbound ``trace_id`` skips sampling — the upstream hop
    already chose to trace, and dropping its continuation here would
    orphan the cross-hop story.  ``activate=False`` skips the contextvar
    (the compute plane begins several traces per frame; none of them is
    "the" current one for its connection thread)."""
    if not _ENABLED:
        return None
    tid = sanitize_id(trace_id)
    inbound = tid is not None
    if tid is None:
        if _SAMPLE < 1.0 and random.random() >= _SAMPLE:
            return None
        tid = mint()
    trace = Trace(tid, route=route)
    trace.inbound = inbound
    if activate:
        trace._token = _current.set(trace)
    return trace


def end(trace: Trace | None, status: int | None = None) -> None:
    """Finalize + record into the flight recorder (no-op on None)."""
    if trace is None:
        return
    if trace._token is not None:
        try:
            _current.reset(trace._token)
        except ValueError:  # ended from a different context: just clear
            _current.set(None)
        trace._token = None
    if status is not None:
        trace.status = status
    trace.dur = time.monotonic() - trace.start_mono
    RECORDER.record(trace)


def current() -> Trace | None:
    return _current.get()


def current_id() -> str | None:
    t = _current.get()
    return t.trace_id if t is not None else None


@contextlib.contextmanager
def use(trace: Trace | None):
    """Make ``trace`` current for a worker thread's scope."""
    token = _current.set(trace)
    try:
        yield trace
    finally:
        _current.reset(token)


@contextlib.contextmanager
def span(name: str, trace: Trace | None = None, **attrs):
    """Record one timed span into ``trace`` (default: the current trace);
    a cheap no-op when there is none."""
    t = trace if trace is not None else _current.get()
    if t is None:
        yield None
        return
    t0 = time.monotonic()
    try:
        yield t
    finally:
        t.add(name, t0, time.monotonic() - t0, attrs or None)


def add_span(trace: Trace | None, name: str, start: float, dur: float,
             attrs=None) -> None:
    """Explicit-timestamp recording (queue delays measured elsewhere,
    spans forwarded across the plane)."""
    if trace is not None:
        trace.add(name, start, dur, attrs)


def note_tier(name: str, dur: float, start: float | None = None,
              attrs=None) -> None:
    """Record a tier event (see _TIER_EVENTS) — one deque append."""
    if not _ENABLED:
        return
    if start is None:
        start = time.monotonic() - dur
    _TIER_EVENTS.append(Span(name, start, dur, attrs))


def tier_events() -> list[Span]:
    return list(_TIER_EVENTS)


# Pluggable tier sources: subsystems with their OWN event storage (the
# native flight recorder's in-C++ per-thread rings, core/native_serve)
# contribute spans to the Perfetto export at read time instead of
# double-buffering into _TIER_EVENTS.  A source returns a list of Span
# objects; two attrs are interpreted by the exporter: ``_lane`` names a
# per-source timeline lane (one Perfetto thread per distinct lane —
# worker threads read as parallel tracks), and ``trace_ids`` lists the
# request-trace IDs the span served — the span is then ALSO emitted on
# each of those traces' own timelines, which is what makes one trace ID
# read as a single story from http.parse down to the worker-thread unit
# that ticked it.  Registered sources must never raise usefully: the
# exporter swallows per-source failures (a debug surface answers).
_TIER_SOURCES: list = []


def register_tier_source(fn) -> None:
    """Register a callable returning a list of Spans for the Perfetto
    export (idempotent per callable)."""
    if fn not in _TIER_SOURCES:
        _TIER_SOURCES.append(fn)


def clear() -> None:
    """Tests: wipe the recorder and tier events."""
    RECORDER.clear()
    _TIER_EVENTS.clear()


def server_timing(trace: Trace | None) -> str | None:
    """The ``Server-Timing`` response-header value for a trace: queue and
    pass phases summed from the serve spans recorded so far, plus the
    total so far — written while the response headers go out, so `total`
    excludes only the response write itself."""
    if trace is None:
        return None
    queue_s = pass_s = 0.0
    for s in trace.spans:  # one pass; this runs per response
        if s.name == "serve.queue":
            queue_s += s.dur
        elif s.name == "serve.pass":
            pass_s += s.dur
    parts = []
    if queue_s or pass_s:
        parts.append(f"queue;dur={queue_s * 1e3:.3f}")
        parts.append(f"pass;dur={pass_s * 1e3:.3f}")
    parts.append(f"total;dur={trace.duration_ms:.3f}")
    return ", ".join(parts)


def parse_server_timing(value: str) -> dict[str, float]:
    """``"queue;dur=1.2, pass;dur=3.4"`` -> {"queue": 1.2, "pass": 3.4}
    (the client-side half; ignores metrics without a dur)."""
    out: dict[str, float] = {}
    for item in value.split(","):
        name, _, params = item.strip().partition(";")
        for p in params.split(";"):
            k, _, v = p.strip().partition("=")
            if k == "dur":
                try:
                    out[name.strip()] = float(v)
                except ValueError:
                    pass
    return out


def debug_payload() -> dict:
    """The GET /debug/requests body: recent + slowest summaries."""
    return {
        "enabled": _ENABLED,
        "sample": _SAMPLE,
        "recent": [t.summary() for t in reversed(RECORDER.recent())],
        "slowest": [t.summary() for t in RECORDER.slowest()],
    }


def slowest_exemplars(k: int = 3, program: str | None = None) -> list[dict]:
    """Alert exemplars: the slowest completed traces (optionally only
    those whose serve spans billed to `program`), each linking straight
    to its full trace at /debug/requests/<id>.  The /debug/alerts route
    attaches these to SLO pages and watchdog findings, so "p99 is
    burning" comes with the actual requests that burned it."""
    out: list[dict] = []
    for t in RECORDER.slowest():
        if program is not None and not any(
            s.attrs and s.attrs.get("program") == program
            for s in t.spans
        ):
            continue
        out.append({
            "trace_id": t.trace_id,
            "route": t.route,
            "duration_ms": t.duration_ms,
            "href": f"/debug/requests/{t.trace_id}",
        })
        if len(out) >= k:
            break
    return out


def perfetto() -> dict:
    """The whole recorder as Chrome trace-event JSON (the "JSON Array
    Format" both Perfetto and chrome://tracing load).

    Layout: one Perfetto "process" per tier (TIER_PIDS), one "thread"
    per trace inside each tier it touched — so the serve tier shows the
    coalesced requests of one fused pass stacked on top of each other,
    with the engine tier's chunk events running underneath.  Tier events
    ride tid 0 of their tier."""
    events: list[dict] = []
    for tier, pid in TIER_PIDS.items():
        events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": f"tier: {tier}"},
        })
    groups: dict[str, list[Trace]] = {}
    for t in RECORDER.recent() + RECORDER.slowest():
        group = groups.setdefault(t.trace_id, [])
        if t not in group:
            group.append(t)
    tids: dict[str, int] = {}
    for trace_id, group in groups.items():
        t = group[0] if len(group) == 1 else merge_traces(group)
        tid = tids.setdefault(trace_id, len(tids) + 1)
        for pid in {TIER_PIDS[tier_of(s.name)] for s in t.spans}:
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": t.trace_id},
            })
        for s in t.spans:
            ev = {
                "ph": "X",
                "name": s.name,
                "pid": TIER_PIDS[tier_of(s.name)],
                "tid": tid,
                "ts": round(s.start * 1e6, 1),
                "dur": round(s.dur * 1e6, 1),
                "args": {"trace_id": t.trace_id},
            }
            if s.attrs:
                ev["args"].update(s.attrs)
            events.append(ev)
    for s in tier_events():
        ev = {
            "ph": "X",
            "name": s.name,
            "pid": TIER_PIDS[tier_of(s.name)],
            "tid": 0,
            "ts": round(s.start * 1e6, 1),
            "dur": round(s.dur * 1e6, 1),
        }
        if s.attrs:
            ev["args"] = dict(s.attrs)
        events.append(ev)
    # pluggable tier sources (register_tier_source): per-lane timelines
    # plus duplication onto the request traces each span served
    lane_tids: dict[str, int] = {}
    for fn in list(_TIER_SOURCES):
        try:
            spans = fn()
        except Exception:
            continue
        for s in spans:
            attrs = dict(s.attrs) if s.attrs else {}
            lane = attrs.pop("_lane", None)
            trace_ids = attrs.pop("trace_ids", None)
            pid = TIER_PIDS[tier_of(s.name)]
            tid = 0
            if lane is not None:
                tid = lane_tids.get(lane)
                if tid is None:
                    tid = 10001 + len(lane_tids)
                    lane_tids[lane] = tid
                    events.append({
                        "ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": lane},
                    })
            ev = {
                "ph": "X",
                "name": s.name,
                "pid": pid,
                "tid": tid,
                "ts": round(s.start * 1e6, 1),
                "dur": round(s.dur * 1e6, 1),
            }
            if trace_ids:
                attrs["trace_id"] = ",".join(trace_ids)
            if attrs:
                ev["args"] = attrs
            events.append(ev)
            # the same span on each served trace's own timeline: the
            # unified per-trace story (only for traces the export knows)
            for trace_id in trace_ids or ():
                tr_tid = tids.get(trace_id)
                if tr_tid is None:
                    continue
                ev2 = dict(ev)
                ev2["tid"] = tr_tid
                ev2["args"] = dict(attrs)
                ev2["args"]["trace_id"] = trace_id
                events.append(ev2)
    return {"traceEvents": events, "displayTimeUnit": "ms"}
