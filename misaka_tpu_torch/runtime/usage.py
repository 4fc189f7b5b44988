"""Per-program resource accounting: who is spending this box's time.

The port's copy of misaka_tpu/runtime/usage.py, with the same accounts,
series, payloads and signed export lines, so the two packages' ledgers
compare field by field and an export signed by one verifies in the other.

Four accumulators per program (label = the registry program name; the
single-program surface accounts under "default"):

  requests / values   what entered the compute lanes
  cpu_seconds         serve-pass wall time (the scheduler's fused passes
                      and the direct lanes' submit-and-collect windows),
                      billed to the program the pass served: the sum over
                      programs equals misaka_serve_pass_wall_seconds_total,
                      the anchor the pass sites accumulate on their own
  native_seconds      MEASURED time in the native host tier's C++ pool
                      (the busy-ns counters of csrc/native/interpreter.cpp,
                      core/native_serve.py) or, unbatched, the wall time of
                      the interpreter call on the calling thread
  queue_seconds       time requests waited ahead of their first dispatch
                      (scheduler queue delay and direct-lane slot waits)

Surfaces: GET /debug/usage (`debug_payload`), the `usage` block of each
program in GET /programs (runtime/registry.py), the `misaka_usage_*`
series, GET /usage/export (`export_lines`: HMAC-signed JSONL when
MISAKA_USAGE_SECRET or the plane secret is set) and the edge's `cpu`
quota stage (runtime/edge.py reads `account(label).cpu_seconds`).  The
synthetic canary books under `_canary`, exempt from the cardinality
collapse and left out of every export (EXEMPT_LABELS), while the
conservation totals cover it.

The durable ledger (MISAKA_TSDB_DIR, `ensure_spool`): a flusher thread
appends cumulative per-program frames (the live accounts plus the base
reloaded from the previous process) to utils/spool.py segments under
<dir>/usage, so a restart, even a kill -9, never makes an exported
number go back; the pass-wall anchor rides the same frames.  An export
is then one period per pair of retained frames.  Unset (or
MISAKA_USAGE_SPOOL=0), an export is the one process-lifetime period.

The module also owns the per-request program context (a contextvar the
registry lease sets): utils/jsonlog.py writes `current_program()` as
`program` on every line logged meanwhile.

Kill switch: MISAKA_USAGE=0 makes every record call a no-op.  Stdlib
only, as utils/metrics.py.
"""

from __future__ import annotations

import contextlib
import contextvars
import hmac
import json
import os
import threading
import time

from misaka_tpu_torch.utils import metrics

DEFAULT_LABEL = "default"

# Accounts that always resolve verbatim, cardinality cap or not: the
# synthetic canary (runtime/canary.py) books its probes here, so no real
# tenant is billed for them and exports drop the account by name.
EXEMPT_LABELS = ("_canary",)

# One counter family per accumulator; children resolved once per account.
M_USAGE_REQS = metrics.counter(
    "misaka_usage_requests_total",
    "Compute requests accounted to a program by the usage ledger",
    ("program",),
)
M_USAGE_VALUES = metrics.counter(
    "misaka_usage_values_total",
    "Values accounted to a program by the usage ledger",
    ("program",),
)
M_USAGE_CPU = metrics.counter(
    "misaka_usage_cpu_seconds_total",
    "Fused-pass wall seconds attributed to a program (slot-share split; "
    "sums across programs to misaka_serve_pass_wall_seconds_total)",
    ("program",),
)
M_USAGE_NATIVE = metrics.counter(
    "misaka_usage_native_seconds_total",
    "Measured C++-pool busy seconds attributed to a program (from the "
    "native per-thread busy-ns counters)",
    ("program",),
)
M_USAGE_QUEUE = metrics.counter(
    "misaka_usage_queue_seconds_total",
    "Seconds requests of a program waited ahead of first dispatch "
    "(scheduler queue delay + direct-lane slot waits)",
    ("program",),
)
# The conservation anchor, accumulated at the pass sites themselves (not
# derived from the per-program splits: the tests compare the two).
M_PASS_SECONDS = metrics.counter(
    "misaka_serve_pass_wall_seconds_total",
    "Total wall seconds of fused serve passes (all programs; the "
    "conservation anchor for misaka_usage_cpu_seconds_total)",
)

FIELDS = ("requests", "values", "cpu_seconds", "native_seconds", "queue_seconds")


class _Account:
    """One program's accumulators and its metric children (resolved by
    `account`, under the cardinality guard)."""

    __slots__ = ("label", "requests", "values", "cpu_seconds", "native_seconds",
                 "queue_seconds", "_lock", "_m_reqs", "_m_values", "_m_cpu", "_m_native",
                 "_m_queue")

    def __init__(self, label: str, children):
        self.label = label
        self.requests = 0
        self.values = 0
        self.cpu_seconds = 0.0
        self.native_seconds = 0.0
        self.queue_seconds = 0.0
        self._lock = threading.Lock()
        self._m_reqs, self._m_values, self._m_cpu, self._m_native, self._m_queue = children

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "requests": self.requests,
                "values": self.values,
                "cpu_seconds": round(self.cpu_seconds, 6),
                "native_seconds": round(self.native_seconds, 6),
                "queue_seconds": round(self.queue_seconds, 6),
            }


_lock = threading.Lock()
_accounts: dict[str, _Account] = {}
_ENABLED = True


def configure(environ=os.environ) -> None:
    """(Re-)read MISAKA_USAGE (the kill switch; default on)."""
    global _ENABLED
    _ENABLED = environ.get("MISAKA_USAGE", "1") != "0"


configure()


def enabled() -> bool:
    return _ENABLED


def account(program: str | None) -> _Account:
    """The ledger for `program` (None -> "default"), created within the
    cardinality budget: past MISAKA_USAGE_LABEL_MAX labels new programs
    collapse into "other" (metrics.capped_label), EXEMPT_LABELS never."""
    label = program or DEFAULT_LABEL
    acct = _accounts.get(label)
    if acct is not None:
        return acct
    with _lock:
        label = metrics.capped_label(_accounts, label, metrics.tenant_label_budget(),
                                     exempt=EXEMPT_LABELS)
        acct = _accounts.get(label)
        if acct is None:
            acct = _accounts[label] = _Account(label, (
                M_USAGE_REQS.labels(program=label), M_USAGE_VALUES.labels(program=label),
                M_USAGE_CPU.labels(program=label), M_USAGE_NATIVE.labels(program=label),
                M_USAGE_QUEUE.labels(program=label)))
    return acct


def add_request(program: str | None, values: int) -> None:
    if not _ENABLED:
        return
    a = account(program)
    with a._lock:
        a.requests += 1
        a.values += int(values)
    a._m_reqs.inc()
    a._m_values.inc(values)


def add_cpu(program: str | None, seconds: float) -> None:
    """One pass's wall time, billed to the program it served."""
    if not _ENABLED or seconds <= 0:
        return
    a = account(program)
    with a._lock:
        a.cpu_seconds += seconds
    a._m_cpu.inc(seconds)


def add_native(program: str | None, seconds: float) -> None:
    """Measured C++-pool busy time (busy-ns counter delta) for one of
    this program's engine calls."""
    if not _ENABLED or seconds <= 0:
        return
    a = account(program)
    with a._lock:
        a.native_seconds += seconds
    a._m_native.inc(seconds)


def add_queue(program: str | None, seconds: float) -> None:
    if not _ENABLED or seconds <= 0:
        return
    a = account(program)
    with a._lock:
        a.queue_seconds += seconds
    a._m_queue.inc(seconds)


def note_pass(seconds: float) -> None:
    """One pass's total wall time into the conservation anchor (called at
    the pass site, apart from the per-program split)."""
    if not _ENABLED or seconds <= 0:
        return
    M_PASS_SECONDS.inc(seconds)


def pass_seconds_total() -> float:
    return M_PASS_SECONDS.value


def snapshot() -> dict[str, dict]:
    """{program: accumulators} for every program the ledger has seen."""
    with _lock:
        accounts = list(_accounts.values())
    return {a.label: a.snapshot() for a in accounts}


def program_snapshot(program: str) -> dict | None:
    """One program's accumulators, or None when it never served (a
    listing must not mint ledger entries for idle programs)."""
    a = _accounts.get(program)
    return a.snapshot() if a is not None else None


def reset() -> None:
    """Tests: wipe the ledger (the counters keep their process totals)."""
    with _lock:
        _accounts.clear()


def debug_payload() -> dict:
    """The GET /debug/usage body (with the durable ledger armed, its
    restart-spanning `cumulative` view too)."""
    programs = snapshot()
    payload = {
        "enabled": _ENABLED,
        "programs": programs,
        "pass_seconds_total": round(pass_seconds_total(), 6),
        "cpu_seconds_total": round(sum(p["cpu_seconds"] for p in programs.values()), 6),
    }
    if _spool is not None:
        payload["cumulative"] = cumulative_snapshot()
    try:
        # the live native pools' measured busy/idle split (None when no
        # pool is serving); imported here: this module stays stdlib-only
        # for every process that never runs a native engine
        from misaka_tpu_torch.core import native_serve

        pool = native_serve.pool_counters()
        if pool is not None:
            payload["native_pool"] = pool
    except Exception:  # the ledger must always answer
        pass
    return payload


# --- the durable ledger -------------------------------------------------------

M_USAGE_SPOOL_DROPPED = metrics.counter(
    "misaka_usage_spool_dropped_total",
    "Usage ledger spool segments evicted by the MISAKA_USAGE_DISK_MB "
    "budget (billing periods older than the retained window are lost)",
)


class UsageExportError(RuntimeError):
    """Unusable or tampered usage export content."""


_spool = None  # utils/spool.SegmentSpool once armed
_spool_lock = threading.Lock()
_base: dict[str, dict] = {}
_pass_base = 0.0
# the live values when the spool armed: cumulative = base + (live -
# offset), so what other servers of this process booked before is never
# counted twice against the reloaded base
_live_offset: dict[str, dict] = {}
_pass_offset = 0.0
_last_flushed: tuple | None = None
_flush_stop: threading.Event | None = None


def cumulative_snapshot() -> dict:
    """The monotone counters an export publishes: the base reloaded from
    the previous process plus the live accrual since the spool armed."""
    live = snapshot()
    programs: dict[str, dict] = {}
    for label in set(_base) | set(live):
        b = _base.get(label) or {}
        v = live.get(label) or {}
        o = _live_offset.get(label) or {}
        programs[label] = {
            f: round(float(b.get(f, 0)) + max(0.0, float(v.get(f, 0)) - float(o.get(f, 0))), 6)
            for f in FIELDS
        }
    return {
        "programs": programs,
        "pass_wall_seconds": round(_pass_base + max(0.0, pass_seconds_total() - _pass_offset), 6),
    }


def spool_dir(environ=os.environ) -> str | None:
    """<MISAKA_TSDB_DIR>/usage, or None (unset, or MISAKA_USAGE_SPOOL=0)."""
    root = environ.get("MISAKA_TSDB_DIR")
    if not root or environ.get("MISAKA_USAGE_SPOOL", "1") == "0":
        return None
    return os.path.join(root, "usage")


def ensure_spool(environ=os.environ):
    """Arm the durable ledger (idempotent; None when MISAKA_TSDB_DIR is
    unset): reload the newest retained frame as the cumulative base,
    write a boot frame, start the flusher (MISAKA_USAGE_FLUSH_S)."""
    global _spool, _pass_base, _pass_offset, _flush_stop
    d = spool_dir(environ)
    if d is None or not _ENABLED:
        return None
    with _spool_lock:
        if _spool is not None:
            return _spool
        from misaka_tpu_torch.utils import spool as spool_mod
        from misaka_tpu_torch.utils.tsdb import env_float

        sp = spool_mod.SegmentSpool(
            d, prefix="usage",
            budget_bytes=int(env_float(environ, "MISAKA_USAGE_DISK_MB", 16.0) * (1 << 20)),
            segment_bytes=int(env_float(environ, "MISAKA_USAGE_SEG_KB", 256.0) * 1024),
            on_evict=M_USAGE_SPOOL_DROPPED.inc,
            on_error=lambda: spool_mod.M_SPOOL_ERRORS.labels(plane="usage").inc(),
        )
        last: list = [None]

        def _keep_last(frame):
            if frame.get("k") == "usage":
                last[0] = frame

        sp.reload(_keep_last)
        if last[0] is not None:
            _base.clear()
            for label, row in (last[0].get("programs") or {}).items():
                _base[str(label)] = {f: float(row.get(f, 0)) for f in FIELDS}
            _pass_base = float(last[0].get("pass_wall", 0.0))
        _live_offset.clear()
        _live_offset.update(snapshot())
        _pass_offset = pass_seconds_total()
        _spool = sp
        _flush_stop = threading.Event()
        interval = max(0.05, env_float(environ, "MISAKA_USAGE_FLUSH_S", 15.0))
        threading.Thread(target=_flush_loop, args=(_flush_stop, interval),
                         daemon=True, name="misaka-usage-spool").start()
    flush_now(force=True)  # the boot frame: the first period's baseline
    return _spool


def _flush_loop(stop: threading.Event, interval: float) -> None:
    while not stop.wait(interval):
        try:
            flush_now()
        except Exception:  # pragma: no cover -- a flush must never take the process down
            pass


def flush_now(force: bool = False) -> bool:
    """Append one cumulative frame and fsync.  A frame equal to the last
    is elided (an idle box must not grow its ledger) unless `force` (the
    boot frame; an export, which must include the accrual up to the
    call)."""
    global _last_flushed
    with _spool_lock:
        if _spool is None:
            return False
        snap = cumulative_snapshot()
        fingerprint = (
            snap["pass_wall_seconds"],
            tuple(sorted((p, row["requests"], row["cpu_seconds"])
                         for p, row in snap["programs"].items())),
        )
        if not force and fingerprint == _last_flushed:
            return False
        _last_flushed = fingerprint
        _spool.append({"k": "usage", "t": round(time.time(), 3),
                       "pass_wall": snap["pass_wall_seconds"], "programs": snap["programs"]})
        _spool.flush()
        return True


def shutdown_spool() -> None:
    """Tests: stop the flusher and drop the armed spool and its bases."""
    global _spool, _pass_base, _pass_offset, _last_flushed, _flush_stop
    with _spool_lock:
        if _flush_stop is not None:
            _flush_stop.set()
            _flush_stop = None
        if _spool is not None:
            _spool.close()
            _spool = None
        _base.clear()
        _live_offset.clear()
        _pass_base = 0.0
        _pass_offset = 0.0
        _last_flushed = None


# --- exports ------------------------------------------------------------------


def export_secret(environ=os.environ) -> bytes | None:
    """The HMAC key of export lines: MISAKA_USAGE_SECRET, else the plane
    secret (MISAKA_PLANE_SECRET / _FILE).  None: lines go out unsigned."""
    s = environ.get("MISAKA_USAGE_SECRET") or environ.get("MISAKA_PLANE_SECRET")
    if s:
        return s.encode()
    p = environ.get("MISAKA_PLANE_SECRET_FILE")
    if p:
        try:
            with open(p, "rb") as f:
                return f.read().strip() or None
        except OSError:
            return None
    return None


def _canonical(obj: dict) -> bytes:
    return json.dumps({k: v for k, v in obj.items() if k != "sig"},
                      sort_keys=True, separators=(",", ":")).encode()


def sign_line(obj: dict, secret: bytes) -> dict:
    obj["sig"] = hmac.new(secret, _canonical(obj), "sha256").hexdigest()
    return obj


def verify_line(obj: dict, secret: bytes) -> bool:
    sig = obj.get("sig")
    if not isinstance(sig, str):
        return False
    want = hmac.new(secret, _canonical(obj), "sha256").hexdigest()
    return hmac.compare_digest(sig, want)


def export_lines(since: float = 0.0, environ=os.environ) -> list[dict]:
    """The GET /usage/export body: one delta line per (period, program)
    between consecutive retained frames with end > `since`, then one
    cumulative totals line; signed when a secret is configured.  With no
    spool armed, the one process-lifetime period.  EXEMPT_LABELS stay
    out of the lines and inside the totals' cpu_seconds_total."""
    frames: list[dict] = []
    with _spool_lock:
        sp = _spool
    if sp is not None:
        flush_now(force=True)
        sp.read_frames(lambda fr: frames.append(fr) if fr.get("k") == "usage" else None)
    if not frames:
        snap = cumulative_snapshot()
        frames = [
            {"t": 0.0, "pass_wall": 0.0, "programs": {}},
            {"t": round(time.time(), 3), "pass_wall": snap["pass_wall_seconds"],
             "programs": snap["programs"]},
        ]
    lines: list[dict] = []
    for prev, cur in zip(frames, frames[1:]):
        t1 = float(cur.get("t", 0.0))
        if t1 <= since:
            continue
        t0 = float(prev.get("t", 0.0))
        prev_p = prev.get("programs") or {}
        for label, row in sorted((cur.get("programs") or {}).items()):
            if label in EXEMPT_LABELS:
                continue  # probe traffic is not billable tenant usage
            before = prev_p.get(label) or {}
            deltas = {f: round(max(0.0, float(row.get(f, 0)) - float(before.get(f, 0))), 6)
                      for f in FIELDS}
            if not any(deltas.values()):
                continue
            lines.append({
                "kind": "period", "start": round(t0, 3), "end": round(t1, 3),
                "program": label, **deltas,
                "cumulative": {f: float(row.get(f, 0)) for f in FIELDS},
            })
    last = frames[-1]
    programs = {
        label: {f: float(row.get(f, 0)) for f in FIELDS}
        for label, row in sorted((last.get("programs") or {}).items())
        if label not in EXEMPT_LABELS
    }
    lines.append({
        "kind": "totals",
        "asof": round(float(last.get("t", 0.0)), 3),
        "pass_wall_seconds": round(float(last.get("pass_wall", 0.0)), 6),
        "cpu_seconds_total": round(sum(float(row.get("cpu_seconds", 0))
                                       for row in (last.get("programs") or {}).values()), 6),
        "programs": programs,
    })
    secret = export_secret(environ)
    if secret is not None:
        for obj in lines:
            sign_line(obj, secret)
    return lines


def totals_from_lines(lines, secret: bytes | None = None) -> dict:
    """Aggregate export lines (the usage-report CLI's core): verifies
    every period and totals line when a secret is given (UsageExportError
    on the first tampered one), sums period deltas per program, and
    carries the newest cumulative totals through."""
    deltas: dict[str, dict] = {}
    totals: dict | None = None
    periods = 0
    for i, obj in enumerate(lines):
        kind = obj.get("kind")
        if kind not in ("period", "totals"):
            continue  # envelope lines pass through
        if secret is not None and not verify_line(obj, secret):
            raise UsageExportError(
                f"line {i} ({kind}) failed HMAC verification — tampered "
                f"or signed with a different secret"
            )
        if kind == "period":
            periods += 1
            row = deltas.setdefault(obj.get("program") or DEFAULT_LABEL,
                                    {f: 0.0 for f in FIELDS})
            for f in FIELDS:
                row[f] += float(obj.get(f, 0))
        elif totals is None or float(obj.get("asof", 0)) >= float(totals.get("asof", 0)):
            totals = obj
    return {
        "verified": secret is not None,
        "periods": periods,
        "programs": {p: {f: round(v, 6) for f, v in row.items()}
                     for p, row in sorted(deltas.items())},
        "cumulative": (totals or {}).get("programs") or {},
        "pass_wall_seconds": float((totals or {}).get("pass_wall_seconds", 0.0)),
        "cpu_seconds_total": float((totals or {}).get("cpu_seconds_total", 0.0)),
    }


# --- the per-request program context (jsonlog's `program` field) ------------

_current: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "misaka_program", default=None
)


def current_program() -> str | None:
    """The program the emitting thread is serving (set by the registry
    lease), or None."""
    return _current.get()


@contextlib.contextmanager
def program_scope(program: str | None):
    """Make `program` current for a request's lifetime (no-op on None)."""
    if program is None:
        yield
        return
    token = _current.set(program)
    try:
        yield
    finally:
        _current.reset(token)
