"""SLO burn-rate engine: sliding-window objectives per program.

The port's copy of misaka_tpu/utils/slo.py: the same grammar, windows,
burn rules, payloads and `misaka_slo_*` series, over the port's own
utils/metrics.py bucket math, so the two packages evaluate the same
observations to the same states and quantiles.

Objectives, the MISAKA_SLO grammar (comma-separated)::

    MISAKA_SLO="p99<25ms,err<0.1%"

  * ``p<NN><T>``  latency: at most (100-NN)% of requests may exceed T
                  (units us, ms, s);
  * ``err<P%``    error rate: at most P% of requests may fail (5xx;
                  4xx are the client's own).

An upload's ``slo`` field (runtime/registry.py) installs a per-program
override when its version becomes ``latest``.

Windows: two ring tiers per program (fine buckets for the two short
windows, coarse for the two long ones), default 10s/1m/5m/1h,
MISAKA_SLO_WINDOWS=10,60,300,3600 to change them.  Burn rate =
bad_fraction / budget, and a rule fires only when both its windows burn::

    page:    burn >= 14.4 over (windows[1] AND windows[0])
    page:    burn >=  6.0 over (windows[2] AND windows[1])
    warning: burn >=  3.0 over (windows[3] AND windows[2])

A window under MISAKA_SLO_MIN_EVENTS requests (default 10) burns 0.
States surface at GET /debug/alerts, in /healthz (`slo`; page raises
`degraded`), in the edge's admission (a page halves the soft watermark)
and as `misaka_slo_*` gauges.  Observations come from the engine's HTTP
handler (compute routes) and from compute-plane frames (per request from
the frontend's edge timestamps).  The synthetic canary's program is never
observed (EXCLUDED_PROGRAMS).  Program cardinality shares
MISAKA_USAGE_LABEL_MAX with the usage ledger.

Disarmed (every observe a no-op) until an objective exists.  Stdlib only.
"""

from __future__ import annotations

import bisect
import logging
import math
import os
import re
import threading
import time

from misaka_tpu_torch.utils import metrics

log = logging.getLogger("misaka_tpu_torch.slo")

# The latency grid: the metrics plane's fixed duration buckets (10us..10s,
# 3/decade) — fixed buckets are what make window sums and cross-program
# aggregation coherent.
UPPERS = metrics.DURATION_BUCKETS

STATES = ("ok", "warning", "page")

# Programs whose traffic NEVER feeds the SLO windows: the synthetic
# canary (runtime/canary.py) deliberately probes through the full public
# stack — including fault drills that make it slow on purpose — and must
# not burn any tenant's error budget while doing it.  Canary failures
# page through the watchdog (utils/watchdog.py) instead.  This is the
# one chokepoint: every entry path (HTTP edge, compute plane) lands in
# observe(), so the exclusion cannot be bypassed by route.
EXCLUDED_PROGRAMS = frozenset({"_canary"})

M_SLO_STATE = metrics.gauge(
    "misaka_slo_state",
    "Per-program SLO state (0 = ok, 1 = warning, 2 = page)",
    ("program",),
)
M_SLO_BURN = metrics.gauge(
    "misaka_slo_burn_rate",
    "Error-budget burn rate per program/objective/window (1.0 = burning "
    "exactly the budget; the page rules fire at 14.4x and 6x)",
    ("program", "objective", "window"),
)
M_SLO_ERR = metrics.gauge(
    "misaka_slo_error_ratio",
    "Observed error ratio per program over each window",
    ("program", "window"),
)
M_SLO_P99 = metrics.gauge(
    "misaka_slo_p99_seconds",
    "Estimated p99 latency per program over each window",
    ("program", "window"),
)


class SLOSpecError(ValueError):
    """Malformed MISAKA_SLO / per-program objective spec."""


_LAT_RE = re.compile(r"^p(\d{1,2}(?:\.\d+)?)<(\d+(?:\.\d+)?)(us|ms|s)$")
_ERR_RE = re.compile(r"^err<(\d+(?:\.\d+)?)%$")
_UNIT = {"us": 1e-6, "ms": 1e-3, "s": 1.0}


class Objective:
    """One declared objective: a bad-event predicate + an error budget."""

    __slots__ = ("name", "kind", "quantile", "threshold_s", "budget")

    def __init__(self, name, kind, budget, quantile=None, threshold_s=None):
        self.name = name            # the spec text, e.g. "p99<25ms"
        self.kind = kind            # "latency" | "error"
        self.budget = budget        # allowed bad fraction, in (0, 1)
        self.quantile = quantile    # latency only: 0.99 for p99
        self.threshold_s = threshold_s  # latency only: seconds


def parse_spec(text: str) -> list[Objective]:
    """``"p99<25ms,err<0.1%"`` -> [Objective, ...] (raises SLOSpecError)."""
    objectives: list[Objective] = []
    for raw in (text or "").split(","):
        item = raw.strip()
        if not item:
            continue
        m = _LAT_RE.match(item)
        if m:
            q = float(m.group(1)) / 100.0
            if not 0.0 < q < 1.0:
                raise SLOSpecError(f"quantile out of range in {item!r}")
            threshold = float(m.group(2)) * _UNIT[m.group(3)]
            if threshold <= 0:
                raise SLOSpecError(f"threshold must be > 0 in {item!r}")
            objectives.append(Objective(item, "latency", budget=1.0 - q, quantile=q,
                                        threshold_s=threshold))
            continue
        m = _ERR_RE.match(item)
        if m:
            budget = float(m.group(1)) / 100.0
            if not 0.0 < budget < 1.0:
                raise SLOSpecError(f"error budget out of range in {item!r}")
            objectives.append(Objective(item, "error", budget=budget))
            continue
        raise SLOSpecError(
            f"cannot parse objective {item!r} (grammar: pNN<T[us|ms|s] or err<P%)"
        )
    return objectives


class _Ring:
    """Fixed-width bucket ring holding (requests, errors, latency counts).

    One tier of a program's sliding windows: `width` seconds per bucket,
    `length` buckets of history.  observe() lands in the bucket for "now";
    sums walk backward from now over ceil(window/width) buckets, skipping
    buckets stale enough to predate the span (the ring is positional —
    each slot carries the epoch it was last reset for, so an idle period
    cannot leak month-old counts into a fresh window)."""

    __slots__ = ("width", "length", "epochs", "reqs", "errs", "lat")

    def __init__(self, width: float, length: int):
        self.width = float(width)
        self.length = int(length)
        self.epochs = [-1] * self.length   # bucket index in absolute time
        self.reqs = [0] * self.length
        self.errs = [0] * self.length
        self.lat = [None] * self.length    # lazily [len(UPPERS)+1] counts

    def _slot(self, now: float) -> int:
        epoch = int(now / self.width)
        i = epoch % self.length
        if self.epochs[i] != epoch:  # rotate: reclaim the stale slot
            self.epochs[i] = epoch
            self.reqs[i] = 0
            self.errs[i] = 0
            self.lat[i] = None
        return i

    def observe(self, now: float, dur_s: float, error: bool) -> None:
        i = self._slot(now)
        self.reqs[i] += 1
        if error:
            self.errs[i] += 1
        counts = self.lat[i]
        if counts is None:
            counts = self.lat[i] = [0] * (len(UPPERS) + 1)
        counts[bisect.bisect_left(UPPERS, dur_s)] += 1

    def window_sum(self, now: float, window_s: float):
        """(requests, errors, lat_counts) over the last `window_s`."""
        n = min(self.length, max(1, math.ceil(window_s / self.width)))
        epoch_now = int(now / self.width)
        reqs = errs = 0
        lat = [0] * (len(UPPERS) + 1)
        for back in range(n):
            epoch = epoch_now - back
            i = epoch % self.length
            if self.epochs[i] != epoch:
                continue  # stale or never-written slot
            reqs += self.reqs[i]
            errs += self.errs[i]
            counts = self.lat[i]
            if counts is not None:
                for j, c in enumerate(counts):
                    if c:
                        lat[j] += c
        return reqs, errs, lat


class _ProgramWindows:
    """Both ring tiers for one program, under one lock."""

    __slots__ = ("lock", "fine", "coarse")

    def __init__(self, windows):
        self.lock = threading.Lock()
        # fine tier: 10 buckets per shortest window, spanning windows[1];
        # coarse tier: 10 per windows[2], spanning windows[3]
        fw = max(windows[0] / 10.0, 0.05)
        cw = max(windows[2] / 10.0, fw)
        self.fine = _Ring(fw, max(2, math.ceil(windows[1] / fw) + 1))
        self.coarse = _Ring(cw, max(2, math.ceil(windows[3] / cw) + 1))

    def observe(self, now, dur_s, error):
        with self.lock:
            self.fine.observe(now, dur_s, error)
            self.coarse.observe(now, dur_s, error)

    def window_sum(self, now, window_s, boundary):
        ring = self.fine if window_s <= boundary else self.coarse
        with self.lock:
            return ring.window_sum(now, window_s)


# (long_window_index, short_window_index, burn_threshold, state):
# both windows must burn past the threshold for the rule to fire.
BURN_RULES = (
    (1, 0, 14.4, "page"),
    (2, 1, 6.0, "page"),
    (3, 2, 3.0, "warning"),
)

_lock = threading.Lock()
_windows: dict[str, _ProgramWindows] = {}
_overrides: dict[str, list[Objective]] = {}
_default_objectives: list[Objective] = []
_spec_error: str | None = None
_WINDOWS: tuple[float, ...] = (10.0, 60.0, 300.0, 3600.0)
_MIN_EVENTS = 10
_eval_cache: dict[str, tuple[float, dict]] = {}


def configure(environ=os.environ) -> None:
    """(Re-)read the env knobs and reset the window state.

      MISAKA_SLO          default objectives (unset + no overrides = the
                          engine is disarmed; observe() is then a no-op)
      MISAKA_SLO_WINDOWS  four ascending second values (default
                          "10,60,300,3600"; tests shrink them)
      MISAKA_SLO_MIN_EVENTS  per-window sample floor below which burn
                          reads 0 (default 10)
    """
    global _default_objectives, _WINDOWS, _MIN_EVENTS, _spec_error
    spec = environ.get("MISAKA_SLO", "")
    _spec_error = None
    try:
        _default_objectives = parse_spec(spec)
    except SLOSpecError as e:
        # a typo'd env var must not take down every importing process —
        # but silently disarming would mean pages that never fire, so the
        # mistake is loud: logged here AND carried on /debug/alerts
        _default_objectives = []
        _spec_error = f"MISAKA_SLO={spec!r}: {e}"
        log.warning("SLO engine DISARMED by a malformed spec — %s",
                    _spec_error)
    raw = environ.get("MISAKA_SLO_WINDOWS", "")
    windows = (10.0, 60.0, 300.0, 3600.0)
    if raw:
        try:
            parsed = tuple(float(x) for x in raw.split(","))
            if len(parsed) == 4 and all(
                0 < a < b for a, b in zip(parsed, parsed[1:])
            ):
                windows = parsed
        except ValueError:
            pass
    _WINDOWS = windows
    try:
        _MIN_EVENTS = max(1, int(environ.get("MISAKA_SLO_MIN_EVENTS", "") or 10))
    except ValueError:
        _MIN_EVENTS = 10
    with _lock:
        _windows.clear()
        _overrides.clear()
        _eval_cache.clear()


configure()


def set_objectives(program: str, spec: str | None) -> None:
    """Install (or clear, spec=None) a per-program objective override —
    the registry calls this when a program's `latest` version moves.

    Bounded by the health plane's shared cardinality cap
    (MISAKA_USAGE_LABEL_MAX): overrides name programs VERBATIM in the
    misaka_slo_* gauge labels and the /debug/alerts walk, so an upload
    flood must not mint unbounded series — past the cap a NEW override
    raises SLOSpecError (replacing an installed one is always allowed;
    the registry surfaces the refusal as a logged warning, the program
    still serves under the env-default objectives)."""
    with _lock:
        if spec:
            cap = metrics.tenant_label_budget()
            if program not in _overrides and len(_overrides) >= cap:
                raise SLOSpecError(
                    f"per-program SLO override budget exhausted "
                    f"({cap} programs, MISAKA_USAGE_LABEL_MAX) — "
                    f"{program!r} keeps the default objectives"
                )
            _overrides[program] = parse_spec(spec)
        else:
            _overrides.pop(program, None)
        _eval_cache.pop(program, None)


def objectives_for(program: str | None) -> list[Objective]:
    label = program or "default"
    return _overrides.get(label, _default_objectives)


def armed() -> bool:
    """True when ANY objective exists — the serving path's cheap gate."""
    return bool(_default_objectives) or bool(_overrides)


def _windows_for(program: str) -> _ProgramWindows:
    w = _windows.get(program)
    if w is not None:
        return w
    with _lock:
        # metrics.capped_label never recurses (resolving "other" by
        # recursing here once self-deadlocked the non-reentrant _lock).
        # A program with an EXPLICIT override is exempt from the
        # collapse — its observations landing in "other" would leave its
        # declared objectives evaluating 0 requests, a page that can
        # never fire; overrides are themselves capped at the same budget
        # in set_objectives, so window cardinality stays within 2*cap.
        program = metrics.capped_label(
            _windows, program, metrics.tenant_label_budget(),
            exempt=_overrides,
        )
        w = _windows.get(program)
        if w is None:
            w = _windows[program] = _ProgramWindows(_WINDOWS)
    return w


def observe(program: str | None, dur_s: float, error: bool = False) -> None:
    """One edge-observed request outcome into `program`'s windows
    (no-op while disarmed, and for canary-tagged programs)."""
    if not armed() or program in EXCLUDED_PROGRAMS:
        return
    _windows_for(program or "default").observe(
        time.monotonic(), dur_s, bool(error)
    )


def _evaluate(program: str, now: float) -> dict:
    """One program's objective states over every window (uncached)."""
    with _lock:
        tracked = set(_windows) | set(_overrides)
    # the gauges' label is a tracked program (or the lone default): the
    # window and override caps bound them
    program = metrics.capped_label(tracked, program, metrics.tenant_label_budget())
    pw = _windows.get(program)
    objectives = objectives_for(program)
    boundary = _WINDOWS[1]
    out_objectives = []
    state = "ok"
    win_stats = []
    for w in _WINDOWS:
        reqs, errs, lat = (
            pw.window_sum(now, w, boundary) if pw is not None
            else (0, 0, [0] * (len(UPPERS) + 1))
        )
        win_stats.append((w, reqs, errs, lat))
    for obj in objectives:
        burns = []
        for w, reqs, errs, lat in win_stats:
            if reqs < _MIN_EVENTS:
                burns.append(0.0)
                continue
            if obj.kind == "error":
                bad = errs / reqs
            else:
                bad = metrics.fraction_over(UPPERS, lat, obj.threshold_s)
            burns.append(bad / obj.budget)
        obj_state = "ok"
        for long_i, short_i, threshold, s in BURN_RULES:
            if burns[long_i] >= threshold and burns[short_i] >= threshold:
                obj_state = s
                break
        if STATES.index(obj_state) > STATES.index(state):
            state = obj_state
        out_objectives.append({
            "objective": obj.name,
            "state": obj_state,
            "burn": {
                _win_label(w): round(b, 3)
                for (w, *_), b in zip(win_stats, burns)
            },
        })
    payload = {
        "state": state,
        "objectives": out_objectives,
        "windows": {
            _win_label(w): {
                "requests": reqs,
                "error_ratio": round(errs / reqs, 6) if reqs else 0.0,
                "p50_ms": round(
                    metrics.quantile_from_buckets(UPPERS, lat, 0.5) * 1e3, 3
                ),
                "p99_ms": round(
                    metrics.quantile_from_buckets(UPPERS, lat, 0.99) * 1e3, 3
                ),
            }
            for w, reqs, errs, lat in win_stats
        },
    }
    # refresh the exported gauges for this program (label cardinality is
    # bounded by the window-map guard above)
    M_SLO_STATE.labels(program=program).set(STATES.index(state))
    for o, obj in zip(out_objectives, objectives):
        for wl, b in o["burn"].items():
            M_SLO_BURN.labels(
                program=program, objective=obj.name, window=wl
            ).set(b)
    # a replaced override must not leave the OLD objective's burn series
    # frozen at its last value (a Prometheus alert on it would never
    # clear) — drop this program's children for objectives that no
    # longer exist
    current = {obj.name for obj in objectives}
    M_SLO_BURN.prune(
        lambda kv: kv["program"] == program
        and kv["objective"] not in current
    )
    for w, reqs, errs, lat in win_stats:
        wl = _win_label(w)
        M_SLO_ERR.labels(program=program, window=wl).set(
            errs / reqs if reqs else 0.0
        )
        M_SLO_P99.labels(program=program, window=wl).set(
            metrics.quantile_from_buckets(UPPERS, lat, 0.99)
        )
    return payload


def _win_label(w: float) -> str:
    if w >= 3600 and w % 3600 == 0:
        return f"{int(w // 3600)}h"
    if w >= 60 and w % 60 == 0:
        return f"{int(w // 60)}m"
    return f"{w:g}s"


def evaluate(program: str) -> dict:
    """One program's cached evaluation (cache TTL 0.25s: /healthz probes
    and scrapes must not re-walk every ring on every poll)."""
    now = time.monotonic()
    cached = _eval_cache.get(program)
    if cached is not None and now - cached[0] < 0.25:
        return cached[1]
    payload = _evaluate(program, now)
    _eval_cache[program] = (now, payload)
    return payload


def _program_set() -> list[str]:
    with _lock:
        names = set(_windows) | set(_overrides)
    if _default_objectives and not names:
        names = {"default"}
    return sorted(names)


def evaluate_all() -> dict[str, dict]:
    return {p: evaluate(p) for p in _program_set()}


def overall_state() -> str | None:
    """The worst program state, or None while disarmed (the /healthz
    `degraded` integration keys on "page")."""
    if not armed():
        return None
    worst = "ok"
    for payload in evaluate_all().values():
        if STATES.index(payload["state"]) > STATES.index(worst):
            worst = payload["state"]
    return worst


def refresh_metrics() -> None:
    """Refresh the misaka_slo_* gauges (the /metrics route calls this
    before rendering; a no-op while disarmed)."""
    if armed():
        evaluate_all()


def debug_payload() -> dict:
    """The GET /debug/alerts body."""
    out = {
        "enabled": armed(),
        "default_objectives": [o.name for o in _default_objectives],
        "overrides": {
            name: [o.name for o in objs]
            for name, objs in sorted(_overrides.items())
        },
        "windows_s": list(_WINDOWS),
        "min_events": _MIN_EVENTS,
        "burn_rules": [
            {
                "long": _win_label(_WINDOWS[li]),
                "short": _win_label(_WINDOWS[si]),
                "burn": t,
                "state": s,
            }
            for li, si, t, s in BURN_RULES
        ],
        "state": overall_state() or "ok",
        "programs": evaluate_all(),
    }
    if _spec_error:
        out["spec_error"] = _spec_error
    return out
