"""Regression watchdog: a rule engine over the embedded TSDB.

The port's copy of misaka_tpu/utils/watchdog.py (stdlib only): the same
grammar, default rules, sustain and clear, ratio baselines and payloads.
The SLO engine (utils/slo.py) pages on declared objectives; these rules
page on regressions against the service's own recent past, over the
retained history (utils/tsdb.py).  Findings ride the existing alert
surface: a ``watchdog`` block on GET /debug/alerts and the ``degraded``
flag of /healthz.

Rule grammar (``MISAKA_WATCHDOG``, comma-separated; ``0`` disables, unset
arms the defaults below)::

    MISAKA_WATCHDOG="p99-drift=misaka_http_request_duration_seconds:p99>2x@1h for 300s ->warning,
                     canary=misaka_canary_success{tier=full}<1 for 20s ->page"

Each entry: ``[name=]series[{label=value}] OP threshold [for SUSTAINs]
[->severity]`` (the name's separator is ``=``: series names contain
``:``), where

  * ``series``  -- a TSDB series name (derived ``:p50``/``:p99``/``:rate``
                   included), with an optional single ``{label=value}``
                   filter; matching series are evaluated together, the
                   worst wins.
  * ``OP``      -- ``>`` or ``<`` against a number, or ``Nx@WINDOW`` (N
                   times the series' own median over the trailing
                   WINDOW).  A ratio rule stays silent until its baseline
                   holds ``MISAKA_WATCHDOG_MIN_POINTS`` (5) points.
  * ``for N[s|m|h]`` -- the condition holds this long before the rule
                   fires, and clears this long before it resets.
  * ``->severity`` -- ``warning`` (default) or ``page``; a paging rule
                   raises /healthz ``degraded``.

A rule compares the mean over the trailing ``MISAKA_WATCHDOG_RECENT_S``
(60) seconds of stage-0 points.  Evaluation rides the TSDB collector's
tick: no second thread, no second clock.  Exemplar trace IDs are attached
at the /debug/alerts route.
"""

from __future__ import annotations

import os
import re
import threading
import time

from misaka_tpu_torch.utils import tsdb as tsdb_mod

SEVERITIES = ("ok", "warning", "page")

_RULE_RE = re.compile(
    r"^(?:(?P<name>[A-Za-z0-9._-]+)=(?=[a-zA-Z_]))?"
    r"(?P<series>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<lk>[a-zA-Z_][a-zA-Z0-9_]*)=(?P<lv>[^}]*)\})?"
    r"\s*(?P<op>[<>])\s*"
    r"(?P<value>\d+(?:\.\d+)?)"
    r"(?:x@(?P<baseline>[0-9.]+[smh]?))?"
    r"(?:\s+for\s+(?P<sustain>[0-9.]+[smh]?))?"
    r"\s*(?:->\s*(?P<severity>warning|page))?$"
)


class WatchdogSpecError(ValueError):
    """Malformed MISAKA_WATCHDOG rule spec."""


class Rule:
    """One parsed rule + its firing state."""

    __slots__ = ("name", "series", "labels", "op", "threshold", "factor",
                 "baseline_s", "sustain_s", "severity", "spec",
                 "state", "_bad_since", "_ok_since", "last_value",
                 "last_baseline", "fired_unix")

    def __init__(self, name, series, labels, op, threshold, factor,
                 baseline_s, sustain_s, severity, spec):
        self.name = name
        self.series = series
        self.labels = labels          # {} or single {k: v}
        self.op = op                  # ">" | "<"
        self.threshold = threshold    # absolute (None for ratio rules)
        self.factor = factor          # ratio multiple (None for absolute)
        self.baseline_s = baseline_s  # trailing window for the median
        self.sustain_s = sustain_s
        self.severity = severity
        self.spec = spec
        self.state = "ok"
        self._bad_since: float | None = None   # monotonic
        self._ok_since: float | None = None
        self.last_value: float | None = None
        self.last_baseline: float | None = None
        self.fired_unix: float | None = None

    def payload(self) -> dict:
        out = {
            "rule": self.name,
            "spec": self.spec,
            "series": self.series,
            "state": self.state,
            "severity": self.severity,
        }
        if self.labels:
            out["labels"] = self.labels
        if self.last_value is not None:
            out["value"] = round(self.last_value, 6)
        if self.last_baseline is not None:
            out["baseline"] = round(self.last_baseline, 6)
            out["threshold"] = round(
                self.last_baseline * (self.factor or 1.0), 6
            )
        elif self.threshold is not None:
            out["threshold"] = self.threshold
        if self.state != "ok" and self.fired_unix is not None:
            out["since_unix"] = round(self.fired_unix, 3)
        return out


def parse_spec(text: str) -> list[Rule]:
    rules: list[Rule] = []
    for i, raw in enumerate((text or "").split(",")):
        item = raw.strip()
        if not item:
            continue
        m = _RULE_RE.match(item)
        if not m:
            raise WatchdogSpecError(
                f"cannot parse watchdog rule {item!r} (grammar: "
                f"[name=]series[{{label=value}}] <|> N[x@window] "
                f"[for Ns] [->warning|page])"
            )
        g = m.groupdict()
        factor = baseline_s = threshold = None
        if g["baseline"]:
            factor = float(g["value"])
            baseline_s = tsdb_mod.parse_window(g["baseline"])
            if factor <= 0:
                raise WatchdogSpecError(f"ratio must be > 0 in {item!r}")
        else:
            threshold = float(g["value"])
        sustain_s = tsdb_mod.parse_window(
            g["sustain"], allow_zero=True
        ) if g["sustain"] else 0.0
        labels = {g["lk"]: g["lv"]} if g["lk"] else {}
        rules.append(Rule(
            name=g["name"] or f"rule{i}",
            series=g["series"],
            labels=labels,
            op=g["op"],
            threshold=threshold,
            factor=factor,
            baseline_s=baseline_s,
            sustain_s=sustain_s,
            severity=g["severity"] or "warning",
            spec=item,
        ))
    return rules


def default_rules(interval_s: float) -> list[Rule]:
    """The always-on defaults (MISAKA_WATCHDOG unset): a full-stack
    canary that keeps failing pages; edge p99 doubling over its own
    trailing hour warns; replicas restarting faster than ~4/h warn;
    sustained telemetry-spool loss (TSDB slots or capture records
    dropped, or spool write errors) warns — durable retention that is
    silently shedding its own history is the failure mode the durable
    plane exists to prevent.
    Each stays silent until its series exists and (for the ratio rule)
    a baseline accumulated — so the p99 rule, which watches the
    ENGINE's own HTTP histogram, is simply inert behind a frontend
    tier (compute rides the plane there; the canary rule is the active
    deep-path watchdog in those topologies)."""
    canary_sustain = max(3.0 * interval_s, 15.0)
    return parse_spec(
        f"canary-full=misaka_canary_success{{tier=full}}<1 "
        f"for {canary_sustain:g}s ->page,"
        f"p99-drift=misaka_http_request_duration_seconds:p99"
        f"{{route=/compute_raw}}>2x@1h for 300s ->warning,"
        f"replica-restarts=misaka_fleet_replica_restarts_total"
        f">0.0011 for 300s ->warning,"
        f"tsdb-spool-drops=misaka_tsdb_spool_dropped_total"
        f">0.001 for 300s ->warning,"
        f"capture-spool-drops=misaka_capture_spool_dropped_total"
        f">0.001 for 300s ->warning,"
        f"spool-errors=misaka_spool_errors_total>0.001 for 60s ->warning"
    )


def _median(values: list[float]) -> float:
    vs = sorted(values)
    n = len(vs)
    return vs[n // 2] if n % 2 else (vs[n // 2 - 1] + vs[n // 2]) / 2.0


class Watchdog:
    """Rule state + evaluation (driven by the TSDB tick hook)."""

    def __init__(self, rules: list[Rule], recent_s: float = 60.0,
                 min_points: int = 5):
        self.rules = rules
        self.recent_s = max(0.05, float(recent_s))
        self.min_points = max(1, int(min_points))
        self._lock = threading.Lock()

    def evaluate(self, db) -> None:
        now_mono = time.monotonic()
        with self._lock:
            for rule in self.rules:
                self._evaluate_rule(rule, db, now_mono)

    def _current_value(self, rule: Rule, db) -> float | None:
        """The worst matching series' recent mean (None = no data)."""
        worst = None
        for row in db.query(rule.series, rule.labels, self.recent_s):
            pts = [p[1] for p in row["points"]]
            if not pts:
                continue
            v = sum(pts) / len(pts)
            if worst is None:
                worst = v
            elif rule.op == ">":
                worst = max(worst, v)
            else:
                worst = min(worst, v)
        return worst

    def _baseline(self, rule: Rule, db) -> float | None:
        """Median over the trailing baseline window, recent part
        excluded (the regression must not lift its own baseline)."""
        pts: list[float] = []
        now = time.time()
        for row in db.query(rule.series, rule.labels, rule.baseline_s):
            for t, avg, _mx in row["points"]:
                if now - t > self.recent_s:
                    pts.append(avg)
        if len(pts) < self.min_points:
            return None
        return _median(pts)

    def _evaluate_rule(self, rule: Rule, db, now_mono: float) -> None:
        value = self._current_value(rule, db)
        rule.last_value = value
        if value is None:
            return  # no data: hold the current state, never invent one
        if rule.factor is not None:
            baseline = self._baseline(rule, db)
            rule.last_baseline = baseline
            if baseline is None:
                return  # no baseline yet: silent, not wrong
            threshold = baseline * rule.factor
        else:
            threshold = rule.threshold
        bad = value > threshold if rule.op == ">" else value < threshold
        if bad:
            rule._ok_since = None
            if rule._bad_since is None:
                rule._bad_since = now_mono
            if (now_mono - rule._bad_since >= rule.sustain_s
                    and rule.state == "ok"):
                rule.state = rule.severity
                rule.fired_unix = time.time()
        else:
            rule._bad_since = None
            if rule.state != "ok":
                # clear only after the condition has been good for the
                # same sustain (a flapping series must not strobe alerts)
                if rule._ok_since is None:
                    rule._ok_since = now_mono
                if now_mono - rule._ok_since >= rule.sustain_s:
                    rule.state = "ok"
                    rule.fired_unix = None
                    rule._ok_since = None

    def overall_state(self) -> str:
        worst = "ok"
        with self._lock:
            for rule in self.rules:
                if SEVERITIES.index(rule.state) > SEVERITIES.index(worst):
                    worst = rule.state
        return worst

    def payload(self) -> dict:
        with self._lock:
            rules = [r.payload() for r in self.rules]
        return {
            "enabled": True,
            "state": self.overall_state(),
            "recent_s": self.recent_s,
            "min_points": self.min_points,
            "rules": rules,
        }


# --- the process-global instance --------------------------------------------

_lock = threading.Lock()
_watchdog: Watchdog | None = None
_spec_error: str | None = None


def enabled(environ=os.environ) -> bool:
    return environ.get("MISAKA_WATCHDOG", "1") != "0"


def get() -> Watchdog | None:
    return _watchdog


def ensure_started(environ=os.environ) -> Watchdog | None:
    """Build the process watchdog from the env and hook it onto the
    TSDB collector; None when either it or the TSDB is disabled."""
    global _watchdog, _spec_error
    if not enabled(environ):
        return None
    db = tsdb_mod.ensure_started(environ)
    if db is None:
        return None  # no history, nothing to watch
    with _lock:
        if _watchdog is None:
            spec = environ.get("MISAKA_WATCHDOG", "")
            _spec_error = None
            try:
                rules = parse_spec(spec) if spec else \
                    default_rules(db.interval_s)
            except WatchdogSpecError as e:
                # a typo'd spec must not take down the server — but
                # silently watching nothing would be worse: loud on the
                # alerts payload, defaults stay armed
                _spec_error = f"MISAKA_WATCHDOG={spec!r}: {e}"
                rules = default_rules(db.interval_s)
            _watchdog = Watchdog(
                rules,
                recent_s=tsdb_mod.env_float(
                    environ, "MISAKA_WATCHDOG_RECENT_S", 60.0
                ),
                min_points=int(tsdb_mod.env_float(
                    environ, "MISAKA_WATCHDOG_MIN_POINTS", 5
                )),
            )
        db.add_hook(_watchdog.evaluate)
    return _watchdog


def shutdown() -> None:
    """Drop the global watchdog (tests; the A/B's off side)."""
    global _watchdog, _spec_error
    with _lock:
        db = tsdb_mod.get()
        if db is not None and _watchdog is not None:
            db.remove_hook(_watchdog.evaluate)
        _watchdog = None
        _spec_error = None


def overall_state() -> str | None:
    """The worst rule state, or None while disarmed (the /healthz
    `degraded` integration keys on "page", like the SLO engine's)."""
    w = _watchdog
    return w.overall_state() if w is not None else None


def debug_payload() -> dict:
    """The `watchdog` block on GET /debug/alerts."""
    w = _watchdog
    if w is None:
        return {"enabled": False, "state": "ok", "rules": []}
    out = w.payload()
    if _spec_error:
        out["spec_error"] = _spec_error
    return out
