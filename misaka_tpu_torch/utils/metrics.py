"""Dependency-free Prometheus metrics plane (text exposition v0.0.4).

The port's own copy of misaka_tpu/utils/metrics.py (stdlib only), so the
two packages render byte-identical exposition text for the same
observations (tests/test_torch_metrics.py pins it).  Served at GET
/metrics by runtime/master.py.

Three metric kinds:

  * Counter    -- monotonically increasing float; inc(amount>=0).
  * Gauge      -- settable value, or a callback read at scrape time
                  (`set_function`, weakref-friendly): queue depths cost
                  nothing per device-loop iteration.
  * Histogram  -- fixed log-spaced buckets (`log_buckets`), cumulative
                  `_bucket{le=...}` + `_sum` + `_count` rendering.

All metrics are thread-safe (one lock per child) and support labels
(`labels(route="/compute")` returns a memoized child).  The helper
constructors (`counter`/`gauge`/`histogram`) get-or-create against the
process-global REGISTRY: masters and servers are built freely in one
process and accumulate into the same series.

`parse_text` + `delta` read a scrape back (chip_smoke.py takes
before/after deltas with them); `quantile_from_buckets` estimates a
quantile from a histogram's cumulative buckets.
"""

from __future__ import annotations

import bisect
import math
import os
import re
import threading

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class MetricError(ValueError):
    """Invalid metric construction or use (bad name, label mismatch,
    duplicate registration under a different shape)."""


def log_buckets(lo: float, hi: float, per_decade: int = 3) -> tuple[float, ...]:
    """Log-spaced bucket upper bounds from `lo` until `hi` is covered.

    per_decade=3 gives the 1/2.2/4.6 pattern (10^(1/3) ratio); values are
    rounded to 4 significant digits so rendered `le` labels stay stable
    across platforms.  +Inf is implicit (the Histogram adds it).
    """
    if not (0 < lo < hi):
        raise MetricError(f"need 0 < lo < hi, got ({lo}, {hi})")
    if per_decade < 1:
        raise MetricError(f"per_decade must be >= 1, got {per_decade}")
    ratio = 10.0 ** (1.0 / per_decade)
    out: list[float] = []
    v = float(lo)
    # hi * (1+eps): float accumulation must not drop the top bucket
    while v <= hi * (1.0 + 1e-9):
        out.append(float(f"{v:.4g}"))
        v *= ratio
    return tuple(out)


def pow2_buckets(lo: int, hi: int) -> tuple[float, ...]:
    """Power-of-two bucket bounds (base-2 log spacing) — the natural grid
    for occupancy/size histograms (batch slots, queue depths)."""
    if not (0 < lo <= hi):
        raise MetricError(f"need 0 < lo <= hi, got ({lo}, {hi})")
    out, v = [], lo
    while v <= hi:
        out.append(float(v))
        v *= 2
    return tuple(out)


# Default duration buckets: 10us .. 10s, 3 per decade.  The serve paths
# span ~us (native pool chunk) to ~s (XLA autogrow compile), so one fixed
# grid serves every duration histogram (fixed buckets = aggregatable).
DURATION_BUCKETS = log_buckets(1e-5, 10.0)


def tenant_label_budget() -> int:
    """MISAKA_USAGE_LABEL_MAX (default 64): the ONE per-tenant cardinality
    cap shared by the whole health plane — usage ledger accounts, SLO
    windows and overrides, and every program-labeled metric series."""
    return int(os.environ.get("MISAKA_USAGE_LABEL_MAX", "") or 64)


def capped_label(existing, label: str, budget: int, exempt=()) -> str:
    """Resolve `label` against a cardinality budget: once `existing`
    (any container supporting `in`/`len`) already tracks `budget`
    distinct labels, a NEW label collapses to "other" — existing labels,
    "other" itself, and `exempt` members always resolve verbatim.

    MUST be called under the lock guarding `existing`, and deliberately
    never recurses or re-locks: the usage ledger and the SLO windows each
    independently grew this logic with a recursive "other" resolution
    that self-deadlocked their non-reentrant module locks — this helper
    is the single shared copy."""
    if label == "other" or label in existing or label in exempt:
        return label
    if len(existing) >= budget:
        return "other"
    return label


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if v != v:  # NaN
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _series(name: str, labelnames: tuple, labelvalues: tuple) -> str:
    if not labelnames:
        return name
    inner = ",".join(
        f'{k}="{_escape_label(str(v))}"'
        for k, v in zip(labelnames, labelvalues)
    )
    return f"{name}{{{inner}}}"


class _Child:
    def __init__(self):
        self._lock = threading.Lock()


class _CounterChild(_Child):
    def __init__(self):
        super().__init__()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise MetricError(f"counters only go up (inc {amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _GaugeChild(_Child):
    def __init__(self):
        super().__init__()
        self._value = 0.0
        self._fn = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    def set_function(self, fn) -> None:
        """Read `fn()` at scrape time instead of a stored value — the
        zero-hot-path-cost gauge (queue depths, fill ratios).  The callback
        must be cheap and non-blocking; exceptions fall back to the last
        stored value (a scrape must never 500 on a dying master)."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            stored = self._value
        if fn is not None:
            try:
                return float(fn())
            except Exception:
                return stored
        return stored


class _HistogramChild(_Child):
    def __init__(self, uppers: tuple):
        super().__init__()
        self._uppers = uppers
        self._counts = [0] * (len(uppers) + 1)  # + the +Inf bucket
        self._sum = 0.0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self._uppers, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value

    def snapshot(self):
        with self._lock:
            return list(self._counts), self._sum


class _Metric:
    kind = "untyped"
    _child_cls = _Child

    def __init__(self, name: str, help: str, labelnames: tuple = ()):
        if not _NAME_RE.match(name):
            raise MetricError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise MetricError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, _Child] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            # eager default child: unlabeled metrics render 0 before any
            # traffic, so a fresh scrape already shows the full catalog
            self._children[()] = self._new_child()

    def _new_child(self):
        return self._child_cls()

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise MetricError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.labelnames)}"
            )
        key = tuple(str(kv[ln]) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def _default(self):
        if self.labelnames:
            raise MetricError(f"{self.name} has labels; use .labels(...)")
        return self._children[()]

    def _items(self):
        with self._lock:
            return sorted(self._children.items())

    def prune(self, predicate) -> None:
        """Drop labeled children the predicate (labels-dict -> bool)
        matches: a series whose label set no longer exists must DISAPPEAR
        from the scrape, not freeze at its last value (e.g. the burn-rate
        series of a replaced per-program SLO objective)."""
        with self._lock:
            stale = [
                k for k in self._children
                if k and predicate(dict(zip(self.labelnames, k)))
            ]
            for k in stale:
                del self._children[k]

    def render(self) -> list[str]:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} {self.kind}",
        ]
        for key, child in self._items():
            lines.append(
                f"{_series(self.name, self.labelnames, key)} "
                f"{_fmt(child.value)}"
            )
        return lines


class Counter(_Metric):
    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Gauge(_Metric):
    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    def set_function(self, fn) -> None:
        self._default().set_function(fn)

    @property
    def value(self) -> float:
        return self._default().value


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames=(), buckets=DURATION_BUCKETS):
        b = tuple(float(x) for x in buckets)
        if not b or any(y <= x for x, y in zip(b, b[1:])):
            raise MetricError(f"{name}: buckets must strictly increase: {b}")
        if b[-1] == math.inf:
            b = b[:-1]  # +Inf is implicit
        self.buckets = b
        super().__init__(name, help, labelnames)

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def render(self) -> list[str]:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} {self.kind}",
        ]
        for key, child in self._items():
            counts, total = child.snapshot()
            cum = 0
            for upper, c in zip(self.buckets + (math.inf,), counts):
                cum += c
                series = _series(
                    f"{self.name}_bucket",
                    self.labelnames + ("le",),
                    key + (_fmt(upper),),
                )
                lines.append(f"{series} {cum}")
            lines.append(
                f"{_series(self.name + '_sum', self.labelnames, key)} "
                f"{_fmt(total)}"
            )
            lines.append(
                f"{_series(self.name + '_count', self.labelnames, key)} {cum}"
            )
        return lines


class Registry:
    """A namespace of metrics; render() is the GET /metrics body."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def get_or_create(self, cls, name, help, labelnames=(), **kw) -> _Metric:
        labelnames = tuple(labelnames)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls or existing.labelnames != labelnames:
                    raise MetricError(
                        f"{name} already registered as {existing.kind} with "
                        f"labels {existing.labelnames}"
                    )
                if cls is Histogram and "buckets" in kw:
                    want = tuple(float(x) for x in kw["buckets"])
                    if want and want[-1] == math.inf:
                        want = want[:-1]
                    if existing.buckets != want:
                        raise MetricError(
                            f"{name} already registered with buckets "
                            f"{existing.buckets}"
                        )
                return existing
            metric = cls(name, help, labelnames, **kw)
            self._metrics[name] = metric
            return metric

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def all_metrics(self) -> list:
        """Every registered metric (the embedded TSDB's collection walk —
        utils/tsdb.py reads values through each metric's own child locks,
        so only the dict copy needs this registry lock)."""
        with self._lock:
            return list(self._metrics.values())

    def render(self) -> str:
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n" if lines else ""


REGISTRY = Registry()


def counter(name, help, labelnames=(), registry=None) -> Counter:
    return (registry or REGISTRY).get_or_create(Counter, name, help, labelnames)


def gauge(name, help, labelnames=(), registry=None) -> Gauge:
    return (registry or REGISTRY).get_or_create(Gauge, name, help, labelnames)


def histogram(
    name, help, labelnames=(), buckets=DURATION_BUCKETS, registry=None
) -> Histogram:
    return (registry or REGISTRY).get_or_create(
        Histogram, name, help, labelnames, buckets=buckets
    )


def render(registry=None) -> str:
    return (registry or REGISTRY).render()


# --- histogram estimation math (shared with the SLO windows) ----------------


def quantile_from_buckets(uppers, counts, q: float) -> float:
    """Estimate the q-quantile (q in [0, 1]) from cumulative-style bucket
    data: `uppers` are the bucket upper bounds (ascending, +Inf implicit),
    `counts` the PER-BUCKET (non-cumulative) counts, len(uppers) + 1 long.

    Linear interpolation inside the straddling bucket (the Prometheus
    histogram_quantile convention): the first bucket interpolates from 0,
    and a quantile landing in the +Inf bucket returns the last finite
    bound (the estimate saturates — there is no upper edge to lerp to).
    Returns 0.0 when there are no observations.  Reused by utils/slo.py's
    sliding windows, so its accuracy is pinned by tests/test_metrics.py.
    """
    if not 0.0 <= q <= 1.0:
        raise MetricError(f"quantile must be in [0, 1], got {q}")
    if len(counts) != len(uppers) + 1:
        raise MetricError(
            f"need len(uppers)+1 counts, got {len(counts)} for "
            f"{len(uppers)} bounds"
        )
    total = sum(counts)
    if total <= 0:
        return 0.0
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if cum + c >= rank:
            if i >= len(uppers):  # the +Inf bucket: saturate
                return float(uppers[-1]) if uppers else 0.0
            lo = float(uppers[i - 1]) if i > 0 else 0.0
            hi = float(uppers[i])
            frac = (rank - cum) / c
            return lo + (hi - lo) * min(1.0, max(0.0, frac))
        cum += c
    return float(uppers[-1]) if uppers else 0.0


def fraction_over(uppers, counts, threshold: float) -> float:
    """Estimated fraction of observations ABOVE `threshold`, from the same
    per-bucket counts quantile_from_buckets takes.  The bucket straddling
    the threshold contributes linearly (uniform-within-bucket assumption).
    The +Inf bucket counts whole — its observations exceed every finite
    bound, and over-counting an unbounded tail is the conservative error
    for an SLO bad-event estimate.  0.0 with no observations."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    over = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if i >= len(uppers):  # the +Inf bucket
            over += c
            continue
        lo = float(uppers[i - 1]) if i > 0 else 0.0
        hi = float(uppers[i])
        if lo >= threshold:
            over += c
        elif hi > threshold:
            over += c * (hi - threshold) / (hi - lo)
    return over / total


# --- the read side: the same parser for tests and bench deltas -------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)(?:\s+\d+)?$"
)
_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape_label(v: str) -> str:
    return v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")


def _parse_value(s: str) -> float:
    if s == "+Inf":
        return math.inf
    if s == "-Inf":
        return -math.inf
    return float(s)


def parse_text(text: str) -> dict[str, float]:
    """Parse exposition text into {series: value}, where `series` is the
    canonical `name{label="v",...}` string (labels in source order).
    Raises MetricError on any malformed non-comment line — the tests use
    this to assert every rendered line is valid."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise MetricError(f"unparseable exposition line: {line!r}")
        name, labelblob, value = m.groups()
        if labelblob:
            pairs = _PAIR_RE.findall(labelblob)
            # reject junk between pairs (e.g. an unescaped quote)
            rebuilt = ",".join(f'{k}="{v}"' for k, v in pairs)
            if rebuilt != labelblob.rstrip(","):
                raise MetricError(f"unparseable label block: {labelblob!r}")
            series = name + "{" + rebuilt + "}"
        else:
            series = name
        out[series] = _parse_value(value)
    return out


def parse_series(series: str) -> tuple[str, dict[str, str]]:
    """Split a parse_text key into (name, {label: value})."""
    if "{" not in series:
        return series, {}
    name, blob = series.split("{", 1)
    blob = blob.rstrip("}")
    return name, {k: _unescape_label(v) for k, v in _PAIR_RE.findall(blob)}


def delta(
    before: dict[str, float],
    after: dict[str, float],
    skip_buckets: bool = True,
) -> dict[str, float]:
    """after-minus-before for every series that moved — the compact
    snapshot bench.py embeds in its artifact.  Histogram buckets are
    dropped by default (the _sum/_count pair carries the signal; buckets
    would triple the artifact for no headline)."""
    out: dict[str, float] = {}
    for series, v in after.items():
        name, _ = parse_series(series)
        if skip_buckets and name.endswith("_bucket"):
            continue
        d = v - before.get(series, 0.0)
        if d:
            out[series] = round(d, 9)
    return out
