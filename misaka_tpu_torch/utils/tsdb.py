"""Embedded time-series history over the live metrics registry, served
at GET /debug/series.

The port's copy of misaka_tpu/utils/tsdb.py (stdlib only), with the same
series, payloads, snapshot blob and spool frames, so a checkpoint's
``__tsdb__`` blob and a spooled tier written by either package load in
the other (tests/test_torch_tsdb.py, tests/test_torch_durable.py).  A
collector thread samples utils/metrics.py's registry every
``MISAKA_TSDB_INTERVAL_S`` seconds into ring buffers with staged
downsampling; a query slices any series over any window up to the
retention horizon.

Per metric kind:

  * Counter   -- stored as a rate (delta over the elapsed time; a
                 negative delta re-bases instead of spiking), under the
                 counter's name.
  * Gauge     -- stored as read.
  * Histogram -- ``<name>:p50`` and ``<name>:p99`` from the interval's
                 bucket delta (an interval with no observations writes
                 nothing), and ``<name>:rate`` (observations/s).

Every sample lands in every stage at once: by default ``interval x 720``
(1 h at the 5 s default), ``1 m x 360`` and ``5 m x 288``.  A slot keeps
mean and max, and slots are positional rings keyed by the wall-clock
epoch ``int(unix / width)`` (stale slots are reclaimed), which is what
lets a restored snapshot land in the right slots after a restart.

Bounded: ~38 KiB per series and at most ``MISAKA_TSDB_MAX_SERIES``
(512) series, new series past the cap dropped and counted
(``dropped_series``); the golden-signal families are sampled first.  The
collector stretches its period to stay under ``MISAKA_TSDB_BUDGET`` (1%)
of one core.

``snapshot_bytes()`` rides as ``__tsdb__`` in MasterNode checkpoints and
``restore_bytes()`` merges it back: a restored slot installs only where
it is strictly newer than the live one.

``MISAKA_TSDB_DIR`` arms the durable tiers: the collector's tick appends
every finalized slot to utils/spool.py segments ("fine", the finest
stage, and "long", ``MISAKA_TSDB_LONG_S`` x ``MISAKA_TSDB_LONG_SLOTS``,
5 m x 4032 = two weeks, which also deepens the coarsest ring so
``window=7d`` answers from memory) under ``MISAKA_TSDB_DISK_MB``, and
boot reloads both.  ``MISAKA_TSDB=0`` is the kill switch; ``shutdown()``
stops the collector.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from array import array

from misaka_tpu_torch.utils import metrics
from misaka_tpu_torch.utils.spool import M_SPOOL_ERRORS, SegmentSpool

DEFAULT_INTERVAL_S = 5.0
DEFAULT_MAX_SERIES = 512
DEFAULT_BUDGET = 0.01
DEFAULT_DISK_MB = 64.0
DEFAULT_LONG_S = 300.0
DEFAULT_LONG_SLOTS = 4032  # two weeks of 5 m slots

M_SPOOL_DROPPED = metrics.counter(
    "misaka_tsdb_spool_dropped_total",
    "TSDB spool segments evicted by the MISAKA_TSDB_DISK_MB budget",
)
M_SPOOL_BYTES = metrics.gauge(
    "misaka_tsdb_spool_bytes",
    "On-disk footprint of the TSDB retention spool",
)

# Families sampled FIRST each pass (the dashboard's golden signals and
# the watchdog's default rules): a label flood elsewhere may exhaust the
# series cap, but never these.
PRIORITY_PREFIXES = (
    "misaka_canary_",
    "misaka_http_",
    "misaka_compute_",
    "misaka_serve_",
    "misaka_edge_",
    "misaka_fleet_",
    "misaka_native_pool_",
    "misaka_usage_values_total",
    "misaka_slo_p99_seconds",
    "misaka_frontend_",
)


class TSDBError(ValueError):
    """Invalid query or snapshot content."""


def parse_window(text: str | float | int, allow_zero: bool = False) -> float:
    """``"30s"`` / ``"5m"`` / ``"1h"`` / ``"7d"`` / bare seconds ->
    seconds.  `allow_zero` admits 0 (the watchdog's no-sustain clause);
    a query window stays strictly positive."""
    if isinstance(text, (int, float)):
        v = float(text)
    else:
        t = str(text).strip().lower()
        mult = 1.0
        if t.endswith("d"):
            mult, t = 86400.0, t[:-1]
        elif t.endswith("h"):
            mult, t = 3600.0, t[:-1]
        elif t.endswith("m"):
            mult, t = 60.0, t[:-1]
        elif t.endswith("s"):
            t = t[:-1]
        try:
            v = float(t) * mult
        except ValueError:
            raise TSDBError(f"cannot parse window {text!r} "
                            f"(use e.g. 30s / 5m / 1h / 7d)") from None
    if v < 0 or (v == 0 and not allow_zero):
        raise TSDBError(f"window must be > 0, got {text!r}")
    return v


def parse_query(query: dict) -> tuple[str | None, dict[str, str], float]:
    """The GET /debug/series query contract, shared by the engine and
    fleet handlers (one copy of the grammar): `query` is a parse_qs
    dict; returns (name-or-None, label filters, window seconds).
    Raises TSDBError (the handlers answer it as 400) on a malformed
    window or a label entry that is not k=v."""
    window_s = parse_window(query.get("window", ["1h"])[0])
    name = query.get("name", [None])[0]
    labels: dict[str, str] = {}
    for item in query.get("label", ()):
        k, sep, v = item.partition("=")
        if not sep:
            raise TSDBError(f"label filter {item!r} is not k=v")
        labels[k] = v
    return name, labels, window_s


def env_float(environ, name: str, default: float) -> float:
    """An env knob parsed with a silent fallback (a typo'd MISAKA_*
    value must not take down a booting server) — the one shared copy
    for this module's and the watchdog's ensure_started."""
    try:
        return float(environ.get(name, "") or default)
    except ValueError:
        return default


def _stage_plan(interval_s: float, long_s: float | None = None,
                long_slots: int = DEFAULT_LONG_SLOTS,
                ) -> tuple[tuple[float, int], ...]:
    """(width_s, length) per retention stage for one sample interval.
    Coarser stages keep their absolute spans when the interval shrinks
    (tests run 50 ms intervals; the 1 m/5 m tiers stay meaningful), and
    widen to the interval when it grows past them.  With the disk spool
    armed (``long_s`` set) the coarsest stage becomes the long-horizon
    tier: ``long_s``-wide slots held ``long_slots`` deep (two weeks at
    the 5 m default), the in-memory landing zone the spool reloads into
    so ``window=7d`` answers from RAM after a restart."""
    stages = [(interval_s, 720)]
    for width, length in ((60.0, 360), (300.0, 288)):
        if width > interval_s and (long_s is None or width < long_s):
            stages.append((width, length))
    if long_s is not None and long_s > interval_s:
        stages.append((long_s, max(288, int(long_slots))))
    return tuple(stages)


class _Ring:
    """One retention stage of one series: positional slots keyed by
    absolute epoch, each aggregating (sum, count, max) of the samples
    that landed in its span."""

    __slots__ = ("width", "length", "epochs", "sums", "counts", "maxs")

    def __init__(self, width: float, length: int):
        self.width = float(width)
        self.length = int(length)
        self.epochs = array("q", [-1]) * self.length
        self.sums = array("d", [0.0]) * self.length
        self.counts = array("L", [0]) * self.length
        self.maxs = array("d", [0.0]) * self.length

    def add(self, now_unix: float, value: float) -> None:
        epoch = int(now_unix / self.width)
        i = epoch % self.length
        if self.epochs[i] != epoch:
            self.epochs[i] = epoch
            self.sums[i] = 0.0
            self.counts[i] = 0
            self.maxs[i] = value
        self.sums[i] += value
        self.counts[i] += 1
        if value > self.maxs[i]:
            self.maxs[i] = value

    def points(self, now_unix: float, window_s: float) -> list[list[float]]:
        """[[slot_start_unix, mean, max], ...] oldest -> newest over the
        last `window_s` (unwritten / stale slots skipped)."""
        n = min(self.length, max(1, math.ceil(window_s / self.width)))
        epoch_now = int(now_unix / self.width)
        out: list[list[float]] = []
        for back in range(n - 1, -1, -1):
            epoch = epoch_now - back
            i = epoch % self.length
            if self.epochs[i] != epoch or not self.counts[i]:
                continue
            out.append([
                round(epoch * self.width, 3),
                self.sums[i] / self.counts[i],
                self.maxs[i],
            ])
        return out

    def install(self, epoch: int, total: float, count: int,
                peak: float) -> None:
        """Snapshot restore: install a slot only where it is strictly
        newer than the live ring's occupant — a stale (eviction-era)
        snapshot must never clobber fresher history, and re-restoring
        the same snapshot must never double-count."""
        i = epoch % self.length
        if epoch > self.epochs[i]:
            self.epochs[i] = epoch
            self.sums[i] = total
            self.counts[i] = count
            self.maxs[i] = peak

    def merge(self, epoch: int, total: float, count: int,
              peak: float) -> None:
        """Spool reload: ACCUMULATE into a matching-epoch slot (a fine
        on-disk slot re-aggregating into a coarser ring), install fresh
        where newer, and — unlike install() — never touch a slot the
        live ring already holds newer data for."""
        i = epoch % self.length
        if epoch > self.epochs[i]:
            self.epochs[i] = epoch
            self.sums[i] = total
            self.counts[i] = count
            self.maxs[i] = peak
        elif epoch == self.epochs[i]:
            self.sums[i] += total
            self.counts[i] += count
            if peak > self.maxs[i]:
                self.maxs[i] = peak

    def slot_at(self, epoch: int) -> tuple[float, int, float] | None:
        """(sum, count, max) of one absolute epoch, None when unwritten
        or reclaimed — the spool writer's finalized-slot read."""
        i = epoch % self.length
        if self.epochs[i] != epoch or not self.counts[i]:
            return None
        return (self.sums[i], int(self.counts[i]), self.maxs[i])

    def dump(self) -> list[list[float]]:
        out = []
        for i in range(self.length):
            if self.epochs[i] >= 0 and self.counts[i]:
                out.append([
                    int(self.epochs[i]), self.sums[i],
                    int(self.counts[i]), self.maxs[i],
                ])
        return out


class _Series:
    """All retention stages of one series."""

    __slots__ = ("name", "labels", "kind", "stages")

    def __init__(self, name: str, labels: dict[str, str], kind: str,
                 plan: tuple[tuple[float, int], ...]):
        self.name = name
        self.labels = labels
        self.kind = kind  # "rate" | "gauge" | "quantile"
        self.stages = tuple(_Ring(w, n) for w, n in plan)

    def add(self, now_unix: float, value: float) -> None:
        for ring in self.stages:
            ring.add(now_unix, value)

    def stage_for(self, window_s: float) -> _Ring:
        """The finest stage whose retention covers the window (the
        coarsest one when nothing does)."""
        for ring in self.stages:
            if ring.width * ring.length >= window_s:
                return ring
        return self.stages[-1]


class TSDB:
    """The store + the governed collector thread."""

    def __init__(self, interval_s: float = DEFAULT_INTERVAL_S,
                 max_series: int = DEFAULT_MAX_SERIES,
                 budget: float = DEFAULT_BUDGET, registry=None,
                 spool_dir: str | None = None,
                 disk_mb: float = DEFAULT_DISK_MB,
                 long_s: float = DEFAULT_LONG_S,
                 long_slots: int = DEFAULT_LONG_SLOTS,
                 segment_bytes: int = 1 << 20):
        self.interval_s = max(0.02, float(interval_s))
        self.max_series = max(16, int(max_series))
        self.budget = min(0.5, max(0.001, float(budget)))
        self._registry = registry if registry is not None else metrics.REGISTRY
        self.spool_dir = spool_dir
        self._long_armed = (
            spool_dir is not None and float(long_s) > self.interval_s
        )
        self._plan = _stage_plan(
            self.interval_s,
            long_s=float(long_s) if self._long_armed else None,
            long_slots=long_slots,
        )
        self._lock = threading.Lock()
        self._series: dict[tuple, _Series] = {}  # (name, sorted-label-items)
        self._dropped: set[tuple] = set()
        self._samples = 0
        self._cost_ema = 0.0
        # previous raw values for rate/quantile derivation, keyed like
        # _series: counters -> float, histograms -> (counts, last_mono)
        self._prev_counter: dict[tuple, float] = {}
        self._prev_hist: dict[tuple, list[int]] = {}
        self._last_mono: float | None = None
        # per-tick hooks (the regression watchdog registers here: rules
        # evaluate right after each sample lands, on this thread — no
        # second clock, no second thread)
        self._hooks: list = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # --- the disk spool (MISAKA_TSDB_DIR; None = today's in-memory
        # behavior).  Two tiers ride the same SegmentSpool discipline:
        # "fine" persists every finalized finest-stage slot (restart
        # continuity at full resolution, ~days under the budget) and
        # "long" persists the coarse long-horizon slots (weeks).  The
        # budget splits 3:1 fine:long.
        self._spools: dict[str, SegmentSpool] = {}
        self._flushed_epoch: dict[str, int] = {}
        self._long_hi = -1  # newest long-tier epoch seen at reload
        self.spooled_frames = 0
        self.reloaded_frames = 0
        if spool_dir is not None:
            budget_bytes = max(1 << 20, int(float(disk_mb) * (1 << 20)))
            tiers = [("fine", self.stages_widths()[0], budget_bytes * 3 // 4)]
            if self._long_armed:
                tiers.append(
                    ("long", self.stages_widths()[-1], budget_bytes // 4)
                )
            now_unix = time.time()
            for tier, width, tier_budget in tiers:
                sp = SegmentSpool(
                    spool_dir, prefix=f"tsdb-{tier}",
                    budget_bytes=tier_budget,
                    segment_bytes=segment_bytes,
                    on_evict=M_SPOOL_DROPPED.inc,
                    on_error=lambda: M_SPOOL_ERRORS.labels(
                        plane="tsdb").inc(),
                )
                self._spools[tier] = sp
                self._flushed_epoch[tier] = int(now_unix / width) - 1
            self._spool_reload()

    def stages_widths(self) -> list[float]:
        return [w for w, _ in self._plan]

    # --- lifecycle ----------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        if self.running:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="misaka-tsdb"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2)
        self._thread = None
        for sp in self._spools.values():
            sp.close()

    def add_hook(self, fn) -> None:
        """Register fn(tsdb) to run after every collected sample."""
        with self._lock:
            if fn not in self._hooks:
                self._hooks.append(fn)

    def remove_hook(self, fn) -> None:
        with self._lock:
            if fn in self._hooks:
                self._hooks.remove(fn)

    # --- the collector ------------------------------------------------------

    def _current_period(self) -> float:
        """Nominal interval, stretched whenever one sample's measured
        cost would blow the duty-cycle budget (utils/sampler.py's
        governor)."""
        return max(self.interval_s, self._cost_ema / self.budget)

    def _loop(self) -> None:
        while not self._stop.wait(self._current_period()):
            t0 = time.perf_counter()
            try:
                self.sample_once()
                self._spool_flush()
            except Exception:  # pragma: no cover — the collector must
                pass           # never take serving down with it
            dt = time.perf_counter() - t0
            self._cost_ema = (
                dt if self._cost_ema == 0.0
                else 0.8 * self._cost_ema + 0.2 * dt
            )
            hooks = list(self._hooks)
            for fn in hooks:
                try:
                    fn(self)
                except Exception:  # pragma: no cover — a broken rule
                    pass           # must not stop history collection

    def _series_for(self, name: str, labels: dict[str, str],
                    kind: str) -> _Series | None:
        key = (name, tuple(sorted(labels.items())))
        s = self._series.get(key)
        if s is not None:
            return s
        if len(self._series) >= self.max_series:
            self._dropped.add(key)
            return None
        s = self._series[key] = _Series(name, labels, kind, self._plan)
        return s

    def _record(self, now_unix: float, name: str, labels: dict,
                kind: str, value: float) -> None:
        s = self._series_for(name, labels, kind)
        if s is not None:
            s.add(now_unix, value)

    def sample_once(self) -> None:
        """One collection pass over the metrics registry (the collector
        thread's body; tests call it directly for deterministic time)."""
        now_unix = time.time()
        now_mono = time.monotonic()
        last = self._last_mono
        self._last_mono = now_mono
        dt = (now_mono - last) if last is not None else None
        if dt is not None and dt <= 0:
            dt = None
        all_metrics = self._registry.all_metrics()
        # priority families first: the series cap must never starve the
        # golden signals (see PRIORITY_PREFIXES)
        all_metrics.sort(
            key=lambda m: (
                not m.name.startswith(PRIORITY_PREFIXES), m.name
            )
        )
        with self._lock:
            self._samples += 1
            for m in all_metrics:
                if isinstance(m, metrics.Histogram):
                    self._sample_histogram(m, now_unix, dt)
                elif isinstance(m, metrics.Counter):
                    self._sample_counter(m, now_unix, dt)
                elif isinstance(m, metrics.Gauge):
                    for lkey, child in m._items():
                        labels = dict(zip(m.labelnames, lkey))
                        self._record(
                            now_unix, m.name, labels, "gauge", child.value
                        )

    def _sample_counter(self, m, now_unix: float, dt: float | None) -> None:
        for lkey, child in m._items():
            key = (m.name, lkey)
            cur = child.value
            prev = self._prev_counter.get(key)
            self._prev_counter[key] = cur
            if prev is None or dt is None:
                continue  # first sight: establish the baseline only
            delta = cur - prev
            if delta < 0:
                delta = cur  # process/metric reset: re-base, don't spike
            labels = dict(zip(m.labelnames, lkey))
            self._record(now_unix, m.name, labels, "rate", delta / dt)

    def _sample_histogram(self, m, now_unix: float,
                          dt: float | None) -> None:
        uppers = m.buckets
        for lkey, child in m._items():
            counts, _total = child.snapshot()
            key = (m.name, lkey)
            prev = self._prev_hist.get(key)
            self._prev_hist[key] = counts
            if prev is None or dt is None or len(prev) != len(counts):
                continue
            delta = [c - p for c, p in zip(counts, prev)]
            n = sum(delta)
            if n < 0:  # reset: re-base on the fresh counts
                delta, n = counts, sum(counts)
            labels = dict(zip(m.labelnames, lkey))
            self._record(
                now_unix, f"{m.name}:rate", labels, "rate", n / dt
            )
            if n <= 0:
                continue  # an idle interval writes no false-zero quantile
            for q, suffix in ((0.5, ":p50"), (0.99, ":p99")):
                self._record(
                    now_unix, f"{m.name}{suffix}", labels, "quantile",
                    metrics.quantile_from_buckets(uppers, delta, q),
                )

    # --- the disk spool -----------------------------------------------------

    def _tier_stage(self, tier: str) -> int:
        return 0 if tier == "fine" else len(self._plan) - 1

    def _spool_flush(self) -> None:
        """Collector-tick hook: append every newly FINALIZED slot (its
        epoch fully in the past) to the tier's segment spool, fsync, and
        let the spool enforce rotation + the disk budget.  Runs on the
        collector thread only (the spool is single-writer)."""
        if not self._spools:
            return
        now_unix = time.time()
        wrote = False
        for tier, sp in self._spools.items():
            stage_i = self._tier_stage(tier)
            width = self._plan[stage_i][0]
            current = int(now_unix / width)
            # bound catch-up after a stall — older slots are still in
            # RAM but no longer worth a giant write burst
            start = max(self._flushed_epoch[tier] + 1, current - 64)
            tier_wrote = False
            for epoch in range(start, current):
                rows = []
                with self._lock:
                    for s in self._series.values():
                        slot = s.stages[stage_i].slot_at(epoch)
                        if slot is not None:
                            rows.append([
                                s.name, s.labels, s.kind,
                                slot[0], slot[1], slot[2],
                            ])
                self._flushed_epoch[tier] = epoch
                if rows:
                    sp.append({"k": "slots", "tier": tier, "w": width,
                               "e": epoch, "rows": rows})
                    self.spooled_frames += 1
                    tier_wrote = True
            if tier_wrote:
                sp.flush()
                wrote = True
        if wrote:
            M_SPOOL_BYTES.set(
                sum(sp.disk_bytes() for sp in self._spools.values())
            )

    def _spool_reload(self) -> None:
        """Boot: retained frames -> the in-memory rings, so /debug/series
        answers across restarts without checkpoints.  Long-tier frames
        own the coarsest ring outright; fine frames re-aggregate into
        every FINER stage (never the coarsest — the long tier already
        carries that span, and merging both would double-count)."""
        for tier in ("long", "fine"):
            sp = self._spools.get(tier)
            if sp is None:
                continue
            self.reloaded_frames += sp.reload(
                lambda fr, t=tier: self._install_frame(t, fr)
            )

    def _install_frame(self, tier: str, frame: dict) -> None:
        if frame.get("k") != "slots":
            return
        try:
            width = float(frame["w"])
            epoch = int(frame["e"])
            rows = frame["rows"]
        except (KeyError, TypeError, ValueError):
            return
        stage_i = self._tier_stage(tier)
        live_width = self._plan[stage_i][0]
        if abs(width - live_width) < 1e-9:
            # same tier geometry across the restart: the writer resumes
            # AFTER the newest on-disk epoch (no duplicate frames)
            self._flushed_epoch[tier] = max(
                self._flushed_epoch[tier], epoch
            )
        if tier == "long":
            self._long_hi = max(self._long_hi, epoch)
        slot_start = epoch * width
        for row in rows:
            try:
                name, labels, kind, total, count, peak = row
            except (TypeError, ValueError):
                continue
            s = self._series_for(
                str(name),
                {str(k): str(v) for k, v in (labels or {}).items()},
                str(kind),
            )
            if s is None:
                continue  # over the cap: counted in dropped_series
            if tier == "long" or not self._long_armed:
                targets = s.stages[stage_i:stage_i + 1]
            else:
                # fine frames fill every finer stage; the coarsest too,
                # but only PAST the long tier's newest reloaded epoch —
                # a young server has no finalized long slots yet, and
                # window=7d must still show pre-restart points without
                # double-counting spans the long tier already carries
                targets = list(s.stages[:-1])
                coarse = s.stages[-1]
                if slot_start >= (self._long_hi + 1) * coarse.width:
                    targets.append(coarse)
            for ring in targets:
                if ring.width + 1e-9 < width:
                    continue  # cannot disaggregate into a finer ring
                ring.merge(
                    int(slot_start / ring.width) if ring.width != width
                    else epoch,
                    float(total), int(count), float(peak),
                )

    def spool_status(self) -> dict | None:
        if not self._spools:
            return None
        return {
            "dir": self.spool_dir,
            "disk_bytes": sum(
                sp.disk_bytes() for sp in self._spools.values()
            ),
            "frames_spooled": self.spooled_frames,
            "frames_reloaded": self.reloaded_frames,
            "evicted_segments": sum(
                sp.evicted for sp in self._spools.values()
            ),
            "errors": sum(sp.errors for sp in self._spools.values()),
            "tiers": {
                tier: {
                    "width_s": self._plan[self._tier_stage(tier)][0],
                    "segments": len(sp.segments()),
                    "budget_bytes": sp.budget_bytes,
                }
                for tier, sp in self._spools.items()
            },
        }

    # --- the read side ------------------------------------------------------

    def series_index(self) -> dict:
        with self._lock:
            names: dict[str, int] = {}
            for s in self._series.values():
                names[s.name] = names.get(s.name, 0) + 1
            dropped = len(self._dropped)
            count = len(self._series)
        return {
            "enabled": True,
            "running": self.running,
            "interval_s": self.interval_s,
            "effective_interval_s": round(self._current_period(), 3),
            "budget": self.budget,
            "sample_cost_us": round(self._cost_ema * 1e6, 1),
            "samples": self._samples,
            "stages": [
                {"width_s": w, "slots": n, "span_s": round(w * n, 1)}
                for w, n in self._plan
            ],
            "series_count": count,
            "max_series": self.max_series,
            "dropped_series": dropped,
            "bytes_per_series": sum(28 * n for _, n in self._plan),
            "names": {k: names[k] for k in sorted(names)},
        } | (
            {"spool": self.spool_status()} if self._spools else {}
        )

    def query(self, name: str, labels: dict[str, str] | None = None,
              window_s: float = 3600.0) -> list[dict]:
        """Every series matching `name` (+ label subset filter) over the
        last `window_s`: [{labels, stage_s, points: [[t, avg, max]...]}]."""
        now_unix = time.time()
        want = labels or {}
        with self._lock:
            matches = [
                s for (n, _), s in self._series.items()
                if n == name and all(
                    s.labels.get(k) == v for k, v in want.items()
                )
            ]
            out = []
            for s in matches:
                ring = s.stage_for(window_s)
                out.append({
                    "labels": s.labels,
                    "kind": s.kind,
                    "stage_s": ring.width,
                    "points": ring.points(now_unix, window_s),
                })
        out.sort(key=lambda r: sorted(r["labels"].items()))
        return out

    # --- snapshot / restore (the durable-checkpoint ride) -------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "format": 1,
                "interval_s": self.interval_s,
                "saved_unix": round(time.time(), 3),
                "series": [
                    {
                        "name": s.name,
                        "labels": s.labels,
                        "kind": s.kind,
                        "stages": [
                            {"width_s": ring.width, "slots": ring.dump()}
                            for ring in s.stages
                        ],
                    }
                    for s in self._series.values()
                ],
            }

    def restore(self, snap: dict) -> int:
        """Merge a snapshot() payload into the live rings (strictly-newer
        slots only; see _Ring.install).  Returns the series count
        touched.  Raises TSDBError on malformed content."""
        if not isinstance(snap, dict) or snap.get("format") != 1:
            raise TSDBError("unrecognized tsdb snapshot format")
        touched = 0
        with self._lock:
            for row in snap.get("series", ()):
                name = row.get("name")
                labels = row.get("labels") or {}
                if not isinstance(name, str) or not isinstance(labels, dict):
                    raise TSDBError("malformed tsdb snapshot series row")
                s = self._series_for(
                    name, {str(k): str(v) for k, v in labels.items()},
                    str(row.get("kind") or "gauge"),
                )
                if s is None:
                    continue  # over the cap: counted in dropped_series
                touched += 1
                by_width = {ring.width: ring for ring in s.stages}
                for st in row.get("stages", ()):
                    ring = by_width.get(float(st.get("width_s", -1)))
                    if ring is None:
                        continue  # interval changed across the restore
                    for slot in st.get("slots", ()):
                        epoch, total, count, peak = slot
                        ring.install(
                            int(epoch), float(total), int(count), float(peak)
                        )
        return touched


# --- the process-global instance --------------------------------------------

_lock = threading.Lock()
_tsdb: TSDB | None = None


def enabled(environ=os.environ) -> bool:
    return environ.get("MISAKA_TSDB", "1") != "0"


def get() -> TSDB | None:
    return _tsdb


def ensure_started(environ=os.environ) -> TSDB | None:
    """Start (or return) the process-global collector — called by
    make_http_server so every serving process retains its own history
    from boot; None when MISAKA_TSDB=0."""
    global _tsdb
    if not enabled(environ):
        return None
    with _lock:
        if _tsdb is None:
            _tsdb = TSDB(
                interval_s=env_float(
                    environ, "MISAKA_TSDB_INTERVAL_S", DEFAULT_INTERVAL_S
                ),
                max_series=int(env_float(
                    environ, "MISAKA_TSDB_MAX_SERIES", DEFAULT_MAX_SERIES
                )),
                budget=env_float(
                    environ, "MISAKA_TSDB_BUDGET", DEFAULT_BUDGET
                ),
                # the durable telemetry plane (unset = today's behavior)
                spool_dir=environ.get("MISAKA_TSDB_DIR") or None,
                disk_mb=env_float(
                    environ, "MISAKA_TSDB_DISK_MB", DEFAULT_DISK_MB
                ),
                long_s=env_float(
                    environ, "MISAKA_TSDB_LONG_S", DEFAULT_LONG_S
                ),
                long_slots=int(env_float(
                    environ, "MISAKA_TSDB_LONG_SLOTS", DEFAULT_LONG_SLOTS
                )),
                segment_bytes=int(env_float(
                    environ, "MISAKA_TSDB_SEG_KB", 1024.0
                ) * 1024),
            )
        if not _tsdb.running:
            _tsdb.start()
    return _tsdb


def shutdown() -> None:
    """Stop and drop the global collector (tests; the A/B's off side)."""
    global _tsdb
    with _lock:
        if _tsdb is not None:
            _tsdb.stop()
            _tsdb = None


def query(name: str, labels: dict[str, str] | None = None,
          window_s: float = 3600.0) -> list[dict]:
    t = _tsdb
    return t.query(name, labels, window_s) if t is not None else []


def index_payload() -> dict:
    t = _tsdb
    if t is None:
        return {
            "enabled": enabled(),
            "running": False,
            "series_count": 0,
            "names": {},
            "hint": "tsdb not started (MISAKA_TSDB=0, or no HTTP server "
                    "in this process)",
        }
    return t.series_index()


def query_payload(name: str, labels: dict[str, str] | None = None,
                  window_s: float = 3600.0) -> dict:
    """The GET /debug/series?name=... body."""
    return {
        "name": name,
        "window_s": window_s,
        "series": query(name, labels, window_s),
    }


def snapshot_bytes() -> bytes | None:
    """The __tsdb__ checkpoint payload (None when no collector runs)."""
    t = _tsdb
    if t is None:
        return None
    return json.dumps(t.snapshot(), separators=(",", ":")).encode()


def restore_bytes(blob: bytes) -> int:
    """Merge a snapshot_bytes() payload into the live store (starting it
    if needed); returns series touched, 0 when the TSDB is disabled."""
    t = ensure_started()
    if t is None:
        return 0
    return t.restore(json.loads(blob.decode()))
