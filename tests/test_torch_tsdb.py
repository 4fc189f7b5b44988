"""The port's embedded TSDB (utils/tsdb.py) and regression watchdog
(utils/watchdog.py) against the JAX package's.

The cases of tests/test_tsdb.py run on both packages and their results
are compared exactly: the window grammar, ring reclaim and the
strictly-newer install, the stage plan, counters as rates with the reset
re-base, histograms as :p50/:p99/:rate, labelled children, the series cap
with the priority families, query stage selection, snapshot and restore
(a snapshot of either package restores in the other, byte for byte), the
kill switch and the module surface; then the watchdog's grammar, its
absolute and ratio rules with sustain and clear, an absent series, and
the defaults and env.

Every TSDB reads its own registry (the process registry holds every
series of the suite) and one injected clock: each module's `time` is
replaced by a fake that the test advances, so the two packages see the
same instants and their payloads compare with ==.  Observations come
from a numpy generator with a fixed seed.
"""

import json
import types

import numpy as np
import pytest

from misaka_tpu.utils import metrics as jmetrics
from misaka_tpu.utils import tsdb as jtsdb
from misaka_tpu.utils import watchdog as jwatchdog
from misaka_tpu_torch.utils import metrics as tmetrics
from misaka_tpu_torch.utils import tsdb as ttsdb
from misaka_tpu_torch.utils import watchdog as twatchdog

PKGS = {
    "jax": types.SimpleNamespace(metrics=jmetrics, tsdb=jtsdb, watchdog=jwatchdog),
    "torch": types.SimpleNamespace(metrics=tmetrics, tsdb=ttsdb, watchdog=twatchdog),
}


class FakeTime:
    """time.time / monotonic / perf_counter on one advancing clock."""

    def __init__(self, t=1_700_000_000.0):
        self.t = t

    def time(self):
        return self.t

    def monotonic(self):
        return self.t - 1_600_000_000.0

    def perf_counter(self):
        return self.t - 1_600_000_000.0

    def sleep(self, s):
        self.t += s


@pytest.fixture
def clock(monkeypatch):
    c = FakeTime()
    for p in PKGS.values():
        monkeypatch.setattr(p.tsdb, "time", c)
        monkeypatch.setattr(p.watchdog, "time", c)
    return c


@pytest.fixture(autouse=True)
def _clean():
    yield
    for p in PKGS.values():
        p.watchdog.shutdown()
        p.tsdb.shutdown()


def both(fn, clock=None):
    """fn(package namespace) on each package; the two results.  With the
    fake clock, each run starts at the same instant."""
    out = []
    for p in PKGS.values():
        if clock is not None:
            clock.t = FakeTime().t
        out.append(fn(p))
    return out


def private_db(p, interval_s=1.0, **kw):
    reg = p.metrics.Registry()
    return p.tsdb.TSDB(interval_s=interval_s, registry=reg, **kw), reg


def raises_or(fn):
    try:
        return ("ok", fn())
    except (ValueError, TypeError) as e:
        return (type(e).__name__, str(e))


# --- grammar -------------------------------------------------------------------------------


WINDOWS = ["30s", "5m", "1h", "90", 120, "0.5s", "7d", "2d", "", "abc", "-5s", "0", "5x", "0s",
           "d", "1e3s", "inf"]


@pytest.mark.parametrize("text", WINDOWS, ids=[repr(w) for w in WINDOWS])
def test_parse_window_equal_jax(text):
    a, b = both(lambda p: (raises_or(lambda: p.tsdb.parse_window(text)),
                           raises_or(lambda: p.tsdb.parse_window(text, allow_zero=True))))
    assert a == b


QUERIES = [{}, {"name": ["misaka_x"]}, {"name": ["a"], "window": ["5m"]},
           {"name": ["a"], "label": ["route=/compute", "program=p"]}, {"name": ["a"], "label": ["x"]},
           {"name": ["a"], "window": ["bogus"]}, {"label": ["k=v"]}, {"window": ["7d"]}]


@pytest.mark.parametrize("query", QUERIES, ids=[json.dumps(q) for q in QUERIES])
def test_parse_query_equal_jax(query):
    a, b = both(lambda p: raises_or(lambda: p.tsdb.parse_query(query)))
    assert a == b


@pytest.mark.parametrize("interval", [5.0, 0.1, 1.0, 60.0, 600.0])
def test_stage_plan_equal_jax(interval):
    a, b = both(lambda p: (p.tsdb._stage_plan(interval),
                           p.tsdb._stage_plan(interval, long_s=300.0, long_slots=4032)))
    assert a == b


# --- rings ---------------------------------------------------------------------------------


def test_ring_reclaim_and_install_equal_jax():
    def run(p):
        ring = p.tsdb._Ring(width=1.0, length=4)
        ring.add(1000.0, 5.0)
        ring.add(1000.2, 7.0)
        ring.add(1001.0, 1.0)
        out = [ring.points(1001.5, window_s=4.0)]
        ring.add(1004.0, 9.0)  # the slot of epoch 1000, reclaimed
        out += [ring.points(1004.5, window_s=4.0), ring.points(2000.0, window_s=4.0)]
        ring = p.tsdb._Ring(width=1.0, length=8)
        ring.add(1000.0, 5.0)
        ring.install(1000 - 8, 99.0, 1, 99.0)  # older: refused
        ring.install(1000, 99.0, 1, 99.0)  # same epoch: refused
        ring.install(1001, 4.0, 2, 3.0)  # strictly newer: installs
        ring.merge(1001, 2.0, 1, 8.0)
        out += [ring.points(1001.5, 8.0), ring.slot_at(1001), ring.dump()]
        return out

    a, b = both(run)
    assert a == b
    assert a[0] == [[1000.0, 6.0, 7.0], [1001.0, 1.0, 1.0]] and a[2] == []


# --- the collector -------------------------------------------------------------------------


def _scenario(p, clock, seed=7, max_series=512, steps=12):
    """One deterministic collection run over a private registry: gauges
    (one labelled), a counter with a reset, a histogram fed by a seeded
    generator, sampled every second of the fake clock."""
    rng = np.random.default_rng(seed)
    db, reg = private_db(p, max_series=max_series)
    m = p.metrics
    g = m.gauge("t_gauge", "x", registry=reg)
    gl = m.gauge("t_gauge_l", "x", ("route",), registry=reg)
    c = m.counter("t_counter", "x", ("program",), registry=reg)
    h = m.histogram("t_hist", "x", registry=reg)
    obs = rng.lognormal(-4.0, 1.0, size=(steps, 20))
    for i in range(steps):
        g.set(float(i % 5))
        gl.labels(route=f"/r{i % 3}").set(float(i))
        c.labels(program="a").inc(float(rng.integers(0, 100)))
        if i == 6:  # a counter reset re-bases, never a negative rate
            child = c.labels(program="a")
            with child._lock:
                child._value = 1.0
        if i % 4 != 3:  # idle intervals write no false-zero quantile
            for v in obs[i]:
                h.observe(float(v))
        db.sample_once()
        clock.sleep(1.0)
    return db


def _db_view(db, names, windows=(10.0, 1000.0, 100000.0)):
    idx = db.series_index()
    for k in ("running", "effective_interval_s", "sample_cost_us"):
        idx.pop(k)
    return idx, {(n, w): db.query(n, window_s=w) for n in names for w in windows}


NAMES = ["t_gauge", "t_gauge_l", "t_counter", "t_hist:p50", "t_hist:p99", "t_hist:rate"]


def test_collector_series_equal_jax(clock):
    a, b = both(lambda p: _db_view(_scenario(p, clock), NAMES), clock)
    assert a == b
    idx, rows = b
    assert idx["series_count"] == 8 and idx["dropped_series"] == 0
    assert [r["stage_s"] for r in rows[("t_gauge", 10.0)]] == [1.0]
    assert [r["stage_s"] for r in rows[("t_gauge", 1000.0)]] == [60.0]
    assert [r["stage_s"] for r in rows[("t_gauge", 100000.0)]] == [300.0]
    counter = rows[("t_counter", 10.0)][0]
    assert counter["kind"] == "rate" and all(pt[1] >= 0 for pt in counter["points"])
    assert [r["labels"] for r in rows[("t_gauge_l", 10.0)]] == [
        {"route": "/r0"}, {"route": "/r1"}, {"route": "/r2"}]
    # the idle intervals write no quantile point (every fourth of 12)
    assert len(rows[("t_hist:p99", 10.0)][0]["points"]) == 6


def test_series_cap_and_priority_equal_jax(clock):
    def run(p):
        db, reg = private_db(p, max_series=16)
        flood = p.metrics.gauge("t_flood", "x", ("k",), registry=reg)
        for i in range(40):
            flood.labels(k=str(i)).set(1.0)
        p.metrics.gauge("misaka_canary_success", "x", ("tier",), registry=reg).labels(
            tier="full").set(1.0)
        db.sample_once()
        idx = db.series_index()
        return (idx["series_count"], idx["dropped_series"], idx["bytes_per_series"],
                db.query("misaka_canary_success", window_s=60))

    a, b = both(run, clock)
    assert a == b
    assert a[0] == 16 and a[1] > 0 and a[3] and a[2] == 28 * (720 + 360 + 288)


# --- snapshot / restore --------------------------------------------------------------------


def test_snapshot_bytes_equal_and_cross_restore(clock):
    dbs = {}
    for name, p in PKGS.items():
        clock.t = FakeTime().t  # both scenarios on the same instants
        dbs[name] = _scenario(p, clock)
    snaps = {name: db.snapshot() for name, db in dbs.items()}
    assert json.dumps(snaps["jax"], sort_keys=True) == json.dumps(snaps["torch"], sort_keys=True)
    for src, dst in (("jax", "torch"), ("torch", "jax")):
        fresh, _ = private_db(PKGS[dst])
        blob = json.loads(json.dumps(snaps[src]))
        assert fresh.restore(blob) == 8
        assert _db_view(fresh, NAMES)[1] == _db_view(dbs[src], NAMES)[1]
        fresh.restore(blob)  # the same snapshot again: a no-op
        assert _db_view(fresh, NAMES)[1] == _db_view(dbs[src], NAMES)[1]


def test_restore_keeps_fresher_history_and_rejects_garbage_equal_jax(clock):
    def run(p):
        db, reg = private_db(p)
        g = p.metrics.gauge("t_clob", "x", registry=reg)
        g.set(1.0)
        db.sample_once()
        stale = db.snapshot()
        clock.sleep(1.1)
        g.set(2.0)
        db.sample_once()
        db.restore(stale)
        out = [db.query("t_clob", window_s=60)]
        for bad in ({"format": 99}, {"format": 1, "series": [{"name": 7}]}, []):
            out.append(raises_or(lambda: db.restore(bad)))
        return out

    a, b = both(run, clock)
    assert a == b
    assert a[0][0]["points"][-1][1] == 2.0 and a[1][0] == "TSDBError"


def test_module_surface_and_kill_switch_equal_jax(monkeypatch, clock):
    monkeypatch.setenv("MISAKA_TSDB_INTERVAL_S", "1.0")

    def run(p):
        p.tsdb.shutdown()
        db = p.tsdb.ensure_started()
        db.stop()  # the collector thread off: the test drives the samples
        g = p.metrics.gauge("t_tsdb_module_surface", "x")
        g.set(5.0)
        db.sample_once()
        blob = p.tsdb.snapshot_bytes()
        p.tsdb.shutdown()
        out = [p.tsdb.snapshot_bytes(), p.tsdb.restore_bytes(blob) >= 1,
               p.tsdb.query("t_tsdb_module_surface", window_s=60),
               p.tsdb.query_payload("t_tsdb_module_surface", {}, 60.0)]
        p.tsdb.shutdown()
        monkeypatch.setenv("MISAKA_TSDB", "0")
        out += [p.tsdb.ensure_started(), p.tsdb.restore_bytes(b"{}"),
                p.tsdb.index_payload(), p.tsdb.query_payload("x", {}, 60.0)]
        monkeypatch.delenv("MISAKA_TSDB")
        return out

    a, b = both(run, clock)
    assert a == b
    assert a[0] is None and a[1] is True and a[2][0]["points"][-1][1] == 5.0
    assert a[4] is None and a[5] == 0 and a[6]["running"] is False


def test_collector_thread_and_governor(monkeypatch):
    monkeypatch.setenv("MISAKA_TSDB_INTERVAL_S", "0.05")
    monkeypatch.setenv("MISAKA_TSDB_BUDGET", "0.5")
    import time

    for p in PKGS.values():
        p.tsdb.shutdown()
        db = p.tsdb.ensure_started()
        deadline = time.monotonic() + 10
        while db._samples < 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert db._samples >= 3, "collector thread never sampled"
        db._cost_ema = 1.0  # the governor stretches the period to the budget
        assert db._current_period() == pytest.approx(1.0 / db.budget)
        p.tsdb.shutdown()


# --- the watchdog --------------------------------------------------------------------------


SPECS = ["p99=foo_seconds:p99{route=/x}>2x@1h for 5m ->page", "bar<1", "a=b>3 for 2s ->warning",
         "x>1,y<2 for 1h", "nonsense", "foo>>1", "foo>1 ->fatal", "foo>0x@1h", "][broken", "",
         "c=misaka_canary_success{tier=full}<1 for 20s ->page"]


@pytest.mark.parametrize("text", SPECS)
def test_watchdog_spec_equal_jax(text):
    def parse(p):
        try:
            return [r.payload() for r in p.watchdog.parse_spec(text)]
        except p.watchdog.WatchdogSpecError as e:
            return ("error", str(e))

    a, b = both(parse)
    assert a == b


@pytest.mark.parametrize("interval", [5.0, 1.0, 0.1])
def test_watchdog_defaults_equal_jax(interval):
    a, b = both(lambda p: [r.payload() for r in p.watchdog.default_rules(interval)])
    assert a == b
    assert [r["rule"] for r in a] == ["canary-full", "p99-drift", "replica-restarts",
                                      "tsdb-spool-drops", "capture-spool-drops", "spool-errors"]


def _drive_rule(p, clock, spec, values, recent_s=0.2, min_points=5, interval=0.05):
    """Set the gauge to each value in turn, sample and evaluate; the rule
    payload after each step."""
    db, reg = private_db(p, interval_s=interval)
    g = p.metrics.gauge("t_wd", "x", registry=reg)
    w = p.watchdog.Watchdog(p.watchdog.parse_spec(spec), recent_s=recent_s,
                            min_points=min_points)
    trail = []
    for v in values:
        g.set(v)
        db.sample_once()
        w.evaluate(db)
        trail.append((w.overall_state(), w.payload()))
        clock.sleep(interval + 0.01)
    return trail


def test_watchdog_absolute_rule_fires_sustains_and_clears_equal_jax(clock):
    values = [5.0] * 6 + [0.0] * 10
    a, b = both(lambda p: _drive_rule(p, clock, "hot=t_wd>2 for 0.15s ->page", values), clock)
    assert a == b
    states = [s for s, _ in b]
    assert states[0] == "ok" and "page" in states and states[-1] == "ok"
    first_page = states.index("page")
    assert first_page >= 2  # held for the sustain first
    rule = b[first_page][1]["rules"][0]
    assert rule["value"] == pytest.approx(5.0) and rule["since_unix"] > 0
    assert states[6] == "page"  # the clear sustains too


def test_watchdog_ratio_rule_needs_baseline_then_catches_drift_equal_jax(clock):
    values = [1.0] * 9 + [10.0] * 6
    a, b = both(lambda p: _drive_rule(p, clock, "d=t_wd>3x@30s for 0s", values,
                                      recent_s=0.1, min_points=3), clock)
    assert a == b
    assert b[0][0] == "ok" and b[0][1]["rules"][0].get("baseline") is None
    assert b[-1][0] == "warning"
    assert b[-1][1]["rules"][0]["baseline"] == pytest.approx(1.0, abs=0.2)


def test_watchdog_absent_series_holds_equal_jax(clock):
    def run(p):
        db, _ = private_db(p, interval_s=0.05)
        w = p.watchdog.Watchdog(p.watchdog.parse_spec("ghost=misaka_never_exists<1 for 0s ->page"),
                                recent_s=0.2)
        w.evaluate(db)
        return w.overall_state(), w.payload()

    a, b = both(run, clock)
    assert a == b and a[0] == "ok"


@pytest.mark.parametrize("spec", ["one=foo>1 for 1s", "][broken", "0", None])
def test_watchdog_env_equal_jax(monkeypatch, spec):
    monkeypatch.setenv("MISAKA_TSDB_INTERVAL_S", "1.0")
    if spec is None:
        monkeypatch.delenv("MISAKA_WATCHDOG", raising=False)
    else:
        monkeypatch.setenv("MISAKA_WATCHDOG", spec)

    def run(p):
        p.tsdb.shutdown()
        p.watchdog.shutdown()
        w = p.watchdog.ensure_started()
        out = (None if w is None else [r.name for r in w.rules], p.watchdog.overall_state(),
               p.watchdog.debug_payload())
        p.watchdog.shutdown()
        p.tsdb.shutdown()
        return out

    a, b = both(run)
    assert a == b
    if spec == "one=foo>1 for 1s":
        assert a[0] == ["one"]
    elif spec == "][broken":
        assert "spec_error" in a[2] and "canary-full" in a[0]
    elif spec == "0":
        assert a[:2] == (None, None)
