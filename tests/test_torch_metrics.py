"""The port's metrics plane (misaka_tpu_torch/utils/metrics.py) against the
JAX package's.

The reference's registry unit cases (tests/test_metrics.py) run on the
port's copy, and the same seeded observations go through both packages'
registries: the exposition text must be byte-identical, and
quantile_from_buckets, fraction_over, parse_text and delta must agree
exactly.
"""

import bisect
import math
import threading

import numpy as np
import pytest

from misaka_tpu.utils import metrics as ref_metrics
from misaka_tpu_torch.utils import metrics

SEEDS = (0, 1, 2, 3)


# --- the reference's registry unit cases, on the port's copy -----------------


def test_log_buckets_shape():
    b = metrics.log_buckets(1e-5, 10.0, per_decade=3)
    assert b[0] == 1e-5 and b[-1] == 10.0
    assert all(y > x for x, y in zip(b, b[1:]))
    ratios = [y / x for x, y in zip(b, b[1:])]
    assert all(abs(r - 10 ** (1 / 3)) < 0.01 for r in ratios)
    assert metrics.pow2_buckets(1, 16) == (1.0, 2.0, 4.0, 8.0, 16.0)
    with pytest.raises(metrics.MetricError):
        metrics.log_buckets(10, 1)
    assert metrics.DURATION_BUCKETS == ref_metrics.DURATION_BUCKETS


def test_counter_rejects_negative_and_gauge_callback():
    r = metrics.Registry()
    c = metrics.counter("t_total", "h", registry=r)
    c.inc(2.5)
    with pytest.raises(metrics.MetricError):
        c.inc(-1)
    g = metrics.gauge("t_gauge", "h", registry=r)
    g.set_function(lambda: 41 + 1)
    assert g.value == 42
    g.set(7)
    g.set_function(lambda: 1 / 0)  # a crashing callback reads the stored value
    assert g.value == 7
    assert "t_gauge 7" in r.render()


def test_get_or_create_idempotent_and_shape_checked():
    r = metrics.Registry()
    a = metrics.counter("same_total", "h", ("x",), registry=r)
    assert metrics.counter("same_total", "h", ("x",), registry=r) is a
    with pytest.raises(metrics.MetricError):
        metrics.gauge("same_total", "h", registry=r)
    with pytest.raises(metrics.MetricError):
        metrics.counter("same_total", "h", ("y",), registry=r)
    h = metrics.histogram("same_h", "h", buckets=(1, 2), registry=r)
    assert metrics.histogram("same_h", "h", buckets=(1, 2), registry=r) is h
    with pytest.raises(metrics.MetricError):
        metrics.histogram("same_h", "h", buckets=(1, 2, 3), registry=r)


def test_labels_validated():
    r = metrics.Registry()
    c = metrics.counter("lab_total", "h", ("route",), registry=r)
    with pytest.raises(metrics.MetricError):
        c.inc()
    with pytest.raises(metrics.MetricError):
        c.labels(wrong="x")
    c.labels(route="/a").inc()
    assert c.labels(route="/a") is c.labels(route="/a")


def test_exposition_roundtrip_with_escaping():
    r = metrics.Registry()
    c = metrics.counter("esc_total", "back\\slash and\nnewline", ("v",), registry=r)
    weird = 'quote " back \\ newline \n end'
    c.labels(v=weird).inc(3)
    parsed = metrics.parse_text(r.render())
    [(series, value)] = [kv for kv in parsed.items() if kv[0].startswith("esc")]
    assert value == 3
    name, labels = metrics.parse_series(series)
    assert name == "esc_total" and labels == {"v": weird}


def test_histogram_render_consistency():
    r = metrics.Registry()
    h = metrics.histogram("lat_seconds", "h", ("k",), buckets=metrics.log_buckets(0.001, 1.0),
                          registry=r)
    obs = list(np.random.default_rng(0).uniform(0.0001, 2.0, size=200))
    for v in obs:
        h.labels(k="a").observe(v)
    parsed = metrics.parse_text(r.render())
    buckets = sorted(
        (math.inf if lbl["le"] == "+Inf" else float(lbl["le"]), v)
        for s, v in parsed.items()
        for n, lbl in [metrics.parse_series(s)]
        if n == "lat_seconds_bucket" and lbl["k"] == "a"
    )
    counts = [c for _, c in buckets]
    assert buckets[-1][0] == math.inf
    assert counts == sorted(counts)
    assert counts[-1] == parsed['lat_seconds_count{k="a"}'] == len(obs)
    assert parsed['lat_seconds_sum{k="a"}'] == pytest.approx(sum(obs), rel=1e-9)
    for upper, cum in buckets[:-1]:
        assert cum == sum(1 for v in obs if v <= upper)


def test_registry_thread_safety():
    r = metrics.Registry()
    c = metrics.counter("conc_total", "h", registry=r)
    h = metrics.histogram("conc_seconds", "h", buckets=(1, 2, 4), registry=r)

    def work():
        for _ in range(1000):
            c.inc()
            h.observe(1.5)

    ts = [threading.Thread(target=work) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    parsed = metrics.parse_text(r.render())
    assert parsed["conc_total"] == 8000
    assert parsed["conc_seconds_count"] == 8000
    assert parsed["conc_seconds_sum"] == pytest.approx(8000 * 1.5)


def test_quantile_from_buckets_interpolation():
    uppers = (1.0, 2.0, 4.0)
    counts = [0, 100, 0, 0]
    assert metrics.quantile_from_buckets(uppers, counts, 0.5) == pytest.approx(1.5)
    assert metrics.quantile_from_buckets(uppers, counts, 0.25) == pytest.approx(1.25)
    assert metrics.quantile_from_buckets(uppers, counts, 1.0) == pytest.approx(2.0)
    assert metrics.quantile_from_buckets(uppers, [100, 0, 0, 0], 0.5) == pytest.approx(0.5)


def test_quantile_from_buckets_boundaries():
    uppers = (1.0, 2.0, 4.0)
    counts = [50, 50, 0, 0]
    assert metrics.quantile_from_buckets(uppers, counts, 0.5) == pytest.approx(1.0)
    assert metrics.quantile_from_buckets(uppers, counts, 0.75) == pytest.approx(1.5)
    assert metrics.quantile_from_buckets(uppers, [0, 0, 0, 10], 0.5) == pytest.approx(4.0)
    assert metrics.quantile_from_buckets(uppers, [0, 0, 0, 0], 0.99) == 0.0
    with pytest.raises(metrics.MetricError):
        metrics.quantile_from_buckets(uppers, [0, 0, 0, 0], 1.5)
    with pytest.raises(metrics.MetricError):
        metrics.quantile_from_buckets(uppers, [0, 0], 0.5)


def test_quantile_matches_exact_on_dense_grid():
    uppers = metrics.DURATION_BUCKETS
    samples = np.random.default_rng(3).lognormal(mean=-6.0, sigma=1.0, size=4000)
    counts = [0] * (len(uppers) + 1)
    for s in samples:
        counts[bisect.bisect_left(uppers, s)] += 1
    for q in (0.5, 0.9, 0.99):
        est = metrics.quantile_from_buckets(uppers, counts, q)
        exact = float(np.quantile(samples, q))
        i = bisect.bisect_left(uppers, exact)
        lo = uppers[i - 1] if i > 0 else 0.0
        hi = uppers[i] if i < len(uppers) else uppers[-1]
        assert lo <= est <= hi * 1.0001, (q, est, exact, lo, hi)


def test_fraction_over():
    uppers = (1.0, 2.0, 4.0)
    counts = [10, 80, 10, 0]
    assert metrics.fraction_over(uppers, counts, 1.5) == pytest.approx((80 * 0.5 + 10) / 100)
    assert metrics.fraction_over(uppers, counts, 4.0) == 0.0
    assert metrics.fraction_over(uppers, counts, 0.0) == pytest.approx(1.0)
    assert metrics.fraction_over(uppers, [0, 0, 0, 10], 100.0) == 1.0
    assert metrics.fraction_over(uppers, [0, 0, 0, 0], 1.0) == 0.0


# --- the same observations through both packages ------------------------------


def _populate(mod, seed):
    """A registry of `mod` fed a seeded stream of observations: counters,
    labeled counters with escaping, a settable gauge, a callback gauge and
    histograms on log and pow2 buckets."""
    rng = np.random.default_rng(seed)
    r = mod.Registry()
    c = mod.counter("x_requests_total", "Requests by route", ("route", "method"), registry=r)
    plain = mod.counter("x_ticks_total", "Ticks", registry=r)
    g = mod.gauge("x_inflight", "In flight \\ with a backslash", registry=r)
    cb = mod.gauge("x_depth", "Callback gauge", registry=r)
    depth = int(rng.integers(0, 1000))
    cb.set_function(lambda: depth)
    h = mod.histogram("x_seconds", "Latency", ("route",), registry=r)
    p2 = mod.histogram("x_values", "Values per pass", buckets=mod.pow2_buckets(1, 1 << 20),
                       registry=r)
    routes = ["/compute", "/compute_raw", 'odd "route"\n']
    for _ in range(300):
        route = routes[int(rng.integers(0, len(routes)))]
        c.labels(route=route, method="POST" if rng.random() < 0.8 else "GET").inc()
        plain.inc(float(rng.integers(1, 4096)))
        g.set(float(rng.normal()))
        h.labels(route=route).observe(float(rng.lognormal(-6.0, 1.5)))
        p2.observe(float(rng.integers(1, 1 << 20)))
    return r


@pytest.mark.parametrize("seed", SEEDS)
def test_exposition_byte_identical_across_packages(seed):
    text = _populate(metrics, seed).render()
    assert text == _populate(ref_metrics, seed).render()
    assert metrics.parse_text(text) == ref_metrics.parse_text(text)


@pytest.mark.parametrize("seed", SEEDS)
def test_quantile_and_fraction_agree_across_packages(seed):
    rng = np.random.default_rng(seed)
    for uppers in (metrics.DURATION_BUCKETS, metrics.pow2_buckets(1, 65536), (1.0, 2.0, 4.0)):
        counts = [int(v) for v in rng.integers(0, 50, size=len(uppers) + 1)]
        for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
            assert (metrics.quantile_from_buckets(uppers, counts, q)
                    == ref_metrics.quantile_from_buckets(uppers, counts, q))
        for t in rng.uniform(0, uppers[-1] * 1.5, size=8):
            assert (metrics.fraction_over(uppers, counts, float(t))
                    == ref_metrics.fraction_over(uppers, counts, float(t)))


@pytest.mark.parametrize("seed", SEEDS)
def test_parse_text_and_delta_agree_across_packages(seed):
    before = _populate(metrics, seed).render()
    after = _populate(metrics, seed + 100).render()
    for skip in (True, False):
        got = metrics.delta(metrics.parse_text(before), metrics.parse_text(after), skip)
        want = ref_metrics.delta(ref_metrics.parse_text(before), ref_metrics.parse_text(after),
                                 skip)
        assert got == want and got
    for series in metrics.parse_text(after):
        assert metrics.parse_series(series) == ref_metrics.parse_series(series)
