"""The port's native flight recorder and the planes that report the native
tier, against the JAX package's.

- The recorder's rings stay within MISAKA_NATIVE_TRACE_RING and count what
  they drop; set_trace toggles a built recorder; MISAKA_NATIVE_TRACE=0
  builds none.
- `flight_payload` decodes the same event kinds and keys as the JAX
  package's for the same schedule; `pool_counters` carries the
  caller-inline lane.
- A live native server: an inbound X-Misaka-Trace ID yields native worker
  spans under that ID in /debug/perfetto beside the http and serve tiers,
  /debug/native_trace carries the ID, /healthz `debug_mem` counts the
  rings' bytes, and the sampler's payload and /debug/usage carry the
  `native_pool` block the JAX server's carry.
- The usage ledger's `native_seconds`: booked from the pool's measured
  busy-ns (conserved against `work_ns`), and unbatched from the
  interpreter call's wall time.
"""

import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from misaka_tpu import networks as jnet
from misaka_tpu.core import native_serve as jnative
from misaka_tpu.runtime.master import MasterNode as JMaster
from misaka_tpu.runtime.master import make_http_server as j_http
from misaka_tpu_torch import networks as tnet
from misaka_tpu_torch.core import native_serve
from misaka_tpu_torch.runtime import usage
from misaka_tpu_torch.runtime.master import MasterNode as TMaster
from misaka_tpu_torch.runtime.master import make_http_server as t_http
from misaka_tpu_torch.utils import metrics, sampler, tracespan
from tests.torch_native_helpers import env, every_handle_closed, small_pools  # noqa: F401

torch.set_num_threads(1)

SMALL = dict(stack_cap=8, in_cap=16, out_cap=16)


@pytest.fixture(autouse=True)
def quiet_planes(monkeypatch):
    for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG"):
        monkeypatch.setenv(switch, "0")


def pools(batch=16, **envkv):
    """The port's and the JAX package's pool for add2, same env."""
    with env(**envkv):
        t = native_serve.NativeServePool(tnet.add2(**SMALL).compile(batch=batch, device="cpu"),
                                         chunk_steps=32, threads=2)
        j = jnative.NativeServePool(jnet.add2(**SMALL).compile(batch=batch),
                                    chunk_steps=32, threads=2)
    return t, j


def serve_rounds(pool, net_batch, in_cap, rounds, init):
    state = init
    vals = np.zeros((net_batch, in_cap), np.int32)
    vals[:, 0] = 7
    counts = np.ones((net_batch,), np.int32)
    for _ in range(rounds):
        state, _ = pool.serve(state, vals, counts)
    return state


def run_both(t, j, rounds):
    serve_rounds(t, 16, 16, rounds, tnet.add2(**SMALL).compile(batch=16, device="cpu").init_state())
    serve_rounds(j, 16, 16, rounds, jnet.add2(**SMALL).compile(batch=16).init_state())


def test_ring_bound_enforced_and_dropped_counted():
    before = metrics.parse_text(metrics.render()).get("misaka_native_trace_dropped_total", 0.0)
    t, j = pools(MISAKA_NATIVE_TRACE_RING="64")
    try:
        info = t._pool.trace_info()
        assert info == {**j._pool.trace_info(), "dropped": info["dropped"]}
        assert info["rings"] == t.threads + 1 and info["capacity"] == 64
        run_both(t, j, 200)
        for ring in range(info["rings"]):
            recs, cursor, dropped = t._pool.trace_read(ring)
            assert len(recs) <= 64 and cursor >= len(recs)
            assert dropped == max(0, cursor - 64)
        assert t._pool.trace_info()["dropped"] > 0
        t._pull_trace_stats(force=True)
        run_both(t, j, 50)
        t._pull_trace_stats(force=True)
        after = metrics.parse_text(metrics.render()).get("misaka_native_trace_dropped_total", 0.0)
        assert after > before
    finally:
        t.close()
        j.close()


def test_trace_set_runtime_toggle_and_kill_switch():
    t, j = pools()
    try:
        run_both(t, j, 3)
        assert native_serve.set_trace(False)
        cursors = [t._pool.trace_read(r)[1] for r in range(t.threads + 1)]
        run_both(t, j, 5)
        assert cursors == [t._pool.trace_read(r)[1] for r in range(t.threads + 1)]
        assert native_serve.set_trace(True)
        run_both(t, j, 3)
        assert sum(t._pool.trace_read(r)[1] for r in range(t.threads + 1)) > sum(cursors)
    finally:
        native_serve.set_trace(native_serve.trace_enabled())
        t.close()
        j.close()
    t, j = pools(MISAKA_NATIVE_TRACE="0")
    try:
        assert t._pool.trace_info()["rings"] == j._pool.trace_info()["rings"] == 0
        assert not t._pool.trace_set(True)
        run_both(t, j, 2)  # serving without rings
        assert native_serve.flight_mem_bytes() == 0
    finally:
        t.close()
        j.close()


def test_payload_and_counters_match_jax():
    t, j = pools()
    try:
        run_both(t, j, 20)
        payloads = [native_serve.flight_payload(), jnative.flight_payload()]
        shapes = []
        for p in payloads:
            assert p["enabled"] and len(p["pools"]) >= 1
            pool = p["pools"][-1]
            kinds = {ev["kind"] for ring in pool["rings"] for ev in ring["events"]}
            keys = {k: sorted({kk for ring in pool["rings"] for ev in ring["events"]
                               if ev["kind"] == k for kk in ev}) for k in kinds}
            shapes.append((sorted(pool), [r["role"] for r in pool["rings"]], keys))
            assert {"serve", "unit"} <= kinds
        assert shapes[0] == shapes[1]
        stats = [t._pool.trace_stats(), j._pool.trace_stats()]
        assert stats[0]["serve_calls"] == stats[1]["serve_calls"] >= 20
        assert set(stats[0]["reps"]) == set(stats[1]["reps"])
        pc = native_serve.pool_counters()
        assert pc["caller_inline_ns"] == pc["serial_ns"]
        assert pc["work_ns"] == pc["busy_ns"] + pc["caller_inline_ns"] > 0
        # `pools` (the per-pool split) rides either payload while more than
        # one pool of that package is live in the process
        assert set(pc) - {"pools"} == set(jnative.pool_counters()) - {"pools"}
        assert native_serve.flight_mem_bytes() >= 32 * t._pool.trace_info()["capacity"] * 3
    finally:
        t.close()
        j.close()


def test_usage_books_the_pool_busy_time():
    usage.reset()
    t, j = pools()
    try:
        t.usage_label = lambda: "tenant-a"
        mark = t._pool.counters()["work_ns"]
        run_both(t, j, 30)
        booked = usage.program_snapshot("tenant-a")["native_seconds"]
        work = (t._pool.counters()["work_ns"] - mark) * 1e-9
        assert booked > 0
        assert abs(booked - work) <= 1e-5 + 0.02 * work  # what the pool measured
        parsed = metrics.parse_text(metrics.render())
        assert parsed['misaka_usage_native_seconds_total{program="tenant-a"}'] >= booked - 1e-6
    finally:
        t.close()
        j.close()
        usage.reset()


def test_usage_books_unbatched_wall_time():
    usage.reset()
    m = TMaster(tnet.add2(**SMALL), chunk_steps=16, engine="native", device="cpu")
    m.program_label = "solo"
    m.run()
    try:
        assert m.compute_many([1, 2, 3]) == [3, 4, 5]
        assert usage.program_snapshot("solo")["native_seconds"] > 0
    finally:
        m.close()
        usage.reset()


def _fetch(conn, path):
    conn.request("GET", path)
    r = conn.getresponse()
    return json.loads(r.read())


def test_live_server_perfetto_native_trace_and_debug_mem():
    tracespan.clear()
    m = TMaster(tnet.add2(in_cap=64, out_cap=64, stack_cap=16), chunk_steps=64, batch=16,
                engine="native", device="cpu")
    httpd = t_http(m, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    tid = "f11687aaf11687aa"
    conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=30)
    try:
        m.run()
        vals = np.arange(32, dtype="<i4")
        for _ in range(6):
            conn.request("POST", "/compute_raw?spread=1", vals.tobytes(), {"X-Misaka-Trace": tid})
            r = conn.getresponse()
            body = r.read()
            assert r.status == 200 and (np.frombuffer(body, "<i4") == vals + 2).all()
        deadline = time.monotonic() + 10
        while True:
            tiers, spans = set(), 0
            for ev in _fetch(conn, "/debug/perfetto")["traceEvents"]:
                if ev.get("ph") == "X" and ev.get("args", {}).get("trace_id") == tid:
                    tiers.add(tracespan.tier_of(ev["name"]))
                    spans += ev["name"].startswith("native.")
            if (spans and {"http", "serve", "native"} <= tiers) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        assert spans > 0 and {"http", "serve", "native"} <= tiers, tiers
        nt = _fetch(conn, "/debug/native_trace?n=50")
        ids = {i for p in nt["pools"] for ring in p["rings"] for ev in ring["events"]
               for i in ev.get("trace_ids", ())}
        assert tid in ids
        assert all(len(ring["events"]) <= 50 for p in nt["pools"] for ring in p["rings"])
        mem = _fetch(conn, "/healthz")["debug_mem"]
        assert mem["flight_bytes"] == native_serve.flight_mem_bytes() > 0
        assert mem["total_bytes"] == mem["trace_bytes"] + mem["flight_bytes"] + mem["capture_bytes"]
    finally:
        conn.close()
        httpd.shutdown()
        httpd.server_close()
        m.close()
        tracespan.clear()


@pytest.mark.parametrize("route", ["/debug/usage", "/debug/flamegraph"])
def test_native_pool_block_on_both_servers(route, monkeypatch):
    """While a native pool serves, /debug/usage and the sampler's payload
    carry `native_pool` on both servers, with the same keys."""
    monkeypatch.setenv("MISAKA_SAMPLER", "1")
    ms = [JMaster(jnet.add2(**SMALL), chunk_steps=16, batch=8, engine="native"),
          TMaster(tnet.add2(**SMALL), chunk_steps=16, batch=8, engine="native", device="cpu")]
    hs = [j_http(ms[0], port=0), t_http(ms[1], port=0)]
    blocks = []
    try:
        for m, h in zip(ms, hs):
            threading.Thread(target=h.serve_forever, daemon=True).start()
            m.run()
            assert m.compute_spread(list(range(40))) == list(range(2, 42))
            conn = http.client.HTTPConnection("127.0.0.1", h.server_address[1], timeout=30)
            blocks.append(_fetch(conn, route)["native_pool"])
            conn.close()
        assert set(blocks[0]) - {"pools"} == set(blocks[1]) - {"pools"}
        assert blocks[1]["work_ns"] > 0
    finally:
        for m, h in zip(ms, hs):
            h.shutdown()
            h.server_close()
            m.close()
        sampler.shutdown()
        from misaka_tpu.utils import sampler as jsampler

        jsampler.shutdown()
