"""The port's serve scheduler (ServeBatcher) keeps the JAX package's pins.

The behaviours tests/test_serve_batcher.py and the priority-lane tests of
tests/test_edge.py pin for misaka_tpu's scheduler, run against the port's
MasterNode on the CPU (the plain version of the kernel): exact FIFO pairing
under concurrency, entries split across passes, the MISAKA_SERVE_BATCH=0
fallback to compute_spread, a reset failing an in-flight pass at once, a
timed-out pass marking its stripes stale so later requests stay paired,
hot requests cut ahead of a bulk stream, a sustained hot stream not
starving bulk work, and the HTTP body checks.  One caller on fresh masters
is compared with the JAX master's outputs value for value.

Every wait is bounded: threads are joined with a timeout and checked dead,
so a hung scheduler fails one test instead of the run.
"""

import http.client
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from misaka_tpu.runtime.master import MasterNode as JMaster
from misaka_tpu.runtime.topology import Topology as JTopology
from misaka_tpu_torch import networks
from misaka_tpu_torch.runtime.master import ComputeTimeout, MasterNode, make_http_server
from misaka_tpu_torch.runtime.topology import Topology

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _master(batch=4, engine="scan", **kw):
    return MasterNode(networks.add2(in_cap=16, out_cap=16, stack_cap=16),
                      chunk_steps=32, batch=batch, engine=engine, device="cpu", **kw)


def _join_all(threads, timeout=60):
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    assert not any(t.is_alive() for t in threads), "a client thread hung"


@pytest.mark.parametrize("batch", [1, 4])
def test_coalesced_exact_pairing_concurrent(batch):
    m = _master(batch=batch)
    m.run()
    try:
        results = {}

        def worker(i):
            rng = np.random.default_rng(i)
            ok = []
            for _ in range(6):
                vals = rng.integers(-1000, 1000, size=int(rng.integers(1, 9)))
                got = m.compute_coalesced(vals.astype(np.int32), timeout=30)
                ok.append(got == [int(v) + 2 for v in vals])
            results[i] = all(ok)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        _join_all(threads)
        assert len(results) == 8 and all(results.values()), results
        st = m.status()
        # 48 requests fused into fewer passes than requests
        assert 0 < st["serve_passes"] <= st["requests_total"] == 48
    finally:
        m.close()


def test_coalesced_large_entry_splits_across_passes():
    # larger than the machine's one-refill capacity (4 slots x 16 values):
    # split over several passes, order kept
    m = _master(batch=4)
    m.run()
    try:
        vals = np.arange(300, dtype=np.int32)
        out = m.compute_coalesced(vals, timeout=60, return_array=True)
        np.testing.assert_array_equal(out, vals + 2)
        assert m.status()["serve_passes"] >= -(-300 // 64)
    finally:
        m.close()


def test_coalesced_empty_and_validation():
    m = _master(batch=2)
    try:
        assert m.compute_coalesced([]) == []
        assert m.compute_coalesced([], return_array=True).shape == (0,)
        with pytest.raises(ValueError):
            m.compute_coalesced([[1, 2], [3, 4]])
        assert m._batcher._workers == []  # no work, no threads
    finally:
        m.close()


def test_serve_batch_disabled_falls_back(monkeypatch):
    monkeypatch.setenv("MISAKA_SERVE_BATCH", "0")
    m = _master(batch=2)
    assert m._batcher is None
    m.run()
    try:
        assert m.compute_coalesced([5, 6]) == [7, 8]  # compute_spread path
        vals = np.arange(40, dtype=np.int32)       # > one stripe: both slots
        np.testing.assert_array_equal(m.compute_coalesced(vals, return_array=True), vals + 2)
        assert m.status()["serve_passes"] == 0
    finally:
        m.close()


def test_compute_spread_stripes_from_slot_zero():
    """compute_spread acquires free slots from 0 up: on a fresh running_total
    master the four stripes are four running totals, in slot order."""
    with open(os.path.join(EXAMPLES, "running_total.json")) as f:
        text = f.read()
    m = MasterNode(Topology.from_json(text, in_cap=8, out_cap=8, stack_cap=8),
                   chunk_steps=32, batch=4, device="cpu")
    m.run()
    try:
        vals = np.arange(1, 33, dtype=np.int32)
        got = m.compute_spread(vals, return_array=True)
        want = np.concatenate([np.cumsum(p) for p in np.split(vals, 4)])
        np.testing.assert_array_equal(got, want)
        # compute_spread leaves the rotation alone: a pinned follow-up
        # starts its scan at slot 0, which carries the first stripe's total
        assert m.compute_many([1]) == [int(want[7]) + 1]
    finally:
        m.close()


def test_single_caller_matches_jax(monkeypatch):
    """One caller on fresh masters, a stream that fits one pass (<= B x
    in_cap): the scheduler takes slots 0-3 in order on both packages, so a
    stateful network answers value for value the same."""
    with open(os.path.join(EXAMPLES, "running_total.json")) as f:
        text = f.read()
    caps = dict(in_cap=8, out_cap=8, stack_cap=8)
    jm = JMaster(JTopology.from_json(text, **caps), chunk_steps=32, batch=4, engine="scan")
    tm = MasterNode(Topology.from_json(text, **caps), chunk_steps=32, batch=4, device="cpu")
    jm.run()
    tm.run()
    try:
        vals = np.random.default_rng(7).integers(-1000, 1000, size=29).astype(np.int32)
        want = jm.compute_coalesced(vals, return_array=True)
        got = tm.compute_coalesced(vals, return_array=True)
        np.testing.assert_array_equal(got, want)
    finally:
        jm.close()
        tm.close()


def test_reset_fails_inflight_request_promptly():
    # a paused network holds the request in flight; reset must fail it well
    # inside its timeout, and the next request must compute cleanly
    m = _master(batch=2)
    m.run()
    try:
        assert m.compute_coalesced([1]) == [3]
        m.pause()
        errs = []

        def waiter():
            t0 = time.monotonic()
            try:
                m.compute_coalesced([1, 2, 3], timeout=20)
            except ComputeTimeout:
                errs.append(time.monotonic() - t0)

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.3)
        m.reset()
        _join_all([t], timeout=10)
        assert errs and errs[0] < 5, errs
        m.run()
        assert m.compute_coalesced([9]) == [11]
    finally:
        m.close()


def test_timed_out_pass_marks_stripes_stale():
    """A pass that times out on a paused network leaves its stripes' outputs
    owed; they surface after /run and are discarded, so every later request
    gets its own answers."""
    m = _master(batch=4)
    m.run()
    try:
        assert m.compute_coalesced([0]) == [2]
        m.pause()
        with pytest.raises(ComputeTimeout, match="no output for"):
            m.compute_coalesced(np.arange(100, 150, dtype=np.int32), timeout=0.5)
        # the pass's own collect gives up at the same deadline and marks
        # the slots it never collected
        deadline = time.monotonic() + 10
        while sum(m._stale) == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert sum(m._stale) > 0
        m.run()
        for k in range(3):
            vals = np.arange(40, dtype=np.int32) * (k + 1)
            np.testing.assert_array_equal(
                m.compute_coalesced(vals, timeout=30, return_array=True), vals + 2)
        assert m.compute_many([5], timeout=30) == [7]
    finally:
        m.close()


def test_small_requests_preempt_a_bulk_stream(monkeypatch):
    monkeypatch.setenv("MISAKA_LANE_SMALL", "64")
    m = _master(batch=4)
    m.run()
    try:
        done: dict[str, float] = {}
        bulk = np.arange(384, dtype=np.int32)  # 6 passes at 4 x 16
        outs = {}

        def run_bulk():
            outs["bulk"] = m.compute_coalesced(bulk, timeout=60, return_array=True)
            done["bulk"] = time.monotonic()

        def run_small(i):
            outs[i] = m.compute_coalesced(np.arange(8, dtype=np.int32) + i,
                                          timeout=60, return_array=True)
            done[i] = time.monotonic()

        tb = threading.Thread(target=run_bulk)
        tb.start()
        time.sleep(0.05)  # the bulk entry occupies the scheduler
        smalls = [threading.Thread(target=run_small, args=(i,)) for i in range(6)]
        for t in smalls:
            t.start()
        _join_all(smalls + [tb])
        np.testing.assert_array_equal(outs["bulk"], bulk + 2)
        for i in range(6):
            np.testing.assert_array_equal(outs[i], np.arange(8) + i + 2)
        assert max(done[i] for i in range(6)) < done["bulk"]
    finally:
        m.close()


def test_sustained_hot_stream_does_not_starve_bulk(monkeypatch):
    monkeypatch.setenv("MISAKA_LANE_SMALL", "64")
    m = _master(batch=4)
    m.run()
    stop = threading.Event()
    errors = []

    def hot_spam():
        vals = np.arange(16, dtype=np.int32)
        try:
            while not stop.is_set():
                np.testing.assert_array_equal(
                    m.compute_coalesced(vals, timeout=30, return_array=True), vals + 2)
        except Exception as e:  # recorded and failed below
            errors.append(e)

    threads = [threading.Thread(target=hot_spam) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.1)  # the hot lane is saturated before the bulk arrives
        bulk = np.arange(160, dtype=np.int32)
        np.testing.assert_array_equal(
            m.compute_coalesced(bulk, timeout=30, return_array=True), bulk + 2)
    finally:
        stop.set()
        _join_all(threads)
        m.close()
    assert not errors


def test_lane_small_zero_and_batch_max(monkeypatch):
    """MISAKA_LANE_SMALL=0 puts everything in the bulk lane; MISAKA_BATCH_MAX
    caps the values of one pass."""
    monkeypatch.setenv("MISAKA_LANE_SMALL", "0")
    monkeypatch.setenv("MISAKA_BATCH_MAX", "16")
    m = _master(batch=4)
    m.run()
    try:
        vals = np.arange(64, dtype=np.int32)
        np.testing.assert_array_equal(m.compute_coalesced(vals, return_array=True), vals + 2)
        assert m.status()["serve_passes"] == 4
        assert not m._batcher._shared.hot
    finally:
        m.close()


def test_window_and_worker_count_knobs(monkeypatch):
    """MISAKA_BATCH_PASSES sets the worker count; MISAKA_BATCH_WINDOW_US
    holds a pass for more entries while another is in flight: answers
    stay exact under both."""
    monkeypatch.setenv("MISAKA_BATCH_PASSES", "1")
    monkeypatch.setenv("MISAKA_BATCH_WINDOW_US", "20000")
    m = _master(batch=4)
    m.run()
    try:
        outs = {}

        def client(i):
            outs[i] = m.compute_coalesced(np.arange(5, dtype=np.int32) * i, timeout=30)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        _join_all(threads)
        assert len(m._batcher._workers) == 1
        assert outs == {i: (np.arange(5) * i + 2).tolist() for i in range(6)}
    finally:
        m.close()


def test_close_ends_the_workers():
    m = _master(batch=4)
    m.run()
    assert m.compute_coalesced([1, 2]) == [3, 4]
    workers = list(m._batcher._workers)
    assert workers and all(t.is_alive() for t in workers)
    m.close()
    assert not any(t.is_alive() for t in workers)
    with pytest.raises(ComputeTimeout, match="closed"):
        m.compute_coalesced([1], timeout=1)


# --- the HTTP body checks -------------------------------------------------------


@pytest.fixture
def served(monkeypatch):
    monkeypatch.setenv("MISAKA_MAX_BODY", "64")
    # a server starts the process-wide sampler, TSDB and watchdog, which
    # would outlive the test
    for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG"):
        monkeypatch.setenv(switch, "0")
    m = _master(batch=2)
    m.run()
    httpd = make_http_server(m, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        m.close()


def test_compute_raw_411_and_413(served):
    c = http.client.HTTPConnection("127.0.0.1", served, timeout=30)
    c.putrequest("POST", "/compute_raw")
    c.endheaders()  # no Content-Length
    r = c.getresponse()
    assert r.status == 411 and r.read() == b"Content-Length required"
    c.close()
    c = http.client.HTTPConnection("127.0.0.1", served, timeout=30)
    c.request("POST", "/compute_raw", body=b"\0" * 68)
    r = c.getresponse()
    assert r.status == 413 and b"MISAKA_MAX_BODY" in r.read()
    c.close()


def test_keep_alive_survives_error_responses(served):
    """Error answers read their body first: the next request on the same
    connection parses cleanly."""
    c = http.client.HTTPConnection("127.0.0.1", served, timeout=30)
    hdr = {"Content-Type": "application/x-www-form-urlencoded"}
    for body, path, code in (
        (b"value=abc", "/compute", 400),
        (b"values=1,x", "/compute_batch", 400),
        (b"\x01\x02\x03", "/compute_raw", 400),
        (b"name=c1", "/checkpoint", 403),
        (b"value=5", "/compute", 200),
        (b"values=1,2&spread=1", "/compute_batch", 200),
    ):
        c.request("POST", path, body=body, headers=hdr)
        r = c.getresponse()
        data = r.read()
        assert r.status == code, (path, data)
    assert json.loads(data) == {"values": [3, 4]}
    c.close()
