"""The port's continuous profiler (utils/sampler.py) against the JAX
package's.

The cases of tests/test_sampler.py on both packages: a busy thread lands
as a thread-rooted folded stack with the same label format, the decay
halves and prunes, the stack cap folds new shapes into "(other)", the
folded text and the payload of the same aggregate are equal, the
duty-cycle governor stretches the period by the same rule, a parked
thread is served from the fold cache, and MISAKA_SAMPLER=0 starts
nothing.  Then GET /debug/flamegraph on both servers: the same JSON keys
(`native_pool` on either side while a native pool of that package is live
in the process) and the same self-contained viewer around the data.
The reference's test of its jax.profiler 409 has its counterpart in
tests/test_torch_observability.py (the port's /profile routes).
"""

import http.client
import json
import re
import threading
import time
import types

import numpy as np
import pytest
import torch

from misaka_tpu import networks as jnetworks
from misaka_tpu.runtime import master as jmaster
from misaka_tpu.utils import sampler as jsampler
from misaka_tpu_torch import networks as tnetworks
from misaka_tpu_torch.runtime import master as tmaster
from misaka_tpu_torch.utils import sampler as tsampler

torch.set_num_threads(1)

PKGS = {
    "jax": types.SimpleNamespace(sampler=jsampler, master=jmaster, networks=jnetworks,
                                 kw={"engine": "scan"}),
    "torch": types.SimpleNamespace(sampler=tsampler, master=tmaster, networks=tnetworks,
                                   kw={"device": "cpu"}),
}


def both(fn):
    return [fn(p) for p in PKGS.values()]


def test_samples_capture_busy_thread():
    stop = threading.Event()

    def busy():
        while not stop.is_set():
            sum(i * i for i in range(500))

    t = threading.Thread(target=busy, name="sampler-busy-probe")
    t.start()
    samplers = [p.sampler.StackSampler(hz=200) for p in PKGS.values()]
    for s in samplers:
        s.start()
    try:
        hits = []
        for s in samplers:
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                stacks, _ = s.snapshot()
                if any(k.startswith("sampler-busy-probe;") for k in stacks):
                    break
                time.sleep(0.05)
            stacks, samples = s.snapshot()
            assert samples > 0
            hit = [k for k in stacks if k.startswith("sampler-busy-probe;")]
            assert hit, sorted(stacks)[:5]
            hits.append(hit)
        # the same labels: function (file) context, leaf last, no lines.
        # Each sampler may catch the thread in `busy` or in its generator,
        # so the labels are compared along the whole stack, not at the leaf
        frames = [{f for k in h for f in k.split(";")[1:]} for h in hits]
        assert frames[0] & frames[1]
        assert all(any("busy (" in k for k in h) for h in hits)
    finally:
        stop.set()
        for s in samplers:
            s.stop()
        t.join()
    assert not any(s.running for s in samplers)


def test_decay_halves_and_prunes_equal():
    def run(p):
        s = p.sampler.StackSampler(hz=1, decay_s=0.01)
        with s._lock:
            s._stacks = {"keep;me": 8.0, "prune;me": 1.0}
            s._last_decay = time.monotonic() - 10  # the decay is due now
        s._sample_once(skip_ident=threading.get_ident())
        stacks, _ = s.snapshot()
        return "prune;me" in stacks, stacks["keep;me"] <= 5.1, stacks["keep;me"] >= 3.9

    a, b = both(run)
    assert a == b == (False, True, True)


def test_bounded_stacks_equal():
    def run(p):
        s = p.sampler.StackSampler(hz=1, max_stacks=16)
        with s._lock:
            for i in range(16):
                s._stacks[f"prefill;{i}"] = 1.0

        def spin():
            t_end = time.monotonic() + 0.1
            while time.monotonic() < t_end:
                pass

        ts = [threading.Thread(target=spin, name=f"cap-probe-{i}") for i in range(4)]
        for t in ts:
            t.start()
        for _ in range(5):
            s._sample_once(skip_ident=0)
        for t in ts:
            t.join()
        stacks, _ = s.snapshot()
        return len(stacks) <= 17, stacks.get("(other)", 0) > 0

    a, b = both(run)
    assert a == b == (True, True)


def test_folded_format_and_payload_equal():
    def run(p):
        s = p.sampler.StackSampler(hz=1)
        with s._lock:
            s._stacks = {"a;b;c": 5.0, "a;d": 2.0, "e": 0.5}
            s._samples = 7
        payload = s.payload()
        # the measured C++ pool split, when an earlier test in this
        # process left a native pool of either package live
        payload.pop("native_pool", None)
        return s.folded(), payload

    a, b = both(run)
    assert a == b
    assert a[0].splitlines() == ["a;b;c 5", "a;d 2", "e 0"]
    assert a[1]["samples"] == 7 and a[1]["distinct_stacks"] == 3


def test_duty_cycle_governor_equal():
    def run(p):
        s = p.sampler.StackSampler(hz=67, budget=0.02)
        out = [s._current_period()]
        s._cost_ema = 0.005  # 5 ms samples at a 2% budget: a 0.25 s period
        pl = s.payload()
        return out + [s._current_period(), pl["effective_hz"], pl["sample_cost_us"]]

    a, b = both(run)
    assert a == b
    assert a[0] == pytest.approx(1 / 67.0) and a[1:] == [pytest.approx(0.25), 4.0, 5000.0]


def test_parked_thread_fold_cache():
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name="park-probe")
    t.start()
    try:
        time.sleep(0.05)
        folds = []
        for p in PKGS.values():
            s = p.sampler.StackSampler(hz=1)
            s._sample_once(skip_ident=threading.get_ident())
            hit = s._fold_cache.get(t.ident)
            assert hit is not None and "park-probe" in hit[2]
            s._sample_once(skip_ident=threading.get_ident())
            assert s._fold_cache[t.ident][2] == hit[2]
            stacks, _ = s.snapshot()
            parked = [k for k in stacks if k.startswith("park-probe;")]
            assert parked and stacks[parked[0]] >= 2  # both samples counted
            folds.append(hit[2])
        assert folds[0] == folds[1]  # the same fold of the same stack
    finally:
        stop.set()
        t.join()


def test_kill_switch_equal():
    a, b = both(lambda p: (p.sampler.enabled({"MISAKA_SAMPLER": "0"}),
                           p.sampler.ensure_started({"MISAKA_SAMPLER": "0"})))
    assert a == b == (False, None)


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    r = conn.getresponse()
    body = r.read()
    ctype = r.getheader("Content-Type")
    conn.close()
    return r.status, ctype, body


def test_flamegraph_route_json_and_html_equal(monkeypatch):
    # the sampler is process-wide: each server starts its package's one
    monkeypatch.setenv("MISAKA_TSDB", "0")
    monkeypatch.setenv("MISAKA_WATCHDOG", "0")
    monkeypatch.delenv("MISAKA_SAMPLER", raising=False)
    out = {}
    for name, p in PKGS.items():
        m = p.master.MasterNode(p.networks.add2(in_cap=16, out_cap=16, stack_cap=16),
                                chunk_steps=32, batch=4, **p.kw)
        httpd = p.master.make_http_server(m, port=0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        m.run()
        try:
            assert p.sampler.get() is not None and p.sampler.get().running
            m.compute_coalesced(np.arange(8, dtype=np.int32))
            time.sleep(0.1)  # a few sampling periods
            port = httpd.server_address[1]
            js = _get(port, "/debug/flamegraph")
            html = _get(port, "/debug/flamegraph?html=1")
            out[name] = (js[0], js[1], json.loads(js[2]), html[0], html[1], html[2].decode())
        finally:
            m.pause()
            httpd.shutdown()
            httpd.server_close()
            m.close()
            p.sampler.shutdown()
    for name, (st, ctype, body, hst, hctype, page) in out.items():
        assert st == hst == 200 and ctype == "application/json"
        assert hctype.startswith("text/html") and "misaka continuous profiler" in page
        assert body["running"] is True and body["rate_hz"] > 0 and body["samples"] > 0
        assert body["stacks"] and body["folded"]
    # `native_pool` rides either body while that package has a native
    # pool live in this process (an earlier test file on this worker)
    assert set(out["torch"][2]) - {"native_pool"} == set(out["jax"][2]) - {"native_pool"}
    strip = re.compile(r"const DATA = .*?;\n", re.S)
    assert strip.sub("", out["torch"][5]) == strip.sub("", out["jax"][5])
