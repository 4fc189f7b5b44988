"""The port's SLO burn-rate engine (utils/slo.py) against the JAX one.

The cases of tests/test_slo.py run on both packages: the spec grammar and
its errors, the ring rotation and stale reclaim, latency and error burns
with the sample floor, per-program overrides (the prune of a replaced
objective's burn series, the override budget, the exemption from the
window collapse), a malformed env spec, the disarmed engine.  Both engines
read one injected clock (each module's `time` replaced by a fake whose
`monotonic` the test advances), so the same observations give the same
`evaluate_all()` payloads: states, burns, counts and the p50/p99 estimates
of the shared bucket math, exactly.  The canary's program is never
observed by either.

Then the serving surfaces, on both packages' in-process servers: the
per-tenant drill (a `serve_delay:<tenant>` fault armed over POST
/debug/faults pages that tenant only, /healthz raises `degraded`, the
page carries exemplars, and the neighbour stays green; clearing the fault
and letting the windows age out recovers), the upload's `slo` install
(on `latest`, cleared by a version without one, back after a restart of
the store), compute-plane frames observed per request from the worker's
timestamps, and /debug/alerts and the `misaka_slo_*` gauges.
"""

import json
import threading
import types
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from misaka_tpu import networks as jnetworks
from misaka_tpu.runtime import master as jmaster
from misaka_tpu.runtime import registry as jregistry
from misaka_tpu.utils import faults as jfaults
from misaka_tpu.utils import slo as jslo
from misaka_tpu.utils import watchdog as jwatchdog
from misaka_tpu_torch import networks as tnetworks
from misaka_tpu_torch.runtime import frontends as tfrontends
from misaka_tpu_torch.runtime import master as tmaster
from misaka_tpu_torch.runtime import registry as tregistry
from misaka_tpu_torch.utils import faults as tfaults
from misaka_tpu_torch.utils import metrics as tmetrics
from misaka_tpu_torch.utils import slo as tslo
from misaka_tpu_torch.utils import watchdog as twatchdog

torch.set_num_threads(1)

SMALL = dict(stack_cap=8, in_cap=8, out_cap=8)
PKGS = {
    "jax": types.SimpleNamespace(slo=jslo, faults=jfaults, master=jmaster, reg=jregistry,
                                 networks=jnetworks, kw={"engine": "scan"}),
    "torch": types.SimpleNamespace(slo=tslo, faults=tfaults, master=tmaster, reg=tregistry,
                                   networks=tnetworks, kw={"engine": "scan", "device": "cpu"}),
}


class Clock:
    """One monotonic clock for both engines, advanced by the test."""

    def __init__(self, t=1000.0):
        self.t = t

    def monotonic(self):
        return self.t


@pytest.fixture(autouse=True)
def _restore():
    yield
    for p in PKGS.values():
        p.faults.configure(None)
        p.slo.configure()


@pytest.fixture(scope="module", autouse=True)
def _quiet_jax_daemons():
    with pytest.MonkeyPatch.context() as mp:
        for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG", "MISAKA_CANARY"):
            mp.setenv(switch, "0")
        yield


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    for p in PKGS.values():
        monkeypatch.setattr(p.slo, "time", c)
    return c


def _arm(monkeypatch, spec="p99<50ms,err<5%", windows="0.5,1,2,4", min_events=5):
    monkeypatch.setenv("MISAKA_SLO", spec)
    monkeypatch.setenv("MISAKA_SLO_WINDOWS", windows)
    monkeypatch.setenv("MISAKA_SLO_MIN_EVENTS", str(min_events))
    for p in PKGS.values():
        p.slo.configure()


def _both(fn):
    """fn(slo module) on each package; the two results."""
    return [fn(p.slo) for p in PKGS.values()]


# --- grammar and rings -------------------------------------------------------------------


SPECS = ["p99<25ms,err<0.1%", "p50<2s", "p95<100us", "", "p99.9<5ms", "p99<25", "p0<1ms",
         "p100<1ms", "err<0%", "err<200%", "latency<5ms", "p99>25ms", "p99<0ms"]


@pytest.mark.parametrize("text", SPECS)
def test_parse_spec_equal_jax(text):
    def parse(mod):
        try:
            return [(o.name, o.kind, o.quantile, o.threshold_s, o.budget)
                    for o in mod.parse_spec(text)]
        except mod.SLOSpecError as e:
            return str(e)

    a, b = _both(parse)
    assert a == b


def test_ring_rotation_and_stale_reclaim():
    def run(mod):
        ring = mod._Ring(width=1.0, length=4)
        ring.observe(100.0, 0.01, False)
        ring.observe(100.5, 0.01, True)
        out = [ring.window_sum(100.9, 1.0)]
        ring.observe(101.2, 0.02, False)
        out.append(ring.window_sum(101.3, 2.0))
        out.append(ring.window_sum(100 + 4000.0, 4.0))  # every slot stale
        return out

    a, b = _both(run)
    assert a == b
    assert [r[:2] for r in b] == [(2, 1), (3, 1), (0, 0)] and sum(b[2][2]) == 0


# --- burn-rate states under one clock -----------------------------------------------------


def test_seeded_observations_evaluate_equal(monkeypatch, clock):
    """A seeded stream of latency and error observations over four
    programs, time advancing through every window: at each checkpoint the
    two engines' payloads are equal, and the states cover ok, warning-free
    pages by latency and by error, and recovery."""
    _arm(monkeypatch)
    rng = np.random.default_rng(20261017)
    seen = set()
    for step in range(40):
        clock.t += float(rng.uniform(0.02, 0.3))
        prog = ["hot", "err", "fine", "tiny"][int(rng.integers(0, 4))]
        n = 2 if prog == "tiny" else int(rng.integers(1, 6))
        dur = {"hot": 0.5, "err": 0.001, "fine": 0.002, "tiny": 0.5}[prog]
        dur *= float(rng.uniform(0.5, 1.5))
        for p in PKGS.values():
            for _ in range(n):
                p.slo.observe(prog, dur, error=(prog == "err"))
        if step % 5 == 4:
            a, b = _both(lambda mod: (mod._eval_cache.clear(), mod.evaluate_all(),
                                      mod.overall_state())[1:])
            assert a == b, step
            seen |= {(name, row["state"]) for name, row in b[0].items()}
    assert {("hot", "page"), ("err", "page"), ("fine", "ok")} <= seen
    clock.t += 10.0  # every window ages out
    a, b = _both(lambda mod: (mod._eval_cache.clear(), mod.evaluate_all())[1])
    assert a == b and {row["state"] for row in b.values()} == {"ok"}


def test_min_events_guard_and_canary_excluded(monkeypatch, clock):
    _arm(monkeypatch)
    for p in PKGS.values():
        for _ in range(2):
            p.slo.observe("tiny", 0.5)
        for _ in range(60):
            p.slo.observe("_canary", 5.0, error=True)  # never observed
    a, b = _both(lambda mod: (mod.evaluate("tiny")["state"], "_canary" in mod._windows))
    assert a == b == ("ok", False)


def test_per_program_override_and_prune(monkeypatch, clock):
    _arm(monkeypatch, spec="p99<10s")

    def run(mod):
        mod.set_objectives("strict", "p99<1ms")
        for _ in range(60):
            mod.observe("strict", 0.1)
            mod.observe("lax", 0.1)
        out = [mod.evaluate("strict")["state"], mod.evaluate("lax")["state"],
               mod.overall_state()]
        mod.set_objectives("strict", "p99<10s")  # the relaxed replacement
        mod._eval_cache.clear()
        out.append(mod.evaluate("strict"))
        out.append(sorted({dict(zip(mod.M_SLO_BURN.labelnames, key))["objective"]
                           for key, _ in mod.M_SLO_BURN._items()
                           if key and key[0] == "strict"}))
        mod.set_objectives("strict", None)  # back to the env default
        mod._eval_cache.clear()
        out.append(mod.debug_payload()["overrides"])
        return out

    a, b = _both(run)
    assert a == b
    assert b[:3] == ["page", "ok", "page"] and b[3]["state"] == "ok"
    assert b[4] == ["p99<10s"] and b[5] == {}


def test_override_budget_and_window_collapse(monkeypatch, clock):
    _arm(monkeypatch)
    monkeypatch.setenv("MISAKA_USAGE_LABEL_MAX", "3")

    def run(mod):
        out = []
        for i in range(5):
            mod.observe(f"cap-flood-{i}", 0.001)
        out.append(sorted(mod._windows))
        for i in range(3):
            mod.set_objectives(f"ovr-{i}", "p99<50ms")
        try:
            mod.set_objectives("ovr-overflow", "p99<50ms")
        except mod.SLOSpecError as e:
            out.append(str(e))
        mod.set_objectives("ovr-1", "p95<10ms")  # a replacement is allowed
        for _ in range(50):
            mod.observe("ovr-1", 0.5)
        out.append(("ovr-1" in mod._windows, mod.evaluate("ovr-1")["state"]))
        return out

    a, b = _both(run)
    assert a == b
    assert "other" in b[0] and len(b[0]) <= 4 and b[2] == (True, "page")


def test_malformed_env_spec_is_loud(monkeypatch):
    monkeypatch.setenv("MISAKA_SLO", "p99<25")  # no unit
    a, b = _both(lambda mod: (mod.configure(), mod.armed(), mod.debug_payload())[1:])
    assert a == b and a[0] is False and "p99<25" in a[1]["spec_error"]


def test_disarmed_is_free(monkeypatch):
    monkeypatch.delenv("MISAKA_SLO", raising=False)

    def run(mod):
        mod.configure()
        mod.observe("ghost", 99.0, error=True)
        return mod.armed(), mod.overall_state(), mod.debug_payload()

    a, b = _both(run)
    assert a == b and a[:2] == (False, None) and a[2]["programs"] == {}


# --- the serving surfaces -------------------------------------------------------------------


def _call(base, path, form=None, raw=None, method=None):
    data = raw if raw is not None else (
        urllib.parse.urlencode(form).encode() if form is not None else None)
    req = urllib.request.Request(base + path, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _serve(p, programs_dir=None):
    reg = p.reg.ProgramRegistry(programs_dir, batch=2, chunk_steps=16, caps=SMALL, **p.kw)
    top = p.networks.add2(**SMALL)
    m = p.master.MasterNode(top, chunk_steps=16, batch=2, **p.kw)
    reg.seed("ten-a", m, top)
    httpd = p.master.make_http_server(m, port=0, registry=reg)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    m.run()
    return f"http://127.0.0.1:{httpd.server_address[1]}", m, reg, httpd


def _stop(m, reg, httpd):
    httpd.shutdown()
    httpd.server_close()
    m.pause()
    reg.close()
    m.close()


def test_tenant_fault_pages_only_that_tenant(monkeypatch, clock):
    """The drill of tests/test_slo.py on both packages' servers: a p99
    objective and a delay on ten-b's passes only.  The windows' clock is
    the injected one, so nothing waits for a window but the faulted
    requests themselves.

    The objective sits on a bound of the latency buckets (2.154 s,
    utils/metrics.py DURATION_BUCKETS), where the bad-event estimate is
    exact: a request counts as bad only past the bound.  An unfaulted
    request on the port's CPU engine takes 0.1-0.3 s unloaded (a 250 ms
    objective inside the (0.2154, 0.4642] bucket paged on one of them
    under load), so it stays good at 7x that; every faulted one takes
    the 2.5 s delay and more, so it is always bad."""
    _arm(monkeypatch, spec="p99<2.154s", windows="3,6,12,24", min_events=3)
    drills = {}
    for name, p in PKGS.items():
        base, m, reg, httpd = _serve(p)
        try:
            assert _call(base, "/programs", {"name": "ten-b",
                                             "program": "IN ACC\nADD 3\nOUT ACC\n"})[0] == 200
            steps = []
            vals = np.arange(4, dtype="<i4")

            def drive(n):
                for _ in range(n):
                    for prog, delta in (("ten-a", 2), ("ten-b", 3)):
                        st, out = _call(base, f"/programs/{prog}/compute_raw?spread=1",
                                        raw=vals.tobytes())
                        assert st == 200 and np.frombuffer(out, "<i4").tolist() == (
                            vals + delta).tolist()

            def states():
                alerts = json.loads(_call(base, "/debug/alerts")[1])
                health = json.loads(_call(base, "/healthz")[1])
                progs = alerts["programs"]
                return ((progs.get("ten-a", {}).get("state"), progs.get("ten-b", {}).get("state"),
                         health["slo"], health["degraded"]),
                        progs.get("ten-b", {}).get("exemplars"))

            drive(2)  # the first chunks compile (the JAX engines): out of every window
            clock.t += 25.0
            drive(4)
            clock.t += 0.3  # past the evaluation cache
            steps.append(states()[0])
            assert _call(base, "/debug/faults", {"spec": "serve_delay:ten-b=2.5"})[0] == 200
            drive(4)
            clock.t += 0.3
            faulted, exemplars = states()
            steps.append(faulted)
            assert _call(base, "/debug/faults", {"spec": ""})[0] == 200
            clock.t += 25.0  # every window ages the faulted events out
            drive(1)
            clock.t += 0.3
            steps.append(states()[0])
            drills[name] = steps
            assert exemplars and exemplars[0]["href"].startswith("/debug/requests/")
        finally:
            _stop(m, reg, httpd)
    assert drills["jax"] == drills["torch"]
    assert drills["torch"] == [("ok", "ok", "ok", False), ("ok", "page", "page", True),
                               ("ok", "ok", "ok", False)]


def test_upload_slo_is_installed_on_latest(monkeypatch, tmp_path):
    _arm(monkeypatch, spec="")  # no env default: overrides only
    for name, p in PKGS.items():
        d = str(tmp_path / name)
        reg = p.reg.ProgramRegistry(d, batch=None, chunk_steps=16, caps=SMALL, **p.kw)
        try:
            reg.publish("slo-ten", tis="IN ACC\nADD 1\nOUT ACC\n", slo_spec="p99<1ms")
            assert p.slo.armed()
            assert [o.name for o in p.slo.objectives_for("slo-ten")] == ["p99<1ms"]
            with pytest.raises(p.reg.RegistryError, match="invalid slo spec"):
                reg.publish("slo-ten2", tis="IN ACC\nOUT ACC\n", slo_spec="p99>nope")
        finally:
            reg.close()
        p.slo.configure()  # a restart: the store re-installs the latest's spec
        reg = p.reg.ProgramRegistry(d, batch=None, chunk_steps=16, caps=SMALL, **p.kw)
        try:
            assert [o.name for o in p.slo.objectives_for("slo-ten")] == ["p99<1ms"]
            reg.publish("slo-ten", tis="IN ACC\nADD 2\nOUT ACC\n")  # a latest without one
            assert p.slo.objectives_for("slo-ten") == [] and not p.slo.armed()
        finally:
            reg.close()


def test_plane_frames_feed_the_windows(monkeypatch, tmp_path):
    _arm(monkeypatch, windows="0.5,1,2,4")
    m = tmaster.MasterNode(tnetworks.add2(**SMALL), chunk_steps=16, batch=4, device="cpu")
    path = str(tmp_path / "plane.sock")
    plane = tfrontends.start_compute_plane(m, path)
    client = tfrontends.PlaneClient(path, conns=1)
    m.run()
    try:
        vals = np.arange(6, dtype=np.int32)
        for _ in range(8):
            out = client.compute_raw(vals.astype("<i4").tobytes())
            assert (np.frombuffer(out, "<i4") == vals + 2).all()
        # the plane observes after its reply: poll the longest window
        for _ in range(30):
            tslo._eval_cache.clear()
            payload = tslo.evaluate("default")
            if payload["windows"]["4s"]["requests"] >= 8:
                break
            threading.Event().wait(0.1)
        assert payload["windows"]["4s"]["requests"] >= 8
        assert payload["windows"]["4s"]["p99_ms"] > 0
    finally:
        client.close()
        plane.close()
        m.close()


def test_alerts_bodies_and_gauges_equal_jax(monkeypatch, clock):
    _arm(monkeypatch)
    # both watchdogs disarmed, whatever an earlier test in this process armed
    jwatchdog.shutdown()
    twatchdog.shutdown()
    bodies = []
    for p in PKGS.values():
        for _ in range(20):
            p.slo.observe("gauge-prog", 0.001)
        m = p.master.MasterNode(p.networks.add2(**SMALL), chunk_steps=16, batch=None, **p.kw)
        httpd = p.master.make_http_server(m, port=0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            bodies.append((_call(base, "/debug/alerts"), _call(base, "/metrics")[1].decode()))
        finally:
            httpd.shutdown()
            m.close()
    (ja, jtext), (ta, ttext) = bodies
    assert ta[0] == ja[0] == 200
    body, jbody = json.loads(ta[1]), json.loads(ja[1])
    assert body == jbody  # the watchdog blocks too: both disarmed (MISAKA_WATCHDOG=0)
    assert body["enabled"] is True and body["programs"]["gauge-prog"]["state"] == "ok"
    assert body["watchdog"] == {"enabled": False, "state": "ok", "rules": []}
    parsed = tmetrics.parse_text(ttext)
    assert any(k.startswith("misaka_slo_state") and 'program="gauge-prog"' in k for k in parsed)
    assert any(k.startswith("misaka_slo_burn_rate") for k in parsed)
