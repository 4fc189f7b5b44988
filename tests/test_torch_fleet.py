"""The port's replicated engine fleet (runtime/fleet.py and the fleet
router of runtime/frontends.py) against the JAX package's.

- Pure functions: HashRing gives the JAX ring's owners for 10,000 keys
  at N = 1..8 and moves the same keys on a join and a leave; the metrics
  relabeller is byte-equal; verify_manifest gives the same verdict on the
  same files (exact, truncated at every offset, one byte flipped at every
  offset, no manifest); parse_fleet_peers parses the reference's cases to
  equal results.
- The router over stub engines, one port test per router test of the
  reference's fast lane (tests/test_fleet.py): least-depth ties, sticky
  programs, failover under load, a partitioned peer, readmission, drain
  reroutes, the 1-replica grace, 503 never 599, the typed fleet-down 503,
  a scoped blackhole hedged, the suspect hold, per-event escalation, the
  stale-socket replay.
- Across packages the frame codec is the reference's: the port's router
  over JAX planes and the JAX router over port planes answer equal bytes,
  and a drain reroutes with zero errors both ways.
- The control server of each package over the same stub replicas:
  skipped replicas reported by a fan-out, /healthz `running`, the
  /healthz, /status and /fleet key sets, and a /fleet/roll over stub
  replicas whose JSON matches field for field; the undrain retry, the
  restore kept armed while rolling, the fault points.
- A port fleet of 2 replicas on the CPU (subprocesses): the replica_kill
  fault fires once and kill -9 of the other replica, each under 8
  clients, gives no client error; POST /fleet/roll under the same load
  gives none, and a quiescent roll restores each replica's state
  bit-identical to its roll checkpoint (np.load).  (A replica that cannot
  boot: tests/test_torch_fleet_dist.py.)
"""

import hashlib
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import numpy as np
import pytest

from misaka_tpu.runtime import canary as jcanary
from misaka_tpu.runtime import fleet as jfleet
from misaka_tpu.runtime import frontends as jfe
from misaka_tpu.utils import faults as jfaults
from misaka_tpu.utils import tsdb as jtsdb
from misaka_tpu.utils import watchdog as jwatchdog
from misaka_tpu_torch.networks import ADD2_PROGRAMS
from misaka_tpu_torch.runtime import canary as tcanary
from misaka_tpu_torch.runtime import fleet as tfleet
from misaka_tpu_torch.runtime import frontends as tfe
from misaka_tpu_torch.utils import faults as tfaults
from misaka_tpu_torch.utils import metrics as tmetrics
from misaka_tpu_torch.utils import tsdb as ttsdb
from misaka_tpu_torch.utils import watchdog as twatchdog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET = {"jax": jfleet, "port": tfleet}
FE = {"jax": jfe, "port": tfe}


@pytest.fixture(autouse=True)
def _disarm(monkeypatch):
    # the control servers start the process-wide TSDB and watchdog: off,
    # so nothing outlives a test
    for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG", "MISAKA_CANARY"):
        monkeypatch.setenv(switch, "0")
    yield
    for mod in (jfaults, tfaults):
        mod.configure(None)
    for mod in (jtsdb, ttsdb, jwatchdog, twatchdog, jcanary, tcanary):
        mod.shutdown()


# --- pure functions -----------------------------------------------------------------------

KEYS = [f"prog-{i}" for i in range(10_000)]


@pytest.mark.parametrize("n", range(1, 9))
def test_hash_ring_owners_equal_jax(n):
    tr, jr = tfleet.HashRing(range(n)), jfleet.HashRing(range(n))
    assert [tr.owner(k) for k in KEYS] == [jr.owner(k) for k in KEYS]
    assert all(tr.lookup(k) == jr.lookup(k) for k in KEYS[:500])
    assert sorted(tr.lookup("tenant-a")) == list(range(n))


@pytest.mark.parametrize("n", range(2, 8))
def test_hash_ring_join_and_leave_move_the_same_keys(n):
    moved = {}
    for pkg, mod in FLEET.items():
        rings = (mod.HashRing(range(n)), mod.HashRing(range(n + 1)),
                 mod.HashRing([r for r in range(n) if r != 1]))
        before, joined, left = ([ring.owner(k) for k in KEYS] for ring in rings)
        moved[pkg] = ({k for k, a, b in zip(KEYS, before, joined) if a != b},
                      {k for k, a, b in zip(KEYS, before, left) if a != b})
        # a leave moves only the departed replica's keys
        assert moved[pkg][1] == {k for k, a in zip(KEYS, before) if a == 1}
    assert moved["port"] == moved["jax"]


def test_relabel_metrics_text_byte_equal():
    text = ("# HELP misaka_x_total things\n# TYPE misaka_x_total counter\n"
            "misaka_x_total 41\n"
            'misaka_y_total{route="/compute",method="POST"} 7\n'
            'misaka_h_bucket{le="0.1"} 3\n\nmalformed\n')
    for replica in (0, 2, 11):
        assert tfleet.relabel_metrics_text(text, replica) == \
            jfleet.relabel_metrics_text(text, replica)
    samples, headers = tfleet.relabel_metrics_text(text, 2)
    assert headers == ["# HELP misaka_x_total things", "# TYPE misaka_x_total counter"]
    assert 'misaka_y_total{replica="2",route="/compute",method="POST"} 7' in samples
    assert tmetrics.parse_text("\n".join(samples) + "\n")['misaka_x_total{replica="2"}'] == 41.0


def _write_ckpt(path):
    np.savez(path[:-len(".npz")], a=np.arange(12, dtype=np.int32))
    with open(path, "rb") as f:
        blob = f.read()
    with open(path + ".manifest", "w") as f:
        json.dump({"size": len(blob), "sha256": hashlib.sha256(blob).hexdigest()}, f)
    return blob


def _verdict(mod, path):
    try:
        mod.verify_manifest(path)
        return "ok"
    except RuntimeError as e:
        return str(e)


def test_verify_manifest_same_verdicts(tmp_path):
    path = str(tmp_path / "c.npz")
    blob = _write_ckpt(path)
    verdicts = {"jax": [], "port": []}

    def both():
        for pkg, mod in FLEET.items():
            verdicts[pkg].append(_verdict(mod, path))

    both()  # exact
    for cut in range(len(blob)):  # truncated at every offset
        with open(path, "wb") as f:
            f.write(blob[:cut])
        both()
    for at in range(len(blob)):  # one byte flipped at every offset
        flipped = bytearray(blob)
        flipped[at] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(flipped))
        both()
    with open(path, "wb") as f:
        f.write(blob)
    os.unlink(path + ".manifest")
    both()  # no manifest
    assert verdicts["port"] == verdicts["jax"]
    v = verdicts["port"]
    assert v[0] == "ok"
    assert all("torn write" in x for x in v[1:1 + len(blob)])
    assert all("sha256 mismatch" in x for x in v[1 + len(blob):1 + 2 * len(blob)])
    assert "unreadable manifest" in v[-1]


PEER_SPECS = [None, "", " ", "10.0.0.2:9000, 10.0.0.3:9000:9501", "h:1", "h:1:7",
              "justahost", ":9000", "h:port", "h:1:2:3", "h:1:x", "a:1,,b:2"]


@pytest.mark.parametrize("spec", PEER_SPECS)
def test_parse_fleet_peers_equal_jax(spec):
    out = {}
    for pkg, mod in FLEET.items():
        try:
            out[pkg] = mod.parse_fleet_peers(spec)
        except ValueError as e:
            out[pkg] = ("ValueError", str(e))
    assert out["port"] == out["jax"]


# --- the router over stub engines ---------------------------------------------------------


class _StubMaster:
    """An engine twin for the plane: values + 2, counting frames (`calls`)
    and values, with an optional delay per frame."""

    is_running = True

    def __init__(self, delay=0.0):
        self.calls = 0
        self.values = 0
        self.delay = delay
        self._lock = threading.Lock()

    def compute_coalesced(self, values, timeout=30.0, return_array=True, traces=()):
        with self._lock:
            self.calls += 1
            self.values += int(np.asarray(values).size)
        if self.delay:
            time.sleep(self.delay)
        return np.asarray(values) + 2


class _StubRegistry:
    def __init__(self, master):
        self._master = master

    def lease(self, program, values=0):
        import contextlib

        @contextlib.contextmanager
        def cm():
            yield self._master

        return cm()


def _stub_fleet(tmp_path, n=2, delay=0.0, plane_pkg="port", router_pkg="port", **router_kw):
    masters = [_StubMaster(delay=delay) for _ in range(n)]
    planes = [FE[plane_pkg].start_compute_plane(
        masters[i], str(tmp_path / f"plane-{i}.sock"), registry=_StubRegistry(masters[i]),
        replica_label=str(i)) for i in range(n)]
    router_kw.setdefault("down_grace", 0.3)
    router = FE[router_pkg].FleetPlaneRouter([p.path for p in planes], **router_kw)
    return masters, planes, router


BODY = np.arange(8, dtype=np.int32).tobytes()
WANT = np.arange(8, dtype=np.int32) + 2


def _check(out):
    assert np.array_equal(np.frombuffer(out, dtype="<i4"), WANT)


def _close(router, planes):
    router.close()
    for p in planes:
        p.close()


def _wait(cond, deadline_s=5.0):
    deadline = time.monotonic() + deadline_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


def test_router_least_depth_tie_breaks_to_lowest_index(tmp_path):
    masters, planes, router = _stub_fleet(tmp_path, n=3)
    try:
        assert [r.idx for r in router._candidates(None, set())] == [0, 1, 2]
        _check(router.compute_raw(BODY, timeout=5))
        assert masters[0].calls == 1 and masters[1].calls == 0
        router._replicas[0].client._inflight += 1
        try:
            assert router._candidates(None, set())[0].idx == 1
        finally:
            router._replicas[0].client._inflight -= 1
    finally:
        _close(router, planes)


def test_router_program_traffic_is_sticky(tmp_path):
    masters, planes, router = _stub_fleet(tmp_path, n=3)
    try:
        for _ in range(12):
            _check(router.compute_raw(BODY, timeout=5, program="tenant-a"))
        assert sorted(m.calls for m in masters) == [0, 0, 12]
        # the owner is the JAX ring's
        owner = jfleet.HashRing(range(3)).owner("tenant-a")
        assert masters[owner].calls == 12
        for _ in range(6):
            _check(router.compute_raw(BODY, timeout=5, program="tenant-b@v2"))
        assert sum(m.calls for m in masters) == 18
        assert masters[jfleet.HashRing(range(3)).owner("tenant-b")].calls >= 6
    finally:
        _close(router, planes)


def _hammer(router, threads, per_thread, errors, stop=None):
    """`threads` clients, each sending `per_thread` requests, or sending until
    `stop` is set when one is given."""
    def worker():
        try:
            n = 0
            while (not stop.is_set()) if stop is not None else n < per_thread:
                _check(router.compute_raw(BODY, timeout=10))
                n += 1
        except Exception as e:  # collected for the assert
            errors.append(e)

    ts = [threading.Thread(target=worker) for _ in range(threads)]
    for t in ts:
        t.start()
    return ts


def test_router_failover_under_concurrent_load_zero_errors(tmp_path):
    masters, planes, router = _stub_fleet(tmp_path, n=2, delay=0.002)
    errors: list = []
    try:
        ts = _hammer(router, 12, 25, errors)
        _wait(lambda: masters[0].values + masters[1].values >= 12 * 25 * 8 // 10)
        planes[1].close()  # the in-process kill -9
        for t in ts:
            t.join(timeout=30)
        assert errors == []
        assert masters[0].values + masters[1].values >= 12 * 25 * 8  # duplicates, no loss
        assert masters[0].values > 0
        assert router.states()[1] == "down"
    finally:
        _close(router, planes)


def test_router_partitioned_peer_hedges_to_siblings(tmp_path):
    masters, planes, router = _stub_fleet(tmp_path, n=2, probe_s=0.05)
    errors: list = []
    try:
        _check(router.compute_raw(BODY, timeout=5))
        hedged0 = tfe.M_PLANE_HEDGED.value
        tfaults.configure("plane_partition:plane-1.sock")
        router._replicas[0].client._inflight += 1
        try:
            ts = _hammer(router, 8, 1, errors)
            for t in ts:
                t.join(timeout=30)
        finally:
            router._replicas[0].client._inflight -= 1
        assert errors == []
        assert masters[1].values == 0 and masters[0].values >= 8 * 8
        assert tfe.M_PLANE_HEDGED.value > hedged0  # failovers are visible
        assert _wait(lambda: router.states()[1] == "down")
        tfaults.configure(None)
        assert _wait(lambda: router.states()[1] == "up")
    finally:
        _close(router, planes)


def test_router_readmits_restarted_replica(tmp_path):
    masters, planes, router = _stub_fleet(tmp_path, n=2, probe_s=0.05)
    try:
        planes[1].close()
        router._replicas[0].client._inflight += 1
        try:
            _check(router.compute_raw(BODY, timeout=5))
        finally:
            router._replicas[0].client._inflight -= 1
        assert router.states()[1] == "down"
        p2 = tfe.start_compute_plane(_StubMaster(), planes[1].path)
        try:
            assert _wait(lambda: router.states()[1] == "up")
        finally:
            p2.close()
    finally:
        router.close()
        planes[0].close()


def test_router_drain_reroutes_with_zero_errors(tmp_path):
    masters, planes, router = _stub_fleet(tmp_path, n=2, delay=0.002)
    errors: list = []
    stop = threading.Event()
    try:
        # the drain lands while the clients are still sending, on a box of any speed
        ts = _hammer(router, 8, None, errors, stop=stop)
        assert _wait(lambda: masters[0].calls > 0)
        planes[0].set_draining(True)
        assert _wait(lambda: planes[0].inflight() == 0)
        calls_at_drain, rerouted_from = masters[0].calls, masters[1].calls
        assert _wait(lambda: masters[1].calls >= rerouted_from + 40)
        stop.set()
        for t in ts:
            t.join(timeout=30)
        assert errors == []
        assert masters[0].calls == calls_at_drain and masters[1].calls > rerouted_from
        assert router.states()[0] == "draining"
        planes[0].set_draining(False)
        assert _wait(lambda: router.states()[0] == "up")
    finally:
        _close(router, planes)


def test_router_single_replica_readmits_inside_grace(tmp_path):
    masters, planes, router = _stub_fleet(tmp_path, n=1, probe_s=0.05, down_grace=5.0)
    try:
        planes[0].set_draining(True)
        threading.Timer(0.4, planes[0].set_draining, args=(False,)).start()
        _check(router.compute_raw(BODY, timeout=10))  # no 503
        assert masters[0].calls >= 1
    finally:
        _close(router, planes)


def test_router_draining_fleet_maps_to_503_never_599(tmp_path):
    masters, planes, router = _stub_fleet(tmp_path, n=1, probe_s=0.05, down_grace=30.0)
    try:
        planes[0].set_draining(True)
        with pytest.raises(tfe.PlaneError) as exc:
            router.compute_raw(BODY, timeout=1.0)
        assert exc.value.status == 503 != tfe.PLANE_DRAINING
    finally:
        _close(router, planes)


def test_router_fleet_down_is_typed_503(tmp_path):
    masters, planes, router = _stub_fleet(tmp_path, n=2, down_grace=0.2)
    try:
        for p in planes:
            p.close()
        t0 = time.monotonic()
        with pytest.raises(tfe.PlaneError) as exc:
            router.compute_raw(BODY, timeout=5)
        assert exc.value.status == 503 and b"fleet down" in exc.value.body
        assert time.monotonic() - t0 < 3.0  # the grace, not the whole timeout
    finally:
        router.close()


def test_router_hedges_scoped_blackhole(tmp_path):
    masters, planes, router = _stub_fleet(tmp_path, n=2)
    try:
        tfaults.configure("replica_blackhole:0=30")
        t0 = time.monotonic()
        _check(router.compute_raw(BODY, timeout=4))
        assert time.monotonic() - t0 < 3.5
        assert masters[1].calls >= 1 and router.states()[0] == "down"
    finally:
        tfaults.configure(None)
        _close(router, planes)


def test_router_probe_cannot_readmit_frame_failed_replica(tmp_path):
    masters, planes, router = _stub_fleet(tmp_path, n=2, probe_s=0.05, suspect_hold=1.2)
    try:
        tfaults.configure("replica_blackhole:0=30")
        _check(router.compute_raw(BODY, timeout=2))
        assert router.states()[0] == "down"
        tfaults.configure(None)
        time.sleep(0.4)  # probes pass, inside the hold
        assert router.states()[0] == "down"
        assert _wait(lambda: router.states()[0] == "up")
    finally:
        tfaults.configure(None)
        _close(router, planes)


def test_suspect_escalates_per_event_not_per_request():
    out = {}
    for pkg in FE:
        r = FE[pkg]._RouterReplica(0, "/nowhere", None)
        t0 = time.monotonic()
        for _ in range(64):
            r.suspect(0.5)
        first = (r.state, r.suspect_streak, r.suspect_until - t0 < 0.75)
        r.suspect_until = time.monotonic() - 0.01
        r.suspect(0.5)
        second = r.suspect_streak
        r.absolve()
        out[pkg] = (first, second, r.suspect_streak, r.suspect_until)
    assert out["port"] == out["jax"] == (("down", 1, True), 2, 0, 0.0)


def test_plane_client_replays_one_stale_socket(tmp_path):
    p1 = tfe.start_compute_plane(_StubMaster(), str(tmp_path / "p.sock"))
    client = tfe.PlaneClient(p1.path, conns=1)
    try:
        _check(client.compute_raw(BODY, timeout=5))
        p1.close()
        m2 = _StubMaster()
        p2 = tfe.start_compute_plane(m2, p1.path)
        try:
            _check(client.compute_raw(BODY, timeout=5))
            assert m2.calls == 1
        finally:
            p2.close()
    finally:
        client.close()


# --- across packages ----------------------------------------------------------------------


@pytest.mark.parametrize("router_pkg,plane_pkg", [("port", "jax"), ("jax", "port")])
def test_router_across_packages_equal_bytes(tmp_path, router_pkg, plane_pkg):
    rng = np.random.default_rng(20261017)
    bodies = [rng.integers(-2**31, 2**31, size=int(rng.integers(1, 40)),
                           dtype=np.int64).astype("<i4").tobytes() for _ in range(20)]
    outs = {}
    for rp, pp in ((router_pkg, plane_pkg), ("jax", "jax")):
        sub = tmp_path / f"{rp}-{pp}"
        sub.mkdir()
        masters, planes, router = _stub_fleet(sub, n=2, plane_pkg=pp, router_pkg=rp)
        try:
            outs[rp, pp] = [router.compute_raw(b, timeout=10, program=p)
                            for b in bodies for p in (None, "tenant-a")]
        finally:
            _close(router, planes)
    assert outs[router_pkg, plane_pkg] == outs["jax", "jax"]
    want = [(np.frombuffer(b, "<i4").astype(np.int64) + 2).astype("<i4").tobytes()
            for b in bodies for _ in (None, "tenant-a")]
    assert outs["jax", "jax"] == want


@pytest.mark.parametrize("router_pkg,plane_pkg", [("port", "jax"), ("jax", "port")])
def test_drain_reroutes_across_packages_zero_errors(tmp_path, router_pkg, plane_pkg):
    masters, planes, router = _stub_fleet(tmp_path, n=2, delay=0.002, plane_pkg=plane_pkg,
                                          router_pkg=router_pkg)
    errors: list = []
    stop = threading.Event()
    try:
        ts = _hammer(router, 8, None, errors, stop=stop)
        assert _wait(lambda: masters[0].calls > 0)
        planes[0].set_draining(True)
        rerouted_from = masters[1].calls
        assert _wait(lambda: masters[1].calls >= rerouted_from + 40)
        stop.set()
        for t in ts:
            t.join(timeout=30)
        assert errors == []
        assert router.states()[0] == "draining" and masters[1].calls > rerouted_from
    finally:
        _close(router, planes)


# --- the control server over stub replicas ------------------------------------------------


class _FakeProc:
    pid = 4242

    def poll(self):
        return None

    def terminate(self):
        pass

    def kill(self):
        pass

    def wait(self, timeout=None):
        return 0


class _StubReplica:
    """One replica's HTTP surface, deep enough for the control server and
    the roll: /healthz, /status, /metrics, lifecycle POSTs, /fleet/drain
    and /checkpoint (a small checkpoint with its manifest in `ckpt_dir`)."""

    def __init__(self, ckpt_dir=None, running=True):
        self.ckpt_dir = ckpt_dir
        self.running = running
        self.calls: list = []
        stub = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                stub.calls.append(("GET", path))
                if path == "/healthz":
                    self._send(200, json.dumps({"ok": True, "running": stub.running,
                                                "degraded": False}).encode())
                elif path == "/status":
                    self._send(200, json.dumps({"running": stub.running, "tick": 5}).encode())
                elif path == "/metrics":
                    self._send(200, b"misaka_x_total 3\n", "text/plain")
                else:
                    self._send(404, b"no")

            def do_POST(self):
                raw = self.rfile.read(int(self.headers.get("Content-Length") or 0))
                path = self.path.split("?", 1)[0]
                form = {k: v[-1] for k, v in parse_qs(raw.decode()).items()}
                stub.calls.append(("POST", path, form))
                if path == "/fleet/drain":
                    self._send(200, json.dumps({"draining": form.get("state") != "off",
                                                "inflight": 0, "http_inflight": 0}).encode())
                elif path == "/checkpoint":
                    _write_ckpt(os.path.join(stub.ckpt_dir, form["name"] + ".npz"))
                    self._send(200, b"Success", "text/plain")
                else:
                    self._send(200, b"Success", "text/plain")

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _stub_control(pkg, tmp_path, n=2, up=None):
    """(FleetManager, control server, control port, stub replicas) of one
    package over stub replicas; the slots in `up` (default all) look up."""
    fm = FLEET[pkg].FleetManager(n, str(tmp_path / f"fleet-{pkg}"), base_env={})
    stubs = []
    for slot in fm._slots:
        os.makedirs(slot["ckpt_dir"], exist_ok=True)
        stub = _StubReplica(slot["ckpt_dir"])
        stubs.append(stub)
        if up is None or slot["idx"] in up:
            slot["proc"] = _FakeProc()
            slot["probe_ok"] = True
            slot["running"] = True
            slot["port"] = stub.port
    ctrl = FLEET[pkg].make_fleet_http_server(fm, port=0)
    threading.Thread(target=ctrl.serve_forever, daemon=True).start()
    return fm, ctrl, ctrl.server_address[1], stubs


def _teardown(fm, ctrl, stubs):
    ctrl.shutdown()
    ctrl.server_close()
    for s in stubs:
        s.close()
    fm.close()


def _req(port, method, path, body=None, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body, {})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _shape(obj):
    """Keys (recursively, lists by their first element) of a payload."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(obj[0])] if obj else []
    return type(obj).__name__


@pytest.mark.parametrize("pkg", list(FLEET))
def test_fanout_reports_skipped_replicas(tmp_path, pkg):
    fm, ctrl, port, stubs = _stub_control(pkg, tmp_path, up={0})
    try:
        status, body = _req(port, "POST", "/pause", b"")
        payload = json.loads(body)
        assert status == 502 and payload["ok"] is False
        rows = {r["replica"]: r for r in payload["replicas"]}
        assert rows[0]["status"] == 200 and rows[1]["skipped"] is True
        assert rows[1]["status"] == 503
        fm._slots[1]["proc"] = _FakeProc()
        fm._slots[1]["probe_ok"] = True
        fm._slots[1]["port"] = stubs[1].port
        assert _req(port, "POST", "/pause", b"") == (200, b"Success")
        assert _req(port, "POST", "/fleet/drain", b"state=on")[0] == 400
    finally:
        _teardown(fm, ctrl, stubs)


def test_control_payloads_equal_jax(tmp_path):
    """/healthz, /status and /fleet of both control servers over the same
    stub replicas: equal shapes (and equal bodies where nothing names a
    pid or port); a paused replica makes `running` false in both."""
    got = {}
    for pkg in FLEET:
        fm, ctrl, port, stubs = _stub_control(pkg, tmp_path)
        try:
            health = json.loads(_req(port, "GET", "/healthz")[1])
            fm._slots[1]["running"] = False
            paused = json.loads(_req(port, "GET", "/healthz")[1])
            got[pkg] = {
                "healthz": _shape(health), "status": _shape(json.loads(
                    _req(port, "GET", "/status")[1])),
                "fleet": _shape(json.loads(_req(port, "GET", "/fleet")[1])),
                "running": (health["ok"], health["running"], paused["ok"], paused["running"]),
                "metrics_replica_lines": sorted(
                    ln for ln in _req(port, "GET", "/metrics")[1].decode().splitlines()
                    if ln.startswith("misaka_x_total")),
            }
        finally:
            _teardown(fm, ctrl, stubs)
    assert got["port"] == got["jax"]
    assert got["port"]["running"] == (True, True, True, False)
    assert got["port"]["metrics_replica_lines"] == ['misaka_x_total{replica="0"} 3',
                                                    'misaka_x_total{replica="1"} 3']


def _normalize_roll(report):
    out = json.loads(json.dumps(report))
    out.pop("duration_s", None)
    for e in out["replicas"]:
        for k in ("drained_in_s", "booted_in_s", "readmitted_in_s"):
            if k in e:
                e[k] = "seconds"
        e["checkpoint"] = os.path.basename(e["checkpoint"]).split("-")[0]
    return out


def test_fleet_roll_json_equal_jax(tmp_path, monkeypatch):
    """POST /fleet/roll over stub replicas, the spawner replaced by a fake
    process (the stub keeps answering): the same report from both."""
    reports = {}
    for pkg, mod in FLEET.items():
        def fake_spawn(self, slot):
            slot["proc"] = _FakeProc()
            slot["spawned_at"] = time.monotonic()
            slot["probe_fails"] = 0
            slot["probe_ok"] = False

        monkeypatch.setattr(mod.FleetManager, "_spawn_inline", fake_spawn)
        fm, ctrl, port, stubs = _stub_control(pkg, tmp_path)
        try:
            status, body = _req(port, "POST", "/fleet/roll", b"", timeout=60)
            assert status == 200, body
            reports[pkg] = json.loads(body)
            assert fm.state()["rolls_total"] == 1
            assert fm.state()["last_roll"]["ok"] is True
            posted = [c[1] for c in stubs[0].calls if c[0] == "POST"]
            assert posted == ["/fleet/drain", "/fleet/drain", "/fleet/drain", "/checkpoint"]
        finally:
            _teardown(fm, ctrl, stubs)
    assert _normalize_roll(reports["port"]) == _normalize_roll(reports["jax"])
    assert [e["restored"] for e in reports["port"]["replicas"]] == [True, True]


@pytest.mark.parametrize("pkg", list(FLEET))
def test_undrain_async_retries_until_replica_recovers(tmp_path, pkg):
    calls: list = []

    class Flaky(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length") or 0))
            calls.append(self.path)
            code = 500 if len(calls) < 3 else 200
            self.send_response(code)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Flaky)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    fm = FLEET[pkg].FleetManager(1, str(tmp_path / "fleet"), base_env={})
    try:
        slot = fm._slots[0]
        slot["proc"] = _FakeProc()
        slot["port"] = srv.server_address[1]
        fm._undrain_async(slot)
        assert _wait(lambda: len(calls) >= 3, 10.0)
        time.sleep(1.2)
        assert calls == ["/fleet/drain"] * 3
    finally:
        srv.shutdown()
        srv.server_close()
        fm.close()


@pytest.mark.parametrize("pkg", list(FLEET))
def test_mark_healthy_keeps_restore_armed_while_rolling(tmp_path, pkg):
    fm = FLEET[pkg].FleetManager(1, str(tmp_path / "fleet"), base_env={})
    try:
        slot = fm._slots[0]
        slot.update(rolling=True, restore="/some/ckpt.npz", run_on_boot=True)
        fm._mark_healthy(slot)
        assert slot["probe_ok"] is True and slot["restore"] == "/some/ckpt.npz"
        assert slot["run_on_boot"] is True
        slot["rolling"] = False
        fm._mark_healthy(slot)
        assert slot["restore"] is None and slot["run_on_boot"] is None
    finally:
        fm.close()


def test_replica_env_equal_jax(tmp_path):
    """The replica environment is the reference's, slot for slot."""
    base = {"MISAKA_PROGRAMS_DIR": "/p", "MISAKA_TSDB_DIR": "/t", "MISAKA_TLS_CERT": "c",
            "MISAKA_TLS_KEY": "k", "MISAKA_ORPHAN_OK": "1", "MISAKA_FLEET": "2",
            "MISAKA_HTTP_WORKERS": "4", "MISAKA_FLEET_RESTORE": "stale"}
    envs = {}
    for pkg, mod in FLEET.items():
        fm = mod.FleetManager(2, str(tmp_path / "fleet"), base_env=base)
        try:
            slot = fm._slots[1]
            slot.update(restore="/r.npz", run_on_boot=False)
            env = fm._replica_env(slot)
            token = env.pop("MISAKA_EDGE_INTERNAL_TOKEN")
            assert token == fm._internal_token
            env.pop("MISAKA_PORT")
            envs[pkg] = env
        finally:
            fm.close()
    assert envs["port"] == envs["jax"]
    assert envs["port"]["MISAKA_FLEET_RESTORE"] == "/r.npz"
    assert envs["port"]["MISAKA_AUTORUN"] == "0"


def test_fleet_fault_points_parse():
    for mod in (jfaults, tfaults):
        spec = mod.parse_spec("replica_kill=2,replica_blackhole:1=5@0.5")
        assert spec["replica_kill"] == (2.0, 1.0)
        assert spec["replica_blackhole:1"] == (5.0, 0.5)
        with pytest.raises(mod.FaultSpecError):
            mod.parse_spec("replica_kill:0=2")


# --- a port fleet on the CPU --------------------------------------------------------------


ADD2_ENV = {
    "NODE_INFO": json.dumps({"misaka1": {"type": "program"}, "misaka2": {"type": "program"},
                             "misaka3": {"type": "stack"}}),
    "MISAKA_PROGRAMS": json.dumps(ADD2_PROGRAMS),
}


def _boot_fleet(tmp_path, extra=None):
    port = tfe.pick_free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("MISAKA_")}
    env.update({**ADD2_ENV, "MISAKA_DEVICE": "cpu", "MISAKA_BATCH": "4",
                "MISAKA_CHUNK_STEPS": "16", "MISAKA_STACK_CAP": "8", "MISAKA_IN_CAP": "8",
                "MISAKA_OUT_CAP": "8", "MISAKA_FLEET": "2", "MISAKA_HTTP_WORKERS": "2",
                "MISAKA_AUTORUN": "1", "MISAKA_PORT": str(port),
                "MISAKA_FLEET_DIR": str(tmp_path / "fleet"), "MISAKA_TTL_S": "300",
                "MISAKA_CANARY": "0", "MISAKA_SAMPLER": "0", "MISAKA_TSDB": "0",
                "MISAKA_WATCHDOG": "0", "MISAKA_FLEET_PROBE_S": "0.2",
                "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
                **(extra or {})})
    log = tmp_path / "fleet.log"
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", "misaka_tpu_torch.runtime.app"],
                                env=env, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
    return proc, port, log


def _get(port, path):
    status, body = _req(port, "GET", path)
    assert status == 200, body
    return json.loads(body)


def _poll(cond, what, deadline_s=60.0):
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            got = cond()
        except (OSError, AssertionError, ValueError):
            got = None
        if got:
            return got
        assert time.monotonic() < deadline, what
        time.sleep(0.1)


class _Load:
    """8 clients of /compute on the public port until stop()."""

    def __init__(self, port, n=8):
        self.port, self.errors, self.count = port, [], 0
        self._stop = threading.Event()
        self._ts = [threading.Thread(target=self._run, args=(i,)) for i in range(n)]
        for t in self._ts:
            t.start()

    def _run(self, i):
        while not self._stop.is_set():
            try:
                status, body = _req(self.port, "POST", "/compute", f"value={i}".encode())
                assert (status, json.loads(body)) == (200, {"value": i + 2}), (status, body)
                self.count += 1
            except Exception as e:  # collected for the assert
                self.errors.append(repr(e))

    def stop(self):
        self._stop.set()
        for t in self._ts:
            t.join(timeout=60)
        return self.errors


def test_cpu_fleet_kills_and_rolls_under_load_zero_errors(tmp_path):
    proc, port, _ = _boot_fleet(tmp_path, {"MISAKA_FAULTS": "replica_kill=1"})
    load = None
    try:
        st = _poll(lambda: (s := _get(port, "/fleet"))["up"] == 2 and s, "fleet up", 90.0)
        load = _Load(port)
        # the replica_kill fault fires once: one replica killed, respawned
        st = _poll(lambda: (s := _get(port, "/fleet"))["restarts_total"] == 1
                   and s["up"] == 2 and s, "replica_kill healed", 60.0)
        # kill -9 of the other replica under the same load
        victim = next(r for r in st["replicas"] if r["restarts"] == 0)
        os.kill(victim["pid"], signal.SIGKILL)
        st = _poll(lambda: (s := _get(port, "/fleet"))["restarts_total"] == 2
                   and s["up"] == 2 and s, "kill -9 healed", 60.0)
        assert load.count > 0 and load.errors == []
        report = json.loads(_req(port, "POST", "/fleet/roll", b"", timeout=120)[1])
        assert report["ok"] is True and [e["restored"] for e in report["replicas"]] == [True] * 2
        assert load.stop() == []
        load = None
        st = _get(port, "/fleet")
        assert st["restarts_total"] == 4 and st["rolls_total"] == 1  # the fault fired once
        # quiescent: the restored state is the roll checkpoint, bit for bit
        assert _req(port, "POST", "/pause", b"") == (200, b"Success")
        assert _req(port, "POST", "/checkpoint", b"name=verify-a")[0] == 200
        quiet = json.loads(_req(port, "POST", "/fleet/roll", b"", timeout=120)[1])
        assert quiet["ok"] is True
        assert _req(port, "POST", "/checkpoint", b"name=verify-b")[0] == 200
        for entry in quiet["replicas"]:
            rdir = tmp_path / "fleet" / f"replica-{entry['replica']}"
            with np.load(entry["checkpoint"]) as z:
                rolled = {k: z[k].copy() for k in z.files if k != "__tsdb__"}
            for name in ("verify-a", "verify-b"):
                with np.load(rdir / f"{name}.npz") as z:
                    got = {k: z[k].copy() for k in z.files if k != "__tsdb__"}
                assert set(got) == set(rolled)
                assert all(np.array_equal(got[k], rolled[k]) for k in got), (entry, name)
        health = _get(port, "/healthz")
        assert health["running"] is False  # the roll kept the fleet paused
        assert set(health) >= {"ok", "engine", "running", "fleet", "degraded", "frontends"}
        assert set(_get(port, "/status")) == {"engine", "fleet", "replicas", "frontends"}
    finally:
        if load is not None:
            load.stop()
        proc.terminate()
        proc.wait(timeout=30)
