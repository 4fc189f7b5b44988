"""The port's multi-host fleet surface against the JAX package's: plane
mTLS over TCP, remote peers, and usage gossip.

- Plane mTLS both ways across packages, with certificates made by openssl
  (skipped where it is absent): the port's PlaneClient against a JAX
  ComputePlane and the reverse round-trip; a plaintext peer and a peer
  outside the CA are refused with a typed, counted close, and both
  packages' counters name the same reasons; a rotation under traffic
  drops no frame and a fresh dial handshakes under the new pair; the
  reloader keeps the old contexts on broken material; a partial
  MISAKA_PLANE_TLS_* triple fails loud in both.
- Several threads send and receive on one mTLS plane at once (12 threads
  on one connection, the router's probes, clients closed under traffic)
  in a process of its own, which must stay up; and 40 fresh mTLS
  connections in a row each answer at once (a TLS 1.3 session ticket read
  while the same session is written stalled some of them).
- Peers, each case on both packages' FleetManager (tests/test_dist.py
  :493-720): registration and the probe-only state ladder, probing up and
  down, a peer roll (drain -> checkpoint -> readmit) and a failed one that
  undrains, the gossip hub's bucket reconciliation under a clock the test
  holds still (no refill lands inside the asserted step), a gossip error
  counted for an unreachable peer, and the bound on a flooded tenant's
  aggregate admission.
- A replica that cannot boot ends the port's fleet parent non-zero,
  naming the replica's exit code, and no fleet ever answers.
- The fleet's observatory: replica-labelled history on the parent's
  merged series, its filter and dashboard, surviving a roll.
- Roll checkpoints cross packages: each package's roll gate takes the
  other's, and a port replica restores a JAX one (and the reverse).
"""

import json
import os
import shutil
import socket
import ssl
import subprocess
import sys
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import numpy as np
import pytest

from misaka_tpu.runtime import edge as jedge
from misaka_tpu.runtime import fleet as jfleet
from misaka_tpu.runtime import frontends as jfe
from misaka_tpu.utils import faults as jfaults
from misaka_tpu_torch.runtime import edge as tedge
from misaka_tpu_torch.runtime import fleet as tfleet
from misaka_tpu_torch.runtime import frontends as tfe
from misaka_tpu_torch.utils import faults as tfaults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {
    "jax": types.SimpleNamespace(edge=jedge, fleet=jfleet, fe=jfe),
    "port": types.SimpleNamespace(edge=tedge, fleet=tfleet, fe=tfe),
}
_HAVE_OPENSSL = shutil.which("openssl") is not None


@pytest.fixture(autouse=True)
def _cleanup():
    yield
    for p in PKG.values():
        p.edge.reset()
    jfaults.configure(None)
    tfaults.configure(None)


class _StubMaster:
    is_running = True

    def __init__(self):
        self.calls = 0
        self.values = 0
        self._lock = threading.Lock()

    def compute_coalesced(self, values, timeout=30.0, return_array=True, traces=()):
        with self._lock:
            self.calls += 1
            self.values += int(np.asarray(values).size)
        return np.asarray(values) + 2


BODY = np.arange(8, dtype=np.int32).tobytes()
WANT = np.arange(8, dtype=np.int32) + 2


def _check(out):
    assert np.array_equal(np.frombuffer(out, dtype="<i4"), WANT)


def _tcp_addr() -> str:
    return f"127.0.0.1:{tfe.pick_free_port()}"


# --- plane mTLS ---------------------------------------------------------------------------


def _gen_cert(directory, name, cn):
    cert, key = str(directory / f"{name}.pem"), str(directory / f"{name}.key")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "ec", "-pkeyopt",
                    "ec_paramgen_curve:prime256v1", "-nodes", "-keyout", key, "-out", cert,
                    "-days", "1", "-subj", f"/CN={cn}",
                    "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
                   check=True, capture_output=True)
    return cert, key


@pytest.fixture(scope="module")
def plane_certs(tmp_path_factory):
    """(fleet cert, key, rogue cert, key): each self-signed, its own CA."""
    if not _HAVE_OPENSSL:
        pytest.skip("openssl unavailable")
    d = tmp_path_factory.mktemp("plane-certs")
    return (*_gen_cert(d, "fleet", "misaka-fleet"), *_gen_cert(d, "rogue", "rogue-peer"))


def _tls_env(monkeypatch, cert, key, ca):
    monkeypatch.setenv("MISAKA_PLANE_TLS_CERT", cert)
    monkeypatch.setenv("MISAKA_PLANE_TLS_KEY", key)
    monkeypatch.setenv("MISAKA_PLANE_TLS_CA", ca)


def _rejects(pkg):
    return {r: PKG[pkg].edge.M_PLANE_TLS_REJECTED.labels(reason=r).value
            for r in ("plaintext", "bad_cert", "handshake")}


def _wait_reject(pkg, reason, before, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if _rejects(pkg)[reason] > before[reason]:
            return True
        time.sleep(0.02)
    return False


def _close_ends(client_pkg, clients, plane):
    """Close the port's end first, then wait for the clients' threads.
    The JAX package closes a TLS socket from another thread than its
    reader, whose session may then read a new connection that reuses the
    descriptor: shut down from the port's side first, the JAX end's
    reader meets EOF, and no later dial starts before it has exited (the
    port closes a socket only from its reader)."""
    clients = [c for c in clients if c is not None]
    if client_pkg == "port":
        for c in clients:
            c.close()
        plane.close()
    else:
        plane.close()
        for c in clients:
            c.close()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and any(
            t.name == "misaka-plane-recv" or t.name.startswith("misaka-plane-client")
            for t in threading.enumerate()):
        time.sleep(0.01)


def _plaintext_dial(addr):
    _, host, port = tfe.parse_plane_addr(addr)
    raw = socket.create_connection((host, port), timeout=5)
    try:
        raw.sendall(b"\x08\x00\x00\x00\x00\x00\x00\x00plaintext!")
        raw.settimeout(5)
        try:
            return raw.recv(64)
        except ConnectionResetError:
            return b""
    finally:
        raw.close()


def _rogue_dial(addr, rogue_cert, rogue_key, ca):
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_cert_chain(rogue_cert, rogue_key)
    ctx.load_verify_locations(ca)
    ctx.check_hostname = False
    _, host, port = tfe.parse_plane_addr(addr)
    raw = socket.create_connection((host, port), timeout=5)
    raw.settimeout(5)
    try:
        # TLS 1.3 delivers the server's alert on the first read
        s = ctx.wrap_socket(raw, server_hostname=host)
        s.sendall(b"\x00" * 8)
        s.recv(64)
    except OSError:
        pass
    finally:
        raw.close()


def test_plane_tls_env_validation_equal_jax(monkeypatch, plane_certs):
    cert, key, _, _ = plane_certs
    for var in ("MISAKA_PLANE_TLS_CERT", "MISAKA_PLANE_TLS_KEY", "MISAKA_PLANE_TLS_CA"):
        monkeypatch.delenv(var, raising=False)
    out = {}
    for pkg, p in PKG.items():
        got = [p.edge.plane_tls_from_env()]
        monkeypatch.setenv("MISAKA_PLANE_TLS_CERT", cert)
        with pytest.raises(ValueError) as e:
            p.edge.plane_tls_from_env()
        got.append(str(e.value))
        _tls_env(monkeypatch, cert, key, cert)
        r = p.edge.plane_tls_from_env()
        got.append((r.client_context().verify_mode, r.server_context().verify_mode,
                    r.client_context().check_hostname))
        for var in ("MISAKA_PLANE_TLS_CERT", "MISAKA_PLANE_TLS_KEY", "MISAKA_PLANE_TLS_CA"):
            monkeypatch.delenv(var, raising=False)
        out[pkg] = got
    assert out["port"] == out["jax"]
    assert out["port"][0] is None and out["port"][2][0] == ssl.CERT_REQUIRED


@pytest.mark.parametrize("client_pkg,plane_pkg",
                         [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_plane_mtls_roundtrip_and_plaintext_refusal(monkeypatch, plane_certs, client_pkg,
                                                    plane_pkg):
    cert, key, _, _ = plane_certs
    _tls_env(monkeypatch, cert, key, cert)
    master = _StubMaster()
    addr = _tcp_addr()
    plane = PKG[plane_pkg].fe.start_compute_plane(master, addr)
    client = PKG[client_pkg].fe.PlaneClient(addr, conns=1, timeout=5)
    try:
        for _ in range(3):
            _check(client.compute_raw(BODY, timeout=5))
        before, served = _rejects(plane_pkg), master.calls
        assert _plaintext_dial(addr) == b""  # closed, no response byte
        assert _wait_reject(plane_pkg, "plaintext", before)
        assert master.calls == served  # nothing reached the engine
        _check(client.compute_raw(BODY, timeout=5))  # the data path is unaffected
    finally:
        _close_ends(client_pkg, [client], plane)


@pytest.mark.parametrize("plane_pkg", ["jax", "port"])
def test_plane_mtls_wrong_ca_refused(monkeypatch, plane_certs, plane_pkg):
    cert, key, rogue_cert, rogue_key = plane_certs
    _tls_env(monkeypatch, cert, key, cert)
    addr = _tcp_addr()
    plane = PKG[plane_pkg].fe.start_compute_plane(_StubMaster(), addr)
    try:
        before = _rejects(plane_pkg)
        _rogue_dial(addr, rogue_cert, rogue_key, cert)
        assert _wait_reject(plane_pkg, "bad_cert", before)
    finally:
        plane.close()


def test_plane_tls_rejects_name_the_same_reasons(monkeypatch, plane_certs):
    """The same refused peers (plaintext, then outside the CA) move the
    same reason counters on both packages' planes."""
    cert, key, rogue_cert, rogue_key = plane_certs
    _tls_env(monkeypatch, cert, key, cert)
    moved = {}
    for pkg in PKG:
        addr = _tcp_addr()
        plane = PKG[pkg].fe.start_compute_plane(_StubMaster(), addr)
        try:
            before = _rejects(pkg)
            _plaintext_dial(addr)
            assert _wait_reject(pkg, "plaintext", before)
            _rogue_dial(addr, rogue_cert, rogue_key, cert)
            assert _wait_reject(pkg, "bad_cert", before)
            after = _rejects(pkg)
            moved[pkg] = {r: after[r] - before[r] for r in after}
        finally:
            plane.close()
    assert moved["port"] == moved["jax"] == {"plaintext": 1, "bad_cert": 1, "handshake": 0}
    # and the classifier maps the same handshake errors to the same reasons
    for text in ("[SSL: WRONG_VERSION_NUMBER] wrong version number",
                 "[SSL: TLSV1_ALERT_UNKNOWN_CA] tlsv1 alert unknown ca",
                 "[SSL: CERTIFICATE_VERIFY_FAILED]", "[SSL: HTTP_REQUEST] http request",
                 "EOF occurred in violation of protocol", "record layer failure"):
        e = ssl.SSLError(1, text)
        assert tfe._classify_tls_reject(e) == jfe._classify_tls_reject(e)


def test_plane_tls_reloader_rotation_and_bad_material(tmp_path, plane_certs):
    cert, key, rogue_cert, rogue_key = plane_certs
    live_cert, live_key, live_ca = (str(tmp_path / n) for n in ("live.pem", "live.key", "ca.pem"))
    shutil.copy(cert, live_cert)
    shutil.copy(key, live_key)
    shutil.copy(cert, live_ca)
    reloader = tedge.PlaneTLSReloader(live_cert, live_key, live_ca)
    s1 = reloader.server_context()
    ok0 = tedge.M_PLANE_TLS_RELOADS.labels(status="ok").value
    err0 = tedge.M_PLANE_TLS_RELOADS.labels(status="error").value
    shutil.copy(rogue_cert, live_cert)
    shutil.copy(rogue_key, live_key)
    with open(live_ca, "wb") as f, open(cert, "rb") as a, open(rogue_cert, "rb") as b:
        f.write(a.read() + b.read())
    now = time.time() + 5
    for p in (live_cert, live_key, live_ca):
        os.utime(p, (now, now))
    reloader._next_stat = 0.0
    s2 = reloader.server_context()
    assert s2 is not s1
    assert tedge.M_PLANE_TLS_RELOADS.labels(status="ok").value == ok0 + 1
    with open(live_key, "w") as f:
        f.write("not a key")
    os.utime(live_key, (now + 5, now + 5))
    reloader._next_stat = 0.0
    assert reloader.server_context() is s2  # a broken rotation keeps the old pair
    assert tedge.M_PLANE_TLS_RELOADS.labels(status="error").value == err0 + 1


@pytest.mark.parametrize("client_pkg,plane_pkg", [("port", "jax"), ("jax", "port")])
def test_plane_mtls_rotation_under_traffic(monkeypatch, tmp_path, plane_certs, client_pkg,
                                           plane_pkg):
    cert, key, _, _ = plane_certs
    live_cert, live_key, live_ca = (str(tmp_path / n) for n in ("live.pem", "live.key", "ca.pem"))
    shutil.copy(cert, live_cert)
    shutil.copy(key, live_key)
    shutil.copy(cert, live_ca)
    _tls_env(monkeypatch, live_cert, live_key, live_ca)
    master = _StubMaster()
    addr = _tcp_addr()
    plane = PKG[plane_pkg].fe.start_compute_plane(master, addr)
    client = PKG[client_pkg].fe.PlaneClient(addr, conns=1, timeout=5)
    c2 = None
    try:
        for _ in range(10):
            _check(client.compute_raw(BODY, timeout=5))
        new_cert, new_key = _gen_cert(tmp_path, "rotated", "misaka-fleet-2")
        with open(live_ca, "wb") as f, open(cert, "rb") as a, open(new_cert, "rb") as b:
            f.write(a.read() + b.read())
        shutil.copy(new_cert, live_cert)
        shutil.copy(new_key, live_key)
        now = time.time() + 5
        for p in (live_cert, live_key, live_ca):
            os.utime(p, (now, now))
        plane._tls._next_stat = 0.0
        client._tls._next_stat = 0.0
        for _ in range(10):
            _check(client.compute_raw(BODY, timeout=5))  # the session streams on
        assert master.values == 160  # 20 frames x 8 values, none dropped
        c2 = PKG[client_pkg].fe.PlaneClient(addr, conns=1, timeout=5)
        _check(c2.compute_raw(BODY, timeout=5))  # a fresh dial, the new pair
    finally:
        _close_ends(client_pkg, [c2, client], plane)


CONCURRENT = r"""
import os, sys, threading, time
import numpy as np
sys.path.insert(0, sys.argv[1])
from misaka_tpu_torch.runtime import frontends as fe

class M:
    is_running = True
    def compute_coalesced(self, values, timeout=30.0, return_array=True, traces=()):
        time.sleep(0.001)
        return np.asarray(values) + 2

addr = f"127.0.0.1:{fe.pick_free_port()}"
os.environ["MISAKA_PLANE_PIPELINE"] = "8"  # asked for; an mTLS session runs one at a time
plane = fe.start_compute_plane(M(), addr)
client = fe.PlaneClient(addr, conns=1, timeout=20)     # one socket for 12 threads
router = fe.FleetPlaneRouter([addr], conns=1, probe_s=0.01, down_grace=5.0)
errors = []

def hammer(c, n, base):
    try:
        for j in range(n):
            vals = np.arange(base + j, base + j + 1 + j % 7, dtype="<i4")
            out = np.frombuffer(c.compute_raw(vals.tobytes(), timeout=20), "<i4")
            assert np.array_equal(out, vals + 2)
    except Exception as e:
        errors.append(repr(e))

def churn():
    # clients closed under traffic: their receivers are parked in recv
    for _ in range(6):
        c = fe.PlaneClient(addr, conns=2, timeout=20)
        ts = [threading.Thread(target=hammer, args=(c, 20, 10_000 * k)) for k in range(3)]
        [t.start() for t in ts]
        time.sleep(0.02)
        [t.join() for t in ts]
        c.close()

ts = [threading.Thread(target=hammer, args=(client, 60, 1000 * i)) for i in range(12)]
ts += [threading.Thread(target=hammer, args=(router, 40, 500_000 + 1000 * i)) for i in range(4)]
ts.append(threading.Thread(target=churn))
for _ in range(20):
    router._replicas[0].mark("down")  # the prober dials the plane too
    time.sleep(0.005)
[t.start() for t in ts]
[t.join(timeout=120) for t in ts]
client.close(); router.close(); plane.close()
print("ERRORS", len(errors), errors[:3])
"""


def test_concurrent_threads_on_one_mtls_plane_stay_up(monkeypatch, plane_certs):
    cert, key, _, _ = plane_certs
    env = {**os.environ, "MISAKA_PLANE_TLS_CERT": cert, "MISAKA_PLANE_TLS_KEY": key,
           "MISAKA_PLANE_TLS_CA": cert}
    out = subprocess.run([sys.executable, "-c", CONCURRENT, ROOT], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ERRORS 0 []" in out.stdout, out.stdout[-2000:]


# --- remote peers -------------------------------------------------------------------------


class _FakePeer:
    """A remote replica's control surface, deep enough for probes, the
    roll and gossip: /healthz, /fleet/drain, /checkpoint, /edge/gossip.
    Records every call and every presented key."""

    def __init__(self, chain=None, checkpoint_status=200, healthy=True):
        self.calls: list = []
        self.keys: list = []
        self.chain = chain
        self.checkpoint_status = checkpoint_status
        self.healthy = healthy
        peer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, status, obj):
                body = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                peer.keys.append(self.headers.get("X-Misaka-Key"))
                peer.calls.append(("GET", self.path, None))
                if self.path == "/healthz" and peer.healthy:
                    self._reply(200, {"ok": True, "running": True, "degraded": False})
                elif self.path == "/healthz":
                    self._reply(503, {"ok": False})
                else:
                    self._reply(404, {"error": "no route"})

            def do_POST(self):
                peer.keys.append(self.headers.get("X-Misaka-Key"))
                raw = self.rfile.read(int(self.headers.get("Content-Length") or 0))
                if self.path == "/fleet/drain":
                    form = {k: v[-1] for k, v in parse_qs(raw.decode()).items()}
                    peer.calls.append(("POST", self.path, form))
                    self._reply(200, {"draining": form.get("state") == "on", "inflight": 0,
                                      "http_inflight": 0})
                elif self.path == "/checkpoint":
                    peer.calls.append(("POST", self.path, raw.decode()))
                    self._reply(peer.checkpoint_status, {"ok": peer.checkpoint_status == 200})
                elif self.path == "/edge/gossip":
                    payload = json.loads(raw or b"{}")
                    peer.calls.append(("POST", self.path, payload))
                    drained = peer.chain.apply_remote_usage(
                        payload.get("usage") or {}, source=str(payload.get("source") or "peer"))
                    self._reply(200, {"drained": drained, "usage": peer.chain.usage_snapshot()})
                else:
                    peer.calls.append(("POST", self.path, raw))
                    self._reply(404, {"error": "no route"})

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.mark.parametrize("pkg", list(PKG))
def test_fleet_registers_remote_peers(tmp_path, pkg):
    fm = PKG[pkg].fleet.FleetManager(1, str(tmp_path), base_env={
        "MISAKA_FLEET_PEERS": "10.0.0.2:9000,10.0.0.3:9000:9501",
        "MISAKA_FLEET_PEER_KEY": "peer-admin-key"})
    try:
        assert [p["idx"] for p in fm._peers] == [1, 2]
        assert fm._peer_key == "peer-admin-key"
        paths = fm.plane_paths()
        assert len(paths) == 3 and paths[1:] == ["10.0.0.2:9001", "10.0.0.3:9501"]
        st = fm.state()
        assert st["peers"] == 2 and st["peers_up"] == 0
        remote = [r for r in st["replicas"] if r.get("remote")]
        assert [r["replica"] for r in remote] == [1, 2]
        assert all(r["state"] == "starting" and r["pid"] is None for r in remote)
        peer = fm._peers[0]
        ladder = [fm.peer_state(peer)]
        peer["probe_fails"] = 1
        ladder.append(fm.peer_state(peer))
        peer["probe_fails"] = fm._down_after
        ladder.append(fm.peer_state(peer))
        peer["probe_ok"] = True
        ladder.append(fm.peer_state(peer))
        peer["rolling"] = True
        ladder.append(fm.peer_state(peer))
        assert ladder == ["starting", "degraded", "down", "up", "draining"]
    finally:
        fm.close()


@pytest.mark.parametrize("pkg", list(PKG))
def test_fleet_peer_probing_up_and_down(tmp_path, pkg):
    peer_srv = _FakePeer()
    fm = PKG[pkg].fleet.FleetManager(
        1, str(tmp_path), probe_s=0.05, down_after=2,
        base_env={"MISAKA_FLEET_PEERS": f"127.0.0.1:{peer_srv.port}",
                  "MISAKA_FLEET_PEER_KEY": "pk"})
    peer = fm._peers[0]
    try:
        threading.Thread(target=fm._peer_probe_loop, args=(peer,), daemon=True).start()
        deadline = time.monotonic() + 5
        while fm.peer_state(peer) != "up":
            assert time.monotonic() < deadline, "peer never probed up"
            time.sleep(0.02)
        assert peer["running"] is True and peer["degraded"] is False
        assert "pk" in peer_srv.keys  # probes present the peer key
        peer_srv.close()
        deadline = time.monotonic() + 5
        while fm.peer_state(peer) != "down":
            assert time.monotonic() < deadline, "dead peer never down"
            time.sleep(0.02)
        assert fm.state()["peers_up"] == 0
    finally:
        fm.close()
        peer_srv.close()


@pytest.mark.parametrize("pkg", list(PKG))
def test_roll_peer_drain_checkpoint_readmit(tmp_path, pkg):
    peer_srv = _FakePeer()
    fm = PKG[pkg].fleet.FleetManager(
        1, str(tmp_path), base_env={"MISAKA_FLEET_PEERS": f"127.0.0.1:{peer_srv.port}",
                                    "MISAKA_FLEET_PEER_KEY": "pk"})
    peer = fm._peers[0]
    try:
        peer["probe_ok"] = True
        entry = fm._roll_peer(peer, drain_timeout_s=5.0)
        assert entry["remote"] is True and entry["host"] == "127.0.0.1"
        assert entry["restored"] is False and entry["checkpoint"].startswith("fleet-roll-")
        assert sorted(entry) == ["checkpoint", "drained_in_s", "host", "readmitted_in_s",
                                 "remote", "replica", "restored"]
        assert peer["rolling"] is False
        posts = [(p, f) for (m, p, f) in peer_srv.calls if m == "POST"]
        drains = [f for (p, f) in posts if p == "/fleet/drain"]
        assert drains[0]["state"] == "on" and drains[-1]["state"] == "off"
        paths = [p for (p, _) in posts]
        assert paths.index("/checkpoint") > paths.index("/fleet/drain")
        assert set(peer_srv.keys) == {"pk"}
    finally:
        fm.close()
        peer_srv.close()


@pytest.mark.parametrize("pkg", list(PKG))
def test_roll_peer_failure_undrains(tmp_path, pkg):
    peer_srv = _FakePeer(checkpoint_status=500)
    fm = PKG[pkg].fleet.FleetManager(
        1, str(tmp_path), base_env={"MISAKA_FLEET_PEERS": f"127.0.0.1:{peer_srv.port}"})
    peer = fm._peers[0]
    try:
        peer["probe_ok"] = True
        with pytest.raises(RuntimeError, match="checkpoint failed"):
            fm._roll_peer(peer, drain_timeout_s=5.0)
        assert peer["rolling"] is False
        drains = [f for (m, p, f) in peer_srv.calls if m == "POST" and p == "/fleet/drain"]
        assert drains[-1]["state"] == "off"
    finally:
        fm.close()
        peer_srv.close()


# --- usage gossip -------------------------------------------------------------------------


@pytest.fixture
def still_clock(monkeypatch):
    """Both packages' edges read a monotonic clock the test holds still:
    no bucket refills between two reads, whatever the machine's load."""
    now = [time.monotonic()]
    for edge in (jedge, tedge):
        fake = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                        if not k.startswith("_")})
        fake.monotonic = lambda: now[0]
        monkeypatch.setattr(edge, "time", fake)
    return now


def _flood_chain(edge, rate=100.0, burst_s=1.0):
    return edge.EdgeChain(quota_defaults={"rps": rate}, burst_s=burst_s, auth_enabled=False,
                          admission_enabled=False)


def _rps_tokens(chain, tenant="flood"):
    with chain._lock:
        buckets = [b for (t, f, _r), b in chain._buckets.items() if t == tenant and f == "rps"]
    assert len(buckets) == 1
    return buckets[0].tokens


@pytest.mark.parametrize("pkg", list(PKG))
def test_gossip_hub_round_reconciles_peer_buckets(tmp_path, still_clock, pkg):
    p = PKG[pkg]
    chain_a, chain_b = _flood_chain(p.edge), _flood_chain(p.edge)
    for _ in range(3):
        assert chain_a.check("/compute", program="flood", requests=20).reject is None
    assert chain_b.check("/compute", program="flood").reject is None
    srv_a, srv_b = _FakePeer(chain=chain_a), _FakePeer(chain=chain_b)
    fm = p.fleet.FleetManager(1, str(tmp_path), base_env={
        "MISAKA_FLEET_PEERS": f"127.0.0.1:{srv_a.port},127.0.0.1:{srv_b.port}",
        "MISAKA_GOSSIP_S": "0"})
    try:
        for peer in fm._peers:
            peer["probe_ok"] = True
        ok0 = p.fleet.M_FLEET_GOSSIP.labels(status="ok").value
        fm._gossip_round()  # collects both snapshots
        fm._gossip_round()  # ships each side's sum to the other
        assert p.fleet.M_FLEET_GOSSIP.labels(status="ok").value == ok0 + 4
        # the clock stood still: exactly the other side's admissions drained
        assert _rps_tokens(chain_b) == 100.0 - 1 - 60
        assert _rps_tokens(chain_a) == 100.0 - 60 - 1
        t_b = _rps_tokens(chain_b)
        fm._gossip_round()  # the same cumulative totals drain nothing new
        assert _rps_tokens(chain_b) == t_b
        still_clock[0] += 0.5  # half a second later the bucket has refilled 50
        assert chain_b.check("/compute", program="flood").reject is None
        assert _rps_tokens(chain_b) == t_b + 50.0 - 1
    finally:
        fm.close()
        srv_a.close()
        srv_b.close()


@pytest.mark.parametrize("pkg", list(PKG))
def test_gossip_loop_counts_unreachable_peer_errors(tmp_path, pkg):
    p = PKG[pkg]
    fm = p.fleet.FleetManager(1, str(tmp_path), base_env={
        "MISAKA_FLEET_PEERS": f"127.0.0.1:{tfe.pick_free_port()}", "MISAKA_GOSSIP_S": "0"})
    try:
        fm._peers[0]["probe_ok"] = True  # up per the prober, gone on the wire
        err0 = p.fleet.M_FLEET_GOSSIP.labels(status="error").value
        fm._gossip_round()
        assert p.fleet.M_FLEET_GOSSIP.labels(status="error").value == err0 + 1
    finally:
        fm.close()


def _simulate_flood(edge, reconcile: bool) -> float:
    """Two replicas, one flooded tenant, a simulated clock (every bucket's
    stamp moved back by each step): 800 req/s of demand at each against a
    400 req/s quota for 2.5 s; the aggregate admitted quota tokens."""
    rate, burst_s, horizon, dt, gossip_every = 400.0, 0.25, 2.5, 0.0125, 0.2
    chains = [_flood_chain(edge, rate=rate, burst_s=burst_s) for _ in range(2)]
    gossip_steps = int(gossip_every / dt)
    for step in range(int(horizon / dt)):
        for c in chains:
            c.check("/compute", program="flood", requests=10)
            with c._lock:
                for bk in c._buckets.values():
                    bk.stamp -= dt
        if reconcile and step and step % gossip_steps == 0:
            a, b = chains
            b.apply_remote_usage(a.usage_snapshot(), source="a")
            a.apply_remote_usage(b.usage_snapshot(), source="b")
    return sum(c.usage_snapshot().get("flood|rps", 0.0) for c in chains)


def test_gossip_bounds_fleet_over_admission(still_clock):
    quota = 400.0 * 2.5
    got = {pkg: (_simulate_flood(p.edge, True), _simulate_flood(p.edge, False))
           for pkg, p in PKG.items()}
    assert got["port"] == got["jax"]
    reconciled, unreconciled = got["port"]
    assert unreconciled >= 1.8 * quota  # ~2x without gossip
    assert reconciled <= 1.25 * quota   # the documented bound


# --- a fleet that cannot boot ----------------------------------------------------------------


def test_replica_that_cannot_boot_fails_the_parent(tmp_path):
    # the replicas refuse MISAKA_ENGINE=fused-interpret (the port has no
    # kernel interpreter); the parent's own checks pass, so only a
    # replica's exit can end the boot
    from misaka_tpu_torch.networks import ADD2_PROGRAMS

    port = tfe.pick_free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("MISAKA_")}
    env.update({
        "NODE_INFO": json.dumps({"misaka1": {"type": "program"}, "misaka2": {"type": "program"},
                                 "misaka3": {"type": "stack"}}),
        "MISAKA_PROGRAMS": json.dumps(ADD2_PROGRAMS), "MISAKA_DEVICE": "cpu",
        "MISAKA_BATCH": "4", "MISAKA_ENGINE": "fused-interpret", "MISAKA_FLEET": "2",
        "MISAKA_HTTP_WORKERS": "2", "MISAKA_PORT": str(port),
        "MISAKA_FLEET_DIR": str(tmp_path / "fleet"), "MISAKA_TTL_S": "300",
        "MISAKA_CANARY": "0", "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")})
    log = tmp_path / "fleet.log"
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", "misaka_tpu_torch.runtime.app"],
                                env=env, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
    try:
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode != 0
    assert "exited during boot (code 1)" in log.read_text()
    with pytest.raises(OSError):  # no fleet ever answered
        socket.create_connection(("127.0.0.1", port), timeout=2).close()


# --- the fleet's observatory --------------------------------------------------------------


def _get_json(port, path, timeout=10):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return json.loads(r.read())


def test_fleet_observatory_history_survives_a_roll(tmp_path):
    """The port of tests/test_observatory.py::test_fleet_observatory_drill
    as far as the fleet carries it (the page-and-recover drill is the
    single engine's, tests/test_torch_observatory.py): a port fleet of 2
    CPU replicas with registries, a 0.5 s collector and canary; the
    parent's merged /debug/series carries replica-labelled history, the
    `replica` label filters it, the merged dashboard serves, a fault spec
    fans out to every replica and /debug/alerts carries the parent's
    watchdog; after POST /fleet/roll the history from before it is
    still there."""
    import urllib.request
    from urllib.parse import urlencode

    from misaka_tpu_torch.networks import ADD2_PROGRAMS

    port = tfe.pick_free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("MISAKA_")}
    env.update({
        "NODE_INFO": json.dumps({"misaka1": {"type": "program"}, "misaka2": {"type": "program"},
                                 "misaka3": {"type": "stack"}}),
        "MISAKA_PROGRAMS": json.dumps(ADD2_PROGRAMS), "MISAKA_DEVICE": "cpu",
        "MISAKA_BATCH": "8", "MISAKA_IN_CAP": "32", "MISAKA_OUT_CAP": "32",
        "MISAKA_STACK_CAP": "16", "MISAKA_CHUNK_STEPS": "16", "MISAKA_FLEET": "2",
        "MISAKA_HTTP_WORKERS": "2", "MISAKA_AUTORUN": "1", "MISAKA_PORT": str(port),
        "MISAKA_FLEET_DIR": str(tmp_path / "fleet"),
        "MISAKA_PROGRAMS_DIR": str(tmp_path / "programs"), "MISAKA_TTL_S": "300",
        "MISAKA_TSDB_INTERVAL_S": "0.5", "MISAKA_TSDB_BUDGET": "0.5",
        "MISAKA_CANARY_INTERVAL_S": "0.5", "MISAKA_SAMPLER": "0",
        "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")})
    with open(tmp_path / "fleet.log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "misaka_tpu_torch.runtime.app"],
                                env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)

    def poll(cond, what, deadline_s=90.0):
        deadline = time.monotonic() + deadline_s
        while True:
            try:
                got = cond()
            except (OSError, ValueError, KeyError):
                got = None
            if got:
                return got
            assert time.monotonic() < deadline, what
            time.sleep(0.25)

    def series(query=""):
        return _get_json(port, "/debug/series?name=misaka_canary_success&window=10m" + query)

    def post(path, fields, timeout=30):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=urlencode(fields).encode())
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()

    try:
        poll(lambda: (h := _get_json(port, "/healthz")).get("ok") and not h.get("degraded")
             and (h.get("canary") or {}).get("tiers", {}).get("full") is True,
             "the fleet canary never went green")
        poll(lambda: {"0", "1"} <= {r["labels"].get("replica") for r in series()["series"]
                                    if r["points"]}, "no replica-labelled canary history")
        q0 = series("&label=replica=0")
        assert q0["series"] and all(r["labels"]["replica"] == "0" for r in q0["series"])
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/dashboard?window=5m",
                                    timeout=15) as r:
            page = r.read().decode()
        assert "misaka observatory" in page and "Canary success" in page
        assert "Replicas alive" in page  # the parent's own fleet series
        # a fault spec reaches every replica: the fan-out answers as one did
        status, body = post("/debug/faults", {"spec": "plane_delay=0.001"})
        assert status == 200 and json.loads(body)["armed"] == ["plane_delay"], body
        assert post("/debug/faults", {"spec": ""})[0] == 200
        assert "fleet_watchdog" in _get_json(port, "/debug/alerts")
        t_roll = time.time()
        status, body = post("/fleet/roll", {}, timeout=120)
        assert status == 200 and all(e["restored"] for e in json.loads(body)["replicas"])
        survived = [r for r in series()["series"] if r["labels"].get("replica") in ("0", "1")
                    and r["points"] and r["points"][0][0] < t_roll - 1]
        assert survived, "no history from before the roll survived it"
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# --- roll checkpoints across packages -----------------------------------------------------


def test_roll_checkpoints_cross_packages(tmp_path):
    """A JAX replica's roll checkpoint passes the port's roll gate and a
    port replica booted with MISAKA_FLEET_RESTORE=<it> serves from exactly
    that state; a port replica's passes the JAX gate and restores into a
    JAX master (its replica's restore is that load)."""
    import urllib.request

    from misaka_tpu import networks as jnet
    from misaka_tpu.runtime.master import MasterNode as JMaster
    from misaka_tpu_torch import networks as tnet
    from misaka_tpu_torch.core.state import state_to_numpy
    from misaka_tpu_torch.networks import ADD2_PROGRAMS
    from misaka_tpu_torch.runtime.master import MasterNode as TMaster

    caps = dict(in_cap=8, out_cap=8, stack_cap=8)
    rng = np.random.default_rng(20261017)

    def arrays(path):
        with np.load(path) as z:
            return {k: z[k].copy() for k in z.files if k != "__tsdb__"}

    jm = JMaster(jnet.add2(**caps), chunk_steps=16, batch=4, engine="scan")
    try:
        jm.run()
        jm.compute_spread(rng.integers(-500, 500, size=24).astype(np.int32))
        jm.pause()
        jpath = str(tmp_path / "jax-roll.npz")
        jm.save_checkpoint(jpath)
    finally:
        jm.close()
    tfleet.verify_manifest(jpath)  # the port's roll gate takes it

    port = tfe.pick_free_port()
    ckdir = tmp_path / "replica-0"
    env = {k: v for k, v in os.environ.items() if not k.startswith("MISAKA_")}
    env.update({
        "NODE_INFO": json.dumps({"misaka1": {"type": "program"}, "misaka2": {"type": "program"},
                                 "misaka3": {"type": "stack"}}),
        "MISAKA_PROGRAMS": json.dumps(ADD2_PROGRAMS), "MISAKA_DEVICE": "cpu",
        "MISAKA_BATCH": "4", "MISAKA_CHUNK_STEPS": "16", "MISAKA_IN_CAP": "8",
        "MISAKA_OUT_CAP": "8", "MISAKA_STACK_CAP": "8", "MISAKA_PORT": str(port),
        "MISAKA_FLEET": "0", "MISAKA_FLEET_REPLICA": "0", "MISAKA_FLEET_RESTORE": jpath,
        "MISAKA_CHECKPOINT_DIR": str(ckdir), "MISAKA_AUTORUN": "0", "MISAKA_TTL_S": "120",
        "MISAKA_CANARY": "0", "MISAKA_SAMPLER": "0", "MISAKA_TSDB": "0",
        "MISAKA_WATCHDOG": "0",
        "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")})
    with open(tmp_path / "replica.log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "misaka_tpu_torch.runtime.app"],
                                env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 90
        while True:
            try:
                req = urllib.request.Request(f"http://127.0.0.1:{port}/checkpoint",
                                             data=b"name=back")
                with urllib.request.urlopen(req, timeout=10) as r:
                    assert r.status == 200
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.2)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    back = arrays(str(ckdir / "back.npz"))
    want = arrays(jpath)
    assert set(back) == set(want)
    assert all(np.array_equal(back[k], want[k]) for k in want)

    tm = TMaster(tnet.add2(**caps), chunk_steps=16, batch=4, device="cpu")
    jm = JMaster(jnet.add2(**caps), chunk_steps=16, batch=4, engine="scan")
    try:
        tm.run()
        tm.compute_spread(rng.integers(-500, 500, size=24).astype(np.int32))
        tm.pause()
        tpath = str(tmp_path / "port-roll.npz")
        tm.save_checkpoint(tpath)
        jfleet.verify_manifest(tpath)  # the JAX roll gate takes it
        jm.load_checkpoint(tpath)
        got = jm.snapshot()
        want = state_to_numpy(tm.snapshot())
        assert all(np.array_equal(np.asarray(getattr(got, f)), want[f]) for f in want)
    finally:
        tm.close()
        jm.close()


@pytest.mark.parametrize("plane_pkg", ["port", "jax"])
def test_fresh_mtls_connections_answer_at_once(monkeypatch, plane_certs, plane_pkg):
    """40 fresh mTLS dials of the port's client in a row, three frames
    each: none may stall.  A TLS 1.3 session ticket read by the receiver
    while the dispatcher wrote the same session stalled a few percent of
    such dials before the port's client alternated reads and writes on an
    mTLS session, its plane stopped sending tickets, and a socket is
    closed only by its reader."""
    client_pkg = "port"
    cert, key, _, _ = plane_certs
    _tls_env(monkeypatch, cert, key, cert)
    stalled = 0
    for _ in range(40):
        addr = _tcp_addr()
        plane = PKG[plane_pkg].fe.start_compute_plane(_StubMaster(), addr)
        client = PKG[client_pkg].fe.PlaneClient(addr, conns=1, timeout=20)
        try:
            for _ in range(3):
                t0 = time.monotonic()
                _check(client.compute_raw(BODY, timeout=20))
                stalled += time.monotonic() - t0 > 2.0
        finally:
            _close_ends(client_pkg, [client], plane)
    assert stalled == 0
