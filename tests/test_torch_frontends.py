"""The port's multi-process serving front answers as the JAX package's.

- The public surface: a JAX stack (master, engine server, compute plane,
  frontend server, in process, as tests/test_serve_batcher.py builds it)
  and the port's twin on the CPU get one seeded request stream on their
  public ports, batched and unbatched; status, Content-Type and body are
  equal (exact: int32 outputs, byte-equal bodies).  /status and /healthz
  are proxied to engines that differ by construction (engine name, build,
  uptime), so those are held by status, Content-Type and their shared keys.
- The frame codec: each package's PlaneClient against the other's
  ComputePlane gives the same outputs for the same seeded frames, plain,
  with MISAKA_PLANE_SECRET (a wrong secret refused on both sides), with
  MISAKA_PLANE_SHM=1, pipelined and over a plaintext TCP address.
- Drain: a draining plane of either package answers the reroute status
  (503 to a single-engine client), and POST /fleet/drain answers alike.
- Traces cross the plane: the frontend's spans reach the engine's trace.
- An engine's 429 with Retry-After comes back with its headers, and the
  worker sheds that tenant's next request itself, as the reference's does.
- The supervisor respawns a killed worker, trips its breaker on a worker
  that exits at once, and reaps every worker at close.
- The app boots the tier from MISAKA_HTTP_WORKERS (1 and 2 workers; a
  killed worker shows `degraded` until it is respawned; terminating the
  engine leaves no worker), and MISAKA_PLANE_SERVE=1 serves a plane with
  no workers.
"""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.parse

import numpy as np
import pytest
import torch

from misaka_tpu import networks as jnet
from misaka_tpu.runtime import frontends as jfe
from misaka_tpu.runtime.master import MasterNode as JMaster
from misaka_tpu.runtime.master import make_http_server as j_http
from misaka_tpu.utils import metrics as jmetrics
from misaka_tpu.utils import slo as jslo
from misaka_tpu.utils import watchdog as jwatchdog
from misaka_tpu.utils import tracespan as jtracespan
from misaka_tpu_torch import networks as tnet
from misaka_tpu_torch.networks import ADD2_PROGRAMS
from misaka_tpu_torch.runtime import frontends as tfe
from misaka_tpu_torch.runtime.master import MasterNode as TMaster
from misaka_tpu_torch.runtime.master import make_http_server as t_http
from misaka_tpu_torch.utils import metrics as tmetrics
from misaka_tpu_torch.utils import slo as tslo
from misaka_tpu_torch.utils import watchdog as twatchdog
from misaka_tpu_torch.utils import tracespan as ttracespan
from misaka_tpu_torch.utils import wire

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPS = dict(in_cap=8, out_cap=8, stack_cap=8)
SEED = 20261017
MAX_BODY = 4096
# /healthz blocks of planes the port has not taken (absent, not faked)
UNPORTED_BLOCKS = {"canary"}
FE = {"jax": jfe, "port": tfe}
METRICS = {"jax": jmetrics, "port": tmetrics}
ADD2_ENV = {
    "NODE_INFO": json.dumps({"misaka1": {"type": "program"}, "misaka2": {"type": "program"},
                             "misaka3": {"type": "stack"}}),
    "MISAKA_PROGRAMS": json.dumps(ADD2_PROGRAMS),
}


@pytest.fixture(autouse=True)
def _quiet_jax_daemons(monkeypatch):
    # the JAX server's process-global daemons would outlive a test
    for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG", "MISAKA_CANARY"):
        monkeypatch.setenv(switch, "0")
    # both SLO engines disarmed, whatever an earlier test in this process
    # armed: a /healthz `slo` block then means the same in both; so are
    # both watchdogs (a `watchdog` block)
    jslo.configure()
    tslo.configure()
    jwatchdog.shutdown()
    twatchdog.shutdown()


def _serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd.server_address[1]


def _master(pkg, batch):
    if pkg == "jax":
        return JMaster(jnet.add2(**CAPS), chunk_steps=8, batch=batch, engine="scan")
    return TMaster(tnet.add2(**CAPS), chunk_steps=8, batch=batch, device="cpu")


def _close_plane_client(fe_httpd):
    """The PlaneClient behind a frontend server: the port's hangs on the
    server; the reference's sits in its handler's closure."""
    client = getattr(fe_httpd, "misaka_plane_client", None)
    if client is None:
        for cell in fe_httpd.RequestHandlerClass._do_post.__closure__ or ():
            if isinstance(cell.cell_contents, jfe.PlaneClient):
                client = cell.cell_contents
    client.close()


def wrap_add2(vals) -> np.ndarray:
    return (np.asarray(vals, np.int64) + 2).astype(np.int32)  # int32 wrap


class Stack:
    """One package's serving tier in process: master, engine server,
    compute plane and one frontend server on a free public port."""

    def __init__(self, pkg, batch, tmp_path):
        self.pkg = pkg
        self.master = _master(pkg, batch)
        self.engine = (j_http if pkg == "jax" else t_http)(self.master, port=0)
        self.engine_port = _serve(self.engine)
        path = str(tmp_path / f"{pkg}.sock")
        self.plane = FE[pkg].start_compute_plane(self.master, path)
        self.engine.misaka_plane = self.plane
        self.fe = FE[pkg].make_frontend_server(
            0, f"http://127.0.0.1:{self.engine_port}", path, plane_conns=2, max_body=MAX_BODY)
        self.port = _serve(self.fe)

    def close(self):
        self.fe.shutdown()
        self.fe.server_close()
        _close_plane_client(self.fe)
        self.plane.close()
        self.engine.shutdown()
        self.engine.server_close()
        self.master.close()


def request(port, method, path, body=None, headers=None):
    """(status, Content-Type, body) of one request on a fresh connection.
    body=None sends no Content-Length at all."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.putrequest(method, path)
        for k, v in (headers or {}).items():
            conn.putheader(k, v)
        if body is not None:
            conn.putheader("Content-Length", str(len(body)))
        conn.endheaders()
        if body:
            conn.send(body)
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def form(**fields) -> bytes:
    return urllib.parse.urlencode(fields).encode()


def i32(arr) -> bytes:
    return np.asarray(arr, dtype="<i4").tobytes()


def stream(seed):
    """The seeded request stream: (method, path, body, headers)."""
    rng = np.random.default_rng(seed)
    one = rng.integers(-1000, 1000, size=6)
    raw = rng.integers(-2**31, 2**31, size=37, dtype=np.int64).astype(np.int32)
    raw[:2] = (2**31 - 1, -2**31)
    binary = rng.integers(-10**6, 10**6, size=50).astype(np.int32)
    pinned = rng.integers(-100, 100, size=9).astype(np.int32)
    batch = rng.integers(-500, 500, size=11)
    binh = {"Content-Type": wire.CONTENT_TYPE, "Accept": wire.CONTENT_TYPE}
    return [
        ("POST", "/compute", form(value=int(one[0])), None),      # not running: 400
        ("POST", "/run", b"", None),
        *[("POST", "/compute", form(value=int(v)), None) for v in one[1:5]],
        ("POST", "/compute_raw", i32(raw), None),                 # legacy raw, striped
        ("POST", "/compute_raw?spread=1", wire.pack(i32(binary)), binh),
        ("POST", "/compute_raw?spread=0", i32(pinned), None),     # proxied
        ("POST", "/compute_batch", form(values=",".join(map(str, batch)), spread="1"), None),
        ("POST", "/compute_batch", form(values=",".join(map(str, batch[:4]))), None),
        ("POST", "/compute_raw", None, None),                     # no length: 411
        ("POST", "/compute_raw", b"\0" * (MAX_BODY + 4), None),   # over the cap: 413
        ("POST", "/compute_raw", b"\0" * 6, None),                # not int32s: 400
        ("POST", "/compute_raw", b"MSK1" + b"\0" * 12, binh),     # bad framing: 400
        ("POST", "/compute", form(value="abc"), None),            # 400
        ("POST", "/pause", None, None),                           # body-less, proxied
        ("POST", "/compute", form(value=int(one[5])), None),      # paused: 400
        ("POST", "/compute_raw", i32(raw[:3]), None),             # paused: 400
        ("POST", "/run", b"", None),
        ("POST", "/compute", form(value=int(one[5])), None),
        ("POST", "/nosuch", b"", None),                           # proxied 404
        ("GET", "/status", None, None),
        ("GET", "/healthz", None, None),
    ]


@pytest.mark.parametrize("batch", [4, None], ids=["batched", "unbatched"])
def test_public_surface_matches_the_jax_stack(tmp_path, batch):
    stacks = {pkg: Stack(pkg, batch, tmp_path) for pkg in ("jax", "port")}
    try:
        for method, path, body, headers in stream(SEED):
            want = request(stacks["jax"].port, method, path, body, headers)
            got = request(stacks["port"].port, method, path, body, headers)
            assert got[:2] == want[:2], (path, got, want)
            if path == "/status":
                assert json.loads(got[2])["running"] is json.loads(want[2])["running"] is True
            elif path == "/healthz":
                g, w = json.loads(got[2]), json.loads(want[2])
                # no supervisor here: the JAX server's `degraded` can only
                # come from its SLO or watchdog plane, process-global state
                # an earlier test in this process may have armed
                raised = {"degraded"} if {"slo", "watchdog"} & set(w) else set()
                assert set(g) == set(w) - UNPORTED_BLOCKS - raised
                assert (g["ok"], g["running"], g["wire_binary"]) == (True, True, True)
                assert g["edge"] == w["edge"]  # the default env arms quota and admission
            else:
                assert got[2] == want[2], (path, got, want)
        # the answers are add2's, not just equal
        code, _, body = request(stacks["port"].port, "POST", "/compute_raw", i32([5, -7]))
        assert code == 200 and np.frombuffer(body, "<i4").tolist() == [7, -5]
    finally:
        for s in stacks.values():
            s.close()


# --- the frame codec across packages ----------------------------------------------


@pytest.fixture(scope="module")
def masters():
    ms = {pkg: _master(pkg, 4) for pkg in ("jax", "port")}
    for m in ms.values():
        m.run()
    yield ms
    for m in ms.values():
        m.close()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _frames(seed, n=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(-2**31, 2**31, size=int(rng.integers(1, 40)),
                         dtype=np.int64).astype(np.int32) for _ in range(n)]


def _compute_all(client, frames):
    """Every frame from its own thread (they coalesce and pipeline)."""
    outs = [None] * len(frames)

    def one(i):
        outs[i] = client.compute_raw(i32(frames[i]), timeout=30)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(frames))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return [np.frombuffer(o, "<i4") for o in outs]


MODES = {"plain": {}, "secret": {"MISAKA_PLANE_SECRET": "s3cret"},
         "shm": {"MISAKA_PLANE_SHM": "1"}, "pipelined": {"MISAKA_PLANE_PIPELINE": "4"},
         "tcp": {}}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("client_pkg,plane_pkg", [("port", "jax"), ("jax", "port")],
                         ids=["port_client-jax_plane", "jax_client-port_plane"])
def test_frames_cross_between_packages(masters, tmp_path, monkeypatch, mode, client_pkg,
                                       plane_pkg):
    for k, v in MODES[mode].items():
        monkeypatch.setenv(k, v)
    path = f"127.0.0.1:{_free_port()}" if mode == "tcp" else str(tmp_path / "plane.sock")
    # the plane-side series each mode must move
    series = {"shm": "misaka_plane_shm_frames_total",
              "pipelined": "misaka_plane_pipeline_depth_count"}.get(mode)
    mod = METRICS[plane_pkg]

    def read():
        return mod.parse_text(mod.render()).get(series, 0.0)

    before = read() if series else None
    plane = FE[plane_pkg].start_compute_plane(masters[plane_pkg], path)
    client = FE[client_pkg].PlaneClient(path, conns=2)
    try:
        frames = _frames(SEED)
        for got, vals in zip(_compute_all(client, frames), frames):
            np.testing.assert_array_equal(got, wrap_add2(vals))
        if series:
            assert read() > before, series
        if mode == "secret":
            monkeypatch.setenv("MISAKA_PLANE_SECRET", "wrong")
            bad = FE[client_pkg].PlaneClient(path, conns=1)
            try:
                with pytest.raises(FE[client_pkg].PlaneError) as e:
                    bad.compute_raw(i32([1]), timeout=20)
                assert e.value.status == 502  # the plane closed the connection
            finally:
                bad.close()
    finally:
        client.close()
        plane.close()


@pytest.mark.parametrize("plane_pkg", ["jax", "port"])
def test_draining_plane_answers_the_reroute_status(masters, tmp_path, plane_pkg):
    path = str(tmp_path / "plane.sock")
    plane = FE[plane_pkg].start_compute_plane(masters[plane_pkg], path)
    clients = {pkg: FE[pkg].PlaneClient(path, conns=1) for pkg in FE}
    try:
        plane.set_draining(True)
        assert plane.draining
        for pkg, client in clients.items():
            with pytest.raises(FE[pkg].PlaneError) as e:
                client.compute_raw(i32([3]), timeout=20)
            assert (e.value.status, e.value.body) == (503, b"replica draining; reroute")
        # the plane releases a frame's in-flight count after it has
        # replied: the client can see the answer first (poll, bounded)
        deadline = time.monotonic() + 10
        while plane.inflight() != 0:
            assert time.monotonic() < deadline, f"{plane.inflight()} frames still in flight"
            time.sleep(0.01)
        plane.set_draining(False)
        for client in clients.values():
            assert np.frombuffer(client.compute_raw(i32([3]), timeout=20), "<i4").tolist() == [5]
    finally:
        for client in clients.values():
            client.close()
        plane.close()


def _settle_http_inflight(timeout=10.0):
    """Wait (bounded) until no HTTP request of any server in this process
    is in flight: the route reports the process-wide gauge less itself,
    and an earlier test's late request (a proxied one a closed worker left
    behind) would read as this server's."""
    from misaka_tpu.runtime.master import M_HTTP_INFLIGHT as j_inflight
    from misaka_tpu_torch.runtime.master import M_HTTP_INFLIGHT as t_inflight

    deadline = time.monotonic() + timeout
    while (j_inflight.value or t_inflight.value) and time.monotonic() < deadline:
        time.sleep(0.05)


def test_fleet_drain_route_answers_like_the_reference(masters, tmp_path):
    _settle_http_inflight()
    answers = {}
    for pkg in ("jax", "port"):
        httpd = (j_http if pkg == "jax" else t_http)(masters[pkg], port=0)
        port = _serve(httpd)
        plane = None
        try:
            got = [request(port, "POST", "/fleet/drain", b"")]  # no plane: 404
            plane = FE[pkg].start_compute_plane(masters[pkg], str(tmp_path / f"{pkg}.sock"))
            httpd.misaka_plane = plane
            got.append(request(port, "POST", "/fleet/drain", b""))
            assert plane.draining
            got.append(request(port, "POST", "/fleet/drain", form(state="off")))
            assert not plane.draining
            answers[pkg] = got
        finally:
            httpd.shutdown()
            httpd.server_close()
            if plane is not None:
                plane.close()
    assert answers["port"] == answers["jax"]
    assert answers["port"][0][0] == 404
    assert json.loads(answers["port"][1][2]) == {"draining": True, "inflight": 0,
                                                  "http_inflight": 0}


def test_a_frame_for_a_registry_program_answers_404_like_the_reference(masters, tmp_path):
    outs = {}
    for pkg in ("jax", "port"):
        path = str(tmp_path / f"{pkg}.sock")
        plane = FE[pkg].start_compute_plane(masters[pkg], path)
        client = tfe.PlaneClient(path, conns=1)
        try:
            with pytest.raises(tfe.PlaneError) as e:
                client.compute_raw(i32([1]), timeout=20, program="other")
            outs[pkg] = (e.value.status, e.value.body)
        finally:
            client.close()
            plane.close()
    assert outs["port"] == outs["jax"] and outs["port"][0] == 404


def test_traces_cross_the_plane(tmp_path):
    stacks = {pkg: Stack(pkg, 4, tmp_path) for pkg in ("jax", "port")}
    want = {"http.parse", "frontend.coalesce", "plane.recv", "serve.queue", "serve.pass"}
    # the worker's own span: http.parse and frontend.coalesce also ride the
    # frame into the engine's half, so only plane.ship marks the worker's
    worker_half = "plane.ship"
    spans = {}
    try:
        for pkg, mod in (("jax", jtracespan), ("port", ttracespan)):
            s = stacks[pkg]
            s.master.run()
            tid = f"fe000111fe00{pkg[:1]}{pkg[:1]}11"
            vals = np.arange(32, dtype=np.int32)
            conn = http.client.HTTPConnection("127.0.0.1", s.port, timeout=30)
            conn.request("POST", "/compute_raw?spread=1", i32(vals), {"X-Misaka-Trace": tid})
            r = conn.getresponse()
            assert r.status == 200 and r.getheader("X-Misaka-Trace") == tid
            np.testing.assert_array_equal(np.frombuffer(r.read(), "<i4"), vals + 2)
            conn.close()
            # both halves land after the response, each in its own order:
            # the plane ends the engine's half after it replies, the
            # worker ends its half after it has written to the client.
            # Poll (bounded) for the merge of both halves.
            deadline = time.monotonic() + 10
            while True:
                tr = mod.RECORDER.get(tid)
                names = {sp.name for sp in tr.spans} if tr is not None else set()
                tiers = {mod.tier_of(n) for n in names}
                if ({"frontend", "plane", "serve"} <= tiers and want <= names
                        and worker_half in names):
                    break
                assert time.monotonic() < deadline, f"{pkg}: {tid} has only {sorted(names)}"
                time.sleep(0.02)
            spans[pkg] = names
    finally:
        for s in stacks.values():
            s.close()
    assert want <= spans["port"]
    assert spans["port"] == spans["jax"]


class RejectingPlane:
    """A plane that answers every compute frame 429 with an edge body (the
    reference's EdgeReject wire form), counting the frames it saw."""

    def __init__(self, path):
        from misaka_tpu.runtime.edge import EdgeReject

        self.body = EdgeReject(429, "rate", "tenant over quota", retry_after=2.0,
                               tenant="t1").to_wire()
        self.frames = 0
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.bind(path)
        self.sock.listen(8)
        self.conns = []
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self.conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn):
        try:
            while True:
                n, n_meta = tfe._REQ_HDR.unpack(tfe._recv_exact(conn, 8))
                tfe._recv_exact(conn, n * 4 + n_meta)
                self.frames += 1
                conn.sendall(tfe._RESP_HDR.pack(429, len(self.body)) + self.body)
        except OSError:
            conn.close()

    def close(self):
        self.sock.shutdown(socket.SHUT_RDWR)
        self.sock.close()
        for c in self.conns:
            c.close()


def test_engine_shed_is_honoured_at_the_worker_like_the_reference(tmp_path):
    """A 429 with Retry-After from the engine's edge comes back with its
    headers, and the tenant's next request sheds at the worker without a
    plane round trip; another tenant still reaches the plane."""
    answers = {}
    for pkg in ("jax", "port"):
        plane = RejectingPlane(str(tmp_path / f"{pkg}.sock"))
        fe = FE[pkg].make_frontend_server(0, "http://127.0.0.1:9", str(tmp_path / f"{pkg}.sock"),
                                          plane_conns=1)
        port = _serve(fe)
        try:
            got = []
            for key in ("k1", "k1", "k2"):
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
                conn.request("POST", "/compute", b"value=1", {"X-Misaka-Key": key})
                r = conn.getresponse()
                got.append((r.status, r.getheader("Retry-After"), r.read(), plane.frames))
                conn.close()
            answers[pkg] = got
        finally:
            fe.shutdown()
            fe.server_close()
            _close_plane_client(fe)
            plane.close()
    assert answers["port"] == answers["jax"]
    assert [a[3] for a in answers["port"]] == [1, 1, 2]  # the second never left the worker
    assert answers["port"][0][:3] == (429, "2", b"tenant over quota")


# --- the supervisor and the app ----------------------------------------------------


def _wait(cond, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


def _gone(pid) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_supervisor_respawns_breaks_and_reaps():
    sleeper = [sys.executable, "-c", "import time; time.sleep(60)"]
    sup = tfe.FrontendSupervisor(2, 0, "", "", cmd=sleeper, poll_s=0.05, backoff_base=0.05,
                                 backoff_cap=0.1)
    try:
        first = sup.pids()
        assert len(first) == 2
        assert sup.state() == {"configured": 2, "alive": 2, "restarts_total": 0,
                               "breaker_open": 0, "degraded": False}
        os.kill(first[0], signal.SIGKILL)
        _wait(lambda: sup.state()["restarts_total"] == 1 and sup.alive() == 2,
              "the killed worker was not respawned")
        now = sup.pids()
        assert first[0] not in now and first[1] in now
    finally:
        sup.close()
    assert all(_gone(p) for p in now)  # reaped, not zombies
    crasher = [sys.executable, "-c", "raise SystemExit(3)"]
    sup = tfe.FrontendSupervisor(1, 0, "", "", cmd=crasher, poll_s=0.05, backoff_base=0.05,
                                 backoff_cap=0.1, breaker_threshold=2)
    try:
        _wait(lambda: sup.state()["breaker_open"] == 1, "the breaker did not open")
        st = sup.state()
        assert st["degraded"] and st["alive"] == 0
    finally:
        sup.close()


def _boot(tmp_path, env, label, ready_path="/status"):
    port = _free_port()
    full = {**{k: v for k, v in os.environ.items() if not k.startswith("MISAKA_")},
            **ADD2_ENV, **env, "MISAKA_PORT": str(port), "MISAKA_AUTORUN": "1",
            "MISAKA_DEVICE": "cpu", "MISAKA_CHUNK_STEPS": "8", "MISAKA_IN_CAP": "8",
            "MISAKA_OUT_CAP": "8", "MISAKA_STACK_CAP": "8", "MISAKA_PIDFILE": "off",
            "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    log = open(tmp_path / f"{label}.log", "w")
    proc = subprocess.Popen([sys.executable, "-m", "misaka_tpu_torch.runtime.app"], cwd=ROOT,
                            env=full, stdout=log, stderr=subprocess.STDOUT)
    log.close()
    deadline = time.monotonic() + 60
    while True:
        assert proc.poll() is None, (tmp_path / f"{label}.log").read_text()
        try:
            code, _, body = request(port, "GET", ready_path)
            if code == 200 and json.loads(body)["running"]:
                return proc, port
        except (OSError, ValueError, http.client.HTTPException):
            pass
        assert time.monotonic() < deadline, f"{label}: app not serving within 60 s"
        time.sleep(0.2)


def _workers_of(pid) -> list[int]:
    out = subprocess.run(["ps", "-o", "pid=,args=", "--ppid", str(pid)], capture_output=True,
                         text=True, timeout=10).stdout
    return [int(line.split(None, 1)[0]) for line in out.splitlines()
            if "misaka_tpu_torch.runtime.frontends" in line]


def _get_json(port, path):
    """GET on the public port, riding out a connection the kernel handed
    to a worker that just died."""
    for _ in range(20):
        try:
            code, _, body = request(port, "GET", path)
            return json.loads(body)
        except (OSError, http.client.HTTPException):
            time.sleep(0.05)
    raise AssertionError(f"GET {path} never answered")


@pytest.mark.parametrize("workers", [1, 2])
def test_app_serves_through_supervised_workers(tmp_path, workers):
    """One worker also rides the shared-memory plane, across processes: the
    payload goes through the segment, and no segment is left behind."""
    env = {"MISAKA_HTTP_WORKERS": str(workers), "MISAKA_BATCH": "4",
           "MISAKA_PLANE_SOCKET": str(tmp_path / "plane.sock"),
           "MISAKA_NATIVE_EDGE": "0"}  # the worker tier on the public port
    if workers == 1:
        env["MISAKA_PLANE_SHM"] = "1"
    proc, port = _boot(tmp_path, env, f"workers{workers}")
    try:
        assert tfe.wait_ready(port, timeout=10)
        pids = _workers_of(proc.pid)
        assert len(pids) == workers
        code, ctype, body = request(port, "POST", "/compute", b"value=5")
        assert (code, ctype, body) == (200, "application/json", b'{"value": 7}\n')
        st = _get_json(port, "/status")
        assert st["frontends"] == {"configured": workers, "alive": workers, "restarts_total": 0,
                                   "breaker_open": 0, "degraded": False}
        hz = _get_json(port, "/healthz")
        assert hz["frontends"] == st["frontends"] and hz["degraded"] is False
        metrics = request(port, "GET", "/metrics")[2].decode()
        assert "misaka_plane_frames_total 1" in metrics
        assert f"misaka_plane_shm_frames_total {2 - workers}" in metrics
        if workers == 2:
            os.kill(pids[0], signal.SIGKILL)
            seen_degraded = []

            def respawned():
                hz = _get_json(port, "/healthz")
                seen_degraded.append(hz["degraded"])
                return hz["frontends"]["restarts_total"] == 1 and hz["frontends"]["alive"] == 2
            _wait(respawned, "the killed worker was not respawned")
            assert True in seen_degraded and seen_degraded[-1] is False
            pids = _workers_of(proc.pid)
            assert len(pids) == 2
            assert request(port, "POST", "/compute", b"value=-9")[2] == b'{"value": -7}\n'
    finally:
        proc.terminate()
        rc = proc.wait(timeout=30)
    assert rc == 0
    _wait(lambda: all(_gone(p) for p in pids), "a worker outlived its engine", timeout=5)
    assert "leaked" not in (tmp_path / f"workers{workers}.log").read_text()


def test_plane_serve_without_workers(tmp_path):
    path = str(tmp_path / "plane.sock")
    proc, port = _boot(tmp_path, {"MISAKA_PLANE_SERVE": "1", "MISAKA_BATCH": "4",
                                  "MISAKA_PLANE_SOCKET": path}, "plane_serve")
    client = tfe.PlaneClient(path, conns=1)
    try:
        out = client.compute_raw(i32([1, 2, 40]), timeout=30)
        assert np.frombuffer(out, "<i4").tolist() == [3, 4, 42]
        assert "frontends" not in _get_json(port, "/status")
        code, _, body = request(port, "POST", "/fleet/drain", b"")
        assert code == 200 and json.loads(body)["draining"] is True
    finally:
        client.close()
        proc.terminate()
        proc.wait(timeout=30)
    assert not os.path.exists(path)
