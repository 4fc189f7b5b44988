"""The port's native C++ edge answers as the JAX package's.

misaka_tpu_torch/runtime/frontends.py `NativeFrontendSupervisor` over the
port's copy of native/frontend.cpp (csrc/native/), mirrored from
tests/test_native_edge.py case by case:

- byte parity against the port's own engine server on the same master (the
  reference's oracle): every hot-route answer of the native tier (compute
  shipped over the plane, a 401 or 413 answered from the pushed state, the
  wire's 400s) equals the CPython route table's in status, body and the
  load-bearing headers; the per-request headers (Date, Server,
  Server-Timing, X-Misaka-Trace) are left out;
- one corpus through the JAX package's edge in front of a JAX master and
  through the port's edge in front of a port master, both in this process
  (each library keeps its own engine: the two run side by side), equal in
  status, body and those headers;
- keep-alive after an error, the 413 close, the proxied routes, /healthz,
  the build-failure fault and a restart cycle of the in-process singleton;
- the pushed state equal to misaka_tpu.runtime.edge.native_edge_state's for
  the same key file;
- the app with MISAKA_HTTP_WORKERS=2 puts the edge on the public port and
  the workers behind it; MISAKA_NATIVE_EDGE=0, an armed TLS cert and the
  edge_native_build fault each leave the workers on the public port, with
  one logged line.

The 429 case holds the port edge's clock still, so no bucket refills
between the three requests whatever the machine's load (the reference's
counterpart is load-sensitive).  The masters run engine="scan" on the CPU:
add2 at B=2, the reference's fixture.
"""

import http.client
import json
import os
import shutil
import socket
import ssl
import struct
import subprocess
import sys
import threading
import time
import types

import pytest
import torch

from misaka_tpu import networks as jnet
from misaka_tpu.runtime import edge as jedge
from misaka_tpu.runtime import frontends as jfe
from misaka_tpu.runtime.master import MasterNode as JMaster
from misaka_tpu.runtime.master import make_http_server as j_http
from misaka_tpu.utils import faults as jfaults
from misaka_tpu.utils import slo as jslo
from misaka_tpu.utils import watchdog as jwatchdog
from misaka_tpu_torch import networks as tnet
from misaka_tpu_torch.networks import ADD2_PROGRAMS
from misaka_tpu_torch.runtime import edge
from misaka_tpu_torch.runtime import frontends
from misaka_tpu_torch.runtime.master import MasterNode, make_http_server
from misaka_tpu_torch.utils import faults, metrics, slo, tracespan, watchdog, wire

torch.set_num_threads(1)

CAPS = dict(in_cap=16, out_cap=16, stack_cap=16)

# two burst-capped tenants with the same spec: the 413 and 429 probes send
# each tier its own tenant, so that the process's buckets never mix legs
KEYS = [
    {"key": "adm-secret", "tenant": "ops", "admin": True},
    {"key": "tiny-a-secret", "tenant": "tiny-a", "quota": "vps<4"},
    {"key": "tiny-b-secret", "tenant": "tiny-b", "quota": "vps<4"},
    {"key": "eve-secret", "tenant": "eve", "disabled": True},
]
ADMIN = {"X-Misaka-Key": "adm-secret"}

# compared byte for byte when present on either side
_PARITY_HEADERS = ("content-type", "content-length", "retry-after", "www-authenticate")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # the process-global daemons of both packages' servers would outlive a test
    for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG", "MISAKA_CANARY"):
        monkeypatch.setenv(switch, "0")
    jslo.configure()
    slo.configure()
    jwatchdog.shutdown()
    watchdog.shutdown()
    yield
    edge.reset()
    jedge.reset()
    faults.configure(None)
    jfaults.configure(None)


def _write_keys(path, entries) -> str:
    with open(path, "w") as f:
        json.dump({"keys": entries}, f)
    return str(path)


def _serve(httpd) -> int:
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd.server_address[1]


class Tiers:
    """One master behind both tiers: its engine server (the parity oracle
    and the native tier's proxy target) and the C++ edge speaking the same
    compute plane.  pkg "port" or "jax"."""

    def __init__(self, pkg, tmp_path):
        if pkg == "jax":
            self.master = JMaster(jnet.add2(**CAPS), chunk_steps=32, batch=2, engine="scan")
            http_, fe = j_http, jfe
        else:
            self.master = MasterNode(tnet.add2(**CAPS), chunk_steps=32, batch=2, engine="scan",
                                     device="cpu")
            http_, fe = make_http_server, frontends
        self.master.run()
        self.httpd = http_(self.master, port=0)
        self.engine_port = _serve(self.httpd)
        plane_path = str(tmp_path / f"{pkg}-plane.sock")
        self.plane = fe.start_compute_plane(self.master, plane_path)
        self.sup = fe.NativeFrontendSupervisor(port=0, proxy_port=self.engine_port,
                                               plane_path=plane_path, threads=2, plane_conns=1)
        self.native_port = self.sup.port

    def close(self):
        self.sup.close()
        self.plane.close()
        self.master.pause()
        self.httpd.shutdown()
        self.httpd.server_close()
        close = getattr(self.master, "close", None)
        if close is not None:
            close()


@pytest.fixture
def keyed_env(tmp_path, monkeypatch):
    monkeypatch.setenv("MISAKA_API_KEYS", _write_keys(tmp_path / "keys.json", KEYS))
    monkeypatch.setenv("MISAKA_MAX_BODY", "65536")


@pytest.fixture
def tiers(tmp_path, keyed_env):
    t = Tiers("port", tmp_path)
    try:
        yield t.engine_port, t.native_port
    finally:
        t.close()


def _req(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=15)
    conn.request(method, path, body=body, headers=headers or {})
    r = conn.getresponse()
    data = r.read()
    hdrs = {k.lower(): v for k, v in r.getheaders()}
    conn.close()
    return r.status, hdrs, data


def _same(a, b, what):
    (s1, h1, b1), (s2, h2, b2) = a, b
    assert (s1, b1) == (s2, b2), f"{what}: {s1} {b1!r} != {s2} {b2!r}"
    for h in _PARITY_HEADERS:
        assert h1.get(h) == h2.get(h), f"{what}: header {h}: {h1.get(h)!r} != {h2.get(h)!r}"


def _parity(engine_port, native_port, method, path, body=None, headers=None):
    want = _req(engine_port, method, path, body, headers)
    got = _req(native_port, method, path, body, headers)
    _same(got, want, f"{method} {path}")
    return got


# --- byte parity: answers ----------------------------------------------------------


def test_parity_raw_legacy(tiers):
    s, h, b = _parity(*tiers, "POST", "/compute_raw", struct.pack("<4i", 1, 2, 3, 4), ADMIN)
    assert s == 200
    assert h["content-type"] == "application/octet-stream"
    assert struct.unpack("<4i", b) == (3, 4, 5, 6)


def test_parity_raw_binary_wire(tiers):
    body = wire.pack(struct.pack("<3i", 10, 20, 30))
    s, h, b = _parity(*tiers, "POST", "/compute_raw", body,
                      {**ADMIN, "Content-Type": wire.CONTENT_TYPE, "Accept": wire.CONTENT_TYPE})
    assert s == 200
    assert h["content-type"] == wire.CONTENT_TYPE
    assert struct.unpack("<3i", wire.unpack(b)) == (12, 22, 32)


def test_parity_compute_form(tiers):
    s, _, b = _parity(*tiers, "POST", "/compute", b"value=7", ADMIN)
    assert (s, b) == (200, b'{"value": 9}\n')


def test_parity_batch_mixed_widths(tiers):
    s, h, b = _parity(*tiers, "POST", "/compute_batch", b"values=5,-17,300&spread=1", ADMIN)
    assert s == 200
    assert h["content-type"] == "application/json"
    assert json.loads(b)["values"] == [7, -15, 302]


# --- byte parity: typed rejections ------------------------------------------------


def test_parity_401_missing_key(tiers):
    s, h, b = _parity(*tiers, "POST", "/compute_raw", struct.pack("<2i", 1, 2))
    assert s == 401
    assert b"API key required" in b
    assert h["www-authenticate"].startswith("Bearer")


def test_parity_401_unknown_key(tiers):
    s, _, b = _parity(*tiers, "POST", "/compute_raw", struct.pack("<2i", 1, 2),
                      {"X-Misaka-Key": "who-is-this"})
    assert (s, b) == (401, b"unknown API key")


def test_parity_403_disabled_key(tiers):
    # a disabled key is in the pushed digests: the engine's chain answers
    # its 403, never a local 401
    s, _, b = _parity(*tiers, "POST", "/compute_raw", struct.pack("<2i", 1, 2),
                      {"X-Misaka-Key": "eve-secret"})
    assert (s, b) == (403, b"API key disabled")


def test_parity_413_burst_cap(tiers):
    # 16 values over vps<4's burst of max(1, 4 * 2) = 8: a terminal 413
    # with no Retry-After, rendered by the native tier from the pushed spec
    engine_port, native_port = tiers
    body = struct.pack("<16i", *range(16))
    es, eh, eb = _req(engine_port, "POST", "/compute_raw", body, {"X-Misaka-Key": "tiny-a-secret"})
    ns, nh, nb = _req(native_port, "POST", "/compute_raw", body, {"X-Misaka-Key": "tiny-b-secret"})
    assert (ns, nb.replace(b"tiny-b", b"tiny-a")) == (es, eb)
    assert es == 413 and b"split the request" in eb
    assert "retry-after" not in eh and "retry-after" not in nh


@pytest.fixture
def still_clock(monkeypatch):
    """The port edge's monotonic clock held still: no bucket refills
    between two requests, whatever the machine's load."""
    now = [time.monotonic()]
    fake = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                    if not k.startswith("_")})
    fake.monotonic = lambda: now[0]
    monkeypatch.setattr(edge, "time", fake)
    return now


def test_parity_429_rate_with_retry_after(tiers, still_clock):
    engine_port, native_port = tiers
    body = struct.pack("<4i", 1, 2, 3, 4)  # takes vps<4's bucket whole
    answers = {}
    for port, key in ((engine_port, "tiny-a-secret"), (native_port, "tiny-b-secret")):
        results = [_req(port, "POST", "/compute_raw", body, {"X-Misaka-Key": key})
                   for _ in range(3)]
        statuses = [r[0] for r in results]
        # the clock stands: the first takes the burst of 8, the second the
        # rest, the third finds the bucket empty
        assert statuses == [200, 200, 429], (port, statuses)
        s, h, b = results[2]
        assert b"value rate quota exhausted (4 values/s)" in b
        assert h["retry-after"].isdigit() and int(h["retry-after"]) >= 1
        answers[port] = (s, h, b.replace(b"tiny-b", b"tiny-a"))
    _same(answers[native_port], answers[engine_port], "429")


def test_parity_400_bad_binary_wire(tiers):
    hdr = {**ADMIN, "Content-Type": wire.CONTENT_TYPE}
    good = wire.pack(struct.pack("<3i", 1, 2, 3))
    for body in (b"short", good[:-4], b"\xff" * 12):
        s, _, b = _parity(*tiers, "POST", "/compute_raw", body, hdr)
        assert s == 400 and b.startswith(b"bad binary body: "), (body, b)


def test_parity_400_misaligned_raw(tiers):
    s, _, b = _parity(*tiers, "POST", "/compute_raw", b"\x01\x02\x03", ADMIN)
    assert (s, b) == (400, b"body must be raw int32 values")


def test_parity_404_unknown_program_route(tiers):
    # a program-addressed request rides the plane on the native tier, and
    # the engine's own route renders a longer hint: the typed shape is
    # compared, as in the reference
    engine_port, native_port = tiers
    body = struct.pack("<2i", 1, 2)
    es, _, eb = _req(engine_port, "POST", "/programs/no-such-prog/compute_raw", body, ADMIN)
    ns, _, nb = _req(native_port, "POST", "/programs/no-such-prog/compute_raw", body, ADMIN)
    assert ns == es == 404
    for b in (eb, nb):
        assert b"cannot route to program 'no-such-prog'" in b


# --- the two packages' edges on one corpus ----------------------------------------


def corpus():
    """(label, method, path, body, headers): every typed answer of the
    reference's parity tests that does not depend on a clock."""
    msk = {**ADMIN, "Content-Type": wire.CONTENT_TYPE, "Accept": wire.CONTENT_TYPE}
    good = wire.pack(struct.pack("<3i", 1, 2, 3))
    return [
        ("raw", "POST", "/compute_raw", struct.pack("<4i", 1, 2, 3, -4), ADMIN),
        ("msk1", "POST", "/compute_raw", wire.pack(struct.pack("<3i", 10, 20, 30)), msk),
        ("form", "POST", "/compute", b"value=7", ADMIN),
        ("batch", "POST", "/compute_batch", b"values=5,-17,300&spread=1", ADMIN),
        ("401-missing", "POST", "/compute_raw", struct.pack("<2i", 1, 2), {}),
        ("401-unknown", "POST", "/compute_raw", struct.pack("<2i", 1, 2),
         {"X-Misaka-Key": "who-is-this"}),
        ("403-disabled", "POST", "/compute_raw", struct.pack("<2i", 1, 2),
         {"X-Misaka-Key": "eve-secret"}),
        ("413-burst", "POST", "/compute_raw", struct.pack("<16i", *range(16)),
         {"X-Misaka-Key": "tiny-a-secret"}),
        ("400-short", "POST", "/compute_raw", b"short", msk),
        ("400-truncated", "POST", "/compute_raw", good[:-4], msk),
        ("400-garbage", "POST", "/compute_raw", b"\xff" * 12, msk),
        ("400-misaligned", "POST", "/compute_raw", b"\x01\x02\x03", ADMIN),
        ("404-program", "POST", "/programs/no-such-prog/compute_raw",
         struct.pack("<2i", 1, 2), ADMIN),
        ("401-proxied", "GET", "/status", None, {}),
        ("403-proxied", "POST", "/pause", b"", {"X-Misaka-Key": "tiny-a-secret"}),
    ]


def test_corpus_matches_the_jax_edge(tmp_path, keyed_env):
    """The JAX edge in front of a JAX master and the port's in front of a
    port master, in one process, side by side."""
    stacks = {}
    try:
        stacks["jax"] = Tiers("jax", tmp_path)
        stacks["port"] = Tiers("port", tmp_path)
        assert stacks["jax"].native_port != stacks["port"].native_port
        for label, method, path, body, headers in corpus():
            want = _req(stacks["jax"].native_port, method, path, body, headers)
            got = _req(stacks["port"].native_port, method, path, body, headers)
            _same(got, want, label)
        _same(_oversized(stacks["port"].native_port), _oversized(stacks["jax"].native_port),
              "413-body")
        assert frontends._FRONTEND_LIB._lib._name != jfe._FRONTEND_LIB._lib._name
        # each library's engine counted only its own requests
        n = len(corpus()) + 1
        deadline = time.monotonic() + 10
        while (stacks["port"].sup.state()["requests"] < n
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert stacks["port"].sup.state()["requests"] == n
        assert stacks["jax"].sup.state()["requests"] == n
    finally:
        for s in stacks.values():
            s.close()


# --- keep-alive and the 413 close -------------------------------------------------


def test_keepalive_after_error(tiers):
    _, native_port = tiers
    conn = http.client.HTTPConnection("127.0.0.1", native_port, timeout=15)
    # a 401 whose body was drained keeps the connection
    conn.request("POST", "/compute_raw", body=struct.pack("<2i", 1, 2))
    r = conn.getresponse()
    r.read()
    assert r.status == 401
    conn.request("POST", "/compute_raw", body=struct.pack("<2i", 5, 6), headers=ADMIN)
    r = conn.getresponse()
    out = r.read()
    conn.close()
    assert r.status == 200
    assert struct.unpack("<2i", out) == (7, 8)


def _oversized(port, n=100 * 1024):
    """POST /compute_raw announcing an `n`-byte body and sending none of it:
    (status, headers, body) of the answer, read up to the server's close (a
    server that kept the stream open would time the read out).  A server
    that refuses on Content-Length alone answers at once and closes; sending
    the body too would race the close against unread bytes, whose RST can
    destroy the answer before the client reads it."""
    with socket.create_connection(("127.0.0.1", port), timeout=15) as sock:
        sock.sendall(b"POST /compute_raw HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                     b"X-Misaka-Key: adm-secret\r\n"
                     b"Content-Length: %d\r\n\r\n" % n)
        data = b""
        while chunk := sock.recv(65536):  # until the server closes
            data += chunk
    head, _, body = data.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    hdrs = {k.strip().lower(): v.strip()
            for k, v in (line.split(":", 1) for line in lines[1:])}
    return int(lines[0].split()[1]), hdrs, body


def test_oversized_body_413_closes(tiers):
    engine_port, native_port = tiers  # MISAKA_MAX_BODY=65536 from the fixture
    # an oversized body is never drained: the server answers and closes the
    # stream (EOF, no Connection: close header), as the engine's does
    ns, nh, nb = _oversized(native_port)
    _same((ns, nh, nb), _oversized(engine_port), "413")
    assert ns == 413 and "connection" not in nh
    assert nb == b"body of 102400 bytes exceeds the 65536-byte cap (MISAKA_MAX_BODY)"


# --- the proxy lane and /healthz -------------------------------------------------


def test_proxy_non_hot_routes(tiers):
    engine_port, native_port = tiers
    for path in ("/status", "/metrics", "/debug/requests"):
        es, _, eb = _req(engine_port, "GET", path, headers=ADMIN)
        ns, _, nb = _req(native_port, "GET", path, headers=ADMIN)
        assert ns == es == 200, (path, ns, es)
        if path == "/status":
            assert json.loads(nb).keys() == json.loads(eb).keys()
    es, _, eb = _req(engine_port, "GET", "/status")
    ns, _, nb = _req(native_port, "GET", "/status")
    assert (ns, nb) == (es, eb)
    assert es == 401
    st = json.loads(_req(native_port, "GET", "/status", headers=ADMIN)[2])
    assert st["engine"] == "plain"  # engine="scan": the torch device loop


def test_native_healthz_and_state(tiers):
    _, native_port = tiers
    s, h, b = _req(native_port, "GET", "/healthz")
    assert s == 200
    assert h["server"] == "misaka-native-edge/1"
    assert json.loads(b)


def test_healthz_native_edge_block_and_series(tmp_path):
    """The engine's /healthz carries the edge's counters (the app sets
    `misaka_native_edge`), and the supervisor pumps them into the
    misaka_native_edge_* series, as the reference's does."""
    t = Tiers("port", tmp_path)
    try:
        t.httpd.misaka_native_edge = t.sup
        assert _req(t.native_port, "POST", "/compute", b"value=5")[2] == b'{"value": 7}\n'
        assert _req(t.native_port, "GET", "/status")[0] == 200  # proxied
        deadline = time.monotonic() + 10
        while True:  # the tier counts a request once its answer is out
            ne = json.loads(_req(t.engine_port, "GET", "/healthz")[2])["native_edge"]
            if ne["requests"] == 2 or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert ne["up"] is True and ne["threads"] == 2
        assert ne["requests"] == 2 and ne["plane"] == 1 and ne["proxied"] == 1
        while True:
            text = metrics.render()
            got = metrics.parse_text(text)
            if got.get("misaka_native_edge_plane_frames_total", 0) >= 1:
                break
            assert time.monotonic() < deadline, "the watcher never pumped the series"
            time.sleep(0.1)
        assert got["misaka_native_edge_up"] == 1
        for name in ("requests_total", "proxied_total", "local_rejects_total",
                     "connections_open"):
            assert f"misaka_native_edge_{name}" in got
        assert frontends._native_edge_spans in tracespan._TIER_SOURCES
    finally:
        t.close()
    assert metrics.parse_text(metrics.render())["misaka_native_edge_up"] == 0


# --- the fallback and the singleton ---------------------------------------------


def test_build_failure_chaos_point_raises(tmp_path):
    """An injected build failure raises out of the constructor (the app
    catches it and keeps the CPython workers on the public port)."""
    faults.configure("edge_native_build")
    with pytest.raises(RuntimeError, match="injected fault"):
        frontends.NativeFrontendSupervisor(port=0, proxy_port=1,
                                           plane_path=str(tmp_path / "p.sock"))


def test_supervisor_restart_cycle(tmp_path):
    """close() releases the C++ engine (one per library, by design), so a
    later boot in the same process starts a fresh tier."""
    plane_path = str(tmp_path / "plane.sock")
    ports = set()
    for _ in range(2):
        sup = frontends.NativeFrontendSupervisor(port=0, proxy_port=1, plane_path=plane_path,
                                                 threads=1, plane_conns=1)
        try:
            ports.add(sup.port)
            assert _req(sup.port, "GET", "/healthz")[0] == 200
        finally:
            sup.close()
    assert len(ports) == 2


def test_tcp_plane_only_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no unix plane"):
        frontends.NativeFrontendSupervisor(port=0, proxy_port=1, plane_path="127.0.0.1:9")


# --- the pushed state -------------------------------------------------------------


def test_edge_state_snapshot_shape(tmp_path):
    kf = edge.KeyFile(_write_keys(tmp_path / "k.json", KEYS))
    chain = edge.EdgeChain(keyfile=kf, internal_token="fleet-tok")
    st = edge.native_edge_state(chain)
    assert st["auth_armed"]
    # every key, the disabled one too, and the internal token
    assert len(st["digests"]) == len(KEYS) + 1
    bursts = [d for d in st["digests"].values() if "burst_cap" in d]
    assert len(bursts) == 2  # tiny-a and tiny-b, never the disabled key
    assert all(b["burst_cap"] == 8.0 for b in bursts)
    assert any(d.get("tenant") == "_fleet" for d in st["digests"].values())
    assert "API key required" in st["reject_missing"]


@pytest.mark.parametrize("case", ["keys", "fractional_vps", "quota_off", "tokens", "no_keys"])
def test_edge_state_equals_the_jax_snapshot(tmp_path, case):
    keys = KEYS + [{"key": "frac", "tenant": "frac", "quota": "vps<2.5,rps<3"},
                   {"key": "rps-only", "tenant": "r", "quota": "rps<7"}]
    path = _write_keys(tmp_path / "k.json", keys)
    kw = {"internal_token": "fleet-tok", "burst_s": 1.5}
    if case == "quota_off":
        kw["quota_enabled"] = False
    if case == "tokens":
        kw["token_secret"] = b"s" * 32
    if case == "fractional_vps":
        kw["burst_s"] = 0.3
    snaps = []
    for mod in (jedge, edge):
        kf = None if case == "no_keys" else mod.KeyFile(path)
        snaps.append(mod.native_edge_state(mod.EdgeChain(keyfile=kf, **kw)))
    assert snaps[1] == snaps[0]
    assert snaps[1]["auth_armed"] is (case not in ("tokens", "no_keys"))


# --- the app: which tier takes the public port ----------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APP_ENV = {
    "NODE_INFO": json.dumps({"misaka1": {"type": "program"}, "misaka2": {"type": "program"},
                             "misaka3": {"type": "stack"}}),
    "MISAKA_PROGRAMS": json.dumps(ADD2_PROGRAMS),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _self_signed(directory):
    cert, key = str(directory / "cert.pem"), str(directory / "key.pem")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "ec", "-pkeyopt",
                    "ec_paramgen_curve:prime256v1", "-nodes", "-keyout", key, "-out", cert,
                    "-days", "1", "-subj", "/CN=misaka",
                    "-addext", "subjectAltName=IP:127.0.0.1"], check=True, capture_output=True)
    return cert, key


def _public(port, tls, method, path, body=None):
    if tls:
        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        conn = http.client.HTTPSConnection("127.0.0.1", port, timeout=15, context=ctx)
    else:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=15)
    conn.request(method, path, body=body)
    r = conn.getresponse()
    out = r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    conn.close()
    return out


def _boot_workers(tmp_path, env, tls=False):
    """The app with MISAKA_HTTP_WORKERS=2 on the CPU: (proc, public port,
    log path) once its public port answers a /compute."""
    port = _free_port()
    full = {**{k: v for k, v in os.environ.items() if not k.startswith("MISAKA_")},
            **APP_ENV, **env, "MISAKA_PORT": str(port), "MISAKA_HTTP_WORKERS": "2",
            "MISAKA_AUTORUN": "1", "MISAKA_DEVICE": "cpu", "MISAKA_BATCH": "2",
            "MISAKA_CHUNK_STEPS": "16", "MISAKA_IN_CAP": "8", "MISAKA_OUT_CAP": "8",
            "MISAKA_STACK_CAP": "8", "MISAKA_PIDFILE": "off", "MISAKA_CANARY": "0",
            "MISAKA_SAMPLER": "0", "MISAKA_TSDB": "0", "MISAKA_WATCHDOG": "0",
            "MISAKA_NATIVE_THREADS": "2", "MISAKA_NATIVE_EDGE_THREADS": "2",
            "MISAKA_PLANE_SOCKET": str(tmp_path / "plane.sock"), "OMP_NUM_THREADS": "1",
            "PYTHONPATH": ROOT}
    log_path = tmp_path / "app.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "misaka_tpu_torch.runtime.app"],
                                cwd=ROOT, env=full, stdout=log, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 60
    while True:
        assert proc.poll() is None, log_path.read_text()
        try:
            if _public(port, tls, "POST", "/compute", b"value=5")[2] == b'{"value": 7}\n':
                return proc, port, log_path
        except (OSError, http.client.HTTPException):
            pass
        assert time.monotonic() < deadline, "app not serving within 60 s"
        time.sleep(0.2)


def _stop(proc):
    proc.terminate()
    assert proc.wait(timeout=30) == 0


def _edge_lines(log_path) -> list[str]:
    return [line for line in log_path.read_text().splitlines() if "native edge" in line]


def test_app_puts_the_native_edge_on_the_public_port(tmp_path):
    proc, port, log_path = _boot_workers(tmp_path, {})
    try:
        s, h, b = _public(port, False, "POST", "/compute", b"value=40")
        assert (s, b) == (200, b'{"value": 42}\n') and h["server"] == "misaka-native-edge/1"
        # /healthz on the public port is the engine's, pushed into the edge
        deadline = time.monotonic() + 15
        while True:
            hz = json.loads(_public(port, False, "GET", "/healthz")[2])
            if hz.get("native_edge", {}).get("plane", 0) >= 2 and hz.get("frontends", {}).get(
                    "alive") == 2:
                break
            assert time.monotonic() < deadline, hz
            time.sleep(0.2)
        assert hz["native_edge"]["up"] is True and hz["engine"] == "native"
        # the rest of the surface is proxied through the workers
        st = json.loads(_public(port, False, "GET", "/status")[2])
        assert st["frontends"]["alive"] == 2 and st["running"] is True
        scraped = metrics.parse_text(_public(port, False, "GET", "/metrics")[2].decode())
        assert scraped["misaka_native_edge_up"] == 1
        assert scraped["misaka_plane_frames_total"] >= 2
    finally:
        _stop(proc)
    lines = _edge_lines(log_path)
    assert len(lines) == 2, lines  # the edge's own line and the topology line
    assert any(f"native edge on :{port}" in line for line in lines)


@pytest.mark.parametrize("why", ["kill_switch", "tls", "build_fault"])
def test_app_falls_back_to_the_worker_tier(tmp_path, why):
    env, tls = {}, False
    if why == "kill_switch":
        env["MISAKA_NATIVE_EDGE"] = "0"
        want = "native edge off (MISAKA_NATIVE_EDGE=0)"
    elif why == "tls":
        if shutil.which("openssl") is None:
            pytest.skip("openssl unavailable")
        env["MISAKA_TLS_CERT"], env["MISAKA_TLS_KEY"] = _self_signed(tmp_path)
        tls = True
        want = "native edge off (MISAKA_TLS_CERT"
    else:
        env["MISAKA_FAULTS"] = "edge_native_build"
        want = "native edge unavailable (native edge build failed (injected fault))"
    proc, port, log_path = _boot_workers(tmp_path, env, tls=tls)
    try:
        s, h, b = _public(port, tls, "POST", "/compute", b"value=40")
        assert (s, b) == (200, b'{"value": 42}\n')
        assert h.get("server") != "misaka-native-edge/1"
        hz = json.loads(_public(port, tls, "GET", "/healthz")[2])
        assert "native_edge" not in hz and hz["frontends"]["alive"] == 2
    finally:
        _stop(proc)
    lines = _edge_lines(log_path)
    assert len(lines) == 1 and want in lines[0], lines
    assert "CPython workers take the public port" in lines[0]
