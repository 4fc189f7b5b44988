"""The port's app reads the reference's boot env, or refuses it at boot.

One test per open fault of ROADMAP C, each failing before the fix:

- C.1 MISAKA_TOPOLOGY builds the same network in both packages (a compose
  .yml exits with status 2, naming ROADMAP A.10);
- C.2 MISAKA_MODE=distributed and NODE_TYPE=program|stack boot the
  per-process nodes (tests/test_torch_nodes.py); where grpcio or protobuf
  does not import, they exit naming the missing package (and A.5), never
  falling back to the fused engine, while a fused boot passes;
- C.3 MISAKA_TLS_CERT/KEY: a plaintext request gets no response from
  either server, and over HTTPS both answer the same /compute;
- C.4 an API keyfile arms auth as the JAX app's does (401 without a key,
  served with one, 403 off its scope; behind 0 and 1 frontend workers),
  and so does <MISAKA_PROGRAMS_DIR>/api_keys.json, with the registry
  seeding the boot network as the pinned default program; MISAKA_QUOTA
  with a `cpu` field boots and sheds, past its budget, with the JAX app's
  typed 429 (the stage reads the usage ledger);
- C.5 MISAKA_AUTOCKPT: auto snapshots written by either package's
  AutoCheckpointer restore in the other, a torn newest snapshot falls back
  to the one before, the interval snapshots rotate to `keep`, and a
  restarted app resumes its state;

and the same class at lower stakes: MISAKA_COORDINATOR joins a process
group of one and the app serves what the JAX app serves (`auto` and a mesh
across a group's processes refuse, A.7b), MISAKA_PROGRAMS_DIR boots and seeds the default program with the JAX
app's version ID, and MISAKA_FLEET, a MISAKA_PLANE_TLS_* triple (a partial
one fails loud) and a comma-separated MISAKA_PLANE_SOCKET pass the boot
checks (the fleet itself: tests/test_torch_fleet.py); MISAKA_FAULTS and
MISAKA_SLO arm their planes at boot.
F.6: MISAKA_TSDB_DIR (the durable telemetry tier) was dropped in silence;
it now arms the TSDB's, the usage ledger's and the capture spools, and
MISAKA_WATCHDOG's rules arm the watchdog, as in the JAX app.
(MISAKA_HTTP_WORKERS is served: tests/test_torch_frontends.py.)
"""

import http.client
import json
import logging
import os
import shutil
import socket
import ssl
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from misaka_tpu.runtime import app as japp
from misaka_tpu.runtime import edge as JEdge
from misaka_tpu.runtime.master import AutoCheckpointer as JAuto
from misaka_tpu.runtime.master import MasterNode as JMaster
from misaka_tpu.runtime.master import make_http_server as j_http
from misaka_tpu.runtime.registry import ProgramRegistry as JRegistry
from misaka_tpu.runtime.topology import Topology as JTopology
from misaka_tpu_torch.core.state import state_to_numpy
from misaka_tpu_torch.networks import ADD2_PROGRAMS
from misaka_tpu_torch.runtime import app
from misaka_tpu_torch.runtime import master as tmaster
from misaka_tpu_torch.runtime.master import AutoCheckpointer, MasterNode, make_http_server
from misaka_tpu_torch.runtime.topology import Topology

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNING_TOTAL = os.path.join(ROOT, "examples", "running_total.json")
CAPS = dict(in_cap=8, out_cap=8, stack_cap=8)
ADD2_ENV = {
    "NODE_INFO": json.dumps({"misaka1": {"type": "program"}, "misaka2": {"type": "program"},
                             "misaka3": {"type": "stack"}}),
    "MISAKA_PROGRAMS": json.dumps(ADD2_PROGRAMS),
    "MISAKA_DEVICE": "cpu",
}


@pytest.fixture(autouse=True)
def _quiet_jax_daemons(monkeypatch):
    # the JAX server's process-global daemons would outlive a test
    for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG"):
        monkeypatch.setenv(switch, "0")


def _serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd.server_address[1]


def _close(*pairs):
    for httpd, master in pairs:
        httpd.shutdown()
        httpd.server_close()
        master.close()


# --- C.1 MISAKA_TOPOLOGY ------------------------------------------------------------


def test_c1_topology_file_builds_the_same_network_as_jax():
    env = {"MISAKA_TOPOLOGY": RUNNING_TOTAL}
    t, j = app.build_topology_from_env(env), japp.build_topology_from_env(env)
    assert t.node_info == j.node_info and t.programs == j.programs
    assert (t.stack_cap, t.in_cap, t.out_cap) == (j.stack_cap, j.in_cap, j.out_cap)
    assert t.in_cap == 1024 and "totaler" in t.node_info
    # the cap knobs apply to the file's topology too, in both packages
    env["MISAKA_IN_CAP"] = "16"
    assert app.build_topology_from_env(env).in_cap == japp.build_topology_from_env(env).in_cap == 16
    m = app.build_master_from_env({"MISAKA_TOPOLOGY": RUNNING_TOTAL, "MISAKA_DEVICE": "cpu",
                                   "MISAKA_BATCH": "2", "MISAKA_CHUNK_STEPS": "32"})
    try:
        m.run()
        assert m.compute_many([1, 2, 3]) == [1, 3, 6]
    finally:
        m.close()


def test_c1_compose_yml_exits_2_naming_a10(capsys, monkeypatch):
    """A compose .yml (ROADMAP A.10) boots the network the JAX app boots
    from it; on a host without PyYAML (hidden here) the app exits 2."""
    env = {"MISAKA_TOPOLOGY": "deploy/docker-compose.yml"}
    got, want = app.build_topology_from_env(env), japp.build_topology_from_env(env)
    assert (got.node_info, got.programs) == (want.node_info, want.programs)
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(SystemExit, match="PyYAML") as exc:
        app.build_topology_from_env(env)
    assert exc.value.code == 2
    assert "PyYAML" in capsys.readouterr().err


def test_c1_neither_variable_names_both():
    with pytest.raises(SystemExit, match="NODE_INFO .* or MISAKA_TOPOLOGY"):
        app.build_topology_from_env({})
    with pytest.raises(SystemExit, match="NODE_INFO .* or MISAKA_TOPOLOGY"):
        japp.build_topology_from_env({})


# --- C.2 the distributed mode and the node servers -------------------------------------


@pytest.mark.parametrize("extra", [
    {"MISAKA_MODE": "distributed"},
    {"NODE_TYPE": "program"},
    {"NODE_TYPE": "stack"},
], ids=["distributed", "program", "stack"])
def test_c2_distributed_and_node_servers_refuse_naming_a5(extra, monkeypatch):
    """With grpc hidden, each per-process boot exits (status 2) naming the
    missing package and A.5; the fused boot's checks pass without it."""
    env = {**ADD2_ENV, **extra}
    env.pop("MISAKA_PROGRAMS")  # the distributed master's programs live in its peers
    monkeypatch.setitem(sys.modules, "grpc", None)
    with pytest.raises(SystemExit, match=r"needs the grpcio package .*lacks") as exc:
        app.build_master_from_env(env)
    assert exc.value.code == 2 and "ROADMAP A.5" in str(exc.value)
    app.check_env({**ADD2_ENV, "MISAKA_DEVICE": "cpu"})  # the fused boot


def test_c2_missing_protobuf_names_protobuf(monkeypatch):
    monkeypatch.setitem(sys.modules, "google.protobuf", None)
    with pytest.raises(SystemExit, match=r"needs the protobuf package") as exc:
        app.check_env({"NODE_TYPE": "program"})
    assert exc.value.code == 2


HIDDEN_GRPC_BOOT = r"""
import runpy, sys
sys.modules["grpc"] = None
sys.path.insert(0, sys.argv[1])
runpy.run_module("misaka_tpu_torch.runtime.app", run_name="__main__")
"""


@pytest.mark.parametrize("extra", [{"NODE_TYPE": "program", "PROGRAM": "IN ACC\nOUT ACC"},
                                   {"MISAKA_MODE": "distributed"}],
                         ids=["program", "distributed"])
def test_c2_boot_without_grpc_exits_naming_the_package(extra):
    """`python -m misaka_tpu_torch.runtime.app` in a process where grpc does
    not import: the per-process boot exits 2, its stderr naming grpcio and
    A.5, and serves nothing (no fallback to the fused engine)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("MISAKA_", "NODE_"))}
    env.update(ADD2_ENV, MISAKA_DEVICE="cpu", MISAKA_PORT="0", MISAKA_GRPC_PORT="0",
               MISAKA_ORPHAN_OK="1", **extra)
    out = subprocess.run([sys.executable, "-c", HIDDEN_GRPC_BOOT, ROOT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2, out.stdout + out.stderr
    assert "needs the grpcio package" in out.stderr and "ROADMAP A.5" in out.stderr
    assert "serving on" not in out.stdout + out.stderr


# --- C.3 TLS ----------------------------------------------------------------------------


def _make_certs(tmp_path):
    if shutil.which("openssl") is None:
        pytest.skip("openssl unavailable")
    cert, key = str(tmp_path / "cert.pem"), str(tmp_path / "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "ec", "-pkeyopt",
         "ec_paramgen_curve:prime256v1", "-nodes", "-keyout", key, "-out", cert,
         "-days", "1", "-subj", "/CN=localhost",
         "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
        check=True, capture_output=True, timeout=60,
    )
    return cert, key


def _plaintext_status(port) -> str:
    """A plaintext GET /status: "no response" when the server answers
    nothing over plain HTTP, else the status it answered."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", "/status")
        return str(conn.getresponse().status)
    except (http.client.HTTPException, OSError):
        return "no response"
    finally:
        conn.close()


def _https_compute(port, cert, value):
    ctx = ssl.create_default_context(cafile=cert)
    req = urllib.request.Request(f"https://127.0.0.1:{port}/compute",
                                 data=urllib.parse.urlencode({"value": value}).encode())
    with urllib.request.urlopen(req, timeout=30, context=ctx) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_c3_tls_plaintext_gets_no_response_https_answers_like_jax(tmp_path, monkeypatch):
    cert, key = _make_certs(tmp_path)
    monkeypatch.setenv("MISAKA_TLS_CERT", cert)
    monkeypatch.setenv("MISAKA_TLS_KEY", key)
    jm = JMaster(JTopology.from_node_info_json(ADD2_ENV["NODE_INFO"], ADD2_PROGRAMS, **CAPS),
                 chunk_steps=8, batch=2, engine="scan")
    tm = app.build_master_from_env({**ADD2_ENV, "MISAKA_BATCH": "2",
                                    "MISAKA_CHUNK_STEPS": "8", "MISAKA_IN_CAP": "8",
                                    "MISAKA_OUT_CAP": "8", "MISAKA_STACK_CAP": "8"})
    jh, th = j_http(jm, port=0), make_http_server(tm, port=0)
    jp, tp = _serve(jh), _serve(th)
    try:
        assert getattr(th, "misaka_tls", False)
        assert _plaintext_status(tp) == _plaintext_status(jp) == "no response"
        jm.run()
        tm.run()
        for v in (5, -3, 1000):
            got, want = _https_compute(tp, cert, v), _https_compute(jp, cert, v)
            assert got == want and got[0] == 200
        # the server keeps serving after the plaintext prober
        assert _https_compute(tp, cert, 1)[2] == b'{"value": 3}\n'
    finally:
        _close((jh, jm), (th, tm))


@pytest.mark.parametrize("var", ["MISAKA_TLS_CERT", "MISAKA_TLS_KEY"])
def test_c3_one_tls_variable_without_the_other_refuses(tmp_path, monkeypatch, var):
    monkeypatch.setenv(var, str(tmp_path / "x.pem"))
    tm = MasterNode(Topology.from_node_info_json(ADD2_ENV["NODE_INFO"], ADD2_PROGRAMS, **CAPS),
                    chunk_steps=32, batch=2, device="cpu")
    try:
        with pytest.raises(ValueError, match="set together"):
            make_http_server(tm, port=0)
    finally:
        tm.close()


# --- C.4 API keys -------------------------------------------------------------------------


C4_KEYS = [{"key": "adm-secret", "tenant": "ops", "admin": True},
           {"key": "bob-secret", "tenant": "bob"}]


def _c4_probe(base):
    """(status, body, WWW-Authenticate) of /compute without a key, with a
    tenant key, and of /pause with the tenant key."""
    out = []
    for path, key in (("/compute", None), ("/compute", "bob-secret"), ("/pause", "bob-secret")):
        req = urllib.request.Request(base + path, data=b"value=5", method="POST")
        if key:
            req.add_header("X-Misaka-Key", key)
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                out.append((r.status, r.read(), r.headers.get("WWW-Authenticate")))
        except urllib.error.HTTPError as e:
            out.append((e.code, e.read(), e.headers.get("WWW-Authenticate")))
    return out


@pytest.mark.parametrize("workers", [0, 1])
def test_c4_api_keyfile_arms_auth_like_jax(tmp_path, monkeypatch, workers):
    keys = tmp_path / "keys.json"
    keys.write_text(json.dumps({"keys": C4_KEYS}))
    monkeypatch.setenv("MISAKA_API_KEYS", str(keys))
    jm = JMaster(JTopology.from_node_info_json(ADD2_ENV["NODE_INFO"], ADD2_PROGRAMS, **CAPS),
                 chunk_steps=32, batch=2, engine="scan")
    jh = j_http(jm, port=0)
    try:
        jm.run()
        want = _c4_probe(f"http://127.0.0.1:{_serve(jh)}")
    finally:
        _close((jh, jm))
    proc, base = _boot(tmp_path, {**ADD2_ENV, "MISAKA_BATCH": "2", "MISAKA_PIDFILE": "off",
                                  "MISAKA_HTTP_WORKERS": str(workers)}, f"keys{workers}")
    try:
        got = _c4_probe(base)
    finally:
        proc.terminate()
        assert proc.wait(timeout=30) == 0
    assert got == want
    assert [g[0] for g in got] == [401, 200, 403] and got[1][1] == b'{"value": 7}\n'
    assert got[0][2] == 'Bearer realm="misaka", charset="UTF-8"'


def test_c4_programs_dir_keyfile_and_cpu_quota_refuse(tmp_path, monkeypatch, capsys):
    # the conventional <MISAKA_PROGRAMS_DIR>/api_keys.json arms auth with
    # the registry, in both apps; the registry seeds the boot network as
    # the pinned default program
    jdir, tdir = tmp_path / "jprograms", tmp_path / "tprograms"
    for d in (jdir, tdir):
        d.mkdir()
        (d / "api_keys.json").write_text(json.dumps({"keys": C4_KEYS}))
    monkeypatch.setenv("MISAKA_PROGRAMS_DIR", str(jdir))
    jm = JMaster(JTopology.from_node_info_json(ADD2_ENV["NODE_INFO"], ADD2_PROGRAMS, **CAPS),
                 chunk_steps=32, batch=2, engine="scan")
    jreg = JRegistry(str(jdir), batch=2, engine="scan", caps=CAPS)
    jreg.seed("default", jm)
    jh = j_http(jm, port=0, registry=jreg)
    try:
        jm.run()
        want = _c4_probe(f"http://127.0.0.1:{_serve(jh)}")
    finally:
        jreg.close()
        _close((jh, jm))
    monkeypatch.delenv("MISAKA_PROGRAMS_DIR")
    proc, base = _boot(tmp_path, {**ADD2_ENV, "MISAKA_BATCH": "2", "MISAKA_PIDFILE": "off",
                                  "MISAKA_IN_CAP": "8", "MISAKA_OUT_CAP": "8",
                                  "MISAKA_STACK_CAP": "8", "MISAKA_CANARY": "0",
                                  "MISAKA_PROGRAMS_DIR": str(tdir)}, "programs_dir_keys")
    try:
        got = _c4_probe(base)
        req = urllib.request.Request(base + "/programs", headers={"X-Misaka-Key": "adm-secret"})
        with urllib.request.urlopen(req, timeout=30) as r:
            listing = json.loads(r.read())["programs"]
    finally:
        proc.terminate()
        assert proc.wait(timeout=30) == 0
    assert got == want
    assert [g[0] for g in got] == [401, 200, 403] and got[1][1] == b'{"value": 7}\n'
    assert listing["default"]["pinned"] and listing["default"]["default"]
    assert listing["default"]["latest"] == jreg.resolve("default")[1]
    assert sorted(os.listdir(tdir / "default" / "versions")) == sorted(
        os.listdir(jdir / "default" / "versions"))
    # the `cpu` stage reads the usage ledger: MISAKA_QUOTA with `cpu` boots,
    # and a budget the first request spends sheds the next ones with the
    # JAX app's typed 429 and Retry-After
    for spec in ("cpu<0.5", "rps<5,cpu<0.5", "rps<5,vps<100"):
        app.check_env({**ADD2_ENV, "MISAKA_QUOTA": spec})
    assert "A.4" not in capsys.readouterr().err
    monkeypatch.setenv("MISAKA_QUOTA", "cpu<0.000001")
    jm = JMaster(JTopology.from_node_info_json(ADD2_ENV["NODE_INFO"], ADD2_PROGRAMS, **CAPS),
                 chunk_steps=32, batch=2, engine="scan")
    jh = j_http(jm, port=0)
    try:
        jm.run()
        want = _cpu_probe(f"http://127.0.0.1:{_serve(jh)}")
    finally:
        _close((jh, jm))
    proc, base = _boot(tmp_path, {**ADD2_ENV, "MISAKA_BATCH": "2", "MISAKA_PIDFILE": "off",
                                  "MISAKA_IN_CAP": "8", "MISAKA_OUT_CAP": "8",
                                  "MISAKA_STACK_CAP": "8", "MISAKA_CANARY": "0",
                                  "MISAKA_ENGINE": "scan"}, "cpu_quota")
    try:
        got = _cpu_probe(base)
    finally:
        proc.terminate()
        assert proc.wait(timeout=30) == 0
    assert got == want
    assert [g[0] for g in got] == [200, 429, 429] and got[0][1] == b'{"value": 7}\n'
    assert got[1][1] == b"cpu quota exhausted (1e-06 core-seconds/s over 60s)"


def _cpu_probe(base):
    """(status, body, Retry-After) of three sequential /compute."""
    out = []
    for _ in range(3):
        req = urllib.request.Request(base + "/compute", data=b"value=5", method="POST")
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                out.append((r.status, r.read(), r.headers.get("Retry-After")))
        except urllib.error.HTTPError as e:
            out.append((e.code, e.read(), e.headers.get("Retry-After")))
    return out


# --- C.5 MISAKA_AUTOCKPT ----------------------------------------------------------------


def _rt_text():
    with open(RUNNING_TOTAL) as f:
        return f.read()


def _jax_rt():
    return JMaster(JTopology.from_json(_rt_text(), **CAPS), chunk_steps=32, batch=4,
                   engine="scan")


def _port_rt():
    return MasterNode(Topology.from_json(_rt_text(), **CAPS), chunk_steps=32, batch=4,
                      device="cpu")


def _jfields(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def _assert_same(a, b):
    assert set(a) == set(b)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def _serve_some(m, seed):
    rng = np.random.default_rng(seed)
    m.run()
    m.compute_spread(rng.integers(-500, 500, size=32).astype(np.int32))
    m.pause()


def test_c5_autockpt_requires_a_checkpoint_dir():
    tm = _port_rt()
    try:
        with pytest.raises(SystemExit, match="MISAKA_AUTOCKPT requires MISAKA_CHECKPOINT_DIR"):
            app.arm_autockpt(tm, {"MISAKA_AUTOCKPT": "5"})
        assert app.arm_autockpt(tm, {}) is None
    finally:
        tm.close()


def test_c5_auto_snapshots_cross_between_packages(tmp_path):
    jm, tm = _jax_rt(), _port_rt()
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    auto = None
    try:
        # JAX writes, the port restores at boot (app.arm_autockpt)
        _serve_some(jm, 1)
        ja = JAuto(jm, str(jdir), 3600)
        try:
            jpath = ja.save_once()
        finally:
            ja.close()
        assert os.path.basename(jpath) == "auto-00000001.npz"
        auto = app.arm_autockpt(tm, {"MISAKA_AUTOCKPT": "3600",
                                     "MISAKA_CHECKPOINT_DIR": str(jdir)})
        _assert_same(state_to_numpy(tm.snapshot()), _jfields(jm.snapshot()))
        # its sequence continues after the restored snapshot's
        assert os.path.basename(auto.save_once()) == "auto-00000002.npz"
        auto.close()
        auto = None
        # the port writes, JAX restores
        _serve_some(tm, 2)
        ta = AutoCheckpointer(tm, str(tdir), 3600)
        try:
            tpath = ta.save_once()
        finally:
            ta.close()
        assert JAuto.restore_latest(jm, str(tdir)) == tpath
        _assert_same(_jfields(jm.snapshot()), state_to_numpy(tm.snapshot()))
    finally:
        if auto is not None:
            auto.close()
        jm.close()
        tm.close()


def test_c5_torn_newest_snapshot_falls_back(tmp_path):
    tm = _port_rt()
    try:
        a = AutoCheckpointer(tm, str(tmp_path), 3600)
        try:
            _serve_some(tm, 3)
            first = a.save_once()
            want = state_to_numpy(tm.snapshot())
            _serve_some(tm, 4)
            newest = a.save_once()
        finally:
            a.close()
        with open(newest, "r+b") as f:  # tear it: cut the file in half
            f.truncate(os.path.getsize(newest) // 2)
        rejected = tmaster.M_CKPT_REJECTED.value
        assert AutoCheckpointer.restore_latest(tm, str(tmp_path)) == first
        assert tmaster.M_CKPT_REJECTED.value == rejected + 1
        _assert_same(state_to_numpy(tm.snapshot()), want)
    finally:
        tm.close()


def test_c5_interval_snapshots_rotate_to_keep(tmp_path):
    tm = _port_rt()
    a = AutoCheckpointer(tm, str(tmp_path), 0.2, keep=2)
    try:
        deadline = time.monotonic() + 30
        while a._seq < 4:
            assert time.monotonic() < deadline, "no interval snapshots within 30 s"
            time.sleep(0.05)
    finally:
        a.close()
    snaps = AutoCheckpointer.snapshots(str(tmp_path))
    assert len(snaps) == 2
    assert all(os.path.exists(p + ".manifest") for p in snaps)
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(p) for p in snaps] + [os.path.basename(p) + ".manifest" for p in snaps])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _boot(tmp_path, env, label):
    port = _free_port()
    full = {**os.environ, **env, "MISAKA_PORT": str(port), "MISAKA_AUTORUN": "1",
            "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    log = open(tmp_path / f"{label}.log", "w")
    proc = subprocess.Popen([sys.executable, "-m", "misaka_tpu_torch.runtime.app"], cwd=ROOT,
                            env=full, stdout=log, stderr=subprocess.STDOUT)
    log.close()
    base = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + 60
    while True:
        assert proc.poll() is None, (tmp_path / f"{label}.log").read_text()
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
                # the native edge answers {"ok": true} until its first push
                if json.loads(r.read()).get("running"):
                    return proc, base
        except (urllib.error.URLError, OSError, ValueError):
            pass
        assert time.monotonic() < deadline, f"{label}: app not serving within 60 s"
        time.sleep(0.2)


def _jax_compute_batch(master, values):
    return [int(v) for v in master.compute_many(values, timeout=60)]


def _compute_batch(base, values):
    data = urllib.parse.urlencode({"values": ",".join(map(str, values))}).encode()
    with urllib.request.urlopen(base + "/compute_batch", data=data, timeout=30) as r:
        return [int(v) for v in json.loads(r.read())["values"]]


def test_c5_restarted_app_resumes_from_its_auto_snapshot(tmp_path):
    env = {"MISAKA_TOPOLOGY": RUNNING_TOTAL, "MISAKA_DEVICE": "cpu", "MISAKA_IN_CAP": "8",
           "MISAKA_OUT_CAP": "8", "MISAKA_STACK_CAP": "8", "MISAKA_CHUNK_STEPS": "32",
           "MISAKA_AUTOCKPT": "0.2", "MISAKA_CHECKPOINT_DIR": str(tmp_path / "ckpt"),
           "MISAKA_PIDFILE": "off"}
    proc, base = _boot(tmp_path, env, "first")
    try:
        assert _compute_batch(base, [1, 2, 3]) == [1, 3, 6]
        # wait for a snapshot taken after the request
        t_done = time.time()
        deadline = time.monotonic() + 30
        while not any(os.path.getmtime(p) > t_done
                      for p in AutoCheckpointer.snapshots(str(tmp_path / "ckpt"))):
            assert time.monotonic() < deadline, "no auto snapshot within 30 s"
            time.sleep(0.1)
    finally:
        proc.terminate()
        assert proc.wait(timeout=30) == 0
    proc, base = _boot(tmp_path, env, "second")
    try:
        # the running total carries on from the restored state (fresh: [4])
        assert _compute_batch(base, [4]) == [10]
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# --- the same class, lower stakes ---------------------------------------------------------


@pytest.mark.parametrize("extra,item", [
    ({"MISAKA_PROGRAMS_DIR": "programs"}, None),
    ({"MISAKA_FLEET": "2"}, "boots"),
    ({"MISAKA_HTTP_WORKERS": "2", "MISAKA_PLANE_TLS_CERT": "plane.pem"}, "partial"),
    ({"MISAKA_HTTP_WORKERS": "2", "MISAKA_PLANE_SOCKET": "/tmp/a.sock,/tmp/b.sock"}, "boots"),
    ({"MISAKA_COORDINATOR": "127.0.0.1:{port}", "MISAKA_NUM_PROCESSES": "1",
      "MISAKA_PROCESS_ID": "0"}, "group"),
], ids=["programs_dir", "fleet", "plane_tls", "plane_paths", "coordinator"])
def test_unported_planes_refuse_at_boot(extra, item, tmp_path):
    if item is None:
        # ported (ROADMAP A.3): the app boots, and the registry seeds the
        # boot network under the JAX app's version ID and store layout
        env = {**ADD2_ENV, "MISAKA_BATCH": "2",
               **{k: str(tmp_path / v) for k, v in extra.items()}}
        app.check_env(env)
        tm = app.build_master_from_env(env)
        jm = JMaster(JTopology.from_node_info_json(ADD2_ENV["NODE_INFO"], ADD2_PROGRAMS),
                     chunk_steps=32, batch=2, engine="scan")
        reg = jreg = None
        try:
            reg = app.build_registry_from_env(tm, env)
            jreg = JRegistry(None, batch=2, engine="scan")
            jreg.seed("default", jm)
            assert reg.default_name == "default" and tm.program_label == "default"
            assert reg.resolve(None) == jreg.resolve(None)
            with reg.lease(None) as m:
                assert m is tm
            assert sorted(os.listdir(tmp_path / "programs" / "default")) == [
                "aliases.json", "versions"]
        finally:
            for r in (reg, jreg):
                if r is not None:
                    r.close()
            tm.close()
            jm.close()
        return
    if item == "boots":
        # ported (ROADMAP A.6): the fleet and the router pass the checks
        app.check_env({**ADD2_ENV, **extra})
        return
    if item == "group":
        # ported (ROADMAP A.7): the app joins a gloo group of one through
        # MISAKA_COORDINATOR and serves add2 as the JAX master does
        extra = {k: v.format(port=_free_port()) for k, v in extra.items()}
        env = {**ADD2_ENV, **extra, "MISAKA_BATCH": "2", "MISAKA_CHUNK_STEPS": "32"}
        app.check_env(env)
        jm = JMaster(JTopology.from_node_info_json(ADD2_ENV["NODE_INFO"], ADD2_PROGRAMS),
                     chunk_steps=32, batch=2, engine="scan")
        jm.run()
        try:
            want = _jax_compute_batch(jm, [5, -3, 40])
        finally:
            jm.close()
        proc, base = _boot(tmp_path, env, "group")
        try:
            assert _compute_batch(base, [5, -3, 40]) == want == [7, -1, 42]
        finally:
            proc.terminate()
            assert proc.wait(timeout=30) == 0
        assert "joined process group" in (tmp_path / "group.log").read_text()
        for bad, why in (({"MISAKA_COORDINATOR": "auto"}, "autodetection"),
                         ({**extra, "MISAKA_NUM_PROCESSES": "2", "MISAKA_MODEL_PARALLEL": "2"},
                          "ROADMAP A.7b")):
            with pytest.raises(SystemExit, match=why) as exc:
                app.check_env({**ADD2_ENV, **bad})
            assert exc.value.code == 2
        return
    if item == "partial":
        # a partial MISAKA_PLANE_TLS_* triple fails loud, as the JAX plane's
        env = {**ADD2_ENV, **extra}
        with pytest.raises(ValueError, match="must be set together") as jexc:
            JEdge.plane_tls_from_env(env)
        with pytest.raises(SystemExit) as exc:
            app.check_env(env)
        assert str(jexc.value) in str(exc.value)
        return
    with pytest.raises(SystemExit, match=f"ROADMAP {item}") as exc:
        app.check_env({**ADD2_ENV, **extra})
    assert exc.value.code == 2


def test_one_worker_and_zero_fleet_boot():
    app.check_env({**ADD2_ENV, "MISAKA_HTTP_WORKERS": "1", "MISAKA_FLEET": "0"})


ARMING = {
    # var -> (value, the probe route, what the JAX app answers there too)
    "MISAKA_FAULTS": ("quota_exhaust", "/debug/faults", {"armed": ["quota_exhaust"]}),
    "MISAKA_SLO": ("p99<250ms", "/debug/alerts", None),
}


@pytest.mark.parametrize("var", ["MISAKA_FAULTS", "MISAKA_SLO"])
def test_faults_and_slo_warn_once(var, caplog, tmp_path):
    # each variable arms its plane at boot, no longer a warning: an app
    # booted with it reports the plane armed, as the JAX modules read it
    value, route, body = ARMING[var]
    with caplog.at_level(logging.WARNING, logger="misaka_tpu_torch.app"):
        app.check_env({**ADD2_ENV, var: value})
    assert not [r for r in caplog.records if var in r.getMessage()]
    proc, base = _boot(tmp_path, {**ADD2_ENV, "MISAKA_BATCH": "2", "MISAKA_PIDFILE": "off",
                                  "MISAKA_CANARY": "0", var: value}, var)
    try:
        with urllib.request.urlopen(base + route, timeout=30) as r:
            got = json.loads(r.read())
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
    finally:
        proc.terminate()
        assert proc.wait(timeout=30) == 0
    if var == "MISAKA_FAULTS":
        assert got == body
    else:
        assert got["enabled"] and got["default_objectives"] == [value]
        assert health["slo"] == "ok" and health["degraded"] is False


def test_f6_tsdb_dir_refuses_naming_a4b(tmp_path):
    # F.6 was a silent drop of MISAKA_TSDB_DIR, then a refusal: the
    # variable now arms the durable tier, as in the JAX app (the TSDB's
    # spooled tiers, the usage ledger's spool, the capture spool)
    tsdb_dir = tmp_path / "tsdb"
    env = {**ADD2_ENV, "MISAKA_BATCH": "2", "MISAKA_TSDB_DIR": str(tsdb_dir)}
    app.check_env(env)  # no refusal
    proc, base = _boot(tmp_path, {**env, "MISAKA_TSDB": "1", "MISAKA_CANARY": "0",
                                  "MISAKA_PIDFILE": "off", "MISAKA_TSDB_INTERVAL_S": "0.2"},
                       "tsdb")
    try:
        assert _compute_batch(base, [1, 2, 3]) == [3, 4, 5]
        with urllib.request.urlopen(base + "/debug/usage", timeout=30) as r:
            assert "cumulative" in json.loads(r.read())
        with urllib.request.urlopen(base + "/debug/captures", timeout=30) as r:
            spool = json.loads(r.read())["spool"]
        assert spool["dir"] == str(tsdb_dir / "capture")
        deadline = time.monotonic() + 30
        while not any(n.startswith("tsdb-fine") for n in os.listdir(tsdb_dir)):
            assert time.monotonic() < deadline, "no TSDB segment within 30 s"
            time.sleep(0.1)
        assert {"usage", "capture"} <= set(os.listdir(tsdb_dir))
        req = urllib.request.Request(base + "/captures/rotate", data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.loads(r.read())["path"].startswith(str(tsdb_dir / "capture" / "spool-"))
    finally:
        proc.terminate()
        proc.wait(timeout=30)


@pytest.mark.parametrize("value,warns", [("0", False), ("p99-drift=x", True)])
def test_f6_watchdog_rules_warn_once(value, warns, caplog, monkeypatch):
    # the rules are armed now, as the JAX app arms them: no warning, and
    # the port's watchdog answers the JAX one's payload (`warns`: the
    # spec is set, so a watchdog runs; this one is malformed, which both
    # report and answer with the default rules)
    from misaka_tpu.utils import tsdb as jtsdb
    from misaka_tpu.utils import watchdog as jwatchdog
    from misaka_tpu_torch.utils import tsdb as ttsdb
    from misaka_tpu_torch.utils import watchdog as twatchdog

    env = {**ADD2_ENV, "MISAKA_WATCHDOG": value, "MISAKA_TSDB": "1", "MISAKA_SAMPLER": "0"}
    with caplog.at_level(logging.WARNING, logger="misaka_tpu_torch.app"):
        app.check_env(env)
    assert not [r for r in caplog.records if "MISAKA_WATCHDOG" in r.getMessage()]
    payloads = []
    try:
        for tsdb_mod, wd_mod in ((jtsdb, jwatchdog), (ttsdb, twatchdog)):
            wd_mod.shutdown()
            armed = wd_mod.ensure_started(env)
            assert (armed is not None) == warns
            payloads.append((wd_mod.overall_state(), wd_mod.debug_payload()))
    finally:
        for tsdb_mod, wd_mod in ((jtsdb, jwatchdog), (ttsdb, twatchdog)):
            wd_mod.shutdown()
            tsdb_mod.shutdown()
    assert payloads[0] == payloads[1]
    if warns:
        state, payload = payloads[1]
        assert state == "ok" and "p99-drift=x" in payload["spec_error"]
        assert [r["rule"] for r in payload["rules"]][0] == "canary-full"
    else:
        assert payloads[1] == (None, {"enabled": False, "state": "ok", "rules": []})
