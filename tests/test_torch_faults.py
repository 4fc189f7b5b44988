"""The port's fault points (utils/faults.py) against the JAX package's.

Both packages parse the same MISAKA_FAULTS specs to the same dicts and
refuse the same bad ones with the same FaultSpecError text; seeded from
the module `random` (the draw the reference makes) they fire the same
sequences.  Then each hook site the port has fires where the reference's
does: `serve_delay` (bare and scoped to one program) in the serve
scheduler's pass, `ckpt_crash` and `ckpt_torn_write` in save_checkpoint,
`swap_during_load` in the registry's hot swap, `overload` (bare and per
tenant) and `quota_exhaust` at the edge, `plane_partition`,
`plane_delay` and `replica_blackhole` on the compute plane, and
`worker_exit` in a frontend worker process.  GET and POST /debug/faults
answer the JAX server's status and body, byte for byte.
"""

import json
import os
import random
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

from misaka_tpu.runtime import master as jmaster
from misaka_tpu.utils import faults as jfaults
from misaka_tpu_torch import networks
from misaka_tpu_torch.runtime import checkpoint as ckpt
from misaka_tpu_torch.runtime import edge as tedge
from misaka_tpu_torch.runtime import frontends
from misaka_tpu_torch.runtime import master as tmaster
from misaka_tpu_torch.runtime import registry as tregistry
from misaka_tpu_torch.utils import faults

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(stack_cap=8, in_cap=8, out_cap=8)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.configure(None)
    jfaults.configure(None)


@pytest.fixture(scope="module", autouse=True)
def _quiet_jax_daemons():
    with pytest.MonkeyPatch.context() as mp:
        for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG", "MISAKA_CANARY"):
            mp.setenv(switch, "0")
        yield


def _parse(mod, text):
    try:
        return ("ok", mod.parse_spec(text))
    except mod.FaultSpecError as e:
        return ("error", str(e))


SPECS = [
    "ckpt_torn_write=0.5, rpc_delay=0.2@0.1,worker_exit",
    "",
    None,
    "plane_partition,plane_partition:10.0.0.2:9001,plane_delay=0.05@0.5",
    "serve_delay:tenant-a=0.5,overload:bob,replica_blackhole:1=2",
    "swap_during_load=0.3,quota_exhaust,ckpt_crash,replica_kill=1,jit_fail",
    "plane_delay:peer=0.1",
    "plane_partition:",
    "not_a_point=1",
    "rpc_drop@2",
    "rpc_drop@x",
    "rpc_delay=abc",
]


@pytest.mark.parametrize("text", SPECS, ids=[repr(s) for s in SPECS])
def test_parse_and_errors_equal_jax(text):
    assert _parse(faults, text) == _parse(jfaults, text)


def test_points_equal_jax():
    assert faults.POINTS == jfaults.POINTS
    assert faults.SCOPED_POINTS == jfaults.SCOPED_POINTS


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_seeded_fire_sequences_equal_jax(seed):
    rng = np.random.default_rng(seed)
    spec = f"rpc_drop@{rng.uniform(0.1, 0.9):.3f},serve_delay:t={rng.uniform():.3f}@0.5"
    seqs = []
    for mod in (jfaults, faults):
        mod.configure(spec)
        random.seed(seed)
        seqs.append([(mod.fire("rpc_drop"), mod.fire("serve_delay:t"), mod.fire("jit_fail"))
                     for _ in range(64)])
        assert mod.armed() and mod.active() == {"rpc_drop", "serve_delay:t"}
        mod.configure("")
        assert not mod.armed()
    assert seqs[0] == seqs[1]
    assert {s[0] for s in seqs[1]} == {None, 1.0}  # the roll misses and hits


# --- hook sites -------------------------------------------------------------------------


def _master(batch=2, **kw):
    return tmaster.MasterNode(networks.add2(**SMALL), chunk_steps=16, batch=batch,
                              device="cpu", **kw)


@pytest.mark.parametrize("spec,label,delayed", [
    ("serve_delay=0.3", None, True),
    ("serve_delay:tenant-a=0.3", "tenant-a", True),
    ("serve_delay:tenant-a=0.3", "tenant-b", False),
    ("serve_delay:default=0.3", None, True),
])
def test_serve_delay_fires_in_the_scheduler_pass(spec, label, delayed):
    m = _master()
    m.program_label = label
    m.run()
    try:
        assert m.compute_coalesced([1]) == [3]  # warm
        faults.configure(spec)
        t0 = time.monotonic()
        assert m.compute_coalesced([5]) == [7]
        took = time.monotonic() - t0
        assert (took >= 0.3) == delayed, took
    finally:
        m.close()


def test_ckpt_crash_leaves_the_target_intact(tmp_path):
    m = _master()
    path = str(tmp_path / "ck.npz")
    try:
        m.save_checkpoint(path)
        good = open(path, "rb").read()
        faults.configure("ckpt_crash")
        with pytest.raises(OSError, match="injected ckpt_crash"):
            m.save_checkpoint(path)
        faults.configure(None)
        assert open(path, "rb").read() == good
        ckpt.verify_checkpoint(path)
        assert [n for n in os.listdir(tmp_path) if ".tmp." in n] == []
    finally:
        m.close()


def test_ckpt_torn_write_is_rejected_then_recovers(tmp_path):
    m = _master()
    m.run()
    path = str(tmp_path / "ck.npz")
    try:
        assert m.compute(1) == 3
        faults.configure("ckpt_torn_write=0.5")
        m.save_checkpoint(path)
        size = os.path.getsize(path)
        faults.configure(None)
        with open(ckpt.manifest_path(path)) as f:
            assert size == json.load(f)["size"] // 2
        fresh = _master()
        with pytest.raises(ckpt.CheckpointError):
            fresh.load_checkpoint(path)
        assert m.compute(2) == 4  # the serving master is untouched
        m.save_checkpoint(path)
        fresh.load_checkpoint(path)
        fresh.close()
    finally:
        m.close()


def test_swap_during_load_holds_the_park_gate():
    reg = tregistry.ProgramRegistry(None, batch=2, chunk_steps=16, caps=SMALL, engine="scan",
                                    device="cpu")
    try:
        reg.publish("p", tis="IN ACC\nADD 10\nOUT ACC\n")
        with reg.lease("p") as m:
            assert m.compute_coalesced([1]) == [11]
        faults.configure("swap_during_load=0.4")
        got = {}

        def parked():
            time.sleep(0.15)  # inside the held gate
            t0 = time.monotonic()
            with reg.lease("p") as m:
                got["out"] = m.compute_coalesced([1])
            got["waited"] = time.monotonic() - t0

        t = threading.Thread(target=parked)
        t0 = time.monotonic()
        t.start()
        assert reg.publish("p", tis="IN ACC\nADD 20\nOUT ACC\n")["swapped"]
        took = time.monotonic() - t0
        t.join(30)
        assert took >= 0.4
        assert got["out"] == [21]  # parked through the swap, served by the new version
    finally:
        reg.close()


def _chain(signals=lambda: (0, False)):
    return tedge.from_env(signals=signals, environ={"MISAKA_QUOTA": "rps<1000"})


@pytest.mark.parametrize("spec,tenant,shed", [
    ("overload", "anon", True),
    ("overload:bob", "bob", True),
    ("overload:bob", "alice", False),
])
def test_overload_sheds_at_admission(spec, tenant, shed):
    gov = tedge.AdmissionGovernor(lambda: (0, False), 1000)
    faults.configure(spec)
    rej = gov.check(tenant, 1)
    assert (rej is not None) == shed
    if shed:
        assert (rej.status, rej.reason, rej.retry_after) == (429, "overload", 1.0)


def test_quota_exhaust_trips_the_quota_stage():
    chain = _chain()
    assert chain.check("/compute", "POST", key=None, program=None, values=1).reject is None
    faults.configure("quota_exhaust")
    rej = chain.check("/compute", "POST", key=None, program=None, values=1).reject
    assert (rej.status, rej.reason, rej.message, rej.retry_after) == (
        429, "rate", "quota exhausted (injected fault)", 1.0)
    faults.configure(None)
    assert chain.check("/compute", "POST", key=None, program=None, values=1).reject is None


@pytest.fixture
def plane(tmp_path):
    m = _master()
    m.run()
    path = str(tmp_path / "plane.sock")
    p = frontends.start_compute_plane(m, path)
    yield path
    p.close()
    m.close()


def test_plane_partition_fails_the_dial(plane):
    client = frontends.PlaneClient(plane, conns=1, timeout=2.0)
    try:
        vals = np.asarray([1, 2], "<i4").tobytes()
        assert np.frombuffer(client.compute_raw(vals), "<i4").tolist() == [3, 4]
        client2 = frontends.PlaneClient(plane, conns=1, timeout=2.0)
        faults.configure(f"plane_partition:{os.path.basename(plane)}")
        with pytest.raises(frontends.PlaneError) as ei:
            client2.compute_raw(vals, timeout=5.0)
        assert b"plane partitioned (injected fault)" in ei.value.body
        faults.configure("plane_partition:elsewhere")
        assert np.frombuffer(client.compute_raw(vals), "<i4").tolist() == [3, 4]
        client2.close()
    finally:
        client.close()


@pytest.mark.parametrize("point", ["plane_delay=0.3", "replica_blackhole=0.3"])
def test_plane_delay_and_blackhole_hold_the_frame(plane, point):
    client = frontends.PlaneClient(plane, conns=1)
    try:
        vals = np.asarray([5], "<i4").tobytes()
        assert np.frombuffer(client.compute_raw(vals), "<i4").tolist() == [7]
        faults.configure(point)
        t0 = time.monotonic()
        assert np.frombuffer(client.compute_raw(vals), "<i4").tolist() == [7]
        assert time.monotonic() - t0 >= 0.3
    finally:
        client.close()


def test_worker_exit_hard_exits_the_worker(tmp_path):
    env = {**os.environ, "MISAKA_FAULTS": "worker_exit=0.2", "PYTHONPATH": ROOT}
    proc = subprocess.Popen(
        [sys.executable, "-m", "misaka_tpu_torch.runtime.frontends", "--port", "0",
         "--engine", "http://127.0.0.1:9", "--plane", str(tmp_path / "none.sock")],
        env=env, cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        assert proc.wait(timeout=30) == 1
        assert b"worker_exit fault fired" in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()


# --- the HTTP surface --------------------------------------------------------------------


def _call(base, method, path, form=None):
    data = urllib.parse.urlencode(form).encode() if form is not None else None
    req = urllib.request.Request(base + path, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_debug_faults_route_answers_like_jax():
    from misaka_tpu.networks import add2 as jadd2

    servers = []
    for mk, top, kw in ((jmaster, jadd2(**SMALL), {"engine": "scan"}),
                        (tmaster, networks.add2(**SMALL), {"device": "cpu"})):
        m = mk.MasterNode(top, chunk_steps=16, batch=2, **kw)
        httpd = mk.make_http_server(m, port=0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        m.run()
        servers.append((f"http://127.0.0.1:{httpd.server_address[1]}", m, httpd))
    steps = [("GET", "/debug/faults", None),
             ("POST", "/debug/faults", {"spec": "serve_delay:b=0.01,quota_exhaust@0"}),
             ("GET", "/debug/faults", None),
             ("POST", "/debug/faults", {"spec": "frobnicate"}),
             ("POST", "/debug/faults", {"spec": "rpc_drop@3"}),
             ("GET", "/debug/faults", None),
             ("POST", "/compute", {"value": "1"}),
             ("POST", "/debug/faults", {"spec": ""}),
             ("GET", "/debug/faults", None)]
    try:
        answers = [[_call(base, *s) for s in steps] for base, _, _ in servers]
    finally:
        for _, m, httpd in servers:
            httpd.shutdown()
            m.close()
    assert answers[0] == answers[1]
    assert [s for s, _ in answers[1]] == [200, 200, 200, 400, 400, 200, 200, 200, 200]
    assert json.loads(answers[1][2][1]) == {"armed": ["quota_exhaust", "serve_delay:b"]}
