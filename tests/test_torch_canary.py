"""The port's synthetic canary (runtime/canary.py) against the JAX one.

`probe_once` of each package's prober runs against its own server on the
CPU: with a program registry and a compute plane every tier (edge, plane,
engine, full) is ok and `_canary` is in the listing, not pinned; without a
registry the engine and full tiers are "off" with the reference's reasons;
a broken plane socket is attributed to `plane`; MISAKA_CANARY=0 arms
nothing; the series are the reference's names, types and help.  The
port's app carries the /healthz `canary` block in its default env, as the
JAX app does, and with MISAKA_PROGRAMS_DIR behind a frontend worker every
tier of it turns ok.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import pytest
import torch

from misaka_tpu import networks as jnetworks
from misaka_tpu.runtime import canary as jcanary
from misaka_tpu.runtime import frontends as jfrontends
from misaka_tpu.runtime import master as jmaster
from misaka_tpu.runtime import registry as jregistry
from misaka_tpu.utils import metrics as jmetrics
from misaka_tpu_torch import networks as tnetworks
from misaka_tpu_torch.networks import ADD2_PROGRAMS
from misaka_tpu_torch.runtime import canary as tcanary
from misaka_tpu_torch.runtime import frontends as tfrontends
from misaka_tpu_torch.runtime import master as tmaster
from misaka_tpu_torch.runtime import registry as tregistry
from misaka_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(stack_cap=16, in_cap=16, out_cap=16)
ADD2_NODE_INFO = json.dumps({"misaka1": {"type": "program"}, "misaka2": {"type": "program"},
                             "misaka3": {"type": "stack"}})

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", MasterNode=jmaster.MasterNode, make_http_server=jmaster.make_http_server,
        reg=jregistry, canary=jcanary, frontends=jfrontends, networks=jnetworks,
        metrics=jmetrics, kw={"engine": "scan"}, app="misaka_tpu.runtime.app"),
    "torch": types.SimpleNamespace(
        name="torch", MasterNode=tmaster.MasterNode, make_http_server=tmaster.make_http_server,
        reg=tregistry, canary=tcanary, frontends=tfrontends, networks=tnetworks,
        metrics=tmetrics, kw={"engine": "scan", "device": "cpu"},
        app="misaka_tpu_torch.runtime.app"),
}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # the JAX server's process-global daemons would outlive a test
    for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG"):
        monkeypatch.setenv(switch, "0")
    yield
    for p in PKGS.values():  # a process canary would probe a dead port
        p.canary.shutdown()


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


class Stack:
    """One package's add2 server at batch 2 on its own thread, with a
    seeded registry and a compute plane when asked."""

    def __init__(self, p, tmp_path, registry=True, plane=True):
        top = p.networks.add2(**SMALL)
        self.master = p.MasterNode(top, chunk_steps=32, batch=2, **p.kw)
        self.reg = None
        if registry:
            self.reg = p.reg.ProgramRegistry(None, batch=2, chunk_steps=32, caps=SMALL, **p.kw)
            self.reg.seed("default", self.master, top)
        self.httpd = p.make_http_server(self.master, port=0, registry=self.reg)
        self.plane = None
        if plane:
            self.plane = p.frontends.start_compute_plane(
                self.master, str(tmp_path / f"{p.name}.sock"), registry=self.reg)
            self.httpd.misaka_plane = self.plane
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.master.run()
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        if self.plane is not None:
            self.plane.close()
        self.master.pause()
        if self.reg is not None:
            self.reg.close()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.master.close()


def oks(state):
    return {t: v.get("ok") for t, v in state["tiers"].items()}


def test_every_tier_ok_with_a_registry_and_a_plane(pkg, tmp_path):
    s = Stack(pkg, tmp_path)
    try:
        c = pkg.canary.CanaryProber(s.base, registry=s.reg, server=s.httpd, interval_s=60)
        state = c.probe_once()
        assert oks(state) == {"edge": True, "plane": True, "engine": True, "full": True}
        assert state["failing_tier"] is None and state["cycles"] == 1
        assert state["program"] == "_canary" and not state["running"]
        listing = s.reg.list_programs()["programs"]
        assert "_canary" in listing and listing["_canary"]["pinned"] is False
        # a second cycle reuses the registered program
        assert oks(c.probe_once()) == oks(state)
        assert len(s.reg.list_programs()["programs"]["_canary"]["versions"]) == 1
    finally:
        s.close()


def test_without_a_registry_engine_and_full_are_off_as_in_jax(tmp_path):
    states = []
    for p in PKGS.values():
        s = Stack(p, tmp_path, registry=False, plane=False)
        try:
            st = p.canary.CanaryProber(s.base, server=s.httpd).probe_once()
        finally:
            s.close()
        assert st["tiers"]["edge"]["ok"] is True
        states.append({t: v for t, v in st["tiers"].items() if t != "edge"})
    assert states[0] == states[1] == {
        "plane": {"ok": None, "off": "no compute plane in this process"},
        "engine": {"ok": None, "off": "no program registry in this process"},
        "full": {"ok": None, "off": "no program registry behind this surface"},
    }


def test_a_broken_plane_socket_is_attributed_to_the_plane(pkg, tmp_path):
    s = Stack(pkg, tmp_path, plane=False)
    try:
        # a plane that is not closed but whose socket answers nothing
        s.httpd.misaka_plane = types.SimpleNamespace(path=str(tmp_path / "gone.sock"),
                                                     _closed=False)
        state = pkg.canary.CanaryProber(s.base, registry=s.reg, server=s.httpd).probe_once()
        assert oks(state) == {"edge": True, "plane": False, "engine": True, "full": True}
        assert state["failing_tier"] == "plane"
        assert "error" in state["tiers"]["plane"]
    finally:
        s.close()


def test_canary_off_arms_nothing(pkg, tmp_path):
    s = Stack(pkg, tmp_path, registry=False, plane=False)
    try:
        assert pkg.canary.ensure_started(s.base, server=s.httpd,
                                         environ={"MISAKA_CANARY": "0"}) is None
        assert pkg.canary.get() is None and pkg.canary.state_payload() is None
        with urllib.request.urlopen(s.base + "/healthz", timeout=30) as r:
            assert "canary" not in json.loads(r.read())
        # armed, the same server's /healthz carries the block
        c = pkg.canary.ensure_started(s.base, server=s.httpd,
                                      environ={"MISAKA_CANARY_INTERVAL_S": "60"})
        assert c.running and pkg.canary.ensure_started(s.base, environ={}) is c
        c.probe_once()
        with urllib.request.urlopen(s.base + "/healthz", timeout=30) as r:
            block = json.loads(r.read())["canary"]
        assert block == {"failing_tier": None, "consecutive_full_failures": 0,
                         "tiers": {"edge": True, "plane": None, "engine": None, "full": None}}
    finally:
        s.close()


def test_series_are_the_references():
    def lines(p):
        return sorted(ln for ln in p.metrics.render().splitlines()
                      if ln.startswith(("# HELP misaka_canary_", "# TYPE misaka_canary_")))

    assert lines(PKGS["torch"]) == lines(PKGS["jax"])
    assert {ln.split()[2] for ln in lines(PKGS["torch"])} == {
        "misaka_canary_probes_total", "misaka_canary_failures_total",
        "misaka_canary_success", "misaka_canary_latency_seconds"}
    assert tcanary.SOURCE == jcanary.SOURCE and tcanary.TIERS == jcanary.TIERS


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _canary_block(p, tmp_path, label, env, until):
    """Boot p's app with `env`, poll /healthz until `until(block)` holds,
    return the block."""
    port = _free_port()
    full = {**os.environ, "NODE_INFO": ADD2_NODE_INFO, "MISAKA_PROGRAMS": json.dumps(ADD2_PROGRAMS),
            "MISAKA_BATCH": "2", "MISAKA_CHUNK_STEPS": "32", "MISAKA_IN_CAP": "16",
            "MISAKA_OUT_CAP": "16", "MISAKA_STACK_CAP": "16", "MISAKA_ENGINE": "scan",
            "MISAKA_DEVICE": "cpu", "MISAKA_AUTORUN": "1", "MISAKA_PIDFILE": "off",
            "MISAKA_PORT": str(port), "MISAKA_CANARY_INTERVAL_S": "0.2", "OMP_NUM_THREADS": "1",
            "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT, **env}
    log_path = tmp_path / f"{label}.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", p.app], cwd=ROOT, env=full, stdout=log,
                                stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 90
        while True:
            assert proc.poll() is None, log_path.read_text()
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                    block = json.loads(r.read()).get("canary")
                if block is not None and until(block):
                    return block
            except (urllib.error.URLError, OSError, ValueError):
                pass
            assert time.monotonic() < deadline, f"{label}: {log_path.read_text()}"
            time.sleep(0.2)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def test_app_healthz_carries_the_canary_in_its_default_env(tmp_path):
    def probed(block):
        return block["tiers"].get("edge") is not None and block["failing_tier"] is None

    blocks = [_canary_block(p, tmp_path, p.name, {}, probed) for p in PKGS.values()]
    assert blocks[0] == blocks[1] == {
        "failing_tier": None, "consecutive_full_failures": 0,
        "tiers": {"edge": True, "plane": None, "engine": None, "full": None}}


def test_app_with_a_programs_dir_turns_every_tier_ok(tmp_path):
    block = _canary_block(
        PKGS["torch"], tmp_path, "programs",
        {"MISAKA_PROGRAMS_DIR": str(tmp_path / "programs"), "MISAKA_HTTP_WORKERS": "1",
         "MISAKA_PLANE_SOCKET": str(tmp_path / "plane.sock")},
        # the tiers update one by one within a cycle and the failing tier
        # at its end: a cycle before the worker answered failed at `edge`
        lambda b: all(b["tiers"].get(t) for t in tcanary.TIERS) and b["failing_tier"] is None)
    assert block["consecutive_full_failures"] == 0
    # the canary program was published into the store like any upload
    assert os.listdir(tmp_path / "programs" / "_canary" / "versions")
