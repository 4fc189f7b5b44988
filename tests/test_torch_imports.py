"""misaka_tpu_torch stands alone: it imports neither jax nor misaka_tpu.

A fresh interpreter imports every module of the port plus chip_smoke.py
and reports what the imports added to sys.modules; neither `jax` nor
`misaka_tpu` (or any submodule), nor the reference's tools/replay.py
(which the JAX CLI loads by path), may appear: the port's replay is its
own misaka_tpu_torch/replay.py.  The frontend worker's modules
(runtime/frontends.py, client.py, utils/backoff.py) and the telemetry
planes they reach (utils/faults.py, utils/slo.py, runtime/usage.py,
runtime/capture.py) import no torch either: a worker process must not
pay for it; nor do the always-on and durable planes, stdlib only as in
the reference (utils/spool.py, tsdb.py, watchdog.py, sampler.py and
dashboard.py), nor the fleet (runtime/fleet.py: a worker's router imports
its HashRing).  The model-parallel modules (core/routing.py, core/axis.py,
parallel/routed.py, sharded.py, multihost.py) and the native host tier's
(utils/nativelib.py, tis/native.py, core/cinterp.py, specialize.py, jit.py,
native_serve.py) are among those checked, with runtime/compose.py and
utils/intmath.py; a native master maps only the port's own builds of its
C++ copies, never the reference's native/*.so.  The per-process distributed
mode's modules (runtime/nodes.py, transport/*) are walked too, and the fused
boot does not import gRPC: a fresh interpreter that imports
runtime/app.py, runtime/master.py and chip_smoke.py has neither `grpc` nor
`google.protobuf` in sys.modules.  chip_smoke.py must refuse to report a
result without a card, and when it is alone in a directory.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
before = set(sys.modules)
sys.path.insert(0, sys.argv[1])
import misaka_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(misaka_tpu_torch.__path__, "misaka_tpu_torch."))
for m in mods:
    importlib.import_module(m)
import chip_smoke
added = set(sys.modules) - before
bad = sorted(k for k in added
             if k.split(".")[0] in ("jax", "jaxlib", "misaka_tpu", "tools", "_misaka_replay"))
print(json.dumps({"modules": mods, "bad": bad}))
"""


def test_port_imports_neither_jax_nor_misaka_tpu():
    out = subprocess.run(
        [sys.executable, "-c", PROBE, ROOT], cwd=ROOT, capture_output=True,
        text=True, timeout=120, check=True,
    )
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    for m in ("misaka_tpu_torch.core.fused", "misaka_tpu_torch.runtime.app",
              "misaka_tpu_torch.csrc.build", "misaka_tpu_torch.utils.wire",
              "misaka_tpu_torch.parallel.mesh", "misaka_tpu_torch.core.trace",
              "misaka_tpu_torch.tis.disasm", "misaka_tpu_torch.debug",
              "misaka_tpu_torch.__main__", "misaka_tpu_torch.utils.metrics",
              "misaka_tpu_torch.utils.tracespan", "misaka_tpu_torch.utils.httpfast",
              "misaka_tpu_torch.utils.jsonlog", "misaka_tpu_torch.utils.buildinfo",
              "misaka_tpu_torch.utils.profiling", "misaka_tpu_torch.runtime.lifecycle",
              "misaka_tpu_torch.runtime.edge", "misaka_tpu_torch.runtime.frontends",
              "misaka_tpu_torch.client", "misaka_tpu_torch.utils.backoff",
              "misaka_tpu_torch.runtime.registry", "misaka_tpu_torch.runtime.canary",
              "misaka_tpu_torch.runtime.usage", "misaka_tpu_torch.utils.slo",
              "misaka_tpu_torch.utils.faults", "misaka_tpu_torch.runtime.capture",
              "misaka_tpu_torch.replay", "misaka_tpu_torch.utils.spool",
              "misaka_tpu_torch.utils.tsdb", "misaka_tpu_torch.utils.watchdog",
              "misaka_tpu_torch.utils.sampler", "misaka_tpu_torch.utils.dashboard",
              "misaka_tpu_torch.runtime.fleet", "misaka_tpu_torch.core.routing",
              "misaka_tpu_torch.core.axis", "misaka_tpu_torch.parallel.routed",
              "misaka_tpu_torch.parallel.sharded", "misaka_tpu_torch.parallel.multihost",
              "misaka_tpu_torch.utils.nativelib", "misaka_tpu_torch.tis.native",
              "misaka_tpu_torch.core.cinterp", "misaka_tpu_torch.core.specialize",
              "misaka_tpu_torch.core.jit", "misaka_tpu_torch.core.native_serve",
              "misaka_tpu_torch.runtime.compose", "misaka_tpu_torch.utils.intmath",
              "misaka_tpu_torch.runtime.nodes", "misaka_tpu_torch.transport",
              "misaka_tpu_torch.transport.rpc", "misaka_tpu_torch.transport.messenger_pb2"):
        assert m in report["modules"]


NO_GRPC_PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import misaka_tpu_torch.runtime.app, misaka_tpu_torch.runtime.master
import chip_smoke
misaka_tpu_torch.runtime.app.check_env({"NODE_INFO": "{}"})  # the fused boot's checks
print(json.dumps(sorted(k for k in sys.modules
                        if k.split(".")[0] == "grpc" or k.startswith("google.protobuf"))))
"""


def test_fused_boot_imports_no_grpc():
    """The fused boot, the HTTP surface and chip_smoke.py import neither
    grpc nor google.protobuf: a card's host without them serves."""
    out = subprocess.run(
        [sys.executable, "-c", NO_GRPC_PROBE, ROOT], cwd=ROOT, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


NATIVE_PROBE = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
os.environ["MISAKA_NATIVE_THREADS"] = "2"
from misaka_tpu_torch import networks
from misaka_tpu_torch.runtime.master import MasterNode
m = MasterNode(networks.add2(), batch=8, engine="native", device="cpu",
               native_spec_dir=sys.argv[2])
m.run()
assert m.compute_many([5]) == [7]
rung = m.status()["native"]
m.close()
with open("/proc/self/maps") as f:
    maps = sorted({line.split()[-1] for line in f if "libmisaka" in line or "interp-spec" in line})
print(json.dumps({"maps": maps, "rung": rung}))
"""


def test_native_libraries_come_from_the_port_build():
    """A native master's libraries are the port's own builds (its copies of
    the C++ sources, built into build/misaka_tpu_torch/ and the spec
    cache): no .so of the reference's native/ directory is mapped."""
    spec_dir = os.path.join(ROOT, "build", "misaka_tpu_torch", "test-imports-spec")
    out = subprocess.run(
        [sys.executable, "-c", NATIVE_PROBE, ROOT, spec_dir], cwd=ROOT, capture_output=True,
        text=True, timeout=300, check=True,
    )
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["maps"], report
    for path in report["maps"]:
        assert not path.startswith(os.path.join(ROOT, "native") + os.sep), path
        assert path.startswith((os.path.join(ROOT, "build", "misaka_tpu_torch") + os.sep,
                                spec_dir + os.sep)), path
    assert report["rung"]["jit"] or report["rung"]["specialized"] or report["rung"]["width"]


LEAN_PROBE = r"""
import json, sys
before = set(sys.modules)
sys.path.insert(0, sys.argv[1])
import misaka_tpu_torch.runtime.frontends, misaka_tpu_torch.client, misaka_tpu_torch.utils.backoff
import misaka_tpu_torch.utils.faults, misaka_tpu_torch.utils.slo, misaka_tpu_torch.runtime.usage
import misaka_tpu_torch.runtime.capture
import misaka_tpu_torch.utils.spool, misaka_tpu_torch.utils.tsdb, misaka_tpu_torch.utils.watchdog
import misaka_tpu_torch.utils.sampler, misaka_tpu_torch.utils.dashboard
import misaka_tpu_torch.runtime.fleet
added = set(sys.modules) - before
print(json.dumps(sorted(k for k in added
                        if k.split(".")[0] in ("torch", "jax", "jaxlib", "misaka_tpu"))))
"""


def test_frontend_worker_modules_import_no_torch():
    out = subprocess.run(
        [sys.executable, "-c", LEAN_PROBE, ROOT], cwd=ROOT, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _run_smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, timeout=120,
    )


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_refuses_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
