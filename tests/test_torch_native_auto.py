"""engine="auto" flips to the host C++ tier on the CPU, as the JAX package's.

The reference's MasterNode serves `auto` through its native tier whenever
no TPU is attached (misaka_tpu/runtime/master.py `_use_native_auto`); the
port's test is the engine's device: `auto` on the CPU flips, on a card it
never does (the card's main path stays the fused kernel).

- The predicate: the port's `_use_native_auto` and the reference's, called
  on the same configuration, agree on every condition (trace, mesh,
  MISAKA_NATIVE_AUTO, an interpreter that does not build, the batch against
  MISAKA_NATIVE_AUTO_MAX_BATCH on both sides of its edge, unbatched); on a
  `cuda` device (or None, the card) the port's is false whatever the rest.
- Masters: `auto` on the CPU reports the native engine batched and
  unbatched and answers as the JAX master does; MISAKA_NATIVE_AUTO=0, a
  batch over the cap, a trace and engine="scan" keep the plain loop.
- State across packages: a `.npz` checkpoint of a native-auto port master
  loads in the JAX master (itself on its native tier here) and back, and
  both continue its running total.
"""

import os
import types

import numpy as np
import pytest
import torch

from misaka_tpu import networks as jnet
from misaka_tpu.core import native_serve as jnative_serve
from misaka_tpu.runtime.master import MasterNode as JMaster
from misaka_tpu.runtime.topology import Topology as JTopology
from misaka_tpu_torch import networks as tnet
from misaka_tpu_torch.core import native_serve as tnative_serve
from misaka_tpu_torch.runtime.master import MasterNode as TMaster
from misaka_tpu_torch.runtime.topology import Topology as TTopology
from tests.torch_native_helpers import every_handle_closed, small_pools  # noqa: F401

torch.set_num_threads(1)

CAPS = dict(in_cap=8, out_cap=8, stack_cap=8)
RUNNING_TOTAL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "examples", "running_total.json")

# (label, trace_cap, mesh, batch, env, interpreter builds)
CASES = [
    ("batched", None, None, 4, {}, True),
    ("unbatched", None, None, None, {}, True),
    ("traced", 8, None, 4, {}, True),
    ("traced_unbatched", 8, None, None, {}, True),
    ("mesh", None, object(), 4, {}, True),
    ("auto_off", None, None, 4, {"MISAKA_NATIVE_AUTO": "0"}, True),
    ("auto_on", None, None, 4, {"MISAKA_NATIVE_AUTO": "1"}, True),
    ("auto_off_unbatched", None, None, None, {"MISAKA_NATIVE_AUTO": "0"}, True),
    ("no_toolchain", None, None, 4, {}, False),
    ("default_cap_edge", None, None, 4096, {}, True),
    ("default_cap_over", None, None, 4097, {}, True),
    ("cap_edge", None, None, 16, {"MISAKA_NATIVE_AUTO_MAX_BATCH": "16"}, True),
    ("cap_over", None, None, 17, {"MISAKA_NATIVE_AUTO_MAX_BATCH": "16"}, True),
    ("cap_empty", None, None, 4096, {"MISAKA_NATIVE_AUTO_MAX_BATCH": ""}, True),
    ("cap_unbatched", None, None, None, {"MISAKA_NATIVE_AUTO_MAX_BATCH": "1"}, True),
]
WANT = {"batched": True, "unbatched": True, "auto_on": True, "default_cap_edge": True,
        "cap_edge": True, "cap_empty": True, "cap_unbatched": True}


def _arrange(monkeypatch, env, builds):
    for name in ("MISAKA_NATIVE_AUTO", "MISAKA_NATIVE_AUTO_MAX_BATCH"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    if not builds:
        monkeypatch.setattr(jnative_serve, "available", lambda: False)
        monkeypatch.setattr(tnative_serve, "available", lambda: False)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_predicate_matches_the_reference(monkeypatch, case):
    label, trace_cap, mesh, batch, env, builds = case
    _arrange(monkeypatch, env, builds)
    jself = types.SimpleNamespace(_trace_cap=trace_cap, _mesh=mesh, _batch=batch)
    tself = types.SimpleNamespace(_trace_cap=trace_cap, _mesh=mesh, _batch=batch, _device="cpu")
    want = JMaster._use_native_auto(jself)
    assert TMaster._use_native_auto(tself) is want
    assert want is WANT.get(label, False)


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0", torch.device("cuda")],
                         ids=["card", "cuda", "cuda0", "torch_cuda"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_a_card_never_flips(monkeypatch, case, device):
    label, trace_cap, mesh, batch, env, builds = case
    _arrange(monkeypatch, env, builds)
    tself = types.SimpleNamespace(_trace_cap=trace_cap, _mesh=mesh, _batch=batch, _device=device)
    assert TMaster._use_native_auto(tself) is False


@pytest.mark.parametrize("batch", [None, 4], ids=["unbatched", "batched"])
def test_auto_on_the_cpu_serves_native_like_jax(batch):
    jm = JMaster(jnet.add2(**CAPS), chunk_steps=16, batch=batch)
    tm = TMaster(tnet.add2(**CAPS), chunk_steps=16, batch=batch, device="cpu")
    try:
        assert getattr(jm._runner, "is_native", False)  # the reference flipped too
        assert tm.engine_name == tm.status()["engine"] == "native"
        assert tm.status()["device"] == "cpu"
        for m in (jm, tm):
            m.run()
        vals = list(range(-20, 20))
        assert tm.compute_many(vals) == jm.compute_many(vals) == [v + 2 for v in vals]
        assert all(n == 0 for n in tm.status()["kernel_launches"].values())
    finally:
        jm.close()
        tm.close()


@pytest.mark.parametrize("kw, env", [
    ({"engine": "scan"}, {}),
    ({}, {"MISAKA_NATIVE_AUTO": "0"}),
    ({}, {"MISAKA_NATIVE_AUTO_MAX_BATCH": "2"}),
    ({"trace_cap": 16}, {}),
], ids=["scan", "auto_off", "over_cap", "traced"])
def test_what_keeps_the_plain_loop(monkeypatch, kw, env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    m = TMaster(tnet.add2(**CAPS), chunk_steps=16, batch=4, device="cpu", **kw)
    try:
        assert m.engine_name == ("plain-traced" if "trace_cap" in kw else "plain")
        m.run()
        assert m.compute_many([1, 2, 3]) == [3, 4, 5]
    finally:
        m.close()


def _running_total(pkg):
    with open(RUNNING_TOTAL) as f:
        text = f.read()
    if pkg == "jax":
        return JMaster(JTopology.from_json(text, **CAPS), chunk_steps=16)
    return TMaster(TTopology.from_json(text, **CAPS), chunk_steps=16, device="cpu")


def test_native_auto_checkpoints_load_in_the_jax_master_and_back(tmp_path):
    """One instance's running total, carried port (native) -> JAX -> port."""
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    tm = _running_total("port")
    try:
        assert tm.engine_name == "native"
        tm.run()
        assert tm.compute_many([5], timeout=30) == [5]
        assert tm.compute_many([3], timeout=30) == [8]
        tm.pause()
        tm.save_checkpoint(a)
        want = tm.status()
    finally:
        tm.close()
    jm = _running_total("jax")
    try:
        jm.load_checkpoint(a)
        got = jm.status()
        for key in ("tick", "retired_per_lane", "stack_depth"):
            assert np.array_equal(np.asarray(got[key]), np.asarray(want[key])), key
        jm.run()
        assert jm.compute_many([10], timeout=30) == [18]
        jm.pause()
        jm.save_checkpoint(b)
    finally:
        jm.close()
    tm = _running_total("port")
    try:
        tm.load_checkpoint(b)
        assert tm.engine_name == "native"
        tm.run()
        assert tm.compute_many([2], timeout=30) == [20]
    finally:
        tm.close()
