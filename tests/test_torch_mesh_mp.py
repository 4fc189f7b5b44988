"""Model-parallel serving in the port: the cases of tests/test_mesh_serving.py.

`MasterNode(device="cpu", model_parallel=M)` lane-shards every instance over
M CPU shards (parallel/mesh.py), agreeing every tick through core/axis.py's
collectives; the JAX mesh master runs the same network on the 8-device
virtual CPU mesh of tests/conftest.py.  Both answer the same requests:

- /compute, /compute_raw (striped and pinned) and /compute_batch over HTTP
  for M in {2, 4, 8} and dp2 x mp4, on the routed and the gather engine;
  `engine_name` and /status `mesh` equal;
- dp x mp on ring4, lifecycle (reset, /load, which rebuilds the route
  table), stack autogrow under mp, the env surface;
- a checkpoint written by one package restores in the other's master at
  mp 8 -> 1 -> 8 with every field equal;
- the model replicas of the stacks and rings stay equal after serving and
  after autogrow.
"""

import json

import numpy as np
import pytest
import torch

from misaka_tpu import networks as jnetworks
from misaka_tpu.runtime.master import MasterNode as JMaster
from misaka_tpu.runtime.master import make_http_server as j_http
from misaka_tpu.runtime.topology import Topology as JTopology
from misaka_tpu_torch import networks
from misaka_tpu_torch.core.state import NetworkState, state_to_numpy
from misaka_tpu_torch.parallel.mesh import replicas_agree
from misaka_tpu_torch.runtime import app
from misaka_tpu_torch.runtime.master import MasterNode
from misaka_tpu_torch.runtime.master import make_http_server as t_http
from misaka_tpu_torch.runtime.topology import Topology
from tests.test_torch_master import form, request, serve

torch.set_num_threads(1)

CAPS = dict(in_cap=8, out_cap=8, stack_cap=8)


@pytest.fixture(autouse=True)
def _no_daemons(monkeypatch):
    # the servers' process-global daemons would outlive a test in its worker
    for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG"):
        monkeypatch.setenv(switch, "0")


def jax_state(master):
    s = master.snapshot()
    return {f: np.asarray(getattr(s, f)) for f in s._fields}


def assert_fields_equal(got, want):
    for f in NetworkState._fields:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def assert_replicas_equal(master):
    with master._state_lock:
        assert replicas_agree(master._state, master._mesh) == []


@pytest.mark.parametrize("engine,mp,dp", [
    ("routed", 2, 1), ("routed", 4, 1), ("routed", 8, 1), ("routed", 4, 2),
    ("gather", 4, 2), ("gather", 8, 1),
])
def test_http_answers_match_the_jax_mesh_master(engine, mp, dp):
    """mesh8 (8 lanes, 2 stacks: every MOV, stack and ring op crosses
    shards) served over HTTP by both masters on [dp, mp] meshes."""
    kw = dict(chunk_steps=32, batch=2 * dp, data_parallel=dp, model_parallel=mp,
              engine="gather" if engine == "gather" else "auto")
    jm = JMaster(jnetworks.mesh8(**CAPS), **kw)
    tm = MasterNode(networks.mesh8(**CAPS), device="cpu", **kw)
    assert tm.engine_name == jm.engine_name == engine
    assert tm.status()["mesh"] == jm.status()["mesh"] == {"data": dp, "model": mp}
    jh, th = j_http(jm, port=0), t_http(tm, port=0)
    jb, tb = serve(jh), serve(th)
    rng = np.random.default_rng(mp * 10 + dp)
    raw = rng.integers(-1000, 1000, size=12).astype("<i4")
    try:
        for path, body in [
            ("/run", b""),
            *[("/compute", form(value=str(v))) for v in (0, 5, -3, 100)],
            ("/compute_raw", raw.tobytes()),
            ("/compute_raw?spread=0", raw[:5].tobytes()),
            ("/compute_batch", form(values=" ".join(map(str, raw[:7])))),
        ]:
            want = request(jb, path, body)
            got = request(tb, path, body)
            assert got == want, (path, got, want)
            if path == "/compute_raw":
                assert np.frombuffer(got[2], "<i4").tolist() == (raw + 4).tolist()
        js = json.loads(request(jb, "/status", method="GET")[2])
        ts = json.loads(request(tb, "/status", method="GET")[2])
        for key in ("engine", "mesh", "nodes", "stack_cap", "batch"):
            assert ts[key] == js[key], key
        assert_replicas_equal(tm)
    finally:
        for h, m in ((jh, jm), (th, tm)):
            h.shutdown()
            h.server_close()
            m.close()


def test_dp_x_mp_combined_like_jax():
    """ring4: 4 lanes over model=4, batch 4 over data=2, the striped lane
    (every value laps the ring: v + 4)."""
    kw = dict(chunk_steps=64, batch=4, data_parallel=2, model_parallel=4)
    jm = JMaster(jnetworks.ring(4, **CAPS), **kw)
    tm = MasterNode(networks.ring(4, **CAPS), device="cpu", **kw)
    vals = list(range(12))
    try:
        jm.run()
        want = [int(v) for v in jm.compute_spread(vals, timeout=60)]
    finally:
        jm.close()
    tm.run()
    try:
        assert tm.compute_spread(vals, timeout=60) == want == [v + 4 for v in vals]
        assert [s.pc.shape for s in tm._state] == [(2, 1)] * 8
    finally:
        tm.close()


def test_lifecycle_and_load_rebuild_the_route_table():
    """reset and /load under mp=4: /load recompiles the routed runner, so
    ring0's removed send slot is gone from the new route table (the JAX
    master's test_mesh_mp_load_rebuilds_route_table)."""
    kw = dict(chunk_steps=64, batch=2, model_parallel=4)
    tm = MasterNode(networks.ring(4, **CAPS), device="cpu", **kw)
    jm = JMaster(jnetworks.ring(4, **CAPS), **kw)
    old = tm._net.lane_runner(64)
    tm.run()
    try:
        assert tm.compute(5, timeout=60) == 9
    finally:
        tm.pause()
    tm.reset()
    assert tm.status()["tick"] == 0 and len(tm._state) == 4
    program = "IN ACC\nADD 10\nOUT ACC"
    tm.load("ring0", program)
    jm.load("ring0", program)
    assert tm._net.lane_runner(64) is not old
    tm.run()
    jm.run()
    try:
        assert tm.engine_name == jm.engine_name == "routed"
        for v in (5, -7):
            assert tm.compute(v, timeout=60) == jm.compute(v, timeout=60) == v + 10
        assert_replicas_equal(tm)
    finally:
        tm.close()
        jm.close()


AUTOGROW = dict(
    node_info={"p": "program", "q": "program", "st": "stack"},
    programs={
        # p pushes until the 0 sentinel, then emits it and drains the
        # stack: 12 values wedge a stack of 8
        "p": ("top: IN ACC\nJEZ dump\nPUSH ACC, st\nJMP top\n"
              "dump: OUT ACC\npop: POP st, ACC\nOUT ACC\nJMP pop\n"),
        "q": "NOP\n",  # a second lane, so the lanes shard over mp=2
    },
    in_cap=32, out_cap=32, stack_cap=8,
)


def test_autogrow_under_model_parallel_like_jax():
    """A full stack under mp=2: both masters double stack_cap and answer
    the reversal; every shard's replica of the stack grows alike."""
    jm = JMaster(JTopology(**AUTOGROW), chunk_steps=32, batch=2, model_parallel=2)
    tm = MasterNode(Topology(**AUTOGROW), chunk_steps=32, batch=2, device="cpu",
                    model_parallel=2)
    vals = list(range(1, 13))
    try:
        jm.run()
        want = [int(v) for v in jm.compute_many(vals + [0], timeout=90)]
        jcap = jm.status()["stack_cap"]
    finally:
        jm.close()
    tm.run()
    try:
        assert tm.compute_many(vals + [0], timeout=90) == want == [0] + vals[::-1]
        assert tm.status()["stack_cap"] == jcap >= 16
        assert tm.engine_name == "routed"
        assert [s.stack_mem.shape[-1] for s in tm._state] == [jcap] * 2
        assert_replicas_equal(tm)
    finally:
        tm.close()


def test_checkpoint_crosses_packages_at_mp_8_1_8(tmp_path):
    """The port's mp=8 master checkpoints; the JAX master at mp=1 restores
    it (every field equal) and serves on, then checkpoints; the port's
    mp=8 master restores that one (every field equal) and serves on."""
    top = networks.mesh8(**CAPS)
    t8 = MasterNode(top, chunk_steps=32, batch=2, device="cpu", model_parallel=8)
    t8.run()
    try:
        assert t8.compute(7, timeout=60) == 11
    finally:
        t8.pause()
    a = str(tmp_path / "port_mp8.npz")
    t8.save_checkpoint(a)
    saved = state_to_numpy(t8.snapshot())
    j1 = JMaster(jnetworks.mesh8(**CAPS), chunk_steps=32, batch=2, engine="scan")
    j1.load_checkpoint(a)
    assert_fields_equal(jax_state(j1), saved)
    j1.run()
    try:
        assert int(j1.compute(20, timeout=60)) == 24
    finally:
        j1.pause()
    b = str(tmp_path / "jax_mp1.npz")
    j1.save_checkpoint(b)
    jsaved = jax_state(j1)
    j1.close()
    t8b = MasterNode(top, chunk_steps=32, batch=2, device="cpu", model_parallel=8)
    t8b.load_checkpoint(b)
    assert_fields_equal(state_to_numpy(t8b.snapshot()), jsaved)
    t8b.run()
    try:
        assert t8b.compute(100, timeout=60) == 104
        assert_replicas_equal(t8b)
    finally:
        t8b.close()
        t8.close()


def test_snapshot_restore_under_model_parallel():
    """snapshot() gathers the lane shards into the global arrays; restore()
    cuts them again, replicas equal."""
    tm = MasterNode(networks.mesh8(**CAPS), chunk_steps=32, batch=4, device="cpu",
                    data_parallel=2, model_parallel=4)
    tm.run()
    try:
        assert tm.compute_spread([1, 2, 3, 4], timeout=60) == [5, 6, 7, 8]
    finally:
        tm.pause()
    snap = tm.snapshot()
    assert snap.pc.shape == (4, 8) and snap.stack_mem.shape == (4, 2, 8)
    tm.reset()
    tm.restore(snap)
    assert_fields_equal(state_to_numpy(tm.snapshot()), state_to_numpy(snap))
    assert_replicas_equal(tm)
    tm.run()
    try:
        assert tm.compute(9, timeout=60) == 13
    finally:
        tm.close()


ENV_NODES = json.dumps({
    "misaka1": {"type": "program"}, "misaka2": {"type": "program"},
    "misaka3": {"type": "stack"},
})
ENV_PROGRAMS = json.dumps({
    "misaka1": "IN ACC\nADD 1\nMOV ACC, misaka2:R0\nMOV R0, ACC\nOUT ACC",
    "misaka2": "MOV R0, ACC\nADD 1\nPUSH ACC, misaka3\nPOP misaka3, ACC\nMOV ACC, misaka1:R0",
})


@pytest.mark.parametrize("engine", ["auto", "gather"])
def test_env_surface_reaches_the_mesh(engine):
    """MISAKA_DATA_PARALLEL x MISAKA_MODEL_PARALLEL (and MISAKA_ENGINE)
    reach status()["mesh"] and engine_name, as in the JAX app."""
    env = {"NODE_INFO": ENV_NODES, "MISAKA_PROGRAMS": ENV_PROGRAMS, "MISAKA_BATCH": "8",
           "MISAKA_CHUNK_STEPS": "32", "MISAKA_DEVICE": "cpu", "MISAKA_DATA_PARALLEL": "2",
           "MISAKA_MODEL_PARALLEL": "2", "MISAKA_ENGINE": engine}
    master = app.build_master_from_env(env)
    jm = JMaster(JTopology.from_node_info_json(ENV_NODES, json.loads(ENV_PROGRAMS)),
                 chunk_steps=32, batch=8, data_parallel=2, model_parallel=2, engine=engine)
    try:
        assert master.status()["mesh"] == jm.status()["mesh"] == {"data": 2, "model": 2}
        assert master.engine_name == jm.engine_name == (
            "gather" if engine == "gather" else "routed")
        master.run()
        assert master.compute(5, timeout=60) == 7
    finally:
        master.close()
        jm.close()


def test_refusals_under_model_parallel():
    with pytest.raises(ValueError, match="lanes not divisible"):
        MasterNode(networks.add2(), batch=2, device="cpu", model_parallel=8)
    with pytest.raises(ValueError, match="routed engine"):
        MasterNode(networks.mesh8(), batch=2, device="cpu", model_parallel=2, engine="fused")
    with pytest.raises(ValueError, match="routed engine"):
        JMaster(jnetworks.mesh8(), batch=2, model_parallel=2, engine="fused")
    with pytest.raises(ValueError, match="single-chip"):
        MasterNode(networks.mesh8(), batch=2, device="cpu", model_parallel=2, trace_cap=16)
    with pytest.raises(ValueError, match="requires batch"):
        MasterNode(networks.mesh8(), device="cpu", model_parallel=2)
    if torch.cuda.device_count() < 8:
        # the card by default: D*M distinct cards, never the CPU (no card
        # here: RuntimeError; too few on a card's host: ValueError)
        with pytest.raises((RuntimeError, ValueError)):
            MasterNode(networks.mesh8(), batch=2, model_parallel=8)
