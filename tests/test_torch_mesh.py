"""Data-parallel serving in the port: the cases of tests/test_mesh_serving.py.

The port's mesh is a list of devices, one per contiguous batch shard
(misaka_tpu_torch/parallel/mesh.py); here every shard lives on the CPU, as
the JAX package's tests run an 8-device virtual CPU mesh (tests/conftest.py).

- The DP runner over 2 CPU shards against the JAX `_make_dp_fused_runner`
  (the Pallas kernel under shard_map, in interpret mode, data_parallel=2,
  B=256) from one seeded state with random hi planes: every field exact.
- shard_state / gather_state: exact inverses, shards in `P("data")` order,
  every part an owned copy.
- The master on a mesh: the DP cases of test_mesh_serving.py, /status
  `mesh`, the refusals (batch % D, lanes % M, too few cards, the kernel
  under model parallel) and the model-parallel boots, held against the
  JAX mesh master (tests/test_torch_mesh_mp.py serves them).
  tests/test_torch_mesh_jax.py serves beside the JAX mesh master, and
  tests/test_torch_mesh_checkpoint.py moves checkpoints between the two.

Every comparison is exact: the state is all integers.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from misaka_tpu import networks as jnetworks
from misaka_tpu.runtime.master import MasterNode as JMaster
from misaka_tpu.runtime.topology import Topology as JTopology
from misaka_tpu_torch import networks
from misaka_tpu_torch.core import fused
from misaka_tpu_torch.core.state import NetworkState, state_from_numpy, state_to_numpy
from misaka_tpu_torch.parallel.mesh import (
    ShardedNetwork,
    gather_state,
    make_mesh,
    shard_state,
)
from misaka_tpu_torch.runtime import app
from misaka_tpu_torch.runtime.master import MasterNode
from misaka_tpu_torch.runtime.topology import Topology

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
CAPS = dict(in_cap=8, out_cap=8, stack_cap=8)


def example(name):
    with open(os.path.join(EXAMPLES, f"{name}.json")) as f:
        return f.read()


def seeded_state(net, rng, n_inputs=6):
    """Queued inputs (with a 0 now and then) and random hi planes."""
    s = state_to_numpy(net.init_state())
    vals = rng.integers(-1000, 1000, size=(net.batch, n_inputs))
    vals[rng.random(vals.shape) < 0.2] = 0
    s["in_buf"][:, :n_inputs] = vals
    s["in_wr"][:] = n_inputs
    for f in ("acc_hi", "bak_hi"):
        s[f] = rng.integers(-(2**31), 2**31, size=s[f].shape).astype(np.int32)
    return s


def assert_fields_equal(got: dict, want: dict):
    for f in NetworkState._fields:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


# --- the runner --------------------------------------------------------------


def test_dp_runner_matches_the_jax_dp_fused_runner():
    """reverse_any (stack, branch, IN/OUT) over 2 shards of 128: the port's
    runner against the Pallas kernel under shard_map, interpret mode."""
    text, steps = example("reverse_any"), 16
    jm = JMaster(JTopology.from_json(text, **CAPS), chunk_steps=steps, batch=256,
                 data_parallel=2, engine="fused-interpret")
    tn = Topology.from_json(text, **CAPS).compile(batch=256, device="cpu")
    entry = seeded_state(tn, np.random.default_rng(11))
    jstate = jm._shard(jm._net.init_state()._replace(
        **{f: jnp.asarray(v) for f, v in entry.items()}))
    jout = jm._runner(jstate)
    jout = {f: np.asarray(getattr(jout, f)) for f in jout._fields}

    mesh = make_mesh(2, "cpu")
    run = ShardedNetwork(tn, mesh).fused_runner(steps)
    before = dict(fused.launch_counts)
    shards = shard_state(state_from_numpy(entry), mesh)
    got = state_to_numpy(gather_state(run(shards)))
    assert fused.launch_counts == before  # CPU shards: the plain version, no launch
    assert run.variant == fused.KERNEL
    assert_fields_equal(got, jout)
    assert_fields_equal(got, state_to_numpy(tn.run(state_from_numpy(entry), steps)))
    assert_fields_equal(state_to_numpy(gather_state(shards)), entry)  # input untouched
    assert got["out_wr"].max() > 0 and got["stack_top"].max() > 0


@pytest.mark.parametrize("elide", [False, True])
def test_dp_runner_equals_one_whole_batch_run(elide):
    """mesh8 over 4 shards: gathered, the shards are the whole batch's run."""
    tn = networks.mesh8(**CAPS).compile(batch=16, device="cpu")
    entry = seeded_state(tn, np.random.default_rng(3))
    mesh = make_mesh(4, "cpu")
    run = ShardedNetwork(tn, mesh).fused_runner(40, elide_dead_hi=elide)
    got = state_to_numpy(gather_state(run(shard_state(state_from_numpy(entry), mesh))))
    assert_fields_equal(got, state_to_numpy(tn.run(state_from_numpy(entry), 40)))
    mask = fused.hi_live_mask(tn.code, tn.prog_len) if elide else None
    assert run.variant == fused.variant(mask, tn.num_lanes)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_shard_and_gather_are_inverse_and_own_their_storage(d):
    tn = networks.sorter(**CAPS).compile(batch=8, device="cpu")
    state = state_from_numpy(seeded_state(tn, np.random.default_rng(d)))
    mesh = make_mesh(d, "cpu")
    assert mesh.shape == {"data": d, "model": 1}
    shards = shard_state(state, mesh)
    b = 8 // d
    for i, shard in enumerate(shards):  # P("data") order: slot j on shard j // b
        for f, part, whole in zip(NetworkState._fields, shard, state):
            assert torch.equal(part, whole[i * b:(i + 1) * b]), f
            assert part.untyped_storage().data_ptr() != whole.untyped_storage().data_ptr()
    back = gather_state(shards)
    assert all(torch.equal(a, w) for a, w in zip(back, state))
    for a, w in zip(back, state):
        assert a.untyped_storage().data_ptr() != w.untyped_storage().data_ptr()
    shards[0].acc.fill_(123)
    assert not bool((back.acc == 123).any()) and not bool((state.acc == 123).any())


def test_make_mesh_refusals():
    with pytest.raises(ValueError, match="n_devices >= 1"):
        make_mesh(0, "cpu")
    with pytest.raises(ValueError, match="1 devices given for a mesh of 2"):
        make_mesh(2, ["cpu"])
    assert make_mesh(2, ["cpu", "cpu"]).devices == (torch.device("cpu"),) * 2
    # more cards than the host has: no card here (RuntimeError), too few on
    # a card's host (ValueError)
    with pytest.raises((RuntimeError, ValueError)):
        make_mesh(torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="not divisible"):
        ShardedNetwork(networks.add2(**CAPS).compile(batch=6, device="cpu"), make_mesh(4, "cpu"))


# --- the master on a mesh ----------------------------------------------------


def test_data_parallel_serving_parity():
    master = MasterNode(networks.add2(**CAPS), chunk_steps=32, batch=16, device="cpu",
                        data_parallel=8)
    assert master.status()["mesh"] == {"data": 8, "model": 1}
    master.run()
    try:
        vals = list(range(-20, 80))
        assert master.compute_spread(vals, timeout=60) == [v + 2 for v in vals]
        assert master.compute(7, timeout=60) == 9
        assert master.compute_coalesced(vals, timeout=60) == [v + 2 for v in vals]
    finally:
        master.close()


def test_mesh_serving_lifecycle():
    """reset / load keep working on a mesh (the state stays sharded)."""
    master = MasterNode(networks.add2(**CAPS), chunk_steps=32, batch=8, device="cpu",
                        data_parallel=4)
    master.run()
    try:
        assert master.compute(1, timeout=60) == 3
    finally:
        master.pause()
    master.reset()
    assert master.status()["tick"] == 0 and len(master._state) == 4
    master.load("misaka1", "IN ACC\nADD 10\nOUT ACC")
    master.run()
    try:
        assert master.compute(1, timeout=60) == 11
        assert [s.pc.shape[0] for s in master._state] == [2] * 4
    finally:
        master.close()


def test_mesh_checkpoint_roundtrip(tmp_path):
    def fresh():
        return MasterNode(networks.add2(**CAPS), chunk_steps=32, batch=8, device="cpu",
                          data_parallel=4)

    master = fresh()
    master.run()
    try:
        assert master.compute(7, timeout=60) == 9
    finally:
        master.close()
    path = str(tmp_path / "mesh.npz")
    master.save_checkpoint(path)
    m2 = fresh()
    m2.load_checkpoint(path)
    assert_fields_equal(state_to_numpy(m2.snapshot()), state_to_numpy(master.snapshot()))
    m2.run()
    try:
        assert m2.compute(100, timeout=60) == 102
    finally:
        m2.close()


def test_mesh_requires_divisibility_and_refuses_model_parallel():
    with pytest.raises(ValueError, match="not divisible by data_parallel=8"):
        MasterNode(networks.add2(), batch=1, device="cpu", data_parallel=8)
    with pytest.raises(ValueError, match="mesh serving requires batch=N"):
        MasterNode(networks.add2(), device="cpu", data_parallel=8)  # unbatched
    with pytest.raises(ValueError, match="batch 3 not divisible by data_parallel=2"):
        MasterNode(networks.add2(), batch=3, device="cpu", data_parallel=2)
    with pytest.raises(ValueError, match="2 lanes not divisible by model_parallel=8"):
        MasterNode(networks.add2(), batch=2, device="cpu", model_parallel=8)
    with pytest.raises(ValueError, match="routed engine"):
        MasterNode(networks.add2(), batch=2, device="cpu", model_parallel=2, engine="fused")
    # model_parallel=2 boots, as the JAX mesh master does
    mp = MasterNode(networks.add2(**CAPS), batch=2, device="cpu", model_parallel=2)
    jmp = JMaster(jnetworks.add2(**CAPS), batch=2, model_parallel=2)
    try:
        assert mp.engine_name == jmp.engine_name == "routed"
        assert mp.status()["mesh"] == jmp.status()["mesh"] == {"data": 1, "model": 2}
        assert [s.pc.shape for s in mp._state] == [(2, 1), (2, 1)]
    finally:
        mp.close()
        jmp.close()
    plain = MasterNode(networks.add2(**CAPS), batch=2, device="cpu")
    assert "mesh" not in plain.status()
    # model_parallel=1 alone is a mesh of one, as in the reference
    one = MasterNode(networks.add2(**CAPS), batch=2, device="cpu", model_parallel=1)
    assert one.status()["mesh"] == {"data": 1, "model": 1}


ENV_NODES = json.dumps({
    "misaka1": {"type": "program"}, "misaka2": {"type": "program"},
    "misaka3": {"type": "stack"},
})
ENV_PROGRAMS = json.dumps({
    "misaka1": "IN ACC\nADD 1\nMOV ACC, misaka2:R0\nMOV R0, ACC\nOUT ACC",
    "misaka2": "MOV R0, ACC\nADD 1\nPUSH ACC, misaka3\nPOP misaka3, ACC\nMOV ACC, misaka1:R0",
})


def test_mesh_env_surface():
    """app.py's MISAKA_DATA_PARALLEL reaches the mesh master."""
    env = {"NODE_INFO": ENV_NODES, "MISAKA_PROGRAMS": ENV_PROGRAMS, "MISAKA_BATCH": "8",
           "MISAKA_CHUNK_STEPS": "32", "MISAKA_DEVICE": "cpu", "MISAKA_DATA_PARALLEL": "2"}
    master = app.build_master_from_env(env)
    assert master.status()["mesh"] == {"data": 2, "model": 1}
    master.run()
    try:
        assert master.compute(5, timeout=60) == 7
    finally:
        master.close()


@pytest.mark.parametrize("extra,error", [
    pytest.param({"MISAKA_DEVICE": "cpu", "MISAKA_MODEL_PARALLEL": "2"}, None,
                 id="extra0-NotImplementedError"),
    pytest.param({"MISAKA_DEVICE": "cpu", "MISAKA_DATA_PARALLEL": "3"}, ValueError,  # 8 % 3
                 id="extra1-ValueError"),
])
def test_mesh_env_refusals_at_boot(extra, error):
    """MISAKA_DATA_PARALLEL that does not divide the batch refuses to boot;
    MISAKA_MODEL_PARALLEL=2 boots the routed mesh master (its two lanes one
    per shard) and answers as the JAX one does."""
    env = {"NODE_INFO": ENV_NODES, "MISAKA_PROGRAMS": ENV_PROGRAMS, "MISAKA_BATCH": "8", **extra}
    if error is not None:
        with pytest.raises(error):
            app.build_master_from_env(env)
        return
    master = app.build_master_from_env({**env, "MISAKA_CHUNK_STEPS": "32"})
    jm = JMaster(JTopology.from_node_info_json(ENV_NODES, json.loads(ENV_PROGRAMS)),
                 chunk_steps=32, batch=8, model_parallel=2)
    try:
        assert master.status()["mesh"] == jm.status()["mesh"] == {"data": 1, "model": 2}
        assert master.engine_name == jm.engine_name == "routed"
        master.run()
        jm.run()
        vals = [5, -3, 40, 0]
        assert master.compute_many(vals, timeout=60) == [
            int(v) for v in jm.compute_many(vals, timeout=60)] == [v + 2 for v in vals]
    finally:
        master.close()
        jm.close()


def test_mesh_env_needs_the_cards_it_names():
    """MISAKA_DATA_PARALLEL without MISAKA_DEVICE=cpu asks for that many
    cards: more than the host has refuses to boot (never the CPU)."""
    n = torch.cuda.device_count() + 1
    env = {"NODE_INFO": ENV_NODES, "MISAKA_PROGRAMS": ENV_PROGRAMS, "MISAKA_BATCH": str(2 * n),
           "MISAKA_DATA_PARALLEL": str(n)}
    with pytest.raises((RuntimeError, ValueError)):
        app.build_master_from_env(env)
