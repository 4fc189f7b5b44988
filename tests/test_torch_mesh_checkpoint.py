"""Checkpoints across packages and shard counts at the same batch.

A checkpoint holds the global [B, ...] arrays in shard order, with
`batch` = B in its manifest, as the JAX mesh master writes them.  So a
JAX D=4 checkpoint loads into the port at D=2, D=1 and off a mesh, and a
port D=2 checkpoint into the JAX master at D=4 and the port at D=1: the
installed state equals the saved one field by field, and both masters go on
answering alike.  A restore onto a mesh installs owned shards.

running_total keeps a total per instance, so every comparison is of real,
stateful state.
"""

import numpy as np
import pytest
import torch

from misaka_tpu.runtime.master import MasterNode as JMaster
from misaka_tpu.runtime.topology import Topology as JTopology
from misaka_tpu_torch.core.state import state_from_numpy, state_to_numpy
from misaka_tpu_torch.runtime.master import MasterNode
from misaka_tpu_torch.runtime.topology import Topology
from tests.test_torch_checkpoint import (
    CAPS,
    assert_fields_equal,
    jax_fields,
    running_total_text,
    serve_some,
)

torch.set_num_threads(1)

BATCH = 8


def jax_mesh_master():
    return JMaster(JTopology.from_json(running_total_text(), **CAPS), chunk_steps=32,
                   batch=BATCH, data_parallel=4, engine="scan")


def port_master(d):
    return MasterNode(Topology.from_json(running_total_text(), **CAPS), chunk_steps=32,
                      batch=BATCH, device="cpu", data_parallel=d)


def same_answers(a, b):
    """Both masters, run from their installed states, answer one striped
    stream alike (compute_spread takes free slots from slot 0 up)."""
    a.run()
    b.run()
    vals = np.arange(1, 41, dtype=np.int32)
    assert a.compute_spread(vals, timeout=60) == b.compute_spread(vals, timeout=60)


@pytest.mark.parametrize("d", [2, 1, None])
def test_jax_d4_checkpoint_loads_into_the_port(tmp_path, d):
    jm, tm = jax_mesh_master(), port_master(d)
    try:
        serve_some(jm, 1)
        path = str(tmp_path / "jax_d4.npz")
        jm.save_checkpoint(path)
        tm.load_checkpoint(path)
        assert not tm.is_running
        assert_fields_equal(state_to_numpy(tm.snapshot()), jax_fields(jm.snapshot()))
        if d is not None:
            assert len(tm._state) == d and tm.status()["mesh"] == {"data": d, "model": 1}
        same_answers(tm, jm)
    finally:
        jm.close()
        tm.close()


@pytest.mark.parametrize("target", ["jax_d4", "port_d1"])
def test_port_d2_checkpoint_loads_elsewhere(tmp_path, target):
    tm = port_master(2)
    other = jax_mesh_master() if target == "jax_d4" else port_master(1)
    try:
        serve_some(tm, 2)
        path = str(tmp_path / "port_d2.npz")
        tm.save_checkpoint(path)
        with np.load(path) as data:
            assert data["acc"].shape[0] == BATCH and data["holding"].dtype == bool
        other.load_checkpoint(path)
        snap = other.snapshot()
        got = jax_fields(snap) if target == "jax_d4" else state_to_numpy(snap)
        assert_fields_equal(got, state_to_numpy(tm.snapshot()))
        same_answers(other, tm)
    finally:
        tm.close()
        other.close()


def test_restore_onto_a_mesh_installs_owned_shards():
    m2, m1 = port_master(2), port_master(None)
    try:
        serve_some(m1, 3)
        snap = m1.snapshot()  # off-mesh state, restored onto the mesh
        m2.restore(snap)
        assert_fields_equal(state_to_numpy(m2.snapshot()), state_to_numpy(snap))
        for shard in m2._state:
            for a, b in zip(shard, snap):
                assert a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
        arrays = state_to_numpy(m2.snapshot())
        m2.restore(state_from_numpy(arrays))
        arrays["acc"][:] = 7  # the caller's arrays stay theirs
        assert all(int(s.acc.abs().sum()) != 7 * s.acc.numel() for s in m2._state)
        m1.restore(m2.snapshot())  # and back off the mesh
        assert_fields_equal(state_to_numpy(m1.snapshot()), state_to_numpy(m2.snapshot()))
        same_answers(m1, m2)
    finally:
        m1.close()
        m2.close()
