"""The port's mesh master served beside the JAX mesh master.

One caller's requests on running_total (a total per instance, so every
answer depends on which instance a value lands on) and a stack autogrow
under D=2 must give the JAX mesh master's outputs exactly.  Both run on
CPU shards: the port's on its CPU mesh, the JAX package's on the
8-device virtual CPU mesh of tests/conftest.py (its scan engine, which
tests/oracle.py holds equal to the kernel).
"""

import numpy as np
import torch

from misaka_tpu.runtime.master import MasterNode as JMaster
from misaka_tpu.runtime.topology import Topology as JTopology
from misaka_tpu_torch.runtime.master import MasterNode
from misaka_tpu_torch.runtime.topology import Topology
from tests.test_torch_mesh import CAPS, example

torch.set_num_threads(1)


def test_single_caller_outputs_match_the_jax_mesh_master(monkeypatch):
    """running_total keeps a total per instance, so the answers depend on
    which instance each value lands on: both masters must route alike.
    With the serve scheduler off one caller's requests rotate the start
    slot the same way on both."""
    for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG", "MISAKA_SERVE_BATCH"):
        monkeypatch.setenv(switch, "0")
    text = example("running_total")
    jm = JMaster(JTopology.from_json(text, **CAPS), chunk_steps=32, batch=8,
                 data_parallel=4, engine="scan")
    tm = MasterNode(Topology.from_json(text, **CAPS), chunk_steps=32, batch=8, device="cpu",
                    data_parallel=4)
    assert tm.status()["mesh"] == jm.status()["mesh"]
    jm.run()
    tm.run()
    try:
        rng = np.random.default_rng(4)
        for _ in range(3):
            vals = rng.integers(-500, 500, size=40).astype(np.int32)
            assert tm.compute_spread(vals, timeout=60) == jm.compute_spread(vals, timeout=60)
            few = rng.integers(-500, 500, size=5).astype(np.int32)
            assert tm.compute_many(few, timeout=60) == jm.compute_many(few, timeout=60)
            assert tm.compute_coalesced(few, timeout=60) == jm.compute_coalesced(few, timeout=60)
            assert tm.compute(9, timeout=60) == jm.compute(9, timeout=60)
    finally:
        jm.close()
        tm.close()


def test_autogrow_under_data_parallel_like_jax():
    """reverse_any at stack_cap=4 under D=2: the block [1..10, 0] parks its
    pusher; both masters double the capacity of every shard (4 -> 16) and
    answer the reversal.  A pre-grow snapshot restores padded."""
    text = example("reverse_any")
    caps = dict(in_cap=16, out_cap=16, stack_cap=4)
    jm = JMaster(JTopology.from_json(text, **caps), chunk_steps=32, batch=2,
                 data_parallel=2, engine="scan")
    tm = MasterNode(Topology.from_json(text, **caps), chunk_steps=32, batch=2, device="cpu",
                    data_parallel=2)
    snap = tm.snapshot()
    jm.run()
    tm.run()
    try:
        block = list(range(1, 11)) + [0]
        want = jm.compute_many(block, timeout=60)
        got = tm.compute_many(block, timeout=60)
        assert got == want == [0] + list(range(10, 0, -1))
        assert tm.status()["stack_cap"] == jm.status()["stack_cap"] == 16
        assert [s.stack_mem.shape[-1] for s in tm._state] == [16, 16]
        tm.restore(snap)  # stack_cap 4 shapes, padded to 16 on every shard
        assert [s.stack_mem.shape[-1] for s in tm._state] == [16, 16]
        assert tm.compute_many([7, 8, 9, 0], timeout=60) == [0, 9, 8, 7]
    finally:
        jm.close()
        tm.close()
