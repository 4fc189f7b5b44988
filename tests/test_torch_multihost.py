"""Multi-process execution in the port (parallel/multihost.py): the cases of
tests/test_multihost.py.

- `initialize_from_env({})` is False; `auto` raises (no counterpart on a
  card's host);
- in one process `hybrid_mesh` is `make_mesh`, `make_global_state` is
  `shard_state` and `put_global` keeps the whole array's shards;
- two real processes (tests/torch_multihost_worker.py) join one gloo group
  through MISAKA_COORDINATOR, each running model=2 over its own two CPU
  shards with the data axis across the processes; both lane-sharded
  engines run add2 at batch 4, and rank 0's global result must equal the
  JAX package's dense step, field by field.  The workers import only the
  port.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from misaka_tpu import networks as jnetworks
from misaka_tpu_torch import networks
from misaka_tpu_torch.core.state import NetworkState
from misaka_tpu_torch.parallel import (
    hybrid_mesh,
    initialize_from_env,
    make_global_state,
    make_mesh,
    put_global,
    shard_state,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_initialize_noop_without_env():
    assert initialize_from_env({}) is False


def test_auto_coordinator_has_no_counterpart():
    with pytest.raises(ValueError, match="autodetection"):
        initialize_from_env({"MISAKA_COORDINATOR": "auto"})
    with pytest.raises(ValueError, match="MISAKA_NUM_PROCESSES"):
        initialize_from_env({"MISAKA_COORDINATOR": "127.0.0.1:1"})


def test_hybrid_mesh_single_process_matches_make_mesh():
    m = hybrid_mesh(model_parallel=2, device="cpu", n_local=4)
    ref = make_mesh(4, "cpu", model_parallel=2)
    assert m == ref and m.shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="not divisible"):
        hybrid_mesh(model_parallel=3, device="cpu", n_local=4)


def test_put_global_single_process():
    mesh = make_mesh(2, "cpu", model_parallel=2)
    arr = np.arange(8, dtype=np.int32)
    parts = put_global(arr, mesh, ("model",))
    np.testing.assert_array_equal(torch.cat(parts).numpy(), arr)
    whole = put_global(arr, mesh, (None,))
    assert all(np.array_equal(p.numpy(), arr) for p in whole)


def test_make_global_state_matches_shard_state():
    mesh = make_mesh(4, "cpu", model_parallel=2)
    net = networks.add2(in_cap=8, out_cap=8, stack_cap=8).compile(batch=4, device="cpu")
    state = net.init_state()._replace(acc=torch.arange(8, dtype=torch.int32).reshape(4, 2))
    a, b = make_global_state(state, mesh), shard_state(state, mesh)
    for x, y in zip(a, b):
        for f, u, v in zip(NetworkState._fields, x, y):
            assert torch.equal(u, v), f


def test_two_process_gloo_run_matches_the_jax_dense_step(tmp_path):
    """Two processes, one gloo group, both lane-sharded engines with the
    data axis across the processes: rank 0's global result equals the JAX
    dense step's, and every instance emitted all its values, +2 each."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = os.path.join(ROOT, "tests", "torch_multihost_worker.py")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA", "MISAKA_"))}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    out = tmp_path / "global.json"
    procs = [subprocess.Popen([sys.executable, worker, str(port), str(pid), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=ROOT)
             for pid in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=25)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n" + "\n---\n".join(logs))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"
        assert "MULTIHOST_OK" in log, log

    batch, per = 4, 4
    jnet = jnetworks.add2(in_cap=8, out_cap=8, stack_cap=8).compile(batch=batch)
    vals = (np.arange(batch)[:, None] * 10 + np.arange(per)[None, :]).astype(np.int32)
    in_buf = np.zeros((batch, 8), np.int32)
    in_buf[:, :per] = vals
    js = jnet.init_state()._replace(in_buf=jnp.asarray(in_buf),
                                    in_wr=jnp.full((batch,), per, jnp.int32))
    js = jnet.run(js, 64, engine="dense")
    want = {f: np.asarray(getattr(js, f)) for f in js._fields}
    report = json.loads(out.read_text())
    assert sorted(report) == ["gather", "routed"]
    for label, rows in report.items():
        assert [r["offset"] for r in rows] == [0, 1]
        for f in NetworkState._fields:
            got = np.concatenate([np.asarray(r["state"][f]) for r in rows])
            np.testing.assert_array_equal(got, want[f].astype(got.dtype), err_msg=f"{label} {f}")
        out_buf = np.concatenate([np.asarray(r["state"]["out_buf"]) for r in rows])
        np.testing.assert_array_equal(out_buf[:, :per], vals + 2)
