"""Worker process for tests/test_torch_multihost.py: one of two port processes.

Joins a torch.distributed gloo group through MISAKA_COORDINATOR, builds the
hybrid mesh (data across the two processes, model=2 over this process's two
CPU shards) and runs both lane-sharded engines on add2 over it.  Rank 0
gathers every process's rows through the group and writes the global state
of each engine to <out.json>.  Prints "MULTIHOST_OK" on success.  Imports
only the port: it fails if jax or misaka_tpu was loaded.

Usage: python torch_multihost_worker.py <coordinator_port> <process_id> <out.json>
"""

import json
import os
import sys

NUM_PROCS = 2
LOCAL_DEVICES = 2
MODEL_PARALLEL = 2
BATCH = 4          # 2 rows of the data axis (one per process) x 2 instances
PER_INSTANCE = 4
TICKS = 64


def main() -> None:
    port, pid, out_path = sys.argv[1], sys.argv[2], sys.argv[3]
    os.environ["MISAKA_COORDINATOR"] = f"127.0.0.1:{port}"
    os.environ["MISAKA_NUM_PROCESSES"] = str(NUM_PROCS)
    os.environ["MISAKA_PROCESS_ID"] = pid

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from misaka_tpu_torch import networks
    from misaka_tpu_torch.core.state import state_to_numpy
    from misaka_tpu_torch.parallel import (
        MODEL_AXIS,
        hybrid_mesh,
        initialize_from_env,
        make_global_state,
        make_routed_runner,
        make_sharded_runner,
    )
    from misaka_tpu_torch.parallel.mesh import gather_state, replicas_agree
    from misaka_tpu_torch.parallel.multihost import process_count, process_index

    assert initialize_from_env()
    assert initialize_from_env()  # idempotent once up
    assert process_count() == NUM_PROCS and process_index() == int(pid)
    mesh = hybrid_mesh(model_parallel=MODEL_PARALLEL, device="cpu", n_local=LOCAL_DEVICES)
    assert mesh.shape == {"data": NUM_PROCS, "model": MODEL_PARALLEL}
    assert mesh.shape[MODEL_AXIS] == MODEL_PARALLEL and mesh.data_offset == int(pid)

    net = networks.add2(in_cap=8, out_cap=8, stack_cap=8).compile(batch=BATCH, device="cpu")
    vals = (np.arange(BATCH)[:, None] * 10 + np.arange(PER_INSTANCE)[None, :]).astype(np.int32)
    in_buf = np.zeros((BATCH, 8), np.int32)
    in_buf[:, :PER_INSTANCE] = vals
    report = {}
    for label, factory in (("routed", make_routed_runner), ("gather", make_sharded_runner)):
        state = net.init_state()._replace(
            in_buf=torch.from_numpy(in_buf), in_wr=torch.full((BATCH,), PER_INSTANCE,
                                                              dtype=torch.int32))
        shards = make_global_state(state, mesh)  # this process's row only
        out = factory(net.code, net.prog_len, mesh, TICKS)(shards)
        assert replicas_agree(out, mesh) == []
        local = {f: v.tolist() for f, v in state_to_numpy(gather_state(out, mesh)).items()}
        rows = [None] * NUM_PROCS
        dist.all_gather_object(rows, {"offset": mesh.data_offset, "state": local})
        report[label] = [r for r in sorted(rows, key=lambda r: r["offset"])]
    dist.barrier()
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "misaka_tpu"))
    assert not bad, f"the worker imported {bad}"
    if pid == "0":
        with open(out_path, "w") as f:
            json.dump(report, f)
    dist.destroy_process_group()
    print("MULTIHOST_OK", flush=True)


if __name__ == "__main__":
    main()
