"""Multi-process execution: a process group and hybrid [data, model] meshes.

The port's twin of misaka_tpu/parallel/multihost.py.  The reference joins
JAX's multi-process runtime (one process per host, a coordinator for
set-up) and puts the batch axis across processes while the lane axis, whose
routing collectives run every tick, stays inside one (its multihost.py:11-16,
:84-88).  The port keeps that layout: `data` spans processes, `model` stays
on the process's own devices, so its per-tick collectives (core/axis.py)
never leave a process and `torch.distributed` is never on the per-tick
path.  The group serves the bootstrap and reading results across processes
(gloo, which serves the CPU and the card alike).

Pieces:
  * initialize_from_env: join the group from MISAKA_COORDINATOR
    ("host:port"), MISAKA_NUM_PROCESSES and MISAKA_PROCESS_ID through
    `torch.distributed.init_process_group("gloo", init_method="tcp://...")`.
    The reference's `MISAKA_COORDINATOR=auto` (JAX's Cloud TPU autodetect)
    has no counterpart on a card's host and raises.
  * hybrid_mesh: a mesh of this process's devices whose rows are this
    process's rows of the global data axis.
  * make_global_state / put_global: the shards of a host-built array or
    state that this process's devices own, as parallel/mesh.py cuts them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from misaka_tpu_torch.core.state import NetworkState
from misaka_tpu_torch.parallel.mesh import Mesh, cut_shard, make_mesh, shard_state

COORDINATOR_ENV = "MISAKA_COORDINATOR"
NUM_PROCESSES_ENV = "MISAKA_NUM_PROCESSES"
PROCESS_ID_ENV = "MISAKA_PROCESS_ID"


def initialize_from_env(environ=os.environ) -> bool:
    """Join the process group if MISAKA_COORDINATOR is set.

    Returns True when the group was (or already is) initialized, False
    without a coordinator.  Raises ValueError for `auto`, which names JAX's
    Cloud TPU autodetection: nothing on a card's host tells a process of a
    cluster, so the address, the process count and the rank are given."""
    coordinator = environ.get(COORDINATOR_ENV)
    if not coordinator:
        return False
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if coordinator == "auto":
        raise ValueError(
            f"{COORDINATOR_ENV}=auto is JAX's Cloud TPU autodetection, which has no "
            "counterpart on a card's host: give host:port with "
            f"{NUM_PROCESSES_ENV} and {PROCESS_ID_ENV}")
    missing = [k for k in (NUM_PROCESSES_ENV, PROCESS_ID_ENV) if not environ.get(k)]
    if missing:
        raise ValueError(f"{COORDINATOR_ENV}={coordinator} needs {' and '.join(missing)}")
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator}",
        world_size=int(environ[NUM_PROCESSES_ENV]),
        rank=int(environ[PROCESS_ID_ENV]),
    )
    return True


def process_count() -> int:
    """The group's size (1 outside a group)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 outside a group)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def hybrid_mesh(model_parallel: int = 1, device=None, n_local: int | None = None) -> Mesh:
    """A [data, model] mesh where `model` never crosses a process boundary.

    This process's devices: device None the cards it sees (all of them
    unless n_local), "cpu" n_local CPU shards, a list as given.  In one
    process it is make_mesh's.  In a group of P processes, each holding
    the same number of devices, the global data axis is P times this
    process's rows, and this process holds rows [rank * rows, (rank + 1) *
    rows); ValueError when the local devices do not divide by
    model_parallel, as the reference's."""
    if isinstance(device, (list, tuple)):
        n = len(device)
    elif n_local is not None:
        n = n_local
    elif device is None or str(device).startswith("cuda"):
        n = torch.cuda.device_count()
    else:
        raise ValueError("hybrid_mesh on the CPU needs n_local (the shards of this process)")
    if n % model_parallel:
        raise ValueError(f"{n} local devices not divisible by model_parallel={model_parallel}")
    local = make_mesh(n, device, model_parallel=model_parallel)
    procs = process_count()
    if procs == 1:
        return local
    return Mesh(local.devices, local.model, data_offset=process_index() * local.rows,
                data_total=procs * local.rows)


def put_global(arr: np.ndarray, mesh: Mesh, spec: tuple) -> list[torch.Tensor]:
    """The shards of `arr` this process's devices own under `spec` (per
    dimension `data`, `model` or None), row-major, each an owned copy on
    its device: every process holds the full value (cheap here: code
    tables and initial states) and keeps only its own shards."""
    t = torch.as_tensor(np.asarray(arr))
    out = []
    for i, dev in enumerate(mesh.devices):
        d, m = divmod(i, mesh.model)
        out.append(cut_shard(t, tuple(spec), mesh, d, m).to(dev, copy=True))
    return out


def make_global_state(init: NetworkState, mesh: Mesh, batched: bool = True) -> list[NetworkState]:
    """The shards of a host-built state that this process's devices own,
    with the canonical layout (parallel/mesh.py::state_specs)."""
    return shard_state(init, mesh, batched)

