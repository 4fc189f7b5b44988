"""Multi-device execution: the [data, model] mesh and the lane-sharded steps."""

from misaka_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    make_mesh,
    shard_state,
    state_specs,
)
from misaka_tpu_torch.parallel.sharded import make_sharded_runner, step_local
from misaka_tpu_torch.parallel.routed import build_route_table, make_routed_runner
from misaka_tpu_torch.parallel.multihost import (
    hybrid_mesh,
    initialize_from_env,
    make_global_state,
    put_global,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "make_mesh",
    "shard_state",
    "state_specs",
    "make_sharded_runner",
    "make_routed_runner",
    "build_route_table",
    "step_local",
    "hybrid_mesh",
    "initialize_from_env",
    "make_global_state",
    "put_global",
]
