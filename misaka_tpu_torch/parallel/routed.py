"""Statically-routed lane-sharded superstep: TWO collectives per tick.

The port's twin of misaka_tpu/parallel/routed.py, the default model-parallel
engine.  A TIS network's route table is static (every MOV_NET names its
destination lane and port at assembly time, program.go:242-275), so the
compact-slot step of core/routing.py reaches global agreement with two
collectives a tick over the `model` axis, both over one compact
[Da + num_stacks + 3] vector per instance:

  pmin(keys)   election and occupancy veto for sends, stacks, IN and OUT
               (key = global_lane*2 + is_push keeps lowest-lane order while
               telling every shard whether a stack winner pushes or pops;
               the shard owning a dest port contributes key -1 when the
               port is full)
  psum(values) the unique winners' values reach the dest shard (sends) and
               the replicated stack and ring state (push, OUT)

Stacks and rings stay replicated over `model`, and every shard applies the
same agreed update, so the state stays bit-identical to core/step.py.
`step_local` keeps the reference's name; its collectives are
core/axis.py's, bound by parallel/mesh.py::build_lane_sharded_runner.
"""

from __future__ import annotations

from misaka_tpu_torch.core.routing import RouteTable, build_route_table, route_on, step_slots
from misaka_tpu_torch.parallel.mesh import build_lane_sharded_runner

__all__ = ["RouteTable", "build_route_table", "make_routed_runner", "step_local"]


def step_local(route, code, prog_len, state, n_total_lanes, axis):
    """One superstep on this shard's lane slice (core/routing.py, bound to
    the shard's member of the `model` axis)."""
    return step_slots(route, code, prog_len, state, axis=axis, n_total_lanes=n_total_lanes)


def make_routed_runner(code, prog_len, mesh, num_steps: int, graph: bool | None = None):
    """fn(shards) -> shards: `num_steps` ticks, lane-sharded over `model`
    (the shards as parallel/mesh.py::shard_state cuts them; `graph` as
    build_lane_sharded_runner's).  Drop-in for
    parallel/sharded.py::make_sharded_runner with the two-collective
    compact-slot fabric."""
    route = build_route_table(code, prog_len)
    n_total = code.shape[0]
    routes = {dev: route_on(route, dev) for dev in set(mesh.devices)}  # made once

    def step1(code_l, len_l, state, axis):
        return step_local(routes[code_l.device], code_l, len_l, state, n_total, axis)

    return build_lane_sharded_runner(step1, code, prog_len, mesh, num_steps, graph)
