"""Lane-sharded superstep, first generation: a per-tick occupancy all_gather.

The port's twin of misaka_tpu/parallel/sharded.py.  It is no longer the
default model-parallel engine (parallel/routed.py is); it stays servable
behind MasterNode(engine="gather") as the A/B baseline the routed design is
measured against.

The multi-shard version of core/step.py: each shard owns a contiguous slice
of program lanes (their registers, ports, hold latches and code); stacks and
master I/O rings are replicated and kept equal by applying the collectively
agreed updates on every shard.  Where the one-device step elects with a
cumsum over the whole lane axis, this one agrees over the `model` axis each
tick with:

  all_gather (port occupancy)  senders must see every shard's ports
  pmin       (winner election) lowest-global-lane arbitration for ports,
                               stacks, IN and OUT
  psum       (value broadcast) the unique winner's value reaches the shard
                               owning the destination, or every shard's
                               replicated stack and ring update

The collectives are core/axis.py's (the step yields at each); `step_local`
keeps the reference's name.
"""

from __future__ import annotations

import functools

import torch

from misaka_tpu_torch.core.phases import (
    apply_stack_ring_updates,
    commit_lane_state,
    decode_and_consume,
)
from misaka_tpu_torch.core.state import NetworkState
from misaka_tpu_torch.parallel.mesh import build_lane_sharded_runner
from misaka_tpu_torch.tis import isa

_I32 = torch.int32
_BIG = 2**31 - 1  # "no contender" sentinel for pmin elections


def _elect(contender: torch.Tensor, lane_global: torch.Tensor, axis):
    """Global lowest-lane election over `model` for a [B, Nl, K] contender
    matrix: (winner_key [B, K], global lane id or _BIG; local_win [B, Nl, K])."""
    local_key = torch.where(contender, lane_global[None, :, None], _BIG).amin(dim=1)
    winner_key = yield from axis.pmin(local_key)
    local_win = contender & (lane_global[None, :, None] == winner_key[:, None, :])
    return winner_key, local_win


def _winner_val(local_win: torch.Tensor, values: torch.Tensor, axis) -> torch.Tensor:
    """psum-broadcast the unique winner's value: [B, Nl, K] mask x [B, Nl]
    -> [B, K]."""
    partial = (local_win.to(_I32) * values[..., None]).sum(dim=1, dtype=_I32)
    return (yield from axis.psum(partial))


def step_local(code: torch.Tensor, prog_len: torch.Tensor, state: NetworkState,
               n_total_lanes: int, axis) -> NetworkState:
    """One superstep on this shard's lane slice (B instances), as a
    generator that yields at each collective (core/axis.py::drive).

    Mirrors core/step.py phase by phase.  Lane tensors are [B, Nl];
    stack and ring state is `model`-replicated."""
    n_local = code.shape[0]
    n_ports = isa.NUM_PORTS
    n_dests = n_total_lanes * n_ports
    batch, n_stacks, stack_cap = state.stack_mem.shape
    in_cap = state.in_buf.shape[-1]
    out_cap = state.out_buf.shape[-1]
    dev = code.device
    lane_offset = axis.index * n_local
    lane_global = lane_offset + torch.arange(n_local, device=dev, dtype=_I32)

    # --- fetch & decode + phase A (core/phases.py) -------------------------
    d = decode_and_consume(code, state)
    op, src_ok, src_val, tgt = d.op, d.src_ok, d.src_val, d.tgt
    port_full_after_reads = d.port_full_after_reads

    # --- phase B: sends, the collective routing fabric ---------------------
    # senders need every shard's occupancy: all_gather over the lanes
    global_full = (yield from axis.all_gather(port_full_after_reads, dim=1)).reshape(batch, n_dests)
    want_send = (op == isa.OP_MOV_NET) & src_ok
    dest = tgt * n_ports + d.tport
    dest_onehot = want_send[..., None] & (dest[..., None] == torch.arange(n_dests, device=dev))
    contender = dest_onehot & ~global_full[:, None, :]
    send_key, send_win = yield from _elect(contender, lane_global, axis)
    send_won = send_win.any(dim=2)
    delivered = send_key < _BIG                          # [B, D], replicated
    deliver_val = yield from _winner_val(send_win, src_val, axis)   # [B, D], replicated
    # each shard applies only its own slice of the dest axis
    mine = slice(lane_offset * n_ports, (lane_offset + n_local) * n_ports)
    my_delivered = delivered[:, mine].reshape(batch, n_local, n_ports)
    my_deliver_val = deliver_val[:, mine].reshape(batch, n_local, n_ports)
    new_port_full = port_full_after_reads | my_delivered
    new_port_val = torch.where(my_delivered, my_deliver_val, state.port_val)

    # --- stacks: one op per stack per tick, applied replicated -------------
    is_push = op == isa.OP_PUSH
    is_pop = op == isa.OP_POP
    tgt_stack = tgt.clamp(0, n_stacks - 1).long()
    top_at_tgt = state.stack_top.gather(1, tgt_stack)
    want_sop = (is_push & src_ok & (top_at_tgt < stack_cap)) | (is_pop & (top_at_tgt > 0))
    stack_onehot = want_sop[..., None] & (
        tgt_stack[..., None] == torch.arange(n_stacks, device=dev))
    _, stack_win = yield from _elect(stack_onehot, lane_global, axis)
    sop_won = stack_win.any(dim=2)
    push_per_stack = (yield from axis.psum(
        (stack_win & is_push[..., None]).to(_I32).sum(dim=1, dtype=_I32))) > 0
    pop_per_stack = (yield from axis.psum(
        (stack_win & is_pop[..., None]).to(_I32).sum(dim=1, dtype=_I32))) > 0
    push_val = yield from _winner_val(stack_win & is_push[..., None], src_val, axis)
    pop_slot = (top_at_tgt - 1).clamp(0, stack_cap - 1).long()
    pop_val_lane = state.stack_mem.reshape(batch, n_stacks * stack_cap).gather(
        1, tgt_stack * stack_cap + pop_slot)

    # --- master I/O rings: global single-slot elections --------------------
    in_avail = (state.in_wr - state.in_rd) > 0
    want_in = (op == isa.OP_IN) & in_avail[:, None]
    in_key, in_win_m = yield from _elect(want_in[..., None], lane_global, axis)
    in_win = in_win_m[..., 0]
    in_any = in_key[:, 0] < _BIG
    in_val = state.in_buf.gather(1, (state.in_rd % in_cap).long()[:, None])  # [B, 1]

    out_free = (state.out_wr - state.out_rd) < out_cap
    want_out = (op == isa.OP_OUT) & src_ok & out_free[:, None]
    out_key, out_win_m = yield from _elect(want_out[..., None], lane_global, axis)
    out_win = out_win_m[..., 0]
    out_any = out_key[:, 0] < _BIG
    out_val = (yield from _winner_val(out_win_m, src_val, axis))[:, 0]

    # --- commit decision ---------------------------------------------------
    dst_ok = torch.where(
        op == isa.OP_MOV_NET,
        send_won,
        torch.where(
            is_push | is_pop,
            sop_won,
            torch.where(op == isa.OP_IN, in_win,
                        torch.where(op == isa.OP_OUT, out_win, torch.ones_like(out_win))),
        ),
    )
    commit = src_ok & dst_ok

    # --- commit-time register/PC + stack/ring writes (core/phases.py) ------
    updates = commit_lane_state(d, prog_len, state, commit, pop_val_lane, in_val)
    updates.update(
        apply_stack_ring_updates(
            state, push_per_stack, pop_per_stack, push_val, in_any, out_any, out_val
        )
    )
    return state._replace(
        port_val=new_port_val,
        port_full=new_port_full,
        tick=state.tick + 1,
        retired=state.retired + commit.to(_I32),
        **updates,
    )


def make_sharded_runner(code, prog_len, mesh, num_steps: int, graph: bool | None = None):
    """fn(shards) -> shards: `num_steps` ticks, lane-sharded over `model`
    (the shards as parallel/mesh.py::shard_state cuts them; `graph` as
    build_lane_sharded_runner's).  The lane count must divide by the mesh's
    model size."""
    step1 = functools.partial(_step1, n_total_lanes=code.shape[0])
    return build_lane_sharded_runner(step1, code, prog_len, mesh, num_steps, graph)


def _step1(code, prog_len, state, axis, n_total_lanes):
    return step_local(code, prog_len, state, n_total_lanes, axis)
