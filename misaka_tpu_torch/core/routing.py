"""Compact-slot routing: the scatter-election superstep.

The port's twin of misaka_tpu/core/routing.py, batched over a leading [B]
axis as core/step.py is.  The dense step (core/step.py) arbitrates with
one-hot matrices over the FULL dest axis, [B, N, 4N] per tick: quadratic in
the lane count.  A TIS network's route table is static (every MOV_NET names
its destination lane and port at assembly time, program.go:242-275), so the
elections here run as a scatter-min of encoded lane keys into a compact slot
vector: the `Da` active dest slots, one slot per stack, IN, OUT and a trash
slot, O(N + Da) per tick.

One function serves two modes:

  * `axis=None`: one device.  The reduction is the local scatter itself;
    the occupancy veto (key -1 for a full port) replaces the dense step's
    contender exclusion with identical semantics.
  * `axis=<a model-axis member>` (core/axis.py): this shard's lane slice
    of a lane-sharded mesh (parallel/routed.py).  The scatter results meet
    across the shards in exactly two collectives per tick: `pmin` of the keys
    (election and occupancy veto in one reduction) and `psum` of the values.
    The step is then a generator that yields at each (core/axis.py).

`chain=ChainTable` elects through statically unrolled min/sum chains over
each slot's possible contenders instead of scatters (one device only).

Arbitration, the hold latch and visibility are exactly core/step.py's, and
so is every field after every tick: the key encoding `global_lane*2 +
is_push`, the `-1` veto and the padded trash row below are what keep it so.
Every reduction is over int32 (min, and sums with at most one non-zero
term per slot): no float, no order dependence.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from misaka_tpu_torch.core.phases import (
    apply_stack_ring_updates,
    commit_lane_state,
    decode_and_consume,
)
from misaka_tpu_torch.core.state import NetworkState
from misaka_tpu_torch.core.axis import finish
from misaka_tpu_torch.tis import isa

_I32 = torch.int32
# "no contender" sentinel for min-elections
BIG = 2**31 - 1


class RouteTable(NamedTuple):
    """Static routing metadata extracted from the lowered code tables: host
    numpy as built, or tensors on a device (`route_on`), which `step_slots`
    then reads without a copy per tick."""

    dest_to_slot: np.ndarray  # [N*4] int32: full dest id -> send slot, or n_send
    slot_lane: np.ndarray     # [n_send] int32: dest lane of each send slot
    slot_port: np.ndarray     # [n_send] int32: dest port of each send slot
    n_send: int               # Da: the number of active dest slots


def build_route_table(code: np.ndarray, prog_len: np.ndarray) -> RouteTable:
    """Scan the lowered programs for every MOV_NET destination.

    Only rows below each lane's true length count (pc wraps at prog_len,
    program.go:429, so padding rows never execute)."""
    code = np.asarray(code)
    prog_len = np.asarray(prog_len)
    n_lanes = code.shape[0]
    n_ports = isa.NUM_PORTS
    n_dests = n_lanes * n_ports

    live = np.arange(code.shape[1])[None, :] < prog_len[:, None]  # [N, L]
    is_send = (code[:, :, isa.F_OP] == isa.OP_MOV_NET) & live
    dest = code[:, :, isa.F_TGT] * n_ports + code[:, :, isa.F_PORT]
    active = np.unique(dest[is_send]).astype(np.int32)
    if active.size and (active.min() < 0 or active.max() >= n_dests):
        raise ValueError("MOV_NET destination out of range in lowered code")

    dest_to_slot = np.full((n_dests,), active.size, dtype=np.int32)
    dest_to_slot[active] = np.arange(active.size, dtype=np.int32)
    return RouteTable(
        dest_to_slot=dest_to_slot,
        slot_lane=(active // n_ports).astype(np.int32),
        slot_port=(active % n_ports).astype(np.int32),
        n_send=int(active.size),
    )


def route_on(route: RouteTable, device) -> RouteTable:
    """`route` with its arrays as int32 tensors on `device`, made once."""
    return route._replace(**{
        f: torch.as_tensor(np.asarray(getattr(route, f), dtype=np.int32), device=device)
        for f in ("dest_to_slot", "slot_lane", "slot_port")})


class ChainTable(NamedTuple):
    """Static contender structure for the chained (scatter-free) election:
    which lanes can ever contend for each slot, and which slots each lane
    can ever address.  Tuples of ints."""

    slot_contenders: tuple  # [kv-1] tuples of lane ids
    lane_slots: tuple       # [N] tuples of slot ids


def build_chain_table(
    code: np.ndarray, prog_len: np.ndarray, route: RouteTable, n_stacks: int
) -> ChainTable:
    """Invert the route table into per-slot contender lists.

    Slots follow step_slots' layout: [0, Da) sends, [Da, Da+S) stacks, then
    IN, then OUT (the trash slot is left out: it never elects)."""
    code = np.asarray(code)
    prog_len = np.asarray(prog_len)
    n_lanes = code.shape[0]
    n_ports = isa.NUM_PORTS
    da = route.n_send
    kv_live = da + max(1, n_stacks) + 2

    slot_sets: list[set] = [set() for _ in range(kv_live)]
    lane_sets: list[set] = [set() for _ in range(n_lanes)]
    live = np.arange(code.shape[1])[None, :] < prog_len[:, None]
    for n in range(n_lanes):
        for line in range(code.shape[1]):
            if not live[n, line]:
                continue
            op = code[n, line, isa.F_OP]
            if op == isa.OP_MOV_NET:
                dest = code[n, line, isa.F_TGT] * n_ports + code[n, line, isa.F_PORT]
                s = int(route.dest_to_slot[dest])
            elif op in (isa.OP_PUSH, isa.OP_POP):
                s = da + int(np.clip(code[n, line, isa.F_TGT], 0, max(1, n_stacks) - 1))
            elif op == isa.OP_IN:
                s = da + max(1, n_stacks)
            elif op == isa.OP_OUT:
                s = da + max(1, n_stacks) + 1
            else:
                continue
            slot_sets[s].add(n)
            lane_sets[n].add(s)
    return ChainTable(
        slot_contenders=tuple(tuple(sorted(s)) for s in slot_sets),
        lane_slots=tuple(tuple(sorted(s)) for s in lane_sets),
    )


def _min_of(terms: list[torch.Tensor]) -> torch.Tensor:
    return torch.stack(terms).amin(dim=0)


def step_slots(
    route: RouteTable,
    code: torch.Tensor,
    prog_len: torch.Tensor,
    state: NetworkState,
    axis=None,
    n_total_lanes: int | None = None,
    chain: ChainTable | None = None,
):
    """One superstep of B instances via compact-slot elections.

    axis=None runs the whole network on one device and returns the state.
    With an axis member (core/axis.py) it runs this shard's lane slice
    (code/prog_len/state are the local shards, n_total_lanes the global
    lane count) and returns the step as a generator that yields at its two
    collectives, for core/axis.py::drive.  chain=ChainTable replaces
    every scatter and gather with statically unrolled min/sum chains over
    the slots' possible contenders (one device only: the contender
    structure differs per shard).
    """
    if chain is not None and axis is not None:
        raise ValueError("chained election is single-chip (axis=None) only")
    gen = _step_slots(route, code, prog_len, state, axis, n_total_lanes, chain)
    return gen if axis is not None else finish(gen)


def _step_slots(route, code, prog_len, state, axis, n_total_lanes, chain):
    """step_slots' one body, SPMD: a generator that yields at each
    collective of `axis` (none when axis is None)."""
    n_local = code.shape[0]
    n_ports = isa.NUM_PORTS
    if n_total_lanes is None:
        n_total_lanes = n_local
    n_dests = n_total_lanes * n_ports
    batch, n_stacks, stack_cap = state.stack_mem.shape
    in_cap = state.in_buf.shape[-1]
    dev = code.device
    lane_offset = 0 if axis is None else axis.index * n_local
    lane_global = lane_offset + torch.arange(n_local, device=dev, dtype=_I32)

    # election-vector slot layout (K live slots + 1 trash)
    da = route.n_send
    in_slot = da + n_stacks
    out_slot = in_slot + 1
    trash = out_slot + 1
    kv = trash + 1

    # --- fetch & decode + phase A (core/phases.py) -------------------------
    d = decode_and_consume(code, state)
    op, src_ok, src_val, tgt = d.op, d.src_ok, d.src_val, d.tgt
    port_full_after_reads = d.port_full_after_reads

    # --- contender classification (all local) ------------------------------
    want_send = (op == isa.OP_MOV_NET) & src_ok
    dest = (tgt * n_ports + d.tport).clamp(0, n_dests - 1).long()
    send_slot = torch.as_tensor(route.dest_to_slot, device=dev)[dest]

    is_push = op == isa.OP_PUSH
    is_pop = op == isa.OP_POP
    tgt_stack = tgt.clamp(0, n_stacks - 1).long()
    top_at_tgt = state.stack_top.gather(1, tgt_stack)
    want_sop = (is_push & src_ok & (top_at_tgt < stack_cap)) | (is_pop & (top_at_tgt > 0))

    in_avail = (state.in_wr - state.in_rd) > 0
    want_in = (op == isa.OP_IN) & in_avail[:, None]
    out_free = (state.out_wr - state.out_rd) < state.out_buf.shape[-1]
    want_out = (op == isa.OP_OUT) & src_ok & out_free[:, None]

    slot = torch.where(                                                  # [B, N] int64
        want_send,
        send_slot.long(),
        torch.where(
            want_sop,
            da + tgt_stack,
            torch.where(want_in, in_slot, torch.where(want_out, out_slot, trash)),
        ),
    )
    contend = want_send | want_sop | want_in | want_out
    # key = lane*2 + bit: monotone in lane (the lowest lane still wins)
    # while carrying the push/pop discriminator every shard needs for the
    # replicated stack update
    my_key = lane_global * 2 + (want_sop & is_push).to(_I32)

    # --- election: keys per slot (+ pmin across shards) --------------------
    key_masked = torch.where(contend, my_key, BIG)
    slot_lane = torch.as_tensor(route.slot_lane, device=dev)
    slot_port = torch.as_tensor(route.slot_port, device=dev).long()
    local_row = slot_lane - lane_offset
    mine = (local_row >= 0) & (local_row < n_local)
    local_row_c = local_row.clamp(0, n_local - 1).long()
    occ = port_full_after_reads[:, local_row_c, slot_port]               # [B, Da]
    vetoed = mine & occ  # the owner of a full port: key -1, below every lane's
    if chain is None:
        keys = torch.full((batch, kv), BIG, dtype=_I32, device=dev).scatter_reduce(
            1, slot, key_masked, "amin", include_self=True)
        keys = torch.cat([torch.where(vetoed, -1, keys[:, :da]), keys[:, da:]], dim=1)
    else:
        big = torch.full((batch,), BIG, dtype=_I32, device=dev)
        ks = []
        for s_idx, lanes_for in enumerate(chain.slot_contenders):
            if not lanes_for:
                ks.append(big)
                continue
            ks.append(_min_of([torch.where(slot[:, c] == s_idx, key_masked[:, c], BIG)
                               for c in lanes_for]))
        ks.append(big)  # trash
        keys = torch.stack(ks, dim=1)
        keys = torch.cat([torch.where(vetoed, -1, keys[:, :da]), keys[:, da:]], dim=1)
    keys_global = keys if axis is None else (yield from axis.pmin(keys))

    if chain is None:
        gathered = keys_global.gather(1, slot)
    else:
        # exactly one slot matches each lane's classification, so a min over
        # (match ? key : BIG) terms is the gather
        gs = []
        for n in range(n_local):
            slots_n = chain.lane_slots[n]
            if not slots_n:
                gs.append(torch.full((batch,), BIG, dtype=_I32, device=dev))
                continue
            gs.append(_min_of([torch.where(slot[:, n] == s_idx, keys_global[:, s_idx], BIG)
                               for s_idx in slots_n]))
        gathered = torch.stack(gs, dim=1)
    won = contend & (gathered == my_key)

    # --- winner values: per-slot sums (+ psum across shards) ---------------
    carries_val = won & (want_send | is_push | want_out)
    carried = torch.where(carries_val, src_val, 0).to(_I32)
    if chain is None:
        vals = torch.zeros((batch, kv), dtype=_I32, device=dev).scatter_add(1, slot, carried)
    else:
        zero = torch.zeros((batch,), dtype=_I32, device=dev)
        vs = []
        for s_idx, lanes_for in enumerate(chain.slot_contenders):
            if not lanes_for:
                vs.append(zero)
                continue
            vs.append(torch.stack([torch.where(slot[:, c] == s_idx, carried[:, c], 0)
                                   for c in lanes_for]).sum(dim=0, dtype=_I32))
        vs.append(zero)  # trash
        vals = torch.stack(vs, dim=1)
    vals_global = vals if axis is None else (yield from axis.psum(vals))

    # --- port delivery (the owner shard applies its own slots) -------------
    sk = keys_global[:, :da]
    delivered = (sk != BIG) & (sk >= 0)  # a sender won and the port was free
    # rows of other shards' slots and undelivered slots land in the padded
    # trash row n_local, cut off below
    row = torch.where(mine & delivered, local_row_c, n_local)             # [B, Da]
    at = (torch.arange(batch, device=dev)[:, None], row, slot_port[None, :])
    pf_pad = torch.nn.functional.pad(port_full_after_reads, (0, 0, 0, 1))
    pv_pad = torch.nn.functional.pad(state.port_val, (0, 0, 0, 1))
    new_port_full = pf_pad.index_put(at, torch.ones((), dtype=torch.bool, device=dev))[:, :n_local]
    new_port_val = pv_pad.index_put(at, vals_global[:, :da])[:, :n_local]

    # --- stack agreement (replicated update, identical on every shard) -----
    skeys = keys_global[:, da:da + n_stacks]
    stack_live = skeys != BIG
    push_per_stack = stack_live & ((skeys & 1) == 1)
    pop_per_stack = stack_live & ((skeys & 1) == 0)
    push_val = vals_global[:, da:da + n_stacks]
    pop_slot = (top_at_tgt - 1).clamp(0, stack_cap - 1).long()
    pop_val_lane = state.stack_mem.reshape(batch, n_stacks * stack_cap).gather(
        1, tgt_stack * stack_cap + pop_slot)

    # --- master I/O rings --------------------------------------------------
    in_any = keys_global[:, in_slot] != BIG
    in_val = state.in_buf.gather(1, (state.in_rd % in_cap).long()[:, None])  # [B, 1]
    out_any = keys_global[:, out_slot] != BIG
    out_val = vals_global[:, out_slot]

    # --- commit decision ---------------------------------------------------
    elects = ((op == isa.OP_MOV_NET) | is_push | is_pop | (op == isa.OP_IN)
              | (op == isa.OP_OUT))
    commit = src_ok & torch.where(elects, won, True)

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
