"""Lane-local phases of the superstep, batched over a leading [B] axis.

The port's twin of misaka_tpu/core/phases.py: fetch/decode, the phase-A
hold-latch consume, source resolution, the commit-time register/PC update
and the stack/ring writes.  Every tensor carries an explicit leading batch
axis where the JAX module relied on `vmap`: lane quantities are [B, N],
ports [B, N, 4], stacks [B, S], ring counters [B].  The program tables
(`code` [N, L, NFIELDS], `prog_len` [N]) are shared by the whole batch.

Semantics documentation lives with the canonical JAX kernel
(misaka_tpu/core/step.py's docstring); this module is the mechanism.
Out-of-range gathers are clamped explicitly, as the JAX code's `clip`s and
XLA's clamping gathers do: torch raises on them instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from misaka_tpu_torch.core import regs64
from misaka_tpu_torch.core.state import NetworkState
from misaka_tpu_torch.tis import isa

_I32 = torch.int32


class Decoded(NamedTuple):
    """Per-lane decode + phase-A results (lane tensors are [B, N])."""

    op: torch.Tensor
    src: torch.Tensor
    imm: torch.Tensor
    dst: torch.Tensor
    tgt: torch.Tensor
    tport: torch.Tensor
    jmp: torch.Tensor
    src_val: torch.Tensor   # resolved low (wire) word of the source operand
    src_hi: torch.Tensor    # 64-bit high word of the source (regs64.py)
    src_ok: torch.Tensor    # source available (port sources: latched)
    holding: torch.Tensor   # hold latch AFTER this tick's consumes
    hold_val: torch.Tensor
    port_full_after_reads: torch.Tensor  # [B, N, 4] occupancy after phase A


def _reads_src(op: torch.Tensor) -> torch.Tensor:
    """op in isa.READS_SRC (the jnp.isin of the JAX module)."""
    hit = torch.zeros_like(op, dtype=torch.bool)
    for code in isa.READS_SRC:
        hit |= op == code
    return hit


def fetch_line(pc: torch.Tensor, max_len: int) -> torch.Tensor:
    """The table row the reference's `code[lane, pc]` reads, as an int64
    index: a negative pc counts from the end of the table (jnp indexing),
    then the gather clamps (XLA)."""
    return torch.where(pc < 0, pc + max_len, pc).clamp(0, max_len - 1).long()


def decode_and_consume(code: torch.Tensor, state: NetworkState) -> Decoded:
    """Fetch/decode at each lane's PC + phase A (consume ready port sources
    into the hold latch, resolve the source operand)."""
    n_lanes, max_len, _ = code.shape
    lane = torch.arange(n_lanes, device=code.device)
    fields = code[lane[None, :], fetch_line(state.pc, max_len)]  # [B, N, NFIELDS]
    op = fields[..., isa.F_OP]
    src = fields[..., isa.F_SRC]
    imm = fields[..., isa.F_IMM]

    is_port_src = src >= isa.SRC_R0
    pidx = (src - isa.SRC_R0).clamp(0, isa.NUM_PORTS - 1).long()
    port_v = state.port_val.gather(2, pidx[..., None])[..., 0]
    port_f = state.port_full.gather(2, pidx[..., None])[..., 0]
    reads_port = _reads_src(op) & is_port_src
    consume_now = reads_port & ~state.holding & port_f
    holding = state.holding | consume_now
    hold_val = torch.where(consume_now, port_v, state.hold_val)
    zero = torch.zeros_like(imm)
    src_val = torch.where(
        src == isa.SRC_IMM,
        imm,
        torch.where(
            src == isa.SRC_ACC,
            state.acc,
            torch.where(src == isa.SRC_NIL, zero, hold_val),
        ),
    )
    # ACC carries its real high word; every other source sign-extends.
    src_hi = torch.where(src == isa.SRC_ACC, state.acc_hi, regs64.sext(src_val))
    src_ok = ~reads_port | holding

    # Ports cleared by this tick's consumes are visible to this tick's sends.
    ports = torch.arange(isa.NUM_PORTS, device=code.device)
    consume_onehot = consume_now[..., None] & (pidx[..., None] == ports)
    port_full_after_reads = state.port_full & ~consume_onehot

    return Decoded(
        op=op, src=src, imm=imm,
        dst=fields[..., isa.F_DST], tgt=fields[..., isa.F_TGT],
        tport=fields[..., isa.F_PORT], jmp=fields[..., isa.F_JMP],
        src_val=src_val, src_hi=src_hi, src_ok=src_ok,
        holding=holding, hold_val=hold_val,
        port_full_after_reads=port_full_after_reads,
    )


def commit_lane_state(
    d: Decoded,
    prog_len: torch.Tensor,
    state: NetworkState,
    commit: torch.Tensor,
    pop_val_lane: torch.Tensor,
    in_val: torch.Tensor,
) -> dict:
    """The commit-time register file + PC update (begin-of-tick reads).

    Returns the new acc/bak (hi+lo), pc, hold_val and holding as a dict of
    NetworkState field updates.  `in_val` is [B, 1] (one IN value per
    instance, broadcast over lanes).
    """
    op, dst = d.op, d.dst
    is_pop = op == isa.OP_POP
    incoming = torch.where(
        is_pop, pop_val_lane, torch.where(op == isa.OP_IN, in_val, d.src_val)
    )
    incoming_hi = torch.where(op == isa.OP_MOV_LOCAL, d.src_hi, regs64.sext(incoming))
    writes_acc = ((op == isa.OP_MOV_LOCAL) | is_pop | (op == isa.OP_IN)) & (
        dst == isa.DST_ACC
    )
    acc, acc_hi = state.acc, state.acc_hi
    add_hi, add_lo = regs64.add64(acc_hi, acc, d.src_hi, d.src_val)
    sub_hi, sub_lo = regs64.sub64(acc_hi, acc, d.src_hi, d.src_val)
    neg_hi, neg_lo = regs64.neg64(acc_hi, acc)
    new_acc, new_acc_hi = acc, acc_hi
    for mask, lo, hi in (
        (writes_acc, incoming, incoming_hi),
        (op == isa.OP_ADD, add_lo, add_hi),
        (op == isa.OP_SUB, sub_lo, sub_hi),
        (op == isa.OP_NEG, neg_lo, neg_hi),
        (op == isa.OP_SWP, state.bak, state.bak_hi),
    ):
        new_acc = torch.where(commit & mask, lo, new_acc)
        new_acc_hi = torch.where(commit & mask, hi, new_acc_hi)
    saves_bak = commit & ((op == isa.OP_SWP) | (op == isa.OP_SAV))
    new_bak = torch.where(saves_bak, acc, state.bak)
    new_bak_hi = torch.where(saves_bak, acc_hi, state.bak_hi)

    jump_taken = (
        (op == isa.OP_JMP)
        | ((op == isa.OP_JEZ) & regs64.is_zero(acc_hi, acc))
        | ((op == isa.OP_JNZ) & ~regs64.is_zero(acc_hi, acc))
        | ((op == isa.OP_JGZ) & regs64.is_pos(acc_hi, acc))
        | ((op == isa.OP_JLZ) & regs64.is_neg(acc_hi, acc))
    )
    pc_inc = (state.pc + 1) % prog_len                                   # program.go:429
    pc_jro = regs64.jro_target(state.pc, d.src_hi, d.src_val, prog_len)  # :354
    new_pc = torch.where(jump_taken, d.jmp, torch.where(op == isa.OP_JRO, pc_jro, pc_inc))
    new_pc = torch.where(commit, new_pc, state.pc)

    return dict(
        acc=new_acc, bak=new_bak, acc_hi=new_acc_hi, bak_hi=new_bak_hi,
        pc=new_pc, hold_val=d.hold_val, holding=d.holding & ~commit,
    )


def apply_stack_ring_updates(
    state: NetworkState,
    push_per_stack: torch.Tensor,
    pop_per_stack: torch.Tensor,
    push_val: torch.Tensor,
    in_any: torch.Tensor,
    out_any: torch.Tensor,
    out_val: torch.Tensor,
) -> dict:
    """Stack memory + master I/O ring updates from the tick's winners.

    At most one push OR pop per stack, one IN, one OUT per instance per
    tick; all reads are begin-of-tick.  Per-stack tensors are [B, S], ring
    quantities [B].  Returns NetworkState field updates.
    """
    stack_cap = state.stack_mem.shape[-1]
    out_cap = state.out_buf.shape[-1]

    push_slot = state.stack_top.clamp(0, stack_cap - 1).long()[..., None]
    cur_slot_val = state.stack_mem.gather(2, push_slot)[..., 0]
    new_stack_mem = state.stack_mem.scatter(
        2, push_slot, torch.where(push_per_stack, push_val, cur_slot_val)[..., None]
    )
    new_stack_top = (
        state.stack_top + push_per_stack.to(_I32) - pop_per_stack.to(_I32)
    )

    new_in_rd = state.in_rd + in_any.to(_I32)
    out_slot = (state.out_wr % out_cap).long()[:, None]
    cur_out = state.out_buf.gather(1, out_slot)[:, 0]
    new_out_buf = state.out_buf.scatter(
        1, out_slot, torch.where(out_any, out_val, cur_out)[:, None]
    )
    new_out_wr = state.out_wr + out_any.to(_I32)

    return dict(
        stack_mem=new_stack_mem, stack_top=new_stack_top,
        in_rd=new_in_rd, out_buf=new_out_buf, out_wr=new_out_wr,
    )
