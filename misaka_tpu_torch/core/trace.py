"""Per-lane instruction trace ring: the device-resident execution history.

The port's twin of misaka_tpu/core/trace.py.  Each traced tick appends every
lane's (pc, opcode, committed, acc-after) of one network instance to a
fixed-capacity ring on the state's device, with no host read while
recording; the host decodes the ring afterwards with the disassembler.

This is the debug path, kept apart from the hot one: `step` and the fused
kernel stay trace-free, `traced_step` wraps the plain step.  The port's
step is batched, so a recorder is handed a [B, ...] before/after pair and
the index of the instance it records: an unbatched network runs as a batch
of one (instance 0), as the JAX package records one instance out of a
vmapped step.

Layout: `buf[lane, slot, field]` with slot = wr % cap and four fields
(TR_PC, TR_OP, TR_COMMIT, TR_ACC).  `wr` counts traced ticks; once it
passes cap the ring has wrapped and only the last cap ticks survive.  The
JAX ring keeps `wr` in uint32 (it restarts its tick labels every 2^32
ticks); torch's uint32 has few operations, so here `wr` is an int64 that
wraps modulo 2^32 at the same tick, and the labels match.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from misaka_tpu_torch.core.phases import fetch_line
from misaka_tpu_torch.core.state import NetworkState
from misaka_tpu_torch.core.step import step
from misaka_tpu_torch.tis import isa
from misaka_tpu_torch.tis.disasm import TISDisasmError, disassemble_line

# Trace record fields.
TR_PC = 0      # pc at fetch
TR_OP = 1      # opcode fetched
TR_COMMIT = 2  # 1 if the instruction committed, 0 if the lane parked
TR_ACC = 3     # acc AFTER the tick (the committed result)
TR_NFIELDS = 4

WR_MOD = 1 << 32  # the JAX ring's uint32 counter wraps here


class TraceRing(NamedTuple):
    """Execution history of one network instance."""

    buf: torch.Tensor  # [N, CAP, TR_NFIELDS] int32
    wr: torch.Tensor   # int64 scalar in [0, 2^32): traced ticks so far (slot = wr % CAP)


def init_trace(num_lanes: int, cap: int = 256,
               device: str | torch.device = "cpu") -> TraceRing:
    return TraceRing(
        buf=torch.zeros((num_lanes, cap, TR_NFIELDS), dtype=torch.int32, device=device),
        wr=torch.zeros((), dtype=torch.int64, device=device),
    )


def _record(code: torch.Tensor, before: NetworkState, after: NetworkState,
            instance: int) -> torch.Tensor:
    """One tick's [N, TR_NFIELDS] record of instance `instance`."""
    n_lanes, max_len, _ = code.shape
    lane = torch.arange(n_lanes, device=code.device)
    pc_before = before.pc[instance]
    op = code[lane, fetch_line(pc_before, max_len), isa.F_OP]
    committed = after.retired[instance] - before.retired[instance]  # [N] 0/1
    # the acc column holds the LOW (wire) word of the 64-bit register: one
    # int32 per entry keeps the ring dense; the debugger shows full width
    return torch.stack([pc_before, op, committed, after.acc[instance]], dim=-1)


def record_step(
    code: torch.Tensor,
    before: NetworkState,
    after: NetworkState,
    trace: TraceRing,
    instance: int = 0,
) -> TraceRing:
    """Append one tick's record for every lane of instance `instance` of
    the batched states `before`/`after` around the tick; the caller owns
    the step.  Returns a new ring (the given one is left as it was)."""
    slot = (trace.wr % trace.buf.shape[1]).view(1)
    rec = _record(code, before, after, instance)
    return TraceRing(buf=trace.buf.index_copy(1, slot, rec[:, None, :]),
                     wr=(trace.wr + 1) % WR_MOD)


def traced_step(
    code: torch.Tensor,
    prog_len: torch.Tensor,
    state: NetworkState,
    trace: TraceRing,
    instance: int = 0,
) -> tuple[NetworkState, TraceRing]:
    """One superstep of a batched state + one trace record per lane of
    instance `instance` (state semantics identical to `step`)."""
    new_state = step(code, prog_len, state)
    return new_state, record_step(code, state, new_state, trace, instance)


def run_traced(
    code: torch.Tensor,
    prog_len: torch.Tensor,
    state: NetworkState,
    trace: TraceRing,
    num_steps: int,
    instance: int = 0,
) -> tuple[NetworkState, TraceRing]:
    """`num_steps` traced supersteps of a batched state (the JAX package's
    lax.scan as a tick loop).  The ring is copied once and then written in
    place, one record per tick; the given ring is left as it was."""
    buf = trace.buf.clone()
    wr = trace.wr.clone()
    cap = buf.shape[1]
    for _ in range(num_steps):
        new_state = step(code, prog_len, state)
        rec = _record(code, state, new_state, instance)
        buf.index_copy_(1, (wr % cap).view(1), rec[:, None, :])
        wr = (wr + 1) % WR_MOD
        state = new_state
    return state, TraceRing(buf=buf, wr=wr)


def decode_trace(
    trace: TraceRing,
    code: np.ndarray,
    prog_len: np.ndarray,
    lane_names: Sequence[str] | None = None,
    stack_names: Sequence[str] | None = None,
    last: int | None = None,
) -> list[dict]:
    """Host-side decode: the ring as a list of per-tick dicts, oldest first.

    Each entry: {"tick", "lane", "name", "pc", "op", "committed", "acc",
    "text"} where `text` is the disassembled instruction the lane executed
    (or retried, if parked).
    """
    buf = trace.buf.cpu().numpy()
    wr = int(trace.wr)
    n_lanes, cap, _ = buf.shape
    code = np.asarray(code)
    lane_names = list(lane_names) if lane_names else [f"node{i}" for i in range(n_lanes)]
    if not stack_names:
        max_tgt = int(code[..., isa.F_TGT].max(initial=0))
        stack_names = [f"stack{i}" for i in range(max_tgt + 1)]
    else:
        stack_names = list(stack_names)

    n_avail = min(wr, cap)
    if last is not None:
        n_avail = min(n_avail, last)
    first_tick = wr - n_avail

    out = []
    for tick in range(first_tick, wr):
        slot = tick % cap
        for lane in range(n_lanes):
            pc, op, committed, acc = (int(v) for v in buf[lane, slot])
            pc_clipped = min(pc, code.shape[1] - 1)
            try:
                text = disassemble_line(code[lane, pc_clipped], lane_names, stack_names)
            except (TISDisasmError, IndexError):  # malformed row (a trace older than a /load)
                text = f"<op {op}>"
            out.append(
                {
                    "tick": tick,
                    "lane": lane,
                    "name": lane_names[lane],
                    "pc": pc,
                    "op": isa.OP_NAMES.get(op, str(op)),
                    "committed": bool(committed),
                    "acc": acc,
                    "text": text,
                }
            )
    return out


def format_trace(entries: list[dict]) -> str:
    """Render decoded entries as an aligned text listing (debugger output)."""
    lines = []
    for e in entries:
        mark = " " if e["committed"] else "*"  # * = parked/retry
        lines.append(
            f"t={e['tick']:>6} {e['name']:>10} pc={e['pc']:>3}{mark} "
            f"acc={e['acc']:>11} | {e['text']}"
        )
    return "\n".join(lines)
