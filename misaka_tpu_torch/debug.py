"""Interactive debugger: single-step a network, inspect every lane.

The port's twin of misaka_tpu/debug.py.  The whole network's state is one
NetworkState, so a debugger is small: step the superstep one tick at a
time (core/trace.py::traced_step on the batch-of-one view of the unbatched
state), read registers, ports and stacks directly, break when a lane
reaches a program line.  Host-driven across ticks, so breakpoints can be
data-dependent.  The bring-up tool; throughput lives in the engines.  Runs
on the card unless given device="cpu".

    dbg = Debugger(networks.add2(), device="cpu")
    dbg.feed([5])
    dbg.add_breakpoint("misaka2", 2)       # PUSH ACC, misaka3
    hits = dbg.run(max_ticks=100)          # -> [("misaka2", 2)]
    dbg.inspect("misaka2")["acc"]          # -> 7
    print(dbg.listing("misaka2"))          # disasm with pc/breakpoint marks
"""

from __future__ import annotations

import torch

from misaka_tpu_torch.core.engine import as_batch, first
from misaka_tpu_torch.core.trace import decode_trace, format_trace, traced_step
from misaka_tpu_torch.runtime.topology import Topology
from misaka_tpu_torch.tis.disasm import disassemble_program


class Debugger:
    """Single-instance stepper over a compiled topology."""

    def __init__(self, topology: Topology, trace_cap: int = 256,
                 device: str | torch.device | None = None):
        self._top = topology
        self._net = topology.compile(device=device)
        self._lane_ids = topology.lane_ids()
        self._lane_names = list(self._lane_ids)
        self._stack_names = list(topology.stack_ids())
        self._state = self._net.init_state()
        self._trace = self._net.init_trace(trace_cap)
        # breakpoints: lane index -> set of program lines
        self._breaks: dict[int, set[int]] = {}

    # --- control -----------------------------------------------------------

    def feed(self, values) -> int:
        """Queue client inputs; returns how many were accepted."""
        self._state, took = self._net.feed(self._state, list(values))
        return took

    def outputs(self) -> list[int]:
        """Drain anything the network has emitted."""
        self._state, outs = self._net.drain(self._state)
        return outs

    def reset(self) -> None:
        self._state = self._net.init_state()
        self._trace = self._net.init_trace(self._trace.buf.shape[1])

    def add_breakpoint(self, lane: str, line: int) -> None:
        idx = self._lane_index(lane)
        length = int(self._net.prog_len[idx])
        if not 0 <= line < length:
            raise ValueError(f"line {line} out of range for {lane} (len {length})")
        self._breaks.setdefault(idx, set()).add(line)

    def clear_breakpoints(self) -> None:
        self._breaks.clear()

    def step(self, ticks: int = 1) -> list[tuple[str, int]]:
        """Advance up to `ticks` supersteps; stops early on a breakpoint hit.

        Returns the breakpoint hits ([(lane_name, line)]) of the stopping
        tick, empty if the full count ran without a hit.
        """
        code, prog_len = self._net._code_t, self._net._len_t
        for _ in range(ticks):
            state, self._trace = traced_step(code, prog_len, as_batch(self._state), self._trace)
            self._state = first(state)
            hits = self._hits()
            if hits:
                return hits
        return []

    def run(self, max_ticks: int = 10_000) -> list[tuple[str, int]]:
        """Run until a breakpoint hit (or the tick budget); returns the hits."""
        return self.step(max_ticks)

    # --- inspection --------------------------------------------------------

    @property
    def tick(self) -> int:
        return int(self._state.tick)

    def inspect(self, lane: str) -> dict:
        """One lane's full architectural state, registers at 64 bits."""
        i = self._lane_index(lane)
        s = self._state

        def full64(hi, lo):  # the true 64-bit register (core/regs64.py)
            return (int(hi) << 32) | (int(lo) & 0xFFFFFFFF)

        port_val, port_full = s.port_val[i].tolist(), s.port_full[i].tolist()
        return {
            "acc": full64(s.acc_hi[i], s.acc[i]),
            "bak": full64(s.bak_hi[i], s.bak[i]),
            "pc": int(s.pc[i]),
            "ports": {f"R{k}": (v if full else None)
                      for k, (v, full) in enumerate(zip(port_val, port_full))},
            "holding": bool(s.holding[i]),
            "hold_val": int(s.hold_val[i]),
            "retired": int(s.retired[i]),
        }

    def stacks(self) -> dict[str, list[int]]:
        """Every stack node's live contents, bottom first."""
        mem = self._state.stack_mem.cpu().numpy()
        tops = self._state.stack_top.cpu().numpy()
        return {
            name: mem[i, : tops[i]].tolist()
            for i, name in enumerate(self._stack_names)
        }

    def listing(self, lane: str) -> str:
        """Disassembly with `->` at the current pc and `B` on breakpoints."""
        i = self._lane_index(lane)
        length = int(self._net.prog_len[i])
        text = disassemble_program(
            self._net.code[i], length, self._lane_names, self._stack_names
        )
        pc = int(self._state.pc[i])
        rows = []
        for line_no, line in enumerate(text.split("\n")):
            cursor = "->" if line_no == pc else "  "
            bp = "B" if line_no in self._breaks.get(i, ()) else " "
            rows.append(f"{cursor}{bp} {line_no:>3}  {line}")
        return "\n".join(rows)

    def history(self, last: int | None = None) -> str:
        """Formatted trace listing of the most recent ticks."""
        entries = decode_trace(
            self._trace,
            self._net.code,
            self._net.prog_len,
            lane_names=self._lane_names,
            stack_names=self._stack_names,
            last=last,
        )
        return format_trace(entries)

    # --- internals ---------------------------------------------------------

    def _lane_index(self, lane: str) -> int:
        if lane not in self._lane_ids:
            raise KeyError(f"'{lane}' is not a program node (have {self._lane_names})")
        return self._lane_ids[lane]

    def _hits(self) -> list[tuple[str, int]]:
        if not self._breaks:
            return []
        pc = self._state.pc.tolist()
        return [
            (self._lane_names[i], pc[i])
            for i, lines in self._breaks.items()
            if pc[i] in lines
        ]
