"""Disassembler: dense ISA tables -> TIS source text (the inverse of lower.py).

The port's own copy of misaka_tpu/tis/disasm.py (the port imports nothing of
the JAX package).  Lowered programs are opaque int32 tables, so the trace
decoder (core/trace.py) and the debugger (debug.py) need a way back to
readable assembly.

Round trip: for any lowered program, `lower(parse(disassemble(code)))`
reproduces the same table.  Every source line is one instruction slot, so
the disassembly emits one line per row; an inline label prefix (`L3: ADD 1`)
occupies no slot, so jump targets get synthetic labels `L<line>` without
shifting any line number.  Label names, comments and blank-line placement
are lost (they all lower to the same table).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from misaka_tpu_torch.tis import isa


class TISDisasmError(ValueError):
    """Raised on malformed tables (unknown opcode / selector)."""


def _src_text(src: int, imm: int) -> str:
    if src == isa.SRC_IMM:
        return str(imm)
    if src == isa.SRC_ACC:
        return "ACC"
    if src == isa.SRC_NIL:
        return "NIL"
    if isa.SRC_R0 <= src <= isa.SRC_R3:
        return f"R{src - isa.SRC_R0}"
    raise TISDisasmError(f"unknown source selector {src}")


def _dst_text(dst: int) -> str:
    if dst == isa.DST_ACC:
        return "ACC"
    if dst == isa.DST_NIL:
        return "NIL"
    raise TISDisasmError(f"unknown destination selector {dst}")


_JUMP_NAMES = {
    isa.OP_JMP: "JMP",
    isa.OP_JEZ: "JEZ",
    isa.OP_JNZ: "JNZ",
    isa.OP_JGZ: "JGZ",
    isa.OP_JLZ: "JLZ",
}
_BARE = {isa.OP_NOP: "NOP", isa.OP_SWP: "SWP", isa.OP_SAV: "SAV", isa.OP_NEG: "NEG"}


def disassemble_line(
    fields: Sequence[int],
    lane_names: Sequence[str],
    stack_names: Sequence[str],
) -> str:
    """Render one instruction word (without any label prefix)."""
    op = int(fields[isa.F_OP])
    src = int(fields[isa.F_SRC])
    imm = int(fields[isa.F_IMM])
    dst = int(fields[isa.F_DST])
    tgt = int(fields[isa.F_TGT])
    port = int(fields[isa.F_PORT])
    jmp = int(fields[isa.F_JMP])

    if op in _BARE:
        return _BARE[op]
    if op == isa.OP_MOV_LOCAL:
        return f"MOV {_src_text(src, imm)}, {_dst_text(dst)}"
    if op == isa.OP_MOV_NET:
        return f"MOV {_src_text(src, imm)}, {lane_names[tgt]}:R{port}"
    if op == isa.OP_ADD:
        return f"ADD {_src_text(src, imm)}"
    if op == isa.OP_SUB:
        return f"SUB {_src_text(src, imm)}"
    if op in _JUMP_NAMES:
        return f"{_JUMP_NAMES[op]} L{jmp}"
    if op == isa.OP_JRO:
        return f"JRO {_src_text(src, imm)}"
    if op == isa.OP_PUSH:
        return f"PUSH {_src_text(src, imm)}, {stack_names[tgt]}"
    if op == isa.OP_POP:
        return f"POP {stack_names[tgt]}, {_dst_text(dst)}"
    if op == isa.OP_IN:
        return f"IN {_dst_text(dst)}"
    if op == isa.OP_OUT:
        return f"OUT {_src_text(src, imm)}"
    raise TISDisasmError(f"unknown opcode {op}")


def disassemble_program(
    code: np.ndarray,
    length: int | None = None,
    lane_names: Sequence[str] | None = None,
    stack_names: Sequence[str] | None = None,
) -> str:
    """Disassemble one lane's [L, NFIELDS] table to TIS source.

    `length` trims padding rows (pad_programs pads with unreachable NOPs);
    name sequences default to positional `node<i>` / `stack<i>`.
    """
    code = np.asarray(code)
    n = code.shape[0] if length is None else int(length)
    if lane_names is None or stack_names is None:
        max_tgt = int(code[:n, isa.F_TGT].max(initial=0)) if n else 0
        lane_names = lane_names or [f"node{i}" for i in range(max_tgt + 1)]
        stack_names = stack_names or [f"stack{i}" for i in range(max_tgt + 1)]

    targets = {
        int(code[i, isa.F_JMP])
        for i in range(n)
        if int(code[i, isa.F_OP]) in _JUMP_NAMES
    }
    lines = []
    for i in range(n):
        text = disassemble_line(code[i], lane_names, stack_names)
        if i in targets:
            text = f"L{i}: {text}"
        lines.append(text)
    return "\n".join(lines)


def disassemble_network(
    code: np.ndarray,
    prog_len: np.ndarray,
    lane_names: Sequence[str],
    stack_names: Sequence[str],
) -> dict[str, str]:
    """Disassemble a whole network's [N, L, NFIELDS] tables, keyed by lane name."""
    return {
        name: disassemble_program(code[i], int(prog_len[i]), lane_names, stack_names)
        for i, name in enumerate(lane_names)
    }
