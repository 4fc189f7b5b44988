"""ctypes bridge to the native C++ assembler (csrc/native/assembler.cpp).

The port's copy of misaka_tpu/tis/native.py.  The native assembler is a
functional twin of parser.py + lower.py, built with the host compiler on
first use (utils/nativelib.py).  `assemble()` is the entry point that
runtime/topology.py lowers through: it takes the native backend only for
a program of NATIVE_MIN_LINES lines or more, where it is faster than the
Python frontend, and the Python frontend for shorter ones and wherever no
compiler is available.

Known divergence: immediates beyond int64 range saturate in C++ but wrap in
Python; both are far outside the reference's int domain.
"""

from __future__ import annotations

import ctypes

import numpy as np

from misaka_tpu_torch.tis import isa
from misaka_tpu_torch.tis.lower import LoweredProgram, TISLowerError, lower_program
from misaka_tpu_torch.tis.parser import TISParseError
from misaka_tpu_torch.utils.nativelib import NativeLib

_MAX_LINES = 65536

# Below this many lines the ctypes round trip costs what the C++ parse
# saves, and a served network's programs are a few lines each; so short
# programs never build the library (chip_smoke.py's `native` phase times
# both backends by program length).
NATIVE_MIN_LINES = 16


def _configure(lib: ctypes.CDLL) -> None:
    lib.misaka_assemble.restype = ctypes.c_int
    lib.misaka_assemble.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int,
    ]


NATIVE = NativeLib("assembler", _configure)


def native_available() -> bool:
    return NATIVE.available()


def _ordered_names(ids: dict[str, int]) -> str:
    return "\n".join(name for name, _ in sorted(ids.items(), key=lambda kv: kv[1]))


def assemble_native(
    program: str, lane_ids: dict[str, int], stack_ids: dict[str, int]
) -> LoweredProgram:
    """Assemble via the C++ backend; raises like the Python frontend."""
    lib = NATIVE.load()
    if lib is None:
        raise RuntimeError("native assembler unavailable (no g++?)")
    n_lines = program.count("\n") + 1
    if n_lines > _MAX_LINES:
        raise TISLowerError(f"program too long ({n_lines} lines)")
    out = np.zeros((n_lines, isa.NFIELDS), dtype=np.int32)
    err = ctypes.create_string_buffer(512)
    rc = lib.misaka_assemble(
        program.encode(),
        _ordered_names(lane_ids).encode(),
        _ordered_names(stack_ids).encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_lines,
        err,
        len(err),
    )
    if rc < 0:
        msg = err.value.decode()
        # the Python frontend's exception taxonomy
        if "not a program node" in msg or "not a stack node" in msg:
            raise TISLowerError(msg)
        raise TISParseError(msg)
    return LoweredProgram(code=out[:rc], length=rc, source=program)


def assemble(
    program: str, lane_ids: dict[str, int], stack_ids: dict[str, int]
) -> LoweredProgram:
    """Native for a program of NATIVE_MIN_LINES lines or more when the
    library builds, the Python frontend otherwise."""
    if program.count("\n") + 1 >= NATIVE_MIN_LINES and native_available():
        return assemble_native(program, lane_ids, stack_ids)
    return lower_program(program, lane_ids, stack_ids)
