"""Integer math helpers — host-side parity with the reference's utils/math.go.

The port's copy of misaka_tpu/utils/intmath.py.  The reference exposes
IntMax/IntMin/IntClamp (math.go:4-22), with clamp used only by JRO
(program.go:354,:362).  In the port's step that clamp is dense tensor
arithmetic (core/regs64.py jro_target); these host-side twins exist for
tooling and tests that need the exact same scalar semantics without
importing torch.
"""

from __future__ import annotations


def int_max(a: int, b: int) -> int:
    """math.go:4-9."""
    return a if a > b else b


def int_min(a: int, b: int) -> int:
    """math.go:11-16."""
    return a if a < b else b


def int_clamp(v: int, lo: int, hi: int) -> int:
    """math.go:18-22 — clamp v into [lo, hi] (the JRO bound, program.go:354)."""
    return int_max(lo, int_min(v, hi))
