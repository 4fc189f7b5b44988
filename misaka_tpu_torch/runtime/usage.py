"""The per-request program context: which registry program a thread serves.

The port's copy of the program-context piece of misaka_tpu/runtime/usage.py
(`_current`, `current_program`, `program_scope`, `DEFAULT_LABEL`).  The
program registry's lease (runtime/registry.py) makes the leased program
current on the serving thread for the request's lifetime, and
utils/jsonlog.py writes it as `program` on every line logged meanwhile.

The rest of the reference module, the per-program resource ledger (GET
/debug/usage, the `usage` block of a program's listing, the `cpu` quota
stage), is not ported yet (ROADMAP A.4): a listing's `usage` is null, as
the reference's is with MISAKA_USAGE=0.
"""

from __future__ import annotations

import contextlib
import contextvars

# the ledger label of the pre-registry single-program surface
DEFAULT_LABEL = "default"

_current: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "misaka_program", default=None
)


def current_program() -> str | None:
    """The program the emitting thread is serving (set by the registry
    lease), or None."""
    return _current.get()


@contextlib.contextmanager
def program_scope(program: str | None):
    """Make `program` current for a request's lifetime (no-op on None)."""
    if program is None:
        yield
        return
    token = _current.set(program)
    try:
        yield
    finally:
        _current.reset(token)
