"""Shared helpers of the tests that hold the port's native host tier
(misaka_tpu_torch/core/{cinterp,native_serve,specialize,jit}.py) against
misaka_tpu's.  Not a test module: the test_torch_native*.py files import it.
"""

import contextlib
import gc
import os

import numpy as np
import pytest

from misaka_tpu_torch.core import cinterp
from misaka_tpu_torch.core.state import NetworkState, state_to_numpy

# the native pools of these tests stay small and quiet on a shared box
POOL_ENV = {"MISAKA_NATIVE_THREADS": "2", "MISAKA_POOL_SPIN_US": "20"}


@pytest.fixture(autouse=True)
def small_pools(monkeypatch):
    for k, v in POOL_ENV.items():
        monkeypatch.setenv(k, v)


def handle_counts() -> dict:
    """Created and closed native handles of this process, by kind."""
    out = {}
    for kind in ("pool", "interp"):
        out[kind] = (cinterp._C_CREATED.labels(kind=kind).value,
                     cinterp._C_CLOSED.labels(kind=kind).value)
    return out


@pytest.fixture(scope="module", autouse=True)
def every_handle_closed():
    """Every native handle a test file creates is closed by its end."""
    before = handle_counts()
    yield
    gc.collect()
    after = handle_counts()
    for kind in after:
        made = after[kind][0] - before[kind][0]
        closed = after[kind][1] - before[kind][1]
        assert made == closed, f"{kind}: {made} created, {closed} closed"


@contextlib.contextmanager
def env(**kv):
    """Set (a value) or unset (None) environment variables for a block."""
    prev = {k: os.environ.get(k) for k in kv}
    try:
        for k, v in kv.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def masked_stack(mem, top):
    """stack_mem with the residue above each top zeroed: pops leave it in
    the torch and JAX steps, the interpreter's export zero-pads."""
    mem, top = np.asarray(mem), np.asarray(top)
    col = np.arange(mem.shape[-1])
    return np.where(col < top[..., None], mem, 0)


def arrays(state) -> dict:
    """Every field of a port (torch) or JAX state as numpy arrays."""
    if hasattr(state, "_fields") and hasattr(getattr(state, "acc"), "numpy") \
            and not hasattr(getattr(state, "acc"), "at"):
        return state_to_numpy(state)
    return {f: np.asarray(getattr(state, f)) for f in NetworkState._fields}


def assert_states_equal(a, b, msg: str = "", mask_stack: bool = True):
    a, b = arrays(a), arrays(b)
    for f in NetworkState._fields:
        x, y = a[f], b[f]
        if f == "stack_mem" and mask_stack:
            x, y = masked_stack(x, a["stack_top"]), masked_stack(y, b["stack_top"])
        np.testing.assert_array_equal(x, y, err_msg=f"{msg}: {f}")


def materialize(engine, state):
    """A resident engine's anchor has stale tensors: export first, as
    MasterNode._sync_native_state does."""
    exp = getattr(engine, "export_resident", None)
    got = exp(state) if exp is not None else None
    return got if got is not None else state
