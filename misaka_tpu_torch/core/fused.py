"""The fused superstep: `num_steps` ticks of B instances in one kernel launch.

The port of misaka_tpu/core/fused.py::make_fused_runner.  On a CUDA tensor
`fused_superstep` launches the hand-written kernel of
csrc/fused_superstep.cu (one thread per instance, the whole chunk in one
launch); on a CPU tensor it runs `plain_run`, the torch tick loop over
core/step.py, which is the kernel's plain version.  There is no other
route: a CUDA state is run by the kernel or the call raises.

Layout: the kernel works on a structure-of-arrays [rows, B] copy of the
state (row r of instance b at r*B + b), so a warp reads 32 consecutive
words -- the TPU kernel's batch-last layout kept for coalescing.  The
wrapper converts the public [B, ...] `NetworkState` in and out once per
chunk (`_to_rows` / `_from_rows`), as fused.py's to_rows/from_rows do, and
rebases the rings after the ticks.  `in_buf`, `in_wr` and `out_rd` pass
through untouched.

The elided variant (fused.py:100-134's `elide_dead_hi`): given the
`hi_live` lane mask (`hi_live_mask`), the kernel keeps only the 32-bit low
words of lanes no 64-bit reader looks at, and leaves their `acc_hi`/`bak_hi`
at the entry values.  A mask that covers every lane is the full kernel, and
is launched and counted as such (`variant`).  On a CPU state the plain version runs either way: it
computes the full 64-bit state, which is what the elided kernel is held
against (every field exact but the dead lanes' hi planes, which must equal
their entry values).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from misaka_tpu_torch.core.state import BOOL_FIELDS, NetworkState, rebase_rings
from misaka_tpu_torch.core.step import step
from misaka_tpu_torch.tis import isa

KERNEL = "fused_superstep"
KERNEL_ELIDE = "fused_superstep_elide_hi"  # the same kernel, elided variant
KERNEL_DP = "fused_superstep_dp"  # the same kernel, once per mesh shard (parallel/mesh.py)
MAX_LANES = 32   # the kernel's compile-time lane bound (fused_superstep.cu)
MAX_STACKS = 16
SMEM_LIMIT = 227 * 1024  # shared memory one H100 block can use

# Launches of each kernel by its wrapper, counted where the kernel is
# launched and nowhere else.  chip_smoke.py zeroes and reads these.  A
# launch of the data-parallel runner counts under KERNEL_DP only, whichever
# variant it runs.
launch_counts = {KERNEL: 0, KERNEL_ELIDE: 0, KERNEL_DP: 0}

# the kernel's state arguments, in order; "sc" is the [5, B] scalar block
# (in_rd, in_wr, out_rd, out_wr, tick), every other name a state field the
# kernel updates in place as [rows, B]
_ARG_ORDER = (
    "acc", "bak", "acc_hi", "bak_hi", "pc", "port_val", "port_full",
    "hold_val", "holding", "stack_mem", "stack_top", "out_buf", "sc",
    "retired",
)
_ROW_FIELDS = tuple(f for f in _ARG_ORDER if f != "sc")
_lib: ctypes.CDLL | None = None


def plain_run(code: torch.Tensor, prog_len: torch.Tensor, state: NetworkState,
              num_steps: int) -> NetworkState:
    """The plain version: `num_steps` ticks of core/step.py, then the ring
    rebase -- what the kernel computes, one torch op at a time."""
    for _ in range(num_steps):
        state = step(code, prog_len, state)
    return rebase_rings(state)


def hi_live_lanes(code: np.ndarray, prog_len: np.ndarray) -> list[bool]:
    """Per lane: does its program read the 64-bit high word of ACC?  Only a
    conditional jump (JEZ/JNZ/JGZ/JLZ) or a JRO whose source is ACC does
    (misaka_tpu/core/fused.py:123-134)."""
    cond = (isa.OP_JEZ, isa.OP_JNZ, isa.OP_JGZ, isa.OP_JLZ)
    live = []
    for n in range(code.shape[0]):
        ops = code[n, : prog_len[n], isa.F_OP]
        srcs = code[n, : prog_len[n], isa.F_SRC]
        live.append(bool(np.isin(ops, cond).any()
                         or ((ops == isa.OP_JRO) & (srcs == isa.SRC_ACC)).any()))
    return live


def hi_live_mask(code: np.ndarray, prog_len: np.ndarray) -> int:
    """`hi_live_lanes` as the kernel's uint32 lane mask (bit n: lane n)."""
    return sum(1 << n for n, live in enumerate(hi_live_lanes(code, prog_len)) if live)


def check_kernel_bounds(n_lanes: int, n_stacks: int, max_len: int) -> None:
    """Raise ValueError naming the kernel bound a network exceeds."""
    if n_lanes > MAX_LANES:
        raise ValueError(
            f"network has {n_lanes} program lanes; the fused CUDA kernel "
            f"takes at most MAX_LANES={MAX_LANES}"
        )
    if n_stacks > MAX_STACKS:
        raise ValueError(
            f"network has {n_stacks} stacks; the fused CUDA kernel takes at "
            f"most MAX_STACKS={MAX_STACKS}"
        )
    smem = (n_lanes * max_len * isa.NFIELDS + n_lanes) * 4
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"program tables of {smem} bytes exceed the fused CUDA kernel's "
            f"shared-memory bound SMEM_LIMIT={SMEM_LIMIT}"
        )


def load_kernel() -> ctypes.CDLL:
    """Build (first call) and bind the kernel's C entry; raises without nvcc."""
    global _lib
    if _lib is None:
        from misaka_tpu_torch.csrc import build

        lib = build.load(KERNEL)
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.misaka_fused_superstep.argtypes = (
            [ptr, ptr] + [i] * 8 + [ctypes.c_uint] + [ptr] * 15 + [ptr]
        )
        lib.misaka_fused_superstep.restype = i
        _lib = lib
    return _lib


def variant(hi_live: int | None, n_lanes: int) -> str:
    """The launch-count key of what the kernel runs for `hi_live`: the full
    kernel for None or a mask that covers every lane (the C entry picks
    its full instantiation from the mask), the elided variant otherwise."""
    return KERNEL if hi_live in (None, (1 << n_lanes) - 1) else KERNEL_ELIDE


def _to_rows(x: torch.Tensor, batch: int) -> torch.Tensor:
    """[B, ...rest] -> an owned contiguous int32 [rows, B] copy.

    Always a fresh buffer: for a one-row field ([B, 1]) the transpose is
    already contiguous, and `.contiguous()` would hand the kernel the
    caller's own storage to update in place."""
    flat = x.reshape(batch, -1)
    out = torch.empty((flat.shape[1], batch), dtype=torch.int32, device=x.device)
    return out.copy_(flat.t())


def _from_rows(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[rows, B] -> `like`'s [B, ...] shape and dtype."""
    return y.t().reshape(like.shape).to(like.dtype)


def fused_superstep(code: torch.Tensor, prog_len: torch.Tensor,
                    state: NetworkState, num_steps: int,
                    hi_live: int | None = None,
                    count_as: str | None = None) -> NetworkState:
    """Advance a batched state `num_steps` ticks: the kernel on a CUDA
    state, the plain version on a CPU state.  `hi_live` (a lane mask from
    `hi_live_mask`) launches the elided variant unless it covers every
    lane; None the full kernel.  The launch is counted under `count_as`
    (None: the key of the variant it runs)."""
    dev = state.pc.device
    if dev.type == "cpu":
        return plain_run(code, prog_len, state, num_steps)
    if dev.type != "cuda":
        raise ValueError(f"fused_superstep runs on cuda or cpu tensors, not {dev}")
    n_lanes, max_len, nfields = code.shape
    batch, n_stacks, stack_cap = state.stack_mem.shape
    in_cap = state.in_buf.shape[-1]
    out_cap = state.out_buf.shape[-1]
    if nfields != isa.NFIELDS or prog_len.shape != (n_lanes,):
        raise ValueError(f"bad program tables: code {tuple(code.shape)}, "
                         f"prog_len {tuple(prog_len.shape)}")
    for name, t in (("code", code), ("prog_len", prog_len)):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on {dev}")
    lanes = (batch, n_lanes)
    shapes = dict(
        acc=lanes, bak=lanes, acc_hi=lanes, bak_hi=lanes, pc=lanes,
        port_val=lanes + (isa.NUM_PORTS,), port_full=lanes + (isa.NUM_PORTS,),
        hold_val=lanes, holding=lanes, stack_mem=(batch, n_stacks, stack_cap),
        stack_top=(batch, n_stacks), in_buf=(batch, in_cap), in_rd=(batch,),
        in_wr=(batch,), out_buf=(batch, out_cap), out_rd=(batch,),
        out_wr=(batch,), tick=(batch,), retired=lanes,
    )
    for name, shape in shapes.items():
        t = getattr(state, name)
        want = torch.bool if name in BOOL_FIELDS else torch.int32
        if t.device != dev or t.dtype != want or tuple(t.shape) != shape:
            raise ValueError(
                f"state.{name} must be {want} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    check_kernel_bounds(n_lanes, n_stacks, max_len)
    if num_steps < 0:
        raise ValueError(f"num_steps must be >= 0, got {num_steps}")
    if hi_live is not None and not 0 <= hi_live < (1 << n_lanes):
        raise ValueError(f"hi_live mask {hi_live:#x} names lanes beyond the "
                         f"network's {n_lanes}")

    mask = (1 << n_lanes) - 1 if hi_live is None else hi_live
    lib = load_kernel()
    with torch.cuda.device(dev):
        out = _launch(lib, code, prog_len, state, num_steps, mask,
                      torch.cuda.current_stream(dev).cuda_stream)
    launch_counts[count_as or variant(hi_live, n_lanes)] += 1
    return out


def _launch(lib, code: torch.Tensor, prog_len: torch.Tensor, state: NetworkState,
            num_steps: int, hi_live: int, stream) -> NetworkState:
    """One call of the C entry on [rows, B] copies of a checked state: the
    layout conversion in and out, the launch (`hi_live`: the kernel's lane
    mask), the ring rebase."""
    n_lanes, max_len, _ = code.shape
    batch, n_stacks, stack_cap = state.stack_mem.shape
    rows = {f: _to_rows(getattr(state, f), batch) for f in _ROW_FIELDS}
    rows["sc"] = torch.stack(
        [state.in_rd, state.in_wr, state.out_rd, state.out_wr, state.tick]
    ).contiguous()                                                  # [5, B]
    in_rows = _to_rows(state.in_buf, batch)
    err = lib.misaka_fused_superstep(
        code.data_ptr(), prog_len.data_ptr(),
        n_lanes, max_len, n_stacks, stack_cap, state.in_buf.shape[-1],
        state.out_buf.shape[-1], batch, num_steps, hi_live,
        *[rows[f].data_ptr() for f in _ARG_ORDER], in_rows.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_superstep launch failed: cudaError {err}")
    out = {f: _from_rows(rows[f], getattr(state, f)) for f in _ROW_FIELDS}
    sc = rows["sc"]
    return rebase_rings(state._replace(
        in_rd=sc[0].clone(), out_wr=sc[3].clone(), tick=sc[4].clone(), **out
    ))
