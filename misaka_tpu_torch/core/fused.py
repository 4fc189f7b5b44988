"""The fused superstep: `num_steps` ticks of B instances in one kernel launch.

The port of misaka_tpu/core/fused.py::make_fused_runner.  On a CUDA tensor
`fused_superstep` launches the hand-written kernel of
csrc/fused_superstep.cu (one thread per instance, the whole chunk in one
launch); on a CPU tensor it runs `plain_run`, the torch tick loop over
core/step.py, which is the kernel's plain version.  There is no other
route: a CUDA state is run by the kernel or the call raises.

Program tables: `decode_lines` turns `code` [N, L, NFIELDS] and `prog_len`
into one 16-byte record per (line, lane), [L, N, 4] int32, with every
per-line decision the kernel would otherwise take per tick made once on the
host (which port a line consumes, the send destination checked against the
network, the stack index clipped, the next line modulo the program
length).  `CompiledNetwork.fused_runner` decodes once per runner.

Layout: the kernel reads and writes the public [B, ...] `NetworkState`
fields as they are.  The wrapper hands it an owned contiguous clone of
every field it writes (the caller's state is never touched) and passes
`in_buf`, which the kernel only reads, as it is: the returned state holds
the caller's own `in_buf` tensor.  The kernel rebases the rings itself
(core/state.py::rebase_rings), so it also writes `in_wr` and `out_rd`.

The elided variant (fused.py:100-134's `elide_dead_hi`): given the
`hi_live` lane mask (`hi_live_mask`), the kernel keeps only the 32-bit low
words of lanes no 64-bit reader looks at, and leaves their `acc_hi`/`bak_hi`
at the entry values.  A mask that covers every lane is the full kernel, and
is launched and counted as such (`variant`).  On a CPU state the plain
version runs either way: it computes the full 64-bit state, which is what
the elided kernel is held against (every field exact but the dead lanes' hi
planes, which must equal their entry values).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from misaka_tpu_torch.core.state import BOOL_FIELDS, NetworkState, rebase_rings
from misaka_tpu_torch.core.step import step
from misaka_tpu_torch.tis import isa
from misaka_tpu_torch.utils import profiling

KERNEL = "fused_superstep"
KERNEL_ELIDE = "fused_superstep_elide_hi"  # the same kernel, elided variant
KERNEL_DP = "fused_superstep_dp"  # the same kernel, once per mesh shard (parallel/mesh.py)
MAX_LANES = 32   # the kernel's compile-time lane bound (fused_superstep.cu)
MAX_STACKS = 16
SMEM_LIMIT = 227 * 1024  # shared memory one H100 block can use
HI_FULL, HI_MASK, HI_DEAD = 0, 1, 2  # the kernel's instantiations per lane bound

# The line record shared with csrc/fused_superstep.cu: int32 words
# (imm, ctl, arg, jumps).  ctl: bits 0-4 op, 5-6 source kind, 7 "writes
# ACC", 24-31 the port index pass 1 consumes (NO_PORT: none).  jumps: bits
# 0-15 the jump target (JMP..JLZ) or len-1, bits 16-31 (line + 1) % len.
REC_WORDS = 4
K_IMM, K_ACC, K_PORT, K_HOLD = 0, 1, 2, 3
CTL_WRITES_ACC = 1 << 7
NO_PORT = 0xFF

# Launches of each kernel by its wrapper, counted where the kernel is
# launched and nowhere else.  chip_smoke.py zeroes and reads these.  A
# launch of the data-parallel runner counts under KERNEL_DP only, whichever
# variant it runs.
launch_counts = {KERNEL: 0, KERNEL_ELIDE: 0, KERNEL_DP: 0}

# every state field but in_buf: the kernel writes each (an owned clone)
_WRITTEN = tuple(f for f in NetworkState._fields if f != "in_buf")
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


def decode_lines(code: np.ndarray, prog_len: np.ndarray, n_stacks: int) -> np.ndarray:
    """The kernel's line records, [L, N, REC_WORDS] int32 (line-major, so a
    tick's lanes read neighbouring records): what core/phases.py and
    core/step.py decide from a lane's line, decided once.

    Raises ValueError on tables the records cannot hold: a program length
    outside [1, L], or a jump target outside the table."""
    code = np.asarray(code, dtype=np.int32)
    prog_len = np.asarray(prog_len, dtype=np.int32)
    n_lanes, max_len, _ = code.shape
    if max_len > 0xFFFF:
        raise ValueError(f"{max_len} lines per program; the line records hold 65535")
    if ((prog_len < 1) | (prog_len > max_len)).any():
        raise ValueError(f"program lengths {prog_len.tolist()} outside [1, {max_len}]")
    f = {name: code[..., getattr(isa, f"F_{name.upper()}")]
         for name in ("op", "src", "imm", "dst", "tgt", "port", "jmp")}
    # an opcode outside the ISA reads nothing and changes nothing: a NOP
    op = np.where((f["op"] >= 0) & (f["op"] < isa.NUM_OPS), f["op"], isa.OP_NOP)
    src = f["src"]
    reads = np.isin(op, isa.READS_SRC)
    kind = np.select(
        [~reads, src == isa.SRC_ACC, src >= isa.SRC_R0,
         (src == isa.SRC_IMM) | (src == isa.SRC_NIL)],
        [K_IMM, K_ACC, K_PORT, K_IMM], K_HOLD)  # K_HOLD: step.py's else-branch
    imm = np.where(reads & (src == isa.SRC_IMM), f["imm"], 0)
    lane = np.arange(n_lanes, dtype=np.int64)[:, None]
    consumed = np.where(
        kind == K_PORT, lane * isa.NUM_PORTS + np.clip(src - isa.SRC_R0, 0, isa.NUM_PORTS - 1),
        NO_PORT)
    ctl = (op.astype(np.int64) | (kind << 5) | ((f["dst"] == isa.DST_ACC) * CTL_WRITES_ACC)
           | (consumed << 24))
    with np.errstate(over="ignore"):  # step.py's int32 arithmetic wraps
        dest = f["tgt"] * np.int32(isa.NUM_PORTS) + f["port"]
    arg = np.where(
        op == isa.OP_MOV_NET,
        np.where((dest >= 0) & (dest < n_lanes * isa.NUM_PORTS), dest, -1),
        np.where((op == isa.OP_PUSH) | (op == isa.OP_POP),
                 np.clip(f["tgt"], 0, n_stacks - 1), 0))
    is_jump = (op >= isa.OP_JMP) & (op <= isa.OP_JLZ)
    bad = is_jump & ((f["jmp"] < 0) | (f["jmp"] >= max_len))
    if bad.any():
        n, line = map(int, np.argwhere(bad)[0])
        raise ValueError(f"lane {n} line {line} jumps to {int(f['jmp'][n, line])}, "
                         f"outside the {max_len}-line table")
    low = np.where(is_jump, f["jmp"], prog_len[:, None] - 1).astype(np.int64)
    nxt = (np.arange(1, max_len + 1, dtype=np.int64)[None, :] % prog_len[:, None])
    words = np.stack([imm.astype(np.int64), ctl, arg.astype(np.int64), low | (nxt << 16)], -1)
    return np.ascontiguousarray(
        (words & 0xFFFFFFFF).astype(np.uint32).view(np.int32).transpose(1, 0, 2))


def line_records(code: np.ndarray, prog_len: np.ndarray, n_stacks: int,
                 device) -> torch.Tensor:
    """`decode_lines` as a tensor on `device`, the kernel's `records`."""
    return torch.from_numpy(decode_lines(code, prog_len, n_stacks)).to(device)


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
    smem = n_lanes * max_len * REC_WORDS * 4
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"line records of {smem} bytes exceed the fused CUDA kernel's "
            f"shared-memory bound SMEM_LIMIT={SMEM_LIMIT}"
        )


def load_kernel() -> ctypes.CDLL:
    """Build (first call) and bind the kernel's C entries; raises without nvcc."""
    global _lib
    if _lib is None:
        from misaka_tpu_torch.csrc import build

        lib = build.load(KERNEL)
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.misaka_fused_superstep.argtypes = (
            [ptr, ptr] + [i] * 8 + [ctypes.c_uint]
            + [ptr] * len(NetworkState._fields) + [ptr]
        )
        lib.misaka_fused_superstep.restype = i
        lib.misaka_fused_occupancy.argtypes = [i, i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.misaka_fused_occupancy.restype = i
        _lib = lib
    return _lib


def occupancy(n_lanes: int, max_len: int, hi_mode: int) -> tuple[int, int]:
    """(resident blocks per SM, threads per block) of the instantiation that
    runs `n_lanes` lanes of `max_len`-line tables in `hi_mode` (HI_FULL,
    HI_MASK or HI_DEAD), with the shared memory its launch reserves for the
    line records, as the CUDA runtime reports them for the current card."""
    blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
    err = load_kernel().misaka_fused_occupancy(n_lanes, max_len, hi_mode,
                                               ctypes.byref(blocks), ctypes.byref(threads))
    if err != 0:
        raise RuntimeError(f"misaka_fused_occupancy failed: cudaError {err}")
    return blocks.value, threads.value


def variant(hi_live: int | None, n_lanes: int) -> str:
    """The launch-count key of what the kernel runs for `hi_live`: the full
    kernel for None or a mask that covers every lane (the C entry picks
    its full instantiation from the mask), the elided variant otherwise."""
    return KERNEL if hi_live in (None, (1 << n_lanes) - 1) else KERNEL_ELIDE


def fused_superstep(code: torch.Tensor, prog_len: torch.Tensor,
                    state: NetworkState, num_steps: int,
                    hi_live: int | None = None,
                    count_as: str | None = None, *,
                    records: torch.Tensor | None) -> NetworkState:
    """Advance a batched state `num_steps` ticks: the kernel on a CUDA
    state, the plain version on a CPU state.  `hi_live` (a lane mask from
    `hi_live_mask`) launches the elided variant unless it covers every
    lane; None the full kernel.  The launch is counted under `count_as`
    (None: the key of the variant it runs).  `records` are the kernel's
    line records for these tables (`line_records`), which a CUDA state
    needs; the plain version reads the tables themselves."""
    dev = state.pc.device
    if dev.type == "cpu":
        return plain_run(code, prog_len, state, num_steps)
    if dev.type != "cuda":
        raise ValueError(f"fused_superstep runs on cuda or cpu tensors, not {dev}")
    # the host work around the launch, as ranges of a capture that records
    # this thread (utils/profiling.py::mark)
    with profiling.mark("misaka.checks_clones"):
        _check_args(code, prog_len, state, num_steps, hi_live, records)
        n_lanes = code.shape[0]
        mask = (1 << n_lanes) - 1 if hi_live is None else hi_live
        lib = load_kernel()
        out = {f: getattr(state, f).clone(memory_format=torch.contiguous_format)
               for f in _WRITTEN}
    with torch.cuda.device(dev), profiling.mark("misaka.kernel_launch"):
        out = _launch(lib, records, prog_len, state, out, num_steps, mask,
                      torch.cuda.current_stream(dev).cuda_stream)
    launch_counts[count_as or variant(hi_live, n_lanes)] += 1
    return out


def _check_args(code, prog_len, state, num_steps, hi_live, records) -> None:
    """Raise ValueError unless the tables, records and every state field
    are what the kernel reads: contiguous int32 (bool) tensors of the
    network's shapes on the state's device, within the kernel's bounds."""
    dev = state.pc.device
    n_lanes, max_len, nfields = code.shape
    batch, n_stacks, stack_cap = state.stack_mem.shape
    in_cap = state.in_buf.shape[-1]
    out_cap = state.out_buf.shape[-1]
    if nfields != isa.NFIELDS or prog_len.shape != (n_lanes,):
        raise ValueError(f"bad program tables: code {tuple(code.shape)}, "
                         f"prog_len {tuple(prog_len.shape)}")
    if records is None:
        raise ValueError("a CUDA state needs the kernel's line records (line_records)")
    for name, t in (("code", code), ("prog_len", prog_len), ("records", records)):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on {dev}")
    if tuple(records.shape) != (max_len, n_lanes, REC_WORDS):
        raise ValueError(f"records {tuple(records.shape)} do not match code "
                         f"{tuple(code.shape)}")
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


def _launch(lib, records: torch.Tensor, prog_len: torch.Tensor, state: NetworkState,
            out: dict, num_steps: int, hi_live: int, stream) -> NetworkState:
    """One call of the C entry on a checked state: `out` holds an owned
    contiguous clone of every field the kernel writes, `in_buf` is read
    where it lies (`hi_live`: the kernel's lane mask).  The ring rebase
    happens in the kernel."""
    max_len, n_lanes, _ = records.shape
    batch, n_stacks, stack_cap = state.stack_mem.shape
    in_buf = state.in_buf.contiguous()  # the caller's tensor when it already is
    args = [in_buf if f == "in_buf" else out[f] for f in NetworkState._fields]
    err = lib.misaka_fused_superstep(
        records.data_ptr(), prog_len.data_ptr(),
        n_lanes, max_len, n_stacks, stack_cap, state.in_buf.shape[-1],
        state.out_buf.shape[-1], batch, num_steps, hi_live,
        *[t.data_ptr() for t in args], stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_superstep launch failed: cudaError {err}")
    return state._replace(**out)
