"""ctypes bridge to the native C++ superstep interpreter (csrc/native/interpreter.cpp).

The port's copy of misaka_tpu/core/cinterp.py.  A host executor with the
exact tick discipline of the kernel (core/step.py): the engine of the
native host tier (core/native_serve.py), and a third independent
implementation for differential testing.  `NativeInterpreter` steps one
instance; `NativePool` steps B replicas on a persistent C++ thread pool
(MISAKA_NATIVE_THREADS, default the core count) with the SIMD ladder
behind MISAKA_SIMD (auto: AVX2 where the CPU has it, generic, scalar).

The library is built from the port's copy of the source with the host
compiler on first use (utils/nativelib.py, ~1 s); `available()` reports
whether it loads.  State crosses the boundary as numpy arrays, always
copied in (import validates and copies) and exported into fresh buffers.
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading

import numpy as np

from misaka_tpu_torch.tis import isa
from misaka_tpu_torch.utils import metrics
from misaka_tpu_torch.utils.nativelib import NativeLib

# Lifecycle counters for the C++ handles (GET /metrics): a leak shows as
# created climbing without closed following — the native pool owns real OS
# threads, so this pair is the observable for the _close_runner discipline
# (runtime/master.py replaces engines on load/restore/autogrow).
_C_CREATED = metrics.counter(
    "misaka_native_engines_created_total",
    "Native C++ engine handles created, by kind", ("kind",),
)
_C_CLOSED = metrics.counter(
    "misaka_native_engines_closed_total",
    "Native C++ engine handles explicitly closed or GC-finalized, by kind",
    ("kind",),
)

_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _configure(lib: ctypes.CDLL) -> None:
    lib.misaka_interp_create.restype = ctypes.c_void_p
    lib.misaka_interp_create.argtypes = [_I32P, _I32P] + [ctypes.c_int] * 6
    lib.misaka_interp_destroy.restype = None
    lib.misaka_interp_destroy.argtypes = [ctypes.c_void_p]
    lib.misaka_interp_feed.restype = ctypes.c_int
    lib.misaka_interp_feed.argtypes = [ctypes.c_void_p, _I32P, ctypes.c_int]
    lib.misaka_interp_run.restype = None
    lib.misaka_interp_run.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.misaka_interp_drain.restype = ctypes.c_int
    lib.misaka_interp_drain.argtypes = [ctypes.c_void_p, _I32P, ctypes.c_int]
    lib.misaka_interp_seed_counters.restype = ctypes.c_int
    lib.misaka_interp_seed_counters.argtypes = [ctypes.c_void_p] + [ctypes.c_int32] * 4
    lib.misaka_interp_read.restype = None
    lib.misaka_interp_read.argtypes = [ctypes.c_void_p] + [
        _I32P, _I32P, _I32P, _I32P, _U8P, _I32P, _U8P,
        _I32P, _I32P, _I32P, _I32P, _I32P, _I32P, _I32P,
    ]
    lib.misaka_interp_read_in.restype = None
    lib.misaka_interp_read_in.argtypes = [ctypes.c_void_p, _I32P]
    lib.misaka_interp_write.restype = ctypes.c_int
    lib.misaka_interp_write.argtypes = [ctypes.c_void_p] + [
        _I32P, _I32P, _I32P, _I32P, _U8P, _I32P, _U8P,
        _I32P, _I32P, _I32P, _I32P, _I32P, _I32P, _I32P, _I32P,
    ]
    lib.misaka_pool_create.restype = ctypes.c_void_p
    lib.misaka_pool_create.argtypes = [_I32P, _I32P] + [ctypes.c_int] * 8
    lib.misaka_pool_destroy.restype = None
    lib.misaka_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.misaka_pool_threads.restype = ctypes.c_int
    lib.misaka_pool_threads.argtypes = [ctypes.c_void_p]
    _I64P = ctypes.POINTER(ctypes.c_int64)
    lib.misaka_pool_counters.restype = None
    lib.misaka_pool_counters.argtypes = [ctypes.c_void_p, _I64P]
    lib.misaka_pool_thread_counters.restype = ctypes.c_int
    lib.misaka_pool_thread_counters.argtypes = [
        ctypes.c_void_p, _I64P, _I64P, ctypes.c_int,
    ]
    lib.misaka_pool_serve.restype = ctypes.c_int
    lib.misaka_pool_serve.argtypes = [ctypes.c_void_p] + [
        _I32P, _I32P, _I32P, _I32P, _U8P, _I32P, _U8P,
        _I32P, _I32P, _I32P, _I32P, _I32P, _I32P, _I32P, _I32P,
        _I32P, _I32P, ctypes.c_int, _I32P, ctypes.c_int, _I32P,
    ]
    lib.misaka_pool_simd_info.restype = None
    lib.misaka_pool_simd_info.argtypes = [ctypes.c_void_p, _I32P]
    lib.misaka_spec_key.restype = ctypes.c_char_p
    lib.misaka_spec_key.argtypes = []
    # resident-state serving
    lib.misaka_interp_pack.restype = None
    lib.misaka_interp_pack.argtypes = [ctypes.c_void_p, _I32P, ctypes.c_int]
    _STATE15 = [
        _I32P, _I32P, _I32P, _I32P, _U8P, _I32P, _U8P,
        _I32P, _I32P, _I32P, _I32P, _I32P, _I32P, _I32P, _I32P,
    ]
    lib.misaka_pool_import.restype = ctypes.c_int
    lib.misaka_pool_import.argtypes = [ctypes.c_void_p] + _STATE15
    lib.misaka_pool_export.restype = ctypes.c_int
    lib.misaka_pool_export.argtypes = [ctypes.c_void_p] + _STATE15
    lib.misaka_pool_discard.restype = None
    lib.misaka_pool_discard.argtypes = [ctypes.c_void_p]
    lib.misaka_pool_is_resident.restype = ctypes.c_int
    lib.misaka_pool_is_resident.argtypes = [ctypes.c_void_p]
    lib.misaka_pool_serve_resident.restype = ctypes.c_int
    lib.misaka_pool_serve_resident.argtypes = [
        ctypes.c_void_p, _I32P, _I32P, ctypes.c_int, _I32P, ctypes.c_int,
        _I32P, _U8P, ctypes.c_int,
    ]
    # copy-and-patch JIT rung.  Absent from older builds loaded through
    # MISAKA_INTERP_SO: the ladder then tops out at
    # switch-threaded — jit_arm() reports rc -9 and the caller falls back.
    try:
        _VPP = ctypes.POINTER(ctypes.c_void_p)
        lib.misaka_pool_jit_arm.restype = ctypes.c_int
        lib.misaka_pool_jit_arm.argtypes = [
            ctypes.c_void_p, _VPP, _VPP, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.misaka_pool_jit_disarm.restype = None
        lib.misaka_pool_jit_disarm.argtypes = [ctypes.c_void_p]
    except AttributeError:
        pass
    # flight recorder
    lib.misaka_pool_trace_info.restype = None
    lib.misaka_pool_trace_info.argtypes = [ctypes.c_void_p, _I64P]
    lib.misaka_pool_trace_read.restype = ctypes.c_int
    lib.misaka_pool_trace_read.argtypes = [
        ctypes.c_void_p, ctypes.c_int, _I64P, ctypes.c_int, _I64P,
    ]
    lib.misaka_pool_trace_stats.restype = None
    lib.misaka_pool_trace_stats.argtypes = [ctypes.c_void_p, _I64P]
    lib.misaka_pool_trace_set.restype = ctypes.c_int
    lib.misaka_pool_trace_set.argtypes = [ctypes.c_void_p, ctypes.c_int]


NATIVE = NativeLib(
    "interpreter", _configure,
    so_env="MISAKA_INTERP_SO",  # an instrumented build, loaded as it is
)


def _load() -> ctypes.CDLL | None:
    return NATIVE.load()


def available() -> bool:
    return NATIVE.available()


# Per-program specialized builds (core/specialize.py): each cached .so is
# the full interpreter ABI compiled with one network's tables baked in.
# dlopen caches by path, but ctypes.CDLL re-runs symbol setup per call —
# keep one configured handle per path (never evicted: a handle must
# outlive every pool created from it, and the set is bounded by the
# registry's activation cache).
_SPEC_LIBS: dict[str, ctypes.CDLL] = {}
_SPEC_LIBS_LOCK = threading.Lock()


def load_specialized(path: str) -> ctypes.CDLL:
    """Load + configure a specialized interpreter .so.  Raises on any
    load/symbol failure — callers fall back to the generic library."""
    with _SPEC_LIBS_LOCK:
        lib = _SPEC_LIBS.get(path)
        if lib is None:
            lib = ctypes.CDLL(path)
            _configure(lib)
            if not lib.misaka_spec_key():  # a generic build is NOT a spec
                raise ValueError(f"{path} carries no specialization key")
            _SPEC_LIBS[path] = lib
        return lib


def _as_i32p(arr: np.ndarray):
    return arr.ctypes.data_as(_I32P)


_I32_INFO = np.iinfo(np.int32)


def _checked_i32(key: str, value, shape: tuple | None = None) -> np.ndarray:
    """Contiguous int32 array of `value`, REJECTING lossy casts: a wider
    integer (hand-edited/corrupt checkpoint) whose values exceed the int32
    range raises ValueError instead of silently wrapping — wrapped values
    can pass the C-side range validation while meaning something else."""
    a = np.asarray(value)
    if shape is not None and a.shape != shape:
        raise ValueError(f"{key}: expected shape {shape}, got {a.shape}")
    if a.dtype != np.int32:
        if a.dtype.kind not in "iub":
            raise ValueError(
                f"{key}: dtype {a.dtype} cannot carry int32 state exactly"
            )
        if a.dtype.kind in "iu" and a.size and not np.can_cast(a.dtype, np.int32):
            mn, mx = int(a.min()), int(a.max())
            if mn < _I32_INFO.min or mx > _I32_INFO.max:
                raise ValueError(
                    f"{key}: values [{mn}, {mx}] out of int32 range "
                    f"(corrupt or hand-edited state?)"
                )
    return np.ascontiguousarray(a, dtype=np.int32)


def _checked_i32_int(key: str, v) -> int:
    iv = int(v)
    if not (_I32_INFO.min <= iv <= _I32_INFO.max):
        raise ValueError(f"{key}: value {iv} out of int32 range")
    return iv


def _checked_u8(key: str, value, shape: tuple) -> np.ndarray:
    """Contiguous uint8 FLAG plane: truthiness-preserving conversion.

    astype(uint8) would wrap wide values (256 -> 0), flipping a truthy
    flag to False with no error — the same lossy-cast class _checked_i32
    rejects.  Flags are booleans, so convert by `!= 0` (any nonzero stays
    1) and reject non-integer dtypes outright."""
    a = np.asarray(value)
    if a.shape != shape:
        raise ValueError(f"{key}: expected shape {shape}, got {a.shape}")
    if a.dtype.kind not in "iub":
        raise ValueError(f"{key}: dtype {a.dtype} is not a valid flag plane")
    return np.ascontiguousarray(a != 0).astype(np.uint8)


class NativeInterpreter:
    """One network instance stepped by the C++ engine (Oracle-compatible API)."""

    def __init__(self, code, prog_len, num_stacks, stack_cap, in_cap, out_cap):
        lib = _load()
        if lib is None:
            raise RuntimeError("native interpreter unavailable (no g++?)")
        self._lib = lib
        code = np.ascontiguousarray(code, dtype=np.int32)
        prog_len = np.ascontiguousarray(prog_len, dtype=np.int32)
        if code.ndim != 3 or code.shape[2] != isa.NFIELDS:
            raise ValueError(
                f"code must be [n_lanes, max_len, {isa.NFIELDS}], got {code.shape}"
            )
        if prog_len.shape != (code.shape[0],):
            raise ValueError(
                f"prog_len must have shape ({code.shape[0]},), got {prog_len.shape}"
            )
        self.n_lanes, self.max_len, _ = code.shape
        self.num_stacks = max(1, num_stacks)
        self.stack_cap = stack_cap
        self.in_cap = in_cap
        self.out_cap = out_cap
        self._h = lib.misaka_interp_create(
            _as_i32p(code),
            _as_i32p(prog_len),
            self.n_lanes,
            self.max_len,
            self.num_stacks,
            stack_cap,
            in_cap,
            out_cap,
        )
        if not self._h:
            raise ValueError("invalid network tables")
        _C_CREATED.labels(kind="interp").inc()

    def close(self) -> None:
        if self._h:
            self._lib.misaka_interp_destroy(self._h)
            self._h = None
            _C_CLOSED.labels(kind="interp").inc()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _handle(self):
        if not self._h:
            raise RuntimeError("interpreter is closed")
        return self._h

    def feed(self, values) -> int:
        vals = np.ascontiguousarray(values, dtype=np.int32)
        return self._lib.misaka_interp_feed(self._handle(), _as_i32p(vals), len(vals))

    def run(self, ticks: int) -> None:
        self._lib.misaka_interp_run(self._handle(), int(ticks))

    def drain(self) -> list[int]:
        out = np.zeros((self.out_cap,), np.int32)
        got = self._lib.misaka_interp_drain(self._handle(), _as_i32p(out), self.out_cap)
        return out[:got].tolist()

    def seed_counters(self, in_rd: int, in_wr: int, out_rd: int, out_wr: int) -> None:
        """Set the ring counters directly (checkpoint restore / soak tests).

        Raises ValueError when the counters violate the ring invariants
        (0 <= rd <= wr, wr - rd <= cap) — the C side rejects them with the
        interpreter state unchanged."""
        rc = self._lib.misaka_interp_seed_counters(
            self._handle(), int(in_rd), int(in_wr), int(out_rd), int(out_wr)
        )
        if rc != 0:
            raise ValueError(
                f"invalid ring counters: in {in_rd}/{in_wr} (cap {self.in_cap}), "
                f"out {out_rd}/{out_wr} (cap {self.out_cap})"
            )

    def _read_raw(self) -> dict:
        """One misaka_interp_read into fresh buffers: the shared read path
        of state_arrays (differential view) and export_arrays (serving
        view) — a signature change lands in exactly one place."""
        n, s, cap = self.n_lanes, self.num_stacks, self.stack_cap
        d = {
            "acc": np.zeros(n, np.int32), "bak": np.zeros(n, np.int32),
            "acc_hi": np.zeros(n, np.int32), "bak_hi": np.zeros(n, np.int32),
            "pc": np.zeros(n, np.int32),
            "port_val": np.zeros((n, isa.NUM_PORTS), np.int32),
            "port_full": np.zeros((n, isa.NUM_PORTS), np.uint8),
            "hold_val": np.zeros(n, np.int32),
            "holding": np.zeros(n, np.uint8),
            "stack_mem": np.zeros((s, cap), np.int32),
            "stack_top": np.zeros(s, np.int32),
            "out_buf": np.zeros(self.out_cap, np.int32),
            "counters": np.zeros(5, np.int32),
            "retired": np.zeros(n, np.int32),
        }
        self._lib.misaka_interp_read(
            self._handle(),
            _as_i32p(d["acc"]), _as_i32p(d["bak"]), _as_i32p(d["pc"]),
            _as_i32p(d["port_val"]), d["port_full"].ctypes.data_as(_U8P),
            _as_i32p(d["hold_val"]), d["holding"].ctypes.data_as(_U8P),
            _as_i32p(d["stack_mem"]), _as_i32p(d["stack_top"]),
            _as_i32p(d["out_buf"]), _as_i32p(d["counters"]),
            _as_i32p(d["retired"]), _as_i32p(d["acc_hi"]),
            _as_i32p(d["bak_hi"]),
        )
        return d

    def pack(self, drain: bool = True) -> np.ndarray:
        """The serve_chunk packed row [in_rd, in_wr, out_rd, out_wr,
        out_buf...] straight off the interpreter, draining the output ring
        AFTER the snapshot when `drain` (the resident-state serve path:
        the counters + ring are the only per-chunk reads, so the full
        state export stays on the lifecycle paths).  With drain=False only
        the four counters are filled."""
        row = np.empty((4 + self.out_cap,), np.int32)
        self._lib.misaka_interp_pack(
            self._handle(), _as_i32p(row), 1 if drain else 0
        )
        return row

    def state_arrays(self) -> dict:
        """Mirror tests/oracle.py state_arrays for differential comparison."""
        d = self._read_raw()
        counters = d.pop("counters")
        d["port_full"] = d["port_full"].astype(bool)
        d["holding"] = d["holding"].astype(bool)
        d["stack_mem_used"] = d.pop("stack_mem")
        d["in_rd"] = counters[0]
        d["out_wr"] = counters[3]
        d["tick"] = counters[4]
        return d

    def export_arrays(self) -> dict:
        """COMPLETE state export for the serving engine: every NetworkState
        field (core/state.py), stack_mem zero-padded above each top.  The
        superset of state_arrays (which keeps its differential-comparison
        key set and naming)."""
        d = self._read_raw()
        counters = d.pop("counters")
        d["port_full"] = d["port_full"].astype(bool)
        d["holding"] = d["holding"].astype(bool)
        in_buf = np.zeros(self.in_cap, np.int32)
        self._lib.misaka_interp_read_in(self._handle(), _as_i32p(in_buf))
        d["in_buf"] = in_buf
        d["in_rd"], d["in_wr"] = counters[0], counters[1]
        d["out_rd"], d["out_wr"] = counters[2], counters[3]
        d["tick"] = counters[4]
        return d

    def import_arrays(self, d: dict) -> None:
        """Bulk state write — the inverse of export_arrays.  Raises
        ValueError (interpreter unchanged) on out-of-range pc/top/counters
        AND on wider-integer inputs whose values do not fit int32 (an unsafe
        cast would wrap them into the valid range — see _checked_i32)."""
        n, s = self.n_lanes, self.num_stacks

        def i32arr(key, shape):
            return _checked_i32(key, d[key], shape)

        def u8arr(key, shape):
            return _checked_u8(key, d[key], shape)

        acc = i32arr("acc", (n,)); bak = i32arr("bak", (n,))
        acc_hi = i32arr("acc_hi", (n,)); bak_hi = i32arr("bak_hi", (n,))
        pc = i32arr("pc", (n,))
        port_val = i32arr("port_val", (n, isa.NUM_PORTS))
        port_full = u8arr("port_full", (n, isa.NUM_PORTS))
        hold_val = i32arr("hold_val", (n,))
        holding = u8arr("holding", (n,))
        stack_mem = i32arr("stack_mem", (s, self.stack_cap))
        stack_top = i32arr("stack_top", (s,))
        in_buf = i32arr("in_buf", (self.in_cap,))
        out_buf = i32arr("out_buf", (self.out_cap,))
        retired = i32arr("retired", (n,))
        counters = np.ascontiguousarray(
            [_checked_i32_int(k, d[k])
             for k in ("in_rd", "in_wr", "out_rd", "out_wr", "tick")],
            dtype=np.int32,
        )
        rc = self._lib.misaka_interp_write(
            self._handle(),
            _as_i32p(acc), _as_i32p(bak), _as_i32p(pc),
            _as_i32p(port_val), port_full.ctypes.data_as(_U8P),
            _as_i32p(hold_val), holding.ctypes.data_as(_U8P),
            _as_i32p(stack_mem), _as_i32p(stack_top),
            _as_i32p(in_buf), _as_i32p(out_buf), _as_i32p(counters),
            _as_i32p(retired), _as_i32p(acc_hi), _as_i32p(bak_hi),
        )
        if rc != 0:
            raise ValueError(
                "invalid state import (pc/stack_top/ring counters out of range)"
            )


class NativePool:
    """B replica interpreters served by a persistent C++ OS-thread pool.

    The multi-threaded host serving tier: one `serve`/`idle` call runs a
    whole batched chunk iteration — per replica: import its state slice,
    feed, run `ticks`, snapshot a packed row, export — with the replica
    range sharded across threads inside ONE ctypes call (which releases the
    GIL, so C++ workers saturate cores while Python serves HTTP).  State
    lives in the caller's batch-major arrays between calls, exactly like
    the stateless single-instance NativeInterpreter serve path.
    """

    def __init__(self, code, prog_len, num_stacks, stack_cap, in_cap, out_cap,
                 replicas, threads: int | None = None,
                 lib: ctypes.CDLL | None = None):
        # `lib` overrides the shared generic library with a per-program
        # specialized build (load_specialized) — same ABI, baked tables
        if lib is None:
            lib = _load()
        if lib is None:
            raise RuntimeError("native interpreter unavailable (no g++?)")
        self._lib = lib
        code = np.ascontiguousarray(code, dtype=np.int32)
        prog_len = np.ascontiguousarray(prog_len, dtype=np.int32)
        if code.ndim != 3 or code.shape[2] != isa.NFIELDS:
            raise ValueError(
                f"code must be [n_lanes, max_len, {isa.NFIELDS}], got {code.shape}"
            )
        if prog_len.shape != (code.shape[0],):
            raise ValueError(
                f"prog_len must have shape ({code.shape[0]},), got {prog_len.shape}"
            )
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.n_lanes, self.max_len, _ = code.shape
        self.num_stacks = max(1, num_stacks)
        self.stack_cap = stack_cap
        self.in_cap = in_cap
        self.out_cap = out_cap
        self.replicas = int(replicas)
        if threads is None:
            threads = int(os.environ.get("MISAKA_NATIVE_THREADS", "0") or 0) \
                or (os.cpu_count() or 1)
        self._h = lib.misaka_pool_create(
            _as_i32p(code), _as_i32p(prog_len),
            self.n_lanes, self.max_len, self.num_stacks,
            stack_cap, in_cap, out_cap, self.replicas, int(threads),
        )
        if not self._h:
            raise ValueError("invalid network tables")
        self.threads = int(lib.misaka_pool_threads(self._h))
        # Serializes counter READS against destroy: the debug surfaces
        # (/metrics, /debug/usage, /debug/flamegraph) read counters() from
        # scrape threads while a registry eviction/hot-swap may close()
        # this pool — the _h None-check alone is TOCTOU-racy (a reader
        # past the check would dereference a freed C++ Pool).  serve/idle
        # stay outside the lock: only the device loop calls them, and the
        # engine quiesces before close by construction.
        self._ctr_lock = threading.Lock()
        # pack-row elision buffers (serve_resident(reuse_out=True)) and
        # the armed JIT program (kept alive: the C++ side holds raw
        # pointers into its executable buffer until disarm/close)
        self._packed_serve = None
        self._packed_idle = None
        self._progress_buf = None
        self._jit_prog = None
        _C_CREATED.labels(kind="pool").inc()

    def close(self) -> None:
        with self._ctr_lock:
            if self._h:
                self._lib.misaka_pool_destroy(self._h)
                self._h = None
                self._jit_prog = None  # exec buffer may now be unmapped
                _C_CLOSED.labels(kind="pool").inc()

    def __del__(self):
        try:
            # NEVER destroy the C++ pool during interpreter finalization:
            # a daemon device-loop thread may be frozen inside a
            # GIL-released serve call (CPython parks daemon threads at
            # their next GIL acquisition, so the C++ side keeps waiting on
            # cv_done) — destroying the condition variable under that
            # waiter is UB and aborts the whole process ("terminate called
            # without an active exception").  The OS reclaims the threads
            # and memory at exit anyway; explicit close() keeps the
            # quiesced-by-construction contract for normal lifecycles.
            if sys.is_finalizing():
                return
            self.close()
        except Exception:
            pass

    def _handle(self):
        if not self._h:
            raise RuntimeError("pool is closed")
        return self._h

    def simd_info(self) -> dict:
        """The pool's execution mode: {"width": replicas per SIMD group
        (0 = scalar per-replica path), "avx2": AVX2 instantiation selected,
        "specialized": per-program baked tick functions engaged, "jit":
        copy-and-patch fragment tables armed}."""
        out = np.zeros((4,), np.int32)
        with self._ctr_lock:
            self._lib.misaka_pool_simd_info(self._handle(), _as_i32p(out))
        return {
            "width": int(out[0]),
            "avx2": bool(out[1]),
            "specialized": bool(out[2]),
            "jit": bool(out[3]),
        }

    def jit_arm(self, prog) -> int:
        """Arm the copy-and-patch JIT rung with a core/jit.py
        JitProgram.  Returns the C rc: 0 armed (the pool now dispatches
        group ticks through the spliced fragments and this pool keeps the
        program's executable buffer alive), nonzero = pool unchanged, the
        caller serves one rung down (-1 ABI drift, -2 scalar pool, -3
        shape mismatch, -4 bad tables, -9 a library without the JIT entry)."""
        fn = getattr(self._lib, "misaka_pool_jit_arm", None)
        if fn is None:
            return -9
        with self._ctr_lock:
            rc = int(fn(self._handle(), prog.tab1, prog.tab2,
                        int(prog.n_lanes), int(prog.max_len),
                        int(prog.abi)))
        if rc == 0:
            self._jit_prog = prog
        return rc

    def jit_disarm(self) -> None:
        """Drop back to the switch-threaded / generic tick and release
        the pool's hold on the JIT program's executable buffer."""
        fn = getattr(self._lib, "misaka_pool_jit_disarm", None)
        with self._ctr_lock:
            if fn is not None and self._h:
                fn(self._h)
            self._jit_prog = None

    def counters(self) -> dict:
        """Pool busy/idle nanosecond counters (the usage-accounting plane):
        `busy_ns` is worker-thread time spent executing replica supersteps,
        `idle_ns` time parked awaiting work, `serial_ns` the small-pass
        fast path run on the calling thread.  Lock-free on the C++ side
        (safe concurrently with serve/idle); _ctr_lock only fences the
        read against a concurrent close() freeing the Pool."""
        out = np.zeros((5,), np.int64)
        with self._ctr_lock:
            self._lib.misaka_pool_counters(
                self._handle(),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
        return {
            "threads": self.threads,
            "busy_ns": int(out[0]),
            "idle_ns": int(out[1]),
            "serial_ns": int(out[2]),
            # the caller-inline lane, first-class: serial_ns IS
            # work booked on the calling thread (zero-handoff inline,
            # caller help, the small-pass fast path) — surfaced under
            # its own name, with work_ns the one total conservation
            # checks read instead of re-deriving busy + serial
            "caller_inline_ns": int(out[2]),
            "work_ns": int(out[0]) + int(out[2]),
            # pack-row elision: quiescent rows whose write into a
            # REUSED packed buffer was skipped vs actually written
            "elided_rows": int(out[3]),
            "skip_packed_rows": int(out[4]),
        }

    def thread_counters(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-thread (busy_ns, idle_ns) arrays — the skew diagnostic
        behind the aggregate counters()."""
        i64p = ctypes.POINTER(ctypes.c_int64)
        busy = np.zeros((self.threads,), np.int64)
        idle = np.zeros((self.threads,), np.int64)
        with self._ctr_lock:
            self._lib.misaka_pool_thread_counters(
                self._handle(), busy.ctypes.data_as(i64p),
                idle.ctypes.data_as(i64p), self.threads,
            )
        return busy, idle

    # --- flight recorder -----------------------------------------

    # Event kinds (csrc/native/interpreter.cpp TraceEv) and the rung/shape tag
    # decode for TEV_UNIT args — shared by native_serve's exporters.
    TRACE_EVENTS = {
        1: "serve", 2: "unit", 3: "spin", 4: "yield", 5: "park",
        6: "import", 7: "export", 8: "discard",
    }
    TRACE_RUNGS = {
        0: "scalar", 1: "generic", 2: "avx2",
        5: "spec-generic", 6: "spec-avx2",
        # bit 3 = copy-and-patch JIT armed; in practice the JIT
        # rides the generic lib (the spec switch tick outranks it inside
        # a specialized .so), so 9/10 are the live values
        9: "jit", 10: "jit-avx2", 13: "spec-jit", 14: "spec-avx2-jit",
    }
    TRACE_SHAPES = {0: "group", 1: "scalar", 2: "masked"}
    _TRACE_STAT_KEYS = (
        "spin_ns", "yield_ns", "park_ns", "wakes",
        "dispatch_calls", "dispatch_wait_ns", "last_dispatch_wait_ns",
        "last_unit_imbalance", "caller_units", "serve_calls",
        "inline_calls", "dropped",
    )

    def trace_info(self) -> dict:
        """Recorder shape: ring count (0 = MISAKA_NATIVE_TRACE=0 skipped
        the build), records per ring, armed flag, and the cumulative
        oldest-dropped (overwritten) record count across rings."""
        out = np.zeros((4,), np.int64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        with self._ctr_lock:
            self._lib.misaka_pool_trace_info(
                self._handle(), out.ctypes.data_as(i64p)
            )
        return {
            "rings": int(out[0]), "capacity": int(out[1]),
            "armed": bool(out[2]), "dropped": int(out[3]),
        }

    def trace_read(self, ring: int, max_records: int | None = None):
        """Snapshot one per-thread event ring without stopping the pool:
        (records [n, 4] int64 rows of [t0_ns, dur_ns, kind, arg] oldest
        first, cursor, dropped).  Ring `threads` is the calling thread's
        (serve lifecycle + caller-inline units + residency events).
        Raises ValueError on a bad ring index or an unbuilt recorder."""
        i64p = ctypes.POINTER(ctypes.c_int64)
        meta = np.zeros((2,), np.int64)
        with self._ctr_lock:
            info = np.zeros((4,), np.int64)
            self._lib.misaka_pool_trace_info(
                self._handle(), info.ctypes.data_as(i64p)
            )
            cap = int(info[1])
            want = cap if max_records is None else min(cap, int(max_records))
            buf = np.zeros((max(1, want), 4), np.int64)
            n = self._lib.misaka_pool_trace_read(
                self._handle(), int(ring), buf.ctypes.data_as(i64p),
                want, meta.ctypes.data_as(i64p),
            )
        if n < 0:
            raise ValueError(
                f"bad trace ring {ring} (recorder built: {bool(info[0])})"
            )
        return buf[:n], int(meta[0]), int(meta[1])

    def trace_stats(self) -> dict:
        """Cumulative recorder aggregates (lock-free relaxed reads on the
        C++ side): dispenser wait ns by phase, wake/dispatch/serve call
        counters, last dispatch wait + unit imbalance, caller-inline
        units, dropped records, and replicas ticked per (rung, shape)."""
        out = np.zeros((12 + 64,), np.int64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        with self._ctr_lock:
            self._lib.misaka_pool_trace_stats(
                self._handle(), out.ctypes.data_as(i64p)
            )
        d = {k: int(out[i]) for i, k in enumerate(self._TRACE_STAT_KEYS)}
        reps = {}
        for rung in range(16):
            for shape in range(4):
                v = int(out[12 + rung * 4 + shape])
                if v:
                    reps[(
                        self.TRACE_RUNGS.get(rung, f"rung{rung}"),
                        self.TRACE_SHAPES.get(shape, f"shape{shape}"),
                    )] = v
        d["reps"] = reps
        return d

    def trace_set(self, on: bool) -> bool:
        """Arm/disarm a built recorder at runtime (the overhead A/B's
        toggle).  False when MISAKA_NATIVE_TRACE=0 skipped the ring
        allocation at pool creation — there is nothing to arm."""
        with self._ctr_lock:
            if not self._h:
                return False
            return self._lib.misaka_pool_trace_set(
                self._h, 1 if on else 0
            ) >= 0

    # --- resident-state serving ----------------------------------

    def _state_ptrs(self, d: dict):
        """The 15 state-array pointers for the import/export ABI (import
        passes _checked arrays — the C++ side copies, no donation; export
        passes freshly-allocated buffers)."""
        return [
            _as_i32p(d["acc"]), _as_i32p(d["bak"]), _as_i32p(d["pc"]),
            _as_i32p(d["port_val"]), d["port_full"].ctypes.data_as(_U8P),
            _as_i32p(d["hold_val"]), d["holding"].ctypes.data_as(_U8P),
            _as_i32p(d["stack_mem"]), _as_i32p(d["stack_top"]),
            _as_i32p(d["in_buf"]), _as_i32p(d["out_buf"]),
            _as_i32p(d["_counters5"]), _as_i32p(d["retired"]),
            _as_i32p(d["acc_hi"]), _as_i32p(d["bak_hi"]),
        ]

    def import_state(self, d: dict) -> bool:
        """Arm C++ residency from a state dict (export_arrays keys, each
        with a leading [B] axis).  The arrays are validated exactly like a
        stateless serve (lossy casts raise ValueError) and COPIED into the
        resident store — no donation.  False when the C side rejects the
        state (pc/stack_top/ring violations): residency stays disarmed and
        the caller's arrays stay authoritative."""
        B, n, s = self.replicas, self.n_lanes, self.num_stacks
        c = {
            "acc": _checked_i32("acc", d["acc"], (B, n)),
            "bak": _checked_i32("bak", d["bak"], (B, n)),
            "acc_hi": _checked_i32("acc_hi", d["acc_hi"], (B, n)),
            "bak_hi": _checked_i32("bak_hi", d["bak_hi"], (B, n)),
            "pc": _checked_i32("pc", d["pc"], (B, n)),
            "port_val": _checked_i32(
                "port_val", d["port_val"], (B, n, isa.NUM_PORTS)
            ),
            "port_full": _checked_u8(
                "port_full", d["port_full"], (B, n, isa.NUM_PORTS)
            ),
            "hold_val": _checked_i32("hold_val", d["hold_val"], (B, n)),
            "holding": _checked_u8("holding", d["holding"], (B, n)),
            "stack_mem": _checked_i32(
                "stack_mem", d["stack_mem"], (B, s, self.stack_cap)
            ),
            "stack_top": _checked_i32("stack_top", d["stack_top"], (B, s)),
            "in_buf": _checked_i32("in_buf", d["in_buf"], (B, self.in_cap)),
            "out_buf": _checked_i32(
                "out_buf", d["out_buf"], (B, self.out_cap)
            ),
            "retired": _checked_i32("retired", d["retired"], (B, n)),
        }
        counters = np.empty((B, 5), np.int32)
        for i, k in enumerate(("in_rd", "in_wr", "out_rd", "out_wr", "tick")):
            counters[:, i] = _checked_i32(k, d[k], (B,))
        c["_counters5"] = counters
        rc = self._lib.misaka_pool_import(
            self._handle(), *self._state_ptrs(c)
        )
        return rc == 0

    def export_state(self) -> dict | None:
        """Non-destructive export of the resident state into fresh
        batch-major arrays (residency stays armed; None when it is not).
        The returned dict has the same key set serve() returns, so the
        caller can feed it straight back through the trusted stateless
        path or build a NetworkState from it."""
        B, n, s = self.replicas, self.n_lanes, self.num_stacks
        d = {
            "acc": np.empty((B, n), np.int32),
            "bak": np.empty((B, n), np.int32),
            "acc_hi": np.empty((B, n), np.int32),
            "bak_hi": np.empty((B, n), np.int32),
            "pc": np.empty((B, n), np.int32),
            "port_val": np.empty((B, n, isa.NUM_PORTS), np.int32),
            "port_full": np.empty((B, n, isa.NUM_PORTS), np.uint8),
            "hold_val": np.empty((B, n), np.int32),
            "holding": np.empty((B, n), np.uint8),
            "stack_mem": np.empty((B, s, self.stack_cap), np.int32),
            "stack_top": np.empty((B, s), np.int32),
            "in_buf": np.empty((B, self.in_cap), np.int32),
            "out_buf": np.empty((B, self.out_cap), np.int32),
            "retired": np.empty((B, n), np.int32),
            "_counters5": np.empty((B, 5), np.int32),
        }
        rc = self._lib.misaka_pool_export(
            self._handle(), *self._state_ptrs(d)
        )
        if rc != 0:
            return None
        counters = d["_counters5"]
        d["in_rd"] = counters[:, 0].copy()
        d["in_wr"] = counters[:, 1].copy()
        d["out_rd"] = counters[:, 2].copy()
        d["out_wr"] = counters[:, 3].copy()
        d["tick"] = counters[:, 4].copy()
        return d

    def discard_resident(self) -> None:
        """Disarm residency WITHOUT exporting — the caller replaced the
        state wholesale (load/restore) and the resident copy is
        superseded."""
        with self._ctr_lock:
            if self._h:
                self._lib.misaka_pool_discard(self._h)

    def is_resident(self) -> bool:
        with self._ctr_lock:
            if not self._h:
                return False
            return bool(self._lib.misaka_pool_is_resident(self._h))

    def serve_resident(self, values, counts, ticks: int, active=None,
                       reuse_out: bool = False):
        """One serve (counts given) or idle (counts None) pass on the
        RESIDENT state: no import, no export, no Python-side state dict at
        all.  Returns (packed, progress) — packed has EVERY row filled
        (skipped rows carry their current counters plus the
        drained-on-serve contract), progress[b]=1 when replica b retired
        an instruction this call (the device loop's hot-set signal).

        `reuse_out=True` enables pack-row elision: the pool keeps
        one packed/progress buffer pair per pass kind and hands the SAME
        arrays back every call, telling the C++ side their contents are
        its own previous output — quiescent replicas' rows are then
        skipped entirely instead of re-filled, removing the B-proportional
        light-fill cost on sparse batches.  The caller must treat the
        returned arrays as read-only and must not hold a row across the
        next call (copy what survives the iteration)."""
        B = self.replicas
        feeding = counts is not None
        reuse = 0
        if feeding:
            values = _checked_i32("values", values, (B, self.in_cap))
            counts = _checked_i32("counts", counts, (B,))
            if reuse_out:
                packed = self._packed_serve
                if packed is None:
                    packed = np.empty((B, 4 + self.out_cap), np.int32)
                    self._packed_serve = packed
                else:
                    reuse = 1
            else:
                packed = np.empty((B, 4 + self.out_cap), np.int32)
            vp, cp = _as_i32p(values), _as_i32p(counts)
        else:
            if reuse_out:
                packed = self._packed_idle
                if packed is None:
                    packed = np.empty((B, 4), np.int32)
                    self._packed_idle = packed
                else:
                    reuse = 1
            else:
                packed = np.empty((B, 4), np.int32)
            vp = cp = None
        ap, n_active = None, 0
        if active is not None:
            active = np.ascontiguousarray(active, dtype=np.int32)
            if active.ndim != 1:
                raise ValueError("active must be a flat replica index list")
            if active.size and (
                int(active[0]) < 0 or int(active[-1]) >= B
                or (np.diff(active) <= 0).any()
            ):
                raise ValueError(
                    "active must be strictly increasing replica indices "
                    f"in [0, {B})"
                )
            if feeding:
                skip = np.ones((B,), bool)
                skip[active] = False
                if (counts[skip] > 0).any():
                    raise ValueError(
                        "active must cover every replica with counts > 0 "
                        "(a skipped feed would silently drop values)"
                    )
            ap, n_active = _as_i32p(active), int(active.size)
        if reuse_out:
            progress = self._progress_buf
            if progress is None:
                progress = np.empty((B,), np.uint8)
                self._progress_buf = progress
        else:
            progress = np.empty((B,), np.uint8)
        rc = self._lib.misaka_pool_serve_resident(
            self._handle(), vp, cp, int(ticks), ap, n_active,
            _as_i32p(packed), progress.ctypes.data_as(_U8P), reuse,
        )
        if rc == -2:
            raise RuntimeError("native pool feed exceeded ring free space")
        if rc == -3:  # pragma: no cover — Python validated above
            raise ValueError("invalid active replica list")
        if rc == -4:
            raise RuntimeError("pool residency is not armed")
        return packed, progress

    def serve(self, d: dict, values, counts, ticks: int, active=None,
              trusted: bool = False):
        """One batched serve iteration.  `d` holds batch-major state arrays
        (export_arrays keys, each with a leading [B] axis); returns
        (new_d, packed [B, 4+out_cap]) with new_d the post-chunk state —
        output rings drained (the packed rows carry the pre-drain
        snapshot, device-twin parity).

        `active` (optional, strictly increasing replica indices) is the
        partial-fill fast path: only those replicas are imported, fed,
        run, and exported; skipped replicas' state is untouched — except
        that a skipped replica with an undrained output ring is drained
        here (its outputs land in its packed row), keeping the
        drained-on-serve contract uniform — and their packed rows carry
        their current counters.  Skipped replicas' ticks do NOT advance
        (instances stop being tick-lockstep under partial fill)."""
        if values is None or counts is None:
            raise ValueError("serve requires values and counts (use idle)")
        return self._call(d, values, counts, int(ticks), active, trusted)

    def idle(self, d: dict, ticks: int, active=None,
             trusted: bool = False):
        """One batched idle iteration: advance `ticks` with no feed; returns
        (new_d, ctrs [B, 4]) with the output rings NOT drained.  `active`
        restricts the pass like serve's (skipped rows: state untouched,
        ctrs row = current counters)."""
        return self._call(d, None, None, int(ticks), active, trusted)

    def _call(self, d, values, counts, ticks, active=None, trusted=False):
        B, n, s = self.replicas, self.n_lanes, self.num_stacks

        if trusted:
            # Identity fast path: `d` is EXACTLY the dict this pool produced
            # last call (NativeServePool round-trips it and asserts identity
            # before setting `trusted`) — every array is already contiguous,
            # writeable int32/uint8 state the C++ side itself exported, and
            # _counters5 is the live [B, 5] buffer whose public columns went
            # out as copies.  Re-validating it every iteration was ~40% of
            # the device-loop's serve-path Python under multi-tenant load.
            acc, bak = d["acc"], d["bak"]
            acc_hi, bak_hi = d["acc_hi"], d["bak_hi"]
            pc = d["pc"]
            port_val, port_full = d["port_val"], d["port_full"]
            hold_val, holding = d["hold_val"], d["holding"]
            stack_mem, stack_top = d["stack_mem"], d["stack_top"]
            in_buf, out_buf = d["in_buf"], d["out_buf"]
            retired = d["retired"]
            counters = d["_counters5"]
        else:
            # The C++ workers write the post-chunk state back INTO these
            # arrays.  `.numpy()` of a torch tensor shares the tensor's
            # memory (its `base` is the tensor), and a caller's state must
            # never be mutated: take ownership unless the array already
            # owns writeable memory.
            def own(key, shape):
                a = _checked_i32(key, d[key], shape)
                if a.base is not None or not a.flags.writeable:
                    a = np.array(a)
                return a

            def u8arr(key, shape):
                return _checked_u8(key, d[key], shape)

            acc = own("acc", (B, n))
            bak = own("bak", (B, n))
            acc_hi = own("acc_hi", (B, n))
            bak_hi = own("bak_hi", (B, n))
            pc = own("pc", (B, n))
            port_val = own("port_val", (B, n, isa.NUM_PORTS))
            port_full = u8arr("port_full", (B, n, isa.NUM_PORTS))
            hold_val = own("hold_val", (B, n))
            holding = u8arr("holding", (B, n))
            stack_mem = own("stack_mem", (B, s, self.stack_cap))
            stack_top = own("stack_top", (B, s))
            in_buf = own("in_buf", (B, self.in_cap))
            out_buf = own("out_buf", (B, self.out_cap))
            retired = own("retired", (B, n))
            counters = np.empty((B, 5), np.int32)
            for i, k in enumerate(
                ("in_rd", "in_wr", "out_rd", "out_wr", "tick")
            ):
                counters[:, i] = _checked_i32(k, d[k], (B,))
        feeding = counts is not None
        if feeding:
            values = _checked_i32("values", values, (B, self.in_cap))
            counts = _checked_i32("counts", counts, (B,))
            packed = np.empty((B, 4 + self.out_cap), np.int32)
            vp, cp = _as_i32p(values), _as_i32p(counts)
        else:
            packed = np.empty((B, 4), np.int32)
            vp = cp = None
        ap, n_active = None, 0
        if active is not None:
            active = np.ascontiguousarray(active, dtype=np.int32)
            if active.ndim != 1:
                raise ValueError("active must be a flat replica index list")
            if active.size and (
                int(active[0]) < 0 or int(active[-1]) >= B
                or (np.diff(active) <= 0).any()
            ):
                raise ValueError(
                    "active must be strictly increasing replica indices "
                    f"in [0, {B})"
                )
            # skipped replicas never reach the C++ side: their packed rows
            # carry their current counters here
            packed[:, :4] = counters[:, :4]
            skip = np.ones((B,), bool)
            skip[active] = False
            if feeding:
                if (counts[skip] > 0).any():
                    raise ValueError(
                        "active must cover every replica with counts > 0 "
                        "(a skipped feed would silently drop values)"
                    )
                # an undrained output ring on a skipped row (possible after
                # an idle chunk) is snapshotted + drained exactly like a
                # served row — the drained-on-serve contract stays uniform
                undrained = skip & (counters[:, 3] > counters[:, 2])
                if undrained.any():
                    packed[undrained, 4:] = out_buf[undrained]
                    counters[undrained, 2] = counters[undrained, 3]
            ap, n_active = _as_i32p(active), int(active.size)
        rc = self._lib.misaka_pool_serve(
            self._handle(),
            _as_i32p(acc), _as_i32p(bak), _as_i32p(pc),
            _as_i32p(port_val), port_full.ctypes.data_as(_U8P),
            _as_i32p(hold_val), holding.ctypes.data_as(_U8P),
            _as_i32p(stack_mem), _as_i32p(stack_top),
            _as_i32p(in_buf), _as_i32p(out_buf), _as_i32p(counters),
            _as_i32p(retired), _as_i32p(acc_hi), _as_i32p(bak_hi),
            vp, cp, ticks, ap, n_active, _as_i32p(packed),
        )
        if rc == -2:
            raise RuntimeError("native pool feed exceeded ring free space")
        if rc == -3:  # pragma: no cover — Python validated above
            raise ValueError("invalid active replica list")
        if rc != 0:
            raise ValueError(
                "invalid state import (pc/stack_top/ring counters out of range)"
            )
        out = {
            "acc": acc, "bak": bak, "acc_hi": acc_hi, "bak_hi": bak_hi,
            "pc": pc, "port_val": port_val, "port_full": port_full,
            "hold_val": hold_val, "holding": holding,
            "stack_mem": stack_mem, "stack_top": stack_top,
            "in_buf": in_buf, "out_buf": out_buf, "retired": retired,
            "in_rd": counters[:, 0].copy(), "in_wr": counters[:, 1].copy(),
            "out_rd": counters[:, 2].copy(), "out_wr": counters[:, 3].copy(),
            "tick": counters[:, 4].copy(),
            # the live counters buffer, for the trusted round-trip fast
            # path (consumers key NetworkState fields explicitly, so the
            # private entry never leaks into state construction)
            "_counters5": counters,
        }
        return out, packed
