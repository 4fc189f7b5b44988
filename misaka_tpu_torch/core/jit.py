"""Copy-and-patch JIT: the top rung of the native tick ladder.

The port's copy of misaka_tpu/core/jit.py.

``csrc/native/stencils.cpp`` holds one parameterized machine-code fragment per
(instruction kind, pass) — semantically identical to the matching arm of
``group_tick`` in ``csrc/native/interpreter.cpp``.  This module compiles that
library ONCE per toolchain/source version (content-keyed ``.o`` in the
same on-disk cache ``core/specialize.py`` uses), parses the fragments and
their relocation tables straight out of the object file, and then — per
activated program — splices fragments per (lane, pc) into an executable
buffer, patching the parameter holes (plane bases, immediates, pc
successors, jump targets) as 64-bit immediates.  Activation cost is a few
dict lookups and ``memmove``s, not a C++ compile; steady-state ticks beat
the switch-threaded tier because dispatch, field reads, and pc advances
are all baked into straight-line code.

Ladder discipline (same contract as specialize.py):

* **Kill switch**: ``MISAKA_JIT=0`` disables the layer entirely.
* **Graceful fallback**: ANY failure — no toolchain, a relocation the
  splicer does not recognize (the self-containment check), mmap/mprotect
  (W^X) failure, ABI drift between interpreter.cpp and stencils.cpp —
  logs, counts on ``misaka_native_jit_total{status=...}``, and returns
  ``None``: the caller falls back ONE rung (switch-threaded / generic),
  never errors a serve.
* **Bit-identity**: fragments mirror ``group_tick`` arm-for-arm, pinned
  by tests/test_torch_jit.py's differential corpus against the scalar, generic,
  avx2, and switch-threaded rungs.

W^X: the buffer is populated while PROT_READ|PROT_WRITE and flipped to
PROT_READ|PROT_EXEC before any pointer escapes — it is never writable and
executable at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import struct
import threading

import numpy as np

from misaka_tpu_torch.core import specialize
from misaka_tpu_torch.tis import isa
from misaka_tpu_torch.utils import faults
from misaka_tpu_torch.utils import metrics
from misaka_tpu_torch.utils import nativelib

log = logging.getLogger("misaka.jit")

_SRC = str(nativelib.NATIVE_SRC / "stencils.cpp")

JIT_VERSION = 1  # bump to invalidate every cached stencil library

# Must match csrc/native/interpreter.cpp + csrc/native/stencils.cpp; the pool's arm
# call rejects a mismatch (rc -1) and the ladder falls back one rung.
MISAKA_JIT_ABI = 1

# The stencil compile contract: no PIC/GOT (holes become movabs imm64
# with R_X86_64_64 relocations), no jump tables / stack protector /
# unwind tables (nothing outside the fragment's own section), one section
# per fragment so splicing is a byte-range copy.
_CXXFLAGS = [
    "-O2", "-std=c++17", "-c", "-fno-pic", "-mcmodel=large",
    "-fno-jump-tables", "-fno-stack-protector", "-fno-exceptions",
    "-fno-rtti", "-fomit-frame-pointer", "-fno-asynchronous-unwind-tables",
    "-ffunction-sections", "-Wall", "-Wextra", "-Werror",
]

M_JIT = metrics.counter(
    "misaka_native_jit_total",
    "Copy-and-patch JIT outcomes (hit = cached stencil library reused, "
    "built = fresh stencil compile, spliced = program fragments patched "
    "into an executable buffer, armed = pool dispatching JIT ticks, "
    "error = any failure -> one rung down, disabled = kill switch or "
    "unsupported arch)",
    ("status",),
)
G_JIT_CODE_BYTES = metrics.gauge(
    "misaka_native_jit_code_bytes",
    "Executable bytes in the most recently spliced JIT program",
)
G_JIT_FRAGMENTS = metrics.gauge(
    "misaka_native_jit_fragments",
    "Distinct patched fragments in the most recently spliced JIT program "
    "(identical (stencil, params) fragments are shared across the table)",
)


def enabled() -> bool:
    """MISAKA_JIT kill switch (default on where supported)."""
    return os.environ.get("MISAKA_JIT", "1") not in ("0", "off")


def supported() -> bool:
    """Stencils are x86-64 machine code; every other arch falls back to
    the switch-threaded tier."""
    return platform.machine() in ("x86_64", "AMD64")


class JitError(RuntimeError):
    """Stencil library violates the self-containment contract."""


# --- stencil library: compile once, content-keyed ---------------------------

_lib_lock = threading.Lock()
_lib_cache: dict[str, "StencilLibrary"] = {}


def stencil_key() -> str:
    """Content key for the compiled library: JIT version + stencil source
    + compile flags (a source or flag change rebuilds, old entries age out
    of the shared cache LRU)."""
    h = hashlib.sha256()
    h.update(f"jit{JIT_VERSION}:{nativelib.src_hash(_SRC)}:".encode())
    h.update(" ".join(_CXXFLAGS).encode())
    return h.hexdigest()[:16]


def build_stencils(cache_dir: str | None = None) -> str | None:
    """Compile (or reuse) the stencil object file; None on any failure."""
    cache_dir = cache_dir or specialize.default_cache_dir()
    key = stencil_key()
    path = os.path.join(cache_dir, f"stencils-{key}.o")
    if os.path.exists(path):
        try:
            os.utime(path, None)  # LRU touch (shared cache prune)
        except OSError:
            pass
        M_JIT.labels(status="hit").inc()
        return path
    try:
        os.makedirs(cache_dir, exist_ok=True)
        nativelib.compile_atomic([*_CXXFLAGS, _SRC], path)
    except Exception as exc:  # noqa: BLE001 - total fallback contract
        log.warning("jit: stencil build failed: %s", exc)
        M_JIT.labels(status="error").inc()
        return None
    M_JIT.labels(status="built").inc()
    return path


# --- ELF64 relocatable-object parsing ---------------------------------------

_SHT_SYMTAB = 2
_SHT_RELA = 4
_R_X86_64_64 = 1


class Stencil:
    """One fragment: its machine code and the (offset, hole, addend)
    patch sites inside it."""

    __slots__ = ("code", "holes")

    def __init__(self, code: bytes, holes: list[tuple[int, int, int]]):
        self.code = code
        self.holes = holes


def _cstr(buf: bytes, off: int) -> str:
    end = buf.index(b"\0", off)
    return buf[off:end].decode("ascii", errors="replace")


def _parse_stencils(path: str) -> dict[str, Stencil]:
    """Extract every ``misaka_st*`` fragment + its relocations from the
    object file.  Raises JitError on anything outside the contract — a
    truncated/corrupted file, a relocation that is not R_X86_64_64
    against a ``misaka_hole_K`` symbol (the fragment would reference
    memory the splicer cannot provide), or a hole outside the fragment."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 64 or data[:4] != b"\x7fELF":
        raise JitError("not an ELF object")
    if data[4] != 2 or data[5] != 1:
        raise JitError("not a little-endian ELF64 object")
    (e_shoff,) = struct.unpack_from("<Q", data, 0x28)
    (e_shentsize, e_shnum, e_shstrndx) = struct.unpack_from("<HHH", data, 0x3A)
    if e_shentsize != 64 or e_shoff + e_shnum * 64 > len(data):
        raise JitError("truncated section table")

    def sh(i: int) -> tuple[int, int, int, int, int, int]:
        off = e_shoff + i * 64
        name, typ = struct.unpack_from("<II", data, off)
        s_off, size = struct.unpack_from("<QQ", data, off + 24)
        link, info = struct.unpack_from("<II", data, off + 40)
        return name, typ, s_off, size, link, info

    _, _, shstr_off, shstr_size, _, _ = sh(e_shstrndx)
    shstrtab = data[shstr_off:shstr_off + shstr_size]

    # symbol table -> (name, shndx, value, size) per symbol index
    symtab_idx = next(
        (i for i in range(e_shnum) if sh(i)[1] == _SHT_SYMTAB), None)
    if symtab_idx is None:
        raise JitError("no symbol table")
    _, _, sym_off, sym_size, sym_link, _ = sh(symtab_idx)
    _, _, str_off, str_size, _, _ = sh(sym_link)
    strtab = data[str_off:str_off + str_size]
    if sym_off + sym_size > len(data):
        raise JitError("truncated symbol table")
    syms = []
    for off in range(sym_off, sym_off + sym_size, 24):
        name_off, = struct.unpack_from("<I", data, off)
        shndx, = struct.unpack_from("<H", data, off + 6)
        value, size = struct.unpack_from("<QQ", data, off + 8)
        syms.append((_cstr(strtab, name_off) if name_off else "",
                     shndx, value, size))

    # fragment sections: one function per section (-ffunction-sections)
    frags: dict[int, tuple[str, int, int, int]] = {}  # shndx -> (name, ...)
    for name, shndx, value, size in syms:
        if not name.startswith("misaka_st") or shndx == 0:
            continue
        _, typ, s_off, s_size, _, _ = sh(shndx)
        if value + size > s_size or size == 0:
            raise JitError(f"fragment {name} outside its section")
        frags[shndx] = (name, s_off, value, size)

    out: dict[str, Stencil] = {}
    holes_by_sec: dict[int, list[tuple[int, int, int]]] = {}
    for i in range(e_shnum):
        _, typ, r_off, r_size, _, r_info = sh(i)
        if typ != _SHT_RELA or r_info not in frags:
            continue
        if r_off + r_size > len(data):
            raise JitError("truncated relocation table")
        sites = holes_by_sec.setdefault(r_info, [])
        for off in range(r_off, r_off + r_size, 24):
            rel_off, rel_info, addend = struct.unpack_from("<QQq", data, off)
            rtype = rel_info & 0xFFFFFFFF
            sym = syms[rel_info >> 32]
            if rtype != _R_X86_64_64 or not sym[0].startswith("misaka_hole_"):
                raise JitError(
                    f"{frags[r_info][0]}: unsupported relocation "
                    f"(type {rtype} against {sym[0] or '?'})")
            hole = int(sym[0][len("misaka_hole_"):])
            sites.append((rel_off, hole, addend))
    for shndx, (name, s_off, value, size) in frags.items():
        code = data[s_off + value:s_off + value + size]
        holes = []
        for rel_off, hole, addend in holes_by_sec.get(shndx, []):
            site = rel_off - value
            if site < 0 or site + 8 > size:
                raise JitError(f"{name}: relocation outside fragment")
            holes.append((site, hole, addend))
        out[name] = Stencil(code, holes)

    required = {
        "misaka_st1_port", "misaka_st1_imm", "misaka_st1_acc",
        "misaka_st1_zero", "misaka_st2_mov_net", "misaka_st2_push",
        "misaka_st2_pop_acc", "misaka_st2_pop_nil", "misaka_st2_in_acc",
        "misaka_st2_in_nil", "misaka_st2_out", "misaka_st2_jro",
        "misaka_st2_jmp", "misaka_st2_jez", "misaka_st2_jnz",
        "misaka_st2_jgz", "misaka_st2_jlz", "misaka_st2_mov_acc",
        "misaka_st2_none", "misaka_st2_add", "misaka_st2_sub",
        "misaka_st2_neg", "misaka_st2_swp", "misaka_st2_sav",
    }
    missing = required - out.keys()
    if missing:
        raise JitError(f"stencil library incomplete: missing {sorted(missing)}")
    return out


class StencilLibrary:
    def __init__(self, stencils: dict[str, Stencil]):
        self.stencils = stencils


def load_stencils(cache_dir: str | None = None) -> StencilLibrary | None:
    """Build-or-reuse + parse, with an in-process cache.  A corrupted
    cached object (truncated write, disk fault) is evicted and rebuilt
    once — robustness pinned by tests/test_torch_jit.py."""
    key = stencil_key()
    with _lib_lock:
        lib = _lib_cache.get(key)
        if lib is not None:
            M_JIT.labels(status="hit").inc()
            return lib
        for attempt in range(2):
            path = build_stencils(cache_dir)
            if path is None:
                return None
            try:
                lib = StencilLibrary(_parse_stencils(path))
                break
            except JitError as exc:
                log.warning("jit: bad stencil library %s (%s); %s", path, exc,
                            "rebuilding" if attempt == 0 else "giving up")
                try:
                    os.unlink(path)
                except OSError:
                    pass
                if attempt == 1:
                    M_JIT.labels(status="error").inc()
                    return None
        _lib_cache[key] = lib
        return lib


# --- splice + patch ---------------------------------------------------------

_libc = ctypes.CDLL(None, use_errno=True)
_libc.mmap.restype = ctypes.c_void_p
_libc.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_long]
_libc.mprotect.restype = ctypes.c_int
_libc.mprotect.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
_libc.munmap.restype = ctypes.c_int
_libc.munmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t]

_PROT_READ, _PROT_WRITE, _PROT_EXEC = 1, 2, 4
_MAP_PRIVATE, _MAP_ANONYMOUS = 0x02, 0x20
_MAP_FAILED = ctypes.c_void_p(-1).value

_K_GROUP_W = 8  # csrc/native/interpreter.cpp kGroupW
_K_PORTS = 4
_F_OP, _F_SRC, _F_IMM, _F_DST, _F_TGT, _F_PORT, _F_JMP = range(7)
_READS = {isa.OP_MOV_LOCAL, isa.OP_MOV_NET, isa.OP_ADD, isa.OP_SUB,
          isa.OP_JRO, isa.OP_PUSH, isa.OP_OUT}


class JitProgram:
    """An executable buffer of patched fragments + the per-(lane, pc)
    dispatch tables the pool consumes.  Owns the mapping: keep this
    object alive while any pool is armed with it."""

    def __init__(self, addr: int, size: int, tab1, tab2, n_lanes: int,
                 max_len: int, fragments: int):
        self._addr = addr
        self._size = size
        self.tab1 = tab1  # ctypes (c_void_p * (n_lanes * max_len))
        self.tab2 = tab2
        self.n_lanes = n_lanes
        self.max_len = max_len
        self.fragments = fragments
        self.code_bytes = size
        self.abi = MISAKA_JIT_ABI

    def close(self) -> None:
        addr, self._addr = self._addr, 0
        if addr:
            _libc.munmap(ctypes.c_void_p(addr), self._size)

    def __del__(self):  # noqa: D105
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


def _frag1(lane: int, f) -> tuple[str, tuple[int, ...]]:
    """(stencil, hole params) for one instruction's pass-1 fragment."""
    op, src = int(f[_F_OP]), int(f[_F_SRC])
    base = lane * _K_GROUP_W
    if op not in _READS or src == isa.SRC_NIL:
        return "misaka_st1_zero", (base,)
    if src >= isa.SRC_R0:
        pi = (lane * _K_PORTS + (src - isa.SRC_R0)) * _K_GROUP_W
        return "misaka_st1_port", (base, pi)
    if src == isa.SRC_IMM:
        return "misaka_st1_imm", (base, int(f[_F_IMM]))
    return "misaka_st1_acc", (base,)  # SRC_ACC


def _frag2(lane: int, p: int, f, ln: int, num_stacks: int, stack_cap: int,
           in_cap: int) -> tuple[str, tuple[int, ...]]:
    """(stencil, hole params) for one instruction's pass-2 fragment —
    parameter layout documented per stencil in csrc/native/stencils.cpp."""
    op = int(f[_F_OP])
    dst, tgt = int(f[_F_DST]), int(f[_F_TGT])
    base = lane * _K_GROUP_W
    nxt = (p + 1) % ln
    if op == isa.OP_MOV_NET:
        pi = (tgt * _K_PORTS + int(f[_F_PORT])) * _K_GROUP_W
        return "misaka_st2_mov_net", (base, pi, nxt)
    if op == isa.OP_PUSH:
        return "misaka_st2_push", (base, tgt * _K_GROUP_W, stack_cap, nxt)
    if op == isa.OP_POP:
        if dst == isa.DST_ACC:
            return "misaka_st2_pop_acc", (base, tgt * _K_GROUP_W,
                                          num_stacks * stack_cap,
                                          tgt * stack_cap, nxt)
        return "misaka_st2_pop_nil", (base, tgt * _K_GROUP_W, nxt)
    if op == isa.OP_IN:
        if dst == isa.DST_ACC:
            return "misaka_st2_in_acc", (base, lane, in_cap, nxt)
        return "misaka_st2_in_nil", (base, lane, nxt)
    if op == isa.OP_OUT:
        return "misaka_st2_out", (base, nxt)
    if op == isa.OP_JRO:
        return "misaka_st2_jro", (base, p, ln - 1)
    if op == isa.OP_JMP:
        return "misaka_st2_jmp", (base, int(f[_F_JMP]))
    cond = {isa.OP_JEZ: "misaka_st2_jez", isa.OP_JNZ: "misaka_st2_jnz",
            isa.OP_JGZ: "misaka_st2_jgz", isa.OP_JLZ: "misaka_st2_jlz"}
    if op in cond:
        return cond[op], (base, int(f[_F_JMP]), nxt)
    if op == isa.OP_MOV_LOCAL and dst == isa.DST_ACC:
        return "misaka_st2_mov_acc", (base, nxt)
    simple = {isa.OP_ADD: "misaka_st2_add", isa.OP_SUB: "misaka_st2_sub",
              isa.OP_NEG: "misaka_st2_neg", isa.OP_SWP: "misaka_st2_swp",
              isa.OP_SAV: "misaka_st2_sav"}
    return simple.get(op, "misaka_st2_none"), (base, nxt)


def _splice(lib: StencilLibrary, code: np.ndarray, prog_len: np.ndarray,
            num_stacks: int, stack_cap: int, in_cap: int) -> JitProgram:
    """Patch per-(lane, pc) fragments into one executable buffer and
    return the dispatch tables.  Identical (stencil, params) fragments
    are emitted once and shared (non-reading slots collapse hard)."""
    n_lanes, max_len = int(code.shape[0]), int(code.shape[1])
    plan1: list[tuple[str, tuple[int, ...]]] = []
    plan2: list[tuple[str, tuple[int, ...]]] = []
    for lane in range(n_lanes):
        ln = int(prog_len[lane])
        base = lane * _K_GROUP_W
        for p in range(max_len):
            if p < ln:
                plan1.append(_frag1(lane, code[lane, p]))
                plan2.append(_frag2(lane, p, code[lane, p], ln, num_stacks,
                                    stack_cap, in_cap))
            else:
                # unreachable slots (pc is validated < prog_len): benign
                # identity-adjacent fragments keep the table total
                plan1.append(("misaka_st1_zero", (base,)))
                plan2.append(("misaka_st2_none", (base, 0)))

    image = bytearray()
    offsets: dict[tuple[str, tuple[int, ...]], int] = {}
    for name, params in plan1 + plan2:
        if (name, params) in offsets:
            continue
        st = lib.stencils[name]
        pad = (-len(image)) % 16  # keep x86 fetch-friendly alignment
        image += b"\x90" * pad
        off = len(image)
        image += st.code
        for site, hole, addend in st.holes:
            if hole >= len(params):
                raise JitError(f"{name}: hole {hole} has no parameter")
            struct.pack_into("<q", image, off + site,
                             int(params[hole]) + addend)
        offsets[(name, params)] = off

    size = max(len(image), 1)
    addr = _libc.mmap(None, size, _PROT_READ | _PROT_WRITE,
                      _MAP_PRIVATE | _MAP_ANONYMOUS, -1, 0)
    if addr in (None, 0, _MAP_FAILED):
        raise JitError(f"mmap failed (errno {ctypes.get_errno()})")
    try:
        ctypes.memmove(addr, bytes(image), len(image))
        if _libc.mprotect(ctypes.c_void_p(addr), size,
                          _PROT_READ | _PROT_EXEC) != 0:
            raise JitError(f"mprotect failed (errno {ctypes.get_errno()})")
    except Exception:
        _libc.munmap(ctypes.c_void_p(addr), size)
        raise
    n = n_lanes * max_len
    tab1 = (ctypes.c_void_p * n)(*(addr + offsets[k] for k in plan1))
    tab2 = (ctypes.c_void_p * n)(*(addr + offsets[k] for k in plan2))
    return JitProgram(addr, size, tab1, tab2, n_lanes, max_len,
                      len(offsets))


def prepare(net, cache_dir: str | None = None) -> JitProgram | None:
    """Build the JIT program for one network: stencil library (cached) +
    splice/patch.  None on ANY failure — the caller serves one rung down
    (switch-threaded / generic); it never raises."""
    if not enabled() or not supported():
        M_JIT.labels(status="disabled").inc()
        return None
    try:
        if faults.fire("jit_fail") is not None:
            raise JitError("jit_fail chaos fault")
        lib = load_stencils(cache_dir)
        if lib is None:
            return None
        code = np.ascontiguousarray(net.code, np.int32)
        prog_len = np.ascontiguousarray(net.prog_len, np.int32)
        if np.any(prog_len <= 0):
            raise JitError("program with an empty lane")
        prog = _splice(lib, code, prog_len, max(1, int(net.num_stacks)),
                       int(net.stack_cap), int(net.in_cap),
                       )
        M_JIT.labels(status="spliced").inc()
        G_JIT_CODE_BYTES.set(prog.code_bytes)
        G_JIT_FRAGMENTS.set(prog.fragments)
        return prog
    except Exception as exc:  # noqa: BLE001 - total fallback contract
        log.warning("jit: prepare failed (%s); falling back one rung", exc)
        M_JIT.labels(status="error").inc()
        return None
