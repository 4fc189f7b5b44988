"""Per-program specialized native tick functions (the ladder's middle rung).

The port's copy of misaka_tpu/core/specialize.py.

The registry compiles each program version exactly once (content-addressed),
which makes activation the perfect hook for native specialization:
instead of the generic interpreter dispatching opcodes through runtime
tables, we re-compile ``csrc/native/interpreter.cpp`` with the program's tables
and every dimension baked in as ``constexpr`` data (a generated header,
``-DMISAKA_SPEC_HEADER``).  The group SIMD tick template then instantiates
against compile-time constants: lane loops unroll, dimension arithmetic
folds, and the program reads from ``.rodata`` — the C++ equivalent of what
the fused kernel's line records do for the card.

Contracts:

* **Cache**: one ``.so`` per (source hash, program tables, dims, flags)
  key, built atomically (tmp + ``os.replace``) so concurrent activations
  of the same version race benignly.  The registry passes a cache dir next
  to the version store; everything else shares ``default_cache_dir()``.
* **Graceful fallback**: ANY failure (no toolchain, compile error, the
  ``specialize_fail`` chaos fault) logs, counts on
  ``misaka_native_specialize_total{status=error}``, and returns ``None`` —
  the caller serves on the generic interpreter.  A specialized build whose
  baked tables do not match the runtime network degrades inside the C++
  side too (``spec_matches``), so a mis-keyed cache entry can never
  execute another program's code.
* **Kill switch**: ``MISAKA_SPECIALIZE=0`` disables the whole layer.

Bit-identity: the specialized paths are instantiations of the SAME
templates as the generic group engine (csrc/native/interpreter.cpp), pinned by
tests/test_torch_simd.py's differential corpus.
"""

from __future__ import annotations

import hashlib
import logging
import os

import numpy as np

from misaka_tpu_torch.tis import isa
from misaka_tpu_torch.utils import faults
from misaka_tpu_torch.utils import metrics
from misaka_tpu_torch.utils import nativelib

log = logging.getLogger("misaka.specialize")

_SRC = str(nativelib.NATIVE_SRC / "interpreter.cpp")

SPEC_VERSION = 2  # bump to invalidate every cached specialization
# v2: the generated header grew a second section — a per-(lane, pc)
# SWITCH-THREADED tick (misaka_spec_tick) whose cases carry the
# instruction fields and pc successors as literals, replacing the
# gather-driven fetch entirely on the specialized path.

M_SPECIALIZE = metrics.counter(
    "misaka_native_specialize_total",
    "Per-program native specialization outcomes (hit = cache reuse, "
    "built = fresh compile, error = compile failure -> generic fallback, "
    "fallback = load/engage failure after a successful build, "
    "disabled = kill switch)",
    ("status",),
)
M_CACHE_EVICT = metrics.counter(
    "misaka_specialize_cache_evictions_total",
    "Specialized-build cache entries evicted by the size/entry LRU bound",
)
G_CACHE_ENTRIES = metrics.gauge(
    "misaka_specialize_cache_entries",
    "Specialized .so entries in the on-disk cache after the last prune",
)
G_CACHE_BYTES = metrics.gauge(
    "misaka_specialize_cache_bytes",
    "Bytes held by the specialized-build cache after the last prune",
)


def enabled() -> bool:
    """MISAKA_SPECIALIZE kill switch (default on: activation compiles a
    specialized tick, any failure falls back to the generic engine)."""
    return os.environ.get("MISAKA_SPECIALIZE", "1") not in ("0", "off")


def default_cache_dir() -> str:
    """The shared on-disk cache for non-registry callers:
    MISAKA_SPEC_CACHE, else `build/misaka_tpu_torch/spec-cache` beside
    the port's other native builds."""
    explicit = os.environ.get("MISAKA_SPEC_CACHE")
    if explicit:
        return explicit
    return str(nativelib.BUILD_ROOT / "spec-cache")


def _switch_cap() -> int:
    """MISAKA_SPEC_SWITCH_MAX: total-instruction ceiling for the generated
    switch-threaded tick (code size is proportional to it); 0 disables the
    layer, falling back to the table-baked generic template tick."""
    return int(os.environ.get("MISAKA_SPEC_SWITCH_MAX", "") or 4096)


def spec_key(code: np.ndarray, prog_len: np.ndarray, num_stacks: int,
             stack_cap: int, in_cap: int, out_cap: int) -> str:
    """Content key: interpreter source hash (the build id — a source change
    invalidates every cached .so) + program tables + dimensions + flags."""
    h = hashlib.sha256()
    h.update(f"v{SPEC_VERSION}:{nativelib.src_hash(_SRC)}".encode())
    h.update(
        f":{num_stacks}:{stack_cap}:{in_cap}:{out_cap}"
        f":{code.shape}:sw{_switch_cap()}:".encode()
    )
    h.update(np.ascontiguousarray(code, np.int32).tobytes())
    h.update(np.ascontiguousarray(prog_len, np.int32).tobytes())
    return h.hexdigest()[:16]


# instruction-word fields (mirrors csrc/native/interpreter.cpp enum Field)
_F_OP, _F_SRC, _F_IMM, _F_DST, _F_TGT, _F_PORT, _F_JMP = range(7)
_READS = {isa.OP_MOV_LOCAL, isa.OP_MOV_NET, isa.OP_ADD, isa.OP_SUB,
          isa.OP_JRO, isa.OP_PUSH, isa.OP_OUT}
_K_GROUP_W = 8  # csrc/native/interpreter.cpp kGroupW
_K_PORTS = 4


def _tick_case1(lane: int, p: int, f) -> list[str]:
    """Pass-1 case (fetch + phase A + source resolution) for one baked
    instruction — mirrors group_tick pass 1 with every field a literal."""
    op, src = int(f[_F_OP]), int(f[_F_SRC])
    reads = op in _READS
    out = [f"        case {p}: {{"]
    if reads and src >= isa.SRC_R0:
        base = (lane * _K_PORTS + (src - isa.SRC_R0)) * _K_GROUP_W
        out += [
            "          if ((!kMasked || mask[r]) && !g.holding[i]) {",
            f"            const size_t pi = {base}u + r;",
            "            if (g.port_full[pi]) {",
            "              g.hold_val[i] = g.port_val[pi];",
            "              g.holding[i] = 1;",
            "              g.port_full[pi] = 0;",
            "              moved[r] = 1;",
            "            }",
            "          }",
        ]
    if not reads:
        val = "0"
    elif src == isa.SRC_IMM:
        val = f"(int64_t){int(f[_F_IMM])}LL"
    elif src == isa.SRC_ACC:
        val = "g.acc[i]"
    elif src == isa.SRC_NIL:
        val = "(int64_t)0"
    else:
        val = "(int64_t)g.hold_val[i]"
    ok = ("1" if (not reads or src < isa.SRC_R0)
          else "(uint8_t)(g.holding[i] != 0)")
    out += [
        f"          g.s_src_val[i] = {val};",
        f"          g.s_src_ok[i] = {ok};",
        "        } break;",
    ]
    return out


def _tick_case2(lane: int, p: int, f, ln: int, num_stacks: int,
                stack_cap: int, in_cap: int) -> list[str]:
    """Pass-2 case (arbitration + commit) for one baked instruction —
    mirrors group_tick pass 2; the pc successors are literals, so the
    modulo advance and the jump targets fold away entirely."""
    op, src = int(f[_F_OP]), int(f[_F_SRC])
    dst, tgt = int(f[_F_DST]), int(f[_F_TGT])
    nxt = (p + 1) % ln
    guarded = op in _READS and src >= isa.SRC_R0  # commit needs src_ok

    def tail(effects: list[str], pc: list[str] | None = None) -> list[str]:
        return [
            "moved[r] = 1;",
            *effects,
            *(pc if pc is not None else [f"g.pc[i] = {nxt};"]),
            "g.holding[i] = 0;",
            "g.retired[i] = i32((int64_t)g.retired[i] + 1);",
        ]

    if op == isa.OP_MOV_NET:
        pi = (tgt * _K_PORTS + int(f[_F_PORT])) * _K_GROUP_W
        body = [
            f"const size_t pi = {pi}u + r;",
            "if (!g.port_full[pi] && !g.s_deliv_full[pi]) {",
            "  g.s_deliv_full[pi] = 1;",
            "  g.s_deliv_val[pi] = i32(g.s_src_val[i]);",
            *("  " + s for s in tail([])),
            "}",
        ]
    elif op == isa.OP_PUSH:
        body = [
            f"const size_t si = {tgt * _K_GROUP_W}u + r;",
            f"if (!g.s_stack_taken[si] && g.s_begin_top[si] < {stack_cap}) {{",
            "  g.s_stack_taken[si] = 1;",
            "  g.s_pushed[si] = 1;",
            "  g.s_push_val[si] = i32(g.s_src_val[i]);",
            *("  " + s for s in tail([])),
            "}",
        ]
    elif op == isa.OP_POP:
        eff = []
        if dst == isa.DST_ACC:
            eff = [f"g.acc[i] = g.stack_mem[((size_t)r * {num_stacks} + "
                   f"{tgt}) * {stack_cap} + g.s_begin_top[si] - 1];"]
        body = [
            f"const size_t si = {tgt * _K_GROUP_W}u + r;",
            "if (!g.s_stack_taken[si] && g.s_begin_top[si] > 0) {",
            "  g.s_stack_taken[si] = 1;",
            *("  " + s for s in tail(eff)),
            "}",
        ]
    elif op == isa.OP_IN:
        eff = []
        if dst == isa.DST_ACC:
            eff = [f"g.acc[i] = g.in_buf[(size_t)r * {in_cap} + "
                   f"g.in_rd[r] % {in_cap}];"]
        body = [
            "if (io.in_avail[r] && !io.in_taken[r]) {",
            "  io.in_taken[r] = 1;",
            f"  io.in_win[r] = {lane};",
            *("  " + s for s in tail(eff)),
            "}",
        ]
    elif op == isa.OP_OUT:
        ok = "g.s_src_ok[i] && " if guarded else ""
        body = [
            f"if ({ok}io.out_free[r] && !io.out_taken[r]) {{",
            "  io.out_taken[r] = 1;",
            "  io.out_value[r] = i32(g.s_src_val[i]);",
            *("  " + s for s in tail([])),
            "}",
        ]
        guarded = False  # the guard is folded into the condition above
    elif op == isa.OP_JRO:
        mx = ln - 1
        body = tail(
            ["const int64_t v = g.s_src_val[i];",
             "const int64_t t = (v >= INT32_MIN && v <= INT32_MAX)",
             f"    ? (int64_t){p} + v : (v < 0 ? 0 : (int64_t){mx});"],
            [f"g.pc[i] = (int32_t)(t < 0 ? 0 : (t > {mx} ? {mx} : t));"],
        )
    elif op == isa.OP_JMP:
        body = tail([], [f"g.pc[i] = {int(f[_F_JMP])};"])
    elif op in (isa.OP_JEZ, isa.OP_JNZ, isa.OP_JGZ, isa.OP_JLZ):
        cond = {isa.OP_JEZ: "== 0", isa.OP_JNZ: "!= 0",
                isa.OP_JGZ: "> 0", isa.OP_JLZ: "< 0"}[op]
        body = tail(
            [], [f"g.pc[i] = g.acc[i] {cond} ? {int(f[_F_JMP])} : {nxt};"]
        )
    else:
        effects = {
            isa.OP_NOP: [],
            isa.OP_SWP: ["const int64_t oa = g.acc[i];",
                         "g.acc[i] = g.bak[i];",
                         "g.bak[i] = oa;"],
            isa.OP_SAV: ["g.bak[i] = g.acc[i];"],
            isa.OP_NEG: ["g.acc[i] = (int64_t)(0 - (uint64_t)g.acc[i]);"],
            isa.OP_ADD: ["g.acc[i] = (int64_t)((uint64_t)g.acc[i] + "
                         "(uint64_t)g.s_src_val[i]);"],
            isa.OP_SUB: ["g.acc[i] = (int64_t)((uint64_t)g.acc[i] - "
                         "(uint64_t)g.s_src_val[i]);"],
            isa.OP_MOV_LOCAL: (["g.acc[i] = g.s_src_val[i];"]
                               if dst == isa.DST_ACC else []),
        }[op]
        body = tail(effects)
    if guarded:
        body = ["if (g.s_src_ok[i]) {", *("  " + s for s in body), "}"]
    return [f"        case {p}: {{",
            *("          " + s for s in body),
            "        } break;"]


def _gen_tick(code: np.ndarray, prog_len: np.ndarray, num_stacks: int,
              stack_cap: int, in_cap: int) -> str | None:
    """The switch-threaded tick (header part 2): None when over the code
    budget — the build then keeps the table-baked generic tick."""
    n_lanes = code.shape[0]
    total = int(np.sum(prog_len))
    cap = _switch_cap()
    if cap <= 0 or total > cap:
        return None
    W = _K_GROUP_W
    lines = [
        "template <bool kMasked>",
        "MISAKA_AI bool misaka_spec_tick(Group& g, const uint8_t* mask) {",
        f"  constexpr int W = {W};",
        "  (void)mask;",
        "  uint8_t moved[W];",
        "  std::memset(moved, 0, sizeof(moved));",
        "  // pass 1 - fetch + phase A + source resolution (see group_tick)",
    ]
    for lane in range(n_lanes):
        ln = int(prog_len[lane])
        lines += [
            "  for (int r = 0; r < W; ++r) {",
            f"    const int i = {lane * W} + r;",
            "    switch (g.pc[i]) {",
        ]
        for p in range(ln):
            lines += _tick_case1(lane, p, code[lane, p])
        lines += [
            "      default: g.s_src_val[i] = 0; g.s_src_ok[i] = 1; break;",
            "    }",
            "  }",
        ]
    lines += [
        "  TickIO io;",
        "  tick_prologue<SpecSpec>(g, io);",
        "  // pass 2 - arbitration + commit (lane order = priority)",
    ]
    for lane in range(n_lanes):
        ln = int(prog_len[lane])
        lines += [
            "  for (int r = 0; r < W; ++r) {",
            "    if (kMasked && !mask[r]) continue;",
            f"    const int i = {lane * W} + r;",
            "    switch (g.pc[i]) {",
        ]
        for p in range(ln):
            lines += _tick_case2(lane, p, code[lane, p], ln, num_stacks,
                                 stack_cap, in_cap)
        lines += [
            "      default: break;",
            "    }",
            "  }",
        ]
    lines += [
        "  return tick_epilogue<SpecSpec, kMasked>(g, io, moved, mask);",
        "}",
    ]
    return "\n".join(lines) + "\n"


def _gen_header(code: np.ndarray, prog_len: np.ndarray, num_stacks: int,
                stack_cap: int, in_cap: int, out_cap: int, key: str) -> str:
    """The two-part specialization header.  Part 1 (default include, top of
    interpreter.cpp): the program tables + dimensions as constexpr data.
    Part 2 (MISAKA_SPEC_PART2, included after Group/TickIO/the pass
    helpers): the generated switch-threaded tick.  A part-2-less header
    (over budget) simply never defines MISAKA_SPEC_SWITCH and the build
    keeps the generic template tick against the baked tables."""
    n_lanes, max_len, nfields = code.shape
    flat = ",".join(str(int(v)) for v in code.reshape(-1))
    plen = ",".join(str(int(v)) for v in prog_len.reshape(-1))
    tick = _gen_tick(code, prog_len, num_stacks, stack_cap, in_cap)
    part1 = (
        "// auto-generated by misaka_tpu_torch/core/specialize.py — do not edit\n"
        "#ifndef MISAKA_SPEC_PART2\n"
        "namespace spec {\n"
        f"constexpr int n_lanes = {n_lanes};\n"
        f"constexpr int max_len = {max_len};\n"
        f"constexpr int num_stacks = {num_stacks};\n"
        f"constexpr int stack_cap = {stack_cap};\n"
        f"constexpr int in_cap = {in_cap};\n"
        f"constexpr int out_cap = {out_cap};\n"
        f'constexpr char key[] = "{key}";\n'
        f"constexpr int32_t prog_len[] = {{{plen}}};\n"
        f"alignas(64) constexpr int32_t code[] = {{{flat}}};\n"
        "}\n"
        "#define MISAKA_SPEC 1\n"
    )
    if tick is None:
        return part1 + "#endif  // MISAKA_SPEC_PART2\n"
    return (
        part1
        + "#define MISAKA_SPEC_SWITCH 1\n"
        + "#else  // MISAKA_SPEC_PART2: the switch-threaded tick\n"
        + tick
        + "#endif  // MISAKA_SPEC_PART2\n"
    )


def build(net, cache_dir: str | None = None) -> str | None:
    """Compile (or reuse) the specialized interpreter .so for one compiled
    network.  Returns the .so path, or None on any failure / kill switch —
    the caller MUST treat None as "serve generic", never as an error."""
    if not enabled():
        M_SPECIALIZE.labels(status="disabled").inc()
        return None
    code = np.ascontiguousarray(np.asarray(net.code), np.int32)
    prog_len = np.ascontiguousarray(np.asarray(net.prog_len), np.int32)
    num_stacks = max(1, int(net.num_stacks))  # the pool's clamp, baked
    stack_cap = int(net.stack_cap)
    in_cap, out_cap = int(net.in_cap), int(net.out_cap)
    try:
        key = spec_key(code, prog_len, num_stacks, stack_cap, in_cap, out_cap)
    except OSError as e:  # interpreter source unreadable
        log.warning("specialize: cannot key build (%s); serving generic", e)
        M_SPECIALIZE.labels(status="error").inc()
        return None
    cache_dir = cache_dir or default_cache_dir()
    so_path = os.path.join(cache_dir, f"interp-spec-{key}.so")
    if os.path.exists(so_path):
        M_SPECIALIZE.labels(status="hit").inc()
        try:  # refresh the LRU clock so a hot entry never ages out
            os.utime(so_path)
        except OSError:
            pass
        return so_path
    try:
        # chaos (utils/faults.py): pin the graceful-fallback contract —
        # activation must succeed on the generic interpreter with zero
        # client-visible errors when the compile site fails
        if faults.fire("specialize_fail") is not None:
            raise RuntimeError("specialize_fail fault injected")
        os.makedirs(cache_dir, exist_ok=True)
        hdr = _gen_header(code, prog_len, num_stacks, stack_cap, in_cap,
                          out_cap, key)
        hdr_path = os.path.join(cache_dir, f"interp-spec-{key}.h")
        tmp_hdr = f"{hdr_path}.tmp.{os.getpid()}"
        with open(tmp_hdr, "w") as f:
            f.write(hdr)
        os.replace(tmp_hdr, hdr_path)
        nativelib.compile_atomic(
            [*nativelib.CXX_FLAGS, f'-DMISAKA_SRC_HASH="{nativelib.src_hash(_SRC)}"',
             f'-DMISAKA_SPEC_HEADER="{hdr_path}"', _SRC],
            so_path)
    except Exception as e:
        log.warning("specialize: build failed (%s); serving generic", e)
        M_SPECIALIZE.labels(status="error").inc()
        return None
    M_SPECIALIZE.labels(status="built").inc()
    log.info("specialize: built %s", so_path)
    _prune_cache(cache_dir, keep=so_path)
    return so_path


def _cache_bounds() -> tuple[int, int]:
    """(max_entries, max_bytes) for the on-disk cache.  The cache is keyed
    on content hashes, so without a bound it grows one .so (~100-300 KB)
    per distinct program version FOREVER across uploads."""
    entries = int(os.environ.get("MISAKA_SPEC_CACHE_MAX_ENTRIES", "") or 64)
    mb = float(os.environ.get("MISAKA_SPEC_CACHE_MAX_MB", "") or 256)
    return entries, int(mb * 1024 * 1024)


def _prune_cache(cache_dir: str, keep: str | None = None) -> None:
    """LRU-evict interp-spec-* entries beyond the size/entry bounds.  Best
    effort and crash-safe: eviction is an unlink (dlopen'd files survive
    it on Linux, and a concurrent loader that loses the race falls down
    the total graceful-fallback ladder).  The just-built `keep` entry is
    never evicted.  Hits refresh mtime, so mtime order IS the LRU order."""
    max_entries, max_bytes = _cache_bounds()
    entries = []
    try:
        for name in os.listdir(cache_dir):
            if not (name.startswith("interp-spec-") and name.endswith(".so")):
                continue
            path = os.path.join(cache_dir, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, path))
    except OSError:
        return
    entries.sort()  # oldest first
    total = sum(e[1] for e in entries)
    count = len(entries)
    for mtime, size, path in entries:
        if count <= max_entries and total <= max_bytes:
            break
        if path == keep:
            continue
        try:
            os.unlink(path)
        except OSError:
            continue
        try:  # the generated header rides along with its .so
            os.unlink(path[:-3] + ".h")
        except OSError:
            pass
        M_CACHE_EVICT.inc()
        count -= 1
        total -= size
    G_CACHE_ENTRIES.set(count)
    G_CACHE_BYTES.set(total)
