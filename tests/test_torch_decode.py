"""The fused kernel's line records decide what the tables decide.

csrc/fused_superstep.cu reads the program only through the records of
`fused.decode_lines` (one 16-byte record per line and lane).  This file
keeps a numpy emulator of the kernel's tick loop (`Emulator`, here and not
in the package) that reads nothing but those records and the state: the
same passes, the same register-carried ring slots, the same cold path for
an entry pc off the table, the same rebase at the end of the chunk.  From
one numpy-seeded state it must equal the port's plain version
(core/step.py, fused.plain_run) and the JAX package's core/step.py after
every tick, on every NetworkState field, exactly (all integers), and after
the chunk's rebase too.

Cases: the five BASELINE_CONFIGS, 16 seeded random networks over every
opcode, and the edges the records fold in: a send to a destination beyond
n_lanes*4, stack indices out of range, JRO from ACC, an immediate and a
port, entry pcs outside [0, len-1], ring counters within a chunk of
REBASE_THRESHOLD and at the int32 wrap.
"""

import zlib

import jax
import numpy as np
import pytest
import torch

from misaka_tpu.core import state as jstate
from misaka_tpu.core.step import step as jstep
from misaka_tpu_torch import networks as tnet
from misaka_tpu_torch.core import fused
from misaka_tpu_torch.core.state import REBASE_THRESHOLD, NetworkState, state_from_numpy, state_to_numpy
from misaka_tpu_torch.core.step import step as tstep
from misaka_tpu_torch.runtime.topology import Topology
from misaka_tpu_torch.tis import isa

torch.set_num_threads(1)

BATCH = 6
STEPS = 40
I32_MIN = -(2**31)


def w32(x: int) -> int:
    return (x + 2**31) % 2**32 - 2**31


def w64(x: int) -> int:
    return (x + 2**63) % 2**64 - 2**63


def jro_target(pc: int, v: int, last: int) -> int:
    lo = w32(v)
    if v == lo:
        t = max(w32(pc + min(max(lo, -(1 << 20)), 1 << 20)), 0)
        return min(t, last)
    return 0 if v < 0 else last


class Emulator:
    """The kernel's tick loop for one instance, from the records alone."""

    def __init__(self, records, prog_len, s: dict, b: int):
        self.rec = records.astype(np.int64) & 0xFFFFFFFF    # [L, N, 4] as unsigned words
        self.prog_len = prog_len
        self.L, self.nl, _ = records.shape
        g = {f: s[f][b].copy() for f in s}
        self.entry_pc = g["pc"].astype(np.int64)
        self.acc = [w64((int(h) << 32) | (int(lo) & 0xFFFFFFFF)) for h, lo in zip(g["acc_hi"], g["acc"])]
        self.bak = [w64((int(h) << 32) | (int(lo) & 0xFFFFFFFF)) for h, lo in zip(g["bak_hi"], g["bak"])]
        self.oor = [not 0 <= int(p) < self.L for p in g["pc"]]
        self.pc = [min(max(int(p) + self.L if p < 0 else int(p), 0), self.L - 1)
                   for p in g["pc"]]
        self.hv = [int(v) for v in g["hold_val"]]
        self.hold = [bool(v) for v in g["holding"]]
        self.ret = [int(v) for v in g["retired"]]
        self.pv = [int(v) for v in g["port_val"].reshape(-1)]
        self.pf = [bool(v) for v in g["port_full"].reshape(-1)]
        self.st = [int(v) for v in g["stack_top"]]
        self.stack_mem = g["stack_mem"].astype(np.int64)
        self.in_buf = g["in_buf"]
        self.out_buf = g["out_buf"].astype(np.int64)
        self.in_rd, self.in_wr = int(g["in_rd"]), int(g["in_wr"])
        self.out_rd, self.out_wr = int(g["out_rd"]), int(g["out_wr"])
        self.tick = int(g["tick"])
        self.in_cap, self.out_cap = self.in_buf.size, self.out_buf.size
        self.cap = self.stack_mem.shape[1]
        self.in_slot = self.in_rd % self.in_cap
        self.out_slot = self.out_wr % self.out_cap

    def word(self, n, i):
        return int(self.rec[self.pc[n], n, i])

    def tick_once(self):
        for n in range(self.nl):  # pass 1
            d = self.word(n, 1) >> 24
            if d != fused.NO_PORT and not self.hold[n] and self.pf[d]:
                self.hv[n], self.hold[n], self.pf[d] = self.pv[d], True, False
        in_avail = w32(self.in_wr - self.in_rd) > 0
        out_free = w32(self.out_wr - self.out_rd) < self.out_cap
        in_taken = out_taken = False
        stack_taken = set()
        for n in range(self.nl):  # pass 2
            imm, ctl, arg, jw = (self.word(n, i) for i in range(4))
            imm, arg = w32(imm), w32(arg)
            op, kind = ctl & 31, (ctl >> 5) & 3
            sv = self.acc[n] if kind == fused.K_ACC else (
                self.hv[n] if kind >= fused.K_PORT else imm)
            src_ok = kind != fused.K_PORT or self.hold[n]
            wire = w32(sv)
            commit, incoming = src_ok, 0
            if op == isa.OP_MOV_NET:
                commit = src_ok and arg >= 0 and not self.pf[arg]
                if commit:
                    self.pf[arg], self.pv[arg] = True, wire
            elif op in (isa.OP_PUSH, isa.OP_POP):
                commit, top = False, self.st[arg]
                if arg not in stack_taken:
                    if op == isa.OP_PUSH and src_ok and top < self.cap:
                        self.stack_mem[arg, max(top, 0)] = wire
                        self.st[arg], commit = top + 1, True
                    elif op == isa.OP_POP and top > 0:
                        incoming = int(self.stack_mem[arg, min(top - 1, self.cap - 1)])
                        self.st[arg], commit = top - 1, True
                    if commit:
                        stack_taken.add(arg)
            elif op == isa.OP_IN:
                commit = in_avail and not in_taken
                if commit:
                    incoming, in_taken = int(self.in_buf[self.in_slot]), True
            elif op == isa.OP_OUT:
                commit = src_ok and out_free and not out_taken
                if commit:
                    self.out_buf[self.out_slot], out_taken = wire, True
            if not commit:
                continue
            a = self.acc[n]
            if ctl & fused.CTL_WRITES_ACC and op == isa.OP_MOV_LOCAL:
                self.acc[n] = sv
            elif ctl & fused.CTL_WRITES_ACC and op in (isa.OP_POP, isa.OP_IN):
                self.acc[n] = incoming
            elif op == isa.OP_ADD:
                self.acc[n] = w64(a + sv)
            elif op == isa.OP_SUB:
                self.acc[n] = w64(a - sv)
            elif op == isa.OP_NEG:
                self.acc[n] = w64(-a)
            elif op == isa.OP_SWP:
                self.acc[n], self.bak[n] = self.bak[n], a
            elif op == isa.OP_SAV:
                self.bak[n] = a
            jmp = jw & 0xFFFF
            taken = (op == isa.OP_JMP or (op == isa.OP_JEZ and a == 0) or (op == isa.OP_JNZ and a != 0)
                     or (op == isa.OP_JGZ and a > 0) or (op == isa.OP_JLZ and a < 0))
            if taken:
                npc = jmp
            elif self.oor[n]:  # the cold path: step from the entry pc
                raw, length = int(self.entry_pc[n]), int(self.prog_len[n])
                npc = (jro_target(raw, sv, length - 1) if op == isa.OP_JRO
                       else w32(raw + 1) % length)
            elif op == isa.OP_JRO:
                npc = jro_target(self.pc[n], sv, jmp)
            else:
                npc = jw >> 16
            self.oor[n] = False
            self.pc[n], self.hold[n], self.ret[n] = npc, False, w32(self.ret[n] + 1)
        if in_taken:
            self.in_rd = w32(self.in_rd + 1)
            self.in_slot = 0 if self.in_slot + 1 == self.in_cap else self.in_slot + 1
            if self.in_rd == I32_MIN:
                self.in_slot = self.in_rd % self.in_cap
        if out_taken:
            self.out_wr = w32(self.out_wr + 1)
            self.out_slot = 0 if self.out_slot + 1 == self.out_cap else self.out_slot + 1
            if self.out_wr == I32_MIN:
                self.out_slot = self.out_wr % self.out_cap
        self.tick = w32(self.tick + 1)

    def fields(self, rebase=False) -> dict:
        rd_wr = [self.in_rd, self.in_wr, self.out_rd, self.out_wr]
        if rebase:
            for rd, wr, cap in ((0, 1, self.in_cap), (2, 3, self.out_cap)):
                if rd_wr[rd] > REBASE_THRESHOLD:
                    base = rd_wr[rd] // cap * cap
                    rd_wr[rd], rd_wr[wr] = rd_wr[rd] - base, w32(rd_wr[wr] - base)
        i32 = lambda xs: np.array(xs, dtype=np.int64).astype(np.int32)  # noqa: E731
        return dict(
            acc=i32([w32(a) for a in self.acc]), bak=i32([w32(a) for a in self.bak]),
            acc_hi=i32([a >> 32 for a in self.acc]), bak_hi=i32([a >> 32 for a in self.bak]),
            pc=i32([e if o else p for e, o, p in zip(self.entry_pc, self.oor, self.pc)]),
            port_val=i32(self.pv).reshape(self.nl, isa.NUM_PORTS),
            port_full=np.array(self.pf).reshape(self.nl, isa.NUM_PORTS),
            hold_val=i32(self.hv), holding=np.array(self.hold),
            stack_mem=self.stack_mem.astype(np.int32), stack_top=i32(self.st),
            in_buf=self.in_buf.copy(), in_rd=i32(rd_wr[0]), in_wr=i32(rd_wr[1]),
            out_buf=self.out_buf.astype(np.int32), out_rd=i32(rd_wr[2]), out_wr=i32(rd_wr[3]),
            tick=i32(self.tick), retired=i32(self.ret),
        )


def stacked(emus, rebase=False) -> dict:
    per = [e.fields(rebase) for e in emus]
    return {f: np.stack([p[f] for p in per]) for f in NetworkState._fields}


_jax_steps = {}


def jax_step(code, prog_len, s: dict) -> dict:
    key = (code.shape, s["stack_mem"].shape, s["in_buf"].shape, s["out_buf"].shape)
    if key not in _jax_steps:
        _jax_steps[key] = jax.jit(jax.vmap(jstep, in_axes=(None, None, 0)))
    out = _jax_steps[key](code, prog_len, jstate.NetworkState(**s))
    return {f: np.asarray(getattr(out, f)) for f in out._fields}


def assert_equal(got: dict, want: dict, what: str):
    for f in NetworkState._fields:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{what}: {f}")


# --- the cases ------------------------------------------------------------------


def random_program_topology(seed):
    import chip_smoke

    return chip_smoke.random_topology(seed, Topology)


def fresh(net, rng, n_inputs=6, lo=-100, hi=100) -> dict:
    s = state_to_numpy(net.init_state())
    k = min(n_inputs, net.in_cap)
    s["in_buf"][:, :k] = rng.integers(lo, hi, size=(net.batch, k))
    s["in_wr"][:] = k
    return s


def scrambled(net, rng, base=0) -> dict:
    """Any entry pc (inside, past the program, off the table), random
    registers, ports, latches and stack tops; ring counters from `base`."""
    s = fresh(net, rng, net.in_cap, -(2**31), 2**31)
    B, N = s["pc"].shape
    r = lambda *sh, lo=-(2**31), hi=2**31: rng.integers(lo, hi, size=sh).astype(np.int32)  # noqa: E731
    L = net.code.shape[1]
    s.update(pc=r(B, N, lo=-3, hi=L + 3), acc=r(B, N), bak=r(B, N), acc_hi=r(B, N, lo=-2, hi=2),
             bak_hi=r(B, N), port_val=r(B, N, 4), port_full=rng.random((B, N, 4)) < 0.5,
             holding=rng.random((B, N)) < 0.3, hold_val=r(B, N), retired=r(B, N), tick=r(B),
             stack_top=r(*s["stack_top"].shape, lo=-2, hi=net.stack_cap + 2))
    rd = (np.int64(base) + rng.integers(0, 3, size=B)).astype(np.int32)
    s.update(in_rd=rd, in_wr=(rd.astype(np.int64) + rng.integers(0, 8, size=B)).astype(np.int32),
             out_rd=(rd.astype(np.int64) + rng.integers(0, 8, size=B)).astype(np.int32))
    s["out_wr"] = (s["out_rd"].astype(np.int64) + rng.integers(0, 3, size=B)).astype(np.int32)
    return s


def edited(net, cells: dict):
    """`net` with code cells replaced: cells maps (lane, line, field) -> value."""
    code = net.code.copy()
    for (n, line, f), v in cells.items():
        code[n, line, f] = v
    return type(net)(code=code, prog_len=net.prog_len, num_stacks=net.num_stacks,
                     stack_cap=net.stack_cap, in_cap=net.in_cap, out_cap=net.out_cap,
                     batch=net.batch, device="cpu")


def case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    caps = dict(in_cap=6, out_cap=5, stack_cap=4)
    if name in tnet.BASELINE_CONFIGS:
        net = tnet.BASELINE_CONFIGS[name](**caps).compile(batch=BATCH, device="cpu")
        return net, fresh(net, rng)
    if name.startswith("random/"):
        net = random_program_topology(int(name.split("/")[1])).compile(batch=BATCH, device="cpu")
        return net, fresh(net, rng)
    add2 = tnet.add2(**caps).compile(batch=BATCH, device="cpu")
    if name == "send_beyond_lanes":
        # misaka2's last line sends to lane 2, misaka1's third to lane 1's
        # port 5 (= port index 9): with two lanes, 8 ports, neither ever
        # delivers, so both stall
        return edited(add2, {(1, 4, isa.F_TGT): 2, (0, 2, isa.F_PORT): 5}), fresh(add2, rng)
    if name == "stack_index_out_of_range":
        return edited(add2, {(1, 2, isa.F_TGT): 7, (1, 3, isa.F_TGT): -3}), fresh(add2, rng)
    if name == "jro_from_acc_imm_port":
        top = Topology(
            node_info={"a": "program", "b": "program"},
            programs={"a": "IN ACC\nMOV ACC, b:R0\nJRO ACC\nADD 1\nOUT ACC\nSUB 5\nJRO -3\n",
                      "b": "JRO R0\nNOP\nADD 1\nJRO 2\nMOV ACC, a:R1\nJRO -9\n"},
            **caps)
        net = top.compile(batch=BATCH, device="cpu")
        s = fresh(net, rng, 6, -4, 5)
        s["acc_hi"] = rng.integers(-2, 2, size=s["acc_hi"].shape).astype(np.int32)
        return net, s
    if name == "entry_pc_off_table":
        return add2, scrambled(add2, rng)
    if name == "counters_near_rebase":
        return add2, scrambled(add2, rng, REBASE_THRESHOLD - 4)
    if name == "counters_at_int32_wrap":
        return add2, scrambled(add2, rng, 2**31 - 3)
    raise KeyError(name)


CASES = (sorted(tnet.BASELINE_CONFIGS) + [f"random/{s}" for s in range(16)]
         + ["send_beyond_lanes", "stack_index_out_of_range", "jro_from_acc_imm_port",
            "entry_pc_off_table", "counters_near_rebase", "counters_at_int32_wrap"])


@pytest.mark.parametrize("name", CASES)
def test_records_emulator_matches_plain_and_jax_every_tick(name):
    net, s0 = case(name)
    records = fused.decode_lines(net.code, net.prog_len, net.num_stacks)
    assert records.shape == (net.code.shape[1], net.num_lanes, fused.REC_WORDS)
    emus = [Emulator(records, net.prog_len, s0, b) for b in range(net.batch)]
    assert_equal(stacked(emus), s0, "entry")
    plain = state_from_numpy(s0)
    jax_s = {f: s0[f] for f in s0}
    for t in range(1, STEPS + 1):
        for e in emus:
            e.tick_once()
        plain = tstep(net._code_t, net._len_t, plain)
        jax_s = jax_step(net.code, net.prog_len, jax_s)
        got = stacked(emus)
        assert_equal(got, state_to_numpy(plain), f"tick {t} vs the plain step")
        assert_equal(got, jax_s, f"tick {t} vs the JAX step")
    final = stacked(emus, rebase=True)
    assert_equal(final, state_to_numpy(fused.plain_run(net._code_t, net._len_t,
                                                       state_from_numpy(s0), STEPS)), "plain_run")
    rebased = jstate.rebase_rings(jstate.NetworkState(**jax_s))
    assert_equal(final, {f: np.asarray(getattr(rebased, f)) for f in rebased._fields}, "JAX rebase")
    if name == "counters_near_rebase":  # some instance's rings were rebased
        assert (final["in_rd"] != got["in_rd"]).any() and (final["out_rd"] != got["out_rd"]).any()
    if name == "counters_at_int32_wrap":  # some instance's in_rd wrapped
        assert (got["in_rd"] < 0).any() and (s0["in_rd"] > 0).all()


def test_decode_refuses_what_the_records_cannot_hold():
    net = tnet.add2(in_cap=4, out_cap=4, stack_cap=4).compile(batch=1, device="cpu")
    bad = edited(net, {(0, 0, isa.F_OP): isa.OP_JMP, (0, 0, isa.F_JMP): net.code.shape[1]})
    with pytest.raises(ValueError, match="jumps to"):
        fused.decode_lines(bad.code, bad.prog_len, bad.num_stacks)
    with pytest.raises(ValueError, match="program lengths"):
        fused.decode_lines(net.code, np.zeros_like(net.prog_len), net.num_stacks)
