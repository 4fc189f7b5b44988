"""The port's instruction trace ring records and decodes what misaka_tpu's does.

The cases of tests/test_trace.py, each held against the JAX function on the
same numpy-seeded state (integers: exact equality of the ring, its write
counter, the decoded entries and every NetworkState field): tracing leaves
the state as the untraced run leaves it, the first tick's fetch/commit
records, the ring's wrap, the decoder and its `last=N`, a batched run
recording one instance against an unbatched run of that instance, and the
out-of-range instance refusal.  Beyond them: random networks, a pc off the
program table (the recorder fetches what jnp indexing fetches) and the
write counter's wrap at 2^32 (uint32 in JAX, int64 modulo 2^32 here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from misaka_tpu import networks as jnet
from misaka_tpu.core import trace as jtrace
from misaka_tpu.core.step import step as jstep
from misaka_tpu.runtime.topology import Topology as JTopology
from misaka_tpu_torch import networks as tnet
from misaka_tpu_torch.core import trace as ttrace
from misaka_tpu_torch.core.engine import as_batch, first
from misaka_tpu_torch.core.state import state_from_numpy, state_to_numpy
from misaka_tpu_torch.core.step import step as tstep
from misaka_tpu_torch.runtime.topology import Topology as TTopology

import chip_smoke

torch.set_num_threads(1)

CAPS = dict(in_cap=8, out_cap=8, stack_cap=8)


def pair(batch=None):
    return (jnet.add2(**CAPS).compile(batch=batch),
            tnet.add2(**CAPS).compile(batch=batch, device="cpu"))


def jfields(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def assert_same_state(port, jax):
    j, t = jfields(jax), state_to_numpy(port)
    for f in j:
        assert t[f].shape == j[f].shape, f
        np.testing.assert_array_equal(t[f], j[f], err_msg=f)


def assert_same_ring(port, jax):
    np.testing.assert_array_equal(port.buf.numpy(), np.asarray(jax.buf))
    assert int(port.wr) == int(jax.wr)


def fed(j, t, values):
    js, _ = j.feed(j.init_state(), values)
    ts, _ = t.feed(t.init_state(), values)
    return js, ts


def test_traced_state_identical_to_untraced_and_to_jax():
    j, t = pair()
    js, ts = fed(j, t, [5, 6, 7])
    plain = t.run(ts, 40)
    ts, tt = t.run_traced(ts, t.init_trace(cap=64), 40)
    js, jt = j.run_traced(js, j.init_trace(cap=64), 40)
    assert_same_state(ts, js)
    np.testing.assert_equal(state_to_numpy(plain), state_to_numpy(ts))
    assert_same_ring(tt, jt)
    assert int(tt.wr) == 40


def test_records_fetch_and_commit():
    """Tick 0 on add2: misaka1 fetches IN (commits: input queued),
    misaka2 fetches MOV R0, ACC (parks: port empty)."""
    j, t = pair()
    js, ts = fed(j, t, [10])
    _, tt = t.run_traced(ts, t.init_trace(cap=16), 1)
    _, jt = j.run_traced(js, j.init_trace(cap=16), 1)
    assert_same_ring(tt, jt)
    buf = tt.buf.numpy()
    assert buf[0, 0].tolist() == [0, 16, 1, 10]  # pc, OP_IN, committed, acc
    assert buf[1, 0, ttrace.TR_COMMIT] == 0


def test_ring_wrap_keeps_last_cap_ticks():
    j, t = pair()
    js, ts = fed(j, t, [1, 2, 3])
    _, tt = t.run_traced(ts, t.init_trace(cap=8), 20)
    _, jt = j.run_traced(js, j.init_trace(cap=8), 20)
    assert_same_ring(tt, jt)
    got = ttrace.decode_trace(tt, t.code, t.prog_len)
    assert got == jtrace.decode_trace(jt, j.code, j.prog_len)
    assert sorted({e["tick"] for e in got}) == list(range(12, 20))


def test_decode_and_format_match_jax():
    j, t = pair()
    top = tnet.add2()
    js, ts = fed(j, t, [41])
    ts, tt = t.run_traced(ts, t.init_trace(cap=64), 30)
    js, jt = j.run_traced(js, j.init_trace(cap=64), 30)
    names = dict(lane_names=list(top.lane_ids()), stack_names=list(top.stack_ids()))
    got = ttrace.decode_trace(tt, t.code, t.prog_len, **names)
    assert got == jtrace.decode_trace(jt, j.code, j.prog_len, **names)
    assert {"IN ACC", "PUSH ACC, misaka3"} <= {e["text"] for e in got}
    assert ttrace.format_trace(got) == jtrace.format_trace(got)
    assert t.drain(ts)[1] == j.drain(js)[1] == [43]


@pytest.mark.parametrize("last", [None, 0, 3, 10, 50])
def test_decode_last_n(last):
    j, t = pair()
    _, tt = t.run_traced(t.init_state(), t.init_trace(cap=32), 10)
    _, jt = j.run_traced(j.init_state(), j.init_trace(cap=32), 10)
    got = ttrace.decode_trace(tt, t.code, t.prog_len, last=last)
    assert got == jtrace.decode_trace(jt, j.code, j.prog_len, last=last)
    if last == 3:
        assert sorted({e["tick"] for e in got}) == [7, 8, 9]


def test_batched_tracing_matches_unbatched_and_jax():
    """Instance 2 of a batched traced run records what an unbatched run of
    its input records, in both packages."""
    jb, tb = pair(batch=4)
    j1, t1 = pair()
    vals = np.asarray([10, 20, 41, 30], np.int32)
    counts = np.ones(4, np.int32)
    feed = np.zeros((4, CAPS["in_cap"]), np.int32)
    feed[:, 0] = vals
    jsb = jb.feed_batched(jb.init_state(), feed, counts)
    tsb = tb.feed_batched(tb.init_state(), feed, counts)
    tsb, ttb = tb.run_traced(tsb, tb.init_trace(cap=32), 20, instance=2)
    jsb, jtb = jb.run_traced(jsb, jb.init_trace(cap=32), 20, instance=2)
    js1, ts1 = fed(j1, t1, [41])
    ts1, tt1 = t1.run_traced(ts1, t1.init_trace(cap=32), 20)
    assert_same_ring(ttb, jtb)
    np.testing.assert_array_equal(ttb.buf.numpy(), tt1.buf.numpy())
    assert_same_state(tsb, jsb)
    assert (tsb.out_wr.numpy() == 1).all()


@pytest.mark.parametrize("instance", [-1, 4])
def test_batched_tracing_instance_out_of_range(instance):
    jb, tb = pair(batch=4)
    with pytest.raises(ValueError) as want:
        jb.run_traced(jb.init_state(), jtrace.init_trace(2, 4), 1, instance=instance)
    with pytest.raises(ValueError) as got:
        tb.run_traced(tb.init_state(), ttrace.init_trace(2, 4), 1, instance=instance)
    assert str(got.value) == str(want.value)


def test_single_step_api():
    """traced_step one tick at a time (the debugger's path)."""
    j, t = pair()
    js, ts = fed(j, t, [3])
    jt, tt = j.init_trace(cap=4), t.init_trace(cap=4)
    for _ in range(6):
        jcode, jlen = j._tables
        js, jt = jtrace.traced_step(jcode, jlen, js, jt)
        tsb, tt = ttrace.traced_step(t._code_t, t._len_t, as_batch(ts), tt)
        ts = first(tsb)
        assert_same_ring(tt, jt)
    assert_same_state(ts, js)
    assert int(ts.tick) == 6


@pytest.mark.parametrize("seed", range(6))
def test_random_networks_trace_like_jax(seed):
    ttop = chip_smoke.random_topology(seed, TTopology)
    jtop = JTopology(node_info=ttop.node_info, programs=ttop.programs, stack_cap=ttop.stack_cap,
                     in_cap=ttop.in_cap, out_cap=ttop.out_cap)
    t = ttop.compile(device="cpu")
    j = jtop.compile()
    vals = np.random.default_rng(seed).integers(-100, 100, size=6).tolist()
    js, ts = fed(j, t, vals)
    ts, tt = t.run_traced(ts, t.init_trace(cap=16), 48)
    js, jt = j.run_traced(js, j.init_trace(cap=16), 48)
    assert_same_ring(tt, jt)
    assert_same_state(ts, js)
    assert ttrace.decode_trace(tt, t.code, t.prog_len) == jtrace.decode_trace(
        jt, j.code, j.prog_len)


@pytest.mark.parametrize("pc", [-2, -7, -100, 5, 100])
def test_record_fetches_an_off_table_pc_like_jax(pc):
    """A restored or hand-made state can hold a pc off the table: the
    recorder's opcode is jnp's `code[lane, pc]` (negative from the end,
    then clamped), as the step's fetch is."""
    j, t = pair()
    js, ts = fed(j, t, [4])
    arrays = jfields(js)
    arrays["pc"] = np.full_like(arrays["pc"], pc)
    jstate = type(js)(**{f: jnp.asarray(v) for f, v in arrays.items()})
    tstate = state_from_numpy(arrays)
    jcode, jlen = j._tables
    jt = jtrace.record_step(jcode, jstate, jstep(jcode, jlen, jstate), j.init_trace(cap=4))
    tb = as_batch(tstate)
    tt = ttrace.record_step(t._code_t, tb, tstep(t._code_t, t._len_t, tb), t.init_trace(cap=4))
    assert_same_ring(tt, jt)


def test_write_counter_wraps_at_2_32_like_jax():
    """JAX keeps `wr` in uint32: its tick labels restart after 2^32 ticks.
    The port's int64 counter wraps at the same tick, to the same slots."""
    j, t = pair()
    js, ts = fed(j, t, [7, 8])
    start = 2**32 - 3
    jt = jtrace.TraceRing(buf=np.zeros((2, 5, 4), np.int32), wr=np.uint32(start))
    tt = ttrace.TraceRing(buf=torch.zeros((2, 5, 4), dtype=torch.int32),
                          wr=torch.tensor(start, dtype=torch.int64))
    js, jt = j.run_traced(js, jt, 6)
    ts, tt = t.run_traced(ts, tt, 6)
    assert_same_ring(tt, jt)
    assert int(tt.wr) == 3
    assert ttrace.decode_trace(tt, t.code, t.prog_len) == jtrace.decode_trace(
        jt, j.code, j.prog_len)
