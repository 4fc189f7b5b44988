"""The port's batched serve pair equals misaka_tpu's, packed array and all.

The same numpy-seeded feeds go through JAX `make_batched_serve(None,
chunk)` and the port's `make_batched_serve(runner, chunk)` iteration after
iteration; the packed [B, 4 + out_cap] snapshots, the idle counters and the
final states must be exactly equal (all integers).  Plus the host-side
helpers (drain_from_snapshot, drain_batched, counters, read_packed) and the
kernel wrapper's CPU route and bounds.
"""

import os

import numpy as np
import pytest
import torch

from misaka_tpu import networks as jnet
from misaka_tpu.core.engine import CompiledNetwork as JNet
from misaka_tpu.runtime.topology import Topology as JTopology
from misaka_tpu_torch import networks as tnet
from misaka_tpu_torch.core import fused
from misaka_tpu_torch.core.engine import CompiledNetwork as TNet
from misaka_tpu_torch.core.state import state_to_numpy
from misaka_tpu_torch.runtime.topology import Topology as TTopology

# tiny tensors: more intra-op threads would only contend with the other
# test workers
torch.set_num_threads(1)

MULTIPLY = os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples", "multiply.json")
CAPS = dict(in_cap=8, out_cap=8, stack_cap=8)


def pair(name):
    if name == "multiply":
        with open(MULTIPLY) as f:
            text = f.read()
        return JTopology.from_json(text, **CAPS), TTopology.from_json(text, **CAPS)
    return jnet.BASELINE_CONFIGS[name](**CAPS), tnet.BASELINE_CONFIGS[name](**CAPS)


def feeds(rng, batch, in_cap, iters):
    """Per iteration: values [B, in_cap] and counts [B] (None = idle)."""
    out = []
    for i in range(iters):
        if i % 3 == 2:
            out.append(None)
            continue
        vals = rng.integers(0, 9, size=(batch, in_cap)).astype(np.int32)
        counts = rng.integers(0, 4, size=batch).astype(np.int32)
        out.append((vals, counts))
    return out


@pytest.mark.parametrize("runner", ["plain", "fused_runner"])
@pytest.mark.parametrize("name", ["add2", "mesh8", "sorter", "multiply"])
def test_batched_serve_matches_jax(name, runner):
    jtop, ttop = pair(name)
    batch, chunk = 8, 24
    j = jtop.compile(batch=batch)
    t = ttop.compile(batch=batch, device="cpu")
    j_serve, j_idle = j.make_batched_serve(None, chunk)
    t_serve, t_idle = t.make_batched_serve(
        (lambda s: t.run(s, chunk)) if runner == "plain" else t.fused_runner(chunk), chunk
    )
    js, ts = j.init_state(), t.init_state()
    jc = np.asarray(j.counters(js))
    for step in feeds(np.random.default_rng(len(name)), batch, t.in_cap, 9):
        if step is None:
            js, jp = j_idle(js)
            ts, tp = t_idle(ts)
        else:
            vals, counts = step
            free = t.in_cap - (jc[1] - jc[0])
            counts = np.minimum(counts, free).astype(np.int32)  # the master's cut
            js, jp = j_serve(js, vals, counts)
            ts, tp = t_serve(ts, vals, counts)
        jp = np.asarray(jp)
        np.testing.assert_array_equal(tp.numpy(), jp)
        jc = jp[:, :4].T
    got = state_to_numpy(ts)
    for f in js._fields:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(js, f)), err_msg=f)
    assert got["retired"].sum() > 0


def test_read_packed_matches_drain_from_snapshot():
    t = tnet.add2(**CAPS).compile(batch=6, device="cpu")
    serve, _ = t.make_batched_serve(t.fused_runner(150), 150)
    vals = np.arange(6 * 8, dtype=np.int32).reshape(6, 8)
    counts = np.array([0, 3, 1, 0, 8, 2], np.int32)
    _, packed = serve(t.init_state(), vals, counts)
    ctrs, per_slot = t.read_packed(packed)
    p = packed.numpy()
    np.testing.assert_array_equal(ctrs, p[:, :4].T)
    want = JNet.drain_from_snapshot(p[:, 4:], p[:, 2], p[:, 3], 8)
    assert [(s, v.tolist()) for s, v in per_slot] == [(s, v.tolist()) for s, v in want]
    assert dict((s, v.tolist()) for s, v in per_slot) == {
        1: [10, 11, 12], 2: [18], 4: [34, 35, 36, 37, 38, 39, 40, 41], 5: [42, 43],
    }


@pytest.mark.parametrize("seed", range(4))
def test_drain_from_snapshot_matches_jax(seed):
    rng = np.random.default_rng(seed)
    b, cap = 16, 8
    buf = rng.integers(-50, 50, size=(b, cap)).astype(np.int32)
    rd = rng.integers(0, 1000, size=b).astype(np.int32)
    wr = rd + rng.integers(0, cap + 1, size=b).astype(np.int32)
    want = JNet.drain_from_snapshot(buf, rd, wr, cap)
    got = TNet.drain_from_snapshot(buf, rd, wr, cap)
    assert [(s, v.tolist()) for s, v in got] == [(s, v.tolist()) for s, v in want]


def test_drain_batched_and_counters_match_jax():
    j = jnet.add2(**CAPS).compile(batch=4)
    t = tnet.add2(**CAPS).compile(batch=4, device="cpu")
    vals = np.tile(np.arange(8, dtype=np.int32), (4, 1))
    counts = np.array([1, 0, 5, 8], np.int32)
    js = j.run(j.feed_batched(j.init_state(), vals, counts), 200)
    ts = t.run(t.feed_batched(t.init_state(), vals, counts), 200)
    np.testing.assert_array_equal(t.counters(ts), np.asarray(j.counters(js)))
    js, jo = j.drain_batched(js)
    ts, to = t.drain_batched(ts)
    assert [(s, v.tolist()) for s, v in to] == [(s, v.tolist()) for s, v in jo]
    np.testing.assert_array_equal(ts.out_rd.numpy(), np.asarray(js.out_rd))
    assert t.drain_batched(ts)[1] == []


def test_feed_batched_validates_shapes():
    t = tnet.add2(**CAPS).compile(batch=4, device="cpu")
    with pytest.raises(ValueError, match="need values"):
        t.feed_batched(t.init_state(), np.zeros((4, 7), np.int32), np.zeros(4, np.int32))


def test_fused_wrapper_takes_plain_version_on_cpu():
    t = tnet.mesh8(**CAPS).compile(batch=4, device="cpu")
    vals = np.tile(np.arange(8, dtype=np.int32), (4, 1))
    s = t.feed_batched(t.init_state(), vals, np.full(4, 6, np.int32))
    before = dict(fused.launch_counts)
    a = state_to_numpy(t.fused_runner(70)(s))
    b = state_to_numpy(t.run(s, 70))
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert fused.launch_counts == before  # no kernel launch on the CPU route


def test_fused_wrapper_refuses_other_devices():
    t = tnet.add2(**CAPS).compile(batch=2, device="cpu")
    meta = type(t.init_state())(*(x.to("meta") for x in t.init_state()))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused.fused_superstep(t._code_t.to("meta"), t._len_t.to("meta"), meta, 4,
                              records=None)


def test_kernel_bounds_raise_naming_the_bound():
    with pytest.raises(ValueError, match="MAX_LANES=32"):
        tnet.pipeline(33).compile(batch=1, device="cpu").fused_runner(8)
    stacks = {f"s{i}": "stack" for i in range(17)}
    top = TTopology(node_info={"p": "program", **stacks})
    with pytest.raises(ValueError, match="MAX_STACKS=16"):
        top.compile(batch=1, device="cpu").fused_runner(8)


def test_compile_without_a_device_uses_the_card_or_raises():
    if torch.cuda.is_available():
        assert tnet.add2().compile(batch=1).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tnet.add2().compile(batch=1)
