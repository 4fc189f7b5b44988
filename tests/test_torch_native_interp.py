"""The port's native interpreter (core/cinterp.py) at every rung of its
tick ladder, against the port's plain torch step and JAX's cinterp.

The same numpy-seeded state goes through the port's `NativePool` under
each MISAKA_SIMD rung (auto = AVX2 where the CPU has it, generic, scalar),
the copy-and-patch JIT rung (core/jit.py) and the specialized rung
(core/specialize.py), through the port's plain loop (`CompiledNetwork.run`)
and through JAX's `cinterp.NativePool`: every NetworkState field exactly
equal (stack_mem below each top: pops leave residue in the torch step,
the interpreter's export zero-pads; against JAX's interpreter all of it).
Networks: the committed parity corpus, the baseline configs and fuzzed
networks over every opcode.  Plus the unbatched `NativeInterpreter`
against the port's unbatched plain loop, the pool's live rung as
`simd_info` reports it, and the interpreter's refusals.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from misaka_tpu.core import cinterp as jcinterp
from misaka_tpu_torch import networks as tnet
from misaka_tpu_torch.core import cinterp, jit, specialize
from misaka_tpu_torch.core.engine import CompiledNetwork as TNet
from misaka_tpu_torch.core.native_serve import state_arrays, state_of
from misaka_tpu_torch.runtime.topology import Topology
from tests.test_differential import build_random_network
from tests.torch_native_helpers import (  # noqa: F401
    assert_states_equal, env, every_handle_closed, small_pools)

torch.set_num_threads(1)

CORPUS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "corpus", "parity", "*.json")))
CAPS = dict(stack_cap=16, in_cap=16, out_cap=16)
B = 19  # two SIMD groups of 8 and a scalar remainder of 3
RUNGS = {"auto": None, "generic": "generic", "scalar": "0"}
WANT_RUNG = {"auto": lambda i: i["width"] == 8,  # avx2 where the CPU has it
             "generic": lambda i: i["width"] == 8 and not i["avx2"],
             "scalar": lambda i: i["width"] == 0}


def corpus_topology(path):
    with open(path) as f:
        case = json.load(f)
    return Topology(node_info=case["node_info"], programs=case["programs"], **CAPS), case


def seeded(net, rng, n=6, lo=-100, hi=100):
    """A port state with n random values queued per instance."""
    s = net.init_state()
    vals = rng.integers(lo, hi, size=(net.batch, n)).astype(np.int32)
    in_buf = s.in_buf.clone()
    in_buf[:, :n] = torch.from_numpy(vals)
    return s._replace(in_buf=in_buf, in_wr=s.in_wr + n)


def pool_of(net, rung, **kw):
    with env(MISAKA_SIMD=RUNGS[rung]):
        return cinterp.NativePool(net.code, net.prog_len, net.num_stacks, net.stack_cap,
                                  net.in_cap, net.out_cap, replicas=net.batch, threads=2, **kw)


def run_pool(pool, state, ticks, chunk=64):
    d = state_arrays(state)
    while ticks > 0:
        d, _ = pool.idle(d, min(chunk, ticks))
        ticks -= chunk
    return state_of(d)


def check_rungs(net, steps, seed, rungs=tuple(RUNGS)):
    """Every rung equal to the plain loop and to JAX's interpreter."""
    state = seeded(net, np.random.default_rng(seed))
    want = net.run(state, steps)
    jpool = jcinterp.NativePool(net.code, net.prog_len, net.num_stacks, net.stack_cap,
                                net.in_cap, net.out_cap, replicas=net.batch, threads=2)
    try:
        ref = run_pool(jpool, state, steps)
    finally:
        jpool.close()
    for rung in rungs:
        pool = pool_of(net, rung)
        try:
            assert WANT_RUNG[rung](pool.simd_info()), (rung, pool.simd_info())
            got = run_pool(pool, state, steps)
        finally:
            pool.close()
        assert_states_equal(got, want, f"{rung} vs plain")
        assert_states_equal(got, ref, f"{rung} vs JAX cinterp", mask_stack=False)
    return want


_PLAIN: dict = {}


def corpus_case(path):
    """(net, fed state, the plain loop's state 192 ticks on), the plain
    run made once per case for the three rungs."""
    if path not in _PLAIN:
        top, case = corpus_topology(path)
        net = top.compile(batch=B, device="cpu")
        vals = np.zeros((B, net.in_cap), np.int32)
        vals[:, : len(case["inputs"])] = case["inputs"]
        state = net.feed_batched(net.init_state(), vals,
                                 np.full((B,), len(case["inputs"]), np.int32))
        _PLAIN[path] = net, state, net.run(state, 192)
    return _PLAIN[path]


@pytest.mark.parametrize("rung", list(RUNGS))
@pytest.mark.parametrize("path", CORPUS, ids=[os.path.basename(p)[:-5] for p in CORPUS])
def test_corpus_every_rung(path, rung):
    net, state, want = corpus_case(path)
    pool = pool_of(net, rung)
    try:
        assert WANT_RUNG[rung](pool.simd_info())
        got = run_pool(pool, state, 192)
    finally:
        pool.close()
    assert_states_equal(got, want, rung)


@pytest.mark.parametrize("seed", range(12))
def test_fuzzed_networks_every_rung(seed):
    code, lengths, n_stacks, _, _ = build_random_network(seed)
    net = TNet(code=code, prog_len=lengths, num_stacks=max(1, n_stacks), stack_cap=4,
               in_cap=8, out_cap=8, batch=B, device="cpu")
    check_rungs(net, 48, seed)


@pytest.mark.parametrize("name", ["add2", "acc_loop", "ring4", "sorter", "mesh8"])
def test_baselines_every_rung(name):
    net = tnet.BASELINE_CONFIGS[name](**CAPS).compile(batch=B, device="cpu")
    want = check_rungs(net, 120, 5)
    assert int(want.out_wr.min()) > 0  # it computed


@pytest.mark.parametrize("name", ["add2", "mesh8", "sorter"])
def test_jit_and_specialized_rungs(name, tmp_path):
    """The ladder's compiled rungs equal the plain loop, and each is the
    rung that ran (simd_info)."""
    net = tnet.BASELINE_CONFIGS[name](**CAPS).compile(batch=16, device="cpu")
    state = seeded(net, np.random.default_rng(11))
    want = net.run(state, 128)
    if jit.supported():
        prog = jit.prepare(net, cache_dir=str(tmp_path))
        assert prog is not None
        pool = pool_of(net, "auto")
        try:
            assert pool.jit_arm(prog) == 0
            assert pool.simd_info()["jit"]
            assert_states_equal(run_pool(pool, state, 128), want, "jit")
        finally:
            pool.close()
            prog.close()
    if name != "add2":
        return  # one specialized build (a compile of the whole interpreter)
    so = specialize.build(net, cache_dir=str(tmp_path))
    assert so is not None and so.startswith(str(tmp_path))
    pool = pool_of(net, "auto", lib=cinterp.load_specialized(so))
    try:
        assert pool.simd_info()["specialized"]
        assert_states_equal(run_pool(pool, state, 128), want, "specialized")
    finally:
        pool.close()


@pytest.mark.parametrize("name", ["add2", "acc_loop", "sorter"])
def test_unbatched_interpreter_matches_plain(name):
    top = tnet.BASELINE_CONFIGS[name](**CAPS)
    net = top.compile(device="cpu")
    serve = net.make_serve(40, "scan")
    state = net.init_state()
    vals = np.arange(1, 9, dtype=np.int32)
    with cinterp.NativeInterpreter(net.code, net.prog_len, net.num_stacks, net.stack_cap,
                                   net.in_cap, net.out_cap) as it:
        it.import_arrays(state_arrays(state))
        assert it.feed(vals[:5]) == 5
        it.run(40)
        packed = it.pack(drain=True)
        want_state, want_packed = serve(state, np.pad(vals[:5], (0, net.in_cap - 5)), 5)
        np.testing.assert_array_equal(packed, want_packed.numpy())
        assert_states_equal(state_of(it.export_arrays()), want_state)


def test_feed_respects_capacity():
    net = tnet.add2(in_cap=4, out_cap=4, stack_cap=4).compile(device="cpu")
    with cinterp.NativeInterpreter(net.code, net.prog_len, net.num_stacks, net.stack_cap,
                                   net.in_cap, net.out_cap) as it:
        assert it.feed(np.arange(10, dtype=np.int32)) == 4
        it.run(200)
        assert it.drain() == [2, 3, 4, 5]


def test_invalid_tables_and_shapes_rejected():
    net = tnet.add2(**CAPS).compile(device="cpu")
    bad = net.code.copy()
    bad[0, 0, 0] = 99  # no such opcode
    with pytest.raises(ValueError):
        cinterp.NativeInterpreter(bad, net.prog_len, 1, 8, 8, 8)
    with pytest.raises(ValueError):
        cinterp.NativeInterpreter(net.code[0], net.prog_len, 1, 8, 8, 8)
    with pytest.raises(ValueError):
        cinterp.NativePool(net.code, net.prog_len, 1, 8, 8, 8, replicas=0)


def test_closed_handles_raise():
    net = tnet.add2(**CAPS).compile(batch=4, device="cpu")
    it = cinterp.NativeInterpreter(net.code, net.prog_len, 1, 8, 8, 8)
    it.close()
    with pytest.raises(RuntimeError):
        it.run(1)
    pool = cinterp.NativePool(net.code, net.prog_len, 1, 8, 8, 8, replicas=4, threads=1)
    pool.close()
    with pytest.raises(RuntimeError):
        pool.simd_info()
    assert not pool.is_resident()
