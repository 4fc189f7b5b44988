"""The port's native serving engine (core/native_serve.py, engine="native")
against the port's torch serve pair and the JAX package's native engine.

- The serve pair: NativeServe's packed row byte-equal to the port's
  `make_serve` and JAX's `serve_chunk`; NativeServePool's serve/idle rows
  byte-equal to the port's `make_batched_serve` and JAX's batched twins,
  resident and stateless, with partial-fill active lists; the states
  equal field by field (stack_mem below each top).
- The master: `MasterNode(engine="native")` batched and unbatched, over
  HTTP, answers the JAX native server's session byte for byte; /status
  reports the engine, the state's device and the live rung.
- Checkpoints cross engines and packages both ways, and a stateful network
  (running_total) continues equal after each crossing.
- Every reader of a resident state exports first: /status, snapshot,
  save_checkpoint, autogrow, the capture anchor, the registry's eviction
  checkpoint, the auto checkpointer; each held against the JAX package.
- The ladder through the master: jit, specialized, generic, each asked
  for by its env and asserted from /status `native`; the jit_fail and
  specialize_fail faults drop one rung, counted.
"""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from misaka_tpu import networks as jnet
from misaka_tpu.core import native_serve as jnative
from misaka_tpu.runtime.master import AutoCheckpointer as JAutoCkpt
from misaka_tpu.runtime.master import MasterNode as JMaster
from misaka_tpu.runtime.master import make_http_server as j_http
from misaka_tpu.runtime.topology import Topology as JTopology
from misaka_tpu_torch import networks as tnet
from misaka_tpu_torch.core import jit, native_serve, specialize
from misaka_tpu_torch.core.native_serve import NativeServe, NativeServePool
from misaka_tpu_torch.core.state import state_from_numpy
from misaka_tpu_torch.runtime import capture as tcapture
from misaka_tpu_torch.runtime.master import AutoCheckpointer as TAutoCkpt
from misaka_tpu_torch.runtime.master import MasterNode as TMaster
from misaka_tpu_torch.runtime.master import make_http_server as t_http
from misaka_tpu_torch.runtime.topology import Topology as TTopology
from misaka_tpu_torch.utils import faults
from tests.test_torch_master import request, request_stream, serve
from tests.torch_native_helpers import (  # noqa: F401
    arrays, assert_states_equal, env, every_handle_closed, materialize, small_pools)

torch.set_num_threads(1)

CAPS = dict(in_cap=8, out_cap=8, stack_cap=8)
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
with open(os.path.join(EXAMPLES, "running_total.json")) as _f:
    RUNNING_TOTAL = _f.read()
STACK_NET = dict(node_info={"p": "program", "st": "stack"},
                 programs={"p": "IN ACC\nPUSH ACC, st\nPUSH ACC, st\nPOP st, ACC\n"
                                "POP st, ACC\nOUT ACC"})


@pytest.fixture(autouse=True)
def quiet_planes(monkeypatch):
    # the servers' process-wide daemons would outlive a test in the worker
    for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG"):
        monkeypatch.setenv(switch, "0")


def pair(name, **caps):
    caps = caps or CAPS
    if name == "stack":
        return JTopology(**STACK_NET, **caps), TTopology(**STACK_NET, **caps)
    if name == "running_total":
        return JTopology.from_json(RUNNING_TOTAL, **caps), TTopology.from_json(RUNNING_TOTAL, **caps)
    return jnet.BASELINE_CONFIGS[name](**caps), tnet.BASELINE_CONFIGS[name](**caps)


# --- the serve pair ---------------------------------------------------------------------


@pytest.mark.parametrize("name", ["add2", "stack", "sorter"])
def test_serve_chunk_parity_unbatched(name):
    jtop, ttop = pair(name)
    jn, tn = jtop.compile(), ttop.compile(device="cpu")
    plain = tn.make_serve(16, "scan")
    ns = NativeServe(tn)
    jns = jnative.NativeServe(jn)
    s_plain = s_nat = tn.init_state()
    s_jax = jn.init_state()
    rng = np.random.default_rng(7)
    try:
        for it in range(12):
            count = int(rng.integers(0, 4)) if it % 3 else 0
            vals = np.zeros((tn.in_cap,), np.int32)
            vals[:count] = rng.integers(-1000, 1000, size=count)
            free = tn.in_cap - int(s_plain.in_wr - s_plain.in_rd)
            count = min(count, free)
            s_plain, p_plain = plain(s_plain, vals, count)
            s_nat, p_nat = ns.serve_chunk(s_nat, vals, count, 16)
            s_jax, p_jax = jns.serve_chunk(s_jax, vals, count, 16)
            assert isinstance(p_nat, np.ndarray)
            np.testing.assert_array_equal(p_nat, p_plain.numpy(), err_msg=f"iter {it}")
            np.testing.assert_array_equal(p_nat, np.asarray(p_jax), err_msg=f"iter {it}")
            s_nat, s_jax = materialize(ns, s_nat), materialize(jns, s_jax)
            assert_states_equal(s_nat, s_plain, f"iter {it}")
            assert_states_equal(s_nat, s_jax, f"iter {it}", mask_stack=False)
    finally:
        ns.close()
        jns.close()


def pool_schedule(tn, jn, pool, jpool, rounds=9, seed=3, active_fn=None):
    """One deterministic serve/idle schedule through the port's pool, the
    port's plain batched twins and JAX's pool; rows and states compared
    every round."""
    B = tn.batch
    serve_fn, idle_fn = tn.make_batched_serve(lambda s: tn.run(s, 32), 32)
    rng = np.random.default_rng(seed)
    s_plain = s_nat = tn.init_state()
    s_jax = jn.init_state()
    for it in range(rounds):
        if it % 4 == 3:
            s_plain, c_plain = idle_fn(s_plain)
            s_nat, c_nat = pool.idle(s_nat, 32)
            s_jax, c_jax = jpool.idle(s_jax, 32)
            np.testing.assert_array_equal(c_nat, np.asarray(c_jax), err_msg=f"idle {it}")
            if active_fn is None:  # partial fill: skipped replicas do not tick
                np.testing.assert_array_equal(c_nat, c_plain.numpy(), err_msg=f"idle {it}")
        else:
            free = tn.in_cap - (s_plain.in_wr - s_plain.in_rd).numpy()
            counts = np.minimum(rng.integers(0, tn.in_cap + 1, size=B), free).astype(np.int32)
            vals = rng.integers(-2**31, 2**31 - 1, size=(B, tn.in_cap), dtype=np.int64).astype(np.int32)
            active = active_fn(it, counts) if active_fn else None
            if active is not None:
                mask = np.zeros((B,), bool)
                mask[active] = True
                counts[~mask] = 0
            s_plain, p_plain = serve_fn(s_plain, vals, counts)
            s_nat, p_nat = pool.serve(s_nat, vals, counts, active=active)
            s_jax, p_jax = jpool.serve(s_jax, vals, counts, active=active)
            p_nat, p_jax, p_plain = np.array(p_nat), np.array(p_jax), p_plain.numpy()
            np.testing.assert_array_equal(p_nat, p_jax, err_msg=f"serve {it}")
            if active is None:
                np.testing.assert_array_equal(p_nat, p_plain, err_msg=f"serve {it}")
        s_nat = materialize(pool, s_nat)
        s_jax = materialize(jpool, s_jax)
        assert_states_equal(s_nat, s_jax, f"round {it}", mask_stack=False)
        if active_fn is None:
            assert_states_equal(s_nat, s_plain, f"round {it}")


@pytest.mark.parametrize("resident", ["1", "0"], ids=["resident", "stateless"])
@pytest.mark.parametrize("name", ["add2", "mesh8", "sorter", "stack"])
def test_pool_matches_batched_twins(name, resident):
    jtop, ttop = pair(name)
    with env(MISAKA_NATIVE_RESIDENT=resident):
        jn, tn = jtop.compile(batch=19), ttop.compile(batch=19, device="cpu")
        pool = NativeServePool(tn, chunk_steps=32, threads=2)
        jpool = jnative.NativeServePool(jn, chunk_steps=32, threads=2)
        try:
            pool_schedule(tn, jn, pool, jpool)
            assert pool._pool.is_resident() == (resident == "1")
        finally:
            pool.close()
            jpool.close()


def test_pool_partial_fill_active_lists():
    jtop, ttop = pair("add2")
    jn, tn = jtop.compile(batch=19), ttop.compile(batch=19, device="cpu")
    pool = NativeServePool(tn, chunk_steps=32, threads=2)
    jpool = jnative.NativeServePool(jn, chunk_steps=32, threads=2)
    lists = [np.array([0, 3, 8, 9, 17]), np.arange(8, 16), np.array([18]), None]
    try:
        pool_schedule(tn, jn, pool, jpool, rounds=12,
                      active_fn=lambda it, counts: lists[it % len(lists)])
    finally:
        pool.close()
        jpool.close()


def test_resident_fallback_fault_bit_identical():
    """resident_fallback forces the stateless path after a coherent export:
    the same rows and states as the resident run.  A fallback is counted
    only when a draw that fires follows one that did not; over 30 calls at
    p=0.5 the chance that none does is 31 / 2**30."""
    jtop, ttop = pair("add2")
    jn, tn = jtop.compile(batch=16), ttop.compile(batch=16, device="cpu")
    pool = NativeServePool(tn, chunk_steps=32, threads=2)
    jpool = jnative.NativeServePool(jn, chunk_steps=32, threads=2)
    before = native_serve._C_RES_FALLBACK.value
    faults.configure("resident_fallback@0.5")
    try:
        pool_schedule(tn, jn, pool, jpool, rounds=30, seed=9)
    finally:
        faults.configure(None)
        pool.close()
        jpool.close()
    assert native_serve._C_RES_FALLBACK.value > before


def test_pool_rejects_corrupt_state_unchanged():
    _, ttop = pair("add2")
    tn = ttop.compile(batch=8, device="cpu")
    pool = NativeServePool(tn, chunk_steps=16, threads=2)
    try:
        st = tn.init_state()
        st, _ = pool.serve(st, np.ones((8, tn.in_cap), np.int32), np.full((8,), 2, np.int32))
        st = materialize(pool, st)
        good = arrays(st)
        bad = st._replace(pc=torch.full_like(st.pc, 99))
        with pytest.raises(ValueError):
            pool.validate_state(bad)
        assert_states_equal(materialize(pool, st), state_from_numpy(good), mask_stack=False)
    finally:
        pool.close()


# --- the master ----------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [4, None], ids=["batched", "unbatched"])
@pytest.mark.parametrize("name", ["add2", "sorter"])
def test_http_session_matches_jax_native(name, batch):
    """The HTTP session of tests/test_torch_master.py (run, compute lanes,
    /load, /reset, pause) on the port's native server and JAX's."""
    jtop, ttop = pair(name)
    jm = JMaster(jtop, chunk_steps=32, batch=batch, engine="native")
    tm = TMaster(ttop, chunk_steps=32, batch=batch, engine="native", device="cpu")
    jh, th = j_http(jm, port=0), t_http(tm, port=0)
    jb, tb = serve(jh), serve(th)
    try:
        for path, body, headers, method in request_stream(name):
            want = request(jb, path, body, headers, method)
            got = request(tb, path, body, headers, method)
            assert got == want, (path, body, got, want)
        js = json.loads(request(jb, "/status", method="GET")[2])
        ts = json.loads(request(tb, "/status", method="GET")[2])
        for key in ("running", "nodes", "stack_cap", "in_queue", "out_queue", "engine"):
            assert ts[key] == js[key], key
        assert ts["engine"] == "native" and ts["device"] == "cpu"
        if batch:
            assert set(ts["native"]) == set(js["native"])
            assert {k: ts["native"][k] for k in ("width", "avx2", "jit")} == \
                {k: js["native"][k] for k in ("width", "avx2", "jit")}
        else:
            assert "native" not in ts and "native" not in js
    finally:
        for h, m in ((jh, jm), (th, tm)):
            h.shutdown()
            h.server_close()
            m.close()


@pytest.mark.parametrize("batch", [8, None], ids=["batched", "unbatched"])
def test_master_native_matches_scan_and_jax(batch):
    streams = [list(range(1, 30)), [0, -5, 2**31 - 3, -(2**31) + 1]]
    outs = {}
    for key, ctor in (("torch-native", lambda t: TMaster(t, chunk_steps=16, batch=batch,
                                                         engine="native", device="cpu")),
                      ("torch-scan", lambda t: TMaster(t, chunk_steps=16, batch=batch,
                                                       engine="scan", device="cpu")),
                      ("jax-native", lambda t: JMaster(t, chunk_steps=16, batch=batch,
                                                       engine="native"))):
        top = pair("add2")[0 if key.startswith("jax") else 1]
        m = ctor(top)
        m.run()
        try:
            outs[key] = [m.compute_many(s) for s in streams]
            if batch:
                outs[key].append(m.compute_spread(list(range(100))))
        finally:
            m.close()
    assert outs["torch-native"] == outs["torch-scan"] == outs["jax-native"]


def running(batch, pkg, engine="native", **kw):
    jtop, ttop = pair("running_total")
    if pkg == "jax":
        return JMaster(jtop, chunk_steps=16, batch=batch, engine=engine, **kw)
    return TMaster(ttop, chunk_steps=16, batch=batch, engine=engine, device="cpu", **kw)


def totals(m, values):
    return [m.compute_many([v])[0] for v in values]


@pytest.mark.parametrize("dst", ["jax-native", "jax-scan", "torch-scan", "torch-native"])
def test_checkpoint_from_native_continues_everywhere(tmp_path, dst):
    """A native port master's checkpoint, loaded by each engine of both
    packages: the running total carries on."""
    src = running(None, "torch")
    src.run()
    try:
        assert totals(src, [5, 3, 10]) == [5, 8, 18]
        path = str(tmp_path / "n.npz")
        src.save_checkpoint(path)
    finally:
        src.close()
    pkg, engine = dst.split("-")
    m = running(None, pkg, engine=engine)
    try:
        m.load_checkpoint(path)
        m.run()
        assert totals(m, [2, -20]) == [20, 0]
    finally:
        m.close()


@pytest.mark.parametrize("src", ["jax-native", "torch-scan"])
def test_checkpoint_into_native(tmp_path, src):
    pkg, engine = src.split("-")
    m = running(None, pkg, engine=engine)
    m.run()
    try:
        assert totals(m, [1, 2, 3]) == [1, 3, 6]
        path = str(tmp_path / "s.npz")
        m.save_checkpoint(path)
    finally:
        m.close()
    n = running(None, "torch")
    try:
        n.load_checkpoint(path)
        assert n.engine_name == "native"
        n.run()
        assert totals(n, [4]) == [10]
    finally:
        n.close()


def test_restore_rejects_corrupt_state_and_keeps_serving():
    """A state the interpreter cannot execute is refused before the swap
    (ValueError, the master left paused as the JAX master leaves it), and
    the live state serves on."""
    m = running(None, "torch")
    m.run()
    try:
        assert totals(m, [7]) == [7]
        snap = m.snapshot()
        with pytest.raises(ValueError):
            m.restore(snap._replace(pc=torch.full_like(snap.pc, 99)))
        m.run()
        assert totals(m, [1]) == [8]
    finally:
        m.close()


# --- every reader of a resident state exports first ---------------------------------------


def served_pair(batch):
    """A JAX and a port native master, each having served the same
    serialized traffic (running totals, one value per request)."""
    ms = [running(batch, "jax"), running(batch, "torch")]
    for m in ms:
        m.run()
    want = [totals(m, [5, 3, 10, -4]) for m in ms]
    assert want[0] == want[1]
    return ms


def continue_equal(states_or_paths, batch, load):
    """Load each package's read state into a fresh port scan master and
    continue the running totals: the answers agree (the state was current)."""
    outs = []
    for x in states_or_paths:
        m = running(batch, "torch", engine="scan")
        try:
            load(m, x)
            m.run()
            outs.append(totals(m, [1, 1, 1, 1]))
        finally:
            m.close()
    assert outs[0] == outs[1]
    return outs[0]


@pytest.mark.parametrize("batch", [4, None], ids=["batched", "unbatched"])
def test_reader_snapshot_and_status(batch):
    jm, tm = served_pair(batch)
    try:
        assert tm.status()["requests_total"] == jm.status()["requests_total"]
        # the resident state is exported: the retired counters are current
        tr = tm.status()["retired_per_lane"]
        assert tr["totaler"] > 0 and tm.status()["in_queue"] == 0
        snaps = [arrays(jm.snapshot()), arrays(tm.snapshot())]
        for s in snaps:
            assert int(np.asarray(s["in_wr"]).sum()) == 4
        out = continue_equal(snaps, batch, lambda m, s: m.restore(state_from_numpy(s)))
        if batch is None:
            assert out == [15, 16, 17, 18]
    finally:
        jm.close()
        tm.close()


@pytest.mark.parametrize("batch", [4, None], ids=["batched", "unbatched"])
def test_reader_checkpoint_and_autocheckpointer(tmp_path, batch):
    jm, tm = served_pair(batch)
    try:
        paths = []
        for tag, m in (("j", jm), ("t", tm)):
            p = str(tmp_path / f"{tag}.npz")
            m.save_checkpoint(p)
            paths.append(p)
        continue_equal(paths, batch, lambda m, p: m.load_checkpoint(p))
        auto = []
        for tag, m, cls in (("ja", jm, JAutoCkpt), ("ta", tm, TAutoCkpt)):
            d = tmp_path / tag
            d.mkdir()
            ck = cls(m, str(d), interval_s=3600)
            try:
                auto.append(ck.save_once())
            finally:
                ck.close()
        continue_equal(auto, batch, lambda m, p: m.load_checkpoint(p))
    finally:
        jm.close()
        tm.close()


def test_reader_capture_anchor():
    jm, tm = served_pair(4)
    try:
        from misaka_tpu.runtime import capture as jcapture

        anchors = [jcapture.anchor_from_master("default", jm),
                   tcapture.anchor_from_master("default", tm)]
        states = [arrays(a["state"]) for a in anchors]
        continue_equal(states, 4, lambda m, s: m.restore(state_from_numpy(s)))
    finally:
        jm.close()
        tm.close()


REVERSER = ("top: IN ACC\nJEZ dump\nPUSH ACC, st\nJMP top\ndump: OUT ACC\n"
            "pop: POP st, ACC\nOUT ACC\nJMP pop\n")


@pytest.mark.parametrize("batch", [2, None], ids=["batched", "unbatched"])
def test_reader_autogrow_keeps_the_resident_state(batch):
    """A reverser deeper than its stack wedges a native engine; autogrow
    exports the resident state, pads it and swaps the engine, and the
    stacked values come back in order, as from the JAX native master."""
    kw = dict(node_info={"p": "program", "st": "stack"}, programs={"p": REVERSER},
              in_cap=64, out_cap=64, stack_cap=8)
    vals = list(range(1, 41))
    outs = []
    for m in (JMaster(JTopology(**kw), chunk_steps=32, batch=batch, engine="native"),
              TMaster(TTopology(**kw), chunk_steps=32, batch=batch, engine="native",
                      device="cpu")):
        m.run()
        try:
            outs.append((m.compute_many(vals + [0], timeout=60), m.status()["stack_cap"]))
        finally:
            m.close()
    assert outs[0] == outs[1] == ([0] + vals[::-1], 64)


def test_reader_registry_eviction_and_revival(tmp_path):
    """A registry of native engines: an evicted engine's checkpoint holds
    its exported state, and the revived engine continues the totals."""
    from misaka_tpu_torch.runtime.registry import ProgramRegistry

    reg = ProgramRegistry(str(tmp_path / "store"), batch=None, engine="native",
                          caps=CAPS, device="cpu", max_active=1)
    try:
        reg.publish("tot", topology_json=RUNNING_TOTAL)
        reg.publish("other", tis="IN ACC\nOUT ACC")
        with reg.lease("tot") as m:
            assert m.engine_name == "native"
            assert totals(m, [5, 3]) == [5, 8]
        with reg.lease("other") as m:  # evicts "tot" through a checkpoint
            assert m.compute_many([4]) == [4]
        with reg.lease("tot") as m:  # revived from its eviction checkpoint
            assert totals(m, [10]) == [18]
    finally:
        reg.close()


def test_lifecycle_reset_load_and_handles_closed():
    m = TMaster(pair("add2")[1], chunk_steps=16, batch=8, engine="native", device="cpu")
    m.run()
    try:
        assert m.compute_many([1, 2]) == [3, 4]
        old = m._serve
        m.load("misaka1", "IN ACC\nADD 10\nMOV ACC, misaka2:R0\nMOV R0, ACC\nOUT ACC\n")
        assert old._closed and m._serve is not old
        m.run()
        assert m.compute_many([1]) == [12]
        m.reset()
        m.run()
        assert m.compute_many([0]) == [11]
    finally:
        m.close()
    assert m._serve._closed


# --- the ladder through the master ---------------------------------------------------------


def rung_of(status):
    n = status["native"]
    return ("jit" if n["jit"] else "specialized" if n["specialized"]
            else "avx2" if n["avx2"] else "generic" if n["width"] else "scalar")


@pytest.mark.parametrize("want,envs", [
    ("jit", {}),
    ("specialized", {"MISAKA_JIT": "0"}),
    ("generic", {"MISAKA_JIT": "0", "MISAKA_SPECIALIZE": "0", "MISAKA_SIMD": "generic"}),
    ("scalar", {"MISAKA_JIT": "0", "MISAKA_SPECIALIZE": "0", "MISAKA_SIMD": "0"}),
])
def test_master_ladder_rungs(tmp_path, want, envs):
    if want == "jit" and not jit.supported():
        pytest.skip("the copy-and-patch stencils are x86-64 code")
    with env(**envs):
        m = TMaster(pair("add2")[1], chunk_steps=16, batch=8, engine="native", device="cpu",
                    native_spec_dir=str(tmp_path))
    m.run()
    try:
        assert rung_of(m.status()) == want
        assert m.compute_spread(list(range(40))) == list(range(2, 42))
    finally:
        m.close()


@pytest.mark.parametrize("point,want,counter", [
    ("jit_fail", "specialized", lambda: jit.M_JIT.labels(status="error").value),
    ("specialize_fail", "avx2",
     lambda: specialize.M_SPECIALIZE.labels(status="error").value),
])
def test_fault_drops_one_rung(tmp_path, point, want, counter):
    if not jit.supported():
        pytest.skip("the copy-and-patch stencils are x86-64 code")
    envs = {} if point == "jit_fail" else {"MISAKA_JIT": "0"}
    before = counter()
    faults.configure(f"{point}=1.0")
    try:
        with env(**envs):
            m = TMaster(pair("add2")[1], chunk_steps=16, batch=8, engine="native",
                        device="cpu", native_spec_dir=str(tmp_path / point))
    finally:
        faults.configure(None)
    m.run()
    try:
        got = rung_of(m.status())
        if want == "avx2" and not m.status()["native"]["avx2"]:
            want = "generic"
        assert got == want
        assert counter() == before + 1
        assert m.compute_many([5]) == [7]
    finally:
        m.close()


def test_direct_construction_runs_no_compiler(tmp_path, monkeypatch):
    """Without a spec dir a master never runs the compiler: the pool
    serves on the avx2 / generic rung."""
    calls = []
    monkeypatch.setattr(jit, "prepare", lambda *a, **k: calls.append("jit"))
    monkeypatch.setattr(specialize, "build", lambda *a, **k: calls.append("spec"))
    m = TMaster(pair("add2")[1], chunk_steps=16, batch=8, engine="native", device="cpu")
    try:
        assert rung_of(m.status()) in ("avx2", "generic") and not calls
    finally:
        m.close()


def test_app_boots_native_with_spec_cache(monkeypatch, tmp_path):
    from misaka_tpu_torch.runtime import app

    monkeypatch.setenv("MISAKA_SPEC_CACHE", str(tmp_path / "cache"))
    env_ = {"NODE_INFO": json.dumps({"misaka1": {"type": "program"},
                                     "misaka2": {"type": "program"},
                                     "misaka3": {"type": "stack"}}),
            "MISAKA_PROGRAMS": json.dumps(tnet.ADD2_PROGRAMS), "MISAKA_DEVICE": "cpu",
            "MISAKA_ENGINE": "native", "MISAKA_BATCH": "8", "MISAKA_JIT": "0"}
    with env(MISAKA_JIT="0"):
        m = app.build_master_from_env(env_)
    try:
        assert m._native_spec_dir == str(tmp_path / "cache")
        assert rung_of(m.status()) == "specialized"
    finally:
        m.close()
    assert app.specialize_dir({"MISAKA_SPECIALIZE": "0"}) is None
