"""Unbatched serving: the port answers as misaka_tpu's default, one-instance lane.

The same numpy-seeded inputs go through the JAX package (its scan engine on
the CPU) and the port (`device="cpu"`, the kernel's plain version), and
everything integer is compared exactly:

- `CompiledNetwork(batch=None)`: `serve_chunk` chunk by chunk (the packed
  snapshot and every NetworkState field, shapes included: 0-d counters,
  [N] lane fields), `feed`/`drain`/`compute_stream`, and the refusals of
  the batched-only members (and the reverse) with the JAX messages;
- `MasterNode(batch=None)` behind its HTTP server: one request stream
  covering tests/test_runtime.py's unbatched cases, every response equal
  (status, content type, body); the Python-side cases (timeout pairing,
  snapshot/restore, caps and pre-regs64 checkpoints, autogrow);
- checkpoints with `"batch": null` both ways, and the batch refusal;
- a traced master's instruction history against the JAX master's for the
  same request stream (committed entries: idle chunks, whose number
  depends on timing, commit nothing);
- the engine refusals, with the JAX exception types;
- the app's environment: the reference README's env boots unbatched
  (MISAKA_BATCH unset), and MISAKA_TRACE_CAP, MISAKA_TRACE_INSTANCE and
  MISAKA_ENGINE are read (each ignored before this slice).
"""

import glob
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

import chip_smoke
from misaka_tpu import networks as jnet
from misaka_tpu.runtime.master import ComputeTimeout as JTimeout
from misaka_tpu.runtime.master import MasterNode as JMaster
from misaka_tpu.runtime.master import make_http_server as j_http
from misaka_tpu.runtime.topology import Topology as JTopology
from misaka_tpu.utils import wire as jwire
from misaka_tpu_torch import networks as tnet
from misaka_tpu_torch.core.state import state_to_numpy
from misaka_tpu_torch.networks import ADD2_PROGRAMS
from misaka_tpu_torch.runtime import app
from misaka_tpu_torch.runtime import checkpoint as ckpt
from misaka_tpu_torch.runtime.master import ComputeTimeout as TTimeout
from misaka_tpu_torch.runtime.master import MasterNode as TMaster
from misaka_tpu_torch.runtime.master import make_http_server as t_http
from misaka_tpu_torch.runtime.topology import Topology as TTopology

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples", "*.json")))
CAPS = dict(in_cap=8, out_cap=8, stack_cap=8)
CHUNK = 24


@pytest.fixture(autouse=True)
def _quiet_jax_daemons(monkeypatch):
    # the JAX server's process-global daemons (stack sampler, TSDB,
    # watchdog) would outlive a test in the worker process
    for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG"):
        monkeypatch.setenv(switch, "0")


def example_text(name):
    with open(os.path.join(ROOT, "examples", name)) as f:
        return f.read()


def topologies(**caps):
    """name -> (JAX topology, port topology) with the same programs."""
    out = {}
    for name in sorted(jnet.BASELINE_CONFIGS):
        out[name] = (jnet.BASELINE_CONFIGS[name](**caps), tnet.BASELINE_CONFIGS[name](**caps))
    for path in EXAMPLES:
        text = example_text(os.path.basename(path))
        out[os.path.basename(path)[:-5]] = (JTopology.from_json(text, **caps),
                                            TTopology.from_json(text, **caps))
    for seed in range(4):
        t = chip_smoke.random_topology(seed, TTopology, **caps)
        out[f"random{seed}"] = (JTopology(node_info=t.node_info, programs=t.programs, **caps), t)
    return out


NETWORKS = sorted(topologies())


def jfields(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def assert_same_state(port, jax):
    j, t = jfields(jax), state_to_numpy(port)
    for f in j:
        assert t[f].shape == j[f].shape, f
        assert t[f].dtype == j[f].dtype, f
        np.testing.assert_array_equal(t[f], j[f], err_msg=f)


# --- CompiledNetwork(batch=None) ------------------------------------------------


@pytest.mark.parametrize("name", NETWORKS)
def test_serve_chunk_matches_jax_chunk_by_chunk(name):
    jtop, ttop = topologies(**CAPS)[name]
    j, t = jtop.compile(), ttop.compile(device="cpu")
    js, ts = j.init_state(), t.init_state()
    assert_same_state(ts, js)
    rng = np.random.default_rng(len(name))
    for _ in range(6):
        free = CAPS["in_cap"] - int(np.asarray(js.in_wr - js.in_rd))
        count = int(rng.integers(0, free + 1))
        vals = rng.integers(-1000, 1000, size=CAPS["in_cap"]).astype(np.int32)
        js, jp = j.serve_chunk(js, vals, count, CHUNK)
        ts, tp = t.serve_chunk(ts, vals, count, CHUNK)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        assert tp.dtype == torch.int32 and tuple(tp.shape) == (4 + CAPS["out_cap"],)
        assert_same_state(ts, js)


@pytest.mark.parametrize("name", NETWORKS)
def test_feed_drain_compute_stream_match_jax(name):
    jtop, ttop = topologies(**CAPS)[name]
    j, t = jtop.compile(), ttop.compile(device="cpu")
    vals = np.random.default_rng(7).integers(-50, 50, size=12).astype(np.int32).tolist()
    # feed takes what fits, drain takes what came out
    (js, jk), (ts, tk) = j.feed(j.init_state(), vals), t.feed(t.init_state(), vals)
    assert tk == jk == CAPS["in_cap"]
    js, ts = j.run(js, 60), t.run(ts, 60)
    (js, jo), (ts, to) = j.drain(js), t.drain(ts)
    assert to == jo
    assert_same_state(ts, js)
    assert t.drain(ts)[1] == []
    # compute_stream to the expected outputs (multiply: 2 inputs -> 1)
    expected = 4 if name == "multiply" else 8
    if name.startswith("random") or name == "reverse_any":
        return  # no fixed number of outputs per input
    js, jo = j.compute_stream(j.init_state(), vals[:8], chunk=16, expected=expected)
    ts, to = t.compute_stream(t.init_state(), vals[:8], chunk=16, expected=expected)
    assert to == jo and len(to) == expected
    assert_same_state(ts, js)
    np.testing.assert_array_equal(t.counters(ts), np.asarray(j.counters(js)))


def test_compute_stream_reports_a_deadlock_like_jax():
    sink = dict(node_info={"p": "program"}, programs={"p": "top: IN ACC\nJMP top"}, **CAPS)
    with pytest.raises(RuntimeError) as want:
        JTopology(**sink).compile().compute_stream(
            JTopology(**sink).compile().init_state(), [1], chunk=8, max_steps=32)
    t = TTopology(**sink).compile(device="cpu")
    with pytest.raises(RuntimeError) as got:
        t.compute_stream(t.init_state(), [1], chunk=8, max_steps=32)
    assert str(got.value) == str(want.value)


def _batched_only(net):
    s = net.init_state()
    return {
        "fused_runner": lambda: net.fused_runner(8),
        "make_batched_serve": lambda: net.make_batched_serve(None, 8),
        "feed_batched": lambda: net.feed_batched(
            s, np.zeros((1, CAPS["in_cap"]), np.int32), np.zeros(1, np.int32)),
        "drain_batched": lambda: net.drain_batched(s),
    }


def _single_only(net):
    s = net.init_state()
    return {
        "serve_chunk": lambda: net.serve_chunk(s, np.zeros(CAPS["in_cap"], np.int32), 0, 8),
        "feed": lambda: net.feed(s, [1]),
        "drain": lambda: net.drain(s),
        "compute_stream": lambda: net.compute_stream(s, [1]),
    }


SINGLE_ONLY = ("serve_chunk", "feed", "drain", "compute_stream")


@pytest.mark.parametrize("member", ("fused_runner", "make_batched_serve", "feed_batched",
                                    "drain_batched") + SINGLE_ONLY)
def test_members_refuse_the_other_shape_like_jax(member):
    """Batched-only members raise on an unbatched network and the
    single-instance ones on a batched network, with the JAX messages."""
    batch = 2 if member in SINGLE_ONLY else None
    pick = _single_only if batch else _batched_only
    jcall = pick(jnet.add2(**CAPS).compile(batch=batch))[member]
    tcall = pick(tnet.add2(**CAPS).compile(batch=batch, device="cpu"))[member]
    with pytest.raises(ValueError) as want:
        jcall()
    with pytest.raises(ValueError) as got:
        tcall()
    assert str(got.value) == str(want.value)


def test_serve_chunk_engines_agree_and_refuse_others():
    t = tnet.add2(**CAPS).compile(device="cpu")
    vals = np.arange(1, 9, dtype=np.int32)
    a = t.serve_chunk(t.init_state(), vals, 5, CHUNK)
    b = t.serve_chunk(t.init_state(), vals, 5, CHUNK, engine="scan")
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    np.testing.assert_equal(state_to_numpy(a[0]), state_to_numpy(b[0]))
    with pytest.raises(ValueError, match="engine must be auto|scan"):
        t.make_serve(CHUNK, engine="fused")


def test_serve_leaves_the_input_state_untouched():
    t = tnet.add2(**CAPS).compile(device="cpu")
    s, _ = t.serve_chunk(t.init_state(), np.arange(8, dtype=np.int32), 3, CHUNK)
    before = state_to_numpy(s)
    t.serve_chunk(s, np.arange(8, dtype=np.int32), 4, CHUNK)
    np.testing.assert_equal(state_to_numpy(s), before)


# --- the master over HTTP -------------------------------------------------------


def serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


HEADERS = ("Deprecation", "Link")


def request(base, path, data=b"", headers=None, method="POST"):
    req = urllib.request.Request(base + path, data=data if method == "POST" else None,
                                 headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return (r.status, r.headers.get("Content-Type"), r.read(),
                    [r.headers.get(h) for h in HEADERS])
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read(), [e.headers.get(h) for h in HEADERS]


def form(**fields):
    return urllib.parse.urlencode(fields).encode()


def request_stream():
    """(path, body, headers, method): tests/test_runtime.py's unbatched
    cases, in one session."""
    raw = np.arange(-5, 20, dtype="<i4")
    bin_hdr = {"Content-Type": jwire.CONTENT_TYPE, "Accept": jwire.CONTENT_TYPE}
    add10 = "IN ACC\nADD 10\nOUT ACC"
    return [
        ("/compute", form(value="1"), None, "POST"),          # not running: 400
        ("/debug/isa_trace", None, None, "GET"),               # tracing off: 409
        ("/trace?last=5", None, None, "GET"),                  # 409 + Deprecation
        ("/debug/isa_trace?last=x", None, None, "GET"),        # 400
        ("/run", b"", None, "POST"),
        ("/run", b"", None, "POST"),
        *[("/compute", form(value=str(v)), None, "POST") for v in (0, 41, -7, 5)],
        ("/compute", form(value="twelve"), None, "POST"),
        ("/compute", form(), None, "POST"),
        ("/compute_batch", form(values="1, 2 3,4"), None, "POST"),
        ("/compute_batch", form(values=""), None, "POST"),
        ("/compute_batch", form(values="1 two 3"), None, "POST"),
        ("/compute_batch", form(values="5,-6,7", spread="1"), None, "POST"),
        ("/compute_raw", raw.tobytes(), None, "POST"),
        ("/compute_raw", b"\x01\x02\x03", None, "POST"),
        ("/compute_raw?spread=0", raw.tobytes(), None, "POST"),
        ("/compute_raw", jwire.pack(raw.tobytes()), bin_hdr, "POST"),
        ("/run", None, None, "GET"),                           # 405
        ("/pause", b"", None, "POST"),
        ("/compute", form(value="1"), None, "POST"),
        ("/run", b"", None, "POST"),
        ("/compute", form(value="5"), None, "POST"),
        ("/load", form(program="NOP", targetURI="ghost"), None, "POST"),
        ("/compute", form(value="1"), None, "POST"),           # still running
        ("/load", form(program="FROB", targetURI="misaka1"), None, "POST"),
        ("/compute", form(value="1"), None, "POST"),           # old program serves
        ("/load", form(program="FROB 1", targetURI="misaka1"), None, "POST"),
        ("/load", form(program="NOP", targetURI="misaka3"), None, "POST"),
        ("/load", form(program=add10, targetURI="misaka1"), None, "POST"),
        ("/compute", form(value="1"), None, "POST"),           # stopped by /load
        ("/run", b"", None, "POST"),
        ("/compute", form(value="3"), None, "POST"),
        ("/load", form(program=ADD2_PROGRAMS["misaka1"], targetURI="misaka1"), None, "POST"),
        ("/run", b"", None, "POST"),
        ("/compute", form(value="3"), None, "POST"),
        ("/checkpoint", form(name="net"), None, "POST"),
        ("/load", form(program="IN ACC\nADD 100\nOUT ACC", targetURI="misaka1"), None, "POST"),
        ("/run", b"", None, "POST"),
        ("/compute", form(value="1"), None, "POST"),
        ("/restore", form(name="net"), None, "POST"),
        ("/compute", form(value="1"), None, "POST"),           # restore pauses
        ("/run", b"", None, "POST"),
        ("/compute", form(value="1"), None, "POST"),
        ("/restore", form(name="nope"), None, "POST"),
        *[("/checkpoint", form(name=bad), None, "POST")
          for bad in ("../../etc/pwned", "/etc/pwned", "a/b", "")],
        ("/reset", b"", None, "POST"),
        ("/compute", form(value="2"), None, "POST"),
        ("/run", b"", None, "POST"),
        ("/compute", form(value="11"), None, "POST"),
        ("/nosuch", b"", None, "POST"),
    ]


def test_http_session_matches_jax(tmp_path):
    jm = JMaster(jnet.add2(), chunk_steps=32, engine="scan")
    tm = TMaster(tnet.add2(), chunk_steps=32, engine="scan", device="cpu")
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jh = j_http(jm, port=0, checkpoint_dir=jdir)
    th = t_http(tm, port=0, checkpoint_dir=tdir)
    jb, tb = serve(jh), serve(th)
    try:
        for path, body, headers, method in request_stream():
            want = request(jb, path, body, headers, method)
            got = request(tb, path, body, headers, method)
            # a refused /restore names the file it looked for
            want = want[:2] + (want[2].replace(jdir.encode(), b"<dir>"),) + want[3:]
            got = got[:2] + (got[2].replace(tdir.encode(), b"<dir>"),) + got[3:]
            assert got == want, (path, body, got, want)
        js, ts = jm.status(), tm.status()
        assert set(js) <= set(ts) and "batch" not in ts
        for key in ("running", "nodes", "stack_cap", "in_queue", "out_queue",
                    "retired_per_lane", "stack_depth", "requests_total"):
            assert ts[key] == js[key], key
        assert ts["engine"] == ts["served_engine"] == "plain" and ts["device"] == "cpu"
    finally:
        for h, m in ((jh, jm), (th, tm)):
            h.shutdown()
            h.server_close()
            m.close()


def test_compute_timeout_keeps_pairing_like_jax():
    """A timed-out request's late output is discarded, not handed to the
    next caller (tests/test_runtime.py::test_compute_timeout_keeps_pairing)."""
    spec = dict(node_info={"n": "program"}, programs={"n": "IN ACC\nOUT ACC"})
    for m, timeout_type in ((JMaster(JTopology(**spec), chunk_steps=16, engine="scan"), JTimeout),
                            (TMaster(TTopology(**spec), chunk_steps=16, engine="scan", device="cpu"),
                             TTimeout)):
        m.run()
        m.pause()  # stalled: inputs accepted, nothing computes
        with pytest.raises(timeout_type, match=r"no output for 1/1 value\(s\) after 0.3s"):
            m.compute(1, timeout=0.3)
        m.run()  # the orphaned value 1 now computes; its output is stale
        assert m.compute(5, timeout=30) == 5
        m.close()


def test_snapshot_restore_and_status_match_jax():
    jm = JMaster(jnet.add2(**CAPS), chunk_steps=16, engine="scan")
    tm = TMaster(tnet.add2(**CAPS), chunk_steps=16, engine="scan", device="cpu")
    try:
        for m in (jm, tm):
            m.run()
            assert m.compute(1) == 3
            m.pause()
        snaps = jm.snapshot(), tm.snapshot()
        for m in (jm, tm):
            m.run()
            assert m.compute_many([2, 3]) == [4, 5]
            m.restore(snaps[m is tm])
            assert m.is_running  # restore resumes a running master
            assert m.compute(10) == 12
            m.pause()
        js, ts = jm.status(), tm.status()
        assert ts["retired_per_lane"] == js["retired_per_lane"]
        assert ts["stack_depth"] == js["stack_depth"]
        assert_same_state(tm.snapshot()._replace(tick=tm.snapshot().tick * 0),
                          jm.snapshot()._replace(tick=jm.snapshot().tick * 0))
    finally:
        jm.close()
        tm.close()


def test_full_stack_grows_unbatched_like_jax():
    """reverse_any at stack_cap=4: [1..10, 0] parks the pusher on a full
    stack; both masters double the capacity to 16 and answer."""
    caps = dict(in_cap=16, out_cap=16, stack_cap=4)
    text = example_text("reverse_any.json")
    jm = JMaster(JTopology.from_json(text, **caps), chunk_steps=32, engine="scan")
    tm = TMaster(TTopology.from_json(text, **caps), chunk_steps=32, engine="scan", device="cpu")
    jm.run()
    tm.run()
    try:
        block = list(range(1, 11)) + [0]
        assert tm.compute_many(block, timeout=60) == jm.compute_many(block, timeout=60) == \
            [0] + list(range(10, 0, -1))
        assert tm.status()["stack_cap"] == jm.status()["stack_cap"] == 16
        assert tuple(tm.snapshot().stack_mem.shape) == (1, 16)
    finally:
        jm.close()
        tm.close()


# --- checkpoints with "batch": null -------------------------------------------------


def running_total_pair(**kw):
    text = example_text("running_total.json")
    return (JMaster(JTopology.from_json(text, **CAPS), chunk_steps=32, engine="scan", **kw),
            TMaster(TTopology.from_json(text, **CAPS), chunk_steps=32, engine="scan", device="cpu",
                    **kw))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_unbatched_checkpoints_load_both_ways(tmp_path, writer):
    """An unbatched checkpoint written by either package loads in the other:
    the installed state equals the saved one (unbatched shapes), and both
    masters go on giving the same answers from it."""
    jm, tm = running_total_pair()
    src, dst = (jm, tm) if writer == "jax" else (tm, jm)
    path = str(tmp_path / "c.npz")
    try:
        src.run()
        assert src.compute_many([5, 7, -3]) == [5, 12, 9]
        src.pause()
        src.save_checkpoint(path)
        with np.load(path) as data:
            meta = json.loads(bytes(data["__topology__"]).decode())
            assert data["pc"].shape == (1,) and data["in_rd"].shape == ()
        with open(ckpt.manifest_path(path)) as f:
            assert meta["batch"] is None and json.load(f)["batch"] is None
        dst.load_checkpoint(path)
        assert_same_state(tm.snapshot(), jm.snapshot())
        for m in (jm, tm):
            if not m.is_running:
                m.run()
        assert tm.compute_many([1, 2]) == jm.compute_many([1, 2]) == [10, 12]
    finally:
        jm.close()
        tm.close()


def test_batch_mismatch_refused_like_jax(tmp_path):
    jm, tm = running_total_pair()
    path = str(tmp_path / "u.npz")
    tm.save_checkpoint(path)
    text = example_text("running_total.json")
    jb = JMaster(JTopology.from_json(text, **CAPS), chunk_steps=32, batch=2, engine="scan")
    tb = TMaster(TTopology.from_json(text, **CAPS), chunk_steps=32, batch=2, device="cpu")
    try:
        with pytest.raises(ValueError) as want:
            jb.load_checkpoint(path)
        with pytest.raises(ValueError) as got:
            tb.load_checkpoint(path)
        assert str(got.value) == str(want.value)
        assert "checkpoint batch=None does not match this master's batch=2" in str(got.value)
        bpath = str(tmp_path / "b.npz")
        tb.save_checkpoint(bpath)
        with pytest.raises(ValueError) as want:
            jm.load_checkpoint(bpath)
        with pytest.raises(ValueError) as got:
            tm.load_checkpoint(bpath)
        assert str(got.value) == str(want.value)
    finally:
        for m in (jm, tm, jb, tb):
            m.close()


def test_checkpoint_caps_and_pre_regs64_like_jax(tmp_path):
    """Caps travel in the checkpoint; one written before the 64-bit
    registers (no hi planes, no manifest) loads with sign-extended hi
    words (tests/test_runtime.py's two checkpoint cases, unbatched)."""
    small = dict(node_info={"n": "program"}, programs={"n": "IN ACC\nADD 1\nOUT ACC"},
                 in_cap=16, out_cap=16, stack_cap=4)
    m1 = TMaster(TTopology(**small), chunk_steps=16, device="cpu")
    with m1._state_lock:
        m1._state = m1._state._replace(acc=torch.tensor([-5], dtype=torch.int32),
                                       acc_hi=torch.tensor([-1], dtype=torch.int32))
    path = str(tmp_path / "old.npz")
    m1.save_checkpoint(path)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files if k not in ("acc_hi", "bak_hi")}
    np.savez(path, **arrays)
    os.unlink(ckpt.manifest_path(path))
    big = dict(node_info={"n": "program"}, programs={"n": "NOP"})
    for m in (TMaster(TTopology(**big), chunk_steps=16, device="cpu"),
              JMaster(JTopology(**big), chunk_steps=16, engine="scan")):
        m.load_checkpoint(path)
        assert int(np.asarray(m.snapshot().acc)[0]) == -5
        assert int(np.asarray(m.snapshot().acc_hi)[0]) == -1  # sign-extended
        assert m._net.in_cap == 16
        m.run()
        assert m.compute(9, timeout=30) == 10
        m.close()


# --- the traced master ------------------------------------------------------------


def committed(entries, chunk):
    """The entries that committed, without their tick labels (the number
    of idle chunks between requests depends on timing), with the tick's
    place in its chunk (values are fed at chunk starts)."""
    return [dict({k: v for k, v in e.items() if k != "tick"}, at=e["tick"] % chunk)
            for e in entries if e["committed"]]


def test_traced_master_history_matches_jax():
    # a ring long enough for the whole session, idle chunks included
    jm = JMaster(jnet.add2(**CAPS), chunk_steps=16, trace_cap=16384, engine="scan")
    tm = TMaster(tnet.add2(**CAPS), chunk_steps=16, trace_cap=16384, device="cpu")
    jh, th = j_http(jm, port=0), t_http(tm, port=0)
    jb, tb = serve(jh), serve(th)
    try:
        assert tm.engine_name == "plain-traced"
        for base in (jb, tb):
            assert request(base, "/run")[0] == 200
            for v in (7, -2, 40):
                assert json.loads(request(base, "/compute", form(value=str(v)))[2]) == \
                    {"value": v + 2}
            assert request(base, "/compute_raw", np.arange(5, dtype="<i4").tobytes())[0] == 200
        for m in (jm, tm):
            m.pause()
        want, got = jm.trace(), tm.trace()
        assert committed(got, 16) == committed(want, 16) != []
        for path in ("/debug/isa_trace?last=3", "/trace?last=3"):
            (jc, jt, jbody, jhdr), (tc, tt, tbody, thdr) = (request(b, path, method="GET")
                                                            for b in (jb, tb))
            assert (tc, tt, thdr) == (jc, jt, jhdr)
            entries = json.loads(tbody)["entries"]
            assert len(entries) == 3 * 2 and [e["tick"] for e in entries] == sorted(
                e["tick"] for e in entries)
            assert [dict(e, tick=0) for e in entries] == [
                dict(e, tick=0) for e in json.loads(jbody)["entries"]]
        for m in (jm, tm):
            m.reset()
            assert m.trace() == []
    finally:
        for h, m in ((jh, jm), (th, tm)):
            h.shutdown()
            h.server_close()
            m.close()


def test_batched_traced_master_records_its_instance():
    tm = TMaster(tnet.add2(**CAPS), chunk_steps=16, batch=4, trace_cap=256, trace_instance=3,
                 device="cpu")
    tm.run()
    try:
        # one request at a time: compute_many's rotating start gives them
        # instances 0, 1, 2 and 3 in turn
        for i in range(4):
            assert tm.compute_many([10 * i, 10 * i + 1]) == [10 * i + 2, 10 * i + 3]
        seen = [e["acc"] for e in tm.trace() if e["committed"] and e["text"] == "IN ACC"]
        assert seen == [30, 31]
    finally:
        tm.close()


# --- engine refusals --------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(engine="bogus"),
    dict(trace_cap=8, trace_instance=1),
    dict(trace_cap=8, batch=4, trace_instance=4),
    dict(data_parallel=2),
    dict(batch=4, data_parallel=2, trace_cap=8),
    dict(engine="fused", trace_cap=8, batch=4),
    dict(engine="fused"),
    dict(engine="gather", batch=4),
], ids=["engine", "instance_unbatched", "instance_batched", "mesh_unbatched",
        "mesh_traced", "fused_traced", "fused_unbatched", "gather"])
def test_engine_refusals_match_jax(kw):
    with pytest.raises(ValueError) as want:
        JMaster(jnet.add2(**CAPS), chunk_steps=16, **kw)
    with pytest.raises(ValueError) as got:
        TMaster(tnet.add2(**CAPS), chunk_steps=16, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_port_only_engine_refusals():
    # the host tier builds (core/native_serve.py) and refuses what the
    # reference's does, with its messages
    m = TMaster(tnet.add2(**CAPS), engine="native", device="cpu")
    assert m.engine_name == "native"
    m.close()
    for kw in (dict(trace_cap=8), dict(batch=4, data_parallel=2)):
        with pytest.raises(ValueError) as want:
            JMaster(jnet.add2(**CAPS), engine="native", **kw)
        with pytest.raises(ValueError) as got:
            TMaster(tnet.add2(**CAPS), engine="native", device="cpu", **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="no kernel interpreter.*engine='scan'"):
        TMaster(tnet.add2(**CAPS), engine="fused-interpret", device="cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        TMaster(tnet.add2(**CAPS), engine="fused", batch=2, device="cpu")
    m = TMaster(tnet.add2(**CAPS), engine="scan", batch=2, device="cpu")
    m.run()
    try:
        assert m.compute(5) == 7 and m.status()["engine"] == "plain"
    finally:
        m.close()


# --- the app's environment ------------------------------------------------------------

README_ENV = {
    "NODE_INFO": json.dumps({"misaka1": {"type": "program"}, "misaka2": {"type": "program"},
                             "misaka3": {"type": "stack"}}),
    # the reference README's programs: no trailing newline
    "MISAKA_PROGRAMS": json.dumps({k: v.rstrip("\n") for k, v in ADD2_PROGRAMS.items()}),
}


def test_app_boots_unbatched_from_the_readme_env(tmp_path):
    """The reference quickstart sets no MISAKA_BATCH: one instance, as the
    JAX app reads it (the port refused to start before)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, **README_ENV, "MISAKA_DEVICE": "cpu", "MISAKA_PORT": str(port),
           "OMP_NUM_THREADS": "1"}
    env.pop("MISAKA_BATCH", None)
    with open(tmp_path / "app.log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "misaka_tpu_torch.runtime.app"],
                                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None, (tmp_path / "app.log").read_text()
            try:
                st = json.loads(request(base, "/status", method="GET")[2])
                break
            except (urllib.error.URLError, OSError, ValueError):
                pass
            assert time.monotonic() < deadline, "app not serving within 60 s"
            time.sleep(0.2)
        # no card: `auto` serves on the host C++ tier, as the JAX app's does
        assert "batch" not in st and not st["running"] and st["engine"] == "native"
        assert request(base, "/run")[:3:2] == (200, b"Success")
        assert request(base, "/compute", form(value="5"))[2] == b'{"value": 7}\n'
    finally:
        proc.terminate()
        proc.wait(timeout=30)


@pytest.mark.parametrize("batch", [None, "2"], ids=["unbatched", "batched"])
def test_app_reads_trace_cap(batch):
    """MISAKA_TRACE_CAP arms the instruction history (GET /debug/isa_trace
    answered 405 before: the variable was ignored)."""
    m = app.build_master_from_env({**README_ENV, "MISAKA_DEVICE": "cpu",
                                   "MISAKA_TRACE_CAP": "32", "MISAKA_CHUNK_STEPS": "16",
                                   **({"MISAKA_BATCH": batch} if batch else {})})
    h = t_http(m, port=0)
    base = serve(h)
    try:
        m.run()
        assert m.compute(5) == 7
        code, ctype, body, _ = request(base, "/debug/isa_trace?last=2", method="GET")
        assert (code, ctype) == (200, "application/json")
        entries = json.loads(body)["entries"]
        assert len(entries) == 4 and {e["name"] for e in entries} == {"misaka1", "misaka2"}
        assert m.status()["engine"] == "plain-traced"
    finally:
        h.shutdown()
        h.server_close()
        m.close()


def test_app_reads_trace_instance():
    env = {**README_ENV, "MISAKA_DEVICE": "cpu", "MISAKA_BATCH": "4", "MISAKA_TRACE_CAP": "16"}
    m = app.build_master_from_env({**env, "MISAKA_TRACE_INSTANCE": "2"})
    assert m._trace_instance == 2
    m.close()
    with pytest.raises(ValueError, match=r"trace_instance 4 out of range \[0, 4\)"):
        app.build_master_from_env({**env, "MISAKA_TRACE_INSTANCE": "4"})


@pytest.mark.parametrize("batch", [None, "2"], ids=["unbatched", "batched"])
def test_app_reads_engine(batch):
    env = {**README_ENV, "MISAKA_DEVICE": "cpu", **({"MISAKA_BATCH": batch} if batch else {})}
    m = app.build_master_from_env({**env, "MISAKA_ENGINE": "native"})
    assert m.status()["engine"] == "native" and m.status()["device"] == "cpu"
    m.close()
    with pytest.raises(ValueError, match="engine must be"):
        app.build_master_from_env({**env, "MISAKA_ENGINE": "bogus"})
    m = app.build_master_from_env({**env, "MISAKA_ENGINE": "scan"})
    assert m._engine == "scan" and m.status()["engine"] == "plain"
    m.close()
