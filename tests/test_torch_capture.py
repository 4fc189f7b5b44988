"""The port's capture and shadow-replay plane against the JAX package's.

The cases of tests/test_capture.py on the port (runtime/capture.py,
misaka_tpu_torch/replay.py, the registry's ?verify=replay gate): the
bounded ring under a concurrent flood, sampling with the inbound-trace
bypass, the kill switch, the segment format through its manifest
verifier (corruption refused), anchor checkpoints on export, byte-for-
byte replay of a mixed-tenant parity-corpus capture on both compute lanes,
a mutated program's loud diff, the unsound-replay refusals, the HTTP loop
(arm, serve, verify=replay 200 and 409, export), the admin gate, the
kill switch's 409 and the load-model fit.

Against the JAX package: the same notes write the same segment frames
(the `.mskcap` format byte for byte, the header's two timestamps apart);
a segment and its anchor checkpoint written by the JAX server replay
green through the port's `replay`, one written by the port's server
replay green through tools/replay.py, and a divergent candidate prints
the same diff lines in both tools; the two servers answer
?verify=replay's 200 and 409 with equal bodies (the requests carry fixed
trace IDs; each diff's engine `tick` is left out, it counts idle chunks),
/captures/rotate with the reference's no-spool 409, and /debug/captures,
the diffs and the load model with the same fields.

The canary: requests to `_canary` are recorded under `_canary`, never in
another program's stream.  The unbatched (B=1) lane replays green too,
and a gate's shadow engine is freed once the gate returns.
"""

import gc
import importlib.util
import io
import json
import os
import threading
import time
import types
import urllib.error
import urllib.parse
import urllib.request
import weakref

import numpy as np
import pytest
import torch

import misaka_tpu_torch.client as tclient
from misaka_tpu import networks as jnetworks
from misaka_tpu.runtime import capture as jcapture
from misaka_tpu.runtime import master as jmaster
from misaka_tpu.runtime import registry as jregistry
from misaka_tpu.runtime.topology import Topology as JTopology
from misaka_tpu_torch import networks as tnetworks
from misaka_tpu_torch import replay as treplay
from misaka_tpu_torch.runtime import capture
from misaka_tpu_torch.runtime import edge as tedge
from misaka_tpu_torch.runtime import frontends as tfrontends
from misaka_tpu_torch.runtime import master as tmaster
from misaka_tpu_torch.runtime import registry as tregistry
from misaka_tpu_torch.runtime.topology import Topology

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(stack_cap=16, in_cap=16, out_cap=16)
ADD10 = "IN ACC\nADD 10\nOUT ACC\n"
ADD20 = "IN ACC\nADD 20\nOUT ACC\n"
DELAY = "IN ACC\nSWP\nOUT ACC\nSWP\nSAV\n"  # output_i = input_{i-1}
CORPUS = os.path.join(ROOT, "tests", "corpus", "parity")
PKGS = {
    "jax": types.SimpleNamespace(capture=jcapture, master=jmaster, reg=jregistry,
                                 networks=jnetworks, kw={"engine": "scan"}),
    "torch": types.SimpleNamespace(capture=capture, master=tmaster, reg=tregistry,
                                   networks=tnetworks, kw={"engine": "scan", "device": "cpu"}),
}


def _tools_replay():
    """tools/replay.py, loaded by path as the JAX CLI loads it."""
    spec = importlib.util.spec_from_file_location("_jax_replay_tool",
                                                  os.path.join(ROOT, "tools", "replay.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _capture_reset():
    # the recorders are module-global: each test starts idle and empty
    for mod in (capture, jcapture):
        mod.configure()
        if mod.recording():
            mod.stop()
        mod.start()
        mod.stop()
    yield
    for mod in (capture, jcapture):
        if mod.recording():
            mod.stop()
        mod.configure()


@pytest.fixture(scope="module", autouse=True)
def _quiet_jax_daemons():
    with pytest.MonkeyPatch.context() as mp:
        for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG", "MISAKA_CANARY"):
            mp.setenv(switch, "0")
        yield


def _tmaster(top, batch=2):
    return tmaster.MasterNode(top, chunk_steps=32, batch=batch, device="cpu")


# --- ring discipline ---------------------------------------------------------------------


def test_ring_bounded_under_concurrent_flood():
    capture.configure({"MISAKA_CAPTURE_MB": "0.0625"})  # the 64 KiB floor
    capture.start()
    blob = b"\0" * 1024
    peak = [0]

    def writer(k):
        for i in range(200):
            capture.note("http", program=f"p{k}", trace=None, inbound=False, vals=blob,
                         resp=blob, status=200, tick=i)
            peak[0] = max(peak[0], capture.mem_bytes())

    ts = [threading.Thread(target=writer, args=(k,)) for k in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    st = capture.status()
    assert peak[0] <= st["budget_bytes"] == 1 << 16
    assert st["dropped"] > 0 and st["dropped"] + st["records"] == 1600
    seqs = [r["seq"] for r in capture.records()]
    assert seqs == list(range(seqs[0], seqs[0] + len(seqs)))


def test_sampling_and_trace_id_bypass():
    capture.configure({"MISAKA_CAPTURE_SAMPLE": "0.0"})
    capture.start()
    for i in range(50):
        capture.note("http", program="p", trace=f"t{i}", inbound=False, vals=b"\0" * 4,
                     resp=b"\0" * 4, status=200, tick=i)
    assert (capture.status()["records"], capture.status()["sampled_out"]) == (0, 50)
    capture.note("http", program="p", trace="wanted", inbound=True, vals=b"\0" * 4,
                 resp=b"\0" * 4, status=200, tick=0)
    capture.ingest("worker", [
        {"t": time.time(), "program": "p", "trace": None, "in": 0, "status": 429,
         "reason": "overload"},
        {"t": time.time(), "program": "p", "trace": "kept", "in": 1, "status": 429,
         "reason": "overload"},
        {"t": "not a time"},  # a malformed row costs itself only
    ])
    assert [r["trace"] for r in capture.records()] == ["wanted", "kept"]
    assert set(capture.status()) == set(jcapture.status())


def test_kill_switch_is_terminal():
    capture.configure({"MISAKA_CAPTURE": "0"})
    assert not capture.available()
    with pytest.raises(capture.CaptureError, match="kill switch"):
        capture.start()
    assert capture.RECORDING is False
    capture.note("http", program="p", trace=None, inbound=False, vals=b"", resp=b"",
                 status=200, tick=0)
    assert capture.status()["records"] == 0


# --- the segment format --------------------------------------------------------------------


def _note_same(mod, n=6):
    mod.configure({"MISAKA_CAPTURE_SAMPLE": "1.0"})
    mod.start()
    for i in range(n):
        vals = np.arange(i + 1, dtype="<i4") - 3
        mod.note("http" if i % 2 else "plane", program="p" if i % 3 else None,
                 trace=f"t{i}", inbound=bool(i % 2), vals=vals.tobytes(),
                 resp=(vals + 10).tobytes(), status=200, tick=i, reqs=1 + i % 2,
                 op="many" if i % 2 else "coalesced",
                 segs=[{"id": f"t{i}", "in": True, "off": 0, "len": i + 1}] if i == 4 else None,
                 t=1792000000.0 + i)
    mod.ingest("worker", [{"t": 1792000009.5, "program": "p", "trace": "r", "in": 1,
                           "status": 429, "reason": "overload"}])
    mod.stop()


def _frames(path):
    blob = open(path, "rb").read()
    assert blob[:8] == b"MSKCAP1\n"
    out, pos = [], 8
    while pos < len(blob):
        n = int.from_bytes(blob[pos:pos + 4], "little")
        out.append(blob[pos + 4:pos + 4 + n])
        pos += 4 + n
    return out


def test_segment_frames_byte_equal_jax(tmp_path):
    paths = {}
    for name, p in PKGS.items():
        _note_same(p.capture)
        paths[name] = str(tmp_path / f"{name}.mskcap")
        p.capture.write_segment(paths[name])
    fj, ft = _frames(paths["jax"]), _frames(paths["torch"])
    assert ft[1:] == fj[1:]  # every record frame, byte for byte
    hj, ht = json.loads(fj[0]), json.loads(ft[0])
    for h in (hj, ht):
        h.pop("saved_unix")
        h.pop("started_unix")
    assert hj == ht
    # each package reads the other's segment to the same records
    for reader in (capture, jcapture):
        recs = [reader.read_segment(paths[n], verify=True)[1] for n in PKGS]
        assert recs[0] == recs[1] and len(recs[0]) == 7
    m = capture.verify_segment(paths["torch"])
    assert m["records"] == 7 and m["sha256"]


def test_segment_corruption_detected(tmp_path):
    _note_same(capture)
    path = str(tmp_path / "seg.mskcap")
    capture.write_segment(path)
    blob = open(path, "rb").read()
    with open(path, "r+b") as f:
        f.seek(len(blob) - 3)
        f.write(bytes([blob[-3] ^ 0xFF]))
    with pytest.raises(capture.CaptureError, match="sha256"):
        capture.verify_segment(path)
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises(capture.CaptureError, match="torn|bytes"):
        capture.verify_segment(path)
    os.unlink(capture._segment_manifest_path(path))
    with pytest.raises(capture.CaptureError):
        capture.read_segment(path, verify=True)


def test_export_anchor_checkpoints_load_in_both_packages(tmp_path):
    m = _tmaster(Topology(node_info={"main": "program"}, programs={"main": DELAY}, **SMALL))
    try:
        m.run()
        assert m.compute_many([5]) == [0]  # state worth anchoring: BAK holds 5
        capture.configure({"MISAKA_CAPTURE_SAMPLE": "1.0"})
        a = capture.anchor_from_master("default", m)
        capture.start(anchors={"default": a})
        capture.stop()
        res = capture.export(str(tmp_path / "cap.mskcap"))
    finally:
        m.close()
    apath = res["anchors"]["default"]
    assert os.path.exists(apath + ".manifest")
    header, _ = capture.read_segment(res["path"], verify=True)
    # no card: `auto` serves on the host C++ tier
    assert header["anchors"]["default"] == {"tick": a["tick"], "batch": 2, "engine": "native",
                                            "dropped_since_anchor": 0,
                                            "file": os.path.basename(apath)}
    tmeta, tstate = capture.load_anchor_checkpoint(apath)
    jmeta, jstate = jcapture.load_anchor_checkpoint(apath)
    assert tmeta == jmeta == a["meta"]
    for f in tstate._fields:
        np.testing.assert_array_equal(tstate[tstate._fields.index(f)].numpy(),
                                      np.asarray(getattr(jstate, f)), err_msg=f)


# --- byte-for-byte replay ---------------------------------------------------------------


def _corpus(name):
    with open(os.path.join(CORPUS, f"{name}.json")) as f:
        case = json.load(f)
    top = Topology(node_info=case["node_info"], programs=case["programs"], stack_cap=64,
                   in_cap=32, out_cap=32)
    return case, top


def test_parity_corpus_replay_byte_identical():
    """Mixed-tenant parity-corpus traffic on both lanes, replayed from the
    anchors.  The tenants take turns in blocks, one engine running at a
    time: several plain-engine loops idling at once would burn the CPU
    the rest of the suite shares."""
    capture.configure({"MISAKA_CAPTURE_SAMPLE": "1.0", "MISAKA_CAPTURE_MB": "64"})
    names = ["add2", "kahn_002", "branch_sign"]
    cases = {n: _corpus(n) for n in names}
    masters = {n: tmaster.MasterNode(top, chunk_steps=64, batch=2, device="cpu")
               for n, (_, top) in cases.items()}
    anchors = {n: capture.anchor_from_master(n, m) for n, m in masters.items()}
    try:
        capture.start(anchors=anchors)
        rng = np.random.default_rng(17)
        for k in range(48):
            n = names[(k // 4) % 3]
            m = masters[n]
            if k % 4 == 0:
                m.run()
            pool = cases[n][0]["inputs"]
            vals = np.array([pool[int(j)] for j in rng.integers(0, len(pool),
                                                                rng.integers(1, 5))], np.int32)
            op = ("coalesced", "many")[k % 2]
            out = (m.compute_many if op == "many" else m.compute_coalesced)(
                vals, return_array=True)
            capture.note("http", program=n, trace=f"t{k:05d}", inbound=False,
                         vals=vals.astype("<i4").tobytes(),
                         resp=np.asarray(out).astype("<i4").tobytes(), status=200,
                         tick=int(m._ticks_done), op=op)
            if k % 4 == 3:
                m.pause()
        capture.stop()
        assert capture.status()["records"] == 48
        for n in names:
            recs = capture.replayable(capture.records(program=n))
            assert len(recs) == 16
            shadow = tmaster.MasterNode(cases[n][1], chunk_steps=64, batch=2, device="cpu")
            try:
                shadow.restore(anchors[n]["state"])
                shadow.run()
                diffs = capture.replay_records(shadow, recs)
            finally:
                shadow.close()
            assert diffs == [], capture.format_diff(diffs[0])
    finally:
        for m in masters.values():
            m.close()


def _mutant_diffs(p):
    """Eight captured requests of +10, replayed against +20, in package p."""
    p.capture.configure({"MISAKA_CAPTURE_SAMPLE": "1.0"})
    T = JTopology if p is PKGS["jax"] else Topology
    m = p.master.MasterNode(T(node_info={"main": "program"}, programs={"main": ADD10}, **SMALL),
                            chunk_steps=32, batch=2, **p.kw)
    try:
        m.run()
        anchor = p.capture.anchor_from_master("p", m)
        p.capture.start(anchors={"p": anchor})
        for i in range(8):
            vals = np.arange(i + 1, dtype=np.int32)
            out = m.compute_coalesced(vals, return_array=True)
            p.capture.note("http", program="p", trace=f"req-{i}", inbound=False,
                           vals=vals.astype("<i4").tobytes(),
                           resp=np.asarray(out).astype("<i4").tobytes(), status=200, tick=0)
        p.capture.stop()
    finally:
        m.close()
    recs = p.capture.replayable(p.capture.records(program="p"))
    shadow = p.master.MasterNode(T(node_info={"main": "program"}, programs={"main": ADD20},
                                   **SMALL), chunk_steps=32, batch=2, **p.kw)
    try:
        shadow.restore(anchor["state"])
        shadow.run()
        return p.capture.replay_records(shadow, recs)
    finally:
        shadow.close()


def test_mutated_program_diverges_loudly_like_jax():
    jd, td = _mutant_diffs(PKGS["jax"]), _mutant_diffs(PKGS["torch"])
    assert td == jd and len(td) == 8
    assert [capture.format_diff(d) for d in td] == [jcapture.format_diff(d) for d in jd]
    for off, d in enumerate(td):
        assert d["offset"] == off and d["trace"] == f"req-{off}"
        assert d["expected_head"][0] + 10 == d["actual_head"][0]
    # the same verdict through the registry's publish gate
    reg = tregistry.ProgramRegistry(None, batch=2, engine="scan", chunk_steps=32, caps=SMALL,
                                    device="cpu")
    try:
        reg.publish("p", tis=ADD10)
        with pytest.raises(tregistry.ReplayDivergence) as ei:
            reg.publish("p", tis=ADD20, verify="replay")
        assert len(ei.value.diffs) == 8 and ei.value.diffs[0]["trace"] == "req-0"
        assert reg.resolve("p") == ("p", reg.list_programs()["programs"]["p"]["latest"])
    finally:
        reg.close()


def test_verify_bundle_refuses_unsound_replay_like_jax():
    errs = []
    for p in PKGS.values():
        p.capture.configure({"MISAKA_CAPTURE_SAMPLE": "1.0"})
        p.capture.start()
        with pytest.raises(p.capture.CaptureError) as e1:
            p.capture.verify_bundle("ghost")
        p.capture.stop()
        p.capture.configure({"MISAKA_CAPTURE_MB": "1", "MISAKA_CAPTURE_SAMPLE": "1.0"})
        p.capture.start(anchors={"p": {"tick": 0, "batch": 2, "state": None}})
        with pytest.raises(p.capture.CaptureError) as e2:
            p.capture.verify_bundle("p")  # anchored, nothing recorded
        blob = b"\0" * 65536
        for i in range(40):
            p.capture.note("http", program="p", trace=None, inbound=False, vals=blob,
                           resp=blob, status=200, tick=i)
        with pytest.raises(p.capture.CaptureError) as e3:
            p.capture.verify_bundle("p")
        p.capture.stop()
        errs.append([str(e1.value), str(e2.value), str(e3.value)])
    assert errs[0] == errs[1]
    assert "anchor" in errs[1][0] and "evicted" in errs[1][2]


# --- the HTTP surface ---------------------------------------------------------------------


def _serve(p, batch=2):
    p.capture.configure({"MISAKA_CAPTURE_SAMPLE": "1.0"})
    reg = p.reg.ProgramRegistry(None, batch=batch, chunk_steps=32, caps=SMALL, **p.kw)
    top = p.networks.add2(**SMALL)
    m = p.master.MasterNode(top, chunk_steps=32, batch=batch, **p.kw)
    reg.seed("default", m, top)
    m.run()
    httpd = p.master.make_http_server(m, port=0, registry=reg)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}", m, reg, httpd


def _stop(m, reg, httpd):
    httpd.shutdown()
    httpd.server_close()
    reg.close()
    m.close()


def _call(base, path, form=None, raw=None, trace=None):
    data = raw if raw is not None else (
        urllib.parse.urlencode(form).encode() if form is not None else None)
    req = urllib.request.Request(base + path, data=data,
                                 headers={"X-Misaka-Trace": trace} if trace else {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _verify_drill(p, tmp_path):
    """Arm, serve a pinned delay line with fixed trace IDs, verify an
    equivalent rewrite (200) and a mutant (409); export the segment."""
    base, m, reg, httpd = _serve(p)
    try:
        out = [_call(base, "/programs", {"name": "d", "program": DELAY})[0]]
        # activate the engine before anchoring it; two pinned requests at
        # B=2 bring its rotating slot start back to 0, where a shadow's
        # starts (the anchor holds the state, not that cursor)
        for v in (1, 2):
            out.append(_call(base, "/programs/d/compute_raw?spread=0",
                             raw=np.asarray([v], "<i4").tobytes())[0])
        st = json.loads(_call(base, "/captures/start", {})[1])
        out.append((sorted(st["anchors"]), st["recording"]))
        out.append(_call(base, "/captures/start", {}))  # double arm: 409
        for i in range(6):
            raw = np.asarray([i * 7 - 3, i], "<i4").tobytes()
            out.append(_call(base, "/programs/d/compute_raw?spread=0", raw=raw,
                             trace=f"{0xfeed0000 + i:016x}"))
        for i in range(3):
            out.append(_call(base, "/compute", {"value": str(i)}, trace=f"{0xbeef0000 + i:016x}"))
        # stopped: the swap the green gate makes is not in the stream
        out.append(json.loads(_call(base, "/captures/stop", {})[1])["records"])
        # an equivalent rewrite: a new version, the same answers
        ok = _call(base, "/programs?verify=replay", {"name": "d", "program": DELAY + "NOP\n"})
        out.append((ok[0], sorted(json.loads(ok[1]))))
        bad = _call(base, "/programs?verify=replay", {"name": "d", "program": ADD10})
        body = json.loads(bad[1])
        for d in body["diffs"]:
            d.pop("tick")
        out.append((bad[0], body))
        out.append(_call(base, "/programs/d/compute_raw?spread=0",
                         raw=np.asarray([42], "<i4").tobytes()))  # the mutant never swapped
        out.append(_call(base, "/captures/rotate", {}))
        dbg = json.loads(_call(base, "/debug/captures?n=3")[1])
        out.append((sorted(dbg), [(r["surface"], r["program"], r["op"], r["n"], r["vals_head"],
                                   r["resp_head"]) for r in dbg["preview"]]))
        exp = json.loads(_call(base, "/captures/export",
                               {"path": str(tmp_path / "wire.mskcap")})[1])
        out.append((exp["records"], sorted(exp["anchors"])))
        hz = json.loads(_call(base, "/healthz")[1])
        assert hz["debug_mem"]["capture_bytes"] > 0
        return out, exp
    finally:
        _stop(m, reg, httpd)


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    """The drill once per package: (answers, export result)."""
    root = tmp_path_factory.mktemp("drills")
    out = {}
    for n, p in PKGS.items():
        _capture_reset_now()
        out[n] = _verify_drill(p, root / n)
    return out


def _capture_reset_now():
    for mod in (capture, jcapture):
        if mod.recording():
            mod.stop()
        mod.configure()


def test_http_verify_replay_and_export_equal_jax(drills, tmp_path):
    (jout, jexp), (tout, texp) = drills["jax"], drills["torch"]
    assert tout == jout
    assert tout[3] == (["d", "default"], True) and tout[4][0] == 409
    assert tout[14] == 9 and tout[15][0] == 200 and tout[16][0] == 409
    diffs = tout[16][1]["diffs"]
    assert len(diffs) == 6 and diffs[0]["trace"] == f"{0xfeed0000:016x}"
    assert tout[18] == (409, b"capture spool not armed (set MISAKA_TSDB_DIR)")
    # each package's segment replays green in the other's tool, and a
    # divergent candidate prints the same lines in both
    jtool = _tools_replay()
    cand = tmp_path / "cand.json"
    cand.write_text(json.dumps({"nodes": {"main": "program"}, "programs": {"main": ADD20}}))
    for exp in (jexp, texp):
        for fn, kw in ((jtool.replay_segment, {}), (treplay.replay_segment, {"device": "cpu"})):
            buf = io.StringIO()
            assert fn(exp["path"], out=buf, **kw) == 0, buf.getvalue()
            assert buf.getvalue().splitlines() == ["d: replay green — 6 requests byte-for-byte "
                                                   "identical", "default: replay green — 3 "
                                                   "requests byte-for-byte identical"]
        lines = []
        for fn, kw in ((jtool.replay_segment, {}), (treplay.replay_segment, {"device": "cpu"})):
            buf = io.StringIO()
            assert fn(exp["path"], candidate=str(cand), program="d", out=buf, **kw) == 1
            lines.append(buf.getvalue().splitlines())
        assert lines[0] == lines[1] and lines[1][-1] == "d: DIVERGED on 6/6 captured requests"


def test_cli_replay_emits_the_load_model(drills, tmp_path):
    exp = drills["torch"][1]
    model = tmp_path / "model.json"
    from misaka_tpu_torch.__main__ import main as tcli

    assert tcli(["replay", exp["path"], "--device", "cpu", "--emit-model", str(model)]) == 0
    fitted = json.loads(model.read_text())
    jfitted = jcapture.fit_load_model(capture.read_segment(exp["path"])[1])
    for f in (fitted, jfitted):
        f.pop("fitted_unix")
    assert fitted == jfitted and "d" in fitted["tenants"]


def test_unbatched_capture_replays_green(tmp_path):
    base, m, reg, httpd = _serve(PKGS["torch"], batch=None)
    try:
        assert _call(base, "/captures/start", {})[0] == 200
        for i in range(5):
            assert _call(base, "/compute", {"value": str(i)}) == (200, b'{"value": %d}\n' % (i + 2))
        exp = json.loads(_call(base, "/captures/export",
                               {"path": str(tmp_path / "b1.mskcap")})[1])
    finally:
        _stop(m, reg, httpd)
    header, _ = capture.read_segment(exp["path"])
    assert header["anchors"]["default"]["batch"] is None
    buf = io.StringIO()
    assert treplay.replay_segment(exp["path"], out=buf, device="cpu") == 0, buf.getvalue()


def test_canary_records_stay_under_canary():
    base, m, reg, httpd = _serve(PKGS["torch"])
    try:
        reg.publish("_canary", tis="IN ACC\nADD 7\nOUT ACC\n")
        assert _call(base, "/captures/start", {})[0] == 200
        raw = np.asarray([1, 2], "<i4").tobytes()
        assert _call(base, "/programs/_canary/compute_raw?spread=1", raw=raw)[0] == 200
        assert _call(base, "/compute", {"value": "1"})[0] == 200
    finally:
        _stop(m, reg, httpd)
    assert [r["program"] for r in capture.records()] == ["_canary", "default"]
    assert [r["n"] for r in capture.replayable(capture.records(program="default"))] == [1]


def test_plane_frames_and_worker_rejects_are_recorded(tmp_path):
    m = _tmaster(tnetworks.add2(**SMALL))
    path = str(tmp_path / "plane.sock")
    plane = tfrontends.start_compute_plane(m, path)
    client = tfrontends.PlaneClient(path, conns=1)
    m.run()
    try:
        capture.start(anchors={"default": capture.anchor_from_master("default", m)})
        client.report_capture({"t": time.time(), "program": None, "trace": None, "in": 0,
                               "status": 429, "reason": "overload"})
        out = client.compute_raw(np.asarray([3, 4], "<i4").tobytes())
        assert np.frombuffer(out, "<i4").tolist() == [5, 6]
        for _ in range(50):  # the plane records after its reply
            if len(capture.records()) == 2:
                break
            time.sleep(0.05)
    finally:
        client.close()
        plane.close()
        m.close()
    recs = capture.records()
    assert [(r["surface"], r["status"], r["op"]) for r in recs] == [
        ("worker", 429, "reject"), ("plane", 200, "coalesced")]
    assert recs[1]["resp"] == np.asarray([5, 6], "<i4").tobytes()


def test_verify_gate_frees_its_shadow(monkeypatch):
    made = []
    real = tmaster.MasterNode.__init__

    def spy(self, *a, **kw):
        real(self, *a, **kw)
        made.append(weakref.ref(self))

    reg = tregistry.ProgramRegistry(None, batch=2, engine="scan", chunk_steps=32, caps=SMALL,
                                    device="cpu")
    try:
        reg.publish("p", tis=ADD10)
        with reg.lease("p") as m:
            capture.configure({"MISAKA_CAPTURE_SAMPLE": "1.0"})
            capture.start(anchors={"p": capture.anchor_from_master("p", m)})
            out = m.compute_coalesced([1, 2], return_array=True)
            capture.note("http", program="p", trace="t", inbound=False,
                         vals=np.asarray([1, 2], "<i4").tobytes(),
                         resp=np.asarray(out, "<i4").tobytes(), status=200, tick=0)
            capture.stop()
        monkeypatch.setattr(tmaster.MasterNode, "__init__", spy)
        with pytest.raises(tregistry.ReplayDivergence):
            reg.publish("p", tis=ADD20, verify="replay")
        assert len(made) == 1
        # the shadow is gone once its threads have ended (bounded wait: a
        # loaded box may still be unwinding one when the gate returns)
        deadline = time.monotonic() + 10
        while made[0]() is not None and time.monotonic() < deadline:
            gc.collect()
            time.sleep(0.05)
        assert made[0]() is None
    finally:
        reg.close()


def test_capture_routes_admin_gated_and_kill_switch(tmp_path, monkeypatch):
    for route in ("/captures/start", "/captures/stop", "/captures/export", "/captures/rotate"):
        assert tedge.route_policy(route, "POST") == ("auth_admin",)
    assert tedge.route_policy("/debug/captures", "GET") == ("auth_admin",)
    kf = tmp_path / "keys.json"
    kf.write_text(json.dumps({"keys": [{"key": "adm", "tenant": "ops", "admin": True},
                                       {"key": "bob", "tenant": "bob"}]}))
    monkeypatch.setenv("MISAKA_API_KEYS", str(kf))
    m = _tmaster(tnetworks.add2(**SMALL))
    m.run()
    httpd = tmaster.make_http_server(m, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        bob = tclient.MisakaClient(url, api_key="bob")
        adm = tclient.MisakaClient(url, api_key="adm")
        for call in (bob.capture_start, bob.capture_stop, bob.capture_export,
                     lambda: bob.capture_status(1)):
            with pytest.raises(tclient.MisakaClientError) as ei:
                call()
            assert ei.value.status == 403
        assert adm.capture_start()["recording"] and adm.capture_status(0)["recording"]
        adm.capture_stop()
        capture.configure({"MISAKA_CAPTURE": "0"})
        with pytest.raises(tclient.MisakaClientError) as ei:
            adm.capture_start()
        assert ei.value.status == 409 and "kill switch" in ei.value.body
        assert adm.healthz()["ok"] is True
    finally:
        tedge.reset()
        httpd.shutdown()
        m.close()


def test_fit_load_model_equal_jax():
    rng = np.random.default_rng(3)
    rows = [(int(rng.integers(1, 30)), "a" if i % 3 else "b") for i in range(60)]
    models = []
    for p in PKGS.values():
        p.capture.configure({"MISAKA_CAPTURE_SAMPLE": "1.0"})
        p.capture.start()
        for i, (n, prog) in enumerate(rows):
            p.capture.note("http", program=prog, trace=None, inbound=False, vals=b"\0" * (4 * n),
                           resp=b"\0" * (4 * n), status=200, tick=i, t=1792000000.0 + i * 0.01)
        p.capture.stop()
        recs = p.capture.records()
        fitted = [p.capture.fit_load_model(recs),
                  p.capture.fit_load_model(recs, series=[(1792000000.0, 1000.0),
                                                         (1792000000.0 + 7200, 800.0)])]
        for f in fitted:
            f.pop("fitted_unix")
        models.append(fitted)
        with pytest.raises(p.capture.CaptureError):
            p.capture.fit_load_model([])
    assert models[0] == models[1]
    assert models[1][0]["source"]["requests"] == 60
    assert models[1][1]["arrival"]["rate_rps"] > models[1][0]["arrival"]["rate_rps"]
