"""The port's durable telemetry tier (MISAKA_TSDB_DIR) against the JAX
package's.

The cases of tests/test_durable.py past the spool itself
(tests/test_torch_spool.py), each run on both packages:

- the tier disarmed without the variable, and each plane's opt-out;
- the TSDB's fine and long tiers: the same collection run (one injected
  clock, values from a seeded numpy generator) spools byte-equal
  segments in both packages, and a directory written by either package
  reloads in the other, answering 10 m and 7 d windows with the points
  from before the restart; the writer resumes after the reloaded epochs
  (no slot written twice);
- the usage ledger's spool: cumulative counters monotone across a
  re-arm, a base spooled by either package reloaded by the other, a
  signed export of either package verified by the other, and a tampered
  line or another key refused by both;
- the capture spool: rotation, the on-disk history, the sequence resumed
  after a re-arm, with equal answers; a segment rotated by either
  package's server replays green through both packages' replay;
- the diurnal fit of the load model.

Then the restart drill on a real `python -m misaka_tpu_torch.runtime.app`
on the CPU: kill -9 with the tier armed, relaunch, /debug/series spans
the kill (15m and 7d windows), the usage export stays monotone and
conserves against the pass-wall anchor within 5% (the reference's
limit), and the segment rotated before the kill replays green through
`python -m misaka_tpu_torch replay`.  Every wait is a bounded poll.
"""

import importlib.util
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

from misaka_tpu import networks as jnetworks
from misaka_tpu.runtime import capture as jcapture
from misaka_tpu.runtime import master as jmaster
from misaka_tpu.runtime import registry as jregistry
from misaka_tpu.runtime import usage as jusage
from misaka_tpu.utils import metrics as jmetrics
from misaka_tpu.utils import spool as jspool
from misaka_tpu.utils import tsdb as jtsdb
from misaka_tpu_torch import networks as tnetworks
from misaka_tpu_torch import replay as treplay
from misaka_tpu_torch.client import MisakaClient
from misaka_tpu_torch.runtime import capture as tcapture
from misaka_tpu_torch.runtime import frontends as tfrontends
from misaka_tpu_torch.runtime import master as tmaster
from misaka_tpu_torch.runtime import registry as tregistry
from misaka_tpu_torch.runtime import usage as tusage
from misaka_tpu_torch.utils import metrics as tmetrics
from misaka_tpu_torch.utils import spool as tspool
from misaka_tpu_torch.utils import tsdb as ttsdb

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "jax": types.SimpleNamespace(tsdb=jtsdb, metrics=jmetrics, spool=jspool, usage=jusage,
                                 capture=jcapture, master=jmaster, networks=jnetworks,
                                 reg=jregistry, kw={"engine": "scan"}),
    "torch": types.SimpleNamespace(tsdb=ttsdb, metrics=tmetrics, spool=tspool, usage=tusage,
                                   capture=tcapture, master=tmaster, networks=tnetworks,
                                   reg=tregistry, kw={"device": "cpu"}),
}
T0 = 1_700_000_000.0


def _tools_replay():
    """tools/replay.py, loaded by path as the JAX CLI loads it."""
    spec = importlib.util.spec_from_file_location("_jax_replay_tool",
                                                  os.path.join(ROOT, "tools", "replay.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class FakeTime:
    def __init__(self):
        self.t = T0

    def time(self):
        return self.t

    def monotonic(self):
        return self.t - 1_600_000_000.0

    def perf_counter(self):
        return self.t - 1_600_000_000.0


@pytest.fixture
def clock(monkeypatch):
    c = FakeTime()
    for p in PKGS.values():
        monkeypatch.setattr(p.tsdb, "time", c)
    return c


@pytest.fixture(autouse=True)
def _clean_planes(monkeypatch):
    for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG"):
        monkeypatch.setenv(switch, "0")
    yield
    for p in PKGS.values():
        p.usage.shutdown_spool()
        p.capture.shutdown_spool()
        if p.capture.RECORDING:
            p.capture.stop()


def dir_bytes(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


def test_spools_disarmed_without_tsdb_dir(tmp_path):
    armed = {"MISAKA_TSDB_DIR": str(tmp_path)}
    envs = [{}, armed, {**armed, "MISAKA_USAGE_SPOOL": "0"}, {**armed, "MISAKA_CAPTURE_SPOOL": "0"}]

    def run(p):
        db = p.tsdb.TSDB(interval_s=1.0, registry=p.metrics.Registry())
        db.sample_once()  # no spool, no side effects
        return (db.spool_status(), [(p.usage.spool_dir(e), p.capture.spool_dir(e)) for e in envs],
                p.usage.ensure_spool({}), p.capture.ensure_spool({}))

    a, b = (run(p) for p in PKGS.values())
    assert a == b
    assert b[0] is None and b[1][0] == (None, None)
    assert b[1][1] == (str(tmp_path / "usage"), str(tmp_path / "capture"))
    assert b[1][2][0] is None and b[1][3][1] is None and b[2:] == (None, None)
    assert os.listdir(tmp_path) == []


# --- the TSDB's spooled tiers ----------------------------------------------------------------


def _spool_run(p, clock, d, steps=15, seed=5):
    """A gauge and a counter sampled once a second for `steps` seconds,
    every finalized slot spooled; the spool closed as a kill would
    leave it (fsync'd)."""
    clock.t = T0
    vals = np.random.default_rng(seed).integers(1, 1000, size=steps)
    reg = p.metrics.Registry()
    g = p.metrics.gauge("t_durable_g", "x", ("program",), registry=reg)
    c = p.metrics.counter("t_durable_c", "x", registry=reg)
    db = p.tsdb.TSDB(interval_s=1.0, registry=reg, spool_dir=str(d))
    assert db.spool_status() is not None
    for v in vals:
        g.labels(program="a").set(float(v))
        c.inc(float(v))
        db.sample_once()
        db._spool_flush()
        clock.t += 1.0
    clock.t += 2.0  # the last fine slot finalized
    db._spool_flush()
    clock.t = T0 + 400.0  # past the 300 s slot: the long tier's too
    db._spool_flush()
    assert db.spooled_frames > 0
    db.stop()
    return vals


def _reload_view(p, d):
    db = p.tsdb.TSDB(interval_s=1.0, registry=p.metrics.Registry(), spool_dir=str(d))
    view = (db.reloaded_frames, db.query("t_durable_g", window_s=600.0),
            db.query("t_durable_c", window_s=600.0),
            db.query("t_durable_g", window_s=p.tsdb.parse_window("7d")))
    before = dir_bytes(d)
    db._spool_flush()  # right after boot: nothing new to write
    assert dir_bytes(d) == before
    db.stop()
    return view


def test_tsdb_spool_byte_equal_and_reloads_across_packages(tmp_path, clock):
    for name, p in PKGS.items():
        vals = _spool_run(p, clock, tmp_path / name)
    assert dir_bytes(tmp_path / "jax") == dir_bytes(tmp_path / "torch")
    assert {n.split("-")[1] for n in os.listdir(tmp_path / "torch")} == {"fine", "long"}
    views = {}
    for writer in PKGS:
        for reader, p in PKGS.items():
            clock.t = T0 + 420.0  # the relaunch, on the same instant each time
            views[writer, reader] = _reload_view(p, tmp_path / writer)
    assert len({json.dumps(v) for v in views.values()}) == 1
    frames, fine, counter, week = views["jax", "torch"]
    assert frames > 0
    assert [pt[1] for pt in fine[0]["points"]] == [float(v) for v in vals]
    assert fine[0]["stage_s"] == 1.0 and all(pt[0] < T0 + 20.0 for pt in fine[0]["points"])
    assert counter[0]["kind"] == "rate" and len(counter[0]["points"]) == len(vals) - 1
    assert week[0]["stage_s"] == 300.0 and week[0]["points"][0][2] == float(vals.max())


# --- the usage ledger's spool -----------------------------------------------------------------


def _accrue(p, label, n_values, cpu):
    p.usage.add_request(label, n_values)
    p.usage.add_cpu(label, cpu)
    p.usage.note_pass(cpu)


def test_usage_cumulative_monotone_across_rearm_equal(tmp_path):
    def run(p, d):
        env = {"MISAKA_TSDB_DIR": str(d), "MISAKA_USAGE_FLUSH_S": "60"}
        label = "t_durable_rearm"
        p.usage.shutdown_spool()
        assert p.usage.ensure_spool(env) is not None
        _accrue(p, label, 8, 0.5)
        assert p.usage.flush_now(force=True)
        row1 = p.usage.cumulative_snapshot()["programs"][label]
        p.usage.shutdown_spool()  # the restart: the spooled frame is the base
        assert p.usage.ensure_spool(env) is not None
        row2 = p.usage.cumulative_snapshot()["programs"][label]
        _accrue(p, label, 2, 0.25)
        row3 = p.usage.cumulative_snapshot()["programs"][label]
        p.usage.shutdown_spool()
        return row1, row2, row3

    a = run(PKGS["jax"], tmp_path / "jax")
    b = run(PKGS["torch"], tmp_path / "torch")
    assert a == b
    row1, row2, row3 = b
    assert row1["requests"] == 1 and row1["values"] == 8 and row2 == row1
    assert row3["requests"] == 2 and row3["values"] == 10 and row3["cpu_seconds"] == 0.75


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_usage_spool_reloads_across_packages(tmp_path, writer, reader):
    env = {"MISAKA_TSDB_DIR": str(tmp_path), "MISAKA_USAGE_FLUSH_S": "60"}
    label = f"t_durable_x_{writer}"
    w, r = PKGS[writer].usage, PKGS[reader].usage
    assert w.ensure_spool(env) is not None
    _accrue(PKGS[writer], label, 6, 0.125)
    assert w.flush_now(force=True)
    want = w.cumulative_snapshot()
    w.shutdown_spool()
    assert r.ensure_spool(env) is not None
    got = r.cumulative_snapshot()
    assert got["programs"][label] == want["programs"][label]
    assert got["pass_wall_seconds"] >= want["pass_wall_seconds"]
    r.shutdown_spool()


@pytest.mark.parametrize("signer,verifier", [("jax", "torch"), ("torch", "jax")])
def test_usage_export_signed_verifies_across_packages(tmp_path, signer, verifier):
    env = {"MISAKA_TSDB_DIR": str(tmp_path), "MISAKA_USAGE_FLUSH_S": "60"}
    signed_env = {**env, "MISAKA_USAGE_SECRET": "hunter2"}
    label = f"t_durable_sig_{signer}"
    s, v = PKGS[signer].usage, PKGS[verifier].usage
    assert s.ensure_spool(env) is not None
    _accrue(PKGS[signer], label, 4, 0.25)
    lines = s.export_lines(environ=signed_env)
    periods = [i for i, ln in enumerate(lines)
               if ln.get("kind") == "period" and ln.get("program") == label]
    assert periods and lines[-1]["kind"] == "totals" and "sig" in lines[-1]
    totals = [mod.totals_from_lines(lines, secret=b"hunter2") for mod in (s, v)]
    assert totals[0] == totals[1] and totals[1]["verified"]
    assert totals[1]["programs"][label]["requests"] == 1.0
    assert totals[1]["cumulative"][label]["cpu_seconds"] == pytest.approx(0.25)
    assert not v.totals_from_lines(lines)["verified"]
    forged = [dict(ln) for ln in lines]
    forged[periods[0]]["cpu_seconds"] = 99.0
    for mod in (s, v):
        with pytest.raises(mod.UsageExportError):
            mod.totals_from_lines(forged, secret=b"hunter2")
        with pytest.raises(mod.UsageExportError):
            mod.totals_from_lines(lines, secret=b"not-the-key")
    s.shutdown_spool()


# --- the capture spool -------------------------------------------------------------------------


def _fake_traffic(capture, n, program="p0"):
    for i in range(n):
        vals = np.arange(4, dtype="<i4") + i
        capture.note("compute_raw", program=program, trace=None, inbound=True,
                     vals=vals.tobytes(), resp=(vals + 1).tobytes(), status=200, tick=None)


def test_capture_spool_rotation_and_history_equal(tmp_path):
    def run(p, d):
        cap = p.capture
        env = {"MISAKA_TSDB_DIR": str(d), "MISAKA_CAPTURE_SEG_S": "9999",
               "MISAKA_CAPTURE_SEG_KB": "100000"}
        cap.shutdown_spool()
        if cap.RECORDING:
            cap.stop()
        st = cap.ensure_spool(env, anchor_fn=None)
        assert st is not None and cap.RECORDING
        _fake_traffic(cap, 10)
        r1 = cap.rotate_now()
        out = [r1["records"], cap.verify_segment(r1["path"])["records"]]
        _fake_traffic(cap, 5)
        out.append(cap.rotate_now()["records"])
        out.append([os.path.basename(x) for x in
                    cap.history_segments(directory=os.path.join(str(d), "capture"))])
        out.append(cap.rotate_now())  # an empty ring: no segment
        status = cap.spool_status()
        out.append({k: v for k, v in status.items() if k not in ("dir", "disk_bytes")})
        cap.shutdown_spool()
        cap.stop()
        out.append(cap.ensure_spool(env, anchor_fn=None)["next_seq"])  # resumes
        cap.shutdown_spool()
        cap.stop()
        return out

    a = run(PKGS["jax"], tmp_path / "jax")
    b = run(PKGS["torch"], tmp_path / "torch")
    assert a == b
    assert b[:3] == [10, 10, 5] and b[3] == ["spool-00000000.mskcap", "spool-00000001.mskcap"]
    assert b[4] is None and b[5]["rotations"] == 2 and b[5]["segments"] == 2 and b[6] == 2


def _rotated_segment(p, d, n_requests=6):
    """A server of `p` with the capture spool armed under `d`: serve add2,
    rotate, and return the segment's path."""
    old = {k: os.environ.get(k) for k in ("MISAKA_TSDB_DIR", "MISAKA_CAPTURE_SEG_S")}
    os.environ["MISAKA_TSDB_DIR"] = str(d)
    os.environ["MISAKA_CAPTURE_SEG_S"] = "9999"
    m = p.master.MasterNode(p.networks.add2(in_cap=8, out_cap=8, stack_cap=8), chunk_steps=16,
                            batch=2, **p.kw)
    try:
        httpd = p.master.make_http_server(m, port=0)
    finally:
        for k, v in old.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    m.run()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        rng = np.random.default_rng(9)
        for _ in range(n_requests):
            vals = rng.integers(-1000, 1000, size=4).astype("<i4")
            req = urllib.request.Request(base + "/compute_raw", data=vals.tobytes())
            with urllib.request.urlopen(req, timeout=60) as r:
                assert np.frombuffer(r.read(), "<i4").tolist() == (vals + 2).tolist()
        req = urllib.request.Request(base + "/captures/rotate", data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            rotated = json.loads(r.read())
        assert rotated["records"] == n_requests
        return rotated["path"]
    finally:
        p.capture.shutdown_spool()
        p.capture.stop()
        p.usage.shutdown_spool()
        httpd.shutdown()
        httpd.server_close()
        m.close()


@pytest.mark.parametrize("writer", list(PKGS))
def test_rotated_segment_replays_green_in_both_packages(tmp_path, writer):
    seg = _rotated_segment(PKGS[writer], tmp_path)
    assert os.path.basename(seg) == "spool-00000000.mskcap"
    jtool = _tools_replay()
    for fn, kw in ((jtool.replay_segment, {}), (treplay.replay_segment, {"device": "cpu"})):
        buf = io.StringIO()
        assert fn(seg, out=buf, **kw) == 0, buf.getvalue()
        assert buf.getvalue().splitlines() == [
            "default: replay green — 6 requests byte-for-byte identical"]


ADD10 = "IN ACC\nADD 10\nOUT ACC\n"
# +10 but for 0, which answers 99: equivalent to ADD10 on any stream without a 0
ZERO99 = "IN ACC\nJEZ ZERO\nADD 10\nJMP END\nZERO: ADD 99\nEND: OUT ACC\n"


def _history_gate(p, d, monkeypatch):
    """A registry engine recorded under an armed capture spool: 0, 1, 2
    rotated into the history, 3, 4 left in the ring; then ?verify=replay
    of ZERO99, with the history swept and with MISAKA_REPLAY_HISTORY=0."""
    reg = p.reg.ProgramRegistry(None, batch=2, chunk_steps=16,
                                caps=dict(in_cap=8, out_cap=8, stack_cap=8), **p.kw)
    p.capture.configure({"MISAKA_CAPTURE_SAMPLE": "1.0"})
    env = {"MISAKA_TSDB_DIR": str(d), "MISAKA_CAPTURE_SEG_S": "9999"}
    monkeypatch.setenv("MISAKA_TSDB_DIR", str(d))  # where the gate finds the history
    try:
        reg.publish("p", tis=ADD10)
        with reg.lease("p"):
            pass  # activated: the spool anchors live engines only
        assert p.capture.ensure_spool(env, anchor_fn=lambda: {
            n: p.capture.anchor_from_master(n, m) for n, m in reg.active_masters()})

        def serve(values):
            with reg.lease("p") as m:
                for v in values:  # serialized, one pinned request at a time
                    vals = np.asarray([v], np.int32)
                    out = m.compute_many(vals, return_array=True)
                    p.capture.note("http", program="p", trace=f"v{v}", inbound=False,
                                   vals=vals.tobytes(), resp=out.astype("<i4").tobytes(),
                                   status=200, tick=0, op="many")

        serve([0, 1, 2])
        assert p.capture.rotate_now()["records"] == 3
        serve([3, 4])
        with pytest.raises(p.reg.ReplayDivergence) as ei:
            reg.publish("p", tis=ZERO99, verify="replay")
        refused = (str(ei.value).replace(str(d), "<dir>"),
                   [(x["offset"], x["expected_head"], x["actual_head"]) for x in ei.value.diffs])
        monkeypatch.setenv("MISAKA_REPLAY_HISTORY", "0")
        swapped = reg.publish("p", tis=ZERO99, verify="replay")["swapped"]
        monkeypatch.delenv("MISAKA_REPLAY_HISTORY")
        return refused, swapped
    finally:
        p.capture.shutdown_spool()
        p.capture.stop()
        p.capture.configure()
        reg.close()


def test_verify_gate_sweeps_rotated_history_like_jax(tmp_path, monkeypatch):
    """The gate replays the newest rotated segments too: a candidate equal
    to the live program on the ring's requests but not on the history's is
    refused, on the history segment; with MISAKA_REPLAY_HISTORY=0 it
    swaps."""
    a = _history_gate(PKGS["jax"], tmp_path / "jax", monkeypatch)
    b = _history_gate(PKGS["torch"], tmp_path / "torch", monkeypatch)
    assert a == b
    (msg, diffs), swapped = b
    assert "history segment <dir>/capture/spool-00000000.mskcap" in msg
    assert diffs == [(0, [10], [99])] and swapped is True


def test_fit_diurnal_hour_weights_equal():
    pts = [(10 * 3600 + 60 * i, 1.0) for i in range(5)]
    pts += [(11 * 3600 + 60 * i, 3.0) for i in range(5)]
    a, b = (p.capture._fit_diurnal(pts) for p in PKGS.values())
    assert a == b and b["hours_observed"] == 2
    w = b["hour_weights_utc"]
    assert len(w) == 24 and w[10] == pytest.approx(0.5) and w[11] == pytest.approx(1.5)
    assert sum(w) / 24 == pytest.approx(1.0)
    assert [p.capture._fit_diurnal(pts[:5]) for p in PKGS.values()] == [None, None]


# --- the restart drill ------------------------------------------------------------------------


def _poll(cond, what, deadline_s=60.0, every=0.1):
    deadline = time.monotonic() + deadline_s
    while True:
        got = cond()
        if got:
            return got
        assert time.monotonic() < deadline, f"{what}: not within {deadline_s:.0f} s"
        time.sleep(every)


def _healthy(base):
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
            payload = json.loads(r.read())
        return payload.get("ok") and payload.get("running") and not payload.get("degraded")
    except OSError:
        return False


def _frames(d, prefix, kind):
    out = []
    tspool.SegmentSpool(d, prefix=prefix).read_frames(
        lambda fr: out.append(fr) if fr.get("k") == kind else None)
    return out


def _values_on_disk(tsdb_dir):
    """The fine tier's spooled slots of misaka_compute_values_total."""
    return [row for fr in _frames(tsdb_dir, "tsdb-fine", "slots") for row in fr["rows"]
            if row[0] == "misaka_compute_values_total" and row[3] > 0]


def test_restart_drill_durable_telemetry(tmp_path):
    """kill -9 of a CPU server with MISAKA_TSDB_DIR armed, then a relaunch
    over the same directory."""
    port = tfrontends.pick_free_port()
    base = f"http://127.0.0.1:{port}"
    tsdb_dir = tmp_path / "telemetry"
    env = {k: v for k, v in os.environ.items() if not k.startswith("MISAKA_")}
    env.update(
        NODE_INFO=json.dumps({"solo": {"type": "program"}}),
        MISAKA_PROGRAMS=json.dumps({"solo": "IN ACC\nADD 1\nOUT ACC\n"}),
        MISAKA_DEVICE="cpu", MISAKA_BATCH="2", MISAKA_CHUNK_STEPS="32",
        MISAKA_IN_CAP="16", MISAKA_OUT_CAP="16", MISAKA_STACK_CAP="16",
        MISAKA_PORT=str(port), MISAKA_TTL_S="600", MISAKA_AUTORUN="1", MISAKA_PIDFILE="off",
        # canary traffic would join the byte-exact replay's stream
        MISAKA_CANARY="0", MISAKA_SAMPLER="0",
        MISAKA_TSDB_DIR=str(tsdb_dir), MISAKA_TSDB_INTERVAL_S="0.25",
        MISAKA_USAGE_FLUSH_S="0.5", MISAKA_CAPTURE_SEG_S="9999",  # rotation by POST only
        OMP_NUM_THREADS="1", PYTHONPATH=ROOT,
    )
    launch = [sys.executable, "-m", "misaka_tpu_torch.runtime.app"]
    logs = [open(tmp_path / f"app{i}.log", "w") for i in (1, 2)]
    proc = subprocess.Popen(launch, env=env, cwd=ROOT, stdout=logs[0], stderr=subprocess.STDOUT)
    proc2 = client = None
    vals = np.arange(16, dtype=np.int32)
    try:
        _poll(lambda: _healthy(base), "first boot healthy", 120, 0.25)
        client = MisakaClient(base, timeout=60)
        for _ in range(20):
            assert np.array_equal(client.compute_raw(vals), vals + 1)
        # the traffic's TSDB slots and a usage frame with it reach the disk
        _poll(lambda: _values_on_disk(str(tsdb_dir)), "values slot on disk")
        _poll(lambda: any(fr["programs"].get("default", {}).get("requests", 0) >= 20
                          for fr in _frames(str(tsdb_dir / "usage"), "usage", "usage")),
              "usage frame on disk")
        req = urllib.request.Request(base + "/captures/rotate", data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            rotated = json.loads(r.read())
        assert rotated["records"] == 20, rotated
        segment = rotated["path"]
        totals1 = tusage.totals_from_lines(client.usage_export())
        assert totals1["pass_wall_seconds"] > 0 and totals1["cumulative"]
        client.close()
        client = None
        t_kill = time.time()
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)

        proc2 = subprocess.Popen(launch, env=env, cwd=ROOT, stdout=logs[1],
                                 stderr=subprocess.STDOUT)
        _poll(lambda: _healthy(base), "relaunch healthy", 120, 0.25)
        client = MisakaClient(base, timeout=60)
        for window in ("15m", "7d"):
            got = client.series("misaka_compute_values_total", window=window)
            pts = [pt for row in got["series"] for pt in row["points"]]
            assert any(pt[0] < t_kill and pt[1] > 0 for pt in pts), (window, pts)
        for _ in range(10):
            assert np.array_equal(client.compute_raw(vals), vals + 1)
        def accrued():
            t = tusage.totals_from_lines(client.usage_export())
            return t if t["cumulative"].get("default", {}).get("requests", 0) >= 30 else None

        totals2 = _poll(accrued, "post-restart accrual")
        for prog, row in totals1["cumulative"].items():
            for f, v in row.items():
                assert totals2["cumulative"][prog][f] >= v - 1e-6, (prog, f)
        assert totals2["pass_wall_seconds"] >= totals1["pass_wall_seconds"] - 1e-6
        wall, cpu = totals2["pass_wall_seconds"], totals2["cpu_seconds_total"]
        assert abs(wall - cpu) <= 0.05 * max(wall, cpu), (wall, cpu)
        client.close()
        client = None
        out = subprocess.run([sys.executable, "-m", "misaka_tpu_torch", "replay", segment,
                              "--device", "cpu"], env=env, cwd=ROOT, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "replay green" in out.stdout, out.stdout + out.stderr
    finally:
        if client is not None:
            client.close()
        for p in (proc, proc2):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for f in logs:
            f.close()
