"""The port's observability hooks answer as the JAX server's.

add2 is served by a JAX `MasterNode(engine="scan")` server and by the
port's `MasterNode(device="cpu")` server, batched (B=8) and unbatched, and
both get the same request sequence.  Then:

- the port's series have the JAX package's names, types, help, labels and
  buckets (the ported scope: every series the port registers);
- the deterministic counters move by the same deltas (compute requests and
  values, HTTP requests by route and method, errors by route and code);
  both registries are process-wide, so only deltas are compared;
- /healthz has the same keys, Server-Timing the same phase names per
  route, X-Misaka-Trace is echoed on every response (errors included);
- /debug/requests (the per-ID lookup and ?slowest=1) and /debug/perfetto
  have the same shapes, tiers and tier pids;
- the profile routes answer the same status codes, and the port's capture
  holds the device-loop thread's ops;
- JSON log lines have the same keys and carry the trace ID;
- tracing on costs little against tracing off (the reference's overhead
  guard, tests/test_request_trace.py).
"""

import io
import json
import logging
import os
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from misaka_tpu import networks as jnet
from misaka_tpu.core import jit as _jjit  # noqa: F401 (its series)
from misaka_tpu.core import native_serve as _jnative  # noqa: F401 (its series)
from misaka_tpu.core import specialize as _jspecialize  # noqa: F401 (its series)
from misaka_tpu.runtime import frontends as _jfrontends  # noqa: F401 (its series)
from misaka_tpu.runtime import canary as _jcanary  # noqa: F401 (its series)
from misaka_tpu.runtime import capture as jcapture
from misaka_tpu.runtime import fleet as _jfleet  # noqa: F401 (its series)
from misaka_tpu.runtime import usage as jusage
from misaka_tpu.runtime.master import MasterNode as JMaster
from misaka_tpu.runtime.master import make_http_server as j_http
from misaka_tpu.utils import metrics as jmetrics
from misaka_tpu.utils import slo as jslo
from misaka_tpu.utils import tracespan as jtracespan
from misaka_tpu.utils import watchdog as jwatchdog
from misaka_tpu.utils.jsonlog import JsonFormatter as JJsonFormatter
from misaka_tpu_torch import networks as tnet
from misaka_tpu_torch.core import jit as _tjit  # noqa: F401 (its series)
from misaka_tpu_torch.core import native_serve as _tnative  # noqa: F401 (its series)
from misaka_tpu_torch.core import specialize as _tspecialize  # noqa: F401 (its series)
from misaka_tpu_torch.runtime import frontends as _tfrontends  # noqa: F401 (its series)
from misaka_tpu_torch.runtime import capture as tcapture
from misaka_tpu_torch.runtime import fleet as _tfleet  # noqa: F401 (its series)
from misaka_tpu_torch.runtime import usage as tusage
from misaka_tpu_torch.runtime.master import MasterNode as TMaster
from misaka_tpu_torch.runtime.master import make_http_server as t_http
from misaka_tpu_torch.utils import metrics as tmetrics
from misaka_tpu_torch.utils import profiling
from misaka_tpu_torch.utils import slo as tslo
from misaka_tpu_torch.utils import tracespan as ttracespan
from misaka_tpu_torch.utils import watchdog as twatchdog
from misaka_tpu_torch.utils.jsonlog import JsonFormatter as TJsonFormatter

torch.set_num_threads(1)

CAPS = dict(in_cap=8, out_cap=8, stack_cap=8)
TRACE_ID = "feedc0de12345678"
# /healthz blocks of planes the port has not taken (absent, not faked)
UNPORTED_BLOCKS = {"frontends", "canary", "degraded"}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # the JAX server's process-global daemons would outlive a test
    for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG"):
        monkeypatch.setenv(switch, "0")
    # both SLO engines and both watchdogs disarmed, whatever an earlier
    # test in this process armed: a /healthz `slo` or `watchdog` block
    # then means the same in both
    jslo.configure()
    tslo.configure()
    jwatchdog.shutdown()
    twatchdog.shutdown()


def _serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


class Pair:
    """A JAX and a port server of add2 side by side."""

    def __init__(self, batch, profile_dir=None):
        self.jm = JMaster(jnet.add2(**CAPS), chunk_steps=8, batch=batch, engine="scan")
        self.tm = TMaster(tnet.add2(**CAPS), chunk_steps=8, batch=batch, engine="scan",
                          device="cpu")
        pj = pt = None
        if profile_dir is not None:
            pj, pt = os.path.join(profile_dir, "jax"), os.path.join(profile_dir, "port")
        self.jh = j_http(self.jm, port=0, profile_dir=pj)
        self.th = t_http(self.tm, port=0, profile_dir=pt)
        self.jb, self.tb = _serve(self.jh), _serve(self.th)

    def close(self):
        for h, m in ((self.jh, self.jm), (self.th, self.tm)):
            h.shutdown()
            h.server_close()
            m.close()


def request(base, path, data=b"", headers=None, method="POST"):
    req = urllib.request.Request(base + path, data=data if method == "POST" else None,
                                 headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def form(**fields):
    return urllib.parse.urlencode(fields).encode()


def trace_doc(base, trace_id):
    """GET /debug/requests/<id>.  A trace is recorded after its response
    is sent, so a lookup right after the response may 404: retry (bounded)."""
    deadline = time.monotonic() + 30
    while True:
        code, _, body = request(base, f"/debug/requests/{trace_id}", method="GET")
        if code == 200 or time.monotonic() > deadline:
            assert code == 200, body
            return json.loads(body)
        time.sleep(0.05)


def session():
    """(path, body, headers, method) of the shared request sequence."""
    raw = np.arange(-10, 10, dtype="<i4").tobytes()
    traced = {"X-Misaka-Trace": TRACE_ID}
    return [
        ("/compute", form(value="1"), None, "POST"),        # not running: 400
        ("/run", b"", None, "POST"),
        *[("/compute", form(value=str(v)), None, "POST") for v in (5, -3, 0)],
        ("/compute", form(value="9"), traced, "POST"),
        ("/compute_raw", raw, None, "POST"),
        ("/compute_raw?spread=0", raw, None, "POST"),
        ("/compute_batch", form(values="1,2,3"), None, "POST"),
        ("/compute_batch", form(values="4,5,6,7", spread="1"), None, "POST"),
        ("/compute", form(value="abc"), None, "POST"),      # 400
        ("/nosuch", b"", None, "POST"),                     # 404
        ("/compute", None, None, "GET"),                    # 405
        ("/status", None, None, "GET"),
        ("/healthz", None, None, "GET"),
        ("/debug/requests", None, None, "GET"),
    ]


DETERMINISTIC = ("misaka_compute_requests_total", "misaka_compute_values_total",
                 "misaka_http_requests_total", "misaka_http_errors_total")


def scrape(base, mod):
    return mod.parse_text(request(base, "/metrics", method="GET")[2].decode())


def deterministic(d: dict, mod) -> dict:
    return {k: v for k, v in d.items() if mod.parse_series(k)[0] in DETERMINISTIC}


@pytest.mark.parametrize("batch", [8, None], ids=["batched", "unbatched"])
def test_same_session_same_series_counters_and_headers(batch):
    p = Pair(batch)
    try:
        jb0, tb0 = scrape(p.jb, jmetrics), scrape(p.tb, tmetrics)
        for path, body, headers, method in session():
            want = request(p.jb, path, body, headers, method)
            got = request(p.tb, path, body, headers, method)
            assert got[0] == want[0], (path, got, want)
            # the trace ID rides every response, the error paths' too
            assert ttracespan.TRACE_HEADER in got[1] and jtracespan.TRACE_HEADER in want[1]
            if headers:
                assert got[1][ttracespan.TRACE_HEADER] == TRACE_ID
            phases = [set(ttracespan.parse_server_timing(r[1].get("Server-Timing", "")))
                      for r in (got, want)]
            assert phases[0] == phases[1], (path, phases)
            if path.startswith("/compute") and got[0] == 200:
                assert {"queue", "pass", "total"} <= phases[0], path
                assert got[2] == want[2], path
            if path == "/healthz":
                assert set(json.loads(got[2])) == set(json.loads(want[2])) - UNPORTED_BLOCKS
                assert json.loads(got[2])["edge"] == json.loads(want[2])["edge"]
                assert json.loads(got[2])["wire_binary"] is True
        # a request's counters move after its response is sent: scrape
        # again (bounded) until the last ones have landed on both
        deadline = time.monotonic() + 30
        while True:
            jd = deterministic(jmetrics.delta(jb0, scrape(p.jb, jmetrics)), jmetrics)
            td = deterministic(tmetrics.delta(tb0, scrape(p.tb, tmetrics)), tmetrics)
            if td == jd or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        assert td == jd and td
        # the device loop's series moved on the port
        after = scrape(p.tb, tmetrics)
        assert after['misaka_device_loop_iterations_total{kind="serve"}'] > 0
        assert after["misaka_device_loop_chunk_seconds_count"] > 0
        assert after["misaka_device_loop_ticks_total"] > 0
        st = json.loads(request(p.tb, "/status", method="GET")[2])
        assert set(st["build"]) == {"version", "git_sha", "python", "torch", "native"}
        # no kernel built on the CPU; the host interpreter's row appears
        # once a native engine loaded it in this process, the codec's once
        # a server warmed it (every server does, at its start)
        assert not set(st["build"]["native"]) - {"interp", "textcodec"}
    finally:
        p.close()


def test_series_catalog_matches_the_reference(monkeypatch, tmp_path):
    # MISAKA_TSDB_DIR arms the usage and capture spools of both servers
    monkeypatch.setenv("MISAKA_TSDB_DIR", str(tmp_path))
    monkeypatch.setenv("MISAKA_CAPTURE_SEG_S", "3600")
    p = Pair(8)  # a master and a server register every series
    try:
        assert tusage.spool_dir() == str(tmp_path / "usage")
        assert tcapture.spool_status()["dir"] == str(tmp_path / "capture")
        ported = tmetrics.REGISTRY.all_metrics()
        names = {m.name for m in ported}
        for m in ported:
            ref = jmetrics.REGISTRY.get(m.name)
            assert ref is not None, m.name
            assert (m.kind, m.help) == (ref.kind, ref.help), m.name
            if m.name == "misaka_build_info":  # torch where the reference has jax
                assert m.labelnames == tuple(
                    "torch" if n == "jax" else n for n in ref.labelnames)
                continue
            assert m.labelnames == ref.labelnames, m.name
            assert getattr(m, "buckets", None) == getattr(ref, "buckets", None), m.name
        for name in ("misaka_device_loop_iterations_total", "misaka_device_loop_chunk_seconds",
                     "misaka_device_loop_fed_slots", "misaka_submit_queue_depth",
                     "misaka_out_queue_depth", "misaka_stack_autogrow_total",
                     "misaka_stack_autogrow_blocked_total", "misaka_checkpoint_save_seconds",
                     "misaka_checkpoint_restore_seconds", "misaka_checkpoint_age_seconds",
                     "misaka_checkpoint_rejected_total", "misaka_compute_timeouts_total",
                     "misaka_serve_coalesced_values", "misaka_serve_coalesced_requests",
                     "misaka_serve_queue_delay_seconds", "misaka_serve_waiting_requests",
                     "misaka_serve_passes_total", "misaka_serve_lane_entries_total",
                     "misaka_http_inflight", "misaka_http_request_duration_seconds",
                     "misaka_debug_mem_bytes", "misaka_build_info",
                     "misaka_plane_frames_total", "misaka_plane_pipelined_frames_total",
                     "misaka_plane_shm_frames_total", "misaka_plane_pipeline_depth",
                     "misaka_frontend_restarts_total", "misaka_frontend_workers_alive",
                     "misaka_edge_admitted_total", "misaka_edge_rejected_total",
                     "misaka_edge_tokens_total", "misaka_edge_gossip_rounds_total",
                     "misaka_edge_gossip_drained_total", "misaka_usage_requests_total",
                     "misaka_usage_cpu_seconds_total", "misaka_serve_pass_wall_seconds_total",
                     "misaka_slo_state", "misaka_slo_burn_rate", "misaka_slo_p99_seconds",
                     "misaka_capture_records_total", "misaka_capture_ring_bytes",
                     "misaka_replay_runs_total", "misaka_replay_divergences_total"):
            assert name in names, name
        # the durable tier's series (MISAKA_TSDB_DIR arms their spools)
        for name in ("misaka_capture_spool_dropped_total", "misaka_capture_spool_rotations_total",
                     "misaka_capture_spool_bytes", "misaka_usage_spool_dropped_total",
                     "misaka_tsdb_spool_dropped_total", "misaka_tsdb_spool_bytes",
                     "misaka_spool_errors_total"):
            assert name in names, name
        # the fleet's and the plane mTLS series (ROADMAP A.6) are there
        for name in ("misaka_plane_hedged_requests_total", "misaka_plane_tls_rejected_total",
                     "misaka_plane_tls_reloads_total", "misaka_fleet_replicas_configured",
                     "misaka_fleet_replicas_alive", "misaka_fleet_replica_restarts_total",
                     "misaka_fleet_rolls_total", "misaka_fleet_peers_up",
                     "misaka_fleet_gossip_total"):
            assert name in names, name
        # the native host tier's series (core/native_serve.py, jit.py,
        # specialize.py)
        for name in ("misaka_native_serve_seconds", "misaka_native_pool_threads",
                     "misaka_native_resident_total", "misaka_native_units_replicas_total",
                     "misaka_native_tick_rung_total", "misaka_native_jit_total",
                     "misaka_native_specialize_total", "misaka_native_engines_created_total",
                     "misaka_usage_native_seconds_total"):
            assert name in names, name
        # the native edge's series (runtime/frontends.py)
        for name in ("misaka_native_edge_up", "misaka_native_edge_connections_open",
                     "misaka_native_edge_requests_total", "misaka_native_edge_plane_frames_total",
                     "misaka_native_edge_proxied_total", "misaka_native_edge_local_rejects_total"):
            assert name in names, name
        scraped = tmetrics.parse_text(request(p.tb, "/metrics", method="GET")[2].decode())
        for series in ("misaka_usage_spool_dropped_total", "misaka_capture_spool_bytes",
                       "misaka_tsdb_spool_bytes"):
            assert series in scraped, series
    finally:
        p.close()
        for cap, use in ((jcapture, jusage), (tcapture, tusage)):
            cap.shutdown_spool()
            cap.stop()
            use.shutdown_spool()


def test_debug_requests_and_perfetto_match_the_reference():
    assert ttracespan.TIER_PIDS == jtracespan.TIER_PIDS
    p = Pair(8)
    try:
        for base in (p.jb, p.tb):
            request(base, "/run")
            request(base, "/compute", form(value="3"), {"X-Misaka-Trace": TRACE_ID})
        docs = [trace_doc(b, TRACE_ID) for b in (p.tb, p.jb)]
        assert set(docs[0]) == set(docs[1])
        assert docs[0]["trace_id"] == TRACE_ID
        spans = [{s["name"] for s in d["spans"]} for d in docs]
        assert spans[0] == spans[1] >= {"http.parse", "serve.queue", "serve.pass"}
        assert request(p.tb, "/debug/requests/nosuchid", method="GET")[0] == 404
        slow = [json.loads(request(b, "/debug/requests?slowest=1", method="GET")[2])
                for b in (p.tb, p.jb)]
        assert set(slow[0]) == set(slow[1]) and "recent" not in slow[0]
        full = [json.loads(request(b, "/debug/requests", method="GET")[2])
                for b in (p.tb, p.jb)]
        assert set(full[0]) == set(full[1]) and full[0]["enabled"]
        perf = [json.loads(request(b, "/debug/perfetto", method="GET")[2])
                for b in (p.tb, p.jb)]
        assert set(perf[0]) == set(perf[1])

        def tiers(doc):
            return {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
                    if e.get("ph") == "M" and e.get("name") == "process_name"}

        assert tiers(perf[0]) == tiers(perf[1]) == {
            pid: f"tier: {tier}" for tier, pid in ttracespan.TIER_PIDS.items()}
        names = [{(e["pid"], e["name"]) for e in d["traceEvents"] if e.get("ph") == "X"}
                 for d in perf]
        # the request's spans sit in the same tiers, and busy iterations in
        # the engine tier, on both
        assert {n for n in names[1] if n[1] in ("http.parse", "serve.queue", "serve.pass",
                                               "engine.chunk")} <= names[0]
        assert (ttracespan.TIER_PIDS["engine"], "engine.chunk") in names[0]
    finally:
        p.close()


def test_profile_routes_answer_like_the_reference(tmp_path):
    p = Pair(8, profile_dir=str(tmp_path))
    q = Pair(8)  # no profile dir
    try:
        codes = []
        for base, other in ((p.tb, q.tb), (p.jb, q.jb)):
            request(base, "/run")
            # compile the serve path before the capture, so the capture
            # (and the trace it writes) holds one request, not a compile
            assert request(base, "/compute", form(value="0"))[0] == 200
            seq = [request(other, "/profile/start", form(name="x"))[0],
                   request(other, "/profile/stop")[0],
                   request(base, "/profile/start", form(name="../escape"))[0],
                   request(base, "/profile/stop")[0],                  # nothing capturing
                   request(base, "/profile/start", form(name="run1"))[0]]
            seq.append(request(base, "/profile/start", form(name="run2"))[0])  # one at a time
            seq.append(request(base, "/compute", form(value="1"))[0])
            code, _, body = request(base, "/profile/stop")
            seq += [code, request(base, "/profile/stop")[0]]
            assert body.decode().endswith("run1")
            codes.append(seq)
        assert codes[0] == codes[1] == [403, 403, 400, 409, 200, 409, 200, 200, 409]
        assert os.path.isfile(tmp_path / "port" / "run1" / profiling.TRACE_FILE)
    finally:
        p.close()
        q.close()


def _loop_thread_ops(trace_path, tid):
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events if e.get("ph") == "X" and e.get("tid") == tid}


@pytest.mark.parametrize("batch", [8, None], ids=["batched", "unbatched"])
def test_profile_holds_the_device_loop_threads_ops(tmp_path, batch):
    """A capture asked for by an HTTP handler thread records the device
    loop's thread: its iterations and the torch ops of feed, chunk and
    pack (the plain version on the CPU)."""
    m = TMaster(tnet.add2(**CAPS), chunk_steps=8, batch=batch, engine="scan", device="cpu")
    h = t_http(m, port=0, profile_dir=str(tmp_path))
    base = _serve(h)
    try:
        m.run()
        assert request(base, "/profile/start", form(name="loop"))[0] == 200
        for v in range(3):
            assert request(base, "/compute", form(value=str(v)))[2] == b'{"value": %d}\n' % (v + 2)
        loop_tid = m._loop.native_id
        code, _, out = request(base, "/profile/stop")
        assert code == 200
        ops = _loop_thread_ops(os.path.join(out.decode(), profiling.TRACE_FILE), loop_tid)
        assert {"misaka.iteration", "misaka.feed", "misaka.pack", "misaka.read"} <= ops
        assert any(n.startswith("aten::") for n in ops)
        # a capture asked for while paused begins when the loop next starts
        m.pause()
        assert request(base, "/profile/start", form(name="later"))[0] == 200
        m.run()
        assert m.compute(4) == 6
        loop_tid = m._loop.native_id
        code, _, out = request(base, "/profile/stop")
        assert code == 200
        assert "misaka.iteration" in _loop_thread_ops(
            os.path.join(out.decode(), profiling.TRACE_FILE), loop_tid)
    finally:
        h.shutdown()
        h.server_close()
        m.close()


def test_profile_capture_context_records_the_caller(tmp_path):
    with profiling.capture(str(tmp_path), cuda=False) as s:
        (torch.arange(8) + 1).sum()
    assert s.thread_id == threading.get_native_id()
    ops = _loop_thread_ops(tmp_path / profiling.TRACE_FILE, s.thread_id)
    assert "aten::add" in ops and "aten::sum" in ops
    # off a capture, a mark is a no-op context
    with profiling.mark("misaka.iteration") as ctx:
        assert ctx is None


def test_json_log_lines_match_and_carry_the_trace_id(monkeypatch):
    monkeypatch.setenv("MISAKA_SLOW_REQ_MS", "0")  # every request logs as slow
    p = Pair(8)
    streams = {}
    handlers = []
    try:
        for name, fmt in (("misaka_tpu.master", JJsonFormatter()),
                          ("misaka_tpu_torch.master", TJsonFormatter())):
            streams[name] = io.StringIO()
            hd = logging.StreamHandler(streams[name])
            hd.setFormatter(fmt)
            hd.setLevel(logging.WARNING)
            logging.getLogger(name).addHandler(hd)
            handlers.append((name, hd))
        for base in (p.jb, p.tb):
            request(base, "/run")
            assert request(base, "/compute", form(value="5"),
                           {"X-Misaka-Trace": TRACE_ID})[0] == 200
        # the slow-request line is logged after the response is sent: wait
        # for it (bounded)
        lines = {}
        deadline = time.monotonic() + 30
        while len(lines) < len(streams):
            assert time.monotonic() < deadline, {n: s.getvalue() for n, s in streams.items()}
            for name, s in streams.items():
                objs = [json.loads(x) for x in s.getvalue().splitlines()]
                hits = [o for o in objs if o.get("trace_id") == TRACE_ID]
                assert len(hits) <= 1, hits
                if hits:
                    lines[name] = hits[0]
            time.sleep(0.05)
        j, t = lines["misaka_tpu.master"], lines["misaka_tpu_torch.master"]
        assert set(t) == set(j) >= {"time", "level", "logger", "msg", "route", "trace_id"}
        assert (t["level"], t["route"]) == (j["level"], j["route"]) == ("WARNING", "/compute")
    finally:
        for name, hd in handlers:
            logging.getLogger(name).removeHandler(hd)
        p.close()
    # any line emitted while a trace is current carries its ID
    rec = logging.LogRecord("misaka_tpu_torch.master", logging.INFO, __file__, 1, "x", (), None)
    tr = ttracespan.begin(TRACE_ID, route="/compute")
    try:
        assert json.loads(TJsonFormatter().format(rec))["trace_id"] == TRACE_ID
    finally:
        ttracespan.end(tr, status=200)
    assert "trace_id" not in json.loads(TJsonFormatter().format(rec))


def test_overhead_guard_tracing_on_vs_off():
    """Tracing must be cheap enough to leave on: the whole per-request
    begin/span/end path against the kill switch, with the reference's
    generous bound (a tripwire for an accidental O(expensive) hot path)."""
    m = TMaster(tnet.add2(**CAPS), chunk_steps=8, batch=4, device="cpu")
    m.run()
    vals = np.arange(16, dtype=np.int32)

    def lap(n=30):
        t0 = time.perf_counter()
        for _ in range(n):
            tr = ttracespan.begin(route="/compute_raw")
            try:
                with ttracespan.use(tr):
                    m.compute_coalesced(vals, return_array=True)
            finally:
                ttracespan.end(tr, status=200)
        return time.perf_counter() - t0

    try:
        lap(5)  # warm both paths
        ttracespan.configure({"MISAKA_TRACE_REQUESTS": "0"})
        off = lap()
        ttracespan.configure({})
        on = lap()
        assert on <= off * 2.0 + 0.5, (on, off)
    finally:
        ttracespan.configure({})
        m.close()
