"""The port's observatory end to end against the JAX server's.

The cases of tests/test_observatory.py but its fleet drill (ROADMAP A.6),
each on a port server and a JAX server of add2 built side by side:

- the default boot: GET /debug/series (the catalog and a query),
  /debug/dashboard and /debug/flamegraph answer, with the same bodies
  apart from timestamps and measured values (the same keys, stages,
  labels, kinds, panels; byte-equal 400s), and /healthz and
  /debug/alerts carry the same live `watchdog` block;
- the series route's shapes and its 400s, the port client's `series`;
- the dashboard's baked data with its panels filled;
- the watchdog fired through the server: POST /debug/faults arms a
  serve delay, the p99 rule pages, /healthz turns `degraded`, the
  finding's exemplars resolve at /debug/requests/<id>; clearing the
  fault clears the rule, on both servers alike;
- history across the checkpoint path: `save_checkpoint` writes
  `__tsdb__` (not with include_history=False, as the JAX master), and a
  checkpoint of either package restored in the other merges its series.

The rule's threshold sits on a bound of the latency buckets (1.0 s), so
an unfaulted request on the port's CPU engine (about 0.1-0.3 s) never
reads past it, and the 1.5 s delay always does.  Every wait is a bounded
poll on the collector's samples or on the served state.
"""

import http.client
import json
import re
import threading
import time
import types

import numpy as np
import pytest
import torch

from misaka_tpu import networks as jnetworks
from misaka_tpu.runtime import master as jmaster
from misaka_tpu.utils import faults as jfaults
from misaka_tpu.utils import sampler as jsampler
from misaka_tpu.utils import slo as jslo
from misaka_tpu.utils import tsdb as jtsdb
from misaka_tpu.utils import watchdog as jwatchdog
from misaka_tpu_torch import networks as tnetworks
from misaka_tpu_torch.client import MisakaClient, MisakaClientError
from misaka_tpu_torch.runtime import master as tmaster
from misaka_tpu_torch.utils import faults as tfaults
from misaka_tpu_torch.utils import sampler as tsampler
from misaka_tpu_torch.utils import slo as tslo
from misaka_tpu_torch.utils import tsdb as ttsdb
from misaka_tpu_torch.utils import watchdog as twatchdog

torch.set_num_threads(1)

CAPS = dict(in_cap=16, out_cap=16, stack_cap=16)
PKGS = {
    "jax": types.SimpleNamespace(master=jmaster, networks=jnetworks, faults=jfaults, slo=jslo,
                                 tsdb=jtsdb, watchdog=jwatchdog, sampler=jsampler,
                                 kw={"engine": "scan"}),
    "torch": types.SimpleNamespace(master=tmaster, networks=tnetworks, faults=tfaults,
                                   slo=tslo, tsdb=ttsdb, watchdog=twatchdog, sampler=tsampler,
                                   kw={"device": "cpu"}),
}
HOT_RULE = ("p99hot=misaka_http_request_duration_seconds:p99{route=/compute_raw}"
            ">1.0 for 0.3s ->page")


def _shutdown_planes():
    for p in PKGS.values():
        p.watchdog.shutdown()
        p.tsdb.shutdown()
        p.sampler.shutdown()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("MISAKA_SAMPLER", "0")
    monkeypatch.delenv("MISAKA_SLO", raising=False)
    _shutdown_planes()
    for p in PKGS.values():
        p.slo.configure()
    yield
    for p in PKGS.values():
        p.faults.configure(None)
        p.slo.configure()
    _shutdown_planes()


def _fast_tsdb(monkeypatch, watchdog_spec=None, recent="0.5"):
    """Test-scale knobs, set before the servers start the collectors."""
    monkeypatch.setenv("MISAKA_TSDB_INTERVAL_S", "0.1")
    monkeypatch.setenv("MISAKA_TSDB_BUDGET", "0.5")
    # the process registry holds every series of the suite by now
    monkeypatch.setenv("MISAKA_TSDB_MAX_SERIES", "8192")
    monkeypatch.setenv("MISAKA_WATCHDOG_RECENT_S", recent)
    if watchdog_spec is not None:
        monkeypatch.setenv("MISAKA_WATCHDOG", watchdog_spec)
    else:
        monkeypatch.delenv("MISAKA_WATCHDOG", raising=False)


class Server:
    def __init__(self, p, batch=8):
        self.p = p
        self.master = p.master.MasterNode(p.networks.add2(**CAPS), chunk_steps=16, batch=batch,
                                          **p.kw)
        self.httpd = p.master.make_http_server(self.master, port=0)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.port = self.httpd.server_address[1]
        self.base = f"http://127.0.0.1:{self.port}"
        self.master.run()

    def request(self, method, path, body=None, ctype="application/x-www-form-urlencoded"):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        conn.request(method, path, body, {"Content-Type": ctype} if body is not None else {})
        r = conn.getresponse()
        out = r.read()
        conn.close()
        return r.status, out

    def get(self, path):
        return self.request("GET", path)

    def getj(self, path):
        st, body = self.get(path)
        assert st == 200, (path, body)
        return json.loads(body)

    def traffic(self, n=10):
        vals = np.arange(8, dtype=np.int32)
        for _ in range(n):
            st, out = self.request("POST", "/compute_raw?spread=1", vals.tobytes(),
                                   "application/octet-stream")
            assert st == 200, out
            assert (np.frombuffer(out, "<i4") == vals + 2).all()

    def wait_samples(self, n, deadline_s=30):
        db = self.p.tsdb.get()
        assert db is not None
        start = db._samples
        deadline = time.monotonic() + deadline_s
        while db._samples < start + n:
            assert time.monotonic() < deadline, "collector too slow"
            time.sleep(0.05)

    def close(self):
        self.master.pause()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.master.close()


@pytest.fixture
def servers():
    made = []

    def make():
        out = {name: Server(p) for name, p in PKGS.items()}
        made.extend(out.values())
        return out

    yield make
    for s in made:
        s.close()


def _warm(srv):
    for s in srv.values():
        s.traffic(10)
    for s in srv.values():
        s.wait_samples(3)
    for s in srv.values():
        s.traffic(10)
    for s in srv.values():
        s.wait_samples(2)


def _shape(query):
    return {"name": query["name"], "window_s": query["window_s"],
            "series": [(r["labels"], r["kind"], r["stage_s"], bool(r["points"]))
                       for r in query["series"]]}


def _rules(payload):
    return [{k: r.get(k) for k in ("rule", "spec", "series", "state", "severity", "labels",
                                   "threshold")} for r in payload["rules"]]


INDEX_KEYS = ("enabled", "running", "interval_s", "budget", "stages", "max_series",
              "dropped_series", "bytes_per_series")


def test_default_boot_routes_answer_like_jax(monkeypatch, servers):
    _fast_tsdb(monkeypatch)
    monkeypatch.delenv("MISAKA_SAMPLER")
    srv = servers()
    _warm(srv)
    got = {}
    for name, s in srv.items():
        idx = s.getj("/debug/series")
        q = s.getj("/debug/series?name=misaka_compute_values_total&window=5m")
        bad = [s.get(p) for p in ("/debug/series?name=x&window=bogus",
                                  "/debug/series?name=x&label=notkv",
                                  "/debug/dashboard?window=junk")]
        st, page = s.get("/debug/dashboard?window=5m")
        data = json.loads(re.search(r"const DATA = (.*);\n", page.decode()).group(1))
        fst, flame = s.get("/debug/flamegraph")
        health = s.getj("/healthz")
        alerts = s.getj("/debug/alerts")
        got[name] = {
            "index": {k: idx[k] for k in INDEX_KEYS}, "index_keys": set(idx),
            "query": _shape(q), "bad": bad, "dashboard": (st, sorted(data),
                                                          [p["title"] for p in data["panels"]]),
            "page": re.sub(r"const DATA = .*?;\n", "", page.decode(), flags=re.S),
            "flame": (fst, set(json.loads(flame)) - {"native_pool"}),
            "health": (health["watchdog"], health.get("degraded")),
            "alerts_watchdog": {k: v for k, v in alerts["watchdog"].items() if k != "rules"},
            "rules": _rules(alerts["watchdog"]),
        }
    assert got["torch"] == got["jax"]
    t = got["torch"]
    assert t["index"]["running"] and t["query"]["series"][0][3]
    assert [b[0] for b in t["bad"]] == [400, 400, 400]
    assert t["health"] == ("ok", False) and t["alerts_watchdog"]["enabled"] is True
    assert [r["rule"] for r in t["rules"]][0] == "canary-full"


def test_series_route_shapes_and_client(monkeypatch, servers):
    _fast_tsdb(monkeypatch)
    s = servers()["torch"]
    s.traffic(10)
    s.wait_samples(3)
    s.traffic(10)
    s.wait_samples(2)
    idx = s.getj("/debug/series")
    assert idx["running"] and idx["series_count"] > 0 and idx["dropped_series"] == 0
    assert [st["width_s"] for st in idx["stages"]] == [0.1, 60.0, 300.0]
    assert idx["bytes_per_series"] == 28 * (720 + 360 + 288)
    q = s.getj("/debug/series?name=misaka_compute_values_total&window=5m")
    [row] = q["series"]
    assert q["window_s"] == 300.0 and row["kind"] == "rate" and row["points"]
    t, avg, mx = row["points"][-1]
    assert t > 0 and avg >= 0 and mx >= avg
    q = s.getj("/debug/series?name=misaka_http_request_duration_seconds:p99&window=5m"
               "&label=route=/compute_raw")
    assert q["series"]
    for row in q["series"]:
        assert row["labels"]["route"] == "/compute_raw" and row["kind"] == "quantile"
    c = MisakaClient(s.base)
    try:
        assert c.series()["series_count"] > 0
        q = c.series("misaka_compute_values_total", window="5m")
        assert q["window_s"] == 300.0 and q["series"][0]["points"]
        q = c.series("misaka_http_request_duration_seconds:p99", window="5m",
                     labels={"route": "/compute_raw"})
        assert all(r["labels"]["route"] == "/compute_raw" for r in q["series"])
        with pytest.raises(MisakaClientError):
            c.series("x", window="bogus")
        assert c.canary_status() is None  # no canary in this process
    finally:
        c.close()


def test_dashboard_html_populated(monkeypatch, servers):
    _fast_tsdb(monkeypatch)
    s = servers()["torch"]
    s.traffic(10)
    s.wait_samples(3)
    s.traffic(10)
    s.wait_samples(2)
    st, body = s.get("/debug/dashboard?window=5m")
    page = body.decode()
    assert st == 200 and "misaka observatory" in page
    data = json.loads(re.search(r"const DATA = (.*);\n", page).group(1))
    assert data["window_s"] == 300.0 and "watchdog" in data
    titles = [p["title"] for p in data["panels"]]
    assert "Throughput (values/s)" in titles and "Canary success" in titles
    assert [p for p in data["panels"] if any(row["points"] for row in p["series"])]


def _wait_state(s, want, deadline_s=60):
    deadline = time.monotonic() + deadline_s
    while True:
        wd = s.getj("/debug/alerts")["watchdog"]
        if wd["state"] == want:
            return wd
        assert time.monotonic() < deadline, wd
        time.sleep(0.1)


def test_watchdog_fires_on_injected_fault_and_clears(monkeypatch, servers):
    _fast_tsdb(monkeypatch, watchdog_spec=HOT_RULE, recent="2")
    srv = servers()
    stop = threading.Event()
    errors = []

    def pump(s):
        try:
            while not stop.is_set():
                s.traffic(1)
                time.sleep(0.02)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    pumps = [threading.Thread(target=pump, args=(s,), daemon=True) for s in srv.values()]
    seen = {}
    try:
        for t in pumps:
            t.start()
        for s in srv.values():
            s.wait_samples(3)
        for name, s in srv.items():
            before = s.getj("/debug/alerts")["watchdog"]["state"]
            assert s.request("POST", "/debug/faults", b"spec=serve_delay=1.5")[0] == 200
            wd = _wait_state(s, "page")
            [rule] = [r for r in wd["rules"] if r["state"] == "page"]
            ex = rule["exemplars"][0]
            st, body = s.get(ex["href"])
            resolved = st == 200 and json.loads(body)["trace_id"] == ex["trace_id"]
            health = s.getj("/healthz")
            paged = (rule["rule"], ex["href"] == f"/debug/requests/{ex['trace_id']}", resolved,
                     health["watchdog"], health["degraded"])
            assert s.request("POST", "/debug/faults", b"spec=")[0] == 200
            _wait_state(s, "ok")
            health = s.getj("/healthz")
            seen[name] = (before, paged, health["watchdog"], health.get("degraded"))
        assert not errors, errors[0]
    finally:
        stop.set()
        for t in pumps:
            t.join(timeout=30)
    assert seen["torch"] == seen["jax"] == (
        "ok", ("p99hot", True, True, "page", True), "ok", False)


def _history(p):
    rows = p.tsdb.query("misaka_compute_values_total", window_s=300)
    return [pt for r in rows for pt in r["points"]]


@pytest.mark.parametrize("writer,reader", [("torch", "torch"), ("jax", "torch"),
                                           ("torch", "jax")])
def test_history_rides_checkpoints(monkeypatch, servers, tmp_path, writer, reader):
    import zipfile

    _fast_tsdb(monkeypatch)
    srv = servers()
    s = srv[writer]
    s.traffic(10)
    s.wait_samples(3)
    s.traffic(10)
    s.wait_samples(2)
    before = _history(s.p)
    assert before
    path, bare = str(tmp_path / "obs.npz"), str(tmp_path / "bare.npz")
    s.master.save_checkpoint(path)
    s.master.save_checkpoint(bare, include_history=False)
    members = [set(zipfile.ZipFile(f).namelist()) for f in (path, bare)]
    assert members[0] - members[1] == {"__tsdb__.npy"}
    # the relaunch: the reader's collector starts afresh, then restores
    r = srv[reader]
    r.p.watchdog.shutdown()
    r.p.tsdb.shutdown()
    r.master.load_checkpoint(path)
    after = _history(r.p)
    assert after, "history lost across the restore"
    assert after[0][0] <= before[-1][0]
    assert {pt[0] for pt in before} <= {pt[0] for pt in after}
    r.master.run()
