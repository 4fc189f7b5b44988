"""The port's usage ledger (runtime/usage.py) against the JAX one.

The cases of tests/test_usage.py on both packages (the JAX side on its
scan engine, the port's plain engine on the CPU; the native pool's cases
are tests/test_torch_native_trace.py's): per-program cpu_seconds over a multi-tenant run sum to
the pass-wall anchor within 5% (two code paths: the pass sites and the
per-program bills), requests and values counted exactly, queue seconds
observed, the listing's `usage` block (null for an idle program), the
`misaka_usage_*` series, the client helper, a failed pass billed nothing,
the kill switch and the cardinality guard.  The same serialized traffic
books the same requests and values in both ledgers, and /debug/usage has
the JAX body's keys.

The export path: lines signed by one package verify in the other, a
tampered line fails both with the same message, and the synthetic
canary's account is booked, exempt from the collapse, left out of every
export line and kept in the totals, in both packages alike.
"""

import copy
import json
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import misaka_tpu.client as jclient
import misaka_tpu_torch.client as tclient
from misaka_tpu import networks as jnetworks
from misaka_tpu.runtime import master as jmaster
from misaka_tpu.runtime import registry as jregistry
from misaka_tpu.runtime import usage as jusage
from misaka_tpu.utils import metrics as jmetrics
from misaka_tpu_torch import networks as tnetworks
from misaka_tpu_torch.runtime import master as tmaster
from misaka_tpu_torch.runtime import registry as tregistry
from misaka_tpu_torch.runtime import usage as tusage
from misaka_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)

CAPS = dict(in_cap=16, out_cap=16, stack_cap=16)
DELTAS = {"dense": 2, "compact": 3, "chained": 4}
PKGS = {
    "jax": types.SimpleNamespace(usage=jusage, master=jmaster, reg=jregistry,
                                 networks=jnetworks, client=jclient, metrics=jmetrics,
                                 kw={"engine": "scan"}),
    "torch": types.SimpleNamespace(usage=tusage, master=tmaster, reg=tregistry,
                                   networks=tnetworks, client=tclient, metrics=tmetrics,
                                   kw={"engine": "scan", "device": "cpu"}),
}


@pytest.fixture(scope="module", autouse=True)
def _quiet_jax_daemons():
    with pytest.MonkeyPatch.context() as mp:
        for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG", "MISAKA_CANARY"):
            mp.setenv(switch, "0")
        yield


@pytest.fixture(scope="module")
def servers():
    """One registry server per package: `dense` (add2, the seeded default),
    `compact` (acc_loop, +3), `chained` (+4) and `idle` (never served)."""
    out = {}
    for name, p in PKGS.items():
        p.usage.configure({})
        reg = p.reg.ProgramRegistry(None, batch=4, chunk_steps=16, caps=CAPS, **p.kw)
        top = p.networks.add2(**CAPS)
        m = p.master.MasterNode(top, chunk_steps=16, batch=4, **p.kw)
        reg.seed("dense", m, top)
        acc = p.networks.acc_loop(**CAPS)
        reg.publish("compact", topology_json=json.dumps(
            {"nodes": acc.node_info, "programs": acc.programs, **CAPS}))
        reg.publish("chained", tis="IN ACC\nADD 4\nOUT ACC\n")
        reg.publish("idle", tis="IN ACC\nADD 9\nOUT ACC\n")
        httpd = p.master.make_http_server(m, port=0, registry=reg)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        m.run()
        out[name] = (f"http://127.0.0.1:{httpd.server_address[1]}", m, reg)
        out[name + "_httpd"] = httpd
    yield out
    for name in PKGS:
        base, m, reg = out[name]
        out[name + "_httpd"].shutdown()
        m.pause()
        reg.close()
        m.close()


def _req(base, path, raw=None, headers=None):
    req = urllib.request.Request(base + path, data=raw, headers=headers or {},
                                 method="POST" if raw is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def _usage(base):
    return json.loads(_req(base, "/debug/usage")[1])


def _drive(base, programs, rounds, values=8, threads=2):
    errors = []

    def worker(name):
        vals = np.arange(values, dtype="<i4")
        try:
            for _ in range(rounds):
                st, out, _ = _req(base, f"/programs/{name}/compute_raw?spread=1", vals.tobytes())
                assert st == 200, out[:200]
                assert (np.frombuffer(out, "<i4") == vals + DELTAS[name]).all()
        except Exception as e:  # surfaced below
            errors.append(e)

    ts = [threading.Thread(target=worker, args=(n,)) for n in programs for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors, errors[0]


def _delta(before, after):
    return {name: {k: a[k] - before["programs"].get(name, {}).get(k, 0) for k in tusage.FIELDS}
            for name, a in after["programs"].items()}


@pytest.mark.parametrize("pkg", list(PKGS))
def test_multi_tenant_cpu_conservation(servers, pkg):
    base = servers[pkg][0]
    before = _usage(base)
    _drive(base, ("dense", "compact", "chained"), rounds=3)
    after = _usage(base)
    d = _delta(before, after)
    for name in ("dense", "compact", "chained"):
        assert (d[name]["requests"], d[name]["values"]) == (6, 6 * 8), (name, d[name])
        assert d[name]["cpu_seconds"] > 0 and d[name]["queue_seconds"] >= 0
    cpu_sum = sum(row["cpu_seconds"] for row in d.values())
    pass_total = after["pass_seconds_total"] - before["pass_seconds_total"]
    assert pass_total > 0
    assert abs(cpu_sum - pass_total) <= 0.05 * pass_total, (cpu_sum, pass_total)


def test_serialized_traffic_books_equal_counts(servers):
    """Every lane (/compute, /compute_batch unspread and spread,
    /compute_raw striped and pinned) through both servers, in one order."""
    rng = np.random.default_rng(11)
    plan = [(str(rng.choice(["dense", "compact"])), int(rng.integers(0, 5)),
             int(rng.integers(1, 12))) for _ in range(10)]
    deltas = []
    for pkg in PKGS:
        base = servers[pkg][0]
        before = _usage(base)
        for prog, lane, n in plan:
            vals = np.arange(n, dtype="<i4")
            if lane == 0:
                st = _req(base, f"/programs/{prog}/compute", b"value=3")[0]
            elif lane in (1, 2):
                body = ("values=" + ",".join(map(str, vals)) + ("&spread=1" if lane == 2 else ""))
                st = _req(base, f"/programs/{prog}/compute_batch", body.encode())[0]
            else:
                q = "?spread=1" if lane == 3 else "?spread=0"
                st = _req(base, f"/programs/{prog}/compute_raw{q}", vals.tobytes())[0]
            assert st == 200
        after = _usage(base)
        deltas.append({k: {f: v[f] for f in ("requests", "values", "native_seconds")}
                       for k, v in _delta(before, after).items() if v["requests"]})
        keys = set(after)
        if "native_pool" in keys:
            # either body carries `native_pool` while a native pool of its
            # package is live in the process (an earlier test file on the
            # same worker may leave one)
            assert isinstance(after["native_pool"], dict)
            keys.discard("native_pool")
        assert keys == {"enabled", "programs", "pass_seconds_total", "cpu_seconds_total"}
    assert deltas[0] == deltas[1]
    assert sum(r["requests"] for r in deltas[1].values()) == len(plan)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_listing_carries_usage_and_series(servers, pkg):
    base = servers[pkg][0]
    _drive(base, ("dense",), rounds=2, threads=1)
    listing = json.loads(_req(base, "/programs")[1])["programs"]
    assert listing["dense"]["usage"]["requests"] > 0
    assert listing["dense"]["usage"]["cpu_seconds"] > 0
    assert listing["idle"]["usage"] is None  # a listing mints no account
    parsed = PKGS[pkg].metrics.parse_text(_req(base, "/metrics")[1].decode())
    assert any(k.startswith("misaka_usage_cpu_seconds_total") and 'program="dense"' in k
               for k in parsed)
    assert "misaka_serve_pass_wall_seconds_total" in parsed


def test_client_usage_helper(servers):
    base = servers["torch"][0]
    c = tclient.MisakaClient(base, program="chained")
    try:
        assert c.compute_raw(np.arange(8, dtype=np.int32)).tolist() == list(range(4, 12))
        u = c.usage()
        assert u["enabled"] is True and u["programs"]["chained"]["requests"] > 0
    finally:
        c.close()


def test_failed_pass_not_billed():
    m = tmaster.MasterNode(tnetworks.add2(**CAPS), chunk_steps=16, batch=2, device="cpu")
    m.program_label = "failing-pass"
    m.run()
    try:
        assert m.compute_coalesced([1], timeout=30) == [3]
        m.pause()  # parked: the next pass times out
        cpu0 = tusage.program_snapshot("failing-pass")["cpu_seconds"]
        pass0 = tusage.pass_seconds_total()
        with pytest.raises(tmaster.ComputeTimeout):
            m.compute_coalesced([1, 2], timeout=0.6)
        threading.Event().wait(0.5)  # the pass worker meets its own deadline
        assert tusage.program_snapshot("failing-pass")["cpu_seconds"] - cpu0 < 0.3
        assert tusage.pass_seconds_total() - pass0 < 0.3
    finally:
        m.close()


def test_kill_switch_and_cardinality_guard_equal_jax(monkeypatch):
    outs = []
    for p in PKGS.values():
        monkeypatch.setenv("MISAKA_USAGE", "0")
        p.usage.configure()
        p.usage.add_request("killswitch-prog", 10)
        p.usage.add_cpu("killswitch-prog", 1.0)
        killed = p.usage.program_snapshot("killswitch-prog")
        monkeypatch.delenv("MISAKA_USAGE")
        p.usage.configure()
        monkeypatch.setenv("MISAKA_USAGE_LABEL_MAX", "4")
        saved = dict(p.usage._accounts)
        p.usage.reset()
        try:
            for i in range(10):
                p.usage.add_request(f"guard-flood-{i}", 1)
            p.usage.add_request("_canary", 1)  # exempt from the collapse
            outs.append((killed, sorted(p.usage.snapshot()),
                         p.usage.program_snapshot("other")["requests"]))
        finally:
            p.usage.reset()
            p.usage._accounts.update(saved)
        monkeypatch.delenv("MISAKA_USAGE_LABEL_MAX")
    assert outs[0] == outs[1]
    assert outs[1][0] is None and "_canary" in outs[1][1] and outs[1][2] == 6


# --- exports ---------------------------------------------------------------------------


def _export(base):
    st, body, ctype = _req(base, "/usage/export?since=0")
    assert st == 200 and ctype == "application/x-ndjson"
    return [json.loads(ln) for ln in body.decode().splitlines()]


def test_signed_lines_cross_between_packages(servers, monkeypatch):
    monkeypatch.setenv("MISAKA_USAGE_SECRET", "billing-key")
    secret = b"billing-key"
    exports = {}
    for pkg in PKGS:
        base = servers[pkg][0]
        _drive(base, ("compact",), rounds=1, threads=1)
        exports[pkg] = _export(base)
        assert _req(base, "/usage/export?since=x")[:2] == (400, b"bad since= (unix seconds)")
    for lines in exports.values():
        kinds = [ln["kind"] for ln in lines]
        assert kinds[-1] == "totals" and set(kinds[:-1]) == {"period"}
        for mod in (jusage, tusage):  # each package verifies both exports
            totals = mod.totals_from_lines(lines, secret=secret)
            assert totals["verified"] and totals["programs"]["compact"]["requests"] > 0
    # the same lines, the same aggregate, in either package
    assert (jusage.totals_from_lines(exports["torch"], secret)
            == tusage.totals_from_lines(exports["torch"], secret))
    # one flipped field: both refuse, naming the same line
    bad = copy.deepcopy(exports["torch"])
    bad[0]["requests"] += 1
    errs = []
    for mod in (jusage, tusage):
        with pytest.raises(mod.UsageExportError) as ei:
            mod.totals_from_lines(bad, secret=secret)
        errs.append(str(ei.value))
    assert errs[0] == errs[1] and errs[1].startswith("line 0 (period) failed HMAC")
    # the client's verify_secret runs the same check
    c = tclient.MisakaClient(servers["torch"][0])
    try:
        assert c.usage_export(verify_secret="billing-key")[-1]["kind"] == "totals"
        with pytest.raises(tclient.MisakaClientError):
            c.usage_export(verify_secret="other-key")
    finally:
        c.close()


def test_canary_exempt_from_exports_kept_in_totals(monkeypatch):
    monkeypatch.delenv("MISAKA_USAGE_SECRET", raising=False)
    outs = []
    for p in PKGS.values():
        saved = dict(p.usage._accounts)
        p.usage.reset()
        try:
            p.usage.add_request("_canary", 3)
            p.usage.add_cpu("_canary", 0.25)
            p.usage.add_request("tenant-x", 5)
            p.usage.add_cpu("tenant-x", 0.5)
            lines = p.usage.export_lines()
            outs.append(([(ln["kind"], ln.get("program"), ln.get("requests"))
                          for ln in lines],
                         sorted(lines[-1]["programs"]), lines[-1]["cpu_seconds_total"]))
        finally:
            p.usage.reset()
            p.usage._accounts.update(saved)
    assert outs[0] == outs[1]
    assert outs[1] == ([("period", "tenant-x", 1.0), ("totals", None, None)], ["tenant-x"], 0.75)
