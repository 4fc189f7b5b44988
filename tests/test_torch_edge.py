"""The port's edge (misaka_tpu_torch/runtime/edge.py) decides as the JAX
package's does, on every surface it guards.

- The chain, case by case from tests/test_edge.py and the token and gossip
  cases of tests/test_dist.py: each case runs the same inputs through both
  packages' edge modules and gives one record per decision (tenant,
  status, reason, message, headers, wire body) plus the delta of the
  misaka_edge_* series it moved.  Records are equal; the one tolerance is
  on Retry-After seconds before rounding (0.05 s: the time between the two
  packages' calls refills the buckets a little), and the headers, rounded
  up to whole seconds, are equal exactly.
- Tokens minted by either package verify in the other under the same
  secret; expired and tampered tokens fail alike.
- Over HTTP, a JAX server and the port's on the CPU get the same request
  streams: typed 401/403/429, the open routes, the /healthz `edge` block,
  key rotation by hot reload, the default env (quota and admission armed)
  and MISAKA_EDGE=0, /edge/token and /edge/gossip; status, body,
  Retry-After and WWW-Authenticate are equal, and so are the edge series.
- Through the compute plane: auth and quota typed per frame, port worker
  over port plane and across the packages both ways, against the JAX
  worker over the JAX plane; the workers' shed counts reach the engine's
  misaka_edge_rejected_total, whichever package sends or books them.
"""

import http.client
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from misaka_tpu import networks as jnet
from misaka_tpu.runtime import edge as jedge
from misaka_tpu.runtime import frontends as jfe
from misaka_tpu.runtime.master import MasterNode as JMaster
from misaka_tpu.runtime.master import make_http_server as j_http
from misaka_tpu.utils import metrics as jmetrics
from misaka_tpu_torch import networks as tnet
from misaka_tpu_torch.runtime import edge as tedge
from misaka_tpu_torch.runtime import frontends as tfe
from misaka_tpu_torch.runtime.master import MasterNode as TMaster
from misaka_tpu_torch.runtime.master import make_http_server as t_http
from misaka_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)

EDGE = {"jax": jedge, "port": tedge}
METRICS = {"jax": jmetrics, "port": tmetrics}
FE = {"jax": jfe, "port": tfe}
CAPS = dict(in_cap=16, out_cap=16, stack_cap=16)
RETRY_TOL = 0.05  # seconds of refill between the two packages' calls
KEYS = [
    {"key": "adm-secret", "tenant": "ops", "admin": True},
    {"key": "bob-secret", "tenant": "bob", "quota": "rps<0.5"},
    {"key": "eve-secret", "tenant": "eve", "disabled": True},
    {"key": "pin-secret", "tenant": "pin", "programs": ["dense"]},
]


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    # the JAX server's process-global daemons would outlive a test
    for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG", "MISAKA_CANARY"):
        monkeypatch.setenv(switch, "0")
    # tenant labels are process-global in both packages: other test files
    # run in the same process must not push one package past the budget
    monkeypatch.setenv("MISAKA_USAGE_LABEL_MAX", "100000")
    for var in ("MISAKA_API_KEYS", "MISAKA_QUOTA", "MISAKA_TOKEN_SECRET", "MISAKA_PLANE_SECRET",
                "MISAKA_EDGE", "MISAKA_ADMISSION_HIGH", "MISAKA_EDGE_INTERNAL_TOKEN"):
        monkeypatch.delenv(var, raising=False)
    yield
    jedge.reset()
    tedge.reset()


def write_keys(path, entries) -> str:
    with open(path, "w") as f:
        json.dump({"keys": entries}, f)
    return str(path)


def edge_series(pkg) -> dict:
    m = METRICS[pkg]
    return {k: v for k, v in m.parse_text(m.render()).items() if k.startswith("misaka_edge_")}


def series_delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


def same(a, b) -> bool:
    """Equal, floats within RETRY_TOL."""
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= RETRY_TOL
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(same, a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    return a == b


def rej(r) -> tuple | None:
    """One rejection's record: everything a client sees."""
    if r is None:
        return None
    wire = json.loads(r.to_wire())
    return (r.status, r.reason, r.message, r.headers(), wire, r.retry_after)


def dec(d) -> tuple:
    return (d.tenant, rej(d.reject))


def raises(fn) -> str:
    try:
        fn()
    except Exception as e:  # the record is the exception's type name and text
        return f"{type(e).__name__}: {e}"
    return "no error"


# --- chain cases: each takes one package's edge module -------------------------


def case_quota_grammar(edge, tmp_path):
    out = [edge.parse_quota_spec(s) for s in ("rps<100,vps<50000,cpu<0.5", "rps=3", None, "")]
    out += [raises(lambda b=b: edge.parse_quota_spec(b))
            for b in ("zps<1", "rps<abc", "rps<0", "rps<-1", "rps")]
    return out


def case_token_bucket(edge, tmp_path):
    b = edge.TokenBucket(10.0, burst_s=2.0)  # capacity 20
    out = [b.capacity, b.take(20), b.take(1)]
    time.sleep(0.15)
    out.append(b.take(1)[0])  # ~1.5 tokens refilled
    b.drain(100)  # gossip debt floors at -capacity
    out.append(b.tokens)
    return out


def case_route_policy(edge, tmp_path):
    routes = ["/healthz", "/metrics", "/compute", "/compute_batch", "/compute_raw", "/run",
              "/pause", "/load", "/checkpoint", "/restore", "/fleet/roll", "/fleet/drain",
              "/edge/token", "/edge/gossip", "/usage/export", "/programs", "/status",
              "/debug/usage", "/debug/requests", "/nosuch"]
    return [(r, m, edge.route_policy(r, m)) for r in routes for m in ("GET", "POST")] + [
        sorted(edge.OPEN_ROUTES), sorted(edge.COMPUTE_ROUTES), sorted(edge.ADMIN_ROUTES),
        sorted(edge.REASONS)]


def case_chain_order(edge, tmp_path):
    kf = edge.KeyFile(write_keys(tmp_path / "k.json", KEYS))
    chain = edge.EdgeChain(keyfile=kf, quota_defaults={"rps": 0.001})
    out = [dec(chain.check("/compute", key="wrong")), dec(chain.check("/compute", key="bob-secret"))]
    out += [dec(chain.check("/compute", key="bob-secret")) for _ in range(3)]
    return out


def case_key_scopes(edge, tmp_path):
    chain = edge.EdgeChain(keyfile=edge.KeyFile(write_keys(tmp_path / "k.json", KEYS)))
    calls = [("/pause", "adm-secret", None), ("/pause", "bob-secret", None),
             ("/compute", "eve-secret", None), ("/compute", "pin-secret", "dense"),
             ("/compute", "pin-secret", "dense@abc123"), ("/compute", "pin-secret", "compact"),
             ("/compute", None, None), ("/status", None, None), ("/healthz", None, None),
             ("/programs", "bob-secret", None), ("/status", "bob-secret", None)]
    out = [dec(chain.check(r, key=k, program=p)) for r, k, p in calls]
    out.append(dec(chain.check("/programs", "GET", key="bob-secret")))
    return out


def case_keyfile_hot_reload_and_malformed(edge, tmp_path):
    path = tmp_path / "k.json"
    write_keys(path, [{"key": "a", "tenant": "t1"}])
    kf = edge.KeyFile(str(path))
    out = [kf.lookup("a")["tenant"], kf.lookup("b"), len(kf)]
    time.sleep(0.6)  # past the 0.5 s stat throttle
    write_keys(path, [{"key": "b", "tenant": "t2"}, {"key": "c", "tenant": "t3"}])
    os.utime(path, (time.time() + 5, time.time() + 5))
    out += [kf.lookup("b")["tenant"], kf.lookup("a"), len(kf)]
    time.sleep(0.6)
    with open(path, "w") as f:
        f.write("{not json")
    os.utime(path, (time.time() + 10, time.time() + 10))
    out += [kf.lookup("b")["tenant"], len(kf)]  # a broken rewrite keeps the table
    out.append(len(edge.KeyFile(str(tmp_path / "missing.json"))))
    bad = tmp_path / "bad.json"
    for body in ('{"keys": [{"key": 1, "tenant": "t"}]}', '{"keys": [{"tenant": "t"}]}',
                 '{"keys": [{"key": "k", "tenant": "t", "quota": "zps<1"}]}'):
        bad.write_text(body)
        out.append(len(edge.KeyFile(str(bad))))
    return out


def case_kill_switches(edge, tmp_path):
    kf = write_keys(tmp_path / "k.json", KEYS)
    base = {"MISAKA_API_KEYS": kf, "MISAKA_QUOTA": "rps<1"}
    sig = lambda: (0, False)  # noqa: E731
    out = []
    for extra in ({}, {"MISAKA_EDGE": "0"}, {"MISAKA_EDGE_AUTH": "0"}, {"MISAKA_EDGE_QUOTA": "0"},
                  {"MISAKA_EDGE_ADMISSION": "0"}, {"MISAKA_ADMISSION_HIGH": "1234"},
                  {"MISAKA_TOKEN_SECRET": "s"}, {"MISAKA_QUOTA_BURST_S": "5"}):
        chain = edge.from_env(signals=sig, environ={**base, **extra})
        out.append((extra, chain.armed, chain.debug_payload(), chain.quota_defaults,
                    chain.burst_s))
    out.append(edge.from_env(environ={}).debug_payload())  # no signals: no governor
    # quota without auth: the program label is the tenant
    chain = edge.from_env(signals=sig, environ={"MISAKA_QUOTA": "rps<1"})
    out += [dec(chain.check("/compute", program="p1")) for _ in range(3)]
    return out


def case_admission_fair_share(edge, tmp_path):
    waiting = [0]
    gov = edge.AdmissionGovernor(lambda: (waiting[0], False), 1000)
    out = [rej(gov.check("flood", 100)) for _ in range(40)]
    out += [rej(gov.check("good", 40)) for _ in range(3)]
    waiting[0] = 1500  # soft zone: the over-share tenant sheds
    out += [rej(gov.check("flood", 100)), rej(gov.check("good", 40))]
    waiting[0] = 2500  # hard cap: everyone sheds
    out += [rej(gov.check("good", 40)), rej(gov.check("flood", 100))]
    return out


def case_admission_single_tenant(edge, tmp_path):
    waiting = [1500]
    gov = edge.AdmissionGovernor(lambda: (waiting[0], False), 1000)
    out = [rej(gov.check("only", 100))]
    waiting[0] = 2500
    out.append(rej(gov.check("only", 100)))
    return out


def case_admission_page_halves(edge, tmp_path):
    page = [False]
    gov = edge.AdmissionGovernor(lambda: (700, page[0]), 1000)
    out = [rej(gov.check("flood", 100)) for _ in range(20)] + [rej(gov.check("good", 10))]
    page[0] = True  # soft 1000 -> 500: the fair-share zone engages
    out += [rej(gov.check("flood", 100)), rej(gov.check("good", 10))]
    return out


def case_admission_through_chain(edge, tmp_path):
    chain = edge.EdgeChain(governor=edge.AdmissionGovernor(lambda: (5000, False), 1000))
    return [dec(chain.check("/compute_raw", program="shed-me", values=64)),
            dec(chain.check("/pause", program="shed-me"))]  # admin routes skip admission


def case_reject_wire_round_trip(edge, tmp_path):
    r = edge.EdgeReject(429, "rate", "slow down", retry_after=2.5, tenant="t")
    back = edge.EdgeReject.from_wire(429, r.to_wire())
    return [r.to_wire(), r.headers(), rej(back), back.tenant,
            edge.EdgeReject.from_wire(429, b"not an edge body"),
            edge.EdgeReject.from_wire(400, b'["reason"]'),
            edge.EdgeReject(401, "unauthenticated", "x").headers(),
            edge.EdgeReject(401, "unauthenticated", "x").to_wire(),
            edge.EdgeReject(429, "overload", "y", retry_after=0.0123).headers()]


def case_cpu_meter_window(edge, tmp_path):
    meter = edge.CpuMeter(window_s=10.0)
    out = [meter.check(0.0, 0.5), meter.check(20.0, 0.5)]
    # the chain's per-program cpu stage, on an injected usage reader
    used = {"hot": 0.0, "cold": 0.0}
    chain = edge.EdgeChain(quota_defaults={"cpu": 0.5}, cpu_reader=used.__getitem__,
                           cpu_window_s=10.0)
    chain.set_program_quota("cold", "rps<100")
    out.append(dec(chain.check("/compute", program="hot")))
    used["hot"] = 20.0  # 20 core-seconds inside the window: over 0.5 x 10
    out += [dec(chain.check("/compute", program="hot")),
            dec(chain.check("/compute", program="cold")),
            dec(chain.check("/compute", program="hot@v2"))]
    return out


def case_program_quota_precedence(edge, tmp_path):
    kf = edge.KeyFile(write_keys(tmp_path / "k.json",
                                 [{"key": "k1", "tenant": "t1", "quota": "rps<7"}]))
    chain = edge.EdgeChain(keyfile=kf, quota_defaults={"rps": 1.0, "vps": 100.0})
    chain.set_program_quota("p", "rps<3,cpu<0.5")
    out = [chain._effective_quota(kf.lookup("k1"), "p@deadbeef"),
           chain._effective_quota(None, "p"), chain._effective_quota(None, "other")]
    chain.set_program_quota("p", None)
    out.append(chain._effective_quota(None, "p"))
    out.append(raises(lambda: chain.set_program_quota("p", "bogus<1")))
    return out


def case_bucket_not_reset_by_alternation(edge, tmp_path):
    kf = edge.KeyFile(write_keys(tmp_path / "k.json", [{"key": "k", "tenant": "alt"}]))
    chain = edge.EdgeChain(keyfile=kf, quota_defaults={"rps": 0.2}, burst_s=10.0)
    chain.set_program_quota("slow", "rps<0.1")
    return [dec(chain.check("/compute", key="k", program="slow" if i % 2 else "fast"))
            for i in range(12)]


def case_oversized_request_413(edge, tmp_path):
    chain = edge.EdgeChain(quota_defaults={"vps": 10.0}, burst_s=2.0)
    return [dec(chain.check("/compute_raw", program="big", values=100)),
            dec(chain.check("/compute_raw", program="big", values=20)),
            dec(chain.check("/compute_raw", program="big", values=15))]


def case_internal_token(edge, tmp_path):
    kf = edge.KeyFile(write_keys(tmp_path / "k.json", KEYS))
    chain = edge.EdgeChain(keyfile=kf, internal_token="boot-secret")
    out = [dec(chain.check(r, key="boot-secret")) for r in ("/fleet/drain", "/checkpoint",
                                                            "/pause", "/compute")]
    out.append(dec(chain.check("/fleet/drain", key="not-the-token")))
    plain = edge.EdgeChain(keyfile=kf)
    out.append(dec(plain.check("/fleet/drain", key="boot-secret")))
    return out


def case_keyfile_strips_cpu(edge, tmp_path):
    kf = edge.KeyFile(write_keys(tmp_path / "k.json",
                                 [{"key": "k", "tenant": "t", "quota": "rps<5,cpu<0.1"}]))
    e = kf.lookup("k")
    return [e["quota_spec"], e["quota"], e["admin"], e["programs"], e["disabled"]]


def case_round4_hardening(edge, tmp_path):
    chain = edge.EdgeChain(
        keyfile=edge.KeyFile(write_keys(tmp_path / "k.json", [{"key": "k", "tenant": "t"}])),
        internal_token="boot-secret")
    out = [dec(chain.check("/compute", key="café"))]
    q = edge.EdgeChain(quota_defaults={"vps": 1000.0}, burst_s=2.0)
    out.append(dec(q.check("/compute_raw", program="fused", values=5000, requests=100)))
    out.append(dec(q.check("/compute_raw", program="fused", values=5000, requests=1)))
    c2 = edge.EdgeChain(quota_defaults={"rps": 1e9})
    out.append(dec(c2.check("/compute_raw", program="counted", values=64, requests=7)))
    # a coalesced frame past the rps burst clamps its charge at capacity
    c3 = edge.EdgeChain(quota_defaults={"rps": 1.0})
    out += [dec(c3.check("/compute_raw", program="clamp", requests=50)) for _ in range(2)]
    return out


def case_count_shed(edge, tmp_path):
    edge.count_shed("shedder", "rate", 3)
    edge.count_shed(None, "overload")
    edge.count_shed("shedder", "made-up-reason", 0)
    return [edge.tenant_metric_label(None), edge.tenant_metric_label("x")]


def case_token_mint_verify(edge, tmp_path):
    secret = b"fleet-token-secret"
    tok, exp = edge.mint_tenant_token(secret, "alice", ttl_s=60.0, now=1000.0)
    out = [tok, exp, edge.verify_tenant_token(secret, tok, now=1001.0),
           edge.verify_tenant_token(secret, tok, now=1060.0)]
    tok2, _ = edge.mint_tenant_token(secret, "alice", ttl_s=60.0, now=1060.0)
    out += [edge.verify_tenant_token(secret, tok2, now=1061.0),
            edge.verify_tenant_token(secret, tok2[:-2] + ("AA" if not tok2.endswith("AA")
                                                          else "BB"), now=1061.0),
            edge.verify_tenant_token(b"other", tok2, now=1061.0),
            edge.verify_tenant_token(secret, "mst1.garbage"),
            edge.verify_tenant_token(secret, "mst1.é.x")]
    tok3, _ = edge.mint_tenant_token(secret, "ops", ttl_s=60.0, admin=True,
                                     programs=["dense", "b"], now=1000.0)
    out += [tok3, edge.verify_tenant_token(secret, tok3, now=1001.0),
            edge.mint_tenant_token(secret, "z", ttl_s=0.0, now=5.0)]
    return out


def case_chain_verifies_tokens(edge, tmp_path):
    secret = b"s3"
    kf = edge.KeyFile(write_keys(tmp_path / "k.json", KEYS[:1]))
    chain = edge.EdgeChain(keyfile=kf, token_secret=secret, quota_enabled=False,
                           admission_enabled=False)
    tok, _ = edge.mint_tenant_token(secret, "alice", ttl_s=60.0)
    adm, _ = edge.mint_tenant_token(secret, "ops", ttl_s=60.0, admin=True)
    out = [dec(chain.check("/status", method="GET", key=tok)),
           dec(chain.check("/fleet/roll", key=adm)), dec(chain.check("/fleet/roll", key=tok))]
    bare = edge.EdgeChain(token_secret=secret, quota_enabled=False, admission_enabled=False)
    old, _ = edge.mint_tenant_token(secret, "alice", ttl_s=1.0, now=time.time() - 10)
    out += [dec(bare.check("/compute", key=old)), dec(bare.check("/compute", key="mst1.bogus.sig")),
            bare.armed]
    return out


def case_token_secret_sources(edge, tmp_path):
    p = tmp_path / "tsecret"
    p.write_text("file-s\n")
    envs = [{}, {"MISAKA_PLANE_SECRET": "plane-s"},
            {"MISAKA_PLANE_SECRET": "plane-s", "MISAKA_TOKEN_SECRET": "token-s"},
            {"MISAKA_TOKEN_SECRET_FILE": str(p)},
            {"MISAKA_TOKEN_SECRET_FILE": str(tmp_path / "none")}]
    return [edge.token_secret(e) for e in envs]


def case_usage_gossip(edge, tmp_path):
    a = edge.EdgeChain(quota_defaults={"rps": 5.0, "vps": 50.0})
    b = edge.EdgeChain(quota_defaults={"rps": 5.0, "vps": 50.0})
    out = [dec(a.check("/compute_raw", program="gossiped", values=8, requests=2))
           for _ in range(3)]
    out += [dec(b.check("/compute", program="gossiped"))]
    snap = a.usage_snapshot()
    out += [snap, b.apply_remote_usage(snap, source="a"), b.apply_remote_usage(snap, source="a")]
    out += [b.apply_remote_usage({"gossiped|rps": 1.0}, source="a"),  # went back: re-anchors
            b.apply_remote_usage({"gossiped|rps": 100.0, "gossiped|cpu": 9, "x": "nan?"},
                                 source="a"),
            raises(lambda: b.apply_remote_usage("nope"))]
    out += [dec(b.check("/compute", program="gossiped"))]
    return out


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_chain_case_matches_jax(name, tmp_path):
    records, deltas = {}, {}
    for pkg in ("jax", "port"):
        before = edge_series(pkg)
        d = tmp_path / pkg
        d.mkdir()
        records[pkg] = CASES[name](EDGE[pkg], d)
        deltas[pkg] = series_delta(before, edge_series(pkg))
    assert same(records["port"], records["jax"]), (records["port"], records["jax"])
    assert deltas["port"] == deltas["jax"]


@pytest.mark.parametrize("minter,verifier", [("jax", "port"), ("port", "jax")])
def test_tokens_cross_between_packages(minter, verifier):
    secret = b"shared-secret"
    tok, exp = EDGE[minter].mint_tenant_token(secret, "carol", ttl_s=30.0, admin=True,
                                              programs=["p"])
    entry, why = EDGE[verifier].verify_tenant_token(secret, tok)
    assert why == "ok" and entry["tenant"] == "carol" and entry["admin"] is True
    assert entry["programs"] == frozenset({"p"}) and entry["token_exp"] == exp
    assert EDGE[verifier].verify_tenant_token(secret, tok, now=exp)[1] == "expired"
    assert EDGE[verifier].verify_tenant_token(b"wrong", tok)[1] == "invalid"
    # a flipped signature character (not the last: its low bits are padding)
    tampered = tok[:-10] + ("A" if tok[-10] != "A" else "B") + tok[-9:]
    assert EDGE[verifier].verify_tenant_token(secret, tampered)[1] == "invalid"
    chain = EDGE[verifier].EdgeChain(token_secret=secret, quota_enabled=False)
    assert chain.check("/pause", key=tok).reject is None


# --- over HTTP: the JAX server and the port's --------------------------------------


def _serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd.server_address[1]


def _master(pkg, batch=2):
    if pkg == "jax":
        return JMaster(jnet.add2(**CAPS), chunk_steps=32, batch=batch, engine="scan")
    return TMaster(tnet.add2(**CAPS), chunk_steps=32, batch=batch, device="cpu")


class Server:
    """One package's master and engine HTTP server, built from the env
    as it stands (the edge reads it)."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.master = _master(pkg)
        self.httpd = (j_http if pkg == "jax" else t_http)(self.master, port=0)
        self.port = _serve(self.httpd)

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.master.close()


def call(port, method, path, body=b"", key=None, headers=None):
    """(status, body, Retry-After, WWW-Authenticate) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        h = dict(headers or {})
        if key is not None:
            h["X-Misaka-Key"] = key
        conn.request(method, path, body if method == "POST" else None, h)
        r = conn.getresponse()
        return (r.status, r.read(), r.getheader("Retry-After"), r.getheader("WWW-Authenticate"))
    finally:
        conn.close()


def both(run):
    """run(pkg, port) on a fresh JAX server and then on the port's; each
    result with the server's edge-series delta."""
    out = {}
    for pkg in ("jax", "port"):
        s = Server(pkg)
        try:
            before = edge_series(pkg)
            got = run(pkg, s.port)
            out[pkg] = (got, series_delta(before, edge_series(pkg)))
        finally:
            s.close()
            EDGE[pkg].reset()
    return out


def test_http_typed_rejections_and_open_routes_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("MISAKA_API_KEYS", write_keys(tmp_path / "keys.json", KEYS))

    def run(pkg, port):
        got = [call(port, "GET", "/healthz")[0], call(port, "GET", "/metrics")[0],
               json.loads(call(port, "GET", "/healthz")[1])["edge"],
               call(port, "POST", "/compute", b"value=1"), call(port, "GET", "/status"),
               call(port, "POST", "/run", b"", headers={"Authorization": "Bearer adm-secret"}),
               call(port, "POST", "/compute", b"value=7", key="adm-secret"),
               call(port, "POST", "/pause", b"", key="bob-secret"),
               call(port, "POST", "/compute", b"value=1", key="eve-secret"),
               call(port, "POST", "/compute", b"value=1", key="pin-secret"),
               call(port, "POST", "/compute", b"value=1", key="pin-secret",
                    headers={"X-Misaka-Program": "compact"}),
               call(port, "POST", "/compute", b"value=1", key="unknown"),
               call(port, "GET", "/debug/requests?slowest=1")[0],
               call(port, "POST", "/compute_raw", b"\0" * 16, key="bob-secret"),
               call(port, "POST", "/compute_raw", b"\0" * 16, key="bob-secret"),
               call(port, "POST", "/compute_batch", b"values=1,2", key="bob-secret"),
               call(port, "GET", "/status", key="bob-secret")[0]]
        return got

    out = both(run)
    assert out["port"] == out["jax"]
    got = out["port"][0]
    assert got[3][0] == 401 and got[3][3] == 'Bearer realm="misaka", charset="UTF-8"'
    assert [g[0] for g in got[5:12]] == [200, 200, 403, 403, 200, 403, 401]
    assert got[13][0] == 200 and got[14][:3] == (429, b"request rate quota exhausted "
                                                 b"(0.5 requests/s)", "2")
    assert out["port"][1]['misaka_edge_rejected_total{reason="rate",tenant="bob"}'] == 2


def test_http_keyfile_hot_reload_rotation_matches_jax(tmp_path, monkeypatch):
    kf = write_keys(tmp_path / "keys.json", KEYS)
    monkeypatch.setenv("MISAKA_API_KEYS", kf)

    def run(pkg, port):
        write_keys(kf, KEYS)
        os.utime(kf, (time.time() - 100, time.time() - 100))
        got = [call(port, "POST", "/run", b"", key="adm-secret")[0],
               call(port, "POST", "/compute", b"value=1", key="adm-secret")]
        time.sleep(0.6)  # past the stat throttle
        write_keys(kf, [{"key": "adm-rotated", "tenant": "ops", "admin": True}])
        got += [call(port, "POST", "/compute", b"value=1", key="adm-secret"),
                call(port, "POST", "/compute", b"value=1", key="adm-rotated"),
                json.loads(call(port, "GET", "/healthz")[1])["edge"]]
        return got

    out = both(run)
    assert out["port"] == out["jax"]
    assert [g[0] for g in out["port"][0][1:4]] == [200, 401, 200]


@pytest.mark.parametrize("mode", ["default", "disarmed"])
def test_http_default_env_and_disarmed_edge_match_jax(monkeypatch, mode):
    if mode == "disarmed":
        monkeypatch.setenv("MISAKA_EDGE", "0")

    def run(pkg, port):
        health = json.loads(call(port, "GET", "/healthz")[1])
        return [health.get("edge"), call(port, "POST", "/run"),
                call(port, "POST", "/compute", b"value=5"),
                call(port, "POST", "/compute_raw", np.arange(6, dtype="<i4").tobytes()),
                call(port, "POST", "/edge/token", b"tenant=a"),
                call(port, "POST", "/edge/gossip", b"{}")[:2],
                call(port, "GET", "/status")[0]]

    out = both(run)
    assert out["port"] == out["jax"]
    got, delta = out["port"]
    if mode == "disarmed":
        assert got[0] is None
        assert not any(k.startswith(("misaka_edge_admitted", "misaka_edge_rejected"))
                       for k in delta)
    else:
        assert got[0] == {"auth": False, "keys": 0, "tokens": False, "quota": True,
                          "admission": True, "admission_high": 33554432}
        assert got[4][0] == 503
        assert delta['misaka_edge_admitted_total{tenant="default"}'] > 0


def test_http_token_and_gossip_routes_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("MISAKA_API_KEYS", write_keys(tmp_path / "keys.json", KEYS))
    monkeypatch.setenv("MISAKA_TOKEN_SECRET", "route-test-secret")
    # a token of each package, to be served by the other's server
    cross = {pkg: EDGE[pkg].mint_tenant_token(b"route-test-secret", "dave")[0] for pkg in EDGE}
    minted = {}

    def run(pkg, port):
        status, body, *_ = call(port, "POST", "/edge/token", b"tenant=alice&ttl=60&programs=b,a",
                                key="adm-secret")
        payload = json.loads(body)
        minted[pkg] = payload.pop("token")
        assert payload.pop("expires_at") == pytest.approx(time.time() + 60, abs=5)
        got = [call(port, "GET", "/status", key=cross["jax" if pkg == "port" else "port"])[0],
               call(port, "POST", "/edge/token", b"tenant=alice"),
               call(port, "POST", "/edge/token", b"tenant=alice", key="bob-secret"),
               (status, payload),
               call(port, "GET", "/status", key=minted[pkg])[0],
               call(port, "GET", "/status", key="mst1.not.real"),
               call(port, "POST", "/edge/token", b"ttl=60", key="adm-secret"),
               call(port, "POST", "/edge/token", b"tenant=x&ttl=bogus", key="adm-secret"),
               call(port, "POST", "/edge/gossip",
                    json.dumps({"source": "peer-1", "usage": {"alice|rps": 5.0}}).encode(),
                    key="adm-secret"),
               call(port, "POST", "/edge/gossip", json.dumps({"usage": "nope"}).encode(),
                    key="adm-secret")]
        return got

    out = both(run)
    assert out["port"] == out["jax"]
    got = out["port"][0]
    assert got[0] == 200  # the JAX-minted token serves on the port, and back
    assert [g[0] for g in got[1:3]] == [401, 403] and got[3][0] == 200 and got[4] == 200
    assert got[5][0] == 401 and got[-1][0] == 400
    assert json.loads(got[-2][1]) == {"drained": 0, "usage": {}}
    entry, why = jedge.verify_tenant_token(b"route-test-secret", minted["port"])
    assert why == "ok" and entry["programs"] == frozenset({"a", "b"})


# --- through the compute plane ----------------------------------------------------


def _close_plane_client(fe_httpd):
    """The PlaneClient behind a frontend server: the port's hangs on the
    server; the reference's sits in its handler's closure."""
    client = getattr(fe_httpd, "misaka_plane_client", None)
    if client is None:
        for cell in fe_httpd.RequestHandlerClass._do_post.__closure__ or ():
            if isinstance(cell.cell_contents, jfe.PlaneClient):
                client = cell.cell_contents
    client.close()


class PlaneStack:
    """A worker of one package over the engine (server and compute plane)
    of another, in process."""

    def __init__(self, worker, engine, tmp_path):
        self.engine_pkg = engine
        self.server = Server(engine)
        path = str(tmp_path / f"{worker}-{engine}.sock")
        self.plane = FE[engine].start_compute_plane(self.server.master, path)
        self.fe = FE[worker].make_frontend_server(
            0, f"http://127.0.0.1:{self.server.port}", path, plane_conns=2)
        self.port = _serve(self.fe)
        self.server.master.run()

    def close(self):
        self.fe.shutdown()
        self.fe.server_close()
        _close_plane_client(self.fe)
        self.plane.close()
        self.server.close()
        EDGE[self.engine_pkg].reset()


COMBOS = [("port", "port"), ("port", "jax"), ("jax", "port")]
VALS = np.arange(8, dtype="<i4").tobytes()


def shed_by_worker(answer):
    """A worker's shed-cache answer: its Retry-After counts down the
    engine's advertised 2 s in real time, so the record keeps that it is
    1 or 2, not which."""
    status, body, retry, challenge = answer
    return status, body, retry in ("1", "2"), challenge


def _plane_session(port):
    raw = "/compute_raw?spread=1"
    got = [call(port, "POST", raw, VALS), call(port, "POST", raw, VALS, key="adm-secret"),
           call(port, "POST", raw, VALS, key="eve-secret"),
           call(port, "POST", "/compute", b"value=3", key="unknown"),
           call(port, "POST", raw, VALS, key="bob-secret"),
           call(port, "POST", raw, VALS, key="bob-secret"),   # the engine's 429
           shed_by_worker(call(port, "POST", "/compute", b"value=3", key="bob-secret")),
           call(port, "POST", "/compute_batch", b"values=1+2+3", key="adm-secret",
                headers={"Content-Type": "application/x-www-form-urlencoded"}),
           call(port, "POST", "/pause", b"", key="bob-secret")]
    return got


@pytest.mark.parametrize("worker,engine", COMBOS, ids=[f"{w}-worker-{e}-plane" for w, e in COMBOS])
def test_plane_auth_and_quota_typing_matches_jax(tmp_path, monkeypatch, worker, engine):
    monkeypatch.setenv("MISAKA_API_KEYS", write_keys(tmp_path / "keys.json", KEYS))
    answers = {}
    for combo in (("jax", "jax"), (worker, engine)):
        s = PlaneStack(*combo, tmp_path)
        try:
            answers[combo] = _plane_session(s.port)
        finally:
            s.close()
    got = answers[(worker, engine)]
    assert got == answers[("jax", "jax")]
    assert [g[0] for g in got] == [401, 200, 403, 401, 200, 429, 429, 200, 403]
    assert got[0][3] == 'Bearer realm="misaka", charset="UTF-8"'
    assert np.frombuffer(got[1][1], "<i4").tolist() == list(range(2, 10))
    assert got[5][2] == "2" and got[6][2] is True


@pytest.mark.parametrize("worker,engine", COMBOS, ids=[f"{w}-worker-{e}-plane" for w, e in COMBOS])
def test_worker_shed_counts_reach_engine_metrics(tmp_path, monkeypatch, worker, engine):
    monkeypatch.setenv("MISAKA_API_KEYS", write_keys(tmp_path / "keys.json", KEYS))
    series = 'misaka_edge_rejected_total{reason="rate",tenant="bob"}'
    s = PlaneStack(worker, engine, tmp_path)
    try:
        before = edge_series(engine).get(series, 0.0)
        statuses = [call(s.port, "POST", "/compute_raw?spread=1", VALS, key="bob-secret")[0]
                    for _ in range(12)]
        assert statuses[0] == 200 and set(statuses[1:]) == {429}
        # an admitted frame carries the worker's pending shed counts
        assert call(s.port, "POST", "/compute_raw?spread=1", VALS, key="adm-secret")[0] == 200
        deadline = time.monotonic() + 10
        while edge_series(engine).get(series, 0.0) - before < 11:
            assert time.monotonic() < deadline, edge_series(engine)
            time.sleep(0.05)
        assert edge_series(engine).get(series, 0.0) - before == 11
    finally:
        s.close()
