"""The port's program registry (runtime/registry.py) against the JAX one.

Each test of tests/test_registry.py runs here once per package (the `pkg`
parameter: "jax" is misaka_tpu, "torch" the port on the CPU), on the plain
engine at batch 2 and caps 16 as that file's make_registry builds it, so
each case holds the port to the reference's own behaviour: content-address
dedup, version and alias resolution, LRU eviction order, eviction and
revival through the manifest-verified checkpoint, concurrent uploads,
compile-first publishes, the persistent store, the HTTP surface (uploads,
program-addressed compute on the three routes, X-Misaka-Program, typed
404s and 400s, listings, /status, a hot swap under 8 clients, the
`program` metric labels and span attr), the client's helpers and the
per-program plane frames.

Then the cross-package cases: the same uploads give the same canonical
source and version ID; a MISAKA_PROGRAMS_DIR store written by one package
boots and serves in the other; the `delay` program evicted by one package
revives in the other with its sequence intact; GET /programs and
/programs/<name> bodies are equal apart from `created_unix` and the
seconds of each `usage` block (both ledgers on: the same requests and
values per program, null for an idle one); the typed 400 and
404 bodies are equal; plane frames cross between the packages' clients
and planes, a `ghost` program's 404 included, while a KeyError out of an
engine's compute stays a 500 on both; and an evicted engine of the port is
freed by reference counting once the registry drops it.

Last, F.4/F.5 of ROADMAP C: a server with no registry answers a request
that names a program (X-Misaka-Program, /programs/<name>/compute) and the
registry routes with the JAX server's status and body, byte for byte.
"""

import json
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

import misaka_tpu.client as jclient
import misaka_tpu_torch.client as tclient
from misaka_tpu import networks as jnetworks
from misaka_tpu.runtime import frontends as jfrontends
from misaka_tpu.runtime import master as jmaster
from misaka_tpu.runtime import registry as jregistry
from misaka_tpu.runtime import usage as jusage
from misaka_tpu.runtime.topology import Topology as JTopology
from misaka_tpu.tis.parser import TISParseError as JTISParseError
from misaka_tpu_torch import networks as tnetworks
from misaka_tpu_torch.runtime import checkpoint as tckpt
from misaka_tpu_torch.runtime import frontends as tfrontends
from misaka_tpu_torch.runtime import master as tmaster
from misaka_tpu_torch.runtime import registry as tregistry
from misaka_tpu_torch.runtime import usage as tusage
from misaka_tpu_torch.runtime.topology import Topology as TTopology
from misaka_tpu_torch.tis.parser import TISParseError as TTISParseError

torch.set_num_threads(1)

SMALL = dict(stack_cap=16, in_cap=16, out_cap=16)

ADD10 = "IN ACC\nADD 10\nOUT ACC\n"
ADD20 = "IN ACC\nADD 20\nOUT ACC\n"
ADD30 = "IN ACC\nADD 30\nOUT ACC\n"
# a delay line: output_i = input_{i-1} (0 first); BAK holds the last value,
# the state eviction must carry
DELAY = "IN ACC\nSWP\nOUT ACC\nSWP\nSAV\n"

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", MasterNode=jmaster.MasterNode, make_http_server=jmaster.make_http_server,
        verify_checkpoint=jmaster.verify_checkpoint, reg=jregistry, Topology=JTopology,
        networks=jnetworks, client=jclient, frontends=jfrontends,
        TISParseError=JTISParseError, kw={"engine": "scan"}),
    "torch": types.SimpleNamespace(
        name="torch", MasterNode=tmaster.MasterNode, make_http_server=tmaster.make_http_server,
        verify_checkpoint=tckpt.verify_checkpoint, reg=tregistry, Topology=TTopology,
        networks=tnetworks, client=tclient, frontends=tfrontends,
        TISParseError=TTISParseError, kw={"engine": "scan", "device": "cpu"}),
}


@pytest.fixture(autouse=True, scope="module")
def _quiet_jax_daemons():
    # the JAX server's process-global daemons would outlive the module
    with pytest.MonkeyPatch.context() as mp:
        for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG", "MISAKA_CANARY"):
            mp.setenv(switch, "0")
        yield


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


def registry_kw(p, **kw):
    kw.setdefault("batch", 2)
    kw.setdefault("chunk_steps", 32)
    kw.setdefault("caps", SMALL)
    kw.update({k: v for k, v in p.kw.items()})
    return kw


def make_registry(p, programs_dir=None, **kw):
    return p.reg.ProgramRegistry(programs_dir, **registry_kw(p, **kw))


def make_master(p, top, batch=2):
    return p.MasterNode(top, chunk_steps=32, batch=batch, **p.kw)


def seeded_registry(p, name="default", **kw):
    reg = make_registry(p, **kw)
    top = p.networks.add2(**SMALL)
    master = make_master(p, top, batch=reg._batch)
    reg.seed(name, master, top)
    master.run()
    return reg, master


def close_all(reg, master):
    master.pause()
    reg.close()
    master.close()


# --- registry core (tests/test_registry.py, both packages) ---------------------------


def test_content_address_dedup(pkg):
    reg, master = seeded_registry(pkg)
    try:
        r1 = reg.publish("p", tis=ADD10)
        r2 = reg.publish("p", tis=ADD10)
        assert r1["created"] and not r2["created"]
        assert r1["version"] == r2["version"]
        # the same network as topology JSON (other key order) dedups
        r3 = reg.publish("q", topology_json=json.dumps({
            "programs": {"main": ADD10}, "nodes": {"main": "program"},
            "out_cap": 16, "in_cap": 16, "stack_cap": 16,
        }))
        assert r3["version"] == r1["version"]
        assert reg.publish("p", tis=ADD20)["version"] != r1["version"]
    finally:
        close_all(reg, master)


def test_canonicalization_is_key_order_invariant(pkg):
    def vid(**kw):
        return pkg.reg.version_of(pkg.reg.canonical_topology(pkg.Topology(**kw, **SMALL)))

    assert vid(node_info={"main": "program"}, programs={"main": ADD10}) == vid(
        programs={"main": ADD10}, node_info={"main": "program"})


def test_version_and_alias_resolution(pkg):
    reg, master = seeded_registry(pkg)
    try:
        v1 = reg.publish("p", tis=ADD10)["version"]
        v2 = reg.publish("p", tis=ADD20)["version"]
        assert reg.resolve("p") == ("p", v2)
        assert reg.resolve("p@latest") == ("p", v2)
        assert reg.resolve(f"p@{v1}") == ("p", v1)
        assert reg.resolve(None) == ("default", reg.resolve("default")[1])
        with pytest.raises(pkg.reg.ProgramNotFound):
            reg.resolve("ghost")
        with pytest.raises(pkg.reg.ProgramNotFound):
            reg.resolve("p@000000000000")
        # exact-version addressing serves the old program after a publish
        with reg.lease(f"p@{v1}") as m:
            assert m.compute_coalesced([1]) == [11]
        with reg.lease("p") as m:
            assert m.compute_coalesced([1]) == [21]
    finally:
        close_all(reg, master)


def test_lru_eviction_order(pkg):
    reg, master = seeded_registry(pkg, max_active=3)
    try:
        for name, src in (("a", ADD10), ("b", ADD20), ("c", ADD30)):
            reg.publish(name, tis=src)
        with reg.lease("a") as m:
            assert m.compute_coalesced([1]) == [11]
        with reg.lease("b") as m:
            assert m.compute_coalesced([1]) == [21]
        # active: default (pinned), a, b at the cap of 3; touch a, so b is
        # the LRU candidate when c activates
        with reg.lease("a"):
            pass
        with reg.lease("c") as m:
            assert m.compute_coalesced([1]) == [31]
        assert {n for n, _ in reg.active_versions()} == {"default", "a", "c"}
        # the evicted program left a manifest-verified checkpoint behind
        pkg.verify_checkpoint(reg._state_path("b", reg.resolve("b")[1]))
        # reactivating b works, and evicts the new LRU, a
        with reg.lease("b") as m:
            assert m.compute_coalesced([2]) == [22]
        assert {n for n, _ in reg.active_versions()} == {"default", "c", "b"}
    finally:
        close_all(reg, master)


def test_eviction_restores_state_bit_identically(pkg):
    # batch=None: one instance, so the delay line's state and every value
    # share it
    reg, master = seeded_registry(pkg, max_active=4, batch=None)
    try:
        v = reg.publish("delay", tis=DELAY)["version"]
        with reg.lease("delay") as m:
            assert m.compute_coalesced([5]) == [0]
            assert m.compute_coalesced([6]) == [5]
        assert reg.deactivate("delay")  # drain + durable checkpoint + close
        ckpt = reg._state_path("delay", v)
        pkg.verify_checkpoint(ckpt)
        # a fresh master that loads the eviction checkpoint holds exactly
        # the saved arrays
        fresh = make_master(pkg, pkg.Topology(node_info={"main": "program"},
                                              programs={"main": DELAY}, **SMALL), batch=None)
        fresh.load_checkpoint(ckpt)
        snap = fresh.snapshot()
        with np.load(ckpt) as data:
            for field in snap._fields:
                if field in data:
                    np.testing.assert_array_equal(np.asarray(getattr(snap, field)),
                                                  data[field], err_msg=field)
        fresh.close()
        # the delay line remembers its last value across the eviction
        with reg.lease("delay") as m:
            assert m.compute_coalesced([7]) == [6]
    finally:
        close_all(reg, master)


def test_concurrent_upload_races(pkg):
    reg, master = seeded_registry(pkg)
    try:
        sources = [f"IN ACC\nADD {i}\nOUT ACC\n" for i in range(1, 9)]
        errors = []

        def upload(src):
            try:
                reg.publish("raced", tis=src)
            except Exception as e:  # the failure path
                errors.append(e)

        ts = [threading.Thread(target=upload, args=(s,)) for s in sources]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errors
        info = reg.list_programs()["programs"]["raced"]
        assert len(info["versions"]) == len(sources)
        assert info["latest"] in info["versions"]
        with reg.lease("raced") as m:
            out = m.compute_coalesced([0])[0]
        assert 1 <= out <= 8
    finally:
        close_all(reg, master)


def test_publish_over_seeded_program_rejected(pkg):
    reg, master = seeded_registry(pkg)
    try:
        with pytest.raises(pkg.reg.RegistryError, match="seeded boot program"):
            reg.publish("default", tis=ADD10)
    finally:
        close_all(reg, master)


def test_publish_compile_first_touches_nothing(pkg):
    reg, master = seeded_registry(pkg)
    try:
        v1 = reg.publish("p", tis=ADD10)["version"]
        with reg.lease("p") as m:
            assert m.compute_coalesced([1]) == [11]
        with pytest.raises(pkg.TISParseError):
            reg.publish("p", tis="FROB 1\n")
        assert reg.resolve("p")[1] == v1
        with reg.lease("p") as m:
            assert m.compute_coalesced([2]) == [12]
    finally:
        close_all(reg, master)


def test_registry_persistence_across_restart(pkg, tmp_path):
    d = str(tmp_path / "programs")
    reg = make_registry(pkg, d)
    v = reg.publish("keeper", tis=ADD10)["version"]
    with reg.lease("keeper") as m:
        assert m.compute_coalesced([1]) == [11]
    reg.close()  # checkpoints + closes the active engine
    reg2 = make_registry(pkg, d)
    info = reg2.list_programs()["programs"]
    assert info["keeper"]["latest"] == v
    assert info["keeper"]["versions"][v]["checkpoint"]
    with reg2.lease("keeper") as m:  # revives from the shutdown checkpoint
        assert m.compute_coalesced([2]) == [12]
    reg2.close()


# --- the HTTP surface -----------------------------------------------------------------


def serve_registry(p, name="default", **kw):
    reg = make_registry(p, **kw)
    top = p.networks.add2(**SMALL)
    master = make_master(p, top, batch=reg._batch)
    reg.seed(name, master, top)
    httpd = p.make_http_server(master, port=0, registry=reg)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    master.run()
    return f"http://127.0.0.1:{httpd.server_address[1]}", master, reg, httpd


def stop_server(master, reg, httpd):
    master.pause()
    reg.close()
    httpd.shutdown()
    httpd.server_close()
    master.close()


def post(base, path, data=None, headers=None, raw=None):
    body = raw if raw is not None else urllib.parse.urlencode(data or {}).encode()
    req = urllib.request.Request(base + path, data=body, method="POST", headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class TestHTTP:
    """The HTTP surface on one server per package (class-scoped: its
    engines stop when the class ends, not at the module's end)."""

    @pytest.fixture(scope="class", params=list(PKGS))
    def reg_server(self, request):
        base, master, reg, httpd = serve_registry(PKGS[request.param])
        yield base, master, reg, PKGS[request.param]
        stop_server(master, reg, httpd)

    def test_http_upload_and_program_routes(self, reg_server):
        base, _, _, _ = reg_server
        status, body = post(base, "/programs", {"name": "web", "program": ADD10})
        assert status == 200, body
        out = json.loads(body)
        assert out["created"] and out["name"] == "web"
        status, body = post(base, "/programs/web/compute", {"value": "1"})
        assert (status, json.loads(body)) == (200, {"value": 11})
        status, body = post(base, "/programs/web/compute_batch", {"values": "1 2", "spread": "1"})
        assert json.loads(body) == {"values": [11, 12]}
        status, body = post(base, "/programs/web/compute_raw?spread=1",
                            raw=np.asarray([3], "<i4").tobytes())
        assert np.frombuffer(body, "<i4").tolist() == [13]
        status, body = post(base, f"/programs/web@{out['version']}/compute", {"value": "2"})
        assert json.loads(body) == {"value": 12}

    def test_http_legacy_routes_serve_default(self, reg_server):
        base, _, _, _ = reg_server
        status, body = post(base, "/compute", {"value": "5"})
        assert (status, json.loads(body)) == (200, {"value": 7})
        status, body = post(base, "/compute_batch", {"values": "1 2", "spread": "1"})
        assert json.loads(body) == {"values": [3, 4]}
        status, body = post(base, "/compute_raw?spread=1", raw=np.asarray([1, 2], "<i4").tobytes())
        assert np.frombuffer(body, "<i4").tolist() == [3, 4]

    def test_http_header_addressing(self, reg_server):
        base, _, _, _ = reg_server
        post(base, "/programs", {"name": "hdr", "program": ADD20})
        status, body = post(base, "/compute", {"value": "1"}, headers={"X-Misaka-Program": "hdr"})
        assert json.loads(body) == {"value": 21}
        status, body = post(base, "/compute_raw?spread=1", raw=np.asarray([5], "<i4").tobytes(),
                            headers={"X-Misaka-Program": "hdr"})
        assert np.frombuffer(body, "<i4").tolist() == [25]

    def test_http_unknown_program_typed_404(self, reg_server):
        base, _, _, _ = reg_server
        status, body = post(base, "/programs/ghost/compute", {"value": "1"})
        assert status == 404 and b"unknown program" in body
        status, body = post(base, "/compute", {"value": "1"}, headers={"X-Misaka-Program": "ghost"})
        assert status == 404 and b"unknown program" in body
        status, body = get(base, "/programs/ghost")
        assert status == 404
        post(base, "/programs", {"name": "known", "program": ADD10})
        status, body = post(base, "/programs/known@ffffffffffff/compute", {"value": "1"})
        assert status == 404 and b"no version" in body

    def test_http_listing_and_status(self, reg_server):
        base, _, _, _ = reg_server
        post(base, "/programs", {"name": "listed", "program": ADD10})
        status, body = get(base, "/programs")
        listing = json.loads(body)
        assert "listed" in listing["programs"]
        assert listing["programs"]["default"]["pinned"]
        status, body = get(base, "/programs/listed")
        assert json.loads(body)["latest"]
        status, body = get(base, "/status")
        assert "programs" in json.loads(body)
        # GET on a compute route is the reference's method rejection
        status, body = get(base, "/programs/listed/compute")
        assert (status, body) == (405, b"method GET not allowed")

    def test_http_bad_upload_400(self, reg_server):
        base, _, _, _ = reg_server
        status, body = post(base, "/programs", {"name": "bad", "program": "FROB"})
        assert status == 400 and b"not a valid instruction" in body
        status, body = post(base, "/programs", {"name": "bad/../evil", "program": ADD10})
        assert status == 400
        status, body = post(base, "/programs", {"name": "noform"})
        assert status == 400 and b"exactly one" in body
        status, body = post(base, "/programs", {"name": "default", "program": ADD10})
        assert status == 400 and b"seeded boot program" in body

    def test_http_hot_swap_under_concurrency(self, reg_server):
        base, _, _, _ = reg_server
        post(base, "/programs", {"name": "swapper", "program": ADD10})
        stop = threading.Event()
        failures = []
        odd = []

        def hammer():
            body = np.asarray([1, 2], "<i4").tobytes()
            while not stop.is_set():
                status, out = post(base, "/programs/swapper/compute_raw?spread=1", raw=body)
                if status != 200:
                    failures.append((status, out))
                    return
                got = np.frombuffer(out, "<i4").tolist()
                if got not in ([11, 12], [21, 22]):
                    odd.append(got)
                    return

        ts = [threading.Thread(target=hammer) for _ in range(8)]
        for t in ts:
            t.start()
        status, body = post(base, "/programs", {"name": "swapper", "program": ADD20})
        assert status == 200 and json.loads(body)["swapped"]
        time.sleep(0.3)
        stop.set()
        for t in ts:
            t.join()
        assert not failures and not odd
        status, body = post(base, "/programs/swapper/compute", {"value": "1"})
        assert json.loads(body) == {"value": 21}

    def test_metrics_carry_program_labels(self, reg_server):
        base, _, _, _ = reg_server
        post(base, "/programs", {"name": "metered", "program": ADD10})
        post(base, "/programs/metered/compute", {"value": "1"})
        post(base, "/compute", {"value": "1"})
        status, body = get(base, "/metrics")
        text = body.decode()
        assert 'misaka_program_requests_total{program="metered"}' in text
        assert 'misaka_program_requests_total{program="default"}' in text
        assert 'misaka_program_values_total{program="metered"}' in text

    def test_client_helpers_and_pinned_session(self, reg_server):
        base, _, _, p = reg_server
        c = p.client.MisakaClient(base)
        out = c.upload_program("cli", program=ADD10)
        assert out["name"] == "cli"
        dup = c.upload_program("cli2", topology={
            "nodes": {"main": "program"}, "programs": {"main": ADD10},
            "stack_cap": 16, "in_cap": 16, "out_cap": 16})
        assert dup["version"] == out["version"]
        assert "cli" in c.list_programs()["programs"]
        assert c.program_info("cli")["latest"] == out["version"]
        pinned = p.client.MisakaClient(base, program="cli")
        assert int(pinned.compute(1)) == 11
        assert pinned.compute_raw([1, 2]).tolist() == [11, 12]
        assert pinned.compute_batch([3]).tolist() == [13]
        with pytest.raises(p.client.MisakaClientError) as exc:
            p.client.MisakaClient(base, program="ghost").compute(1)
        assert exc.value.status == 404
        c.close()
        pinned.close()

    def test_serve_pass_span_carries_program_attr(self, reg_server):
        base, _, _, _ = reg_server
        post(base, "/programs", {"name": "traced", "program": ADD10})
        status, body = post(base, "/programs/traced/compute", {"value": "1"},
                            headers={"X-Misaka-Trace": "prog-attr-test-1"})
        assert status == 200
        # the trace lands in the recorder after the response is sent
        deadline = time.monotonic() + 10
        while True:
            status, body = get(base, "/debug/requests/prog-attr-test-1")
            if status == 200 or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        spans = [s for s in json.loads(body)["spans"] if s["name"] == "serve.pass"]
        assert spans and spans[0]["attrs"]["program"] == "traced"


# --- the compute plane ---------------------------------------------------------------


def test_plane_frames_route_per_program(pkg, tmp_path):
    reg, master = seeded_registry(pkg)
    plane_path = str(tmp_path / "plane.sock")
    plane = pkg.frontends.start_compute_plane(master, plane_path, registry=reg)
    client = pkg.frontends.PlaneClient(plane_path, conns=2)
    try:
        reg.publish("pl", tis=ADD10)
        results = {}

        def worker(i):
            vals = np.asarray([i, i + 1], "<i4")
            prog = "pl" if i % 2 else None
            out = client.compute_raw(vals.tobytes(), program=prog)
            want = vals + (10 if i % 2 else 2)
            results[i] = np.frombuffer(out, "<i4").tolist() == want.tolist()

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(12)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert all(results.values()) and len(results) == 12
        with pytest.raises(pkg.frontends.PlaneError) as exc:
            client.compute_raw(np.asarray([1], "<i4").tobytes(), program="ghost")
        assert exc.value.status == 404
    finally:
        client.close()
        plane.close()
        close_all(reg, master)


# --- across the packages -------------------------------------------------------------


UPLOADS = [
    {"tis": ADD10},
    {"tis": DELAY},
    {"tis": "IN ACC\r\nADD 1\r\nOUT ACC"},
    {"topology_json": json.dumps({"nodes": {"b": "program", "a": "program", "s": "stack"},
                                  "programs": {"a": "IN ACC\nMOV ACC, b:R0\n",
                                               "b": "MOV R0, ACC\nPUSH ACC, s\n"
                                                    "POP s, ACC\nOUT ACC\n"},
                                  "stack_cap": 32})},
]


@pytest.mark.parametrize("upload", UPLOADS, ids=["add10", "delay", "crlf", "topology"])
def test_same_upload_same_canonical_source_and_version(upload):
    sources = []
    for p in PKGS.values():
        reg = make_registry(p)
        try:
            r = reg.publish("same", **upload)
            sources.append((r["version"], reg._entries["same"].versions[r["version"]]["source"]))
        finally:
            reg.close()
    assert sources[0] == sources[1]
    top = tregistry.topology_from_canonical(sources[1][1])
    assert tregistry.version_of(tregistry.canonical_topology(top)) == sources[1][0]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_store_written_by_one_package_boots_in_the_other(writer, reader, tmp_path):
    d = str(tmp_path / "programs")
    w = make_registry(PKGS[writer], d)
    va = w.publish("a10", tis=ADD10)["version"]
    w.publish("a20", tis=ADD20)
    with w.lease("a10") as m:
        assert m.compute_coalesced([1]) == [11]
    w.close()  # the active engine leaves its checkpoint in the store
    r = make_registry(PKGS[reader], d)
    try:
        info = r.list_programs()["programs"]
        assert sorted(info) == ["a10", "a20"] and info["a10"]["latest"] == va
        assert info["a10"]["versions"][va]["checkpoint"]
        with r.lease("a10") as m:  # revives from the other package's checkpoint
            assert m.compute_coalesced([2]) == [12]
        with r.lease("a20") as m:
            assert m.compute_coalesced([2]) == [22]
    finally:
        r.close()


def test_delay_evicted_by_one_package_revives_in_the_other(tmp_path):
    d = str(tmp_path / "programs")
    want = 0
    for i, name in enumerate(["jax", "torch", "jax"]):
        reg = make_registry(PKGS[name], d, batch=None)
        try:
            if i == 0:
                reg.publish("delay", tis=DELAY)
            with reg.lease("delay") as m:
                for v in (10 * i + 1, 10 * i + 2):
                    assert m.compute_coalesced([v]) == [want], (name, v)
                    want = v
            assert reg.deactivate("delay")
        finally:
            reg.close()


def strip_created(obj):
    if isinstance(obj, dict):
        return {k: strip_created(v) for k, v in obj.items() if k != "created_unix"}
    return obj


@pytest.fixture
def fresh_ledgers():
    # both ledgers on and empty: each package books only this test's traffic
    for mod in (jusage, tusage):
        mod.configure({})
        mod.reset()
    yield


def strip_durations(obj):
    """A listing with each usage block's seconds (durations) dropped."""
    if isinstance(obj, dict):
        return {k: ({f: v[f] for f in ("requests", "values")} if k == "usage" and v
                    else strip_durations(v)) for k, v in obj.items()}
    return obj


def test_listing_bodies_equal_across_packages(fresh_ledgers):
    servers = [serve_registry(p, name="boot") for p in PKGS.values()]
    try:
        bodies = []
        for base, _, _, _ in servers:
            post(base, "/programs", {"name": "lst", "program": ADD10})
            post(base, "/programs", {"name": "lst2", "program": ADD20})
            assert post(base, "/programs/lst/compute", {"value": "1"}) == (200, b'{"value": 11}\n')
            assert post(base, "/programs/lst/compute_raw", raw=np.arange(5, dtype="<i4")
                        .tobytes())[0] == 200
            bodies.append([get(base, p) for p in ("/programs", "/programs/lst",
                                                  "/programs/lst2", "/programs/boot")])
        for (sj, bj), (st, bt) in zip(*bodies):
            assert sj == st == 200
            assert (strip_durations(strip_created(json.loads(bj)))
                    == strip_durations(strip_created(json.loads(bt))))
        # the ledger on in both: `lst` served 2 requests of 6 values; an
        # idle program has none
        for b in bodies:
            lst = json.loads(b[1][1])["usage"]
            assert (lst["requests"], lst["values"], lst["native_seconds"]) == (2, 6, 0.0)
            assert lst["cpu_seconds"] > 0
            assert json.loads(b[2][1])["usage"] is None
    finally:
        for _, master, reg, httpd in servers:
            stop_server(master, reg, httpd)


TYPED = [
    ("POST", "/programs", {"name": "bad", "program": "FROB"}, None),
    ("POST", "/programs", {"name": "bad/../evil", "program": ADD10}, None),
    ("POST", "/programs", {"name": "noform"}, None),
    ("POST", "/programs", {"name": "boot", "program": ADD10}, None),
    ("POST", "/programs", {"name": "x", "program": ADD10, "slo": "p99<"}, None),
    ("POST", "/programs", {"name": "x", "program": ADD10, "quota": "foo<1"}, None),
    ("POST", "/programs", {"name": "x", "program": ADD10, "verify": "nope"}, None),
    ("POST", "/programs", {"name": "x", "program": "   "}, None),
    ("POST", "/programs", {"name": "x", "topology": "{"}, None),
    ("POST", "/programs/ghost/compute", {"value": "1"}, None),
    ("POST", "/compute", {"value": "1"}, {"X-Misaka-Program": "ghost"}),
    ("POST", "/programs/typed@ffffffffffff/compute_raw", None, None),
    ("GET", "/programs/ghost", None, None),
]


def test_typed_400_and_404_bodies_equal_across_packages():
    servers = [serve_registry(p, name="boot") for p in PKGS.values()]
    try:
        answers = []
        for base, _, _, _ in servers:
            post(base, "/programs", {"name": "typed", "program": ADD10})
            got = []
            for method, path, form, headers in TYPED:
                if method == "GET":
                    got.append(get(base, path))
                elif form is None:
                    got.append(post(base, path, raw=b"\x01\x00\x00\x00", headers=headers))
                else:
                    got.append(post(base, path, form, headers=headers))
            # verify=replay: both refuse with the reference's 400 prefix
            s, b = post(base, "/programs?verify=replay", {"name": "typed", "program": ADD20})
            got.append((s, b.startswith(b"error publishing program: verify=replay refused: ")))
            answers.append(got)
        assert answers[0] == answers[1]
        assert [s for s, _ in answers[1]] == [400] * 9 + [404] * 4 + [400]
        assert answers[1][-1][1] is True
    finally:
        for _, master, reg, httpd in servers:
            stop_server(master, reg, httpd)


@pytest.mark.parametrize("client_pkg,plane_pkg", [("jax", "torch"), ("torch", "jax")])
def test_plane_frames_route_per_program_across_packages(client_pkg, plane_pkg, tmp_path):
    reg, master = seeded_registry(PKGS[plane_pkg])
    path = str(tmp_path / "plane.sock")
    plane = PKGS[plane_pkg].frontends.start_compute_plane(master, path, registry=reg)
    fe = PKGS[client_pkg].frontends
    client = fe.PlaneClient(path, conns=2)
    try:
        reg.publish("pl", tis=ADD10)
        for i, prog in enumerate(["pl", None, "pl", None]):
            vals = np.asarray([i, -i], "<i4")
            out = np.frombuffer(client.compute_raw(vals.tobytes(), program=prog), "<i4")
            assert out.tolist() == (vals + (10 if prog else 2)).tolist()
        with pytest.raises(fe.PlaneError) as exc:
            client.compute_raw(np.asarray([1], "<i4").tobytes(), program="ghost")
        assert exc.value.status == 404 and exc.value.body == b"unknown program 'ghost'"
    finally:
        client.close()
        plane.close()
        close_all(reg, master)


def test_a_key_error_from_the_compute_stays_500(tmp_path):
    # only the lease may answer 404: a KeyError out of the engine's own
    # compute is a fault, a 500, on both packages' planes
    answers = []
    for p in PKGS.values():
        reg, master = seeded_registry(p)
        path = str(tmp_path / f"{p.name}.sock")
        plane = p.frontends.start_compute_plane(master, path, registry=reg)
        client = p.frontends.PlaneClient(path, conns=1)

        def boom(*args, **kwargs):
            raise KeyError("boom")

        master.compute_coalesced = boom
        try:
            with pytest.raises(p.frontends.PlaneError) as exc:
                client.compute_raw(np.asarray([1], "<i4").tobytes())
            answers.append((exc.value.status, exc.value.body))
        finally:
            client.close()
            plane.close()
            close_all(reg, master)
    assert answers[0] == answers[1] == (500, b"'boom'")


def test_evicted_engine_is_freed_when_the_registry_drops_it():
    reg, master = seeded_registry(PKGS["torch"], max_active=2)
    try:
        reg.publish("a", tis=ADD10)
        reg.publish("b", tis=ADD20)
        with reg.lease("a") as m:
            assert m.compute_coalesced([1, 2]) == [11, 12]
            gone = weakref.ref(m)
            state = weakref.ref(m._state.pc)
            del m
        with reg.lease("b") as m:  # evicts a
            assert m.compute_coalesced([1]) == [21]
        # nothing the port keeps (the loop, the scheduler's workers, metric
        # callbacks) holds the evicted engine: it is freed by reference
        # counting, without a garbage collection
        assert gone() is None and state() is None
    finally:
        close_all(reg, master)


# --- F.4/F.5: no registry, the JAX server's answers ---------------------------------


NO_REGISTRY = [
    ("POST", "/compute", b"value=5", {"X-Misaka-Program": "nope"}),
    ("POST", "/programs/nope/compute", b"value=5", {}),
    ("POST", "/programs", b"name=x&program=NOP", {}),
    ("GET", "/programs", None, {}),
    ("GET", "/programs/nope", None, {}),
]


@pytest.fixture(scope="module")
def bare_servers():
    out = []
    for p in PKGS.values():
        master = make_master(p, p.networks.add2(**SMALL), batch=4)
        httpd = p.make_http_server(master, port=0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        master.run()
        out.append((master, httpd))
    yield [f"http://127.0.0.1:{h.server_address[1]}" for _, h in out]
    for master, httpd in out:
        master.pause()
        httpd.shutdown()
        httpd.server_close()
        master.close()


def raw_answer(base, method, path, data, headers):
    req = urllib.request.Request(base + path, data=data, method=method, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


@pytest.mark.parametrize("method,path,data,headers", NO_REGISTRY,
                         ids=["header", "program_path", "upload", "listing", "info"])
def test_no_registry_answers_like_jax(bare_servers, method, path, data, headers):
    jax_base, port_base = bare_servers
    want = raw_answer(jax_base, method, path, data, headers)
    got = raw_answer(port_base, method, path, data, headers)
    assert got == want
    assert got[0] == 404 and got[2].startswith(b"program registry disabled (set "
                                               b"MISAKA_PROGRAMS_DIR)")
