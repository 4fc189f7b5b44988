"""The port's per-process distributed mode, held against the JAX package's.

The port's counterparts of tests/test_distributed.py (its 16 cases, here
at tier-1 depth), tests/test_tls.py (4), the peer-down case of
tests/test_chaos.py and the rpc case of tests/test_faults.py, run on the
port's nodes (misaka_tpu_torch/runtime/nodes.py, transport/).  Beside them:
the wire contract byte for byte against the JAX package's (the serialized
descriptor, encoded messages for negative values and values past int32),
the HTTP surface of both distributed masters answering the same bodies,
the distributed /metrics and /healthz, the x-misaka-trace metadata round
trip, and the rpc_drop / rpc_delay fault points firing.

Every cluster lives on loopback ephemeral ports in this process and is
closed in a fixture's finally, so no node thread outlives its test.
"""

import json
import os
import shutil
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

grpc = pytest.importorskip("grpc")

from misaka_tpu.runtime import nodes as jnodes  # noqa: E402
from misaka_tpu_torch.runtime import nodes as tnodes  # noqa: E402
from misaka_tpu_torch.runtime.master import (  # noqa: E402
    BroadcastError,
    PeerUnavailable,
    make_http_server,
)
from misaka_tpu_torch.runtime.nodes import (  # noqa: E402
    MasterNodeProcess,
    ProgramNodeProcess,
    Resolver,
    StackNodeProcess,
    build_loopback_cluster,
)
from misaka_tpu_torch.transport import ProgramClient, RpcError, StackClient  # noqa: E402
from misaka_tpu_torch.transport import messenger_pb2 as tpb  # noqa: E402
from misaka_tpu_torch.transport import rpc as trpc  # noqa: E402
from misaka_tpu_torch.utils import faults, metrics, tracespan  # noqa: E402

# The docker-compose add-2 programs (docker-compose.yml:35-40, :54-59).
MISAKA1 = "IN ACC\nADD 1\nMOV ACC, misaka2:R0\nMOV R0, ACC\nOUT ACC"
MISAKA2 = "MOV R0, ACC\nADD 1\nPUSH ACC, misaka3\nPOP misaka3, ACC\nMOV ACC, misaka1:R0"
ADD2_NODES = {"misaka1": "program", "misaka2": "program", "misaka3": "stack"}
ADD2_PROGRAMS = {"misaka1": MISAKA1, "misaka2": MISAKA2}
ADD10_MISAKA2 = "MOV R0, ACC\nADD 10\nPUSH ACC, misaka3\nPOP misaka3, ACC\nMOV ACC, misaka1:R0"


@pytest.fixture(autouse=True)
def _quiet_daemons(monkeypatch):
    # the servers' process-global sampler, TSDB and watchdog would outlive
    # a test (both packages')
    for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG"):
        monkeypatch.setenv(switch, "0")


@pytest.fixture
def add2_cluster():
    """master + 2 program nodes + 1 stack node of the port on loopback."""
    resolver = Resolver()
    nodes = {}
    master = None
    try:
        stack = StackNodeProcess(grpc_port=0, host="127.0.0.1")
        nodes["misaka3"] = stack
        resolver.set_addr("misaka3", f"127.0.0.1:{stack.start()}")
        for name, program in ADD2_PROGRAMS.items():
            p = ProgramNodeProcess(master_uri="last_order", resolver=resolver, grpc_port=0,
                                   host="127.0.0.1")
            nodes[name] = p
            p.load_program(program)
            resolver.set_addr(name, f"127.0.0.1:{p.start()}")
        master = MasterNodeProcess(node_info={n: {"type": k} for n, k in ADD2_NODES.items()},
                                   resolver=resolver, grpc_port=0, host="127.0.0.1")
        resolver.set_addr("last_order", f"127.0.0.1:{master.start()}")
        yield master, nodes
    finally:
        if master is not None:
            master.close()
        for n in nodes.values():
            n.close()


@pytest.fixture
def served():
    """make_http_server over a master, in a thread; shut down after."""
    servers = []

    def serve(master):
        httpd = make_http_server(master, 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        servers.append(httpd)
        return f"http://127.0.0.1:{httpd.server_address[1]}"

    try:
        yield serve
    finally:
        for httpd in servers:
            httpd.shutdown()
            httpd.server_close()


def _request(base, path, data=None, raw=None, method="POST", headers=None):
    body = raw if raw is not None else (
        urllib.parse.urlencode(data or {}).encode() if method == "POST" else None)
    req = urllib.request.Request(base + path, data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=15) as resp:
            return resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def _wait_for(pred, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


# --- the wire contract against the JAX package's ---------------------------------------


def test_descriptor_bytes_equal_the_reference():
    """Both messenger_pb2 modules load in one process only because protobuf
    accepts a second AddSerializedFile of identical bytes: the port's copy
    keeps the reference's serialized descriptor byte for byte."""
    from misaka_tpu.transport import messenger_pb2 as jpb

    assert tpb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
    assert tpb.DESCRIPTOR.name == "messenger.proto" and tpb.DESCRIPTOR.package == "grpc"
    assert trpc.SERVICES.keys() == __import__(
        "misaka_tpu.transport.rpc", fromlist=["SERVICES"]).SERVICES.keys()


@pytest.mark.parametrize("value", [0, 5, -3, -(2**31), 2**31 - 1, 2**31 + 5, -(2**31) - 7,
                                   2**40 + 3])
def test_encoded_messages_equal_the_reference(value):
    """SendMessage / ValueMessage / LoadMessage encode to the same bytes in
    both packages, negative values and values past int32 (truncated by
    _i32 exactly as the reference's int32(v) cast) included."""
    from misaka_tpu.transport import messenger_pb2 as jpb
    from misaka_tpu.transport import rpc as jrpc

    assert trpc._i32(value) == jrpc._i32(value)
    v = trpc._i32(value)
    assert tpb.SendMessage(value=v, register=3).SerializeToString() == \
        jpb.SendMessage(value=jrpc._i32(value), register=3).SerializeToString()
    assert tpb.ValueMessage(value=v).SerializeToString() == \
        jpb.ValueMessage(value=jrpc._i32(value)).SerializeToString()
    src = f"MOV {v}, ACC\nOUT ACC"
    assert tpb.LoadMessage(program=src).SerializeToString() == \
        jpb.LoadMessage(program=src).SerializeToString()


# --- tests/test_distributed.py, on the port's nodes --------------------------------------


def test_add2_end_to_end(add2_cluster):
    master, _ = add2_cluster
    master.run()
    assert master.is_running
    for v in (5, -3, 1000, 0):
        assert master.compute(v, timeout=10) == v + 2


def test_add2_pause_resume(add2_cluster):
    master, nodes = add2_cluster
    master.run()
    assert master.compute(1, timeout=10) == 3
    master.pause()
    assert not master.is_running
    assert not nodes["misaka1"]._life.is_running
    master.run()
    assert master.compute(7, timeout=10) == 9


def test_reset_clears_state(add2_cluster):
    master, nodes = add2_cluster
    master.run()
    assert master.compute(2, timeout=10) == 4
    master.reset()
    assert nodes["misaka1"].acc == 0
    assert nodes["misaka3"].depth == 0
    master.run()
    assert master.compute(10, timeout=10) == 12


def test_load_reprograms_target(add2_cluster):
    """/load dials the target's real gRPC port (the reference dials :8000
    where no node listens, quirk #1, master.go:178)."""
    master, _ = add2_cluster
    master.run()
    assert master.compute(1, timeout=10) == 3
    master.load("misaka2", ADD10_MISAKA2)
    master.run()
    assert master.compute(1, timeout=10) == 12


def test_load_rejects_unknown_node(add2_cluster):
    from misaka_tpu_torch.runtime.topology import TopologyError

    master, _ = add2_cluster
    with pytest.raises(TopologyError, match="not valid on this network"):
        master.load("nobody", "NOP")


def test_load_bad_program_surfaces_error(add2_cluster):
    master, _ = add2_cluster
    with pytest.raises(BroadcastError, match="not a valid instruction"):
        master.load("misaka1", "FROB 3")


def _http_drill(base):
    """The reference's curl workflow (README.md:50-80) plus the stream
    lanes and the control plane's 404s, as (status, body) pairs."""
    out = []

    def post(path, **kw):
        status, body, _ = _request(base, path, **kw)
        out.append((path, status, body))
        return status, body

    post("/run")
    for v in (40, -3, 2**31 + 5):
        post("/compute", data={"value": v})
    post("/compute_batch", data={"values": "1, 2 3"})
    post("/compute_batch", data={"values": "4 5", "spread": "1"})
    post("/compute_raw", raw=np.asarray([10, 11], "<i4").tobytes())
    post("/compute_raw?spread=0", raw=np.asarray([-7], "<i4").tobytes())
    for path in ("/trace", "/debug/isa_trace"):
        status, body, _ = _request(base, path, method="GET")
        out.append((path, status, body))
    post("/checkpoint", data={"name": "x"})
    post("/load", data={"targetURI": "misaka2", "program": "FROB 3"})
    post("/load", data={"targetURI": "nobody", "program": "NOP"})
    post("/pause")
    post("/compute", data={"value": 1})
    post("/reset")
    return out


def test_http_surface(add2_cluster, served):
    """The distributed master behind the port's HTTP surface answers the
    JAX package's distributed master byte for byte, past-int32 value and
    404s of the routes a control plane lacks included."""
    from misaka_tpu.runtime.master import make_http_server as jmake

    master, _ = add2_cluster
    port_out = _http_drill(served(master))
    jmaster, jclose = jnodes.build_loopback_cluster(ADD2_NODES, ADD2_PROGRAMS)
    httpd = jmake(jmaster, 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        jax_out = _http_drill(f"http://127.0.0.1:{httpd.server_address[1]}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        jclose()
    assert port_out == jax_out
    got = {p: (s, b) for p, s, b in port_out}
    assert got["/run"] == (200, b"Success")
    assert json.loads(got["/compute_batch"][1]) == {"values": [6, 7]}
    assert np.frombuffer(got["/compute_raw?spread=0"][1], "<i4").tolist() == [-5]
    assert got["/trace"] == (404, b"not found")
    # the value past int32 crosses the sint32 wire: int32(2**31 + 5) + 2
    assert port_out[3] == ("/compute", 200, b'{"value": -2147483641}\n')
    assert got["/checkpoint"][0] == 403


def test_port_backpressure():
    """Send blocks while the cap-1 port is full (program.go:160-175)."""
    p = ProgramNodeProcess(master_uri="x", grpc_port=0, host="127.0.0.1")
    try:
        port = p.start()
        with ProgramClient(f"127.0.0.1:{port}") as client:
            client.send(1, 0, timeout=5)  # fills r0
            fut = client.send_future(2, 0)  # must block: port full
            time.sleep(0.3)
            assert not fut.done()
            p.load_program("MOV R0, ACC")
            p.run_cmd()
            fut.result(timeout=5)
            assert _wait_for(lambda: p.acc == 2, 5)
    finally:
        p.close()


def test_send_invalid_register_rejected():
    p = ProgramNodeProcess(master_uri="x", grpc_port=0, host="127.0.0.1")
    try:
        port = p.start()
        with ProgramClient(f"127.0.0.1:{port}") as client:
            with pytest.raises(RpcError, match="not a valid register"):
                client.send(1, 7, timeout=5)
    finally:
        p.close()


def test_stack_pop_blocks_until_push():
    s = StackNodeProcess(grpc_port=0, host="127.0.0.1")
    try:
        port = s.start()
        with StackClient(f"127.0.0.1:{port}") as client:
            fut = client.pop_future()
            time.sleep(0.2)
            assert not fut.done()
            client.push(42, timeout=5)
            assert fut.result(timeout=5).value == 42
            client.push(1, timeout=5)
            client.push(2, timeout=5)
            assert client.pop(timeout=5) == 2
            assert client.pop(timeout=5) == 1
    finally:
        s.close()


def test_stack_pop_cancelled_by_reset():
    """A reset cancels a blocked Pop with the reference's message
    (stack.go:150-153), and no leaked consumer swallows the next pushed
    value (quirk #4)."""
    s = StackNodeProcess(grpc_port=0, host="127.0.0.1")
    try:
        port = s.start()
        with StackClient(f"127.0.0.1:{port}") as client:
            fut = client.pop_future()
            time.sleep(0.2)
            client.reset(timeout=5)
            with pytest.raises(Exception, match="stack pop cancelled"):
                fut.result(timeout=5)
            client.push(7, timeout=5)
            assert client.pop(timeout=5) == 7
    finally:
        s.close()


def test_int32_wire_truncation():
    """Cross-node transfers truncate to sint32 as the reference's int32(v)
    casts do (program.go:498, messenger.proto:34-41)."""
    p = ProgramNodeProcess(master_uri="x", grpc_port=0, host="127.0.0.1")
    try:
        port = p.start()
        with ProgramClient(f"127.0.0.1:{port}") as client:
            client.send(2**31 + 5, 0, timeout=5)  # wraps to -2**31+5
            p.load_program("MOV R0, ACC")
            p.run_cmd()
            assert _wait_for(lambda: p.acc != 0, 5)
            assert p.acc == -(2**31) + 5
    finally:
        p.close()


def test_acc_wraps_at_64_bits_locally():
    """acc/bak are Go's 64-bit int (program.go:27-28): local arithmetic
    wraps at 64 bits, as the JAX package's _wrap64 does."""
    for v in (2**63, -(2**63) - 1, 2**64 + 9, -5):
        assert tnodes._wrap64(v) == jnodes._wrap64(v)
    assert tnodes._wrap64(2**63) == -(2**63)


def test_broadcast_error_on_dead_node():
    """Any single node failure fails the whole broadcast (master.go:288-292)."""
    resolver = Resolver()
    resolver.set_addr("ghost", "127.0.0.1:1")  # nothing listens there
    master = MasterNodeProcess(node_info={"ghost": {"type": "program"}}, resolver=resolver,
                               grpc_port=0, host="127.0.0.1")
    try:
        master.start()
        with pytest.raises(BroadcastError):
            master.run()
    finally:
        master.close()


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    """A throwaway EC cert with loopback SANs (the reference's `make cert`
    flow, loopback names instead of compose hostnames)."""
    if shutil.which("openssl") is None:
        pytest.skip("openssl unavailable")
    d = tmp_path_factory.mktemp("certs")
    cert, key = str(d / "service.pem"), str(d / "service.key")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "ec", "-pkeyopt",
         "ec_paramgen_curve:prime256v1", "-nodes", "-keyout", key, "-out", cert,
         "-days", "1", "-subj", "/CN=localhost",
         "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
        check=True, capture_output=True, timeout=60,
    )
    return cert, key


def test_tls_program_node_roundtrip(certs):
    """CERT_FILE/KEY_FILE TLS on the node server, the same cert as the
    client's root CA (program.go:52-55, :98-101)."""
    cert, key = certs
    p = ProgramNodeProcess(master_uri="x", cert_file=cert, key_file=key, grpc_port=0,
                           host="127.0.0.1")
    try:
        port = p.start()
        with ProgramClient(f"127.0.0.1:{port}", cert_file=cert) as client:
            client.send(11, 1, timeout=5)
            p.load_program("MOV R1, ACC")
            p.run_cmd()
            assert _wait_for(lambda: p.acc == 11, 5)
    finally:
        p.close()


def test_tls_rejects_plaintext_client(certs):
    cert, key = certs
    s = StackNodeProcess(cert_file=cert, key_file=key, grpc_port=0, host="127.0.0.1")
    try:
        port = s.start()
        with StackClient(f"127.0.0.1:{port}") as client:  # no cert: plaintext
            with pytest.raises(RpcError):
                client.push(1, timeout=3)
    finally:
        s.close()


def test_port_value_survives_rpc_retry(monkeypatch):
    """A consumed port value survives a transient RPC failure: the hold
    latch keeps it across retries (the reference would re-read the port
    and lose it, program.go:80-92 + :435-472)."""
    monkeypatch.setenv("MISAKA_RPC_BACKOFF_MAX", "0.2")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead_port = s.getsockname()[1]
    s.close()
    resolver = Resolver()
    resolver.set_addr("peer", f"127.0.0.1:{dead_port}")
    p = ProgramNodeProcess(master_uri="x", resolver=resolver, grpc_port=0, host="127.0.0.1")
    peer = None
    try:
        p.load_program("MOV R0, peer:R1")
        port = p.start()
        with ProgramClient(f"127.0.0.1:{port}") as client:
            client.send(123, 0, timeout=5)
        p.run_cmd()
        assert _wait_for(lambda: p._hold == 123, 3)
        time.sleep(0.3)  # the send fails against the dead peer, retried
        assert p._hold == 123  # consumed, latched, not lost
        peer = ProgramNodeProcess(master_uri="x", grpc_port=dead_port, host="127.0.0.1")
        peer.start()
        assert _wait_for(lambda: peer._ports[1].qsize() > 0, 5)
        assert peer._ports[1].get_nowait() == 123  # the retry delivered it
    finally:
        p.close()
        if peer is not None:
            peer.close()


# --- tests/test_tls.py, on the port's nodes ----------------------------------------------


def test_stack_tls_roundtrip(certs):
    cert, key = certs
    node = StackNodeProcess(cert_file=cert, key_file=key, grpc_port=0, host="127.0.0.1")
    try:
        port = node.start()
        with StackClient(f"localhost:{port}", cert_file=cert) as client:
            client.run(timeout=5)
            client.push(41, timeout=5)
            client.push(42, timeout=5)
            assert client.pop(timeout=5) == 42
            assert client.pop(timeout=5) == 41
    finally:
        node.close()


def test_program_tls_load_and_send(certs):
    cert, key = certs
    node = ProgramNodeProcess(master_uri="nowhere", cert_file=cert, key_file=key,
                              grpc_port=0, host="127.0.0.1")
    try:
        port = node.start()
        with ProgramClient(f"localhost:{port}", cert_file=cert) as client:
            client.load("MOV R0, ACC", timeout=5)
            client.run(timeout=5)
            client.send(77, 0, timeout=5)
            assert _wait_for(lambda: node.acc == 77, 5)
    finally:
        node.close()


def test_plaintext_client_rejected_by_tls_server(certs):
    cert, key = certs
    node = StackNodeProcess(cert_file=cert, key_file=key, grpc_port=0, host="127.0.0.1")
    try:
        port = node.start()
        with StackClient(f"localhost:{port}") as client:  # no CA: insecure channel
            with pytest.raises(grpc.RpcError):
                client.push(1, timeout=3)
    finally:
        node.close()


def test_wrong_ca_rejected(certs, tmp_path):
    cert, key = certs
    other_cert, other_key = str(tmp_path / "o.pem"), str(tmp_path / "o.key")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "ec", "-pkeyopt",
         "ec_paramgen_curve:prime256v1", "-nodes", "-keyout", other_key, "-out",
         other_cert, "-days", "1", "-subj", "/CN=localhost",
         "-addext", "subjectAltName=DNS:localhost"],
        check=True, capture_output=True, timeout=60,
    )
    node = StackNodeProcess(cert_file=cert, key_file=key, grpc_port=0, host="127.0.0.1")
    try:
        port = node.start()
        with StackClient(f"localhost:{port}", cert_file=other_cert) as client:
            with pytest.raises(grpc.RpcError):
                client.push(1, timeout=3)
    finally:
        node.close()


def test_tls_mixed_cluster_port_program_jax_stack(certs):
    """Over TLS, a port program node pushes to and pops from a JAX stack
    node with the same cert: the wire and the credentials are the same."""
    cert, key = certs
    stack = jnodes.StackNodeProcess(cert_file=cert, key_file=key, grpc_port=0, host="127.0.0.1")
    resolver = Resolver()
    p = ProgramNodeProcess(master_uri="x", resolver=resolver, cert_file=cert, key_file=key,
                           grpc_port=0, host="127.0.0.1")
    try:
        resolver.set_addr("st", f"localhost:{stack.start()}")
        p.load_program("MOV -9, ACC\nPUSH ACC, st\nMOV 0, ACC\nPOP st, ACC\nSUB 1\nSAV\n"
                       "l: JMP l")
        p.start()
        p.run_cmd()
        assert _wait_for(lambda: p.bak == -10, 5)
    finally:
        p.close()
        stack.close()


# --- chaos: a dead peer (tests/test_chaos.py) and an unreachable master (test_faults.py) --


def test_dead_peer_fails_fast_typed_and_recovers(monkeypatch, served):
    """A downed peer yields PeerUnavailable well inside the deadline (and
    503 over HTTP), /status shows it down, and the cluster recovers with no
    master restart once the peer returns."""
    monkeypatch.setenv("MISAKA_PEER_PROBE_S", "0.2")
    monkeypatch.setenv("MISAKA_PEER_DOWN_AFTER", "2")
    program = "IN ACC\nADD 2\nOUT ACC"
    resolver = Resolver()
    node = ProgramNodeProcess(master_uri="last_order", resolver=resolver, grpc_port=0,
                              host="127.0.0.1")
    master = MasterNodeProcess(node_info={"n": {"type": "program"}}, resolver=resolver,
                               grpc_port=0, host="127.0.0.1")
    replacement = None
    try:
        node.load_program(program)
        port = node.start()
        resolver.set_addr("n", f"127.0.0.1:{port}")
        resolver.set_addr("last_order", f"127.0.0.1:{master.start()}")
        base = served(master)
        master.run()
        assert master.compute(1, timeout=30) == 3
        node.close()  # the peer dies outright
        assert _wait_for(lambda: master.status()["peers"]["n"]["state"] == "down", 10)
        t0 = time.monotonic()
        with pytest.raises(PeerUnavailable):
            master.compute(2, timeout=30)
        assert time.monotonic() - t0 < 5  # typed fast-fail, not a 30 s park
        status, body, _ = _request(base, "/compute", data={"value": 2})
        assert status == 503 and b"peer(s) down" in body
        status, _, _ = _request(base, "/compute_raw", raw=np.asarray([1], "<i4").tobytes())
        assert status == 503
        replacement = ProgramNodeProcess(master_uri="last_order", resolver=resolver,
                                         grpc_port=port, host="127.0.0.1")
        replacement.load_program(program)
        replacement.start()
        replacement.run_cmd()
        assert _wait_for(lambda: master.status()["peers"]["n"]["state"] == "up", 10)
        assert master.compute(10, timeout=30) == 12
    finally:
        master.close()
        node.close()
        if replacement is not None:
            replacement.close()


def test_program_node_survives_unreachable_master():
    """IN against a dead master retries forever instead of killing the node
    (the reference would log.Fatalf on the dial error, program.go:494)."""
    node = ProgramNodeProcess(master_uri="master",
                              resolver=Resolver({"master": "127.0.0.1:1"}),
                              grpc_port=0, host="127.0.0.1")
    try:
        port = node.start()
        node.load_program("IN ACC")
        node.run_cmd()
        time.sleep(0.5)  # the IN keeps failing and retrying the whole time
        with ProgramClient(f"127.0.0.1:{port}") as client:
            client.pause(timeout=5)  # the node is alive and serving RPCs
            client.load("MOV 7, ACC", timeout=5)  # and reprogrammable
            client.run(timeout=5)
        assert _wait_for(lambda: node.acc == 7, 5)
    finally:
        node.close()


# --- observability ---------------------------------------------------------------------


def test_metrics_and_healthz_distributed_mode(served):
    """The distributed control plane serves the shared observability
    surface (reference tests/test_metrics.py:402-433), with the JAX
    package's keys."""
    from misaka_tpu.runtime.master import make_http_server as jmake

    info = {"n1": {"type": "program"}, "s1": {"type": "stack"}}
    master = MasterNodeProcess(node_info=info)
    jmaster = jnodes.MasterNodeProcess(node_info=info)
    jhttpd = jmake(jmaster, port=0)
    threading.Thread(target=jhttpd.serve_forever, daemon=True).start()
    try:
        base = served(master)
        status, body, _ = _request(base, "/healthz", method="GET")
        assert status == 200
        h = json.loads(body)
        assert h["ok"] is True and h["engine"] == "distributed-grpc"
        assert h["running"] is False and h["wire_binary"] is True
        status, body, _ = _request(base, "/metrics", method="GET")
        parsed = metrics.parse_text(body.decode())
        for series in ("misaka_dist_compute_values_total", "misaka_dist_compute_requests_total",
                       "misaka_dist_broadcasts_total", "misaka_stack_push_total",
                       "misaka_program_instructions_total", "misaka_rpc_retries_total"):
            assert any(k.startswith(series) for k in parsed) or series in body.decode(), series
        assert 'misaka_peer_state{peer="n1"}' in parsed
        assert 'misaka_http_requests_total{route="/healthz",method="GET"}' in parsed
        st = json.loads(_request(base, "/status", method="GET")[1])
        jbase = f"http://127.0.0.1:{jhttpd.server_address[1]}"
        jst = json.loads(_request(jbase, "/status", method="GET")[1])
        assert st["served_engine"] == "distributed-grpc"
        assert st["uptime_seconds"] >= 0 and st["requests_total"] == 0
        assert "device_memory" not in st
        for k in ("running", "mode", "served_engine", "requests_total", "nodes", "peers",
                  "in_queue", "out_queue"):
            assert st[k] == jst[k], k
        jh = json.loads(_request(jbase, "/healthz", method="GET")[1])
        assert h["engine"] == jh["engine"] and h["running"] == jh["running"]
    finally:
        jhttpd.shutdown()
        jhttpd.server_close()
        master.close()
        jmaster.close()


def test_distributed_counters_move_with_traffic():
    """Compute traffic moves the control-plane, data-plane and stack
    push/pop counters of this process."""
    before = metrics.parse_text(metrics.render())
    master, close = build_loopback_cluster(ADD2_NODES, ADD2_PROGRAMS)
    try:
        master.run()
        assert master.compute_many([1, 2, 3], timeout=10) == [3, 4, 5]
    finally:
        close()
    d = metrics.delta(before, metrics.parse_text(metrics.render()))
    assert d["misaka_dist_compute_requests_total"] == 1
    assert d["misaka_dist_compute_values_total"] == 3
    assert d["misaka_dist_inputs_total"] == 3 and d["misaka_dist_outputs_total"] == 3
    assert d["misaka_stack_push_total"] == 3 and d["misaka_stack_pop_total"] == 3
    assert d['misaka_dist_broadcasts_total{command="run"}'] == 1
    assert d["misaka_program_instructions_total"] >= 3 * 10


def test_grpc_metadata_propagation_loopback(served):
    """The x-misaka-trace ID crosses the wire (reference
    tests/test_request_trace.py:326-361): the client records an rpc.Run
    span in the request's trace, the peer's interceptor an rpc.recv.Run
    tier event with the same ID."""
    master, close = build_loopback_cluster({"misaka1": "program"},
                                           {"misaka1": "IN ACC\nOUT ACC"})
    tid = "d157d157d157d157"
    try:
        base = served(master)
        status, _, headers = _request(base, "/run", headers={"X-Misaka-Trace": tid})
        assert status == 200 and headers["X-Misaka-Trace"] == tid
        assert _wait_for(lambda: tracespan.RECORDER.get(tid) is not None, 5)
        _, body, _ = _request(base, f"/debug/requests/{tid}", method="GET")
        assert "rpc.Run" in {s["name"] for s in json.loads(body)["spans"]}
        received = [s for s in tracespan.tier_events()
                    if s.name == "rpc.recv.Run" and (s.attrs or {}).get("trace_id") == tid]
        assert received, "the peer never saw the trace metadata"
        master.pause()
    finally:
        close()


# --- the fault points -------------------------------------------------------------------


@pytest.fixture
def armed_faults():
    try:
        yield faults.configure
    finally:
        faults.configure(None)


def test_rpc_drop_fires(armed_faults):
    """rpc_drop fails every armed call with InjectedRpcError, a
    grpc.RpcError the retry paths treat as a network fault, and makes a
    readiness probe report the peer unreachable."""
    s = StackNodeProcess(grpc_port=0, host="127.0.0.1")
    try:
        port = s.start()
        with StackClient(f"127.0.0.1:{port}") as client:
            client.push(5, timeout=5)
            assert client.ready(timeout=5)
            armed_faults("rpc_drop")
            with pytest.raises(grpc.RpcError, match="injected rpc_drop fault on "
                                                    "/grpc.Stack/Push") as exc:
                client.push(6, timeout=5)
            assert isinstance(exc.value, trpc.InjectedRpcError)
            with pytest.raises(trpc.InjectedRpcError):
                client.pop_future()
            assert not client.ready(timeout=5)
            armed_faults(None)
            assert client.pop(timeout=5) == 5  # the dropped push never landed
    finally:
        s.close()


def test_rpc_drop_retried_by_the_execute_loop(armed_faults, monkeypatch):
    """A node's execute loop retries a dropped RPC on the same instruction
    (misaka_rpc_retries_total moves) and delivers once the fault clears."""
    monkeypatch.setenv("MISAKA_RPC_BACKOFF_MAX", "0.1")
    monkeypatch.setenv("MISAKA_PEER_DOWN_AFTER", "100")  # the probes drop too
    before = metrics.parse_text(metrics.render())
    master, close = build_loopback_cluster({"misaka1": "program"},
                                           {"misaka1": "IN ACC\nADD 3\nOUT ACC"})
    try:
        master.run()
        assert master.compute(1, timeout=10) == 4
        armed_faults("rpc_drop")
        out = []
        fut = threading.Thread(target=lambda: out.append(master.compute(2, timeout=10)))
        fut.start()
        assert _wait_for(lambda: metrics.delta(
            before, metrics.parse_text(metrics.render())).get("misaka_rpc_retries_total", 0)
            >= 2, 5)
        assert out == []
        armed_faults(None)
        fut.join(10)
        assert out == [5]
    finally:
        faults.configure(None)
        close()


def test_rpc_delay_fires(armed_faults):
    """rpc_delay sleeps `value` seconds before every armed call."""
    s = StackNodeProcess(grpc_port=0, host="127.0.0.1")
    try:
        port = s.start()
        with StackClient(f"127.0.0.1:{port}") as client:
            client.push(1, timeout=5)  # the channel is up
            t0 = time.monotonic()
            client.push(2, timeout=5)
            quiet = time.monotonic() - t0
            armed_faults("rpc_delay=0.3")
            t0 = time.monotonic()
            client.push(3, timeout=5)
            delayed = time.monotonic() - t0
            assert delayed >= 0.3 > quiet
            armed_faults(None)
            assert [client.pop(timeout=5) for _ in range(3)] == [3, 2, 1]
    finally:
        s.close()


NO_CUDA_PROBE = r"""
import json, sys, threading, urllib.request
sys.path.insert(0, sys.argv[1])
import torch
calls = []
for name in ("_lazy_init", "init", "is_available", "device_count", "current_device",
             "memory_allocated", "memory_reserved", "synchronize", "set_device"):
    orig = getattr(torch.cuda, name)
    def spy(*a, _name=name, _orig=orig, **k):
        calls.append(_name)
        return _orig(*a, **k)
    setattr(torch.cuda, name, spy)
from misaka_tpu_torch.runtime import app
from misaka_tpu_torch.runtime.master import make_http_server
from misaka_tpu_torch.runtime.nodes import build_loopback_cluster
app.check_env({"MISAKA_MODE": "distributed"})
master, close = build_loopback_cluster({"a": "program", "s": "stack"},
                                       {"a": "IN ACC\nPUSH ACC, s\nPOP s, ACC\nOUT ACC"})
httpd = make_http_server(master, 0)
threading.Thread(target=httpd.serve_forever, daemon=True).start()
base = f"http://127.0.0.1:{httpd.server_address[1]}"
try:
    urllib.request.urlopen(urllib.request.Request(base + "/run", data=b"")).read()
    out = urllib.request.urlopen(urllib.request.Request(base + "/compute", data=b"value=4")).read()
    for path in ("/status", "/healthz", "/metrics"):
        urllib.request.urlopen(base + path).read()
finally:
    httpd.shutdown()
    close()
print(json.dumps({"calls": calls, "out": out.decode()}))
"""


def test_distributed_path_never_touches_the_card():
    """The node servers and the distributed master hold no device state:
    booting a cluster, serving it over HTTP and reading /status, /healthz
    and /metrics calls nothing of torch.cuda (no context on a card)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("MISAKA_")}
    env.update(MISAKA_SAMPLER="0", MISAKA_TSDB="0", MISAKA_WATCHDOG="0")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", NO_CUDA_PROBE, root], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["out"].strip() == '{"value": 4}'
    assert report["calls"] == []


# --- the app's NODE_TYPE dispatch (runtime/app.py) --------------------------------------


def test_app_builds_the_distributed_roles(caplog):
    """MISAKA_MODE=distributed builds the control plane over NODE_INFO and
    NODE_ADDRS; NODE_TYPE=program loads PROGRAM, and a program that does
    not parse is logged and leaves NOP (app.go:22-24); an unknown
    NODE_TYPE exits with the reference's message."""
    from misaka_tpu_torch.runtime import app

    env = {"MISAKA_MODE": "distributed", "NODE_ADDRS": json.dumps({"n": "127.0.0.1:9"}),
           "NODE_INFO": json.dumps({"n": {"type": "program"}}), "MISAKA_GRPC_PORT": "0"}
    master = app.build_master_from_env(env)
    try:
        assert isinstance(master, MasterNodeProcess) and master.node_info == {
            "n": {"type": "program"}}
        assert master._resolver.resolve("n") == "127.0.0.1:9"
        assert master._resolver.resolve("m") == "m:0"
    finally:
        master.close()
    with pytest.raises(SystemExit, match="distributed master requires NODE_INFO"):
        app.build_master_from_env({"MISAKA_MODE": "distributed"})
    node = app.build_node_from_env("program", {"PROGRAM": "MOV R0, ACC\nADD 1"})
    assert node._asm == [["MOV_SRC_LOCAL", "R0", "ACC"], ["ADD_VAL", "1"]]
    with caplog.at_level("WARNING"):
        node = app.build_node_from_env("program", {"PROGRAM": "FROB 3"})
    assert node._asm == [["NOP"]] and "Could not load default program" in caplog.text
    assert isinstance(app.build_node_from_env("stack", {}), StackNodeProcess)
    # the reference's main() exits with this text (misaka_tpu/runtime/app.py)
    with pytest.raises(SystemExit, match=r"^'gpu' not a valid node type$"):
        app.check_env({"NODE_TYPE": "gpu"})


def test_app_boots_a_stack_node_process(tmp_path):
    """`python -m misaka_tpu_torch.runtime.app` with NODE_TYPE=stack serves
    the Stack service on MISAKA_GRPC_PORT until SIGTERM."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("MISAKA_", "NODE_"))}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env.update(NODE_TYPE="stack", MISAKA_GRPC_PORT=str(port), MISAKA_ORPHAN_OK="1",
               PYTHONPATH=root + os.pathsep + env.get("PYTHONPATH", ""))
    with open(tmp_path / "stack.log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "misaka_tpu_torch.runtime.app"],
                                cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        with StackClient(f"127.0.0.1:{port}") as client:
            assert client.ready(timeout=60), (tmp_path / "stack.log").read_text()
            client.push(-5, timeout=5)
            client.push(2**31 + 1, timeout=5)
            assert client.pop(timeout=5) == -(2**31) + 1  # the sint32 wire
            assert client.pop(timeout=5) == -5
    finally:
        proc.terminate()
        assert proc.wait(timeout=30) is not None
    assert "stack node serving grpc on :" in (tmp_path / "stack.log").read_text()
