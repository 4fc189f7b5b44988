"""The port's MisakaClient is the JAX package's client.

Each package's client drives the other package's server (add2, batch 4,
on the CPU), and the same calls give the same results: compute (with its
Server-Timing and trace ID), compute_batch over the negotiated binary
wire and over the text wire, compute_raw in both wires and pinned,
status, healthz, a checkpoint round trip, and the error path's status,
body and trace ID.  The pooled keep-alive connection is reused and a dead
pooled socket reconnects (tests/test_serve_batcher.py's check, on the
port's pair).  `python -m misaka_tpu_torch compute` prints what the JAX
CLI prints.
"""

import io
import socket
import threading
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from misaka_tpu import networks as jnet
from misaka_tpu.__main__ import main as jcli
from misaka_tpu.client import MisakaClient as JClient
from misaka_tpu.client import MisakaClientError as JClientError
from misaka_tpu.runtime.master import MasterNode as JMaster
from misaka_tpu.runtime.master import make_http_server as j_http
from misaka_tpu_torch import networks as tnet
from misaka_tpu_torch.__main__ import main as tcli
from misaka_tpu_torch.client import MisakaClient as TClient
from misaka_tpu_torch.client import MisakaClientError as TClientError
from misaka_tpu_torch.runtime.master import MasterNode as TMaster
from misaka_tpu_torch.runtime.master import make_http_server as t_http

torch.set_num_threads(1)

CAPS = dict(in_cap=8, out_cap=8, stack_cap=8)
SEED = 20261017
TRACE_ID = "c11e47c11e47c11e"


@pytest.fixture(autouse=True)
def _quiet_jax_daemons(monkeypatch):
    for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG", "MISAKA_CANARY"):
        monkeypatch.setenv(switch, "0")


@pytest.fixture
def servers(tmp_path):
    """A JAX and a port server of add2, each with a checkpoint directory."""
    out = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            m = JMaster(jnet.add2(**CAPS), chunk_steps=8, batch=4, engine="scan")
            httpd = j_http(m, port=0, checkpoint_dir=str(tmp_path / "jax"))
        else:
            m = TMaster(tnet.add2(**CAPS), chunk_steps=8, batch=4, device="cpu")
            httpd = t_http(m, port=0, checkpoint_dir=str(tmp_path / "port"))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        out[pkg] = (m, f"http://127.0.0.1:{httpd.server_address[1]}", httpd)
    yield out
    for m, _, httpd in out.values():
        httpd.shutdown()
        httpd.server_close()
        m.close()


def _session(client, errors):
    """One fixed call sequence; returns what each call gave."""
    rng = np.random.default_rng(SEED)
    vals = rng.integers(-2**31, 2**31, size=45, dtype=np.int64).astype(np.int32)
    got = {}
    with pytest.raises(errors) as e:  # not running yet
        client.compute(1)
    got["paused"] = (e.value.status, e.value.body)
    client.run()
    one = client.compute(int(vals[0]))
    got["compute"] = int(one)
    got["compute_phases"] = set(one.timings)
    got["compute_trace"] = bool(one.trace_id)
    got["batch_binary"] = client.compute_batch(vals[:20]).tolist()
    got["wire_binary"] = client._wire_binary
    got["raw_spread"] = client.compute_raw(vals).tolist()
    got["raw_pinned"] = client.compute_raw(vals[:7], spread=False).tolist()
    got["healthz"] = {k: client.healthz()[k] for k in ("ok", "running", "wire_binary")}
    status = client.status()
    got["status"] = (status["running"], status["batch"])
    client.checkpoint("c1")
    before = client.compute(5)
    client.restore("c1")  # leaves the network paused, as the reference
    with pytest.raises(errors) as e:
        client.compute(5)
    got["after_restore"] = (int(before), e.value.status, e.value.body)
    client.run()
    got["restored_compute"] = int(client.compute(6))
    with pytest.raises(errors) as e:
        client.checkpoint("../escape")
    got["bad_name"] = (e.value.status, e.value.body)
    client.pause()
    return got


@pytest.mark.parametrize("client_pkg,server_pkg", [("port", "jax"), ("jax", "port")],
                         ids=["port_client-jax_server", "jax_client-port_server"])
def test_client_session_crosses_packages(servers, client_pkg, server_pkg):
    cls, err = (TClient, TClientError) if client_pkg == "port" else (JClient, JClientError)
    twin, twin_err = (JClient, JClientError) if client_pkg == "port" else (TClient, TClientError)
    _, url, _ = servers[server_pkg]
    _, twin_url, _ = servers["port" if server_pkg == "jax" else "jax"]
    with cls(url, timeout=30) as client, twin(twin_url, timeout=30) as ref:
        got = _session(client, err)
        want = _session(ref, twin_err)
    assert got == want
    vals = np.random.default_rng(SEED).integers(-2**31, 2**31, size=45,
                                                dtype=np.int64).astype(np.int32)
    assert got["raw_spread"] == (vals.astype(np.int64) + 2).astype(np.int32).tolist()
    assert got["wire_binary"] is True and {"queue", "pass", "total"} <= got["compute_phases"]


@pytest.mark.parametrize("client_cls", [TClient, JClient], ids=["port_client", "jax_client"])
def test_text_wire_latched_and_error_trace_id(servers, client_cls):
    """wire="text" keeps the decimal /compute_batch and headerless raw
    lanes; the error path carries the server's trace ID."""
    results = {}
    for pkg in ("jax", "port"):
        m, url, _ = servers[pkg]
        m.run()
        with client_cls(url, timeout=30, wire="text") as client:
            vals = np.arange(-6, 7, dtype=np.int32)
            results[pkg] = (client.compute_batch(vals).tolist(),
                            client.compute_batch(vals, spread=False).tolist(),
                            client.compute_raw(vals).tolist(), client._wire_binary)
            m.pause()
            with pytest.raises((TClientError, JClientError)) as e:
                client._request_full("/compute", b"value=1", "POST",
                                     extra_headers={"X-Misaka-Trace": TRACE_ID})
            results[pkg] += (e.value.status, e.value.body, e.value.trace_id, str(e.value))
    assert results["port"] == results["jax"]
    assert results["port"][0] == list(range(-4, 9)) and results["port"][3] is False
    assert results["port"][4:7] == (400, "network is not running", TRACE_ID)


def test_client_pools_and_reconnects(servers):
    m, url, _ = servers["port"]
    m.run()
    client = TClient(url, timeout=15)
    assert client.compute(1) == 3
    assert len(client._pool) == 1  # the connection went back to the pool
    pooled = client._pool[0]
    assert client.compute(2) == 4
    assert client._pool[0] is pooled  # and was reused
    # a dead pooled socket reconnects cleanly (a shutdown gives the shape a
    # server-side drop gives)
    pooled.sock.shutdown(socket.SHUT_RDWR)
    assert client.compute(3) == 5
    out = client.compute_raw(np.arange(16, dtype=np.int32))
    np.testing.assert_array_equal(out, np.arange(16) + 2)
    client.close()
    assert client._pool == []


def test_cli_compute_prints_what_the_jax_cli_prints(servers):
    outs = {}
    for pkg, cli in (("jax", jcli), ("port", tcli)):
        m, url, _ = servers[pkg]
        m.run()
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = cli(["compute", "5", "-3", "--url", url])
        outs[pkg] = (rc, buf.getvalue())
    assert outs["port"] == outs["jax"] == (0, '{"value": 7}\n{"value": -1}\n')


def test_cli_compute_reports_a_paused_server_like_the_jax_cli(servers, capsys):
    outs = {}
    for pkg, cli in (("jax", jcli), ("port", tcli)):
        _, url, _ = servers[pkg]
        rc = cli(["compute", "5", "--url", url])
        cap = capsys.readouterr()
        outs[pkg] = (rc, cap.out, cap.err)
    assert outs["port"] == outs["jax"] == (1, "", "error: network is not running\n")
