"""The port's MasterNode + HTTP server answer like misaka_tpu's.

One request stream goes to a JAX `MasterNode(engine="scan")` server and to
the port's `MasterNode(device="cpu")` server; every response (status,
content type, body) must be identical: /run, /pause, /reset, /compute,
/compute_raw (striped by default, pinned under `?spread=0`; legacy raw and
the MSK1 binary framing), /compute_batch (pinned and `spread=1`),
/checkpoint and /restore without a checkpoint directory, /load (good and
bad programs), unknown routes and GET /status's shared fields.
examples/multiply.json (two inputs per output) is driven through the Python
API, where both masters must agree on the timeout bookkeeping of a lone
pair.

Two faults of the first slice are pinned here at exact equality: a
/compute_raw with no query must stripe like the JAX master's (it pinned one
instance, which a stateful network answers differently), and a full stack
must grow as the JAX master's does (it wedged the port).
"""

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

from misaka_tpu import networks as jnet
from misaka_tpu.runtime.master import ComputeTimeout as JTimeout
from misaka_tpu.runtime.master import MasterNode as JMaster
from misaka_tpu.runtime.master import make_http_server as j_http
from misaka_tpu.runtime.topology import Topology as JTopology
from misaka_tpu.utils import wire as jwire
from misaka_tpu_torch import networks as tnet
from misaka_tpu_torch.networks import ADD2_PROGRAMS
from misaka_tpu_torch.runtime import app
from misaka_tpu_torch.runtime.master import ComputeTimeout as TTimeout
from misaka_tpu_torch.runtime.master import MasterNode as TMaster
from misaka_tpu_torch.runtime.master import make_http_server as t_http
from misaka_tpu_torch.runtime.topology import Topology as TTopology

# tiny tensors: more intra-op threads would only contend with the other
# test workers
torch.set_num_threads(1)

CAPS = dict(in_cap=8, out_cap=8, stack_cap=8)
MULTIPLY = os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples", "multiply.json")

# per network: a node to reload and its new program
LOADS = {
    "add2": ("misaka1", "IN ACC\nADD 10\nMOV ACC, misaka2:R0\nMOV R0, ACC\nOUT ACC\n"),
    "mesh8": ("a3", "MOV R2, ACC\nADD 7\nOUT ACC\n"),
    "sorter": ("sorter", "IN ACC\nJLZ n\nOUT 1\nJMP e\nn: OUT -1\ne: NOP\n"),
}


def serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def request(base, path, data=b"", headers=None, method="POST"):
    req = urllib.request.Request(base + path, data=data if method == "POST" else None,
                                 headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def form(**fields):
    return urllib.parse.urlencode(fields).encode()


def request_stream(name):
    """(path, body, headers, method) for one full session."""
    rng = np.random.default_rng(len(name))
    raw = rng.integers(-1000, 1000, size=20).astype("<i4")
    raw2 = rng.integers(-1000, 1000, size=9).astype("<i4")
    bin_hdr = {"Content-Type": jwire.CONTENT_TYPE, "Accept": jwire.CONTENT_TYPE}
    target, program = LOADS[name]
    return [
        ("/compute", form(value="1"), None, "POST"),          # not running: 400
        ("/run", b"", None, "POST"),
        ("/run", b"", None, "POST"),                          # already running
        *[("/compute", form(value=str(v)), None, "POST") for v in (5, -3, 0, 999)],
        ("/compute", form(value="abc"), None, "POST"),        # 400
        ("/compute", form(), None, "POST"),                   # 400
        ("/compute_raw?spread=0", raw.tobytes(), None, "POST"),
        ("/compute_raw?spread=0", jwire.pack(raw2.tobytes()), bin_hdr, "POST"),
        ("/compute_raw?spread=0", raw2.tobytes(), {"Accept": jwire.CONTENT_TYPE}, "POST"),
        ("/compute_raw?spread=0", b"\x00" * 16, {"Content-Type": jwire.CONTENT_TYPE}, "POST"),
        ("/compute_raw?spread=0", b"\x01\x02\x03\x04\x05\x06", None, "POST"),
        ("/compute_raw", raw.tobytes(), None, "POST"),                  # striped
        ("/compute_raw?spread=1", jwire.pack(raw2.tobytes()), bin_hdr, "POST"),
        ("/compute_batch", form(values=" ".join(map(str, raw))), None, "POST"),
        ("/compute_batch", form(values="5,-6,7", spread="1"), None, "POST"),
        ("/compute_batch", form(values=""), None, "POST"),
        ("/compute_batch", form(values="5x"), None, "POST"),            # 400
        ("/checkpoint", form(name="c1"), None, "POST"),                 # 403
        ("/restore", form(name="c1"), None, "POST"),                    # 403
        ("/load", form(targetURI="nosuch", program="NOP"), None, "POST"),
        ("/load", form(targetURI=target, program="MOV 1,ACC"), None, "POST"),
        ("/compute", form(value="7"), None, "POST"),          # old program serves
        ("/load", form(targetURI=target, program=program), None, "POST"),
        ("/compute", form(value="7"), None, "POST"),          # paused by /load
        ("/run", b"", None, "POST"),
        *[("/compute", form(value=str(v)), None, "POST") for v in (7, -8)],
        ("/compute_raw?spread=0", raw.tobytes(), None, "POST"),
        ("/pause", b"", None, "POST"),
        ("/compute", form(value="2"), None, "POST"),          # 400
        ("/compute_batch", form(values="2"), None, "POST"),   # 400
        ("/compute_raw", raw2.tobytes(), None, "POST"),       # 400
        ("/run", b"", None, "POST"),
        ("/reset", b"", None, "POST"),
        ("/run", b"", None, "POST"),
        ("/compute", form(value="11"), None, "POST"),
        ("/nosuch", b"", None, "POST"),                       # 404
        ("/compute", None, None, "GET"),                      # 405
    ]


@pytest.mark.parametrize("name", sorted(LOADS))
def test_http_session_matches_jax(name, monkeypatch):
    # the JAX server's process-global daemons (stack sampler, TSDB,
    # watchdog) would outlive this test in the worker process
    for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG"):
        monkeypatch.setenv(switch, "0")
    jm = JMaster(jnet.BASELINE_CONFIGS[name](**CAPS), chunk_steps=32, batch=4, engine="scan")
    tm = TMaster(tnet.BASELINE_CONFIGS[name](**CAPS), chunk_steps=32, batch=4, engine="scan",
                 device="cpu")
    jh, th = j_http(jm, port=0), t_http(tm, port=0)
    jb, tb = serve(jh), serve(th)
    try:
        for path, body, headers, method in request_stream(name):
            want = request(jb, path, body, headers, method)
            got = request(tb, path, body, headers, method)
            assert got == want, (path, body, got, want)
        js = json.loads(request(jb, "/status", method="GET")[2])
        ts = json.loads(request(tb, "/status", method="GET")[2])
        for key in ("running", "nodes", "stack_cap", "batch", "in_queue", "out_queue"):
            assert ts[key] == js[key], key
        assert ts["engine"] == "plain" and ts["device"] == "cpu"
        assert ts["requests_total"] > 0 and ts["tick"] > 0
    finally:
        for h, m in ((jh, jm), (th, tm)):
            h.shutdown()
            h.server_close()
            m.close()


RUNNING_TOTAL = os.path.join(os.path.dirname(MULTIPLY), "running_total.json")
REVERSE_ANY = os.path.join(os.path.dirname(MULTIPLY), "reverse_any.json")


def test_compute_raw_stripes_by_default_like_jax(monkeypatch):
    """running_total keeps a total per instance: one 32-value /compute_raw
    with no query at B=4, in_cap=8 is cut into four 8-value stripes by the
    JAX master (four running totals); a pinned one would be a single
    total over all 32.  Fresh masters, one caller: the stripes land on
    slots 0-3 in order on both."""
    for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG"):
        monkeypatch.setenv(switch, "0")
    with open(RUNNING_TOTAL) as f:
        text = f.read()
    jm = JMaster(JTopology.from_json(text, **CAPS), chunk_steps=32, batch=4, engine="scan")
    tm = TMaster(TTopology.from_json(text, **CAPS), chunk_steps=32, batch=4, device="cpu")
    jh, th = j_http(jm, port=0), t_http(tm, port=0)
    jb, tb = serve(jh), serve(th)
    try:
        jm.run()
        tm.run()
        vals = np.arange(1, 33, dtype="<i4")
        want = request(jb, "/compute_raw", vals.tobytes())
        got = request(tb, "/compute_raw", vals.tobytes())
        assert got == want
        totals = np.concatenate([np.cumsum(part) for part in np.split(vals, 4)])
        assert np.frombuffer(got[2], "<i4").tolist() == totals.tolist()
        # ?spread=0 pins one instance: one total over all 32 values, carried
        # on from the stripe that instance already summed.  Which instance
        # depends on how often the scheduler's workers rotated the start
        # slot, so the check is on the shape of the answer.
        bases = {int(part.sum()) for part in np.split(vals, 4)}
        for base in (jb, tb):
            pinned = np.frombuffer(request(base, "/compute_raw?spread=0", vals.tobytes())[2], "<i4")
            assert int(pinned[0] - vals[0]) in bases
            assert (pinned - pinned[0]).tolist() == (np.cumsum(vals) - vals[0]).tolist()
    finally:
        for h, m in ((jh, jm), (th, tm)):
            h.shutdown()
            h.server_close()
            m.close()


def test_full_stack_grows_like_jax():
    """reverse_any needs stack depth = stream length.  At stack_cap=4 the
    block [1..10, 0] parks its pusher on a full stack: the JAX master doubles
    the capacity (4 -> 8 -> 16) and answers; the port must too."""
    with open(REVERSE_ANY) as f:
        text = f.read()
    caps = dict(in_cap=16, out_cap=16, stack_cap=4)
    jm = JMaster(JTopology.from_json(text, **caps), chunk_steps=32, batch=2, engine="scan")
    tm = TMaster(TTopology.from_json(text, **caps), chunk_steps=32, batch=2, device="cpu")
    jm.run()
    tm.run()
    try:
        block = list(range(1, 11)) + [0]
        want = jm.compute_many(block, timeout=60)
        got = tm.compute_many(block, timeout=60)
        assert got == want == [0] + list(range(10, 0, -1))
        assert tm.status()["stack_cap"] == jm.status()["stack_cap"] == 16
        assert tm._topology.stack_cap == 16
    finally:
        jm.close()
        tm.close()


def test_compute_many_streams_match_jax():
    jm = JMaster(jnet.mesh8(**CAPS), chunk_steps=32, batch=3, engine="scan")
    tm = TMaster(tnet.mesh8(**CAPS), chunk_steps=32, batch=3, device="cpu")
    jm.run()
    tm.run()
    try:
        rng = np.random.default_rng(8)
        for n in (1, 7, 30):
            vals = rng.integers(-500, 500, size=n).astype(np.int32)
            assert tm.compute_many(vals) == jm.compute_many(vals)
        assert tm.compute(41) == jm.compute(41) == 45
    finally:
        jm.close()
        tm.close()


def test_multiply_pairs_timeout_bookkeeping_matches_jax():
    """Two inputs, one output: a compute_many of a pair gets the product and
    times out waiting for a second output, marking it stale; the next
    pair's product is then discarded as that stale output.  Both masters
    keep the same books and say so in the same words."""
    with open(MULTIPLY) as f:
        text = f.read()
    jm = JMaster(JTopology.from_json(text, **CAPS), chunk_steps=32, batch=1, engine="scan")
    tm = TMaster(TTopology.from_json(text, **CAPS), chunk_steps=32, batch=1, device="cpu")
    jm.run()
    tm.run()
    try:
        for (a, b), missing in (((2, 3), 1), ((5, -4), 2)):
            # both masters at once: each call waits out its whole timeout
            errors = {}

            def call(key, master):
                try:
                    master.compute_many([a, b], timeout=4.0)
                except (JTimeout, TTimeout) as e:
                    errors[key] = e

            threads = [threading.Thread(target=call, args=kv) for kv in (("jax", jm), ("port", tm))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=30)
            assert isinstance(errors["jax"], JTimeout) and isinstance(errors["port"], TTimeout)
            assert str(errors["jax"]) == f"no output for {missing}/2 value(s) after 4.0s"
            assert str(errors["port"]) == str(errors["jax"])
    finally:
        jm.close()
        tm.close()


def test_master_rejects_bad_arguments():
    with pytest.raises(ValueError, match="batch"):
        TMaster(tnet.add2(**CAPS), batch=0, device="cpu")


# --- the app entry point ------------------------------------------------------

ADD2_ENV = {
    "NODE_INFO": json.dumps({"misaka1": {"type": "program"}, "misaka2": {"type": "program"},
                             "misaka3": {"type": "stack"}}),
    "MISAKA_PROGRAMS": json.dumps(ADD2_PROGRAMS),
}


@pytest.mark.parametrize(
    "env,match",
    [
        ({}, None),
        ({"MISAKA_BATCH": "0"}, None),
        ({"MISAKA_BATCH": "2", "NODE_TYPE": "stack"}, "not a valid node type"),
    ],
    ids=["no_batch", "zero_batch", "node_type"],
)
def test_app_env_errors(env, match):
    """MISAKA_BATCH unset or 0 is one instance, as the JAX app reads it
    (misaka_tpu/runtime/app.py:838): no error, no `batch` in /status."""
    env = {**ADD2_ENV, **env, "MISAKA_DEVICE": "cpu"}
    if match is None:
        m = app.build_master_from_env(env)
        assert m._batch is None and "batch" not in m.status()
        m.close()
        return
    with pytest.raises(SystemExit, match=match):
        app.build_master_from_env(env)


def test_app_env_builds_the_master(monkeypatch):
    m = app.build_master_from_env({
        **ADD2_ENV, "MISAKA_BATCH": "3", "MISAKA_DEVICE": "cpu", "MISAKA_CHUNK_STEPS": "16",
        "MISAKA_STACK_CAP": "16", "MISAKA_IN_CAP": "8", "MISAKA_OUT_CAP": "8",
    })
    st = m.status()
    # no card: `auto` serves on the host C++ tier (the reference's flip);
    # MISAKA_NATIVE_AUTO=0 keeps the plain version
    assert (st["batch"], st["stack_cap"], st["device"], st["engine"]) == (3, 16, "cpu", "native")
    assert m._chunk == 16 and m._net.in_cap == 8
    m.close()
    m = app.build_master_from_env({**ADD2_ENV, "MISAKA_BATCH": "3", "MISAKA_DEVICE": "cpu"})
    assert m.status()["engine"] == "native"
    m.close()
    monkeypatch.setenv("MISAKA_NATIVE_AUTO", "0")
    m = app.build_master_from_env({**ADD2_ENV, "MISAKA_BATCH": "3", "MISAKA_DEVICE": "cpu"})
    assert m.status()["engine"] == "plain"
    m.close()


def test_app_without_a_card_refuses_to_start():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the app would serve on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.build_master_from_env({**ADD2_ENV, "MISAKA_BATCH": "1"})


def test_app_serves_over_http_as_a_process(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, **ADD2_ENV, "MISAKA_BATCH": "2", "MISAKA_DEVICE": "cpu",
           "MISAKA_CHUNK_STEPS": "32", "MISAKA_IN_CAP": "8", "MISAKA_OUT_CAP": "8",
           "MISAKA_STACK_CAP": "8", "MISAKA_AUTORUN": "1", "MISAKA_PORT": str(port),
           "MISAKA_CHECKPOINT_DIR": str(tmp_path / "ckpt"), "OMP_NUM_THREADS": "1"}
    with open(tmp_path / "app.log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "misaka_tpu_torch.runtime.app"],
                                cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None, (tmp_path / "app.log").read_text()
            try:
                if json.loads(request(base, "/status", method="GET")[2])["running"]:
                    break
            except (urllib.error.URLError, OSError, ValueError):
                pass
            assert time.monotonic() < deadline, "app not serving within 60 s"
            time.sleep(0.2)
        assert request(base, "/compute", form(value="5"))[2] == b'{"value": 7}\n'
        raw = np.arange(-4, 4, dtype="<i4")
        assert request(base, "/compute_raw", raw.tobytes())[2] == (raw + 2).tobytes()
        # MISAKA_CHECKPOINT_DIR arms /checkpoint
        assert request(base, "/checkpoint", form(name="c1"))[::2] == (200, b"Success")
        assert (tmp_path / "ckpt" / "c1.npz").is_file()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
