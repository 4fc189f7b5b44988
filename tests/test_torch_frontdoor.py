"""The port's lean host front: the fast request parser and the lifecycle
guards.

utils/httpfast.py: the port's copy parses what the reference's parses into
the same fields, and both servers answer the same raw requests the same
way with MISAKA_FAST_HTTP on and off (keep-alive, HTTP/1.0, 100-continue,
an over-long request line or header, too many headers, a missing or
oversized Content-Length); the fast parser's mark feeds the `http.parse`
span, which the stock parser does not record.

runtime/lifecycle.py, through `python -m misaka_tpu_torch.runtime.app` in a
subprocess (the reference's tests/test_lifecycle.py cases): MISAKA_TTL_S
exits 0, SIGTERM exits 0 and removes the pidfile, SIGINT exits 130, a
server whose launcher dies exits (the orphan watchdog), and
MISAKA_ORPHAN_OK=1 keeps it.
"""

import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from misaka_tpu import networks as jnet
from misaka_tpu.runtime.master import MasterNode as JMaster
from misaka_tpu.runtime.master import make_http_server as j_http
from misaka_tpu.utils import httpfast as jhttpfast
from misaka_tpu_torch import networks as tnet
from misaka_tpu_torch.networks import ADD2_PROGRAMS
from misaka_tpu_torch.runtime.master import MasterNode as TMaster
from misaka_tpu_torch.runtime.master import make_http_server as t_http
from misaka_tpu_torch.utils import httpfast

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPS = dict(in_cap=8, out_cap=8, stack_cap=8)


# --- the fast parser ------------------------------------------------------------------


class _FakeHandler:
    """What fast_parse_request reads and writes on a request handler."""

    def __init__(self, raw: bytes):
        line, _, rest = raw.partition(b"\r\n")
        self.raw_requestline = line + b"\r\n"
        self.rfile = io.BytesIO(rest)
        self.sent = []

    def send_error(self, code, msg):
        self.sent.append((code, msg))

    def send_response_only(self, code):
        self.sent.append((code, None))

    def end_headers(self):
        pass


PARSE_CASES = {
    "keepalive": b"POST /compute HTTP/1.1\r\nHost: x\r\nContent-Length: 7\r\n\r\nvalue=3",
    "close": b"GET /status HTTP/1.1\r\nConnection: close\r\nX-Misaka-Trace: abcd\r\n\r\n",
    "http10": b"GET /status HTTP/1.0\r\n\r\n",
    "http10_keepalive": b"GET /status HTTP/1.0\r\nConnection: keep-alive\r\n\r\n",
    "expect": b"POST /compute HTTP/1.1\r\nExpect: 100-continue\r\nContent-Length: 7\r\n\r\n",
    "junk_line": b"GET / HTTP/1.1\r\nnot a header\r\nA:  b \r\n\r\n",
    "http09": b"GET /\r\n\r\n",
    "bad_version": b"GET / HTTP/2.0\r\n\r\n",
    "long_header": b"GET / HTTP/1.1\r\nX: " + b"a" * 70000 + b"\r\n\r\n",
    "many_headers": b"GET / HTTP/1.1\r\n" + b"".join(
        b"H%d: v\r\n" % i for i in range(101)) + b"\r\n",
}


@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_fast_parse_matches_the_reference(case):
    got, want = _FakeHandler(PARSE_CASES[case]), _FakeHandler(PARSE_CASES[case])
    r_got = httpfast.fast_parse_request(got)
    r_want = jhttpfast.fast_parse_request(want)
    assert r_got == r_want
    assert got.sent == want.sent
    for attr in ("command", "path", "request_version", "close_connection", "requestline"):
        assert getattr(got, attr, None) == getattr(want, attr, None), attr
    if r_got:
        assert dict(got.headers.items()) == dict(want.headers.items())
        assert got.headers.get("HOST") == got.headers.get("host")


def _raw_exchange(port, data: bytes, reads: int = 1) -> list[bytes]:
    """Send raw bytes; return the status lines of up to `reads` responses
    (b"" when the server closed without one)."""
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(data)
        f = s.makefile("rb")
        out = []
        for _ in range(reads):
            line = f.readline()
            out.append(line.strip())
            if not line:
                break
            length = 0
            while True:
                h = f.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.partition(b":")
                if k.strip().lower() == b"content-length":
                    length = int(v)
            f.read(length)
        return out


RAW_CASES = {
    "keepalive_pair": (b"POST /compute HTTP/1.1\r\nContent-Length: 7\r\n\r\nvalue=3"
                       b"GET /healthz HTTP/1.1\r\nConnection: close\r\n\r\n", 2),
    "http10": (b"POST /compute HTTP/1.0\r\nContent-Length: 7\r\n\r\nvalue=4", 1),
    "expect_100": (b"POST /compute HTTP/1.1\r\nExpect: 100-continue\r\n"
                   b"Content-Length: 7\r\nConnection: close\r\n\r\nvalue=5", 2),
    "long_request_line": (b"GET /" + b"a" * 70000 + b" HTTP/1.1\r\n\r\n", 1),
    "long_header": (b"GET /healthz HTTP/1.1\r\nX: " + b"a" * 70000 + b"\r\n\r\n", 1),
    "many_headers": (b"GET /healthz HTTP/1.1\r\n" + b"".join(
        b"H%d: v\r\n" % i for i in range(101)) + b"\r\n", 1),
    "no_length_raw": (b"POST /compute_raw HTTP/1.1\r\nConnection: close\r\n\r\n", 1),
    "oversized_raw": (b"POST /compute_raw HTTP/1.1\r\nContent-Length: 1000\r\n"
                      b"Connection: close\r\n\r\n", 1),
}


@pytest.mark.parametrize("fast", ["1", "0"], ids=["fast", "stock"])
def test_raw_requests_answer_like_the_reference(fast, monkeypatch):
    for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG"):
        monkeypatch.setenv(switch, "0")
    monkeypatch.setenv("MISAKA_FAST_HTTP", fast)
    monkeypatch.setenv("MISAKA_MAX_BODY", "64")
    jm = JMaster(jnet.add2(**CAPS), chunk_steps=8, batch=2, engine="scan")
    tm = TMaster(tnet.add2(**CAPS), chunk_steps=8, batch=2, device="cpu")
    jh, th = j_http(jm, port=0), t_http(tm, port=0)
    for h in (jh, th):
        threading.Thread(target=h.serve_forever, daemon=True).start()
    try:
        jm.run()
        tm.run()
        for name, (data, reads) in RAW_CASES.items():
            got = _raw_exchange(th.server_address[1], data, reads)
            want = _raw_exchange(jh.server_address[1], data, reads)
            assert got == want, (name, got, want)
        # the fast parser's mark is the http.parse span; the stock parser
        # records none, in both packages
        for h in (jh, th):
            tid = f"fa57{fast}0000{h.server_address[1]}"
            req = urllib.request.Request(f"http://127.0.0.1:{h.server_address[1]}/compute",
                                         data=b"value=1", headers={"X-Misaka-Trace": tid})
            urllib.request.urlopen(req, timeout=30).read()
            # the trace is recorded after the response is sent: retry
            deadline = time.monotonic() + 30
            while True:
                try:
                    doc = json.loads(urllib.request.urlopen(
                        f"http://127.0.0.1:{h.server_address[1]}/debug/requests/{tid}",
                        timeout=30).read())
                    break
                except urllib.error.HTTPError:
                    assert time.monotonic() < deadline, tid
                    time.sleep(0.05)
            assert ("http.parse" in {s["name"] for s in doc["spans"]}) == (fast == "1")
    finally:
        for h, m in ((jh, jm), (th, tm)):
            h.shutdown()
            h.server_close()
            m.close()


# --- the lifecycle guards ---------------------------------------------------------------


def _env(**extra):
    env = dict(os.environ)
    env.update(
        NODE_INFO=json.dumps({"misaka1": {"type": "program"}, "misaka2": {"type": "program"},
                              "misaka3": {"type": "stack"}}),
        MISAKA_PROGRAMS=json.dumps(ADD2_PROGRAMS), MISAKA_PORT="0", MISAKA_DEVICE="cpu",
        OMP_NUM_THREADS="1", PYTHONPATH=ROOT,
    )
    env.update(extra)
    return env


def _spawn(**extra):
    return subprocess.Popen([sys.executable, "-m", "misaka_tpu_torch.runtime.app"], cwd=ROOT,
                            env=_env(**extra), stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)


def _wait_gone(proc_or_pid, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if isinstance(proc_or_pid, subprocess.Popen):
            if proc_or_pid.poll() is not None:
                return True
        else:
            try:
                os.kill(proc_or_pid, 0)
            except OSError:
                return True
        time.sleep(0.25)
    return False


def _wait_serving(proc, timeout=60.0):
    """Read the app's log until it says it serves (its guards are armed)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stderr.readline()
        if not line:
            break
        if "serving on :" in line:
            return
    raise AssertionError("the app did not start serving")


def test_ttl_deadline_exits():
    proc = _spawn(MISAKA_TTL_S="2", MISAKA_PIDFILE="off")
    try:
        assert _wait_gone(proc), "server ignored MISAKA_TTL_S"
        assert proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()


@pytest.mark.parametrize("sig,code", [(signal.SIGTERM, 0), (signal.SIGINT, 130)],
                         ids=["sigterm", "sigint"])
def test_signal_exits_clean_and_removes_the_pidfile(tmp_path, sig, code):
    pidfile = tmp_path / "app.pid"
    proc = _spawn(MISAKA_PIDFILE=str(pidfile), MISAKA_AUTORUN="1")
    try:
        _wait_serving(proc)
        assert pidfile.read_text().strip() == str(proc.pid)
        proc.send_signal(sig)
        assert _wait_gone(proc, 30), "server survived the signal"
        assert proc.returncode == code
        assert not pidfile.exists()
    finally:
        if proc.poll() is None:
            proc.kill()


def _launch_and_die(**extra):
    launcher = (
        "import subprocess, sys, time\n"
        "p = subprocess.Popen([sys.executable, '-m', 'misaka_tpu_torch.runtime.app'],"
        " stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)\n"
        "print(p.pid, flush=True)\n"
        "time.sleep(1.0)\n"
    )
    out = subprocess.run([sys.executable, "-c", launcher], cwd=ROOT,
                         env=_env(MISAKA_PIDFILE="off", **extra), capture_output=True,
                         text=True, timeout=60)
    return int(out.stdout.strip())


def test_orphan_watchdog_exits():
    """A server whose launcher dies must die with it."""
    pid = _launch_and_die()
    try:
        assert _wait_gone(pid), f"orphaned server pid {pid} kept running"
    finally:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass


def test_orphan_ok_optout():
    """MISAKA_ORPHAN_OK=1 keeps a deliberately daemonized server alive."""
    pid = _launch_and_die(MISAKA_ORPHAN_OK="1", MISAKA_TTL_S="30")
    try:
        # alive past several watchdog polls (every 2 s)
        assert not _wait_gone(pid, timeout=6.0), "daemonized server died early"
    finally:
        try:
            os.kill(pid, signal.SIGTERM)
        except OSError:
            pass
