"""HTTP frontend workers and the engine compute plane: the multi-process
serving tier.

The port of misaka_tpu/runtime/frontends.py.  One CPython process serves
HTTP requests one interpreter slice at a time; under many small requests
the handler threads and the device loop wait for each other.  This tier
scales the per-request work across processes and keeps the engine's work
per frame:

    clients --HTTP/1.1 keep-alive--> N frontend processes (SO_REUSEPORT,
                                     one public port, kernel-balanced)
        each frontend coalesces its concurrent requests locally
                    |  persistent unix-socket connections carrying
                    v  fused frames (length-prefixed raw int32)
              engine process --ServeBatcher--> device loop (the kernel)

A frontend answers the hot compute routes (POST /compute, POST
/compute_raw with spread) from the plane and proxies every other route,
`?spread=0` and bulk bodies included, to the engine's own HTTP server, so
the public port speaks the whole surface.

The frame codec, the handshake, shared-memory arming, pipelining, the
drain status and the probe are byte for byte the reference's: the two
packages' PlaneClient and ComputePlane talk to each other.  The engine
runs the edge chain (runtime/edge.py) once per frame on the frame's API
key and request count, and books the shed counts a worker ships in its
frames (the worker's shed cache answers a tenant inside an engine-issued
Retry-After without a round trip).  With a program registry
(runtime/registry.py) each frame resolves its engine through a registry
lease on the frame's program (the seeded default when it names none); an
unknown program is the typed 404, and without a registry a frame that
names a program gets the reference's 404.  The telemetry planes ride the
frames as in the reference: while the SLO engine is armed (or a programs
dir is set) a worker ships one edge timestamp per request, and the engine
observes each request's latency from the moment the worker took it
(utils/slo.py); while the recorder runs, the engine cuts one "plane"
capture record per frame and ingests the workers' locally terminated
rejects, which ride the next frame (runtime/capture.py); and the chaos
points plane_partition, plane_delay, replica_blackhole and worker_exit
fire at the reference's sites (utils/faults.py).

The fleet (runtime/fleet.py): a comma-separated plane path makes a worker
route across N engine replicas through `FleetPlaneRouter` (least queue
depth for stateless compute, the program's consistent-hash owner for
addressed compute, a failed frame hedged onto a sibling, drain reroutes
absorbed, the typed 503 only when the whole fleet stays down past
MISAKA_FLEET_DOWN_GRACE_S).  A TCP plane (`host:port`) is wrapped in
mutual TLS when MISAKA_PLANE_TLS_CERT/KEY/CA are set (runtime/edge.py
`PlaneTLSReloader`), the HMAC handshake running inside the session; a
peer refused at the gate is a typed, counted close.  One thread reads an
mTLS socket and writes to it go through one lock (or one thread), never
two at once.

The native edge (`NativeFrontendSupervisor`, the reference's r19 tier):
the port's copy of the reference's C++ epoll frontend
(csrc/native/frontend.cpp with msk_http.hpp and msk_frame.hpp, built by
utils/nativelib.py) takes the public port in the engine's own process,
terminates HTTP/1.1 keep-alive and the MSK1 binary wire with no GIL on
the data path, ships the hot compute routes straight over the plane, and
proxies everything else to the CPython workers.  Python stays the control
plane: a watcher pushes the edge chain's key digests and burst caps, the
registry's programs, the tracing, SLO and capture flags and the engine's
/healthz body into C++, and pumps the tier's counters, spans and capture
rows back out.

This module imports the standard library and the port's stdlib-only
modules only: a frontend worker never pays the torch import or its memory.
"""

from __future__ import annotations

import ctypes
import http.client
import json
import logging
import os
import re
import signal
import socket
import ssl
import struct
import subprocess
import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlsplit

from misaka_tpu_torch.runtime import capture as capture_mod
from misaka_tpu_torch.runtime import edge as edge_mod
from misaka_tpu_torch.utils import faults, metrics, slo, tracespan, wire
from misaka_tpu_torch.utils.backoff import Backoff
from misaka_tpu_torch.utils.httpfast import fast_parse_request
from misaka_tpu_torch.utils.nativelib import NativeLib

log = logging.getLogger("misaka_tpu_torch.frontends")

M_FE_RESTARTS = metrics.counter(
    "misaka_frontend_restarts_total",
    "Frontend worker processes respawned by the supervisor",
)
M_FE_ALIVE = metrics.gauge(
    "misaka_frontend_workers_alive",
    "Frontend worker processes currently alive (live supervisor)",
)
M_FE_CONFIGURED = metrics.gauge(
    "misaka_frontend_workers_configured",
    "Frontend worker processes the pool is configured for (live supervisor)",
)
M_PLANE_FRAMES = metrics.counter(
    "misaka_plane_frames_total",
    "Compute-plane frames served by this engine replica",
)
M_PLANE_HEDGED = metrics.counter(
    "misaka_plane_hedged_requests_total",
    "Requests served here after being hedged away from a failed sibling "
    "replica (fleet router failover)",
)
M_PLANE_DRAIN_REROUTES = metrics.counter(
    "misaka_plane_drain_reroutes_total",
    "Compute-plane frames answered with the drain reroute status "
    "(the fleet router re-dispatches them to a sibling)",
)
M_PLANE_PIPELINED = metrics.counter(
    "misaka_plane_pipelined_frames_total",
    "Compute frames accepted while an earlier frame from the same plane "
    "connection was still in flight (MISAKA_PLANE_PIPELINE > 1) — zero "
    "under load means the plane is running single-outstanding-frame",
)
M_PLANE_SHM_FRAMES = metrics.counter(
    "misaka_plane_shm_frames_total",
    "Compute-plane frames whose payload rode a shared-memory segment "
    "instead of the socket (MISAKA_PLANE_SHM=1) — zero here with the "
    "flag set means the zero-copy plane silently fell back to sockets",
)
M_PLANE_PIPE_DEPTH = metrics.histogram(
    "misaka_plane_pipeline_depth",
    "In-flight frames on one compute-plane connection at frame dispatch "
    "(1 = no overlap; MISAKA_PLANE_PIPELINE bounds it)",
)


class _DepthWindow:
    """Max pipeline depth over a rolling ~5 s window: two rotating buckets,
    so the reported max covers the last 5-10 s and every scraper inside
    the window sees a spike."""

    def __init__(self, window_s: float = 5.0):
        self._lock = threading.Lock()
        self._window_s = window_s
        self._t0 = 0.0
        self._cur = 0
        self._prev = 0

    def note(self, depth: int) -> None:
        now = time.monotonic()
        with self._lock:
            if now - self._t0 >= self._window_s:
                self._prev, self._cur = self._cur, 0
                self._t0 = now
            if depth > self._cur:
                self._cur = depth

    def read(self) -> float:
        now = time.monotonic()
        with self._lock:
            if now - self._t0 >= 2 * self._window_s:
                return 0.0
            if now - self._t0 >= self._window_s:
                return float(self._cur)
            return float(max(self._cur, self._prev))


_PIPE_DEPTH_WINDOW = _DepthWindow()
G_PLANE_PIPE_DEPTH = metrics.gauge(
    "misaka_plane_pipeline_depth_max",
    "Deepest per-connection frame overlap observed on the compute plane "
    "in the last ~5s (0 = no pipelined traffic)",
)
G_PLANE_PIPE_DEPTH.set_function(_PIPE_DEPTH_WINDOW.read)

# The compute-plane wire format (a SOCK_STREAM: a unix socket path, or
# `host:port` for TCP, parse_plane_addr, in mTLS when
# MISAKA_PLANE_TLS_CERT/KEY/CA are set):
#   request:  <I n_values> <I n_meta_bytes>
#             <n_values * 4 bytes little-endian int32>
#             <n_meta_bytes of UTF-8 JSON metadata; absent (0) when the
#              frame carries one untraced request of the default program>
#   response: <i status> <I length> <payload>
#     status == 200 -> payload is length*4 bytes of int32 outputs
#     otherwise     -> payload is `length` bytes of utf-8 error body, and
#                      status is the HTTP code the frontend answers
# With MISAKA_PLANE_SECRET set, every connection opens with the 32-byte
# HMAC handshake (runtime/edge.py) before its first frame.  The metadata
# is a JSON object {"program": name-or-null, "traces": [...], "key": ...,
# "reqs": n, "shed": [[tenant, reason, count], ...], "hedged": k}; `hedged`
# counts the frame's requests a fleet router re-routed here after a
# sibling failed them (misaka_plane_hedged_requests_total); each traces entry
# covers one traced request of the frame:
# {"id", "off", "len", "spans": [[name, start_monotonic_s, dur_s], ...]},
# the spans the frontend completed (http.parse, frontend.coalesce), so the
# engine-side trace tells the cross-process story (CLOCK_MONOTONIC is
# host-wide).
_REQ_HDR = struct.Struct("<II")
_RESP_HDR = struct.Struct("<iI")

# Plane-private status of a draining engine (a fleet router re-dispatches
# the frame; a single-engine PlaneClient maps it to 503).  A frame whose
# metadata carries {"probe": 1} is a zero-value health probe answered
# 200 or PLANE_DRAINING without touching the engine.
PLANE_DRAINING = 599

# Plane-private ack of a shared-memory arming frame (MISAKA_PLANE_SHM=1):
# not 200, so a client can tell an engine that maps its segment from one
# that answered the arming frame as an empty compute.
PLANE_SHM_OK = 298

# One frame's value budget: a frontend's whole in-hand backlog ships at
# once, and engine-side buffering stays bounded.
MAX_FRAME_VALUES = 1 << 20

_PROGRAM_COMPUTE_RE = re.compile(r"^/programs/([^/]+)/(compute|compute_batch|compute_raw)$")


def plane_shm_enabled() -> bool:
    """MISAKA_PLANE_SHM=1: one shared-memory segment per plane connection
    carries the frame payloads; header and metadata stay on the socket."""
    return os.environ.get("MISAKA_PLANE_SHM", "0") == "1"


def _attach_shm(name: str, size: int):
    """Engine-side attach to a frontend-owned segment.  The resource
    tracker forgets it at once: the frontend owns the segment's lifetime,
    and the tracker would otherwise unlink it (and warn) when this process
    exits."""
    from multiprocessing import resource_tracker, shared_memory

    seg = shared_memory.SharedMemory(name=name)
    try:
        resource_tracker.unregister(seg._name, "shared_memory")
    except Exception:
        pass  # tracker internals shifted: worst case is an exit warning
    if seg.size < 2 * size:
        seg.close()
        raise ValueError(f"segment {name} is {seg.size} bytes; arming promised {2 * size}")
    return seg


def parse_plane_addr(path: str) -> tuple[str, str, int | None]:
    """One plane address -> ("tcp", host, port) | ("unix", path, None): a
    `host:port` (a ':' and no '/') is a TCP plane, anything else a unix
    socket path."""
    if ":" in path and "/" not in path:
        host, _, port_s = path.rpartition(":")
        try:
            return "tcp", host or "127.0.0.1", int(port_s)
        except ValueError:
            pass
    return "unix", path, None


def _classify_tls_reject(e: BaseException) -> str:
    """A failed plane-TLS handshake's typed close reason: "plaintext" (a
    peer speaking raw frames or HTTP at a TLS listener), "bad_cert" (a
    certificate outside the pinned CA, or none), else "handshake"."""
    s = str(e).upper()
    if "CERTIFICATE" in s or "UNKNOWN_CA" in s or "ALERT" in s:
        return "bad_cert"
    if ("WRONG_VERSION" in s or "UNKNOWN_PROTOCOL" in s or "HTTP_REQUEST" in s
            or "RECORD" in s or "PACKET_LENGTH" in s):
        return "plaintext"
    return "handshake"


def _shutdown_socket(sock) -> None:
    """Wake the thread reading `sock` with EOF; that thread closes it.
    A socket is closed only by its reader: closed under a reader, its
    descriptor can be reused by a new connection while the reader's TLS
    session still polls and reads that number (the new connection's bytes
    then go to the old session)."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly n bytes or raise ConnectionError."""
    parts = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("compute plane connection closed")
        parts.append(chunk)
        n -= len(chunk)
    return b"".join(parts)


# --- engine side ----------------------------------------------------------------


class _BadMeta(Exception):
    """A frame's metadata failed to decode: it may name a program, so the
    frame fails rather than serving the default network."""


class _Meta:
    """One compute frame's decoded metadata."""

    __slots__ = ("program", "key", "reqs", "shed", "traces", "probe", "shm_arm", "shm_vals",
                 "shm_seg", "edge", "cap", "hedged")

    def __init__(self):
        self.program = None
        self.key = None        # the frame's API key (frames pack per tenant)
        self.reqs = 1          # client requests the frame fused
        self.shed = []         # worker-local shed counts: [[tenant, reason, n], ...]
        self.traces = []
        self.probe = False
        self.shm_arm = None    # {name, size}: a shared-memory arming request
        self.shm_vals = None   # the payload's count when it rides the segment
        self.shm_seg = None    # (segment, size) of an inline shm frame
        self.edge = []         # per-request worker receive times (SLO armed)
        self.cap = None        # {"segs", "rej"} while the recorder runs
        self.hedged = 0        # requests re-routed here after a sibling failed them


def _parse_meta(blob: bytes) -> _Meta:
    """A frame's metadata.  The program address, the key's type and the
    shared-memory fields are fatal when malformed (guessing would compute
    the wrong network or on the wrong bytes); trace segments are rebuilt
    only while tracing is on, and a malformed one is dropped."""
    if not blob:
        return _Meta()
    try:
        obj = json.loads(blob.decode())
        meta = _Meta()
        edge_raw = ()
        if isinstance(obj, dict):
            meta.program = obj.get("program") or None
            key = obj.get("key") or None
            segs = obj.get("traces", ())
            edge_raw = obj.get("edge", ())
            meta.probe = bool(obj.get("probe"))
            meta.hedged = int(obj.get("hedged") or 0)
            meta.reqs = max(1, int(obj.get("reqs") or 1))
            meta.shed = obj.get("shed") or []
            if obj.get("shm") is not None:
                arm = obj["shm"]
                if not (isinstance(arm, dict) and isinstance(arm.get("name"), str)
                        and isinstance(arm.get("size"), int) and arm["size"] > 0):
                    raise ValueError("shm arming must carry {name: str, size: int > 0}")
                meta.shm_arm = arm
            if obj.get("shm_vals") is not None:
                meta.shm_vals = int(obj["shm_vals"])
                if meta.shm_vals < 0:
                    raise ValueError("shm_vals must be >= 0")
        elif isinstance(obj, list):  # the traces-only list form
            key, segs = None, obj
        else:
            raise ValueError("metadata must be an object or list")
        if meta.program is not None and not isinstance(meta.program, str):
            raise ValueError("program must be a string")
        if key is not None and not isinstance(key, str):
            # guessing "no key" would bill an authentication failure to
            # the anonymous tenant's quota
            raise ValueError("key must be a string")
        meta.key = key
    except (ValueError, TypeError, UnicodeDecodeError, KeyError) as e:
        raise _BadMeta(str(e)) from e
    if tracespan.enabled():
        try:
            for seg in segs:
                tr = tracespan.begin(seg.get("id"), route="/compute_raw", activate=False)
                if tr is None:
                    continue
                for name, start, dur in seg.get("spans", ()):
                    tracespan.add_span(tr, str(name), float(start), float(dur))
                meta.traces.append(tr)
        except (ValueError, TypeError, KeyError, AttributeError):
            log.debug("dropping malformed plane trace metadata")
    if slo.armed():
        try:
            meta.edge = [float(t0) for t0 in edge_raw]
        except (ValueError, TypeError):
            log.debug("dropping malformed plane edge metadata")
    if capture_mod.RECORDING:
        try:
            meta.cap = {
                "segs": [{"id": tracespan.sanitize_id(s.get("id")), "in": bool(s.get("in")),
                          "off": int(s.get("off", 0)), "len": int(s.get("len", 0))}
                         for s in segs if isinstance(s, dict)],
                "rej": (obj.get("caprej") or []) if isinstance(obj, dict) else [],
            }
        except (ValueError, TypeError, AttributeError):
            log.debug("dropping malformed plane capture metadata")
    return meta


def _plane_partitioned(path: str) -> bool:
    """The plane_partition chaos point: bare it black-holes every plane,
    `plane_partition:<substr>` only the planes whose address holds it."""
    if faults.fire("plane_partition") is not None:
        return True
    for point in faults.active():
        if point.startswith("plane_partition:") and point[len("plane_partition:"):] in path:
            return faults.fire(point) is not None
    return False


class ComputePlane:
    """The engine-side listener serving fused compute frames.

    One daemon thread per frontend connection reads a frame, runs it
    through `master.compute_coalesced` (one scheduler submission for the
    whole frame: the frontend already coalesced its requests) and writes
    the outputs back.  Up to MISAKA_PLANE_PIPELINE frames of one
    connection (default 4) are in flight at once; responses ship in frame
    order.  A TCP plane with MISAKA_PLANE_TLS_CERT/KEY/CA set wraps each
    accepted connection in server-side mTLS on its own thread; a unix
    plane never leaves the host and ignores them."""

    def __init__(self, master, path: str, timeout: float = 30.0, registry=None,
                 replica_label: str | None = None):
        self._master = master
        # the program registry when multi-program serving is armed: frames
        # then resolve their engine through a registry lease.  This module
        # never imports the registry: an unknown program surfaces as the
        # lease's KeyError (ProgramNotFound), answered as 404.
        self._registry = registry
        # which fleet replica this plane serves (scopes replica_blackhole)
        self._replica_label = (replica_label if replica_label is not None
                               else os.environ.get("MISAKA_FLEET_REPLICA") or None)
        self._timeout = timeout
        self._secret = edge_mod.plane_secret()
        self.path = path
        self._family, bind_host, bind_port = parse_plane_addr(path)
        if self._family == "tcp":
            self._tls = edge_mod.plane_tls_from_env()
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((bind_host, bind_port))
        else:
            self._tls = None
            if os.path.exists(path):
                os.unlink(path)
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.bind(path)
        self._sock.listen(64)
        self._closed = False
        # drain (POST /fleet/drain): new compute frames answer
        # PLANE_DRAINING; `inflight` counts frames still being served
        self._draining = False
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="misaka-plane-accept")
        self._accept_thread.start()

    def close(self) -> None:
        self._closed = True
        # closing the listening socket does not wake a thread blocked in
        # accept() on Linux: a self-connect pops it, and the loop sees
        # _closed and exits (else every closed plane leaks its thread)
        try:
            fam, host, port = parse_plane_addr(self.path)
            wake = socket.socket(socket.AF_INET if fam == "tcp" else socket.AF_UNIX,
                                 socket.SOCK_STREAM)
            wake.settimeout(0.5)
            try:
                wake.connect((host, port) if fam == "tcp" else self.path)
            finally:
                wake.close()
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._family != "tcp":
            try:
                os.unlink(self.path)
            except OSError:
                pass
        # sever live frontend connections: a closed plane looks like a
        # dead engine
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            _shutdown_socket(c)  # each connection's thread closes its own
        self._accept_thread.join(timeout=2)

    def set_draining(self, on: bool) -> None:
        self._draining = bool(on)

    @property
    def draining(self) -> bool:
        return self._draining

    def inflight(self) -> int:
        """Compute frames currently being served (0 = quiescent)."""
        return self._inflight

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # closed
            if self._closed:
                conn.close()
                return
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True,
                             name="misaka-plane-conn").start()

    def _slo_record(self, program, edge, t_recv: float, error: bool) -> None:
        """A frame's outcome into its program's SLO windows: per request
        from the worker's timestamps (queueing in the worker counts), else
        one observation from the frame's arrival.  4xx never come here."""
        if not slo.armed():
            return
        label = (program.partition("@")[0] if program
                 else getattr(self._registry, "default_name", None))
        now = time.monotonic()
        if edge:
            for t0 in edge:
                slo.observe(label, max(0.0, now - t0), error=error)
        else:
            slo.observe(label, now - t_recv, error=error)

    def _process_frame(self, n: int, meta: _Meta, get_values, reply) -> None:
        """Everything past the metadata for one compute frame: the drain
        check, the scheduler submission and the ordered response through
        `reply`.  The caller took the in-flight count; it is released
        here."""
        traces = meta.traces
        try:
            if self._draining:
                M_PLANE_DRAIN_REROUTES.inc()
                body = b"replica draining; reroute"
                reply(_RESP_HDR.pack(PLANE_DRAINING, len(body)) + body)
                for tr in traces:
                    tracespan.end(tr, status=PLANE_DRAINING)
                return
            bh = faults.fire("replica_blackhole")
            if bh is None and self._replica_label is not None:
                bh = faults.fire(f"replica_blackhole:{self._replica_label}")
            if bh is not None:
                # chaos: hold the frame unanswered
                log.warning("replica_blackhole fault: holding frame %.1fs", bh)
                time.sleep(max(0.0, bh))
            M_PLANE_FRAMES.inc()
            if meta.shm_vals is not None:
                M_PLANE_SHM_FRAMES.inc()
            if meta.hedged:
                M_PLANE_HEDGED.inc(meta.hedged)
            if meta.shed:
                # the worker's shed-cache hits since its last frame: booked
                # here, so the rejected series covers the whole door (a
                # malformed row costs the count, never the frame)
                try:
                    for t, r, cnt in meta.shed:
                        edge_mod.count_shed(t if isinstance(t, str) else None, str(r), int(cnt))
                except (ValueError, TypeError):
                    log.debug("dropping malformed shed metadata")
            if meta.cap is not None and meta.cap["rej"]:
                # the worker's locally terminated rejects, recorded here
                capture_mod.ingest("worker", meta.cap["rej"])
            # The edge chain, once per frame (runtime/edge.py): one frame is
            # one (program, tenant), so a frame decision is a tenant
            # decision.  A rejection ships its typed status and a JSON body
            # from which the worker restores the headers.
            registry = self._registry
            chain = edge_mod.current()
            if chain.armed:
                decision = chain.check("/compute_raw", "POST", key=meta.key,
                                       program=meta.program or getattr(registry, "default_name",
                                                                       None),
                                       values=int(n), requests=meta.reqs)
                rej = decision.reject
                if rej is not None:
                    rej.tenant = decision.tenant  # the worker's shed cache reports under it
                    body = rej.to_wire()
                    reply(_RESP_HDR.pack(rej.status, len(body)) + body)
                    if capture_mod.RECORDING:  # terminated here: this surface records it
                        capture_mod.ingest("plane", [{"program": meta.program, "trace": None,
                                                      "in": 0, "status": rej.status,
                                                      "reason": rej.reason}])
                    for tr in traces:
                        tracespan.end(tr, status=rej.status)
                    return
            t_recv = time.monotonic()
            values = get_values()
            # The lease first, in its own try: only this step may answer
            # 404 (ProgramNotFound is a KeyError).  A KeyError escaping the
            # compute itself stays a 500: calling an engine fault "program
            # not found" would hide it from 5xx alerting.
            lease = None
            try:
                if registry is not None:
                    # resolves the program (the seeded default for None),
                    # activates a cold engine, parks through a hot swap
                    lease = registry.lease(meta.program, values=int(values.size))
                    m = lease.__enter__()
                elif meta.program:
                    raise KeyError(f"program registry disabled; cannot route to program "
                                   f"{meta.program!r}")
                else:
                    m = self._master
            except KeyError as e:
                # args[0]: KeyError's str() would quote the message
                msg = e.args[0] if e.args and isinstance(e.args[0], str) else str(e)
                body = msg.encode()
                reply(_RESP_HDR.pack(404, len(body)) + body)
                for tr in traces:
                    tracespan.end(tr, status=404)
                return
            except Exception as e:  # an activation failure
                body = str(e).encode()
                reply(_RESP_HDR.pack(500, len(body)) + body)
                self._slo_record(meta.program, meta.edge, t_recv, error=True)
                for tr in traces:
                    tracespan.end(tr, status=500)
                return
            try:
                if not m.is_running:
                    body = b"network is not running"  # the route's 400 body
                    reply(_RESP_HDR.pack(400, len(body)) + body)
                    for tr in traces:
                        tracespan.end(tr, status=400)
                    return
                out = m.compute_coalesced(values, timeout=self._timeout,
                                          return_array=True, traces=tuple(traces))
            except Exception as e:
                body = str(e).encode()
                reply(_RESP_HDR.pack(500, len(body)) + body)
                self._slo_record(meta.program, meta.edge, t_recv, error=True)
                for tr in traces:
                    tracespan.add_span(tr, "plane.recv", t_recv, time.monotonic() - t_recv)
                    tracespan.end(tr, status=500)
                return
            finally:
                if lease is not None:
                    lease.__exit__(None, None, None)
            payload = out.astype("<i4").tobytes()
            if meta.shm_vals is not None:
                # the response rides the segment's second half; the socket
                # carries the 8-byte header only (shm frames run inline,
                # one in flight, so the double buffer is never shared)
                seg, size = meta.shm_seg
                seg.buf[size:size + len(payload)] = payload
                reply(_RESP_HDR.pack(200, len(payload) // 4))
            else:
                reply(_RESP_HDR.pack(200, len(payload) // 4) + payload)
            if capture_mod.RECORDING:
                # one record per frame (surface "plane"): the raw int32
                # comparands, and each traced request's slice
                cap_segs = (meta.cap or {}).get("segs") or None
                capture_mod.note(
                    "plane", program=meta.program or getattr(registry, "default_name", None),
                    trace=cap_segs[0]["id"] if cap_segs else None,
                    inbound=any(s["in"] for s in cap_segs) if cap_segs else False,
                    vals=values.tobytes(), resp=payload, status=200,
                    tick=int(getattr(m, "_ticks_done", 0)), reqs=meta.reqs, op="coalesced",
                    segs=cap_segs)
            self._slo_record(meta.program, meta.edge, t_recv, error=False)
            dur = time.monotonic() - t_recv
            for tr in traces:
                tracespan.add_span(tr, "plane.recv", t_recv, dur, {"frame_values": int(n)})
                tracespan.end(tr, status=200)
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    def _tls_accept(self, raw: socket.socket) -> socket.socket | None:
        """Wrap one accepted TCP connection in server-side mTLS, on its
        own thread (never in the accept loop: one silent peer would stall
        every dial).  A peer that fails the handshake (plaintext bytes, a
        certificate outside the pinned CA) gets a typed, counted close
        before any frame byte is read; None then."""
        conn = raw
        try:
            conn = self._tls.server_context().wrap_socket(
                raw, server_side=True, do_handshake_on_connect=False)
            conn.do_handshake()
        except (ssl.SSLError, OSError) as e:
            if not self._closed:  # close()'s wake-up dial is not a peer
                reason = _classify_tls_reject(e)
                edge_mod.count_plane_tls_reject(reason)
                log.warning("compute plane: refused %s peer at the mTLS gate: %s", reason, e)
            with self._conns_lock:
                self._conns.discard(raw)
            for sk in (conn, raw):
                try:
                    sk.close()
                except OSError:
                    pass
            return None
        # the wrapped socket owns the descriptor now: close() severs it
        with self._conns_lock:
            self._conns.discard(raw)
            self._conns.add(conn)
        return conn

    def _serve_conn(self, conn: socket.socket) -> None:
        if self._tls is not None:
            conn = self._tls_accept(conn)
            if conn is None:
                return
        # Pipelining: up to `pipe_depth` frames of this connection go
        # through the scheduler at once while the reader keeps reading.
        # Responses ship in frame order through a chain of done events
        # (the wire carries no frame ids: FIFO pairing is the protocol).
        # Probes, shm arming, shm frames and the reader's error replies
        # first wait for the chain's tail.
        # an mTLS connection serves its frames inline: this thread alone
        # reads and writes the session (a pipelined response written
        # while this thread sits in a read is what one TLS session must
        # not see)
        pipe_depth = (1 if self._tls is not None
                      else max(1, int(os.environ.get("MISAKA_PLANE_PIPELINE", "") or 4)))
        send_lock = threading.Lock()
        conn_dead = [False]
        conn_depth = [0]
        pipe_sem = threading.Semaphore(pipe_depth)
        executor: list = [None]
        tail: list = [None]
        shm_state: list = [None, 0]  # [segment, size] of this connection

        def send_ordered(prev, data: bytes) -> None:
            if prev is not None:
                prev.wait()
            if conn_dead[0]:
                raise ConnectionError("plane connection is closed")
            send(data)

        def send(data: bytes) -> None:
            # every write takes the lock: an mTLS session must never see
            # two writers at once (the reader thread is its one reader)
            with send_lock:
                conn.sendall(data)

        def drain_pipeline() -> None:
            t = tail[0]
            if t is not None:
                t.wait()

        def run_pipelined(n, meta, values, prev, done) -> None:
            try:
                self._process_frame(n, meta, lambda: values,
                                    lambda data: send_ordered(prev, data))
            except OSError as e:  # ConnectionError included
                conn_dead[0] = True
                log.debug("pipelined plane frame send failed: %r", e)
            except Exception:  # a frame must not die silently
                conn_dead[0] = True
                log.exception("pipelined compute-plane frame crashed")
            finally:
                with self._inflight_lock:
                    conn_depth[0] -= 1
                done.set()
                pipe_sem.release()

        import numpy as np

        try:
            if self._secret is not None:
                presented = _recv_exact(conn, edge_mod.PLANE_HANDSHAKE_LEN)
                if not edge_mod.verify_plane_handshake(self._secret, presented):
                    log.warning("compute plane: bad handshake; closing connection")
                    return
            while not self._closed:
                n, n_meta = _REQ_HDR.unpack(_recv_exact(conn, 8))
                if n > MAX_FRAME_VALUES:
                    drain_pipeline()
                    body = b"frame exceeds MAX_FRAME_VALUES"
                    send(_RESP_HDR.pack(413, len(body)) + body)
                    return  # protocol state is unrecoverable past this
                raw = _recv_exact(conn, n * 4)
                blob = _recv_exact(conn, n_meta) if n_meta else b""
                try:
                    meta = _parse_meta(blob)
                except _BadMeta as e:
                    drain_pipeline()  # error replies keep frame order
                    body = f"malformed plane metadata: {e}".encode()
                    send(_RESP_HDR.pack(400, len(body)) + body)
                    continue
                if meta.shm_arm is not None:
                    drain_pipeline()  # nobody may still read the old segment
                    old, shm_state[0], shm_state[1] = shm_state[0], None, 0
                    if old is not None:
                        old.close()
                    try:
                        shm_state[0] = _attach_shm(meta.shm_arm["name"], meta.shm_arm["size"])
                        shm_state[1] = int(meta.shm_arm["size"])
                        send(_RESP_HDR.pack(PLANE_SHM_OK, 0))
                    except (OSError, ValueError) as e:
                        body = f"shm attach failed: {e}".encode()
                        send(_RESP_HDR.pack(400, len(body)) + body)
                    continue
                if meta.shm_vals is not None:
                    if (shm_state[0] is None or meta.shm_vals * 4 > shm_state[1]
                            or meta.shm_vals > MAX_FRAME_VALUES):
                        drain_pipeline()
                        body = b"shm frame without a valid armed segment"
                        send(_RESP_HDR.pack(400, len(body)) + body)
                        return  # transport misuse: unrecoverable
                    n = meta.shm_vals
                if meta.probe:
                    drain_pipeline()
                    send(_RESP_HDR.pack(
                        PLANE_DRAINING if self._draining else 200, 0))
                    continue
                # the in-flight count is taken before the drain check, so
                # a drain that polls `inflight` cannot miss this frame
                if pipe_depth > 1 and meta.shm_vals is None:
                    pipe_sem.acquire()
                    if conn_dead[0]:
                        pipe_sem.release()
                        return
                    done = threading.Event()
                    prev, tail[0] = tail[0], done
                    if prev is not None and not prev.is_set():
                        M_PLANE_PIPELINED.inc()
                    if executor[0] is None:
                        executor[0] = ThreadPoolExecutor(
                            max_workers=pipe_depth, thread_name_prefix="misaka-plane-pipe")
                    with self._inflight_lock:
                        self._inflight += 1
                        conn_depth[0] += 1
                        depth = conn_depth[0]
                    M_PLANE_PIPE_DEPTH.observe(depth)
                    _PIPE_DEPTH_WINDOW.note(depth)
                    executor[0].submit(run_pipelined, n, meta,
                                       np.frombuffer(raw, dtype="<i4"), prev, done)
                    continue
                # inline: shm frames (the double buffer needs one frame in
                # flight) and MISAKA_PLANE_PIPELINE=1
                drain_pipeline()
                if meta.shm_vals is not None:
                    meta.shm_seg = (shm_state[0], shm_state[1])
                    # the scheduler copies the values into its feed before
                    # it completes the entry: the view is never read after
                    # the response, when the client writes the next payload
                    get_values = (lambda seg=shm_state[0], count=meta.shm_vals:
                                  np.frombuffer(seg.buf, dtype="<i4", count=count))
                else:
                    get_values = (lambda r=raw: np.frombuffer(r, dtype="<i4"))
                with self._inflight_lock:
                    self._inflight += 1
                self._process_frame(n, meta, get_values, lambda data: send_ordered(None, data))
        except OSError as e:  # ConnectionError included: the frontend went away
            log.debug("compute-plane connection closed: %r", e)
        except Exception:  # a connection must not die silently
            log.exception("compute-plane connection handler crashed")
        finally:
            conn_dead[0] = True
            if executor[0] is not None:
                executor[0].shutdown(wait=False)
            if shm_state[0] is not None:
                try:
                    shm_state[0].close()  # unmap; the frontend owns unlink
                except (OSError, BufferError):
                    # a surviving numpy view pins the mapping: it is
                    # unmapped when the last view is collected
                    pass
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass


def start_compute_plane(master, path: str, timeout: float = 30.0, registry=None,
                        replica_label: str | None = None) -> ComputePlane:
    return ComputePlane(master, path, timeout=timeout, registry=registry,
                        replica_label=replica_label)


# --- frontend side --------------------------------------------------------------


class PlaneError(RuntimeError):
    """The engine answered a frame with an error (carries the HTTP status)."""

    def __init__(self, status: int, body: bytes):
        super().__init__(body.decode(errors="replace"))
        self.status = status
        self.body = body


class _PlaneRequest:
    __slots__ = ("body", "out", "error", "event", "cancelled", "trace", "enqueued", "program",
                 "key", "replayed", "hedged")

    def __init__(self, body: bytes, trace=None, program=None, key=None, hedged=False):
        self.body = body          # raw little-endian int32 values
        self.out: bytes | None = None
        self.error: PlaneError | None = None
        self.event = threading.Event()
        self.cancelled = False    # the waiter gave up: never ship it
        self.trace = trace        # request trace (utils/tracespan.py) or None
        self.enqueued = time.monotonic()  # frontend.coalesce span start
        self.program = program    # registry address (None: the default network)
        self.key = key            # API key (frames pack per (program, key))
        self.replayed = False     # one stale-socket requeue per request
        self.hedged = hedged      # re-routed here after a sibling replica failed it


class _Shipment:
    """One in-flight frame on a pipelined plane connection."""

    __slots__ = ("batch", "traced", "t_ship", "use_shm", "shed", "replay_ok", "sent")

    def __init__(self, batch, traced, t_ship, use_shm, shed, replay_ok, sent=True):
        self.batch = batch
        self.traced = traced
        self.t_ship = t_ship
        self.use_shm = use_shm
        self.shed = shed            # the worker's shed counts riding this frame
        self.replay_ok = replay_ok  # not the first frame on a fresh dial
        self.sent = sent            # its bytes are written (mTLS: the receiver waits)


class PlaneClient:
    """Frontend-local coalescer over persistent compute-plane connections.

    Handler threads enqueue raw int32 bodies; one dispatcher thread per
    connection (`conns`) packs everything waiting into a single frame
    (FIFO, value offsets recorded), ships it, and scatters the response
    back by offset: the engine's ServeBatcher, one level out.  While a
    frame is in flight a dispatcher waits MISAKA_PLANE_WINDOW_US (default
    300) to gather more requests; an idle plane dispatches at once.  Up to
    MISAKA_PLANE_PIPELINE frames (default 4; 1 with the shared-memory
    plane) are outstanding per connection.  A TCP plane dials in mTLS when
    MISAKA_PLANE_TLS_CERT/KEY/CA are set; per socket the dispatcher is the
    one writer and one receiver thread the one reader.  `replica` is the
    fleet slot this client serves (None: a single engine)."""

    def __init__(self, path: str, conns: int = 2, timeout: float = 60.0,
                 replica: int | None = None):
        self._path = path
        self._timeout = timeout
        self._secret = edge_mod.plane_secret()  # read once, not per reconnect
        self._family = parse_plane_addr(path)[0]
        # client-side mTLS for TCP planes only; the reloader re-stats the
        # files, so a rotation reaches new dials without a restart
        self._tls = edge_mod.plane_tls_from_env() if self._family == "tcp" else None
        self.replica = replica
        # dial-storm guard: a dead peer is not re-dialed in a tight loop
        self._dial_backoff = Backoff(base=0.05, cap=2.0)
        self._next_dial = 0.0
        self._shm_enabled = plane_shm_enabled()
        self._cond = threading.Condition()
        self._pending: deque[_PlaneRequest] = deque()
        self._closed = False
        self._inflight = 0
        # the worker's shed-cache rejections awaiting delivery: they never
        # reach the engine, so their counts ride the next frame's metadata
        # into its misaka_edge_rejected_total
        self._shed: dict[tuple[str, str], int] = {}
        # the worker's locally terminated capture rows, delivered the same
        # way; bounded (observability must not grow a quiet worker)
        self._caprej: list[dict] = []
        self._segs: set = set()  # live shared-memory segments (guarded by _cond)
        self._window_s = float(os.environ.get("MISAKA_PLANE_WINDOW_US", "") or 300) / 1e6
        self._threads = [
            threading.Thread(target=self._dispatch_loop, daemon=True,
                             name=f"misaka-plane-client-{i}")
            for i in range(max(1, conns))
        ]
        for t in self._threads:
            t.start()

    def close(self) -> None:
        """Stop the dispatchers and unlink every shared-memory segment."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=2)
        with self._cond:
            segs, self._segs = list(self._segs), set()
        for seg in segs:
            self._unlink(seg)

    def depth(self) -> int:
        """Queued plus in-flight frames on this client."""
        with self._cond:
            return len(self._pending) + self._inflight

    def report_shed(self, tenant: str | None, reason: str) -> None:
        """Count one worker-local edge rejection for the next frame."""
        k = (tenant or "other", reason)
        with self._cond:
            self._shed[k] = self._shed.get(k, 0) + 1

    def report_capture(self, row: dict) -> None:
        """Queue one worker-terminated capture row ({t, program, trace,
        in, status, reason}) for the next frame; past 32 waiting rows new
        ones drop."""
        with self._cond:
            if len(self._caprej) < 32:
                self._caprej.append(row)

    def _remerge_shed(self, shed) -> None:
        """The frame carrying these counts was lost: keep them for the next."""
        if shed:
            with self._cond:
                for k, cnt in shed.items():
                    self._shed[k] = self._shed.get(k, 0) + cnt

    def compute_raw(self, body: bytes, timeout: float = 30.0, program: str | None = None,
                    key: str | None = None, hedged: bool = False) -> bytes:
        """One request's raw int32 body in, its raw int32 outputs out.
        Frames coalesce strictly per (program, key).  `hedged` marks a
        request a fleet router re-routed here after a sibling failed it."""
        req = _PlaneRequest(body, trace=tracespan.current(), program=program, key=key,
                            hedged=hedged)
        with self._cond:
            self._pending.append(req)
            self._cond.notify()
        if not req.event.wait(timeout):
            with self._cond:
                # never ship a request whose caller already got its 500
                req.cancelled = True
            raise PlaneError(500, b"compute plane timed out")
        if req.error is not None:
            raise req.error
        return req.out

    def _connect(self) -> socket.socket:
        if faults.armed() and _plane_partitioned(self._path):
            raise OSError("plane partitioned (injected fault)")
        if time.monotonic() < self._next_dial:
            raise OSError("plane dial backoff (peer recently unreachable)")
        try:
            fam, host, port = parse_plane_addr(self._path)
            if fam == "tcp":
                sock = socket.create_connection((host, port), timeout=self._timeout)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                if self._tls is not None:
                    sock = self._tls.client_context().wrap_socket(sock, server_hostname=host)
            else:
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                sock.settimeout(self._timeout)
                sock.connect(self._path)
        except OSError:
            # ssl.SSLError is an OSError: a peer refusing our certificate
            # backs off as a dead one does
            self._next_dial = time.monotonic() + self._dial_backoff.next_delay()
            raise
        self._dial_backoff.reset()
        self._next_dial = 0.0
        if self._secret is not None:
            sock.sendall(edge_mod.plane_handshake(self._secret))
        return sock

    @staticmethod
    def _arm_shm(sock: socket.socket, seg, seg_size: int) -> bool:
        """Offer a dispatcher's segment to the engine over a fresh
        connection; True only on the PLANE_SHM_OK ack."""
        meta = json.dumps({"shm": {"name": seg.name, "size": seg_size}}).encode()
        sock.sendall(_REQ_HDR.pack(0, len(meta)) + meta)
        status, length = _RESP_HDR.unpack(_recv_exact(sock, 8))
        if length:  # keep the connection frame-aligned
            _recv_exact(sock, length * 4 if status == 200 else length)
        return status == PLANE_SHM_OK

    @staticmethod
    def _unlink(seg) -> None:
        try:
            seg.close()
            seg.unlink()
        except (OSError, BufferError):
            pass

    def _drop_seg(self, seg_box: list) -> None:
        seg, seg_box[0] = seg_box[0], None
        if seg is not None:
            with self._cond:
                self._segs.discard(seg)
            self._unlink(seg)

    def _fresh_seg(self, seg_box: list, seg_size: int):
        """A new segment for a new connection (never the old one: a stale
        engine handler may still map it); None when shared memory is
        unavailable, which costs that connection the shm path only."""
        self._drop_seg(seg_box)
        try:
            from multiprocessing import shared_memory

            seg_box[0] = shared_memory.SharedMemory(create=True, size=2 * seg_size)
        except OSError as e:
            log.warning("plane shm unavailable (%s); socket payloads", e)
            return None
        with self._cond:
            self._segs.add(seg_box[0])
        return seg_box[0]

    def _dispatch_loop(self) -> None:
        # MISAKA_PLANE_SHM=1: one segment per connection, [0, size) the
        # request payloads, [size, 2 size) the responses
        seg_box: list = [None]
        try:
            self._dispatch_loop_inner(seg_box)
        finally:
            self._drop_seg(seg_box)

    def _dispatch_loop_inner(self, seg_box: list) -> None:
        # Frames ship as soon as they are built, up to `depth` outstanding
        # on this connection; a receiver thread per socket completes them
        # in FIFO order.  When a socket dies before any response arrived
        # on it, its outstanding requests are requeued once each at the
        # front of the queue (a stale socket); the first frame on a fresh
        # dial never replays, nor does a timeout.  Lock order: `cond`
        # (connection state) before self._cond (queue state).
        depth = max(1, int(os.environ.get("MISAKA_PLANE_PIPELINE", "") or 4))
        seg_size = MAX_FRAME_VALUES * 4 if self._shm_enabled else 0
        cond = threading.Condition()
        gen: dict = {"id": 0, "sock": None, "armed": False, "seg": None,
                     "outstanding": deque(), "responded": 0, "dead": True,
                     "inherited": False}

        def fail_requests(reqs, text: bytes, status: int = 502) -> None:
            err = PlaneError(status, text)
            for r in reqs:
                r.error = err
                r.event.set()

        def conn_failed(gen_id: int, exc: BaseException) -> None:
            """Tear down one socket generation: fail or requeue its
            outstanding shipments under the replay rule above."""
            with cond:
                if gen["id"] != gen_id or gen["dead"]:
                    return
                gen["dead"] = True
                outstanding = list(gen["outstanding"])
                gen["outstanding"].clear()
                responded = gen["responded"]
                sock = gen["sock"]
                gen["sock"] = None
                cond.notify_all()
                if outstanding:
                    with self._cond:
                        self._inflight -= len(outstanding)
            if sock is not None:
                _shutdown_socket(sock)  # its receiver closes it
            replay = responded == 0 and not isinstance(exc, TimeoutError)
            requeue: list = []
            failed: list = []
            for shp in outstanding:
                for r in shp.batch:
                    if replay and shp.replay_ok and not r.replayed and not r.cancelled:
                        r.replayed = True
                        requeue.append(r)
                    else:
                        failed.append(r)
                self._remerge_shed(shp.shed)
            fail_requests(failed, f"compute plane error: {exc}".encode())
            if requeue:
                with self._cond:
                    for r in reversed(requeue):
                        self._pending.appendleft(r)
                    self._cond.notify_all()

        def receiver(sock: socket.socket, gen_id: int, seg) -> None:
            serial = isinstance(sock, ssl.SSLSocket)
            try:
                while True:
                    if serial:
                        # mTLS: read only while a written frame awaits its
                        # answer, never while the dispatcher writes (one
                        # TLS session must not be read and written at once)
                        with cond:
                            while (gen["id"] == gen_id and not gen["dead"]
                                   and not (gen["outstanding"] and gen["outstanding"][0].sent)):
                                cond.wait(0.5)
                            if gen["id"] != gen_id or gen["dead"]:
                                return
                    # an idle connection parks here; with frames
                    # outstanding, the oldest gets its full timeout from
                    # its ship time before the replica counts as silent
                    while True:
                        try:
                            hdr = _recv_exact(sock, 8)
                            break
                        except TimeoutError:
                            with cond:
                                if gen["id"] != gen_id:
                                    return
                                oldest = (gen["outstanding"][0].t_ship
                                          if gen["outstanding"] else None)
                            if oldest is not None and time.monotonic() - oldest >= self._timeout:
                                raise
                    status, length = _RESP_HDR.unpack(hdr)
                    with cond:
                        if gen["id"] != gen_id:
                            return  # superseded generation
                        if not gen["outstanding"]:
                            raise struct.error("response without an outstanding frame")
                        shp = gen["outstanding"][0]
                    if status == 200:
                        payload = (bytes(seg.buf[seg_size:seg_size + length * 4])
                                   if shp.use_shm else _recv_exact(sock, length * 4))
                        off = 0
                        for r in shp.batch:
                            r.out = payload[off:off + len(r.body)]
                            off += len(r.body)
                    else:
                        err = PlaneError(status, _recv_exact(sock, length))
                        if status == PLANE_DRAINING and self.replica is None:
                            # a single engine has no sibling to reroute to;
                            # a fleet router reads the raw status
                            err = PlaneError(503, err.body)
                        for r in shp.batch:
                            r.error = err
                    dur = time.monotonic() - shp.t_ship
                    attrs = {"replica": self.replica} if self.replica is not None else None
                    for r in shp.traced:
                        tracespan.add_span(r.trace, "plane.ship", shp.t_ship, dur, attrs)
                    with cond:
                        if gen["id"] != gen_id:
                            return
                        gen["outstanding"].popleft()
                        gen["responded"] += 1
                        cond.notify_all()
                    with self._cond:
                        self._inflight -= 1
                        self._cond.notify()  # a window-waiting dispatcher
                    for r in shp.batch:
                        r.event.set()
            except (OSError, struct.error) as e:  # ConnectionError included
                conn_failed(gen_id, e)
            finally:
                try:
                    sock.close()  # this thread is the socket's only reader
                except OSError:
                    pass

        try:
            while self._ship_one(seg_box, seg_size, depth, cond, gen, fail_requests,
                                 conn_failed, receiver):
                pass
        finally:
            # pop the receiver out of its blocking recv: a closed client
            # must not leave a thread parked on a live engine socket
            with cond:
                sock = gen["sock"]
                gen["sock"] = None
                gen["dead"] = True
                cond.notify_all()
            if sock is not None:
                _shutdown_socket(sock)  # its receiver closes it

    def _next_batch(self):
        """(batch, program, key, total bytes, shed counts, capture rows) of
        the next frame, or None when the client closed.  One frame is one (program, key);
        later requests for others keep their FIFO place."""
        with self._cond:
            while True:
                while not self._pending and not self._closed:
                    self._cond.wait(0.5)
                if self._closed:
                    return None
                if self._inflight and self._window_s > 0:
                    # coalesce only while another frame is in flight
                    self._cond.wait(self._window_s)
                    if self._closed:
                        return None
                batch: list[_PlaneRequest] = []
                skipped: deque[_PlaneRequest] = deque()
                program = key = None
                total = 0
                while self._pending and total < MAX_FRAME_VALUES * 4:
                    req = self._pending[0]
                    if req.cancelled:
                        self._pending.popleft()
                        continue
                    if batch and (req.program != program or req.key != key):
                        skipped.append(self._pending.popleft())
                        continue
                    if total and total + len(req.body) > MAX_FRAME_VALUES * 4:
                        break
                    self._pending.popleft()
                    if not batch:
                        program, key = req.program, req.key
                    batch.append(req)
                    total += len(req.body)
                while skipped:
                    self._pending.appendleft(skipped.pop())
                if batch:
                    self._inflight += 1
                    shed, self._shed = (self._shed, {}) if self._shed else (None, self._shed)
                    caprej, self._caprej = ((self._caprej, []) if self._caprej
                                            else (None, self._caprej))
                    return batch, program, key, total, shed, caprej

    @staticmethod
    def _frame_meta(batch, program, key, shed, caprej) -> bytes:
        """The frame's metadata: each traced request's ID, value offset
        and completed spans (http.parse, frontend.coalesce), the key, the
        fused request count, the shed counts, the capture rows and, while
        SLO may be armed, one receive time per request; nothing for one
        untraced request of the default program."""
        traced = [r for r in batch if r.trace is not None]
        # Per-program objectives are installed engine-side at upload, out
        # of this process's sight: a programs dir ships the timestamps too
        # (the engine's own armed() check decides).
        slo_armed = slo.armed() or bool(os.environ.get("MISAKA_PROGRAMS_DIR"))
        hedged = sum(1 for r in batch if r.hedged)
        if not (traced or program is not None or key is not None or slo_armed or hedged
                or len(batch) > 1 or shed or caprej):
            return b""
        now = time.monotonic()
        entries = []
        edge = []
        off = 0
        for r in batch:
            if r.trace is not None:
                tracespan.add_span(r.trace, "frontend.coalesce", r.enqueued, now - r.enqueued,
                                   {"frame_requests": len(batch)})
                ent = {"id": r.trace.trace_id, "off": off, "len": len(r.body) // 4,
                       "spans": [[s.name, s.start, s.dur] for s in r.trace.spans]}
                if r.trace.inbound:
                    ent["in"] = 1
                entries.append(ent)
            if slo_armed:
                edge.append(round(r.enqueued, 6))  # its SLO clock starts here
            off += len(r.body) // 4
        obj = {"program": program, "traces": entries}
        if key is not None:
            obj["key"] = key
        if len(batch) > 1:
            obj["reqs"] = len(batch)  # the engine bills rps per request
        if edge:
            obj["edge"] = edge
        if hedged:
            obj["hedged"] = hedged
        if shed:
            obj["shed"] = [[t, r, n] for (t, r), n in shed.items()]
        if caprej:
            obj["caprej"] = caprej  # lost with the frame if its ship fails
        return json.dumps(obj).encode()

    def _ship_one(self, seg_box, seg_size, depth, cond, gen, fail_requests, conn_failed,
                  receiver) -> bool:
        """Build and ship one frame on the live socket generation, dialing
        as needed; False when the client closed."""
        nxt = self._next_batch()
        if nxt is None:
            return False
        batch, program, key, total, shed, caprej = nxt
        meta = self._frame_meta(batch, program, key, shed, caprej)
        traced = [r for r in batch if r.trace is not None]
        payload_out = b"".join(r.body for r in batch)
        dials = 0
        while True:
            with cond:
                need_dial = gen["dead"] or gen["sock"] is None
                gen_id = gen["id"]
            if need_dial:
                dials += 1
                error = b"compute plane error: dial failed"
                sock = None
                if dials <= 2:
                    try:
                        sock = self._connect()
                    except OSError as e:
                        error = f"compute plane error: {e}".encode()
                if sock is None:
                    with self._cond:
                        self._inflight -= 1
                        self._cond.notify()
                    fail_requests(batch, error)
                    self._remerge_shed(shed)
                    return True
                armed = False
                seg = self._fresh_seg(seg_box, seg_size) if self._shm_enabled else None
                if seg is not None:
                    try:
                        armed = self._arm_shm(sock, seg, seg_size)
                    except (OSError, struct.error):
                        try:
                            sock.close()
                        except OSError:
                            pass
                        continue  # one more dial, then give up
                with cond:
                    gen["id"] += 1
                    gen_id = gen["id"]
                    gen.update(sock=sock, seg=seg, armed=armed, dead=False, responded=0,
                               inherited=False)
                    gen["outstanding"].clear()
                threading.Thread(target=receiver, daemon=True,
                                 args=(sock, gen_id, seg if armed else None),
                                 name="misaka-plane-recv").start()
            with cond:
                if gen["id"] != gen_id or gen["dead"]:
                    continue
                # backpressure: the shm double buffer takes one frame, and
                # so does an mTLS session (written only while no answer is
                # being read)
                serial = isinstance(gen["sock"], ssl.SSLSocket)
                eff = 1 if gen["armed"] or serial else depth
                while (not gen["dead"] and gen["sock"] is not None
                       and len(gen["outstanding"]) >= eff):
                    cond.wait(0.2)
                if gen["dead"] or gen["sock"] is None:
                    continue  # the generation died while we waited
                use_shm = gen["armed"] and total <= seg_size
                if use_shm:
                    # payload into the segment (no frame outstanding on an
                    # armed connection); header and metadata on the socket
                    gen["seg"].buf[0:total] = payload_out
                    shm_meta = (json.dumps({"program": program, "shm_vals": total // 4}).encode()
                                if not meta else meta[:-1] + b',"shm_vals":%d}' % (total // 4))
                    frame = _REQ_HDR.pack(0, len(shm_meta)) + shm_meta
                else:
                    frame = _REQ_HDR.pack(total // 4, len(meta)) + payload_out + meta
                shp = _Shipment(batch, traced, time.monotonic(), use_shm, shed,
                                replay_ok=gen["inherited"], sent=not serial)
                # enqueued before the send (a response cannot precede its
                # frame), and sent outside the lock: a blocking sendall
                # under `cond` would stall the receiver's completions
                sock_now = gen["sock"]
                gen["outstanding"].append(shp)
                gen["inherited"] = True
            try:
                if faults.armed():
                    delay = faults.fire("plane_delay")
                    if delay is not None:
                        time.sleep(delay)  # per-frame latency, outside every lock
                    if _plane_partitioned(self._path):
                        # black hole: the frame is never written, so the
                        # deadline trips, not a connection error
                        return True
                sock_now.sendall(frame)
                if not shp.sent:
                    with cond:
                        shp.sent = True
                        cond.notify_all()
            except OSError as send_exc:  # ConnectionError included
                conn_failed(gen_id, send_exc)
            return True


class _RouterReplica:
    """One replica slot as the fleet router sees it: a PlaneClient and a
    health state the prober keeps fresh."""

    __slots__ = ("idx", "path", "client", "state", "since", "suspect_until", "suspect_streak")

    def __init__(self, idx: int, path: str, client: PlaneClient):
        self.idx = idx
        self.path = path
        self.client = client
        # optimistic start: the first real frame corrects a wrong "up"
        # within one round trip
        self.state = "up"  # "up" | "down" | "draining"
        self.since = time.monotonic()
        # until this instant a probe success alone may not readmit it
        self.suspect_until = 0.0
        self.suspect_streak = 0

    def mark(self, state: str) -> None:
        if self.state != state:
            self.state = state
            self.since = time.monotonic()

    def suspect(self, hold_base: float) -> None:
        """A real frame failed here (transport error or frame deadline):
        down, and held out of probe readmission on a doubling backoff,
        since a wedged but live engine still answers probes.  Failures
        inside the current hold are one event (one failed frame fans out
        to every request it coalesced); only a failure after the hold
        doubles it."""
        now = time.monotonic()
        if now < self.suspect_until:
            self.mark("down")
            return
        self.suspect_streak += 1
        self.suspect_until = now + min(30.0, hold_base * (2 ** (self.suspect_streak - 1)))
        self.mark("down")

    def absolve(self) -> None:
        """A frame was served here, or the plane stopped accepting (what
        accepts next is a fresh process): the failure history is over."""
        self.suspect_streak = 0
        self.suspect_until = 0.0


class FleetPlaneRouter:
    """Routes requests across N engine-replica compute planes: one
    PlaneClient per replica and a policy over them.

      * a program-addressed request follows the consistent-hash ring on
        the program name (runtime/fleet.py HashRing): per-program
        coalescing and registry state stay on one replica, and only ~1/N
        of the keys move when a replica joins or leaves;
      * a stateless request goes to the healthy replica with the least
        queue depth, ties to the lowest index;
      * a replica that fails a frame (transport error, frame deadline, the
        drain reroute status) is marked down or draining and the request
        goes to the next candidate on the remaining deadline; re-routed
        requests after a failure ride the frame metadata as `hedged`;
      * with no replica healthy, the router waits up to `down_grace`
        seconds (MISAKA_FLEET_DOWN_GRACE_S, default 5) for one to come
        back, then answers the typed 503.

    A prober thread sends a zero-value probe frame to every replica not
    up and readmits it when it answers; a replica a real frame failed on
    sits out a doubling hold first (`suspect_hold` base, 30 s cap)."""

    # plane statuses that mean "a sibling can serve this frame": a
    # transport failure (502 inside PlaneClient) and the drain reroute
    REROUTE_STATUSES = frozenset({502, PLANE_DRAINING})

    def __init__(self, paths: list[str], conns: int = 2, timeout: float = 60.0,
                 probe_s: float = 0.25, down_grace: float | None = None,
                 suspect_hold: float = 0.5):
        from misaka_tpu_torch.runtime.fleet import HashRing

        if not paths:
            raise ValueError("FleetPlaneRouter needs at least one path")
        self._replicas = [
            _RouterReplica(i, p, PlaneClient(p, conns=conns, timeout=timeout, replica=i))
            for i, p in enumerate(paths)
        ]
        self._ring = HashRing(range(len(paths)))
        self._probe_s = float(probe_s)
        if down_grace is None:
            down_grace = float(os.environ.get("MISAKA_FLEET_DOWN_GRACE_S", "") or 5.0)
        self._down_grace = float(down_grace)
        self._suspect_hold = float(suspect_hold)
        self._secret = edge_mod.plane_secret()
        # probes of TCP planes present the data path's client certificate
        self._tls = (edge_mod.plane_tls_from_env()
                     if any(parse_plane_addr(p)[0] == "tcp" for p in paths) else None)
        self._closed = False
        self._prober = threading.Thread(target=self._probe_loop, daemon=True,
                                        name="misaka-fleet-router-probe")
        self._prober.start()

    def close(self) -> None:
        self._closed = True
        for r in self._replicas:
            r.client.close()
        self._prober.join(timeout=2)

    def states(self) -> dict[int, str]:
        return {r.idx: r.state for r in self._replicas}

    def depth(self) -> int:
        """Queued plus in-flight frames across every replica's client."""
        return sum(r.client.depth() for r in self._replicas)

    def _any_up(self) -> PlaneClient:
        up = [r for r in self._replicas if r.state == "up"]
        return (up[0] if up else self._replicas[0]).client

    def report_shed(self, tenant: str | None, reason: str) -> None:
        """A worker-local shed count rides any up replica's next frame
        (the fleet's /metrics sums them)."""
        self._any_up().report_shed(tenant, reason)

    def report_capture(self, row: dict) -> None:
        self._any_up().report_capture(row)

    def _probe_once(self, r: _RouterReplica) -> str:
        """One probe frame: "up", "draining" or "down" as seen now."""
        if faults.armed() and _plane_partitioned(r.path):
            return "down"  # unreachable to probes too: no up/down flapping
        try:
            fam, host, port = parse_plane_addr(r.path)
            if fam == "tcp":
                sock = socket.create_connection((host, port), timeout=1.0)
                if self._tls is not None:
                    sock = self._tls.client_context().wrap_socket(sock, server_hostname=host)
            else:
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                sock.settimeout(1.0)
                sock.connect(r.path)
            try:
                if self._secret is not None:
                    sock.sendall(edge_mod.plane_handshake(self._secret))
                meta = b'{"probe": 1}'
                sock.sendall(_REQ_HDR.pack(0, len(meta)) + meta)
                status, length = _RESP_HDR.unpack(_recv_exact(sock, 8))
                if length:
                    _recv_exact(sock, length)
            finally:
                sock.close()
        except OSError:
            return "down"
        if status == 200:
            return "up"
        return "draining" if status == PLANE_DRAINING else "down"

    def _probe_loop(self) -> None:
        while not self._closed:
            time.sleep(self._probe_s)
            for r in self._replicas:
                if self._closed:
                    return
                if r.state == "up":
                    continue
                observed = self._probe_once(r)
                if observed == "down":
                    r.absolve()  # a dead process: what accepts next is fresh
                elif observed == "up" and time.monotonic() < r.suspect_until:
                    continue  # weaker evidence than the frame that failed
                r.mark(observed)

    def _candidates(self, program: str | None, tried: set[int]) -> list[_RouterReplica]:
        """Healthy untried replicas in preference order: the ring walk for
        an addressed request, least depth (ties to the lowest index) else."""
        up = [r for r in self._replicas if r.state == "up" and r.idx not in tried]
        if not up:
            return []
        if program:
            by_idx = {r.idx: r for r in up}
            return [by_idx[i] for i in self._ring.lookup(program.partition("@")[0])
                    if i in by_idx]
        return sorted(up, key=lambda r: (r.client.depth(), r.idx))

    def compute_raw(self, body: bytes, timeout: float = 30.0, program: str | None = None,
                    key: str | None = None) -> bytes:
        deadline = time.monotonic() + timeout
        tried: set[int] = set()
        hedged = False
        last_err: PlaneError | None = None
        while True:
            cands = self._candidates(program, tried)
            if not cands:
                # forget the attempts (a replica the prober readmits while
                # we wait must be eligible again: with one replica `tried`
                # would mask its own recovery) and ride out a respawn
                tried = set()
                grace_end = min(deadline, time.monotonic() + self._down_grace)
                cands = self._candidates(program, tried)
                while not cands and time.monotonic() < grace_end:
                    time.sleep(0.05)
                    cands = self._candidates(program, tried)
                if not cands:
                    detail = (last_err.body.decode(errors="replace") if last_err is not None
                              else "no replica up")
                    raise PlaneError(
                        503, f"fleet down: no healthy engine replica ({detail})".encode())
            r = cands[0]
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                if last_err is None:
                    raise PlaneError(500, b"compute plane timed out")
                if last_err.status == PLANE_DRAINING:
                    # the plane-private status never reaches a client
                    raise PlaneError(503, b"fleet draining: " + last_err.body)
                raise last_err
            # while another candidate remains, an attempt gets half the
            # remaining deadline: a silent replica must leave time to hedge
            attempt_timeout = remaining / 2 if len(cands) > 1 else remaining
            try:
                out = r.client.compute_raw(body, timeout=attempt_timeout, program=program,
                                           key=key, hedged=hedged)
                r.absolve()
                return out
            except PlaneError as e:
                if e.status in self.REROUTE_STATUSES:
                    if e.status == PLANE_DRAINING:
                        # routine in every roll, and counted on the draining
                        # replica's reroute counter: not a hedge
                        r.mark("draining")
                    else:
                        r.suspect(self._suspect_hold)
                        hedged = True
                    tried.add(r.idx)
                    last_err = e
                    continue
                if e.status == 500 and e.body == b"compute plane timed out":
                    # the frame deadline (a blackholed or wedged replica)
                    r.suspect(self._suspect_hold)
                    tried.add(r.idx)
                    hedged = True
                    last_err = e
                    continue
                raise  # an engine's own answer (400/404/413/500): final


class _ReusePortHTTPServer(ThreadingHTTPServer):
    """SO_REUSEPORT bind: every frontend process binds the same public
    port; the kernel balances incoming connections."""

    daemon_threads = True

    def server_bind(self):
        self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        super().server_bind()


def make_frontend_server(public_port: int, engine_url: str, plane_path: str,
                         plane_conns: int = 2, max_body: int | None = None,
                         fleet: bool | None = None) -> ThreadingHTTPServer:
    """One frontend worker's HTTP server (call serve_forever on it).

    Hot routes answer from the compute plane at `plane_path`; everything
    else proxies to the engine's own HTTP server at `engine_url` (the fleet
    control server in fleet mode).  A comma-separated `plane_path` routes
    across the replicas' planes through FleetPlaneRouter; `fleet=True`
    takes the router for one path too (a 1-replica fleet still needs the
    reroute grace through a roll).  The server's `misaka_plane_client` is
    its PlaneClient or router (close it after the server)."""
    if max_body is None:
        max_body = int(os.environ.get("MISAKA_MAX_BODY", "") or 64 * 1024 * 1024)
    paths = [p for p in plane_path.split(",") if p]
    if fleet is None:
        fleet = len(paths) > 1
    plane = (FleetPlaneRouter(paths, conns=plane_conns) if fleet
             else PlaneClient(paths[0], conns=plane_conns))
    engine = urlsplit(engine_url)
    engine_host = engine.hostname or "127.0.0.1"
    engine_port = engine.port or 8000
    local = threading.local()
    # The worker's one local guard: a cap on plane backlog (frames), so a
    # flood cannot grow this worker's queue without bound.  0 disables it,
    # as MISAKA_EDGE=0 or MISAKA_EDGE_ADMISSION=0 do.
    plane_depth_max = (
        int(os.environ.get("MISAKA_PLANE_DEPTH_MAX", "") or 256)
        if os.environ.get("MISAKA_EDGE", "1") != "0"
        and os.environ.get("MISAKA_EDGE_ADMISSION", "1") != "0" else 0
    )
    # When the engine sheds a (program, key) frame with 429 + Retry-After,
    # this worker honours the Retry-After locally: the tenant's next
    # requests shed at this door until it expires
    shed_lock = threading.Lock()
    shed_until: dict[tuple, tuple[float, edge_mod.EdgeReject]] = {}
    # bodies above this ride the proxy: the engine stripes a bulk body
    # directly, and the plane's frame cap must not shrink MISAKA_MAX_BODY
    plane_body_limit = MAX_FRAME_VALUES * 2

    class FrontendHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log.debug(fmt, *args)

        def handle_one_request(self):
            # the engine server's fast request loop
            try:
                self.raw_requestline = self.rfile.readline(65537)
                if len(self.raw_requestline) > 65536:
                    self.requestline = ""
                    self.request_version = ""
                    self.command = ""
                    self.send_error(414, "Request-URI Too Long")
                    return
                if not self.raw_requestline:
                    self.close_connection = True
                    return
                t_parse = time.monotonic()  # after the line: keep-alive idles
                parsed = fast_parse_request(self)
                if parsed is None:
                    return
                if not parsed and not self.parse_request():
                    return
                self._parse_mark = (t_parse, time.monotonic() - t_parse)
                mname = "do_" + self.command
                if not hasattr(self, mname):
                    self.send_error(501, f"Unsupported method ({self.command!r})")
                    return
                getattr(self, mname)()
                self.wfile.flush()
            except TimeoutError as e:
                self.log_error("Request timed out: %r", e)
                self.close_connection = True
            except ssl.SSLError as e:
                # the deferred TLS handshake fails on the first read
                self.log_error("TLS handshake failed: %r", e)
                self.close_connection = True

        def send_response(self, code, message=None):
            self._trace_code = code
            super().send_response(code, message)

        def _reply(self, code: int, data: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            # a proxied response carries the engine's trace headers (its
            # queue and pass phases); else this worker's own
            have_trace = False
            for k, v in self._extra_headers:
                if k.lower() == "x-misaka-trace":
                    have_trace = True
                self.send_header(k, v)
            tr = self._misaka_trace
            if tr is not None and not have_trace:
                self.send_header(tracespan.TRACE_HEADER, tr.trace_id)
                st = tracespan.server_timing(tr)
                if st:
                    self.send_header("Server-Timing", st)
            self.end_headers()
            self.wfile.write(data)

        def _text(self, code: int, body: str) -> None:
            self._reply(code, body.encode(), "text/plain; charset=utf-8")

        def _plane_error(self, e: PlaneError, shed_key) -> None:
            """Answer a PlaneError, restoring an edge rejection's headers;
            a 429 with Retry-After arms the local shed cache."""
            rej = edge_mod.EdgeReject.from_wire(e.status, e.body)
            if rej is None:
                self._text(e.status, e.body.decode(errors="replace"))
                return
            if e.status == 429 and rej.retry_after is not None:
                # hold at least 250 ms: a flooding tenant must not get a
                # plane round trip every few ms
                now = time.monotonic()
                until = now + min(max(rej.retry_after, 0.25), 30.0)
                with shed_lock:
                    if len(shed_until) >= 1024:
                        # the key is client-controlled: sweep the expired
                        # entries, and cap hard if a flood outruns expiry
                        for k in [k for k, (u, _) in shed_until.items() if u <= now]:
                            del shed_until[k]
                        while len(shed_until) >= 4096:
                            shed_until.pop(next(iter(shed_until)))
                    shed_until[shed_key] = (until, rej)
            self._extra_headers.extend(rej.headers())
            self._text(e.status, rej.message)

        def _shed_cached(self, shed_key) -> bool:
            """True (and answered 429) inside an engine-advertised backoff."""
            if not shed_until:
                return False
            with shed_lock:
                hit = shed_until.get(shed_key)
                if hit is None:
                    return False
                until, rej = hit
                remaining = until - time.monotonic()
                if remaining <= 0:
                    del shed_until[shed_key]
                    return False
            edge_mod.drain_or_close(self)  # keep-alive discipline
            self._extra_headers.append(("Retry-After", str(max(1, int(-(-remaining // 1))))))
            self._text(429, rej.message)
            plane.report_shed(rej.tenant, rej.reason)  # rides the next frame
            self._report_capture(shed_key[0], rej.reason)
            return True

        def _report_capture(self, program, reason: str) -> None:
            """A 429 this worker answered: the capture row rides the next
            frame to the engine's recorder (surface "worker")."""
            if capture_mod.available():
                tr = tracespan.current()
                plane.report_capture({"t": time.time(), "program": program,
                                      "trace": tr.trace_id if tr is not None else None,
                                      "in": int(tr.inbound) if tr is not None else 0,
                                      "status": 429, "reason": reason})

        def _edge_guard(self) -> bool:
            """The backlog cap; True = proceed.  Over the cap: a 429 with
            Retry-After, the body unread and the connection closed."""
            if not plane_depth_max or plane.depth() < plane_depth_max:
                return True
            self.close_connection = True
            self._extra_headers.append(("Retry-After", "1"))
            self._text(429, f"frontend overloaded: {plane.depth()} plane frames queued "
                            f"(cap {plane_depth_max}); retry after backoff")
            plane.report_shed(None, "overload")  # no tenant is known at the worker
            self._report_capture(None, "overload")
            return False

        def _with_trace(self, inner) -> None:
            """Begin and end the request trace around one dispatch: the
            request enters the serving tier here."""
            self._extra_headers = []
            self._trace_code = None
            trace = tracespan.begin(self.headers.get(tracespan.TRACE_HEADER),
                                    route=self.path.split("?", 1)[0])
            self._misaka_trace = trace
            mark = getattr(self, "_parse_mark", None)
            self._parse_mark = None
            if trace is not None and mark is not None:
                tracespan.add_span(trace, "http.parse", mark[0], mark[1])
            try:
                inner()
            finally:
                self._misaka_trace = None
                tracespan.end(trace, status=self._trace_code)

        def _read_body(self, required: bool = True):
            """The body, or None after answering 411/400/413.
            required=False reads a missing Content-Length as an empty body
            (the engine's form routes are as lenient)."""
            length_hdr = self.headers.get("Content-Length")
            if length_hdr is None:
                if not required:
                    return b""
                self.close_connection = True
                self._text(411, "Content-Length required")
                return None
            try:
                length = int(length_hdr)
            except ValueError:
                self.close_connection = True
                self._text(400, "cannot parse Content-Length")
                return None
            if length > max_body:
                self.close_connection = True
                self._text(413, f"body of {length} bytes exceeds the {max_body}-byte cap "
                                "(MISAKA_MAX_BODY)")
                return None
            return self.rfile.read(length)

        def do_POST(self):
            self._with_trace(self._do_post)

        def do_GET(self):
            self._with_trace(lambda: self._proxy("GET"))

        def _do_post(self):
            route = self.path.split("?", 1)[0]
            pm = _PROGRAM_COMPUTE_RE.match(route)
            if pm:
                program = unquote(pm.group(1))
                route = "/" + pm.group(2)
            else:
                program = self.headers.get("X-Misaka-Program") or None
            key = edge_mod.key_from_headers(self.headers)
            shed_key = (program, key)
            if route == "/compute_raw" and "spread=0" not in self.path:
                if self._shed_cached(shed_key) or not self._edge_guard():
                    return
                length_hdr = self.headers.get("Content-Length", "")
                if length_hdr.isdigit() and int(length_hdr) > plane_body_limit:
                    self._proxy("POST")
                    return
                body = self._read_body()
                if body is None:
                    return
                if wire.is_binary(self.headers.get("Content-Type")):
                    # the worker checks the framing and ships the payload
                    try:
                        body = wire.unpack(body)
                    except wire.WireError as e:
                        self._text(400, f"bad binary body: {e}")
                        return
                if len(body) % 4:
                    self._text(400, "body must be raw int32 values")
                    return
                try:
                    out = plane.compute_raw(body, program=program, key=key)
                except PlaneError as e:
                    self._plane_error(e, shed_key)
                    return
                if wire.accepts_binary(self.headers.get("Accept")):
                    self._reply(200, wire.header(len(out) // 4) + out, wire.CONTENT_TYPE)
                else:
                    self._reply(200, out, "application/octet-stream")
                return
            if route == "/compute":
                if self._shed_cached(shed_key) or not self._edge_guard():
                    return
                body = self._read_body(required=False)
                if body is None:
                    return
                form = {k: v[0] for k, v in parse_qs(body.decode(errors="replace"),
                                                     keep_blank_values=True).items()}
                try:
                    value = int(form.get("value", ""))
                except ValueError:
                    self._text(400, "cannot parse value")
                    return
                try:
                    out = plane.compute_raw(struct.pack("<i", value), program=program, key=key)
                except PlaneError as e:
                    self._plane_error(e, shed_key)
                    return
                self._reply(200, b'{"value": %d}\n' % struct.unpack("<i", out)[0],
                            "application/json")
                return
            self._proxy("POST")

        def _proxy(self, method: str) -> None:
            """Relay what this worker does not answer to the engine's HTTP
            server over a per-thread keep-alive connection."""
            body = b""
            if method == "POST":
                body = self._read_body(required=False)
                if body is None:
                    return
            headers = {}
            for h in ("Content-Type", "X-Misaka-Program", "X-Misaka-Key", "Authorization"):
                v = self.headers.get(h)
                if v:
                    headers[h] = v
            tr = self._misaka_trace
            if tr is not None:
                # the trace follows the request; the engine's trace headers
                # come back verbatim below
                headers[tracespan.TRACE_HEADER] = tr.trace_id
            if self.path.split("?", 1)[0] == "/fleet/roll":
                # a roll pays one engine boot per replica and can outlive
                # the pooled 60 s timeout (a 502 while it runs on, then a
                # retry's 409): a connection of its own, the client's budget
                conn = http.client.HTTPConnection(engine_host, engine_port, timeout=600)
                try:
                    conn.request(method, self.path, body or None, headers)
                    resp = conn.getresponse()
                    payload = resp.read()
                except (http.client.HTTPException, OSError) as e:
                    self._text(502, f"engine unreachable: {e}")
                    return
                finally:
                    conn.close()
                self._reply(resp.status, payload, resp.getheader("Content-Type") or "text/plain")
                return
            for attempt in (0, 1):
                conn = getattr(local, "engine_conn", None)
                fresh = conn is None
                if fresh:
                    conn = http.client.HTTPConnection(engine_host, engine_port, timeout=60)
                    local.engine_conn = conn
                try:
                    conn.request(method, self.path, body or None, headers)
                    resp = conn.getresponse()
                    payload = resp.read()
                except (http.client.HTTPException, OSError) as e:
                    conn.close()
                    local.engine_conn = None
                    if fresh or attempt:
                        self._text(502, f"engine unreachable: {e}")
                        return
                    continue  # a stale pooled socket: retry once, fresh
                for h in (tracespan.TRACE_HEADER, "Server-Timing", "Deprecation", "Link",
                          "Retry-After", "WWW-Authenticate"):
                    v = resp.getheader(h)
                    if v:
                        self._extra_headers.append((h, v))
                self._reply(resp.status, payload, resp.getheader("Content-Type") or "text/plain")
                return

    httpd = _ReusePortHTTPServer(("0.0.0.0", public_port), FrontendHandler)
    httpd.misaka_plane_client = plane
    # TLS terminates at the workers (MISAKA_TLS_CERT/KEY, inherited by every
    # worker); the engine behind them stays loopback HTTP
    return edge_mod.wrap_server_tls(httpd, edge_mod.tls_context_from_env())


def frontend_main(argv=None) -> int:
    """`python -m misaka_tpu_torch.runtime.frontends`: one worker process."""
    import argparse

    parser = argparse.ArgumentParser(description="misaka HTTP frontend worker (SO_REUSEPORT)")
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--engine", required=True, help="engine HTTP base url (proxy target)")
    parser.add_argument("--plane", required=True, help="compute-plane socket path or host:port")
    parser.add_argument("--plane-conns", type=int, default=2)
    parser.add_argument("--fleet", action="store_true",
                        help="route through the fleet router even for one plane path")
    parser.add_argument(
        "--parent-pid", type=int, default=0,
        help="exit when this process disappears: an orphaned worker must not keep the "
        "SO_REUSEPORT public port, where the kernel would balance traffic onto it")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    # many small handler threads share this interpreter: the default 5 ms
    # switch interval turns response waves into convoys
    sys.setswitchinterval(0.001)
    exit_after = faults.fire("worker_exit")
    if exit_after is not None:
        # chaos: hard-exit this worker after N seconds, the failure the
        # supervisor must absorb
        def _fault_exit(delay=max(0.0, exit_after)):
            time.sleep(delay)
            log.warning("worker_exit fault fired; frontend hard-exiting")
            os._exit(1)

        threading.Thread(target=_fault_exit, daemon=True).start()

    def _terminate(signum, frame):
        raise SystemExit(0)

    # SIGTERM (the supervisor's close) exits through the finally below,
    # which unlinks the shared-memory segments
    signal.signal(signal.SIGTERM, _terminate)
    if args.parent_pid:
        def _watch_parent(pid=args.parent_pid):
            while True:
                # a dead engine left as a zombie still answers kill(pid, 0),
                # but this worker is its child: its ppid flips at once
                gone = os.getppid() != pid
                if not gone:
                    try:
                        os.kill(pid, 0)
                    except OSError:
                        gone = True
                if gone:
                    log.warning("engine pid %d gone; frontend exiting", pid)
                    os.kill(os.getpid(), signal.SIGTERM)
                    time.sleep(5.0)  # the clean exit stalled: leave anyway
                    os._exit(0)
                time.sleep(2.0)

        threading.Thread(target=_watch_parent, daemon=True).start()
    httpd = make_frontend_server(args.port, args.engine, args.plane,
                                 plane_conns=args.plane_conns, fleet=args.fleet or None)
    log.info("frontend worker on :%d (engine %s)", args.port, args.engine)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        httpd.misaka_plane_client.close()
    return 0


def _worker_cmd(public_port: int, engine_url: str, plane_path: str,
                plane_conns: int, fleet: bool = False) -> list[str]:
    cmd = [sys.executable, "-m", "misaka_tpu_torch.runtime.frontends",
           "--port", str(public_port), "--engine", engine_url, "--plane", plane_path,
           "--plane-conns", str(plane_conns), "--parent-pid", str(os.getpid())]
    if fleet:
        cmd.append("--fleet")
    return cmd


def spawn_frontends(n: int, public_port: int, engine_url: str, plane_path: str,
                    plane_conns: int = 2, fleet: bool = False) -> list[subprocess.Popen]:
    """Start n unsupervised worker processes sharing `public_port` (for
    callers that own the processes' lifetimes; serving uses
    FrontendSupervisor).  fork+exec, never a bare fork: the engine process
    holds a CUDA context.  wait_ready() confirms the port answers."""
    cmd = _worker_cmd(public_port, engine_url, plane_path, plane_conns, fleet=fleet)
    return [subprocess.Popen(cmd) for _ in range(n)]


class FrontendSupervisor:
    """Keeps the worker pool at strength: spawn, watch, respawn.

    When one SO_REUSEPORT worker dies the kernel balances the public port
    over the survivors: capacity shrinks and nothing errors.  So:

      * each of the n slots holds one worker process; a monitor thread
        polls for deaths (reaping them) and respawns with exponential
        backoff and jitter (`backoff_base` doubling to `backoff_cap`);
      * a slot whose workers die within `fast_crash_s` of spawn
        `breaker_threshold` times in a row opens its circuit breaker:
        respawning pauses for `breaker_reset_s`, then one half-open retry;
      * `state()` reports alive against configured, restarts, open
        breakers and `degraded`; /healthz and /status render it (the
        engine's server reads `server.misaka_supervisor`).
    """

    def __init__(self, n: int, public_port: int, engine_url: str, plane_path: str,
                 plane_conns: int = 2, backoff_base: float = 0.5, backoff_cap: float = 15.0,
                 fast_crash_s: float = 5.0, breaker_threshold: int = 5,
                 breaker_reset_s: float = 60.0, poll_s: float = 0.2, cmd: list | None = None,
                 fleet: bool = False):
        """`cmd` replaces the worker command (tests: a command that exits
        at once trips the breaker); `fleet` gives the workers the fleet
        router."""
        self._cmd = cmd or _worker_cmd(public_port, engine_url, plane_path, plane_conns,
                                       fleet=fleet)
        # stateless use (delay_for): the exponent is each slot's streak
        self._backoff = Backoff(base=backoff_base, cap=backoff_cap)
        self._fast_crash_s = float(fast_crash_s)
        self._breaker_threshold = max(1, int(breaker_threshold))
        self._breaker_reset_s = float(breaker_reset_s)
        self._poll_s = float(poll_s)
        self._lock = threading.Lock()
        self._closed = False
        self._restarts_total = 0
        now = time.monotonic()
        self._slots: list[dict] = [
            {"proc": None, "spawned_at": now, "restarts": 0, "fast_crashes": 0,
             "next_spawn": 0.0, "breaker_until": None}
            for _ in range(max(1, int(n)))
        ]
        for slot in self._slots:
            self._spawn(slot)
        import weakref

        ref = weakref.ref(self)
        M_FE_CONFIGURED.set_function(lambda: len(s._slots) if (s := ref()) is not None else 0)
        M_FE_ALIVE.set_function(lambda: s.alive() if (s := ref()) is not None else 0)
        self._monitor = threading.Thread(target=self._monitor_loop, daemon=True,
                                         name="misaka-frontend-supervisor")
        self._monitor.start()

    def pids(self) -> list[int]:
        """The live workers' pids."""
        with self._lock:
            return [s["proc"].pid for s in self._slots
                    if s["proc"] is not None and s["proc"].poll() is None]

    def alive(self) -> int:
        return len(self.pids())

    def state(self) -> dict:
        """The /healthz and /status block: `degraded` whenever a slot is
        down or its breaker is open."""
        now = time.monotonic()
        with self._lock:
            alive = sum(1 for s in self._slots
                        if s["proc"] is not None and s["proc"].poll() is None)
            broken = sum(1 for s in self._slots
                         if s["breaker_until"] is not None and s["breaker_until"] > now)
            configured = len(self._slots)
            restarts = self._restarts_total
        return {"configured": configured, "alive": alive, "restarts_total": restarts,
                "breaker_open": broken, "degraded": alive < configured or broken > 0}

    def close(self) -> None:
        with self._lock:
            self._closed = True
            procs = [s["proc"] for s in self._slots if s["proc"] is not None]
        for p in procs:
            try:
                p.terminate()
            except OSError:
                pass
        for p in procs:
            # reap: an unreaped child stays a zombie for the host's lifetime
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=5)
        self._monitor.join(timeout=2)

    def _spawn(self, slot: dict) -> None:
        slot["proc"] = subprocess.Popen(self._cmd)
        slot["spawned_at"] = time.monotonic()

    def _monitor_loop(self) -> None:
        while True:
            time.sleep(self._poll_s)
            # decide under the lock, fork outside it: state() serves
            # /healthz off the same lock
            due: list[dict] = []
            with self._lock:
                if self._closed:
                    return
                now = time.monotonic()
                for slot in self._slots:
                    proc = slot["proc"]
                    if proc is not None and proc.poll() is not None:  # poll() reaps
                        lifetime = now - slot["spawned_at"]
                        slot["proc"] = None
                        fast = lifetime < self._fast_crash_s
                        slot["fast_crashes"] = slot["fast_crashes"] + 1 if fast else 0
                        if slot["fast_crashes"] >= self._breaker_threshold:
                            slot["breaker_until"] = now + self._breaker_reset_s
                            log.error("frontend worker crash loop (%d fast deaths, last exit "
                                      "%s): circuit breaker open for %.0fs",
                                      slot["fast_crashes"], proc.returncode,
                                      self._breaker_reset_s)
                        else:
                            delay = self._backoff.delay_for(slot["fast_crashes"] - 1)
                            slot["next_spawn"] = now + delay
                            log.warning("frontend worker died (exit %s after %.1fs); "
                                        "respawn in %.2fs", proc.returncode, lifetime, delay)
                    if slot["proc"] is None:
                        if slot["breaker_until"] is not None:
                            if now < slot["breaker_until"]:
                                continue
                            slot["breaker_until"] = None  # half-open: one retry
                            log.warning("frontend circuit breaker half-open: retrying one "
                                        "respawn")
                        elif now < slot["next_spawn"]:
                            continue
                        due.append(slot)
            spawned: list[dict] = []
            for slot in due:
                # only this thread mutates slots
                try:
                    self._spawn(slot)
                except OSError as e:
                    # fork/exec failed: retry on the backoff curve, as for
                    # another fast crash; the monitor must survive it
                    log.error("frontend worker spawn failed (%s); retrying with backoff", e)
                    with self._lock:
                        slot["fast_crashes"] += 1
                        slot["next_spawn"] = time.monotonic() + self._backoff.delay_for(
                            slot["fast_crashes"] - 1)
                    continue
                spawned.append(slot)
            if not spawned:
                continue
            with self._lock:
                if self._closed:
                    # close() ran between the spawns and here; its
                    # terminate pass missed these
                    for slot in spawned:
                        try:
                            slot["proc"].terminate()
                            slot["proc"].wait(timeout=5)
                        except (OSError, subprocess.TimeoutExpired):
                            pass
                    return
                for slot in spawned:
                    slot["restarts"] += 1
                    self._restarts_total += 1
                    M_FE_RESTARTS.inc()
                    log.info("frontend worker respawned (pid %d, slot restarts %d)",
                             slot["proc"].pid, slot["restarts"])


def wait_ready(port: int, timeout: float = 10.0, host: str = "127.0.0.1") -> bool:
    """Poll until a TCP connect to the public port succeeds."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with socket.create_connection((host, port), timeout=1):
                return True
        except OSError:
            time.sleep(0.05)
    return False


def pick_free_port() -> int:
    """A free TCP port for the shared SO_REUSEPORT bind (racy by nature)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]



# --- the native edge: the C++ epoll frontend tier ---------------------------------

M_NE_UP = metrics.gauge(
    "misaka_native_edge_up",
    "1 while the C++ native edge tier is serving the public port "
    "(0/absent = CPython worker tier)",
)
M_NE_CONNS = metrics.gauge(
    "misaka_native_edge_connections_open",
    "Client connections currently open on the native edge",
)
M_NE_REQUESTS = metrics.counter(
    "misaka_native_edge_requests_total",
    "HTTP requests terminated by the native edge (served or proxied)",
)
M_NE_PLANE = metrics.counter(
    "misaka_native_edge_plane_frames_total",
    "Compute frames the native edge shipped directly over the plane "
    "(the no-GIL hot path)",
)
M_NE_PROXIED = metrics.counter(
    "misaka_native_edge_proxied_total",
    "Requests the native edge proxied to the CPython worker tier "
    "(admin routes, GETs, cold programs, bulk bodies)",
)
M_NE_LOCAL_REJECTS = metrics.counter(
    "misaka_native_edge_local_rejects_total",
    "Requests the native edge rejected from pushed edge state without "
    "a plane round-trip (401 unknown/missing key, 413 burst, shed "
    "cache, overload) — each also bills misaka_edge_rejected_total "
    "via frame metadata",
)


def _configure_frontend(lib: ctypes.CDLL) -> None:
    lib.msk_edge_start.restype = ctypes.c_int
    lib.msk_edge_start.argtypes = [ctypes.c_char_p]
    lib.msk_edge_port.restype = ctypes.c_int
    lib.msk_edge_port.argtypes = []
    lib.msk_edge_push_state.restype = ctypes.c_int
    lib.msk_edge_push_state.argtypes = [ctypes.c_char_p]
    lib.msk_edge_stats.restype = ctypes.c_int64
    lib.msk_edge_stats.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.msk_edge_spans.restype = ctypes.c_int64
    lib.msk_edge_spans.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.msk_edge_captures.restype = ctypes.c_int64
    lib.msk_edge_captures.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.msk_edge_stop.restype = None
    lib.msk_edge_stop.argtypes = []
    lib.msk_edge_last_error.restype = ctypes.c_char_p
    lib.msk_edge_last_error.argtypes = []


# frontend.cpp includes the two codec headers: the library's content tag
# hashes all three, in the reference Makefile's order
_FRONTEND_LIB = NativeLib("frontend", _configure_frontend, so_env="MISAKA_FRONTEND_SO",
                          parts=("msk_http.hpp", "msk_frame.hpp", "frontend.cpp"))

# the Perfetto exporter reads the edge's spans through a module-level
# source holding the live supervisor weakly: a closed one pins nothing,
# and registering again across server restarts in one process is a no-op
_ACTIVE_NATIVE_EDGE = None  # weakref.ref[NativeFrontendSupervisor] | None


def _native_edge_spans() -> list:
    sup = _ACTIVE_NATIVE_EDGE() if _ACTIVE_NATIVE_EDGE is not None else None
    if sup is None:
        return []
    return sup.recent_spans()


def _read_json(fn, cap: int):
    """A JSON document the C++ tier writes into a buffer (`fn(buf, cap)`:
    its length, negative when the buffer is too small): one retry at 4x
    the size; None when it does not fit or does not parse."""
    for _ in range(2):
        buf = ctypes.create_string_buffer(cap)
        n = fn(buf, cap)
        if n >= 0:
            try:
                return json.loads(buf.raw[:n].decode("utf-8", "replace")) if n else None
            except ValueError:
                return None
        cap *= 4
    return None


class NativeFrontendSupervisor:
    """Build, start and feed the in-process C++ edge.

    Its contract is FrontendSupervisor's (`port`, state(), close()), so the
    app treats either tier alike.  The watcher thread is the push plane:
    every 0.5 s it snapshots the edge chain (the key file is stat'd inside,
    so a rotation lands within a second), the registry's programs, the
    tracing, SLO and capture flags and, every other tick, the engine's
    /healthz body, and pushes the bundle into C++ only when it changed.
    The same thread pumps the tier's counters into the `misaka_native_edge_*`
    series, drains its spans into the Perfetto export and ingests its
    capture rows under surface "edge".

    Any failure in __init__ raises: the app catches it and keeps the
    CPython workers on the public port."""

    def __init__(self, *, port: int, proxy_port: int, plane_path: str, chain=None,
                 registry=None, healthz_url: str | None = None, threads: int | None = None,
                 max_conns: int | None = None, plane_conns: int = 2, environ=os.environ):
        # the fallback's own chaos point, where a missing toolchain fails
        if faults.armed() and faults.fire("edge_native_build") is not None:
            raise RuntimeError("native edge build failed (injected fault)")
        lib = _FRONTEND_LIB.load()
        if lib is None:
            raise RuntimeError(
                "native edge unavailable: frontend.so failed to build/load (no g++?)")
        self._lib = lib
        self._chain = chain if chain is not None else edge_mod.current()
        self._registry = registry
        self._healthz_url = healthz_url
        if threads is None:
            threads = int(environ.get("MISAKA_NATIVE_EDGE_THREADS", "")
                          or min(8, max(2, (os.cpu_count() or 2) // 2)))
        if max_conns is None:
            max_conns = int(environ.get("MISAKA_NATIVE_EDGE_MAX_CONNS", "") or 4096)
        config = {
            "port": int(port),
            "threads": int(threads),
            "max_conns": int(max_conns),
            "plane_conns": int(plane_conns),
            "plane_depth_max": int(environ.get("MISAKA_PLANE_DEPTH_MAX", "") or 256),
            "proxy_port": int(proxy_port),
            "proxy_host": "127.0.0.1",
            "max_body": int(environ.get("MISAKA_MAX_BODY", "") or 64 * 1024 * 1024),
            "plane_body_limit": MAX_FRAME_VALUES * 2,
            "plane_timeout_s": float(environ.get("MISAKA_PLANE_TIMEOUT_S", "") or 30.0),
            # the C++ tier dials unix planes only: the first of the list
            # (the Python router owns a fleet's TCP peers)
            "plane_path": next((p for p in plane_path.split(",")
                                if p and parse_plane_addr(p)[0] == "unix"), None),
        }
        if config["plane_path"] is None:
            raise RuntimeError(
                f"native edge unavailable: no unix plane in {plane_path!r} (the C++ "
                "tier does not speak the TCP plane transport)")
        secret = edge_mod.plane_secret(environ)
        if secret is not None:
            config["handshake_hex"] = edge_mod.plane_handshake(secret).hex()
        if lib.msk_edge_start(json.dumps(config).encode()) != 0:
            raise RuntimeError("native edge failed to start: "
                               + (lib.msk_edge_last_error() or b"?").decode("utf-8", "replace"))
        self.port = int(lib.msk_edge_port())
        self.proxy_port = int(proxy_port)
        self._lock = threading.Lock()
        self._closed = False
        self._last_push: str | None = None
        self._healthz_body: bytes | None = None
        self._healthz_ctype: str | None = None
        self._span_buf: deque = deque(maxlen=4096)
        self._last_stats: dict = {}
        try:
            self._push(force=True)
        except Exception:
            # the C++ loop is live: release it, or the process's one edge
            # stays taken for every later boot
            lib.msk_edge_stop()
            raise
        import weakref

        global _ACTIVE_NATIVE_EDGE
        _ACTIVE_NATIVE_EDGE = weakref.ref(self)
        tracespan.register_tier_source(_native_edge_spans)
        ref = weakref.ref(self)
        M_NE_UP.set_function(lambda: 0 if (s := ref()) is None or s._closed else 1)
        M_NE_CONNS.set_function(
            lambda: s._last_stats.get("conns_open", 0) if (s := ref()) is not None else 0)
        self._watcher = threading.Thread(target=self._watch_loop, daemon=True,
                                         name="misaka-native-edge-supervisor")
        self._watcher.start()
        log.info("native edge serving :%d (%d threads, proxy -> 127.0.0.1:%d, plane %s)",
                 self.port, threads, proxy_port, config["plane_path"])

    # --- the push plane -------------------------------------------------------

    def _snapshot(self) -> dict:
        state = edge_mod.native_edge_state(self._chain)
        if self._registry is not None:
            try:
                state["programs"] = sorted(self._registry._entries.keys())
            except Exception:
                state["programs"] = []
        state["trace_enabled"] = tracespan.enabled()
        state["trace_sample"] = float(getattr(tracespan, "_SAMPLE", 1.0))
        state["slo_armed"] = bool(slo.armed())
        # the edge records its local rejects only while the engine's
        # recorder runs, at its sample rate
        state["capture_enabled"] = capture_mod.recording()
        state["capture_sample"] = capture_mod.sample_rate()
        if self._healthz_body is not None:
            state["healthz_body"] = self._healthz_body.decode("utf-8", "replace")
            state["healthz_ctype"] = self._healthz_ctype or "application/json"
        return state

    def _push(self, force: bool = False) -> None:
        js = json.dumps(self._snapshot(), sort_keys=True)
        if not force and js == self._last_push:
            return
        if self._lib.msk_edge_push_state(js.encode()) != 0:
            log.warning("native edge rejected state push: %s",
                        (self._lib.msk_edge_last_error() or b"?").decode("utf-8", "replace"))
            return
        self._last_push = js

    def _fetch_healthz(self) -> None:
        if self._healthz_url is None:
            return
        import urllib.request

        try:
            with urllib.request.urlopen(self._healthz_url, timeout=2) as r:
                self._healthz_body = r.read()
                self._healthz_ctype = r.headers.get("Content-Type", "application/json")
        except Exception:
            pass  # the engine is booting or draining: keep the last snapshot

    # --- observability ----------------------------------------------------------

    def _read_stats(self) -> dict:
        buf = ctypes.create_string_buffer(1024)
        n = self._lib.msk_edge_stats(buf, len(buf))
        if n <= 0:
            return {}
        try:
            return json.loads(buf.raw[:n].decode())
        except ValueError:
            return {}

    def _pump_metrics(self) -> None:
        stats = self._read_stats()
        if not stats:
            return
        prev = self._last_stats
        for field, counter in (("requests", M_NE_REQUESTS), ("plane", M_NE_PLANE),
                               ("proxied", M_NE_PROXIED)):
            d = stats.get(field, 0) - prev.get(field, 0)
            if d > 0:
                counter.inc(d)
        local = ("local_401", "local_413", "shed_hits", "overload")
        rejects = sum(stats.get(f, 0) for f in local) - sum(prev.get(f, 0) for f in local)
        if rejects > 0:
            M_NE_LOCAL_REJECTS.inc(rejects)
        self._last_stats = stats

    def _drain_spans(self) -> None:
        recs = _read_json(self._lib.msk_edge_spans, 256 * 1024)
        if not recs:
            return
        with self._lock:
            for r in recs:
                attrs = {"_lane": r.get("lane") or "edge"}
                if r.get("trace"):
                    attrs["trace_ids"] = [r["trace"]]
                self._span_buf.append(tracespan.Span(
                    r.get("name", "frontend.edge"), float(r.get("start", 0.0)),
                    float(r.get("dur", 0.0)), attrs))

    def _drain_captures(self) -> None:
        """The edge's capture rows (its local rejects, sampled there) into
        the engine's capture ring."""
        if not capture_mod.RECORDING:
            return
        payload = _read_json(self._lib.msk_edge_captures, 256 * 1024)
        rows = (payload or {}).get("records") or []
        if rows:
            capture_mod.ingest("edge", rows, pre_sampled=True)

    def recent_spans(self, window_s: float = 15.0) -> list:
        """The edge's per-request spans of the last `window_s` for the
        Perfetto export (a tier source): `_lane` per edge thread and
        `trace_ids`, so one X-Misaka-Trace still renders one timeline from
        the edge down to the engine."""
        self._drain_spans()
        now = time.monotonic()
        with self._lock:
            return [s for s in self._span_buf if now - s.start <= window_s]

    def state(self) -> dict:
        """The /healthz `native_edge` block."""
        stats = self._read_stats() or dict(self._last_stats)
        stats["up"] = not self._closed
        return stats

    # --- lifecycle ---------------------------------------------------------------

    def _watch_loop(self) -> None:
        tick = 0
        while not self._closed:
            time.sleep(0.5)
            if self._closed:
                return
            try:
                if tick % 2 == 0:
                    self._fetch_healthz()
                self._push()
                self._pump_metrics()
                self._drain_spans()
                self._drain_captures()
            except Exception:
                log.exception("native edge watcher tick failed")
            tick += 1

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._lib.msk_edge_stop()


if __name__ == "__main__":
    sys.exit(frontend_main())
