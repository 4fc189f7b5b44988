"""Synthetic canaries: an always-on prober through every serving tier.

The port's twin of misaka_tpu/runtime/canary.py.  The health plane is
otherwise passive: it reports what real traffic did, so an idle (or
silently broken) stack reads as healthy until the first request fails.
A background prober drives a known-answer program through the whole
public path on a low cadence (``MISAKA_CANARY_INTERVAL_S``, default 5 s),
plus one shallow probe per tier underneath, so a failure is attributed to
the first failing tier:

  edge    GET /healthz through the public HTTP listener (TLS and the edge
          chain included): the load balancer's view of the door.
  plane   one zero-value probe frame over the engine's compute plane
          (handshake included); "off" when no plane serves.
  engine  a direct compute on the canary program's engine through a
          registry lease: the ServeBatcher and the device loop with no
          HTTP or plane in front.
  full    POST /programs/_canary/compute_raw through the public listener:
          edge -> (frontend plane) -> ServeBatcher -> engine, the output
          checked against the known answer.

If ``full`` fails while edge, plane and engine pass, the fault is in the
serving path between them (frontend routing or the batcher), reported as
tier ``serve``.

The canary program (``_canary``, IN ACC / ADD 7 / OUT ACC) is published
into the registry on first use and serves from its own engine like any
tenant, at the registry's batch: it takes one of MISAKA_REGISTRY_MAX_ACTIVE
slots, and it is not pinned, so capacity pressure evicts it and the next
probe revives it through the checkpoint path.

Surfaces: ``misaka_canary_success{tier}`` (1/0 per probe),
``misaka_canary_latency_seconds{tier}``, the probe and failure counters,
and a ``canary`` block on ``/healthz``.  Armed by the app only
(runtime/app.py), never by a bare make_http_server: tests build many
servers per process, and a process-global prober aimed at a dead port
would poison them all.  ``MISAKA_CANARY=0`` is the kill switch.

Canary traffic is tagged by its program name: the usage ledger books it
under the ``_canary`` account, exempt from the cardinality collapse and
left out of exports (runtime/usage.py EXEMPT_LABELS); the SLO engine never
observes it (utils/slo.py EXCLUDED_PROGRAMS); the capture recorder files
it under ``_canary``, never in a tenant's stream.  The TSDB keeps these
series' history, the dashboard draws the canary panel, and the
watchdog's default ``canary-full`` rule (utils/watchdog.py) pages when the
full tier keeps failing.
"""

from __future__ import annotations

import http.client
import logging
import os
import socket
import ssl
import struct
import threading
import time
import weakref

from misaka_tpu_torch.utils import metrics

log = logging.getLogger("misaka_tpu_torch.canary")

PROGRAM = "_canary"
# the known-answer source: out = in + 7, one small program slot
SOURCE = "IN ACC\nADD 7\nOUT ACC\n"
DELTA = 7
DEFAULT_INTERVAL_S = 5.0

TIERS = ("edge", "plane", "engine", "full")

M_PROBES = metrics.counter(
    "misaka_canary_probes_total", "Canary probes attempted, by tier", ("tier",),
)
M_FAILURES = metrics.counter(
    "misaka_canary_failures_total", "Canary probes that failed, by tier", ("tier",),
)
M_SUCCESS = metrics.gauge(
    "misaka_canary_success",
    "Last canary probe outcome by tier (1 ok / 0 failed; absent = tier "
    "not probed in this process)",
    ("tier",),
)
M_LATENCY = metrics.histogram(
    "misaka_canary_latency_seconds", "Canary probe latency by tier", ("tier",),
)


class CanaryProber:
    """The probing thread + last-cycle state."""

    def __init__(self, base_url: str, registry=None, server=None,
                 interval_s: float = DEFAULT_INTERVAL_S, token: str | None = None,
                 program: str = PROGRAM, values: int = 4, full_stack: bool | None = None,
                 probe_timeout_s: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.interval_s = max(0.05, float(interval_s))
        self.program = program
        self.token = token
        self.values = max(1, int(values))
        self.probe_timeout_s = max(0.1, float(probe_timeout_s))
        self._registry = registry
        # drive the full public stack?  Default: only with a registry in
        # process; full_stack=True registers the program over POST
        # /programs instead (a front with the registries behind it)
        self._full_stack = full_stack if full_stack is not None else registry is not None
        # the serving HTTP server, held weakly (the canary must never keep
        # a dead server alive): read each cycle for `misaka_plane`, which
        # the app attaches after make_http_server returns
        self._server = weakref.ref(server) if server is not None else None
        self._registered = False
        self._lock = threading.Lock()
        self._tiers: dict[str, dict] = {}
        self._failing_tier: str | None = None
        self._consecutive_full_failures = 0
        self._cycles = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        u = self.base_url
        self._tls = u.startswith("https:")
        host, _, port = u.split("://", 1)[-1].partition(":")
        self._host = host or "127.0.0.1"
        self._port = int(port or (443 if self._tls else 80))

    # --- lifecycle ------------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        if self.running:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="misaka-canary")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.probe_once()
            except Exception:  # the prober must never take serving down
                log.exception("canary cycle crashed")

    # --- probe plumbing -------------------------------------------------------

    def _conn(self, timeout: float) -> http.client.HTTPConnection:
        if self._tls:
            # a loopback self-probe: the serving cert is routinely
            # self-signed and names the public host, neither of which a
            # localhost probe can verify (transport only, no authn)
            return http.client.HTTPSConnection(self._host, self._port, timeout=timeout,
                                               context=ssl._create_unverified_context())
        return http.client.HTTPConnection(self._host, self._port, timeout=timeout)

    def _headers(self) -> dict:
        return {"X-Misaka-Key": self.token} if self.token else {}

    def _record(self, tier: str, ok: bool, dur_s: float, error: str | None = None) -> None:
        M_PROBES.labels(tier=tier).inc()
        M_SUCCESS.labels(tier=tier).set(1.0 if ok else 0.0)
        M_LATENCY.labels(tier=tier).observe(dur_s)
        if not ok:
            M_FAILURES.labels(tier=tier).inc()
        row = {"ok": ok, "latency_ms": round(dur_s * 1e3, 3), "last_unix": round(time.time(), 3)}
        if error:
            row["error"] = error[:300]
        with self._lock:
            self._tiers[tier] = row

    def _mark_off(self, tier: str, reason: str) -> None:
        with self._lock:
            self._tiers[tier] = {"ok": None, "off": reason}

    # --- the tiers ------------------------------------------------------------

    def _probe_edge(self) -> bool:
        t0 = time.monotonic()
        try:
            conn = self._conn(timeout=5.0)
            try:
                conn.request("GET", "/healthz", headers=self._headers())
                resp = conn.getresponse()
                resp.read()
                ok = resp.status == 200
                err = None if ok else f"status {resp.status}"
            finally:
                conn.close()
        except (OSError, http.client.HTTPException) as e:
            ok, err = False, repr(e)
        self._record("edge", ok, time.monotonic() - t0, err)
        return ok

    def _plane_path(self) -> str | None:
        server = self._server() if self._server is not None else None
        plane = getattr(server, "misaka_plane", None) if server else None
        if plane is not None and not getattr(plane, "_closed", False):
            return plane.path
        return None

    def _probe_plane(self) -> bool | None:
        """None = no plane serving in this process (tier off)."""
        path = self._plane_path()
        if path is None:
            self._mark_off("plane", "no compute plane in this process")
            return None
        from misaka_tpu_torch.runtime import edge as edge_mod
        from misaka_tpu_torch.runtime.frontends import (
            _REQ_HDR,
            _RESP_HDR,
            PLANE_DRAINING,
            _recv_exact,
            parse_plane_addr,
        )

        t0 = time.monotonic()
        ok, err = False, None
        try:
            family, host, port = parse_plane_addr(path)
            sock = socket.socket(socket.AF_INET if family == "tcp" else socket.AF_UNIX,
                                 socket.SOCK_STREAM)
            sock.settimeout(2.0)
            try:
                sock.connect((host, port) if family == "tcp" else path)
                secret = edge_mod.plane_secret()
                if secret is not None:
                    sock.sendall(edge_mod.plane_handshake(secret))
                meta = b'{"probe": 1}'
                sock.sendall(_REQ_HDR.pack(0, len(meta)) + meta)
                status, length = _RESP_HDR.unpack(_recv_exact(sock, 8))
                if length:
                    _recv_exact(sock, length)
                ok = status in (200, PLANE_DRAINING)
                err = None if ok else f"plane status {status}"
            finally:
                sock.close()
        except (OSError, struct.error) as e:
            ok, err = False, repr(e)
        self._record("plane", ok, time.monotonic() - t0, err)
        return ok

    def _ensure_program(self) -> bool:
        """Publish the known-answer program once: through the registry when
        one is in process, over the public POST /programs otherwise.
        Non-fatal: a busy registry retries next cycle."""
        if self._registered:
            return True
        if self._registry is not None:
            try:
                if self.program not in self._registry.list_programs()["programs"]:
                    self._registry.publish(self.program, tis=SOURCE)
                self._registered = True
            except Exception as e:
                log.warning("canary: cannot register %s yet: %s", self.program, e)
            return self._registered
        if not self._full_stack:
            return False
        try:
            from urllib.parse import urlencode

            body = urlencode({"name": self.program, "program": SOURCE}).encode()
            conn = self._conn(timeout=10.0)
            try:
                conn.request("POST", "/programs", body, headers={
                    **self._headers(), "Content-Type": "application/x-www-form-urlencoded"})
                resp = conn.getresponse()
                resp.read()
                self._registered = resp.status == 200
                if not self._registered:
                    log.warning("canary: POST /programs for %s answered %d",
                                self.program, resp.status)
            finally:
                conn.close()
        except (OSError, http.client.HTTPException) as e:
            log.warning("canary: cannot register %s yet: %s", self.program, e)
        return self._registered

    def _probe_engine(self) -> bool | None:
        """A direct compute through the canary program's engine lease: no
        HTTP, no plane.  None when no registry is armed."""
        if self._registry is None:
            self._mark_off("engine", "no program registry in this process")
            return None
        if not self._ensure_program():
            self._mark_off("engine", "canary program not registered yet")
            return None
        vals = list(range(1, self.values + 1))
        t0 = time.monotonic()
        ok, err = False, None
        try:
            with self._registry.lease(self.program, values=len(vals)) as m:
                out = m.compute_many(vals, timeout=self.probe_timeout_s)
            got = [int(v) for v in out]
            want = [v + DELTA for v in vals]
            ok = got == want
            err = None if ok else f"answer {got} != {want}"
        except Exception as e:
            ok, err = False, repr(e)
        self._record("engine", ok, time.monotonic() - t0, err)
        return ok

    def _probe_full(self) -> bool | None:
        """The whole public stack: POST /programs/_canary/compute_raw."""
        if not self._full_stack:
            self._mark_off("full", "no program registry behind this surface")
            return None
        if not self._ensure_program():
            self._mark_off("full", "canary program not registered yet")
            return None
        vals = list(range(1, self.values + 1))
        body = b"".join(struct.pack("<i", v) for v in vals)
        t0 = time.monotonic()
        ok, err = False, None
        try:
            conn = self._conn(timeout=self.probe_timeout_s)
            try:
                conn.request("POST", f"/programs/{self.program}/compute_raw?spread=1", body,
                             headers=self._headers())
                resp = conn.getresponse()
                raw = resp.read()
                if resp.status != 200:
                    err = f"status {resp.status}: {raw[:120]!r}"
                else:
                    got = [struct.unpack_from("<i", raw, i * 4)[0]
                           for i in range(len(raw) // 4)]
                    want = [v + DELTA for v in vals]
                    ok = got == want
                    err = None if ok else f"answer {got} != {want}"
            finally:
                conn.close()
        except (OSError, http.client.HTTPException, struct.error) as e:
            ok, err = False, repr(e)
        self._record("full", ok, time.monotonic() - t0, err)
        return ok

    # --- one cycle ------------------------------------------------------------

    def probe_once(self) -> dict:
        """All tiers, shallow to deep; returns state() (tests call this for
        a deterministic cadence)."""
        edge_ok = self._probe_edge()
        plane_ok = self._probe_plane()
        engine_ok = self._probe_engine()
        full_ok = self._probe_full()
        failing = None
        if edge_ok is False:
            failing = "edge"
        elif plane_ok is False:
            failing = "plane"
        elif engine_ok is False:
            failing = "engine"
        elif full_ok is False:
            # every tier underneath passed: the fault is the serving path
            # between them (frontend routing, the batcher)
            failing = "serve"
        with self._lock:
            self._cycles += 1
            if full_ok is False:
                self._consecutive_full_failures += 1
            elif full_ok:
                self._consecutive_full_failures = 0
            self._failing_tier = failing
        return self.state()

    def state(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "running": self.running,
                "interval_s": self.interval_s,
                "program": self.program,
                "cycles": self._cycles,
                "failing_tier": self._failing_tier,
                "consecutive_full_failures": self._consecutive_full_failures,
                "tiers": {t: dict(v) for t, v in self._tiers.items()},
            }


# --- the process-global instance ----------------------------------------------

_lock = threading.Lock()
_canary: CanaryProber | None = None


def enabled(environ=os.environ) -> bool:
    return environ.get("MISAKA_CANARY", "1") != "0"


def get() -> CanaryProber | None:
    return _canary


def ensure_started(base_url: str, registry=None, server=None, token: str | None = None,
                   full_stack: bool | None = None,
                   environ=os.environ) -> CanaryProber | None:
    """Start the process canary against `base_url` (called by the app,
    never by a bare make_http_server); None when MISAKA_CANARY=0."""
    global _canary
    if not enabled(environ):
        return None
    with _lock:
        if _canary is None:
            try:
                interval = float(environ.get("MISAKA_CANARY_INTERVAL_S", "")
                                 or DEFAULT_INTERVAL_S)
            except ValueError:
                interval = DEFAULT_INTERVAL_S
            _canary = CanaryProber(
                base_url, registry=registry, server=server, interval_s=interval,
                full_stack=full_stack,
                token=token or environ.get("MISAKA_EDGE_INTERNAL_TOKEN") or None,
            )
        if not _canary.running:
            _canary.start()
    return _canary


def shutdown() -> None:
    """Stop and drop the process canary."""
    global _canary
    with _lock:
        if _canary is not None:
            _canary.stop()
            _canary = None


def state_payload() -> dict | None:
    """The `canary` block on /healthz (None when no prober runs)."""
    c = _canary
    return c.state() if c is not None else None
