"""Typed Python client for the master's HTTP surface.

The port's own copy of misaka_tpu/client.py: the same methods, wire and
retry rules, against either package's server.  It wraps the reference's
five routes plus every additive route, with the two bulk lanes a
throughput client wants:

  compute(v)          POST /compute        one value, int -> int
  compute_batch(vals) POST /compute_batch  decimal text, vectorized codec
  compute_raw(vals)   POST /compute_raw    raw little-endian int32 bodies
                                           (the fleet-client wire format)
  run/pause/reset     POST /run /pause /reset
  load(target, prog)  POST /load
  status()/trace()    GET  /status /trace
  healthz()/metrics() GET  /healthz /metrics  (liveness + Prometheus text)
  usage()/alerts()    GET  /debug/usage /debug/alerts  (per-program cost
                      ledger + SLO burn-rate states); flamegraph() GET
                      /debug/flamegraph (continuous profiler)
  checkpoint/restore  POST /checkpoint /restore  (server-side .npz)
  profile_start/stop  POST /profile/start /profile/stop
  upload_program/list_programs/program_info  POST/GET /programs*
                      (the registry surface; Client(program=...) pins a
                      session to one registry program)

The module imports stdlib only (numpy lazily, inside the bulk methods)
and never torch: the scalar and lifecycle surface is importable on any ops
box.  Routes a server does not serve (the port's server has no registry,
usage, SLO, capture or fleet planes yet) answer as that server answers
them: the client raises MisakaClientError with its status and body.

Transport: every request rides a POOLED persistent HTTP/1.1 connection
(the server keeps keep-alive since r8) — the reference pays TCP setup +
teardown per transferred value; a fleet client must not.  A connection
dropped by the server (restart, idle timeout) reconnects cleanly: the
retry happens only when the failure hit a REUSED pooled socket before a
response arrived, so a request is never silently replayed against a
connection that might have executed it.
"""

from __future__ import annotations

import http.client
import json
import threading
import urllib.error
import urllib.parse


class MisakaClientError(RuntimeError):
    """Non-2xx response from the master (carries status + body text, and
    the server's trace ID when the response had one — a 503/timeout then
    names the exact request to grep for in `/debug/requests/<id>` and
    the server's JSON logs)."""

    def __init__(self, status: int, body: str, trace_id: str | None = None,
                 retry_after: float | None = None):
        msg = f"HTTP {status}: {body}"
        if trace_id:
            msg += f" [trace {trace_id}]"
        if retry_after is not None:
            msg += f" (retry after {retry_after:g}s)"
        super().__init__(msg)
        self.status = status
        self.body = body
        self.trace_id = trace_id
        #: structured per-request divergence records when the server
        #: refused a ?verify=replay publish (HTTP 409 JSON body
        #: {"error", "diffs"}) — each names the captured request's
        #: trace/offset and the expected-vs-actual value heads.  Empty
        #: for every other error shape.
        self.diffs: list = []
        if status == 409 and body.lstrip().startswith("{"):
            try:
                obj = json.loads(body)
                if isinstance(obj, dict) and isinstance(
                    obj.get("diffs"), list
                ):
                    self.diffs = obj["diffs"]
            except ValueError:
                pass
        #: seconds from the response's Retry-After header (None when the
        #: server sent none).  A 429 carries it always — back off for
        #: this long instead of retrying hot (the edge's token bucket
        #: will just burn your next request too).
        self.retry_after = retry_after


class TracedInt(int):
    """An int carrying the response's tracing context: ``timings`` (the
    parsed ``Server-Timing`` phases, ms) and ``trace_id``."""

    timings: dict | None = None
    trace_id: str | None = None


def _parse_server_timing(value: str) -> dict:
    """"queue;dur=1.2, total;dur=3.4" -> {"queue": 1.2, "total": 3.4}.
    One parser for both halves of the wire (lazy import: tracespan is
    stdlib-only like this client, but the scalar/lifecycle surface
    shouldn't pay any misaka import until a response carries timings)."""
    from misaka_tpu_torch.utils.tracespan import parse_server_timing

    return parse_server_timing(value)


_traced_array_cls = None


def _traced_array(arr, headers):
    """`arr` as a numpy view carrying ``.timings`` + ``.trace_id`` (the
    subclass is built lazily so the scalar/lifecycle client surface stays
    numpy-free)."""
    global _traced_array_cls
    import numpy as np

    if _traced_array_cls is None:
        class TracedArray(np.ndarray):
            """An int32 result array + the response's tracing context."""

            timings = None
            trace_id = None

        _traced_array_cls = TracedArray
    out = arr.view(_traced_array_cls)
    st = headers.get("Server-Timing")
    out.timings = _parse_server_timing(st) if st else {}
    out.trace_id = headers.get("X-Misaka-Trace")
    return out


class MisakaClient:
    """A client session against one master (`base_url`, default port 8000).

    Methods raise MisakaClientError on any non-2xx response (e.g. 400
    "network is not running", 500 compute timeout) and wrap connection
    failures in urllib.error.URLError (the documented socket-error shape
    since r1; the transport is http.client underneath).

    Thread-safe: concurrent callers draw idle connections from a shared
    pool (LIFO — the hottest socket stays warm) and return them after
    each response; `pool_size` caps how many idle sockets are retained.
    """

    def __init__(self, base_url: str = "http://localhost:8000",
                 timeout: float = 30.0, pool_size: int = 4,
                 retry_stale: bool = True, connect_retries: int = 3,
                 program: str | None = None, api_key: str | None = None,
                 ca: str | None = None, tls_insecure: bool = False,
                 wire: str | None = None):
        """`retry_stale` (default True) replays a request ONCE when a
        POOLED connection proves dead at send time or before any
        response byte arrives — the stale-keep-alive case.  This is
        at-least-once: in the rare window where the server executed the
        request and died before writing a byte, the replay executes it
        twice.  Pass False for strict at-most-once (stale pooled sockets
        then surface as URLError and the caller decides).

        `connect_retries` (default 3) retries a request whose FRESH
        connection was refused outright — the server-restarting window
        (a supervisor respawning a frontend worker, a rolling deploy) —
        with exponential backoff (0.1s doubling, jittered).  Distinct
        from `retry_stale` and always safe: connection refused means the
        kernel rejected the dial, so nothing was ever sent to execute.
        Pass 0 to surface the first refusal as URLError immediately.

        `program` pins this session to one registry program: compute /
        compute_batch / compute_raw then ride the program-addressed
        routes (POST /programs/<name>/compute*).  Accepts "name",
        "name@latest", or "name@<version>"; requires the server to run
        with MISAKA_PROGRAMS_DIR (unknown programs answer 404).  None
        (default) keeps the legacy routes, which serve the seeded
        default program.

        `api_key` authenticates this session against a server with the
        edge armed (MISAKA_API_KEYS): sent as X-Misaka-Key on every
        request.  Defaults to the MISAKA_API_KEY env var, so ops scripts
        need no code change to authenticate.  A 401/403/429 surfaces as
        MisakaClientError with `.status` and (for 429) `.retry_after`.

        An `https://` base_url speaks TLS (server-side MISAKA_TLS_CERT/
        KEY): `ca` pins a CA bundle path (the `make cert` ca.cert, or
        the self-signed service cert itself); `tls_insecure=True` skips
        verification (lab use).  Default with neither: the system trust
        store.

        `wire` selects the bulk-lane encoding: "auto" (default) speaks
        the headered binary protocol (utils/wire.py — raw little-endian
        int32 + a 12-byte header, negotiated via Content-Type/Accept)
        when the server advertises `wire_binary` on /healthz, decimal
        text otherwise; "binary" forces it (no probe); "text" keeps the
        legacy decimal lanes.  MISAKA_CLIENT_WIRE overrides the
        default."""
        import os as _os

        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.retry_stale = bool(retry_stale)
        self.connect_retries = max(0, int(connect_retries))
        self.api_key = (
            api_key if api_key is not None
            else _os.environ.get("MISAKA_API_KEY") or None
        )
        split = urllib.parse.urlsplit(self.base_url)
        if split.scheme not in ("http", "https", ""):
            raise ValueError(
                f"unsupported scheme {split.scheme!r} (use http:// or "
                f"https://)"
            )
        self._tls = split.scheme == "https"
        self._ssl_ctx = None
        if self._tls:
            import ssl

            if tls_insecure:
                ctx = ssl._create_unverified_context()
            else:
                ctx = ssl.create_default_context(cafile=ca)
            self._ssl_ctx = ctx
        self._host = split.hostname or "localhost"
        # urllib's defaults, kept exactly
        self._port = split.port or (443 if self._tls else 80)
        self._prefix = split.path.rstrip("/")
        self._pool: list[http.client.HTTPConnection] = []
        self._pool_lock = threading.Lock()
        self._pool_size = max(0, int(pool_size))
        self.program = program
        wire_mode = wire or _os.environ.get("MISAKA_CLIENT_WIRE") or "auto"
        if wire_mode not in ("auto", "binary", "text"):
            raise ValueError(
                f"wire must be auto|binary|text, got {wire_mode!r}"
            )
        # None = auto (probe /healthz wire_binary once, lazily): the
        # headered binary form must never reach a server that would
        # compute on the header bytes as payload
        self._wire_binary: bool | None = (
            True if wire_mode == "binary"
            else False if wire_mode == "text" else None
        )

    def _compute_path(self, suffix: str) -> str:
        """`/compute*` or the program-addressed `/programs/<name>/compute*`
        twin when this session is pinned to a registry program."""
        if not self.program:
            return suffix
        return f"/programs/{urllib.parse.quote(self.program, safe='@')}" \
               f"{suffix}"

    def close(self) -> None:
        """Drop every pooled connection (sessions are reusable after)."""
        with self._pool_lock:
            pool, self._pool = self._pool, []
        for conn in pool:
            conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --- plumbing ----------------------------------------------------------

    def _connection(self) -> http.client.HTTPConnection:
        if self._tls:
            return http.client.HTTPSConnection(
                self._host, self._port, timeout=self.timeout,
                context=self._ssl_ctx,
            )
        return http.client.HTTPConnection(
            self._host, self._port, timeout=self.timeout
        )

    def _checkout(self) -> tuple[http.client.HTTPConnection, bool]:
        """An idle pooled connection (reused=True) or a fresh one."""
        with self._pool_lock:
            if self._pool:
                return self._pool.pop(), True
        return self._connection(), False

    def _checkin(self, conn: http.client.HTTPConnection) -> None:
        with self._pool_lock:
            if len(self._pool) < self._pool_size:
                self._pool.append(conn)
                return
        conn.close()

    def _request(self, path: str, data: bytes | None, method: str) -> bytes:
        return self._request_full(path, data, method)[0]

    def _request_full(
        self, path: str, data: bytes | None, method: str,
        extra_headers: dict[str, str] | None = None,
    ) -> tuple[bytes, dict[str, str]]:
        """Like _request, but also returns the response headers the
        tracing surface rides (X-Misaka-Trace, Server-Timing)."""
        headers = dict(extra_headers) if extra_headers else {}
        if data is not None:
            # the server's bulk lanes answer 411 without a length;
            # http.client sets it for bytes bodies, but be explicit
            headers["Content-Length"] = str(len(data))
        if self.api_key is not None:
            headers["X-Misaka-Key"] = self.api_key
        refused = 0
        replays = 0
        fresh_replays = 0
        while True:
            conn, reused = self._checkout()
            try:
                conn.request(method, self._prefix + path, data, headers)
                resp = conn.getresponse()
            except (http.client.HTTPException, ConnectionError, OSError) as e:
                conn.close()
                if self.retry_stale and isinstance(
                    e, (http.client.RemoteDisconnected, ConnectionError,
                        BrokenPipeError)
                ) and (reused or (replays and fresh_replays < 1)):
                    # A pooled socket the server dropped between requests:
                    # the send failed or ZERO response bytes arrived —
                    # replay on a fresh connection (see __init__'s
                    # retry_stale for the at-least-once caveat).  Any
                    # other failure shape (e.g. a garbled partial status
                    # line) may mean a response was in flight — never
                    # replay those.  Reused-socket replays stay UNCAPPED:
                    # after a server restart the whole idle pool is stale
                    # and must drain, however many connections deep.
                    #
                    # `fresh_replays` additionally allows ONE replay of a
                    # failed FRESH dial, but only once a stale replay has
                    # begun: a kill -9'd SO_REUSEPORT worker keeps its
                    # listening socket for a beat after its threads are
                    # gone, so the replay's connect can land in the dying
                    # worker's backlog and be reset before any byte of
                    # response.  The at-least-once semantics are
                    # unchanged; a request's FIRST attempt on a fresh
                    # dial is still never replayed.
                    if not reused:
                        fresh_replays += 1
                    replays += 1
                    continue
                if (
                    not reused
                    and isinstance(e, ConnectionRefusedError)
                    and refused < self.connect_retries
                ):
                    # fresh dial refused: the server-restarting window.
                    # Nothing was sent, so retrying is exactly-once safe;
                    # back off exponentially to ride out the respawn (see
                    # __init__'s connect_retries).  Lazy import: the
                    # shared policy module is stdlib-only, but the happy
                    # path shouldn't even pay the import.
                    import time

                    from misaka_tpu_torch.utils.backoff import Backoff

                    time.sleep(Backoff(base=0.1, cap=2.0).delay_for(refused))
                    refused += 1
                    continue
                raise urllib.error.URLError(e) from e
            try:
                body = resp.read()
            except (http.client.HTTPException, ConnectionError, OSError) as e:
                # response headers arrived: the request executed — a
                # mid-body failure must surface, never retry
                conn.close()
                raise urllib.error.URLError(e) from e
            if resp.will_close:
                conn.close()
            else:
                self._checkin(conn)
            resp_headers = {
                "X-Misaka-Trace": resp.getheader("X-Misaka-Trace"),
                "Server-Timing": resp.getheader("Server-Timing"),
            }
            if resp.status >= 400:
                retry_after = None
                ra = resp.getheader("Retry-After")
                if ra:
                    try:
                        retry_after = float(ra)
                    except ValueError:
                        pass  # HTTP-date form: surface the header's
                        # presence through the body text instead
                raise MisakaClientError(
                    resp.status, body.decode(errors="replace").strip(),
                    trace_id=resp_headers["X-Misaka-Trace"],
                    retry_after=retry_after,
                )
            return body, resp_headers

    def _post_form(self, path: str, **fields) -> bytes:
        return self._request(
            path, urllib.parse.urlencode(fields).encode(), "POST"
        )

    # --- the reference's five routes (master.go:90-224) --------------------

    def run(self) -> None:
        self._post_form("/run")

    def pause(self) -> None:
        self._post_form("/pause")

    def reset(self) -> None:
        self._post_form("/reset")

    def load(self, target: str, program: str) -> None:
        """Reprogram one node (resets the network, like the reference)."""
        self._post_form("/load", targetURI=target, program=program)

    def compute(self, value: int) -> int:
        """One value through POST /compute.  The returned int carries the
        response's tracing context: ``result.timings`` (parsed
        Server-Timing phases, ms) and ``result.trace_id``."""
        raw, headers = self._request_full(
            self._compute_path("/compute"),
            urllib.parse.urlencode({"value": str(int(value))}).encode(),
            "POST",
        )
        out = TracedInt(json.loads(raw)["value"])
        st = headers.get("Server-Timing")
        out.timings = _parse_server_timing(st) if st else {}
        out.trace_id = headers.get("X-Misaka-Trace")
        return out

    # --- bulk compute lanes -------------------------------------------------

    def _use_binary_wire(self) -> bool:
        """Lazy capability probe for wire="auto": one GET /healthz per
        client session decides whether the server speaks the headered
        binary protocol.  Fail-safe: any probe failure (old server, no
        route, network hiccup) latches text — the headered form must
        never reach a server that would compute on the header bytes."""
        cached = self._wire_binary
        if cached is None:
            try:
                cached = bool(self.healthz().get("wire_binary"))
            except Exception:
                cached = False
            self._wire_binary = cached
        return cached

    def compute_batch(self, values, spread: bool = True):
        """A value stream in ONE round trip.  Speaks the binary wire by
        default (the headered /compute_raw protocol — utils/wire.py) when
        the server supports it; the decimal text /compute_batch form is
        the fallback (and forced by wire="text" / MISAKA_CLIENT_WIRE).
        Returns an int32 numpy array (numpy imported here, not at module
        scope — the scalar/lifecycle surface stays stdlib-only)."""
        import numpy as np

        if self._use_binary_wire():
            return self.compute_raw(values, spread=spread)
        vals = np.ascontiguousarray(values, dtype=np.int32)
        body = b"values=" + b"+".join(b"%d" % v for v in vals.tolist())
        if spread:
            body += b"&spread=1"
        raw, headers = self._request_full(
            self._compute_path("/compute_batch"), body, "POST"
        )
        return _traced_array(
            np.asarray(json.loads(raw)["values"], dtype=np.int32), headers
        )

    def compute_raw(self, values, spread: bool = True):
        """The wire-efficient lane: raw little-endian int32 both ways —
        headered binary protocol (framing-validated, utils/wire.py) when
        negotiated, the legacy headerless raw form otherwise.  Returns an
        int32 numpy array."""
        import numpy as np

        vals = np.ascontiguousarray(values, dtype="<i4")
        path = self._compute_path("/compute_raw") \
            + "?spread=" + ("1" if spread else "0")
        if self._use_binary_wire():
            from misaka_tpu_torch.utils import wire as _wire

            raw, headers = self._request_full(
                path, _wire.pack(vals.tobytes()), "POST",
                extra_headers={
                    "Content-Type": _wire.CONTENT_TYPE,
                    "Accept": _wire.CONTENT_TYPE,
                },
            )
            payload = _wire.unpack(raw)
            return _traced_array(
                np.frombuffer(payload, dtype="<i4").copy(), headers
            )
        raw, headers = self._request_full(path, vals.tobytes(), "POST")
        return _traced_array(np.frombuffer(raw, dtype="<i4").copy(), headers)

    # --- observability ------------------------------------------------------

    def status(self) -> dict:
        return json.loads(self._request("/status", None, "GET"))

    def healthz(self) -> dict:
        """Cheap liveness (no server-side state lock): engine + uptime."""
        return json.loads(self._request("/healthz", None, "GET"))

    def native_edge(self) -> dict | None:
        """The C++ edge tier's /healthz block (r19), or None when the
        CPython worker tier owns the public port — which tier terminated
        this client's bytes, without parsing Server headers."""
        return self.healthz().get("native_edge")

    def metrics(self) -> str:
        """Raw Prometheus text exposition from GET /metrics (parse with
        misaka_tpu_torch.utils.metrics.parse_text: stdlib-only like this
        client)."""
        return self._request("/metrics", None, "GET").decode()

    def trace(self, last: int | None = None) -> list[dict]:
        """Decoded INSTRUCTION history (GET /debug/isa_trace — renamed
        from /trace, which the server keeps as a deprecated alias)."""
        path = "/debug/isa_trace" if last is None \
            else f"/debug/isa_trace?last={int(last)}"
        return json.loads(self._request(path, None, "GET"))["entries"]

    def debug_requests(self, slowest: bool = False) -> dict:
        """The request-trace flight recorder (GET /debug/requests):
        recent + slowest completed traces, summaries only."""
        path = "/debug/requests" + ("?slowest=1" if slowest else "")
        return json.loads(self._request(path, None, "GET"))

    def debug_request(self, trace_id: str) -> dict:
        """One completed trace's full span tree."""
        return json.loads(
            self._request(f"/debug/requests/{trace_id}", None, "GET")
        )

    def perfetto(self) -> dict:
        """The flight recorder as Chrome trace-event JSON — dump it to a
        file and load in https://ui.perfetto.dev."""
        return json.loads(self._request("/debug/perfetto", None, "GET"))

    def usage(self) -> dict:
        """The per-program resource ledger (GET /debug/usage): requests,
        values, CPU-seconds, measured native-pool seconds, and
        queue-delay seconds per program (runtime/usage.py)."""
        return json.loads(self._request("/debug/usage", None, "GET"))

    def usage_export(self, since: float = 0.0,
                     verify_secret: str | None = None) -> list[dict]:
        """Billing-grade usage export (GET /usage/export, admin-gated):
        HMAC-signed JSONL periods of cumulative per-tenant counters from
        the durable ledger, one parsed dict per line.  ``since`` (unix
        seconds) bounds the window.  Pass ``verify_secret`` (the plane
        secret) to verify every signature locally — a tampered or
        unsigned line raises MisakaClientError.  Against a fleet hub the
        stream carries every replica's and peer's lines verbatim behind
        ``{"kind": "source"}`` envelopes."""
        raw = self._request(f"/usage/export?since={since:g}", None, "GET")
        if isinstance(raw, bytes):
            raw = raw.decode()
        lines = [json.loads(ln) for ln in raw.splitlines() if ln.strip()]
        if verify_secret is not None:
            from misaka_tpu_torch.runtime import usage as usage_mod

            sec = verify_secret.encode() if isinstance(verify_secret, str) else verify_secret
            try:
                usage_mod.totals_from_lines(lines, secret=sec)
            except usage_mod.UsageExportError as e:
                raise MisakaClientError(200, str(e)) from None
        return lines

    def alerts(self) -> dict:
        """The SLO burn-rate engine's state (GET /debug/alerts):
        per-program ok/warning/page with per-window burn rates and
        latency quantiles (utils/slo.py; objectives via MISAKA_SLO or
        per-program upload metadata)."""
        return json.loads(self._request("/debug/alerts", None, "GET"))

    def flamegraph(self) -> dict:
        """The continuous profiler's folded-stack aggregate + native
        busy/idle split (GET /debug/flamegraph; append ?html=1 in a
        browser for the self-contained viewer)."""
        return json.loads(self._request("/debug/flamegraph", None, "GET"))

    def series(self, name: str | None = None, window: str = "1h",
               labels: dict | None = None) -> dict:
        """Retained metric history from the embedded TSDB (GET
        /debug/series, utils/tsdb.py).

        ``series()`` with no name lists the catalog (series counts,
        retention stages, drop counters).  With ``name`` — a counter
        (returned as a rate), a gauge, or a derived histogram series
        (``<hist>:p50`` / ``:p99`` / ``:rate``) — returns every matching
        series over the trailing ``window`` ("30s"/"5m"/"1h"/"7d" or
        bare seconds — day windows answer from the durable long-horizon
        tier when MISAKA_TSDB_DIR is armed), each as
        ``{labels, stage_s, points: [[unix, avg,
        max], ...]}``.  ``labels`` filters by exact label values; on a
        fleet endpoint every replica's series carries ``replica="<i>"``.
        Raises MisakaClientError on a malformed window or filter (400)."""
        from urllib.parse import quote

        if name is None:
            return json.loads(self._request("/debug/series", None, "GET"))
        path = (
            f"/debug/series?name={quote(name, safe=':')}"
            f"&window={quote(str(window))}"
        )
        for k, v in (labels or {}).items():
            path += f"&label={quote(f'{k}={v}')}"
        return json.loads(self._request(path, None, "GET"))

    def canary_status(self) -> dict | None:
        """The synthetic canary's last cycle (runtime/canary.py), from
        the /healthz ``canary`` block: per-tier outcomes, the
        first-failing-tier attribution, and the consecutive full-stack
        failure count.  None when the server runs no canary
        (MISAKA_CANARY=0, or a bare test server)."""
        return self.healthz().get("canary")

    # --- the engine fleet (server must run with MISAKA_FLEET >= 1) ----------

    def fleet_status(self) -> dict:
        """The fleet manager's state (GET /fleet): per-replica rows
        (state, pid, port, restarts), restart/roll totals, and the
        aggregate `degraded` flag (runtime/fleet.py)."""
        return json.loads(self._request("/fleet", None, "GET"))

    def fleet_roll(self, timeout: float | None = None) -> dict:
        """Zero-loss rolling restart of every engine replica (POST
        /fleet/roll): drain to quiescence -> manifest-verified checkpoint
        -> replace -> bit-identical restore -> readmit, one replica at a
        time.  Synchronous — returns the per-replica report; pass a
        generous `timeout` (each replica pays an engine boot).  409 when
        a roll is already in progress."""
        if timeout is None:
            timeout = max(self.timeout, 120.0 * 4)
        # deliberately NOT the pooled _request path: a roll blocks for
        # minutes (one engine boot per replica), and parking a pooled
        # keep-alive connection on it — or mutating its timeout — would
        # poison the pool for every concurrent compute call
        conn = self._connection()
        conn.timeout = timeout  # applied at connect time
        try:
            headers = {"Content-Length": "0"}
            if self.api_key is not None:
                headers["X-Misaka-Key"] = self.api_key
            conn.request("POST", self._prefix + "/fleet/roll", b"", headers)
            resp = conn.getresponse()
            body = resp.read()
            if resp.status >= 400:
                raise MisakaClientError(
                    resp.status, body.decode(errors="replace").strip()
                )
            return json.loads(body)
        finally:
            conn.close()

    # --- the program registry (server must run with MISAKA_PROGRAMS_DIR) ---

    def upload_program(self, name: str, program: str | None = None,
                       topology: "dict | str | None" = None,
                       compose: str | None = None,
                       verify: str | None = None) -> dict:
        """Publish one program version (POST /programs) and return the
        server's {"name", "version", "created", "latest", "swapped"}.

        Exactly one source form: `program` is bare TIS text (served as a
        single-node network), `topology` a {"nodes": ..., "programs": ...}
        dict or JSON string, `compose` a reference docker-compose YAML
        text.  Identical sources dedup to one content-addressed version;
        publishing a new version over a live engine hot-swaps it with
        zero client-visible errors.

        verify="replay" gates the hot-swap on shadow replay of the live
        capture (POST /programs?verify=replay): the candidate must
        byte-for-byte reproduce every captured response before any
        bookkeeping or swap happens.  A divergence surfaces as
        MisakaClientError(status=409) with ``.diffs`` carrying the
        per-request records; see ``replay()``."""
        fields: dict[str, str] = {"name": name}
        if program is not None:
            fields["program"] = program
        if topology is not None:
            fields["topology"] = (
                topology if isinstance(topology, str) else json.dumps(topology)
            )
        if compose is not None:
            fields["compose"] = compose
        path = "/programs"
        if verify is not None:
            path += "?verify=" + urllib.parse.quote(verify, safe="")
        return json.loads(self._post_form(path, **fields))

    def list_programs(self) -> dict:
        """The registry catalog (GET /programs): every name's versions,
        aliases, and which engines are active."""
        return json.loads(self._request("/programs", None, "GET"))

    def program_info(self, name: str) -> dict:
        """One program's detail (GET /programs/<name>)."""
        return json.loads(
            self._request(
                f"/programs/{urllib.parse.quote(name, safe='')}", None, "GET"
            )
        )

    # --- checkpoint / profiling (additive; server must have dirs enabled) --

    def checkpoint(self, name: str) -> None:
        self._post_form("/checkpoint", name=name)

    def restore(self, name: str) -> None:
        self._post_form("/restore", name=name)

    def profile_start(self, name: str = "profile") -> None:
        self._post_form("/profile/start", name=name)

    def profile_stop(self) -> str:
        return self._request("/profile/stop", b"", "POST").decode()

    # --- traffic capture & shadow replay (runtime/capture.py) --------------
    # Admin-gated when edge auth is configured: construct the client with
    # the admin api_key or the edge answers 403.

    def capture_start(self) -> dict:
        """Arm the wire recorder (POST /captures/start): anchors every
        active engine's state and records sampled request/response pairs
        into the bounded ring.  Returns the recorder status.  409 when
        already recording or killed via MISAKA_CAPTURE=0."""
        return json.loads(self._post_form("/captures/start"))

    def capture_stop(self) -> dict:
        """Disarm the recorder; the ring stays readable for export and
        ?verify=replay until the next capture_start()."""
        return json.loads(self._post_form("/captures/stop"))

    def capture_export(self, path: str | None = None) -> dict:
        """Write the captured ring + per-program anchor checkpoints to
        disk ON THE SERVER (POST /captures/export) and return
        {"path", "records", "dropped", "anchors"}.  path=None lets the
        server pick a timestamped file under MISAKA_CAPTURE_DIR."""
        fields = {"path": path} if path else {}
        return json.loads(self._request(
            "/captures/export",
            urllib.parse.urlencode(fields).encode(), "POST",
        ))

    def capture_status(self, n: int = 0) -> dict:
        """The recorder's live status + the newest ``n`` records with
        value previews (GET /debug/captures?n=...)."""
        return json.loads(
            self._request(f"/debug/captures?n={int(n)}", None, "GET")
        )

    def replay(self, name: str, program: str | None = None,
               topology: "dict | str | None" = None,
               compose: str | None = None) -> dict:
        """Replay-verified publish: upload_program(verify="replay").

        Green replay -> the publish proceeds and the server's publish
        payload returns.  Divergence -> MisakaClientError with
        status=409 and ``.diffs`` listing every captured request the
        candidate answered differently (trace ID, stream offset,
        expected/actual heads) — nothing was swapped or recorded."""
        return self.upload_program(
            name, program=program, topology=topology, compose=compose,
            verify="replay",
        )
