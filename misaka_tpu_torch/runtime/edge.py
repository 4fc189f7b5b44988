"""The production edge: one route table and one ordered middleware chain
shared by every HTTP surface of the serving plane, TLS on the listener and
the compute plane's shared-secret handshake.

The port of misaka_tpu/runtime/edge.py.  The chain runs on the engine's
HTTP server (runtime/master.py make_http_server, before every route body)
and on the compute plane (runtime/frontends.py, once per frame: the
frontend workers ship each frame's API key, and the state must be global,
since N workers each holding 1/Nth of a bucket would not be a quota).  In
order, each stage with its own kill switch:

  1. AUTH (MISAKA_EDGE_AUTH=0 disables): API keys in a reloadable JSON file
     (MISAKA_API_KEYS), looked up by HMAC digest, mapping to tenants; signed
     short-lived tenant tokens (MISAKA_TOKEN_SECRET, minted at POST
     /edge/token) and the per-boot internal token
     (MISAKA_EDGE_INTERNAL_TOKEN).  No key -> 401, a known key without the
     route's scope -> 403.
  2. QUOTA (MISAKA_EDGE_QUOTA=0 disables): per-tenant token buckets for
     requests/s (`rps`) and values/s (`vps`), MISAKA_QUOTA="rps<100,vps<5e5"
     by default, field-wise overridden by a program's and then a key's own
     spec.  Exhaustion answers a typed 429 with a computed Retry-After.
  3. ADMISSION (MISAKA_EDGE_ADMISSION=0 disables): beyond the soft
     watermark of waiting values (MISAKA_ADMISSION_HIGH, halved while an
     SLO pages) tenants above their fair share of the recent admission
     window are shed; beyond the hard watermark (2x) everyone is.

MISAKA_EDGE=0 disarms the whole chain.  Every decision is counted in
misaka_edge_admitted_total{tenant} and misaka_edge_rejected_total{reason,
tenant}, and a rejected traced request carries an `edge.reject` span.

The `cpu` quota stage reads a program's cpu_seconds from the usage ledger
through the `cpu_reader` the engine passes (a chain without one never runs
the stage); the admission signals carry the SLO engine's page bit
(utils/slo.py); the `overload[:<tenant>]` and `quota_exhaust` fault points
(utils/faults.py) force a shed at the admission and quota sites.  The
TCP compute plane's mTLS material (MISAKA_PLANE_TLS_CERT/KEY/CA,
`PlaneTLSReloader`, hot-reloaded on a rotation) and its typed reject
counter live here too, and so does `native_edge_state`, the snapshot of
the chain that the native C++ edge (runtime/frontends.py
`NativeFrontendSupervisor`) is pushed.  Stdlib only, plus the port's
stdlib-only utils: the frontend workers import this module.
"""

from __future__ import annotations

import base64
import collections
import hashlib
import hmac
import json
import logging
import os
import ssl
import threading
import time

from misaka_tpu_torch.utils import faults, metrics

log = logging.getLogger("misaka_tpu_torch.edge")

# --- metrics -----------------------------------------------------------------

M_EDGE_ADMITTED = metrics.counter(
    "misaka_edge_admitted_total",
    "Requests admitted through the edge middleware chain, by tenant",
    ("tenant",),
)
M_EDGE_REJECTED = metrics.counter(
    "misaka_edge_rejected_total",
    "Requests rejected at the edge, by reason "
    "(unauthenticated/forbidden/rate/values/cpu/overload) and tenant",
    ("reason", "tenant"),
)
M_PLANE_TLS_REJECTED = metrics.counter(
    "misaka_plane_tls_rejected_total",
    "Plane connections refused at the mTLS gate, by reason "
    "(plaintext/bad_cert/handshake)",
    ("reason",),
)
M_PLANE_TLS_RELOADS = metrics.counter(
    "misaka_plane_tls_reloads_total",
    "Plane TLS cert/key/CA hot-reload attempts, by status (ok/error)",
    ("status",),
)
M_EDGE_TOKENS = metrics.counter(
    "misaka_edge_tokens_total",
    "Tenant-token operations, by op (mint/ok/expired/invalid)",
    ("op",),
)
M_EDGE_GOSSIP_ROUNDS = metrics.counter(
    "misaka_edge_gossip_rounds_total",
    "Usage-gossip applications at this replica, by status (ok/stale/error)",
    ("status",),
)
M_EDGE_GOSSIP_DRAINED = metrics.counter(
    "misaka_edge_gossip_drained_total",
    "Tokens drained from local quota buckets to reconcile remote usage, "
    "by field (rps/vps)",
    ("field",),
)

# Tenant names are client-chosen: the label set rides the one health-plane
# budget (MISAKA_USAGE_LABEL_MAX), past which new tenants collapse to
# "other".  A known label is a lock-free set read; a new one takes the lock.
_tenant_labels_lock = threading.Lock()
_tenant_labels: set[str] = set()


def tenant_metric_label(tenant: str | None) -> str:
    """`tenant` resolved against the shared cardinality budget."""
    label = tenant or "default"
    if label in _tenant_labels:
        return label
    with _tenant_labels_lock:
        label = metrics.capped_label(_tenant_labels, label, metrics.tenant_label_budget())
        _tenant_labels.add(label)
    return label


# program-keyed state (cpu meters) has its own capped set: program names
# must not consume the tenant slots
_program_labels_lock = threading.Lock()
_program_labels: set[str] = set()


def _program_state_label(program: str) -> str:
    if program in _program_labels:
        return program
    with _program_labels_lock:
        label = metrics.capped_label(_program_labels, program, metrics.tenant_label_budget())
        _program_labels.add(label)
    return label


# per-tenant metric children resolved once: the labels() walk and its lock
# must not run per admitted (or shed) request.  Callers pass capped labels;
# the miss path launders again (a no-op on a known label) so no caller can
# mint a series past the budget.
_children_lock = threading.Lock()
_admitted_children: dict[str, object] = {}
_rejected_children: dict[tuple[str, str], object] = {}


def _admitted_child(label: str):
    c = _admitted_children.get(label)
    if c is None:
        with _children_lock:
            c = _admitted_children.setdefault(
                label, M_EDGE_ADMITTED.labels(tenant=tenant_metric_label(label)))
    return c


def _rejected_child(reason: str, label: str):
    k = (reason, label)
    c = _rejected_children.get(k)
    if c is None:
        with _children_lock:
            c = _rejected_children.setdefault(
                k, M_EDGE_REJECTED.labels(reason=reason, tenant=tenant_metric_label(label)))
    return c


# --- decisions ---------------------------------------------------------------


class EdgeReject(Exception):
    """A typed edge rejection: HTTP status, machine-readable reason and an
    optional Retry-After in seconds.  Each surface renders it (the HTTP
    headers; a plane frame ships `to_wire`, from which the frontend worker
    restores the headers).  `tenant` is attached where known, so a worker
    honouring the Retry-After reports its shed counts under it."""

    def __init__(self, status: int, reason: str, message: str,
                 retry_after: float | None = None, tenant: str | None = None):
        super().__init__(message)
        self.status = int(status)
        self.reason = reason
        self.message = message
        self.retry_after = retry_after
        self.tenant = tenant

    def headers(self) -> list[tuple[str, str]]:
        out = []
        if self.retry_after is not None:
            # ceil to whole seconds: Retry-After is delta-seconds
            out.append(("Retry-After", str(max(1, int(-(-self.retry_after // 1))))))
        if self.status == 401:
            out.append(("WWW-Authenticate", 'Bearer realm="misaka", charset="UTF-8"'))
        return out

    def to_wire(self) -> bytes:
        """The plane-frame body: JSON the frontend turns back into headers."""
        obj = {"error": self.message, "reason": self.reason}
        if self.retry_after is not None:
            obj["retry_after"] = round(self.retry_after, 3)
        if self.tenant is not None:
            obj["tenant"] = self.tenant
        return json.dumps(obj).encode()

    @staticmethod
    def from_wire(status: int, body: bytes) -> "EdgeReject | None":
        """Inverse of to_wire (None when the body is not an edge payload)."""
        try:
            obj = json.loads(body.decode())
            if not isinstance(obj, dict) or "reason" not in obj:
                return None
            return EdgeReject(
                status, str(obj["reason"]), str(obj.get("error", "")),
                retry_after=float(obj["retry_after"])
                if obj.get("retry_after") is not None else None,
                tenant=str(obj["tenant"]) if obj.get("tenant") is not None else None,
            )
        except (ValueError, TypeError, UnicodeDecodeError):
            return None


# every reason the chain can emit: frame-carried shed reports are clamped
# to this set, so wire metadata cannot mint label values
REASONS = frozenset({"unauthenticated", "forbidden", "rate", "values", "cpu", "overload"})


def count_shed(tenant: str | None, reason: str, n: int = 1) -> None:
    """Record `n` rejections made away from a chain: a frontend worker's
    shed cache honours an engine-issued Retry-After and ships its counts
    back in frame metadata, so the rejected series covers the whole door."""
    _rejected_child(reason if reason in REASONS else "other",
                    tenant_metric_label(tenant)).inc(max(1, int(n)))


class Decision:
    """One edge evaluation: the resolved tenant (always set) and the
    rejection, if any."""

    __slots__ = ("tenant", "reject", "key_entry")

    def __init__(self, tenant: str | None, reject: EdgeReject | None = None,
                 key_entry: "dict | None" = None):
        self.tenant = tenant
        self.reject = reject
        self.key_entry = key_entry


# --- route table -------------------------------------------------------------

# The stages per route class, shared by every surface: OPEN routes have no
# edge (probes, scrapers), COMPUTE the whole chain, ADMIN auth with the
# `admin` scope (no quota or admission: a /pause must land during a shed),
# everything else (READ) auth only.
OPEN_ROUTES = frozenset({"/healthz", "/metrics"})
COMPUTE_ROUTES = frozenset({"/compute", "/compute_batch", "/compute_raw"})
ADMIN_ROUTES = frozenset({
    "/run", "/pause", "/reset", "/load", "/checkpoint", "/restore",
    "/profile/start", "/profile/stop", "/fleet/roll", "/fleet/drain",
    "/debug/faults",
    "/captures/start", "/captures/stop", "/captures/export",
    "/captures/rotate", "/debug/captures",
    "/usage/export",
    # minting hands out credentials; gossip mutates bucket state
    "/edge/token", "/edge/gossip",
})


def route_policy(route: str, method: str = "POST") -> tuple[str, ...]:
    """The ordered stages for one (route, method), drawn from ("auth",
    "auth_admin", "quota", "admission")."""
    if route in OPEN_ROUTES:
        return ()
    if route in COMPUTE_ROUTES:
        return ("auth", "quota", "admission")
    if route in ADMIN_ROUTES:
        return ("auth_admin",)
    if route == "/programs" and method == "POST":
        return ("auth_admin",)
    return ("auth",)


# --- API key file ------------------------------------------------------------


def _digest(key: str) -> bytes:
    """A presented key's identifier: HMAC-SHA256 under a fixed tag, so
    neither the table walk nor the comparison touches key bytes."""
    return hmac.new(b"misaka-api-key-v1", key.encode(), hashlib.sha256).digest()


class KeyFile:
    """A reloadable API-key table.

        {"keys": [
          {"key": "alice-secret", "tenant": "alice", "admin": true},
          {"key": "bob-secret", "tenant": "bob",
           "programs": ["dense"], "quota": "rps<50,vps<20000"}
        ]}

    `key` and `tenant` are required; `admin` (the ADMIN_ROUTES scope),
    `programs` (an allowlist: a request for another program is 403),
    `quota` (field-wise over the program's and the env's specs) and
    `disabled` (403: revoked in place) are optional.  The file is stat'd at
    most every 0.5 s and a change swaps the table; a file that fails to
    parse keeps the previous table and logs."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._by_digest: dict[bytes, dict] = {}
        self._stamp: tuple[float, int] | None = None
        self._next_stat = 0.0
        self._load(force=True)

    def _load(self, force: bool = False) -> None:
        try:
            st = os.stat(self.path)
            stamp = (st.st_mtime, st.st_size)
        except OSError:
            if force:
                log.warning("edge: key file %s unreadable; no keys loaded", self.path)
            return
        if not force and stamp == self._stamp:
            return
        try:
            with open(self.path) as f:
                obj = json.load(f)
            entries = obj["keys"] if isinstance(obj, dict) else obj
            table: dict[bytes, dict] = {}
            for e in entries:
                key = e["key"]
                tenant = e["tenant"]
                if not isinstance(key, str) or not isinstance(tenant, str):
                    raise ValueError("key and tenant must be strings")
                quota_spec = None
                if e.get("quota") is not None:
                    quota_spec = parse_quota_spec(e["quota"])  # parsed once, at load
                    if quota_spec.pop("cpu", None) is not None:
                        # cpu budgets are per program (the usage ledger's
                        # unit): billing one tenant for a shared program
                        # would shed the innocent one
                        log.warning(
                            "edge: key for tenant %r declares a `cpu` quota; cpu budgets "
                            "are per-program (use the POST /programs quota field or "
                            "MISAKA_QUOTA) — ignored", tenant)
                table[_digest(key)] = {
                    "tenant": tenant,
                    "admin": bool(e.get("admin")),
                    "programs": (frozenset(e["programs"])
                                 if e.get("programs") is not None else None),
                    "quota": e.get("quota"),
                    "quota_spec": quota_spec,
                    "disabled": bool(e.get("disabled")),
                }
        except (OSError, ValueError, TypeError, KeyError) as e:
            log.error("edge: key file %s failed to parse (%s); keeping the previous table",
                      self.path, e)
            self._stamp = stamp  # don't re-parse the same broken file hot
            return
        self._by_digest = table
        self._stamp = stamp
        log.info("edge: loaded %d API key(s) from %s", len(table), self.path)

    def lookup(self, key: str | None) -> dict | None:
        """The entry for a presented key (None: unknown or missing)."""
        now = time.monotonic()
        if now >= self._next_stat:
            with self._lock:
                if now >= self._next_stat:
                    self._next_stat = now + 0.5
                    self._load()
        if key is None:
            return None
        return self._by_digest.get(_digest(key))

    def __len__(self) -> int:
        return len(self._by_digest)


# --- quota specs -------------------------------------------------------------


class QuotaSpecError(ValueError):
    """Malformed quota spec (grammar: "rps<100,vps<500000,cpu<0.5")."""


_QUOTA_FIELDS = ("rps", "vps", "cpu")


def parse_quota_spec(text: str | None) -> dict[str, float]:
    """`"rps<100,vps<500000,cpu<0.5"` -> {"rps": 100.0, ...}; `=` is a
    synonym of `<`."""
    out: dict[str, float] = {}
    for raw in (text or "").split(","):
        entry = raw.strip()
        if not entry:
            continue
        for sep in ("<", "="):
            if sep in entry:
                name, _, val = entry.partition(sep)
                break
        else:
            raise QuotaSpecError(f"cannot parse quota term {entry!r} (want name<value)")
        name = name.strip()
        if name not in _QUOTA_FIELDS:
            raise QuotaSpecError(f"unknown quota field {name!r} (known: {_QUOTA_FIELDS})")
        try:
            limit = float(val.strip())
        except ValueError:
            raise QuotaSpecError(f"cannot parse quota value {val!r} in {entry!r}") from None
        if limit <= 0:
            raise QuotaSpecError(f"quota {name} must be > 0, got {limit}")
        out[name] = limit
    return out


class TokenBucket:
    """`rate` tokens/s, capacity `rate * burst_s`.  take(n) admits (True,
    0.0) or rejects with the seconds until n tokens exist."""

    __slots__ = ("rate", "capacity", "tokens", "stamp", "_lock")

    def __init__(self, rate: float, burst_s: float = 2.0):
        self.rate = float(rate)
        self.capacity = max(1.0, self.rate * burst_s)
        self.tokens = self.capacity
        self.stamp = time.monotonic()
        self._lock = threading.Lock()

    def take(self, n: float = 1.0) -> tuple[bool, float]:
        with self._lock:
            now = time.monotonic()
            self.tokens = min(self.capacity, self.tokens + (now - self.stamp) * self.rate)
            self.stamp = now
            if self.tokens >= n:
                self.tokens -= n
                return True, 0.0
            need = min(n, self.capacity) - self.tokens
            return False, need / self.rate if self.rate > 0 else 60.0

    def drain(self, n: float) -> None:
        """Remove `n` tokens without admitting anything (usage gossip): the
        balance may go down to -capacity, which bounds the recovery time."""
        if n <= 0:
            return
        with self._lock:
            now = time.monotonic()
            self.tokens = min(self.capacity, self.tokens + (now - self.stamp) * self.rate)
            self.stamp = now
            self.tokens = max(-self.capacity, self.tokens - n)


class CpuMeter:
    """Sliding-window cpu-seconds enforcement: (t, cumulative cpu) samples
    over `window_s`, rejecting while the windowed consumption exceeds
    `limit_frac * window_s` core-seconds."""

    __slots__ = ("window_s", "_samples", "_lock")

    def __init__(self, window_s: float):
        self.window_s = float(window_s)
        self._samples: list[tuple[float, float]] = []
        self._lock = threading.Lock()

    def check(self, cpu_now: float, limit_frac: float) -> tuple[bool, float]:
        now = time.monotonic()
        with self._lock:
            s = self._samples
            if not s or now - s[-1][0] >= 0.05:
                s.append((now, cpu_now))
            while s and now - s[0][0] > self.window_s:
                s.pop(0)
            if not s:
                return True, 0.0
            consumed = cpu_now - s[0][1]
        budget = limit_frac * self.window_s
        if consumed <= budget:
            return True, 0.0
        # assume consumption stops: the overage must age out of the window
        frac_over = (consumed - budget) / max(consumed, 1e-9)
        return False, min(self.window_s, max(1.0, frac_over * self.window_s))


# --- admission governor ------------------------------------------------------


class AdmissionGovernor:
    """Queue-depth and fair-share load shedding at the door.

    `signals()` returns (waiting_values, slo_page).  Below the soft
    watermark everyone is admitted; between soft and hard (2x) tenants
    above FAIR_SLACK times their equal share of the last second's admitted
    values are shed (a lone tenant rides to the hard cap); at hard everyone
    is.  A paging SLO halves the soft watermark.  Retry-After comes from
    the observed drain rate, clamped to [0.05 s, 5 s]."""

    FAIR_SLACK = 1.5

    def __init__(self, signals, high_values: int):
        self._signals = signals
        self.high = max(1, int(high_values))
        self._lock = threading.Lock()
        # the raw admissions and the running per-tenant sums: eviction is
        # amortized O(1) per admission, never a rebuild under the lock
        self._events: collections.deque = collections.deque()
        self._sums: dict[str, int] = {}
        self._total = 0
        self.window_s = 1.0

    def _evict(self, now: float) -> None:
        """Drop admissions older than the window (call under _lock)."""
        dq = self._events
        while dq and now - dq[0][0] > self.window_s:
            _, tenant, values = dq.popleft()
            self._total -= values
            s = self._sums.get(tenant, 0) - values
            if s <= 0:
                self._sums.pop(tenant, None)
            else:
                self._sums[tenant] = s

    def check(self, tenant: str, values: int) -> EdgeReject | None:
        waiting, page = self._signals()
        now = time.monotonic()
        if faults.armed():
            # chaos: `overload` saturates the governor for everyone,
            # `overload:<tenant>` for one tenant
            forced = faults.fire("overload")
            if forced is None:
                forced = faults.fire(f"overload:{tenant}")
            if forced is not None:
                return self._reject(waiting, values, 0, forced=True)
        soft = self.high // 2 if page else self.high
        hard = self.high * 2
        with self._lock:
            self._evict(now)
            drained = self._total
            shed = waiting >= hard
            if not shed and waiting >= soft and len(self._sums) > 1:
                fair = self.FAIR_SLACK / len(self._sums)
                shed = self._sums.get(tenant, 0) / (drained or 1) > fair
            if not shed:
                self._events.append((now, tenant, values))
                self._total += values
                self._sums[tenant] = self._sums.get(tenant, 0) + values
        if shed:
            return self._reject(waiting, values, drained)
        return None

    def _reject(self, waiting: int, values: int, drained: int,
                forced: bool = False) -> EdgeReject:
        """The typed 429, built outside the lock."""
        rate = max(drained / self.window_s, 1.0)
        retry = 1.0 if forced else min(5.0, max(0.05, (waiting + values) / rate))
        return EdgeReject(
            429, "overload",
            f"admission control: {waiting} values already waiting "
            f"(watermark {self.high}); retry after backoff",
            retry_after=retry,
        )


# --- the chain ---------------------------------------------------------------


class EdgeChain:
    """The ordered middleware chain, evaluated by every serving surface
    through `check()`.  Build one per process with `from_env()` and
    `install()` it: the compute plane and the HTTP handlers read it."""

    def __init__(
        self,
        keyfile: KeyFile | None = None,
        quota_defaults: dict[str, float] | None = None,
        governor: AdmissionGovernor | None = None,
        cpu_reader=None,
        auth_enabled: bool = True,
        quota_enabled: bool = True,
        admission_enabled: bool = True,
        burst_s: float = 2.0,
        cpu_window_s: float = 60.0,
        internal_token: str | None = None,
        token_secret: bytes | None = None,
    ):
        # MISAKA_EDGE_INTERNAL_TOKEN: a per-boot admin credential the app
        # mints for its own process tree (never persisted)
        self.internal_token = internal_token
        self.token_secret = token_secret if auth_enabled else None
        self.keyfile = keyfile if auth_enabled else None
        self.quota_defaults = dict(quota_defaults or {})
        self.governor = governor if admission_enabled else None
        # a program's cumulative cpu_seconds (the usage ledger,
        # runtime/usage.py); None: the `cpu` stage never runs
        self.cpu_reader = cpu_reader
        # armed with no env defaults too: key and program specs may come later
        self.quota_enabled = bool(quota_enabled)
        self.burst_s = burst_s
        self.cpu_window_s = cpu_window_s
        self._lock = threading.Lock()
        self._buckets: dict[tuple[str, str, float], TokenBucket] = {}
        self._cpu_meters: dict[str, CpuMeter] = {}
        self._program_quotas: dict[str, dict[str, float]] = {}
        # cumulative admitted quota tokens per (tenant label, field): the
        # usage gossip that lets sibling replicas drain each other's buckets
        self._gossip_lock = threading.Lock()
        self._usage: dict[tuple[str, str], float] = {}
        self._gossip_applied: dict[str, dict[str, float]] = {}

    @property
    def armed(self) -> bool:
        """True when any stage can reject (the fast-path gate).  A token
        secret arms the chain alone: an expired token must get its 401."""
        return (self.keyfile is not None or self.token_secret is not None
                or self.quota_enabled or self.governor is not None)

    def set_program_quota(self, program: str, spec: str | None) -> None:
        """Install (or clear, spec=None) a per-program quota override;
        QuotaSpecError on a malformed spec."""
        with self._lock:
            if spec is None:
                self._program_quotas.pop(program, None)
            else:
                self._program_quotas[program] = parse_quota_spec(spec)

    def program_quota(self, program: str | None) -> dict[str, float] | None:
        if program is None or not self._program_quotas:
            return None
        return self._program_quotas.get(program)

    def resolve_tenant(self, key: str | None, program: str | None) -> tuple[str, dict | None]:
        """The tenant a request bills to: its key's (or token's) tenant, the
        internal token's admin-scoped "_fleet", else the program label."""
        if (self.internal_token is not None and key is not None
                and hmac.compare_digest(
                    # bytes: compare_digest raises on non-ASCII str, and a
                    # client's header must never become a 500
                    key.encode("utf-8", "surrogateescape"), self.internal_token.encode())):
            return "_fleet", {"tenant": "_fleet", "admin": True, "programs": None,
                              "quota": None, "quota_spec": None, "disabled": False}
        if self.token_secret is not None and key is not None and key.startswith(TOKEN_PREFIX):
            entry, why = verify_tenant_token(self.token_secret, key)
            _token_children[why].inc()
            if entry is not None:
                return entry["tenant"], entry
            # a typed 401 downstream, never the key table's "unknown API key"
            return (program or "default"), {"_bad_token": why}
        entry = self.keyfile.lookup(key) if self.keyfile is not None else None
        if entry is not None:
            return entry["tenant"], entry
        return (program or "default"), None

    def _bucket(self, tenant: str, field: str, rate: float) -> TokenBucket:
        # the rate is part of the key: a tenant alternating between
        # programs with different overrides drains two bounded buckets and
        # never recreates one at full burst on every flip
        k = (tenant, field, rate)
        b = self._buckets.get(k)
        if b is None:
            with self._lock:
                b = self._buckets.get(k)
                if b is None:
                    same = [k2 for k2 in self._buckets if k2[0] == tenant and k2[1] == field]
                    if len(same) >= 8:
                        del self._buckets[same[0]]
                    b = TokenBucket(rate, self.burst_s)
                    self._buckets[k] = b
        return b

    def _effective_quota(self, entry: dict | None, program: str | None) -> dict[str, float]:
        """Field-wise precedence: key entry > program override > env.  With
        no override the shared env dict is returned (callers only read)."""
        pq = self.program_quota(program.partition("@")[0] if program else None)
        kq = entry.get("quota_spec") if entry is not None else None
        if pq is None and not kq:
            return self.quota_defaults
        q = dict(self.quota_defaults)
        if pq:
            q.update(pq)
        if kq:
            q.update(kq)
        return q

    def check(self, route: str, method: str = "POST", key: str | None = None,
              program: str | None = None, values: int = 1, requests: int = 1) -> Decision:
        """Evaluate the chain for one request, or one plane frame fusing
        `requests` client requests of one tenant.  Never raises; counts the
        decision per client request."""
        stages = route_policy(route, method)
        tenant, entry = self.resolve_tenant(key, program)
        if not stages or not self.armed:
            return Decision(tenant, None, entry)
        # every stateful stage keys on the capped label, like the series
        label = tenant_metric_label(tenant)
        reject = self._run_stages(stages, label, entry, key, program, values, requests)
        if reject is None:
            _admitted_child(label).inc(max(1, requests))
        else:
            _rejected_child(reject.reason, label).inc(max(1, requests))
        return Decision(tenant, reject, entry)

    def _run_stages(self, stages, tenant, entry, key, program, values,
                    requests=1) -> EdgeReject | None:
        for stage in stages:
            if stage in ("auth", "auth_admin") and entry is not None and entry.get("_bad_token"):
                why = entry["_bad_token"]
                return EdgeReject(
                    401, "unauthenticated",
                    "tenant token expired; mint a new one at /edge/token"
                    if why == "expired" else "tenant token invalid",
                )
            if stage in ("auth", "auth_admin") and self.keyfile is not None:
                if key is None:
                    return EdgeReject(401, "unauthenticated",
                                      "API key required (X-Misaka-Key header or "
                                      "Authorization: Bearer <key>)")
                if entry is None:
                    return EdgeReject(401, "unauthenticated", "unknown API key")
                if entry.get("disabled"):
                    return EdgeReject(403, "forbidden", "API key disabled")
                if stage == "auth_admin" and not entry.get("admin"):
                    return EdgeReject(403, "forbidden",
                                      "this route requires an admin-scoped API key")
                allow = entry.get("programs")
                if allow is not None and program is not None and (
                        program.partition("@")[0] not in allow):
                    return EdgeReject(403, "forbidden",
                                      f"API key not authorized for program "
                                      f"{program.partition('@')[0]!r}")
            elif stage == "quota" and self.quota_enabled:
                r = self._check_quota(tenant, entry, program, values, requests)
                if r is not None:
                    return r
            elif stage == "admission" and self.governor is not None:
                r = self.governor.check(tenant, values)
                if r is not None:
                    return r
        return None

    def _check_quota(self, tenant, entry, program, values, requests=1) -> EdgeReject | None:
        if faults.armed() and faults.fire("quota_exhaust") is not None:
            return EdgeReject(429, "rate", "quota exhausted (injected fault)", retry_after=1.0)
        q = self._effective_quota(entry, program)
        if not q:
            return None
        if "rps" in q:
            bucket = self._bucket(tenant, "rps", q["rps"])
            # a coalesced frame may fuse more requests than the burst holds:
            # each client sent one, so the charge clamps at capacity
            charge = min(max(1.0, float(requests)), bucket.capacity)
            ok, retry = bucket.take(charge)
            if not ok:
                return EdgeReject(429, "rate",
                                  f"request rate quota exhausted ({q['rps']:g} requests/s)",
                                  retry_after=retry)
            self._note_usage(tenant, "rps", charge)
        if "vps" in q:
            bucket = self._bucket(tenant, "vps", q["vps"])
            if values > bucket.capacity and requests <= 1:
                # one request the bucket can never hold: a terminal 413, not
                # a Retry-After that loops a compliant client forever
                return EdgeReject(
                    413, "values",
                    f"request of {values} values exceeds this tenant's burst capacity "
                    f"({bucket.capacity:g} at {q['vps']:g} values/s); split the request")
            charge = min(max(1.0, float(values)), bucket.capacity)
            ok, retry = bucket.take(charge)
            if not ok:
                return EdgeReject(429, "values",
                                  f"value rate quota exhausted ({q['vps']:g} values/s)",
                                  retry_after=retry)
            self._note_usage(tenant, "vps", charge)
        if "cpu" in q and self.cpu_reader is not None:
            # per program: the ledger attributes cpu_seconds to programs
            label = _program_state_label(program.partition("@")[0] if program else "default")
            with self._lock:
                meter = self._cpu_meters.get(label)
                if meter is None:
                    meter = self._cpu_meters[label] = CpuMeter(self.cpu_window_s)
            ok, retry = meter.check(float(self.cpu_reader(label)), q["cpu"])
            if not ok:
                return EdgeReject(429, "cpu",
                                  f"cpu quota exhausted ({q['cpu']:g} core-seconds/s "
                                  f"over {self.cpu_window_s:g}s)",
                                  retry_after=retry)
        return None

    # -- usage gossip ---------------------------------------------------------

    def _note_usage(self, label: str, field: str, n: float) -> None:
        if n <= 0:
            return
        with self._gossip_lock:
            k = (label, field)
            self._usage[k] = self._usage.get(k, 0.0) + n

    def usage_snapshot(self) -> dict[str, float]:
        """Cumulative admitted quota tokens since boot, keyed "tenant|field"
        (monotone: a lost or repeated round never double-counts)."""
        with self._gossip_lock:
            return {f"{t}|{f}": round(v, 3) for (t, f), v in self._usage.items()}

    def apply_remote_usage(self, usage: dict, source: str = "peer") -> int:
        """Drain each existing local bucket by the delta of `usage` since the
        last round from `source`; a counter that went backwards re-anchors.
        Returns the number of buckets drained."""
        if not isinstance(usage, dict):
            raise ValueError("usage must map 'tenant|field' -> total")
        deltas: list[tuple[str, str, float]] = []
        with self._gossip_lock:
            last = self._gossip_applied.setdefault(source, {})
            for key, total in usage.items():
                try:
                    tot = float(total)
                except (TypeError, ValueError):
                    continue
                prev = last.get(key, 0.0)
                if tot > prev:
                    tenant, _, field = str(key).rpartition("|")
                    if field in ("rps", "vps"):
                        deltas.append((tenant, field, tot - prev))
                last[key] = tot
        drained = 0
        for tenant, field, delta in deltas:
            with self._lock:
                buckets = [b for (t, f, _r), b in self._buckets.items()
                           if t == tenant and f == field]
            for b in buckets:
                b.drain(delta)
                drained += 1
            if buckets:
                M_EDGE_GOSSIP_DRAINED.labels(field=field).inc(delta * len(buckets))
        return drained

    def debug_payload(self) -> dict:
        """The /healthz `edge` block: which stages are armed."""
        return {
            "auth": self.keyfile is not None,
            "keys": len(self.keyfile) if self.keyfile is not None else 0,
            "tokens": self.token_secret is not None,
            "quota": self.quota_enabled,
            "admission": self.governor is not None,
            "admission_high": self.governor.high if self.governor is not None else None,
        }


# --- construction ------------------------------------------------------------

_DISARMED = EdgeChain(keyfile=None, quota_defaults=None, governor=None,
                      auth_enabled=False, quota_enabled=False, admission_enabled=False)

_installed: EdgeChain = _DISARMED


def install(chain: EdgeChain) -> EdgeChain:
    """Make `chain` the process's edge (read through current())."""
    global _installed
    _installed = chain
    return chain


def reset() -> None:
    """Restore the disarmed placeholder chain."""
    install(_DISARMED)


def current() -> EdgeChain:
    return _installed


def keyfile_path(environ=os.environ) -> str | None:
    """MISAKA_API_KEYS, or the conventional <MISAKA_PROGRAMS_DIR>/
    api_keys.json when that file exists."""
    p = environ.get("MISAKA_API_KEYS")
    if p:
        return p
    d = environ.get("MISAKA_PROGRAMS_DIR")
    if d:
        conv = os.path.join(d, "api_keys.json")
        if os.path.exists(conv):
            return conv
    return None


def from_env(signals=None, cpu_reader=None, default_admission_high: int = 65536,
             environ=os.environ) -> EdgeChain:
    """The process's chain from the env.

    MISAKA_EDGE=0 disarms everything; MISAKA_EDGE_AUTH, MISAKA_EDGE_QUOTA
    and MISAKA_EDGE_ADMISSION=0 one stage each.  MISAKA_ADMISSION_HIGH is
    the soft watermark in waiting values (`default_admission_high`
    otherwise: the engine passes one that clears the largest legal body);
    MISAKA_QUOTA the env-default spec; MISAKA_QUOTA_BURST_S the bucket
    burst window (2 s); MISAKA_QUOTA_CPU_WINDOW_S the cpu window (60 s).
    The governor exists only when `signals` is given, the `cpu` stage
    only with a `cpu_reader` (a program label -> its cumulative cpu
    seconds: the usage ledger).  MISAKA_TOKEN_SECRET
    [_FILE] (else the plane secret) arms signed tenant tokens;
    MISAKA_EDGE_INTERNAL_TOKEN the per-boot admin credential."""
    if environ.get("MISAKA_EDGE", "1") == "0":
        return _DISARMED
    auth_on = environ.get("MISAKA_EDGE_AUTH", "1") != "0"
    quota_on = environ.get("MISAKA_EDGE_QUOTA", "1") != "0"
    admission_on = environ.get("MISAKA_EDGE_ADMISSION", "1") != "0"
    kf_path = keyfile_path(environ)
    keyfile = KeyFile(kf_path) if (kf_path and auth_on) else None
    quota_defaults = parse_quota_spec(environ.get("MISAKA_QUOTA"))
    governor = None
    if admission_on and signals is not None:
        governor = AdmissionGovernor(
            signals, int(environ.get("MISAKA_ADMISSION_HIGH", "") or default_admission_high))
    return EdgeChain(
        keyfile=keyfile,
        quota_defaults=quota_defaults,
        governor=governor,
        cpu_reader=cpu_reader,
        auth_enabled=auth_on,
        quota_enabled=quota_on,
        admission_enabled=admission_on,
        burst_s=float(environ.get("MISAKA_QUOTA_BURST_S", "") or 2.0),
        cpu_window_s=float(environ.get("MISAKA_QUOTA_CPU_WINDOW_S", "") or 60.0),
        internal_token=environ.get("MISAKA_EDGE_INTERNAL_TOKEN") or None,
        token_secret=token_secret(environ) if auth_on else None,
    )


def key_from_headers(headers) -> str | None:
    """The presented API key: X-Misaka-Key, or Authorization: Bearer."""
    k = headers.get("X-Misaka-Key")
    if k:
        return k
    auth = headers.get("Authorization")
    if auth and auth.startswith("Bearer "):
        return auth[len("Bearer "):].strip() or None
    return None


# --- TLS on the HTTP edge ----------------------------------------------------


def tls_context_from_env(environ=os.environ) -> ssl.SSLContext | None:
    """A server-side SSLContext from MISAKA_TLS_CERT/MISAKA_TLS_KEY (None
    when both are unset: plain HTTP).  One without the other raises, and
    so does a cert/key that fails to load: a server that fell back to
    plaintext would be worse than one that refused to boot."""
    cert = environ.get("MISAKA_TLS_CERT")
    key = environ.get("MISAKA_TLS_KEY")
    if not cert and not key:
        return None
    if not cert or not key:
        raise ValueError("MISAKA_TLS_CERT and MISAKA_TLS_KEY must be set together")
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(cert, key)
    return ctx


def wrap_server_tls(httpd, context: ssl.SSLContext | None):
    """Wrap an already-bound http.server socket for TLS (no-op when
    `context` is None); returns httpd.

    The handshake is deferred (do_handshake_on_connect=False): run inside
    accept(), the server's single accept loop, one client that connects
    and sends nothing (a plaintext prober) would stall every other client.
    Deferred, it happens on the handler thread's first read."""
    if context is not None:
        httpd.socket = context.wrap_socket(
            httpd.socket, server_side=True, do_handshake_on_connect=False
        )
        httpd.misaka_tls = True
    return httpd


def drain_or_close(handler, max_drain: int = 65536) -> None:
    """The keep-alive discipline of a surface that rejects a POST before
    its route body runs: a small unread body is drained (the connection
    stays synchronized), a bulk or unparseable one closes the connection,
    so rejecting at the door never buffers the flood it is shedding."""
    try:
        length = int(handler.headers.get("Content-Length") or 0)
    except ValueError:
        length = -1
    if 0 <= length <= max_drain:
        handler.rfile.read(length)
    else:
        handler.close_connection = True


# --- plane mTLS (TCP transport) -----------------------------------------------


class PlaneTLSReloader:
    """Hot-reloadable mTLS contexts for the TCP compute plane.

    MISAKA_PLANE_TLS_CERT/KEY/CA name this process's certificate, its key
    and the pinned fleet CA.  Both sides authenticate: the plane server
    requires a client certificate the CA signed (CERT_REQUIRED), and the
    client verifies the server's chain against the same CA.  Hostnames are
    not checked: identity here is CA membership, not a DNS name.

    Rotation without a restart: the three files' mtime and size are stat'd
    at most every 0.5 s; a change rebuilds both contexts, and new
    connections take them while established sessions stream on.  A
    rebuild that fails (files half written mid-rotation) keeps the
    previous contexts and counts misaka_plane_tls_reloads_total{status=
    "error"}; the stamp is recorded, so the broken files are not re-parsed
    on every dial, and the next change retries."""

    def __init__(self, cert: str, key: str, ca: str):
        self.cert, self.key, self.ca = cert, key, ca
        self._lock = threading.Lock()
        self._next_stat = 0.0
        self._stamp = self._stat()  # missing files raise: fail loud
        # and so does a first build that fails: a plane that ran plaintext
        # after a bad certificate would be worse than one that refused
        self._server, self._client = self._make()

    def _stat(self) -> tuple:
        out = []
        for p in (self.cert, self.key, self.ca):
            st = os.stat(p)
            out.append((st.st_mtime, st.st_size))
        return tuple(out)

    def _make(self) -> tuple[ssl.SSLContext, ssl.SSLContext]:
        server = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        server.minimum_version = ssl.TLSVersion.TLSv1_2
        server.load_cert_chain(self.cert, self.key)
        server.load_verify_locations(self.ca)
        server.verify_mode = ssl.CERT_REQUIRED
        # no TLS 1.3 session tickets: a plane resumes no session (every
        # dial is a full handshake), and a ticket arriving while a peer's
        # receiver reads and its dispatcher writes one session is the
        # race that stalls frames (the JAX package's client runs so)
        server.num_tickets = 0
        client = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        client.minimum_version = ssl.TLSVersion.TLSv1_2
        client.load_cert_chain(self.cert, self.key)
        client.load_verify_locations(self.ca)
        client.check_hostname = False  # CA-pinned, not DNS identity
        client.verify_mode = ssl.CERT_REQUIRED
        return server, client

    def _maybe_reload(self) -> None:
        now = time.monotonic()
        if now < self._next_stat:
            return
        with self._lock:
            if now < self._next_stat:
                return
            self._next_stat = now + 0.5
            try:
                stamp = self._stat()
            except OSError:
                return  # a rename window mid-rotation: keep serving
            if stamp == self._stamp:
                return
            self._stamp = stamp
            try:
                server, client = self._make()
            except (OSError, ssl.SSLError, ValueError) as e:
                M_PLANE_TLS_RELOADS.labels(status="error").inc()
                log.error("edge: plane TLS reload failed (%s); keeping the previous "
                          "certificates", e)
                return
            self._server, self._client = server, client
            M_PLANE_TLS_RELOADS.labels(status="ok").inc()
            log.info("edge: plane TLS certificates reloaded from %s", self.cert)

    def server_context(self) -> ssl.SSLContext:
        self._maybe_reload()
        return self._server

    def client_context(self) -> ssl.SSLContext:
        self._maybe_reload()
        return self._client


def plane_tls_from_env(environ=os.environ) -> PlaneTLSReloader | None:
    """The plane's mTLS material from MISAKA_PLANE_TLS_CERT/KEY/CA (None
    when all three are unset: a TCP plane then runs plaintext behind the
    HMAC handshake).  A partial triple raises, and so do files that fail
    to load."""
    cert = environ.get("MISAKA_PLANE_TLS_CERT")
    key = environ.get("MISAKA_PLANE_TLS_KEY")
    ca = environ.get("MISAKA_PLANE_TLS_CA")
    if not cert and not key and not ca:
        return None
    if not (cert and key and ca):
        raise ValueError("MISAKA_PLANE_TLS_CERT, MISAKA_PLANE_TLS_KEY and "
                         "MISAKA_PLANE_TLS_CA must be set together")
    return PlaneTLSReloader(cert, key, ca)


def count_plane_tls_reject(reason: str) -> None:
    """One plane connection refused at the mTLS gate (a typed, counted
    close)."""
    M_PLANE_TLS_REJECTED.labels(
        reason=reason if reason in ("plaintext", "bad_cert") else "handshake").inc()


# --- the native edge's state push ---------------------------------------------


def native_edge_state(chain: EdgeChain | None = None) -> dict:
    """The chain's auth and quota surface as the native C++ edge takes it
    (runtime/frontends.py `NativeFrontendSupervisor` pushes it through
    msk_edge_push_state).  The native tier is a cache, never an authority:

    * `digests` lists every known key's digest (hex; raw keys never cross
      the boundary), disabled keys included, so that a disabled key
      reaches the engine's chain and gets its 403, not a local 401;
    * burst caps ride only on keys whose own spec pins `vps` (a key's spec
      overrides the program's and the env's field by field, so the cap is
      exact there); `burst_msg_mid` is the message's middle, rendered with
      %g here, so that C++ never formats a Python float;
    * the 401 bodies are shipped verbatim.

    With tenant tokens armed the native tier must not reject locally: a
    valid token is verified, not looked up, so `auth_armed` is false and
    every request goes to the engine's chain.  The fleet's internal token
    is listed as tenant `_fleet`."""
    if chain is None:
        chain = current()
    state: dict = {
        "auth_armed": chain.keyfile is not None and chain.token_secret is None,
        "digests": {},
        "reject_missing": "API key required (X-Misaka-Key header or Authorization: Bearer <key>)",
        "reject_unknown": "unknown API key",
    }
    kf = chain.keyfile
    if kf is not None:
        kf._load()
        for digest, entry in kf._by_digest.items():
            d: dict = {"tenant": entry["tenant"]}
            spec = entry.get("quota_spec")
            if chain.quota_enabled and not entry.get("disabled") and spec and "vps" in spec:
                vps = float(spec["vps"])
                cap = max(1.0, vps * chain.burst_s)
                d["burst_cap"] = cap
                d["burst_msg_mid"] = (f" values exceeds this tenant's burst capacity "
                                      f"({cap:g} at {vps:g} values/s); split the request")
            state["digests"][digest.hex()] = d
    if chain.internal_token is not None:
        state["digests"][_digest(chain.internal_token).hex()] = {"tenant": "_fleet"}
    return state


# --- compute-plane shared secret ---------------------------------------------

_PLANE_TAG = b"misaka-plane-v1"
PLANE_HANDSHAKE_LEN = 32


def plane_secret(environ=os.environ) -> bytes | None:
    """MISAKA_PLANE_SECRET, or the contents of MISAKA_PLANE_SECRET_FILE
    (None: an open plane)."""
    s = environ.get("MISAKA_PLANE_SECRET")
    if s:
        return s.encode()
    p = environ.get("MISAKA_PLANE_SECRET_FILE")
    if p:
        try:
            with open(p, "rb") as f:
                return f.read().strip() or None
        except OSError:
            log.error("edge: plane secret file %s unreadable", p)
            return None
    return None


def plane_handshake(secret: bytes) -> bytes:
    """The 32 bytes a plane client writes right after connect()."""
    return hmac.new(secret, _PLANE_TAG, hashlib.sha256).digest()


def verify_plane_handshake(secret: bytes, presented: bytes) -> bool:
    return hmac.compare_digest(plane_handshake(secret), presented)


# --- signed tenant tokens ----------------------------------------------------
#
# Short-lived, HMAC-signed under one secret, minted by the admin route POST
# /edge/token and verified locally by every process holding the secret:
#
#     mst1.<base64url payload>.<base64url HMAC-SHA256 sig>
#
# payload JSON: {"t": tenant, "exp": epoch seconds, "adm": bool?,
# "p": [programs]?}.  Expiry is wall-clock: tokens cross hosts.

_TOKEN_TAG = b"misaka-tenant-token-v1"
TOKEN_PREFIX = "mst1."

_token_children = {op: M_EDGE_TOKENS.labels(op=op) for op in ("mint", "ok", "expired", "invalid")}


def token_secret(environ=os.environ) -> bytes | None:
    """MISAKA_TOKEN_SECRET, or MISAKA_TOKEN_SECRET_FILE, falling back to the
    plane secret.  None disarms minting and verification: an `mst1.` string
    is then just an unknown API key."""
    s = environ.get("MISAKA_TOKEN_SECRET")
    if s:
        return s.encode()
    p = environ.get("MISAKA_TOKEN_SECRET_FILE")
    if p:
        try:
            with open(p, "rb") as f:
                return f.read().strip() or None
        except OSError:
            log.error("edge: token secret file %s unreadable", p)
            return None
    return plane_secret(environ)


def _token_sign(secret: bytes, payload_b64: bytes) -> bytes:
    return hmac.new(secret, _TOKEN_TAG + b"." + payload_b64, hashlib.sha256).digest()


def mint_tenant_token(secret: bytes, tenant: str, ttl_s: float = 300.0, admin: bool = False,
                      programs=None, now: float | None = None) -> tuple[str, float]:
    """A signed tenant token -> (token, expires_at_epoch)."""
    exp = (time.time() if now is None else now) + max(1.0, float(ttl_s))
    payload: dict = {"t": tenant, "exp": round(exp, 3)}
    if admin:
        payload["adm"] = True
    if programs:
        payload["p"] = sorted(programs)
    pb = base64.urlsafe_b64encode(json.dumps(payload, separators=(",", ":")).encode()).rstrip(b"=")
    sig = base64.urlsafe_b64encode(_token_sign(secret, pb)).rstrip(b"=")
    _token_children["mint"].inc()
    return TOKEN_PREFIX + pb.decode() + "." + sig.decode(), float(payload["exp"])


def verify_tenant_token(secret: bytes, token: str,
                        now: float | None = None) -> tuple[dict | None, str]:
    """-> (a synthetic key-table entry, "ok"), or (None, "invalid" |
    "expired").  The signature is checked before the payload is parsed."""
    body = token[len(TOKEN_PREFIX):] if token.startswith(TOKEN_PREFIX) else token
    pb_s, _, sig_s = body.partition(".")
    if not pb_s or not sig_s:
        return None, "invalid"
    try:
        pb = pb_s.encode("ascii")
        sig = base64.urlsafe_b64decode(sig_s.encode("ascii") + b"=" * (-len(sig_s) % 4))
        if not hmac.compare_digest(_token_sign(secret, pb), sig):
            return None, "invalid"
        payload = json.loads(base64.urlsafe_b64decode(pb + b"=" * (-len(pb_s) % 4)))
        tenant = payload["t"]
        exp = float(payload["exp"])
        programs = payload.get("p")
        if not isinstance(tenant, str) or (programs is not None and not isinstance(programs, list)):
            return None, "invalid"
    except (ValueError, TypeError, KeyError, UnicodeDecodeError):
        return None, "invalid"
    if (time.time() if now is None else now) >= exp:
        return None, "expired"
    return {
        "tenant": tenant,
        "admin": bool(payload.get("adm")),
        "programs": frozenset(programs) if programs is not None else None,
        "quota": None,
        "quota_spec": None,
        "disabled": False,
        "token_exp": exp,
    }, "ok"
