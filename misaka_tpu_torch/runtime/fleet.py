"""The replicated engine fleet: N engine processes behind one endpoint.

The port of misaka_tpu/runtime/fleet.py.  The parent spawns N replicas,
each a full `python -m misaka_tpu_torch.runtime.app` process with its own
device loop launching the fused kernel on the card, and puts the frontend
workers in front of them as a data-parallel router:

    clients --HTTP--> frontend workers (SO_REUSEPORT)
                          |  FleetPlaneRouter (runtime/frontends.py)
            +-------------+--------------+
            v             v              v
        replica 0      replica 1  ...  replica N-1    (supervised here)
            ^             ^              ^
            +---- fleet control server --+  (aggregated /metrics, /status,
                  /healthz, POST /fleet/roll, lifecycle fan-out, proxy)

Routing (frontends.FleetPlaneRouter; the hash ring lives here so both
sides share it): least queue depth for stateless compute, ties to the
lowest index; the program name's consistent-hash owner for addressed
compute; a frame a replica fails is hedged onto a sibling, and the typed
503 comes only when the whole fleet is down.

Supervision is the frontend supervisor's one level up: a dead replica is
respawned with exponential backoff and jitter, a crash loop opens a
circuit breaker, and per-replica health (each replica's /healthz, probed
by one thread per slot) gates routing and rides the aggregated /healthz
and /status.

A rolling restart (POST /fleet/roll) takes one replica at a time: drain to
quiescence (its plane answers new frames with the reroute status the
router absorbs), a manifest-verified checkpoint, kill, a replacement that
restores it (MISAKA_FLEET_RESTORE) before any traffic, readmission.
Static remote peers (MISAKA_FLEET_PEERS) are probed, routed to over their
TCP planes and rolled through drain -> checkpoint -> readmit; the usage
gossip hub (MISAKA_GOSSIP_S) reconciles the replicas' quota buckets.

The module imports the standard library and the port's stdlib-only
modules only: a frontend worker imports HashRing from here and must not
pay for torch.  The parent imports torch only inside run_fleet, where it
builds the kernel once before the replicas boot.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import logging
import os
import queue
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import weakref
from bisect import bisect_left
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, quote, urlencode

from misaka_tpu_torch.utils import faults, metrics
from misaka_tpu_torch.utils.backoff import Backoff

log = logging.getLogger("misaka_tpu_torch.fleet")


def reserve_port() -> socket.socket:
    """A free TCP port, held: a socket bound on every address with
    SO_REUSEADDR that never listens.  The replica's server binds the same
    port (SO_REUSEADDR, as every HTTPServer does) in each of its lives,
    and while the replica is down no client's ephemeral source port can
    land on it: a client connection closed there would sit in TIME_WAIT
    and refuse the respawn's bind for a minute, a loop of failed respawns."""
    sock = socket.socket()
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind(("0.0.0.0", 0))
    return sock


M_FLEET_CONFIGURED = metrics.gauge(
    "misaka_fleet_replicas_configured",
    "Engine replicas the fleet is configured for (live fleet manager)",
)
M_FLEET_ALIVE = metrics.gauge(
    "misaka_fleet_replicas_alive",
    "Engine replica processes currently alive (live fleet manager)",
)
M_FLEET_RESTARTS = metrics.counter(
    "misaka_fleet_replica_restarts_total",
    "Engine replica processes respawned by the fleet manager",
    ("reason",),  # "crash" | "roll"
)
M_FLEET_ROLLS = metrics.counter(
    "misaka_fleet_rolls_total",
    "Rolling restarts completed by the fleet manager",
    ("status",),  # "ok" | "failed"
)
M_FLEET_PEERS_UP = metrics.gauge(
    "misaka_fleet_peers_up",
    "Registered remote peers currently passing health probes",
)
M_FLEET_GOSSIP = metrics.counter(
    "misaka_fleet_gossip_total",
    "Usage-gossip exchanges driven by the fleet hub, per target outcome",
    ("status",),  # "ok" | "error"
)


# --- consistent hashing -------------------------------------------------------------------


class HashRing:
    """Consistent hashing over replica indices (sha1, virtual nodes).

    `lookup(key)` returns every replica once, in ring order from the key's
    position: a preference list the router walks for the first healthy
    replica.  Removing one replica of N changes the first preference of
    only its own keys (~1/N); every other key keeps its owner."""

    def __init__(self, replicas, vnodes: int = 64):
        self.replicas = sorted(replicas)
        points = []
        for rid in self.replicas:
            for v in range(vnodes):
                h = hashlib.sha1(f"misaka-replica-{rid}#{v}".encode()).digest()
                points.append((int.from_bytes(h[:8], "big"), rid))
        points.sort()
        self._points = points
        self._hashes = [p[0] for p in points]

    def lookup(self, key: str) -> list[int]:
        """Preference order of replica indices for `key` (all, each once)."""
        if not self._points:
            return []
        h = int.from_bytes(hashlib.sha1(key.encode()).digest()[:8], "big")
        start = bisect_left(self._hashes, h) % len(self._points)
        order: list[int] = []
        seen = set()
        for i in range(len(self._points)):
            rid = self._points[(start + i) % len(self._points)][1]
            if rid not in seen:
                seen.add(rid)
                order.append(rid)
                if len(order) == len(self.replicas):
                    break
        return order

    def owner(self, key: str) -> int:
        return self.lookup(key)[0]


# --- small shared helpers -----------------------------------------------------------------


def parse_fleet_peers(spec: str | None) -> list[dict]:
    """MISAKA_FLEET_PEERS="host:port[:planeport],..." -> peer descriptors.

    `port` is the peer's HTTP port (probes and the roll protocol); its
    compute plane defaults to port + 1 on the same host unless a third
    field pins it.  A malformed entry raises: a typo'd peer dropped from
    supervision in silence would be worse than none."""
    peers: list[dict] = []
    for raw in (spec or "").split(","):
        entry = raw.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) not in (2, 3) or not parts[0]:
            raise ValueError(f"MISAKA_FLEET_PEERS entry {entry!r}: want host:port or "
                             f"host:port:planeport")
        try:
            port = int(parts[1])
            plane_port = int(parts[2]) if len(parts) == 3 else port + 1
        except ValueError:
            raise ValueError(f"MISAKA_FLEET_PEERS entry {entry!r}: ports must be "
                             f"integers") from None
        peers.append({"host": parts[0], "port": port, "plane": f"{parts[0]}:{plane_port}"})
    return peers


def verify_manifest(path: str) -> None:
    """The strict gate on a checkpoint just written: its `.manifest`
    sidecar must exist and match the file's size and sha256, else
    RuntimeError.  The full verifier (runtime/checkpoint.py) tolerates a
    missing or stale sidecar because it gates restores of old history; a
    roll checkpoint was written moments ago, so anything short of an exact
    match means the save tore, and the replica must not be killed."""
    mpath = path + ".manifest"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        want_size = int(manifest["size"])
        want_sha = str(manifest["sha256"])
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise RuntimeError(f"roll checkpoint {path}: unreadable manifest ({e})") from e
    size = os.path.getsize(path)
    if size != want_size:
        raise RuntimeError(f"roll checkpoint {path}: {size} bytes on disk vs {want_size} "
                           f"in the manifest (torn write)")
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    if h.hexdigest() != want_sha:
        raise RuntimeError(f"roll checkpoint {path}: sha256 mismatch against the manifest")


class _ReplicaHTTP:
    """One-shot HTTP calls against one replica's server (control calls are
    rare: no pooling).  Local replicas are on loopback; remote peers pass
    their host.  `key` is the fleet's internal token (or the peer key), so
    the parent's own calls pass a replica's edge when auth is armed."""

    def __init__(self, port: int, timeout: float = 10.0, key: str | None = None,
                 host: str = "127.0.0.1"):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.key = key

    def request(self, method: str, path: str, body: bytes | None = None,
                headers: dict | None = None, timeout: float | None = None
                ) -> tuple[int, bytes, dict]:
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout if timeout is None else timeout)
        headers = dict(headers or {})
        if self.key is not None and "X-Misaka-Key" not in headers:
            headers["X-Misaka-Key"] = self.key
        try:
            conn.request(method, path, body, headers)
            resp = conn.getresponse()
            payload = resp.read()
            return resp.status, payload, dict(resp.getheaders())
        finally:
            conn.close()

    def get_json(self, path: str, timeout: float | None = None):
        status, body, _ = self.request("GET", path, timeout=timeout)
        if status != 200:
            raise RuntimeError(f"GET {path} on {self.host}:{self.port} -> {status}: "
                               f"{body[:200].decode(errors='replace')}")
        return json.loads(body)

    def post_json(self, path: str, obj, timeout: float | None = None) -> tuple[int, bytes]:
        status, payload, _ = self.request("POST", path, json.dumps(obj).encode(),
                                          {"Content-Type": "application/json"},
                                          timeout=timeout)
        return status, payload

    def post_form(self, path: str, timeout: float | None = None, **fields) -> tuple[int, bytes]:
        status, payload, _ = self.request(
            "POST", path, urlencode(fields).encode(),
            {"Content-Type": "application/x-www-form-urlencoded"}, timeout=timeout)
        return status, payload


# --- the fleet manager --------------------------------------------------------------------


class FleetManager:
    """Spawns and supervises N engine-replica processes.

    Each replica is pinned to a slot identity (a loopback HTTP port and a
    plane socket path) that survives respawns and rolls, so the router
    readmits a replacement the moment its plane accepts.  A monitor thread
    reaps deaths and respawns on a bounded backoff curve; a slot whose
    replicas keep dying fast opens its circuit breaker.  One prober thread
    per slot reads the replica's /healthz: "up" on a passing probe,
    "degraded" while probes fail, "down" when the process is dead or
    probes failed `down_after` times, "draining" while a roll owns it,
    "starting" before its first answer."""

    def __init__(self, n: int, fleet_dir: str, base_env: dict | None = None,
                 backoff_base: float = 0.5, backoff_cap: float = 15.0,
                 fast_crash_s: float = 5.0, breaker_threshold: int = 5,
                 breaker_reset_s: float = 60.0, poll_s: float = 0.2, probe_s: float = 0.5,
                 down_after: int = 3, boot_timeout_s: float = 180.0,
                 drain_timeout_s: float = 30.0):
        self.n = max(1, int(n))
        self.fleet_dir = fleet_dir
        os.makedirs(fleet_dir, exist_ok=True)
        self._base_env = dict(base_env if base_env is not None else os.environ)
        self._backoff = Backoff(base=backoff_base, cap=backoff_cap)
        self._fast_crash_s = float(fast_crash_s)
        self._breaker_threshold = max(1, int(breaker_threshold))
        self._breaker_reset_s = float(breaker_reset_s)
        self._poll_s = float(poll_s)
        self._probe_s = float(probe_s)
        self._down_after = max(1, int(down_after))
        self._boot_timeout_s = float(boot_timeout_s)
        self._drain_timeout_s = float(drain_timeout_s)
        self._lock = threading.Lock()
        self._closed = False
        # the per-boot internal credential: replicas take it as an admin
        # key (MISAKA_EDGE_INTERNAL_TOKEN), so the fleet's own drain,
        # checkpoint and aggregation calls pass their edge when auth is on
        self._internal_token = os.urandom(16).hex()
        self._restarts_total = 0
        self._rolls_total = 0
        self._last_roll: dict | None = None
        self._roll_lock = threading.Lock()  # one roll at a time
        # every replica Popen runs on one long-lived spawner thread: a
        # replica arms PR_SET_PDEATHSIG (runtime/lifecycle.py), which fires
        # when the spawning thread exits, so a replica forked from a
        # /fleet/roll handler thread would die with that request
        self._spawn_q: queue.Queue = queue.Queue()
        self._spawner = threading.Thread(target=self._spawner_loop, daemon=True,
                                         name="misaka-fleet-spawner")
        self._spawner.start()
        now = time.monotonic()
        # each replica's HTTP port, held for the fleet's life (reserve_port)
        self._port_holds = [reserve_port() for _ in range(self.n)]
        self._slots: list[dict] = []
        for i in range(self.n):
            self._slots.append({
                "idx": i,
                "port": self._port_holds[i].getsockname()[1],
                "plane": os.path.join(fleet_dir, f"plane-{i}.sock"),
                "ckpt_dir": os.path.join(fleet_dir, f"replica-{i}"),
                "proc": None,
                "spawned_at": now,
                "restarts": 0,
                "fast_crashes": 0,
                "next_spawn": 0.0,
                "breaker_until": None,
                "probe_fails": 0,
                "probe_ok": False,
                "running": None,    # the replica's network run state (probed)
                "degraded": False,  # replica-declared (probed /healthz)
                "rolling": False,   # a roll owns the slot: the monitor hands off
                "restore": None,    # the checkpoint the next spawn restores
                "run_on_boot": None,  # the run state a roll preserves (one-shot)
            })
        # static remote peers: replicas on other hosts this fleet routes to
        # and supervises remotely (probe, drain, checkpoint), kept apart
        # from the slots, which the monitor respawns; their indices follow
        # the slots'
        self._peers: list[dict] = []
        for j, peer in enumerate(parse_fleet_peers(self._base_env.get("MISAKA_FLEET_PEERS"))):
            peer.update({"idx": self.n + j, "probe_fails": 0, "probe_ok": False,
                         "running": None, "degraded": False, "rolling": False,
                         "remote": True})
            self._peers.append(peer)
        # peers are separate boots with their own internal tokens: remote
        # calls need a shared admin key, else this boot's token
        self._peer_key = self._base_env.get("MISAKA_FLEET_PEER_KEY") or self._internal_token
        self._gossip_s = float(self._base_env.get("MISAKA_GOSSIP_S", "0.5") or 0.5)
        # the gossip hub's cumulative usage snapshot per source
        self._gossip_seen: dict[str, dict[str, float]] = {}
        self._threads: list[threading.Thread] = []

    # --- lifecycle -------------------------------------------------------------------

    def start(self, wait_ready: bool = True) -> None:
        for slot in self._slots:
            self._spawn(slot)
        if wait_ready:
            deadline = time.monotonic() + self._boot_timeout_s
            for slot in self._slots:
                self._wait_replica_ready(slot, deadline)
        ref = weakref.ref(self)
        M_FLEET_CONFIGURED.set_function(lambda: f.n if (f := ref()) is not None else 0)
        M_FLEET_ALIVE.set_function(lambda: f.alive() if (f := ref()) is not None else 0)
        M_FLEET_PEERS_UP.set_function(
            lambda: sum(1 for p in f._peers if p["probe_ok"]) if (f := ref()) is not None else 0)
        self._start_thread(self._monitor_loop, "misaka-fleet-monitor")
        for slot in self._slots:
            self._start_thread(self._probe_loop, f"misaka-fleet-probe-{slot['idx']}", slot)
        for peer in self._peers:
            self._start_thread(self._peer_probe_loop, f"misaka-fleet-peer-probe-{peer['idx']}",
                               peer)
        if self._gossip_s > 0 and (self._peers or self.n > 1):
            self._start_thread(self._gossip_loop, "misaka-fleet-gossip")
        # chaos (utils/faults.py): `replica_kill=N` SIGKILLs one live
        # replica N seconds after the fleet starts, once per fleet boot
        # (per spawn would kill every respawn into a loop the breaker
        # would read as a crash loop)
        kill_after = faults.fire("replica_kill")
        if kill_after is not None:
            threading.Thread(target=self._chaos_kill, args=(max(0.0, kill_after),),
                             daemon=True, name="misaka-fleet-chaos-kill").start()

    def _start_thread(self, target, name: str, *args) -> None:
        t = threading.Thread(target=target, args=args, daemon=True, name=name)
        t.start()
        self._threads.append(t)

    def _chaos_kill(self, delay: float) -> None:
        time.sleep(delay)
        with self._lock:
            live = [s for s in self._slots if s["proc"] is not None and s["proc"].poll() is None]
            if not live:
                return
            victim = live[0]
            pid = victim["proc"].pid
        log.warning("replica_kill fault: SIGKILL replica %d (pid %d)", victim["idx"], pid)
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            procs = [s["proc"] for s in self._slots if s["proc"] is not None]
        for p in procs:
            try:
                p.terminate()
            except OSError:
                pass
        for p in procs:
            try:
                p.wait(timeout=5)
            except (OSError, subprocess.TimeoutExpired):
                try:
                    p.kill()
                    p.wait(timeout=2)
                except (OSError, subprocess.TimeoutExpired):
                    pass
        self._spawn_q.put(None)
        for t in self._threads:
            t.join(timeout=2)
        for sock in self._port_holds:
            sock.close()

    # --- spawning --------------------------------------------------------------------

    def plane_paths(self) -> list[str]:
        """Every plane the router fans across: local sockets first, then
        the peers' host:port planes (router indices are slot/peer idx)."""
        return [s["plane"] for s in self._slots] + [p["plane"] for p in self._peers]

    def _replica_env(self, slot: dict) -> dict:
        env = dict(self._base_env)
        env.update({
            # one engine behind the shared tier: no fleet, no workers
            "MISAKA_FLEET": "0",
            "MISAKA_HTTP_WORKERS": "0",
            "MISAKA_PORT": str(slot["port"]),
            "MISAKA_PLANE_SOCKET": slot["plane"],
            "MISAKA_PLANE_SERVE": "1",
            "MISAKA_FLEET_REPLICA": str(slot["idx"]),
            # each replica checkpoints (and auto-restores) in its own dir
            "MISAKA_CHECKPOINT_DIR": slot["ckpt_dir"],
        })
        env.pop("MISAKA_ORPHAN_OK", None)  # replicas die with the fleet
        # TLS terminates at the workers; a replica serves loopback HTTP
        env.pop("MISAKA_TLS_CERT", None)
        env.pop("MISAKA_TLS_KEY", None)
        from misaka_tpu_torch.runtime import edge as edge_mod

        keyfile = edge_mod.keyfile_path(self._base_env)
        if keyfile and not self._base_env.get("MISAKA_API_KEYS"):
            # <MISAKA_PROGRAMS_DIR>/api_keys.json would not resolve under
            # the per-replica store below: pin the parent's resolved path
            env["MISAKA_API_KEYS"] = keyfile
        env["MISAKA_EDGE_INTERNAL_TOKEN"] = self._internal_token
        if not self._base_env.get("MISAKA_NATIVE_THREADS") and self.n > 1:
            # N replicas share one box: a full-width native pool each
            # would oversubscribe every core N times, so split the cores;
            # an explicit MISAKA_NATIVE_THREADS always wins
            env["MISAKA_NATIVE_THREADS"] = str(max(2, (os.cpu_count() or 8) // self.n))
        programs_dir = self._base_env.get("MISAKA_PROGRAMS_DIR")
        if programs_dir:
            # per-replica registry stores (uploads fan out to every one)
            env["MISAKA_PROGRAMS_DIR"] = os.path.join(programs_dir, f"replica-{slot['idx']}")
        tsdb_dir = self._base_env.get("MISAKA_TSDB_DIR")
        if tsdb_dir:
            # the durable spools are single-writer per directory; the
            # parent keeps the root for its own history
            env["MISAKA_TSDB_DIR"] = os.path.join(tsdb_dir, f"replica-{slot['idx']}")
        if slot["restore"]:
            env["MISAKA_FLEET_RESTORE"] = slot["restore"]
        else:
            env.pop("MISAKA_FLEET_RESTORE", None)
        if slot["run_on_boot"] is not None:
            # a roll's replacement keeps its predecessor's run state
            env["MISAKA_AUTORUN"] = "1" if slot["run_on_boot"] else "0"
        return env

    def _spawner_loop(self) -> None:
        while True:
            item = self._spawn_q.get()
            if item is None:
                return
            slot, outcome, done = item
            try:
                self._spawn_inline(slot)
            except BaseException as e:  # re-raised on the caller's thread
                outcome.append(e)
            done.set()

    def _spawn(self, slot: dict) -> None:
        """Spawn on the spawner thread; raises what Popen raised."""
        if threading.current_thread() is self._spawner:
            self._spawn_inline(slot)
            return
        outcome: list = []
        done = threading.Event()
        self._spawn_q.put((slot, outcome, done))
        done.wait()
        if outcome:
            raise outcome[0]

    def _spawn_inline(self, slot: dict) -> None:
        os.makedirs(slot["ckpt_dir"], exist_ok=True)
        cmd = [sys.executable, "-m", "misaka_tpu_torch.runtime.app"]
        slot["proc"] = subprocess.Popen(cmd, env=self._replica_env(slot))
        slot["spawned_at"] = time.monotonic()
        slot["probe_fails"] = 0
        slot["probe_ok"] = False
        slot["degraded"] = False  # a fresh process is probed afresh
        log.info("replica %d spawned (pid %d, http :%d, plane %s%s)", slot["idx"],
                 slot["proc"].pid, slot["port"], slot["plane"],
                 ", restoring " + slot["restore"] if slot["restore"] else "")
        # restore and run_on_boot stay armed until the replica passes a
        # health check (_mark_healthy): a replacement that crashes during
        # boot retries its checkpoint; once it served, a later crash
        # respawns fresh

    def _wait_replica_ready(self, slot: dict, deadline: float) -> None:
        rh = _ReplicaHTTP(slot["port"], timeout=2.0, key=self._internal_token)
        while time.monotonic() < deadline:
            proc = slot["proc"]
            if proc is not None and proc.poll() is not None:
                raise RuntimeError(f"replica {slot['idx']} exited during boot "
                                   f"(code {proc.returncode})")
            try:
                payload = rh.get_json("/healthz")
                if payload.get("ok"):
                    slot["running"] = bool(payload.get("running"))
                    self._mark_healthy(slot)
                    return
            except (OSError, RuntimeError, ValueError):
                pass
            time.sleep(0.2)
        raise RuntimeError(f"replica {slot['idx']} did not become healthy within "
                           f"{self._boot_timeout_s:.0f}s")

    # --- supervision -----------------------------------------------------------------

    def alive(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots if s["proc"] is not None and s["proc"].poll() is None)

    def replica_state(self, slot: dict) -> str:
        proc = slot["proc"]
        if proc is None or proc.poll() is not None:
            return "down"
        if slot["rolling"]:
            return "draining"
        if slot["probe_ok"]:
            return "up"
        if slot["probe_fails"] >= self._down_after:
            return "down"
        return "degraded" if slot["probe_fails"] else "starting"

    def peer_state(self, peer: dict) -> str:
        """The same ladder for a remote peer: no process to poll, so
        liveness is probe-only, and "draining" while a roll owns it."""
        if peer["rolling"]:
            return "draining"
        if peer["probe_ok"]:
            return "up"
        if peer["probe_fails"] >= self._down_after:
            return "down"
        return "degraded" if peer["probe_fails"] else "starting"

    def state(self) -> dict:
        """The /healthz and /status fleet block: per-replica rows and an
        explicit `degraded` (any replica not up, or up but degraded)."""
        now = time.monotonic()
        with self._lock:
            rows = []
            for s in self._slots:
                rows.append({
                    "replica": s["idx"],
                    "state": self.replica_state(s),
                    "pid": s["proc"].pid if s["proc"] is not None else None,
                    "port": s["port"],
                    "restarts": s["restarts"],
                    "running": s["running"],
                    "degraded": s["degraded"],
                    "breaker_open": bool(s["breaker_until"] is not None
                                         and s["breaker_until"] > now),
                })
            for p in self._peers:
                rows.append({
                    "replica": p["idx"],
                    "state": self.peer_state(p),
                    "pid": None,
                    "host": p["host"],
                    "port": p["port"],
                    "restarts": None,  # the peer's own supervisor counts
                    "running": p["running"],
                    "degraded": p["degraded"],
                    "breaker_open": False,
                    "remote": True,
                })
            restarts = self._restarts_total
            rolls = self._rolls_total
            last_roll = self._last_roll
        up = sum(1 for r in rows if r["state"] == "up")
        return {
            "configured": len(rows),
            "alive": sum(1 for r in rows if r["state"] != "down"),
            "up": up,
            "peers": len(self._peers),
            "peers_up": sum(1 for r in rows if r.get("remote") and r["state"] == "up"),
            "replicas": rows,
            "restarts_total": restarts,
            "rolls_total": rolls,
            "last_roll": last_roll,
            "degraded": up < len(rows) or any(r["state"] == "up" and r["degraded"]
                                              for r in rows),
        }

    def up_slots(self) -> list[dict]:
        with self._lock:
            return [s for s in self._slots if self.replica_state(s) == "up"]

    def slot_states(self) -> list[tuple[dict, str]]:
        """Every slot with its state, in index order (a fan-out reports the
        ones it skipped)."""
        with self._lock:
            return [(s, self.replica_state(s)) for s in self._slots]

    def _mark_healthy(self, slot: dict) -> None:
        slot["probe_ok"] = True
        slot["probe_fails"] = 0
        if slot["rolling"]:
            # the roll owns the slot and has armed `restore` for the
            # replacement: a disarm now (a straggling probe of the old
            # replica) would boot the replacement without its state
            return
        slot["restore"] = None
        slot["run_on_boot"] = None

    def _probe_loop(self, slot: dict) -> None:
        rh = _ReplicaHTTP(slot["port"], timeout=2.0, key=self._internal_token)
        while not self._closed:
            time.sleep(self._probe_s)
            if slot["rolling"]:
                continue  # the roll owns the slot (see _mark_healthy)
            proc = slot["proc"]
            if proc is None or proc.poll() is not None:
                slot["probe_ok"] = False
                continue
            try:
                payload = rh.get_json("/healthz")
                ok = bool(payload.get("ok"))
                slot["running"] = bool(payload.get("running"))
                # a replica's own degradation (an SLO or watchdog page)
                # shows on the fleet's /healthz too
                slot["degraded"] = bool(payload.get("degraded"))
            except (OSError, RuntimeError, ValueError):
                ok = False
            if ok:
                self._mark_healthy(slot)
            else:
                slot["probe_ok"] = False
                slot["probe_fails"] += 1

    def _peer_probe_loop(self, peer: dict) -> None:
        """A remote peer's /healthz on the local cadence: the fleet's
        /healthz and the roll's gate (the router keeps its own view)."""
        rh = _ReplicaHTTP(peer["port"], timeout=2.0, key=self._peer_key, host=peer["host"])
        while not self._closed:
            time.sleep(self._probe_s)
            if peer["rolling"]:
                continue  # a drain reads degraded by design
            try:
                payload = rh.get_json("/healthz")
                ok = bool(payload.get("ok"))
                peer["running"] = bool(payload.get("running"))
                peer["degraded"] = bool(payload.get("degraded"))
            except (OSError, RuntimeError, ValueError):
                ok = False
            if ok:
                if not peer["probe_ok"]:
                    log.info("peer %d (%s:%d) is up", peer["idx"], peer["host"], peer["port"])
                peer["probe_ok"] = True
                peer["probe_fails"] = 0
            else:
                if peer["probe_ok"]:
                    log.warning("peer %d (%s:%d) failed a probe", peer["idx"], peer["host"],
                                peer["port"])
                peer["probe_ok"] = False
                peer["probe_fails"] += 1

    # --- usage gossip hub ------------------------------------------------------------

    def _gossip_targets(self) -> list[tuple[str, _ReplicaHTTP]]:
        """(source key, http helper) of every participant now up."""
        targets: list[tuple[str, _ReplicaHTTP]] = []
        with self._lock:
            for s in self._slots:
                if self.replica_state(s) == "up":
                    targets.append((f"replica-{s['idx']}",
                                    _ReplicaHTTP(s["port"], timeout=2.0,
                                                 key=self._internal_token)))
        for p in self._peers:
            if self.peer_state(p) == "up":
                targets.append((f"peer-{p['idx']}",
                                _ReplicaHTTP(p["port"], timeout=2.0, key=self._peer_key,
                                             host=p["host"])))
        return targets

    def _gossip_loop(self) -> None:
        """Star-topology usage gossip: every MISAKA_GOSSIP_S the hub posts
        each participant the sum of every other participant's cumulative
        per-tenant admissions and takes that participant's own snapshot
        from the answer.  Sums of monotone counters are monotone, so each
        edge chain's per-source deltas (edge.apply_remote_usage) stay
        right, and a flooded tenant's aggregate admission stays near its
        quota instead of N times it."""
        while not self._closed:
            time.sleep(self._gossip_s)
            self._gossip_round()

    def _gossip_round(self) -> None:
        """One hub round: one exchange with every participant up."""
        for source, rh in self._gossip_targets():
            if self._closed:
                return
            merged: dict[str, float] = {}
            for other, usage in self._gossip_seen.items():
                if other == source:
                    continue
                for key, total in usage.items():
                    merged[key] = merged.get(key, 0.0) + total
            try:
                status, body = rh.post_json("/edge/gossip", {"source": "fleet-hub",
                                                             "usage": merged})
                if status != 200:
                    raise RuntimeError(f"gossip -> {status}")
                snap = json.loads(body).get("usage")
                if isinstance(snap, dict):
                    self._gossip_seen[source] = {str(k): float(v) for k, v in snap.items()}
                M_FLEET_GOSSIP.labels(status="ok").inc()
            except (OSError, RuntimeError, ValueError):
                # a down or draining participant misses rounds; its last
                # snapshot keeps reconciling into the others
                M_FLEET_GOSSIP.labels(status="error").inc()

    def _monitor_loop(self) -> None:
        while True:
            time.sleep(self._poll_s)
            due: list[dict] = []
            with self._lock:
                if self._closed:
                    return
                now = time.monotonic()
                for slot in self._slots:
                    proc = slot["proc"]
                    if proc is not None and proc.poll() is not None and not slot["rolling"]:
                        lifetime = now - slot["spawned_at"]
                        slot["proc"] = None
                        slot["probe_ok"] = False
                        fast = lifetime < self._fast_crash_s
                        slot["fast_crashes"] = slot["fast_crashes"] + 1 if fast else 0
                        if slot["fast_crashes"] >= self._breaker_threshold:
                            slot["breaker_until"] = now + self._breaker_reset_s
                            log.error("replica %d crash loop (%d fast deaths, last exit %s): "
                                      "circuit breaker open for %.0fs", slot["idx"],
                                      slot["fast_crashes"], proc.returncode,
                                      self._breaker_reset_s)
                        else:
                            delay = self._backoff.delay_for(max(0, slot["fast_crashes"] - 1))
                            slot["next_spawn"] = now + delay
                            log.warning("replica %d died (exit %s after %.1fs); respawn in "
                                        "%.2fs", slot["idx"], proc.returncode, lifetime, delay)
                    if slot["proc"] is None and not slot["rolling"]:
                        if slot["breaker_until"] is not None:
                            if now < slot["breaker_until"]:
                                continue
                            slot["breaker_until"] = None
                            log.warning("replica %d breaker half-open: one respawn", slot["idx"])
                        elif now < slot["next_spawn"]:
                            continue
                        due.append(slot)
            spawned: list[dict] = []
            for slot in due:
                # only the monitor (or a roll holding `rolling`) sets a
                # slot's proc: spawning outside the lock races no writer
                try:
                    self._spawn(slot)
                except OSError as e:
                    log.error("replica %d spawn failed (%s); backing off", slot["idx"], e)
                    with self._lock:
                        slot["fast_crashes"] += 1
                        slot["next_spawn"] = (time.monotonic()
                                              + self._backoff.delay_for(slot["fast_crashes"] - 1))
                    continue
                spawned.append(slot)
            if not spawned:
                continue
            with self._lock:
                if self._closed:
                    for slot in spawned:
                        try:
                            slot["proc"].terminate()
                            slot["proc"].wait(timeout=2)
                        except (OSError, subprocess.TimeoutExpired):
                            pass
                    return
                for slot in spawned:
                    slot["restarts"] += 1
                    self._restarts_total += 1
                    M_FLEET_RESTARTS.labels(reason="crash").inc()
                    log.info("replica %d respawned (pid %d)", slot["idx"], slot["proc"].pid)

    # --- rolling restart -------------------------------------------------------------

    def roll(self, drain_timeout_s: float | None = None) -> dict:
        """Zero-loss rolling restart, one replica at a time: drain ->
        checkpoint -> verify -> replace -> restore -> readmit; then each
        remote peer through drain -> checkpoint -> readmit.  Returns the
        per-replica report.  A failed step raises RuntimeError and leaves
        that replica undrained and serving ("the deploy did not happen",
        never "a replica was lost"); a concurrent roll is refused."""
        if not self._roll_lock.acquire(blocking=False):
            raise RuntimeError("a rolling restart is already in progress")
        try:
            return self._roll_locked(self._drain_timeout_s if drain_timeout_s is None
                                     else float(drain_timeout_s))
        finally:
            self._roll_lock.release()

    def _roll_locked(self, drain_timeout_s: float) -> dict:
        report: list[dict] = []
        t_start = time.monotonic()
        for target, roll_one in ([(s, self._roll_one) for s in self._slots]
                                 + [(p, self._roll_peer) for p in self._peers]):
            try:
                entry = roll_one(target, drain_timeout_s)
            except Exception:
                M_FLEET_ROLLS.labels(status="failed").inc()
                with self._lock:
                    self._last_roll = {"ok": False, "replicas": report,
                                       "failed_replica": target["idx"]}
                raise
            report.append(entry)
        with self._lock:
            self._rolls_total += 1
            self._last_roll = {"ok": True, "replicas": report,
                               "duration_s": round(time.monotonic() - t_start, 3)}
            out = dict(self._last_roll)
        M_FLEET_ROLLS.labels(status="ok").inc()
        return out

    def _drain(self, rh: _ReplicaHTTP, who: str, drain_timeout_s: float) -> None:
        """Drain one replica to quiescence: its plane answers new frames
        with the reroute status, in-flight frames finish, and two
        consecutive reads show no frame and no HTTP request in flight."""
        status, body = rh.post_form("/fleet/drain", state="on")
        if status != 200:
            raise RuntimeError(f"{who}: drain request failed "
                               f"({status}: {body[:200].decode(errors='replace')})")
        deadline = time.monotonic() + drain_timeout_s
        quiescent = 0
        while time.monotonic() < deadline:
            payload = json.loads(rh.post_form("/fleet/drain", state="on")[1])
            if payload.get("inflight", 1) == 0 and payload.get("http_inflight", 0) == 0:
                quiescent += 1
                if quiescent >= 2:
                    return
            else:
                quiescent = 0
            time.sleep(0.05)
        raise RuntimeError(f"{who}: did not drain to quiescence within {drain_timeout_s:.0f}s")

    def _roll_one(self, slot: dict, drain_timeout_s: float) -> dict:
        idx = slot["idx"]
        rh = _ReplicaHTTP(slot["port"], timeout=10.0, key=self._internal_token)
        entry: dict = {"replica": idx}
        # a roll right after a failover is routine: wait for a replica
        # that is still booting before giving up
        heal_deadline = time.monotonic() + self._boot_timeout_s
        while True:
            with self._lock:
                state = self.replica_state(slot)
                if state == "up":
                    slot["rolling"] = True  # the monitor hands the slot over
                    break
            if time.monotonic() >= heal_deadline:
                raise RuntimeError(f"roll aborted: replica {idx} is {state}, not up (heal "
                                   f"the fleet before rolling)")
            time.sleep(0.2)
        try:
            t0 = time.monotonic()
            try:
                was_running = bool(rh.get_json("/healthz").get("running"))
            except (OSError, RuntimeError, ValueError):
                was_running = True  # serving is the safe default
            self._drain(rh, f"replica {idx}", drain_timeout_s)
            entry["drained_in_s"] = round(time.monotonic() - t0, 3)

            name = f"fleet-roll-{int(time.time())}"
            t_ckpt = time.monotonic()
            status, body = rh.post_form("/checkpoint", name=name, timeout=60)
            if status != 200:
                raise RuntimeError(f"replica {idx}: roll checkpoint failed "
                                   f"({status}: {body[:200].decode(errors='replace')})")
            ckpt = os.path.join(slot["ckpt_dir"], name + ".npz")
            verify_manifest(ckpt)
            entry["checkpoint"] = ckpt
            log.info("replica %d: roll checkpoint %s written and verified in %.3fs", idx, ckpt,
                     time.monotonic() - t_ckpt)

            # replace on the same port and plane path: the router readmits
            # the replacement the moment its plane accepts
            proc = slot["proc"]
            slot["restore"] = ckpt
            slot["run_on_boot"] = was_running
            try:
                proc.terminate()
                proc.wait(timeout=10)
            except (OSError, subprocess.TimeoutExpired):
                try:
                    proc.kill()
                    proc.wait(timeout=5)
                except (OSError, subprocess.TimeoutExpired):
                    pass
            t_boot = time.monotonic()
            self._spawn(slot)
            with self._lock:
                slot["restarts"] += 1
                self._restarts_total += 1
            M_FLEET_RESTARTS.labels(reason="roll").inc()
            self._wait_replica_ready(slot, time.monotonic() + self._boot_timeout_s)
            entry["booted_in_s"] = round(time.monotonic() - t_boot, 3)
            entry["restored"] = True
            return entry
        except Exception:
            # leave the replica serving if it still can, and keep retrying
            # in the background: the failure may be this replica wedged
            self._undrain_async(slot)
            raise
        finally:
            with self._lock:
                slot["rolling"] = False

    def _roll_peer(self, peer: dict, drain_timeout_s: float) -> dict:
        """One remote peer through drain -> checkpoint -> undrain ->
        readmit.  The checkpoint is trusted on the peer's 200 (its own save
        path verifies the manifest on its disk), and the process is not
        replaced: the peer host's supervisor owns it.  A failed step
        undrains and raises."""
        idx = peer["idx"]
        rh = _ReplicaHTTP(peer["port"], timeout=10.0, key=self._peer_key, host=peer["host"])
        entry: dict = {"replica": idx, "remote": True, "host": peer["host"]}
        heal_deadline = time.monotonic() + self._boot_timeout_s
        while True:
            state = self.peer_state(peer)
            if state == "up":
                peer["rolling"] = True  # the peer prober skips
                break
            if time.monotonic() >= heal_deadline:
                raise RuntimeError(f"roll aborted: peer {idx} ({peer['host']}:{peer['port']}) "
                                   f"is {state}, not up (heal the fleet before rolling)")
            time.sleep(0.2)
        try:
            t0 = time.monotonic()
            self._drain(rh, f"peer {idx}", drain_timeout_s)
            entry["drained_in_s"] = round(time.monotonic() - t0, 3)
            name = f"fleet-roll-{int(time.time())}"
            t_ckpt = time.monotonic()
            status, body = rh.post_form("/checkpoint", name=name, timeout=60)
            if status != 200:
                raise RuntimeError(f"peer {idx}: roll checkpoint failed "
                                   f"({status}: {body[:200].decode(errors='replace')})")
            entry["checkpoint"] = name
            log.info("peer %d: roll checkpoint %s written in %.3fs", idx, name,
                     time.monotonic() - t_ckpt)
            entry["restored"] = False  # the peer host owns its replacement
            status, body = rh.post_form("/fleet/drain", state="off")
            if status != 200:
                raise RuntimeError(f"peer {idx}: undrain failed "
                                   f"({status}: {body[:200].decode(errors='replace')})")
            # readmit on a direct probe (the prober skips while rolling)
            t_ready = time.monotonic()
            readmit_deadline = t_ready + self._boot_timeout_s
            while True:
                try:
                    if rh.get_json("/healthz").get("ok"):
                        break
                except (OSError, RuntimeError, ValueError):
                    pass
                if time.monotonic() >= readmit_deadline:
                    raise RuntimeError(f"peer {idx}: not healthy after undrain")
                time.sleep(0.2)
            peer["probe_ok"] = True
            peer["probe_fails"] = 0
            entry["readmitted_in_s"] = round(time.monotonic() - t_ready, 3)
            return entry
        except Exception:
            try:
                rh.post_form("/fleet/drain", state="off")
            except Exception:
                pass
            raise
        finally:
            peer["rolling"] = False

    def _undrain_async(self, slot: dict) -> None:
        """Undrain in the background after a failed roll step, retrying
        until it lands, the replica is replaced (a respawn boots
        undrained), a new roll takes the slot, or the manager closes."""
        proc = slot["proc"]

        def loop() -> None:
            # the failed roll's `finally` clears `rolling` right after this
            # thread starts: wait it out before reading `rolling` as "a
            # newer roll owns the slot"
            settle = time.monotonic() + 2.0
            while slot["rolling"] and time.monotonic() < settle:
                time.sleep(0.02)
            rh = _ReplicaHTTP(slot["port"], timeout=5.0, key=self._internal_token)
            while not self._closed:
                if slot["rolling"] or slot["proc"] is not proc:
                    return
                if proc is None or proc.poll() is not None:
                    return
                try:
                    if rh.post_form("/fleet/drain", state="off")[0] == 200:
                        return
                except Exception:
                    pass  # a wedged replica: keep trying
                time.sleep(0.5)

        threading.Thread(target=loop, daemon=True,
                         name=f"misaka-fleet-undrain-{slot['idx']}").start()


# --- the fleet control server -------------------------------------------------------------

# fanned out to every up replica: lifecycle stays consistent across the
# fleet, uploads land everywhere (a failover finds the program on any
# sibling), and fault re-arming reaches every replica
_FANOUT_ROUTES = frozenset({
    "/run", "/pause", "/reset", "/load", "/programs", "/checkpoint", "/restore",
    "/debug/faults",
})

# stateful singleton routes pinned to one replica: a /profile/stop must
# land where its /profile/start did, and flamegraph reads watch one process
_STICKY_ROUTES = frozenset({"/profile/start", "/profile/stop", "/debug/flamegraph"})

_PROGRAM_RE = re.compile(r"^/programs/([^/]+)(/.*)?$")


def relabel_metrics_text(text: str, replica: int) -> tuple[list[str], list[str]]:
    """Inject `replica="<i>"` into every sample of one replica's exposition.
    Returns (sample lines, header lines); the headers (# HELP / # TYPE)
    come apart, so the aggregate emits each once across the fleet."""
    samples: list[str] = []
    headers: list[str] = []
    label = f'replica="{replica}"'
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("#"):
            headers.append(line)
            continue
        brace = line.find("{")
        if brace == -1:
            name, sep, rest = line.partition(" ")
            if not sep:
                continue  # malformed: dropped rather than mislabelled
            samples.append(f"{name}{{{label}}} {rest}")
        else:
            samples.append(f"{line[:brace + 1]}{label},{line[brace + 1:]}")
    return samples, headers


def _gather(slots: list[dict], fn) -> list:
    """fn(slot) on every slot at once, results in slot order (None where
    fn raised): one wedged replica must not stall an aggregate by its
    whole timeout per sibling."""
    out: list = [None] * len(slots)

    def run(i: int, slot: dict) -> None:
        try:
            out[i] = fn(slot)
        except Exception:
            out[i] = None

    threads = [threading.Thread(target=run, args=(i, s), daemon=True)
               for i, s in enumerate(slots)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def make_fleet_http_server(fleet: FleetManager, port: int = 0,
                           host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """The fleet control server: the frontend workers' proxy target for
    every non-compute route, and the operator's surface.

      * GET /metrics: every up replica's exposition with a `replica` label
        injected, one HELP/TYPE per family, and the parent's own series;
      * GET /healthz and /fleet: the fleet block with per-replica rows;
        `degraded` whenever a replica is not up (or the workers, a replica
        or the parent's watchdog say so); GET /status adds each up
        replica's own /status;
      * GET /debug/requests, /debug/perfetto, /debug/series (and
        /debug/dashboard over them), /usage/export: merged across the
        replicas (and peers, for the series and the export);
      * POST /fleet/roll: the rolling restart;
      * the lifecycle POSTs of _FANOUT_ROUTES go to every up replica, a
        skipped replica reported; everything else is proxied to one up
        replica (program paths by the hash ring, sticky routes to the
        lowest up index, else round robin)."""
    from misaka_tpu_torch.runtime import canary as canary_mod
    from misaka_tpu_torch.runtime import edge as edge_mod
    from misaka_tpu_torch.utils import dashboard as dash_mod
    from misaka_tpu_torch.utils import tracespan
    from misaka_tpu_torch.utils import tsdb as tsdb_mod
    from misaka_tpu_torch.utils import watchdog as watchdog_mod

    ring = HashRing(range(fleet.n))
    rr_counter = [0]
    # the parent keeps its own history (fleet gauges, restart counters,
    # which the watchdog's replica-restart rule reads) beside the merged
    tsdb_mod.ensure_started()
    watchdog_mod.ensure_started()

    # the edge's auth stage only: the operator surface rejects a bad key
    # here (a roll is not proxied), quota and admission stay with the
    # replica a request lands on (else every proxied request bills twice)
    kf_path = edge_mod.keyfile_path()
    auth_on = (os.environ.get("MISAKA_EDGE", "1") != "0"
               and os.environ.get("MISAKA_EDGE_AUTH", "1") != "0")
    control_chain = edge_mod.EdgeChain(
        keyfile=edge_mod.KeyFile(kf_path) if (kf_path and auth_on) else None,
        quota_enabled=False, admission_enabled=False,
        token_secret=edge_mod.token_secret() if auth_on else None)

    def slot_http(slot: dict, timeout: float) -> _ReplicaHTTP:
        return _ReplicaHTTP(slot["port"], timeout=timeout,
                            key=fleet._peer_key if slot.get("remote") else fleet._internal_token,
                            host=slot.get("host") or "127.0.0.1")

    def up_peers(want: str | None = None) -> list[dict]:
        return [p for p in fleet._peers
                if p["probe_ok"] and (want is None or str(p["idx"]) == want)]

    def merged_series(name: str, window_s: float, labels: dict | None = None) -> list[dict]:
        """One family across the fleet: every up replica's and peer's rows
        under replica="<i>", plus the parent's own.  A `replica` filter
        picks which to fetch and is never forwarded (their own series
        carry no such label)."""
        labels = dict(labels or {})
        want = labels.pop("replica", None)
        qs = urlencode({"name": name, "window": f"{window_s:g}s"})
        extra = "".join(f"&label={quote(f'{k}={v}')}" for k, v in labels.items())
        sources = [s for s in fleet.up_slots() if want is None or str(s["idx"]) == want]
        sources += up_peers(want)
        fetched = _gather(sources, lambda s: slot_http(s, 5.0).get_json(
            f"/debug/series?{qs}{extra}"))
        rows: list[dict] = []
        for src, payload in zip(sources, fetched):
            if payload is None:
                continue
            for row in payload.get("series", ()):
                row["labels"] = {**row.get("labels", {}), "replica": str(src["idx"])}
                rows.append(row)
        if want is None:
            rows.extend(tsdb_mod.query(name, labels, window_s))
        return rows

    class FleetHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log.debug(fmt, *args)

        def _reply(self, code: int, data: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _text(self, code: int, body: str) -> None:
            self._reply(code, body.encode(), "text/plain; charset=utf-8")

        def _json(self, obj, code: int = 200) -> None:
            self._reply(code, (json.dumps(obj) + "\n").encode(), "application/json")

        def _read_body(self) -> bytes:
            length = int(self.headers.get("Content-Length") or 0)
            return self.rfile.read(length) if length else b""

        def _query(self) -> dict:
            return parse_qs(self.path.split("?", 1)[1] if "?" in self.path else "")

        def _edge_check(self, path: str, method: str) -> bool:
            """The auth stage; True = admitted (after the body was read)."""
            if not control_chain.armed:
                return True
            m = _PROGRAM_RE.match(path)
            program = (m.group(1).partition("@")[0] if m
                       else self.headers.get("X-Misaka-Program") or None)
            d = control_chain.check(path, method, key=edge_mod.key_from_headers(self.headers),
                                    program=program, values=0)
            if d.reject is None:
                return True
            data = d.reject.message.encode()
            self.send_response(d.reject.status)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            for k, v in d.reject.headers():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)
            return False

        def _pick_slot(self, path: str) -> dict | None:
            up = fleet.up_slots()
            if not up:
                return None
            m = _PROGRAM_RE.match(path)
            if m:
                by_idx = {s["idx"]: s for s in up}
                for idx in ring.lookup(m.group(1).partition("@")[0]):
                    if idx in by_idx:
                        return by_idx[idx]
            if path in _STICKY_ROUTES:
                return min(up, key=lambda s: s["idx"])
            rr_counter[0] += 1
            return up[rr_counter[0] % len(up)]

        def _proxy(self, method: str, body: bytes | None = None) -> None:
            slot = self._pick_slot(self.path.split("?", 1)[0])
            if slot is None:
                self._text(503, "fleet down: no healthy engine replica")
                return
            headers = {h: self.headers.get(h) for h in (
                "Content-Type", "X-Misaka-Program", "X-Misaka-Trace", "X-Misaka-Key",
                "Authorization") if self.headers.get(h)}
            try:
                status, payload, resp_headers = _ReplicaHTTP(slot["port"], timeout=60.0).request(
                    method, self.path, body, headers)
            except (OSError, http.client.HTTPException) as e:
                # a replica dying mid-response raises an HTTPException
                self._text(502, f"replica {slot['idx']} unreachable: {e}")
                return
            self.send_response(status)
            self.send_header("Content-Type",
                             resp_headers.get("Content-Type", "text/plain; charset=utf-8"))
            self.send_header("Content-Length", str(len(payload)))
            self.send_header("X-Misaka-Replica", str(slot["idx"]))
            for h in ("X-Misaka-Trace", "Server-Timing", "Deprecation", "Link", "Retry-After",
                      "WWW-Authenticate"):
                v = resp_headers.get(h)
                if v:
                    self.send_header(h, v)
            self.end_headers()
            self.wfile.write(payload)

        def _fanout(self, body: bytes) -> None:
            """One lifecycle POST to every up replica: a uniform outcome
            across the whole fleet answers as one replica did; anything
            else, a skipped replica included, is reported per replica (a
            /pause that missed a mid-roll replica would leave it running
            behind a 200)."""
            states = fleet.slot_states()
            if not any(st == "up" for _, st in states):
                self._text(503, "fleet down: no healthy engine replica")
                return
            headers = {h: self.headers.get(h) for h in (
                "Content-Type", "X-Misaka-Key", "Authorization") if self.headers.get(h)}

            def apply(slot: dict) -> tuple[int, bytes]:
                try:
                    status, payload, _ = _ReplicaHTTP(slot["port"], timeout=60.0).request(
                        "POST", self.path, body, headers)
                except (OSError, http.client.HTTPException) as e:
                    status, payload = 502, str(e).encode()
                return status, payload

            up = [slot for slot, st in states if st == "up"]
            applied = dict(zip((s["idx"] for s in up), _gather(up, apply)))
            results = []
            ok = True
            skipped = 0
            for slot, st in states:
                if st != "up":
                    results.append({"replica": slot["idx"], "status": 503,
                                    "body": f"replica {st}; lifecycle change not applied",
                                    "skipped": True})
                    ok = False
                    skipped += 1
                    continue
                status, payload = applied.get(slot["idx"]) or (502, b"fan-out request failed")
                results.append({"replica": slot["idx"], "status": status,
                                "body": payload[:500].decode(errors="replace")})
                ok = ok and 200 <= status < 300
            if not skipped and (len(results) == 1 or all(
                    r["body"] == results[0]["body"] and r["status"] == results[0]["status"]
                    for r in results)):
                # uniform across the whole fleet: exactly what one replica
                # said, success or not (a fleet-wide 400 stays a 400)
                self._text(results[0]["status"], results[0]["body"])
                return
            self._json({"ok": ok, "replicas": results}, code=200 if ok else 502)

        def _healthz(self) -> None:
            st = fleet.state()
            up_rows = [r for r in st["replicas"] if r["state"] == "up"]
            payload = {
                "ok": st["up"] > 0,
                "engine": "fleet",
                # the network's run state, not process liveness: a fully
                # paused fleet must not read as serving
                "running": bool(up_rows) and all(r.get("running") for r in up_rows),
                "fleet": st,
                "degraded": st["degraded"],
            }
            sup = getattr(self.server, "misaka_supervisor", None)
            if sup is not None:
                fs = sup.state()
                payload["frontends"] = fs
                payload["degraded"] = payload["degraded"] or fs["degraded"]
            wd_state = watchdog_mod.overall_state()
            if wd_state is not None:
                payload["watchdog"] = wd_state
                payload["degraded"] = payload["degraded"] or wd_state == "page"
            cst = canary_mod.state_payload()
            if cst is not None:
                payload["canary"] = {
                    "failing_tier": cst["failing_tier"],
                    "consecutive_full_failures": cst["consecutive_full_failures"],
                    "tiers": {t: v.get("ok") for t, v in cst["tiers"].items()},
                }
            self._json(payload)

        def _status(self) -> None:
            payload = {"engine": "fleet", "fleet": fleet.state(), "replicas": {}}
            sup = getattr(self.server, "misaka_supervisor", None)
            if sup is not None:
                payload["frontends"] = sup.state()

            def fetch(slot: dict):
                try:
                    return slot_http(slot, 5.0).get_json("/status")
                except (OSError, RuntimeError, ValueError) as e:
                    return {"error": str(e)}

            slots = fleet.up_slots()
            for slot, row in zip(slots, _gather(slots, fetch)):
                payload["replicas"][str(slot["idx"])] = row if row is not None else {
                    "error": "fetch"}
            self._json(payload)

        def _metrics(self) -> None:
            sample_lines: list[str] = []
            header_seen: dict[str, str] = {}
            slots = fleet.up_slots()
            fetched = _gather(slots, lambda s: _ReplicaHTTP(s["port"], timeout=5.0).request(
                "GET", "/metrics"))
            for slot, resp in zip(slots, fetched):
                if resp is None or resp[0] != 200:
                    continue
                samples, headers = relabel_metrics_text(resp[1].decode(errors="replace"),
                                                        slot["idx"])
                sample_lines.extend(samples)
                for h in headers:
                    header_seen.setdefault(h, h)
            # the parent's own series ride unlabelled; their HELP/TYPE
            # lines dedupe against the replicas' (a second TYPE line for
            # one family is invalid exposition)
            for line in metrics.render().splitlines():
                if line.startswith("#"):
                    header_seen.setdefault(line, line)
                elif line.strip():
                    sample_lines.append(line)
            text = "\n".join([*header_seen.values(), *sample_lines]) + "\n"
            self._reply(200, text.encode(), metrics.CONTENT_TYPE)

        def _debug_requests(self) -> None:
            merged = {"recent": [], "slowest": [], "replicas": {}}
            qs = "?" + self.path.split("?", 1)[1] if "?" in self.path else ""
            slots = fleet.up_slots()
            fetched = _gather(slots, lambda s: slot_http(s, 5.0).get_json("/debug/requests" + qs))
            for slot, payload in zip(slots, fetched):
                if payload is None:
                    continue
                for key in ("recent", "slowest"):
                    for row in payload.get(key, ()):
                        row["replica"] = slot["idx"]
                        merged[key].append(row)
                merged["replicas"][str(slot["idx"])] = {"enabled": payload.get("enabled")}
            merged["slowest"].sort(key=lambda r: -(r.get("duration_ms") or 0))
            self._json(merged)

        def _perfetto(self) -> None:
            events = []
            slots = fleet.up_slots()
            fetched = _gather(slots, lambda s: slot_http(s, 10.0).get_json("/debug/perfetto"))
            for slot, payload in zip(slots, fetched):
                if payload is None:
                    continue
                base = (slot["idx"] + 1) * 100  # which replica served each span
                for ev in payload.get("traceEvents", ()):
                    if "pid" in ev:
                        ev["pid"] = base + int(ev["pid"])
                    if ev.get("ph") == "M" and ev.get("name") == "process_name":
                        ev["args"]["name"] = (f"replica {slot['idx']} · "
                                              f"{ev['args'].get('name', '')}")
                    events.append(ev)
            self._json({"traceEvents": events, "displayTimeUnit": "ms"})

        def _alerts(self) -> None:
            # one replica's SLO and watchdog view (sticky) and the parent's
            # own watchdog (replica restarts fire here)
            slot = self._pick_slot("/debug/alerts")
            payload = {}
            if slot is not None:
                try:
                    payload = slot_http(slot, 5.0).get_json("/debug/alerts")
                    payload["replica"] = slot["idx"]
                except (OSError, RuntimeError, ValueError):
                    payload = {}
            wd = watchdog_mod.debug_payload()
            for rule in wd.get("rules", ()):
                if rule.get("state") != "ok":
                    rule["exemplars"] = tracespan.slowest_exemplars()
            payload["fleet_watchdog"] = wd
            self._json(payload)

        def _series(self) -> None:
            try:
                name, labels, window_s = tsdb_mod.parse_query(self._query())
            except tsdb_mod.TSDBError as e:
                self._text(400, str(e))
                return
            if name is not None:
                self._json({"name": name, "window_s": window_s,
                            "series": merged_series(name, window_s, labels)})
                return
            merged = tsdb_mod.index_payload()
            merged["replicas"] = {}
            slots = fleet.up_slots()
            for slot, payload in zip(slots, _gather(
                    slots, lambda s: slot_http(s, 5.0).get_json("/debug/series"))):
                if payload is None:
                    continue
                for n, c in payload.get("names", {}).items():
                    merged["names"][n] = merged["names"].get(n, 0) + c
                merged["replicas"][str(slot["idx"])] = {
                    "series_count": payload.get("series_count", 0),
                    "dropped_series": payload.get("dropped_series", 0)}
            self._json(merged)

        def _usage_export(self) -> None:
            # every up replica's and peer's signed lines verbatim (the hub
            # never re-signs), each source under an unsigned envelope, and
            # the gossip hub's fleet-wide counters last
            since = (self._query().get("since") or ["0"])[0]
            sources = fleet.up_slots() + up_peers()
            fetched = _gather(sources, lambda s: slot_http(s, 10.0).request(
                "GET", f"/usage/export?since={since}"))
            out: list[str] = []
            for src, got in zip(sources, fetched):
                good = bool(got and got[0] == 200)
                out.append(json.dumps({"kind": "source", "replica": str(src["idx"]),
                                       "remote": bool(src.get("remote")), "ok": good},
                                      separators=(",", ":")))
                if good:
                    out.extend(ln for ln in got[1].decode(errors="replace").splitlines()
                               if ln.strip())
            out.append(json.dumps({"kind": "fleet_gossip",
                                   "sources": {k: dict(v) for k, v in fleet._gossip_seen.items()}},
                                  separators=(",", ":")))
            self._reply(200, ("\n".join(out) + "\n").encode(), "application/x-ndjson")

        def _dashboard(self) -> None:
            q = {k: v[0] for k, v in self._query().items()}
            try:
                window_s = tsdb_mod.parse_window(q.get("window", "1h"))
            except tsdb_mod.TSDBError as e:
                self._text(400, str(e))
                return
            extra = {"watchdog": watchdog_mod.debug_payload()}
            cst = canary_mod.state_payload()
            if cst is not None:
                extra["canary"] = cst
            html = dash_mod.render_html(merged_series, window_s, extra)
            self._reply(200, html.encode(), "text/html; charset=utf-8")

        def do_GET(self):
            try:
                path = self.path.split("?", 1)[0]
                if not self._edge_check(path, "GET"):
                    return
                route = {
                    "/healthz": self._healthz,
                    "/fleet": lambda: self._json(fleet.state()),
                    "/fleet/state": lambda: self._json(fleet.state()),
                    "/status": self._status,
                    "/metrics": self._metrics,
                    "/debug/requests": self._debug_requests,
                    "/debug/perfetto": self._perfetto,
                    "/debug/alerts": self._alerts,
                    "/debug/series": self._series,
                    "/usage/export": self._usage_export,
                    "/debug/dashboard": self._dashboard,
                }.get(path)
                if route is not None:
                    route()
                else:
                    self._proxy("GET")
            except Exception as e:  # never kill the server
                log.exception("fleet handler error")
                try:
                    self._text(500, f"internal error: {e}")
                except Exception:
                    pass

        def do_POST(self):
            try:
                path = self.path.split("?", 1)[0]
                body = self._read_body()
                if not self._edge_check(path, "POST"):
                    return
                if path == "/fleet/drain":
                    # proxied, it would drain a round-robin replica the
                    # caller could never target again to undrain
                    self._text(400, "/fleet/drain is replica-internal (the roll protocol "
                                    "drives it); use POST /fleet/roll")
                    return
                if path == "/fleet/roll":
                    try:
                        report = fleet.roll()
                    except RuntimeError as e:
                        code = 409 if "already in progress" in str(e) else 500
                        self._text(code, f"rolling restart failed: {e}")
                        return
                    self._json(report)
                    return
                if path in _FANOUT_ROUTES:
                    self._fanout(body)
                    return
                self._proxy("POST", body)
            except Exception as e:
                log.exception("fleet handler error")
                try:
                    self._text(500, f"internal error: {e}")
                except Exception:
                    pass

    return ThreadingHTTPServer((host, port), FleetHandler)


# --- app entrypoint -----------------------------------------------------------------------


def prebuild_kernel(environ=os.environ) -> None:
    """Build the fused kernel once, in the parent, before the replicas
    boot: each would otherwise build it at its first launch, N nvcc runs
    racing to one cache entry (safe, csrc/build.py renames atomically,
    but N times the work).  Nothing to build for replicas on the CPU or
    the plain loop; a build that fails raises (the replicas would fail
    the same way)."""
    if (environ.get("MISAKA_DEVICE") or "cuda").startswith("cpu"):
        return
    if environ.get("MISAKA_ENGINE", "auto") in ("scan", "native"):
        return  # the plain loop and the host tier launch no kernel
    from misaka_tpu_torch.core import fused
    from misaka_tpu_torch.csrc import build

    t0 = time.monotonic()
    build.build(fused.KERNEL)
    log.info("kernel %s built for the replicas in %.1fs", fused.KERNEL, time.monotonic() - t0)


def run_fleet(n: int, environ=None) -> None:
    """The MISAKA_FLEET=N entrypoint (runtime/app.py): N supervised engine
    replicas, the frontend workers routing across them and the control
    server; serve until signalled.  A replica that cannot boot ends the
    parent with a non-zero status naming its exit code."""
    environ = dict(os.environ if environ is None else environ)
    from misaka_tpu_torch.runtime import canary as canary_mod
    from misaka_tpu_torch.runtime import frontends
    from misaka_tpu_torch.runtime.lifecycle import install_guards
    from misaka_tpu_torch.utils import buildinfo

    buildinfo.install_metric()
    public_port = int(environ.get("MISAKA_PORT", "8000"))
    fleet_dir = (environ.get("MISAKA_FLEET_DIR") or environ.get("MISAKA_CHECKPOINT_DIR")
                 or f"/tmp/misaka-fleet-{os.getpid()}")
    prebuild_kernel(environ)
    fleet = FleetManager(
        n, fleet_dir, base_env=environ,
        probe_s=float(environ.get("MISAKA_FLEET_PROBE_S", "0.5") or 0.5),
        drain_timeout_s=float(environ.get("MISAKA_FLEET_DRAIN_S", "30") or 30))
    install_guards(fleet.close, environ)
    log.info("booting %d engine replicas under %s", fleet.n, fleet_dir)
    try:
        fleet.start(wait_ready=True)
    except RuntimeError as e:
        fleet.close()
        raise SystemExit(f"misaka_tpu_torch fleet: {e}") from None

    server = make_fleet_http_server(fleet, port=0)
    control_port = server.server_address[1]
    # the frontend tier is the public surface: on by default in a fleet
    workers = int(environ.get("MISAKA_HTTP_WORKERS", "") or max(2, fleet.n))
    # one plane connection per (worker, replica) for N > 1: the N replicas
    # already pipeline, and a second connection splits each worker's
    # backlog into smaller frames
    plane_conns = int(environ.get("MISAKA_PLANE_CONNS", "") or (1 if fleet.n > 1 else 2))
    supervisor = frontends.FrontendSupervisor(
        workers, public_port, f"http://127.0.0.1:{control_port}", ",".join(fleet.plane_paths()),
        plane_conns=plane_conns, fleet=True)  # a 1-replica fleet still needs the grace
    server.misaka_supervisor = supervisor
    log.info("fleet up: %d replicas, control on 127.0.0.1:%d, %d frontend workers on :%d",
             fleet.n, control_port, workers, public_port)
    # the fleet-level canary probes the public port with the internal token
    scheme = "https" if environ.get("MISAKA_TLS_CERT") else "http"
    canary_mod.ensure_started(f"{scheme}://127.0.0.1:{public_port}",
                              token=fleet._internal_token,
                              full_stack=bool(environ.get("MISAKA_PROGRAMS_DIR")),
                              environ=environ)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        supervisor.close()
        fleet.close()
