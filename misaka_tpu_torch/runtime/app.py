"""Process entrypoint: serve one network over HTTP, or one node over gRPC.

    python -m misaka_tpu_torch.runtime.app

The port's twin of misaka_tpu/runtime/app.py.  Deployment modes (NODE_TYPE
dispatch, mirroring cmd/app.go:17-39):

  * NODE_TYPE unset / "master" (default): the fused engine, the whole
    network in one kernel launch per chunk on the card.  The product.
  * MISAKA_MODE=distributed + NODE_TYPE=master: the reference's distributed
    control plane (runtime/nodes.py::MasterNodeProcess): the HTTP surface,
    gRPC command fan-out and the Master data-plane service, for a network
    of per-process nodes.  NODE_INFO is required; MISAKA_AUTORUN=1 runs the
    network at boot (a failure, e.g. peers not up yet, is logged: /run
    retries).
  * NODE_TYPE=program: one TIS interpreter process (MASTER_URI, default
    "last_order", and PROGRAM, app.go:20-25; a program that does not parse
    is logged and the node keeps NOP), serving the Program gRPC service.
  * NODE_TYPE=stack: one LIFO storage process serving the Stack service.

The per-process nodes honour CERT_FILE/KEY_FILE for TLS (app.go:15-16;
plain TCP when unset), NODE_ADDRS ({name: "host:port"}) and
MISAKA_GRPC_PORT (default 8001, the reference's fixed port) for
addressing, and the lifecycle guards (MISAKA_TTL_S, MISAKA_ORPHAN_OK).
They need grpcio and protobuf, imported only in those branches: without
them such a boot exits naming the missing package, and the fused boot
never imports either.  None of them touches the card.

Environment of the fused engine (and, where it applies, of the
distributed master's HTTP surface):

  NODE_INFO          {"name": {"type": "program"|"stack"}, ...} (app.go:30-35)
  MISAKA_PROGRAMS    {"name": "<TIS source>", ...} per program node
  MISAKA_PORT        HTTP port (default 8000)
  MISAKA_BATCH       run N independent instances in lockstep and serve
                     concurrent requests across them (default, or 0: one
                     instance, every /compute strictly FIFO)
  MISAKA_CHUNK_STEPS ticks per device-loop chunk (default 128)
  MISAKA_ENGINE      auto (default: the fused kernel on the card; on the CPU
                     the host C++ tier, as the reference's auto serves it
                     with no TPU attached, unless MISAKA_NATIVE_AUTO=0, a
                     trace, a mesh or a batch over
                     MISAKA_NATIVE_AUTO_MAX_BATCH (default 4096) keeps the
                     plain version) | scan (the plain version) | fused
                     (require the kernel: batched and untraced) | native
                     (the host C++ interpreter tier, core/native_serve.py,
                     on the host whatever MISAKA_DEVICE says: one instance,
                     or MISAKA_BATCH replicas on a thread pool);
                     fused-interpret refuses to start, gather needs model
                     parallel
  MISAKA_NATIVE_THREADS  the native pool's OS threads (default: the cores)
  MISAKA_SIMD        the native ladder's SIMD rung: auto/unset (AVX2 where
                     the CPU has it, else generic), generic, 0 (scalar);
                     /status `native` shows the live rung
  MISAKA_JIT         "0" disables the copy-and-patch JIT rung (core/jit.py)
  MISAKA_SPECIALIZE  "0" disables per-program specialized builds
                     (core/specialize.py) and the spec cache dir the boot
                     engine is given (MISAKA_SPEC_CACHE, default
                     build/misaka_tpu_torch/spec-cache; a registry's
                     engines cache under <MISAKA_PROGRAMS_DIR>/<name>/native);
                     MISAKA_SPEC_CACHE_MAX_MB / _MAX_ENTRIES bound it,
                     MISAKA_SPEC_SWITCH_MAX caps the switch-threaded tick
  MISAKA_NATIVE_RESIDENT  "0" serves native pools statelessly (import and
                     export every call) instead of holding the state in C++
  MISAKA_POOL_SPIN_US  the pool dispenser's spin budget before it parks
  MISAKA_NATIVE_TRACE  "0" disables the native flight recorder (GET
                     /debug/native_trace); MISAKA_NATIVE_TRACE_RING records
                     per thread ring
  MISAKA_TRACE_CAP   N > 0 records every tick of one instance in an N-tick
                     ring: GET /debug/isa_trace?last=N (the plain version
                     serves, recording; 409 on that route without it)
  MISAKA_TRACE_INSTANCE  which instance a batched traced server records
                     (default 0; out of range refuses to start)
  MISAKA_STACK_CAP / MISAKA_IN_CAP / MISAKA_OUT_CAP   stack and ring depths
  MISAKA_AUTORUN     "1" starts the network at boot
  MISAKA_DEVICE      cuda (default) | cpu -- with no card and no
                     MISAKA_DEVICE=cpu the app refuses to start
  MISAKA_SERVE_BATCH "0" turns the serve scheduler off: /compute and the
                     spread lanes then stripe per request (compute_spread)
  MISAKA_BATCH_WINDOW_US / MISAKA_BATCH_MAX / MISAKA_BATCH_PASSES /
  MISAKA_LANE_SMALL  the serve scheduler's knobs (runtime/master.py)
  MISAKA_STACK_AUTOGROW  "0" leaves a full stack parked; by default its
                     capacity doubles when a request stalls on it
  MISAKA_CHECKPOINT_DIR  enables POST /checkpoint and /restore, storing
                     named .npz snapshots (the JAX package's format) here
  MISAKA_FUSED_ELIDE_HI  "1" serves through the kernel's elided variant
                     (lanes with no 64-bit reader skip the hi plane)
  MISAKA_DATA_PARALLEL   shard the batch over D devices, one kernel launch
                     per shard per chunk (MISAKA_BATCH must divide by D)
  MISAKA_MODEL_PARALLEL  shard each instance's program lanes over M devices
                     (the lane count must divide by M), agreeing every tick
                     through in-process collectives: the routed engine
                     (MISAKA_ENGINE=gather: the first-generation one).
                     The mesh is D x M devices: the first D*M cards, and
                     the app refuses to start when the host has fewer; with
                     MISAKA_DEVICE=cpu, D*M shards on the CPU.  /status
                     then reports "mesh"
  MISAKA_COORDINATOR host:port of a torch.distributed (gloo) process group,
                     with MISAKA_NUM_PROCESSES and MISAKA_PROCESS_ID: the
                     process joins it before anything touches the card.
                     Each process then serves its own network; a mesh
                     across processes (MISAKA_DATA_PARALLEL or
                     MISAKA_MODEL_PARALLEL > 1 in a group of more than one)
                     is not ported (ROADMAP A.7b) and refuses to start, and
                     so does `auto` (JAX's Cloud TPU autodetection)
  MISAKA_TOPOLOGY    a declarative topology JSON file (Topology.from_json),
                     in place of NODE_INFO/MISAKA_PROGRAMS, or a reference
                     docker-compose .yml (runtime/compose.py; without
                     PyYAML it refuses to start)
  MISAKA_TLS_CERT / MISAKA_TLS_KEY  serve HTTPS (both or neither)
  MISAKA_AUTOCKPT    N seconds: snapshot the live state into
                     MISAKA_CHECKPOINT_DIR (required) as auto-<seq>.npz and
                     restore the newest valid one at boot;
                     MISAKA_AUTOCKPT_KEEP snapshots kept (default 4)
  MISAKA_PROFILE_DIR enables POST /profile/start|stop (torch.profiler
                     Chrome traces under <dir>/<name>/)
  MISAKA_LOG_JSON    "1": one JSON object per log line, with the trace ID
  MISAKA_SLOW_REQ_MS log a warning for each request slower than this
  MISAKA_FAST_HTTP   "0" keeps the stdlib request parser
  MISAKA_TRACE_REQUESTS / _SAMPLE / _RING / _SLOWEST  the request tracer
                     (utils/tracespan.py): kill switch, sampling, recorder
  MISAKA_PIDFILE     pidfile path ("0"/"off": none; default under the
                     temp dir), removed at exit
  MISAKA_TTL_S / MISAKA_ORPHAN_OK  lifecycle guards (runtime/lifecycle.py)
  MISAKA_HTTP_WORKERS  N > 0: N supervised frontend worker processes
                     (runtime/frontends.py) share MISAKA_PORT over
                     SO_REUSEPORT and feed this engine over a compute plane
                     at MISAKA_PLANE_SOCKET (default <tmp>/misaka-plane-
                     <pid>.sock; host:port for TCP); the engine's own HTTP
                     server moves to a free port as their proxy target, and
                     /healthz and /status carry `frontends`.
                     MISAKA_PLANE_CONNS connections per worker (default 2)
  MISAKA_NATIVE_EDGE with MISAKA_HTTP_WORKERS > 0: 1 (default) puts the C++
                     epoll edge (runtime/frontends.py
                     NativeFrontendSupervisor) on the public port: HTTP
                     keep-alive and the MSK1 binary wire end in C++, the
                     hot compute routes go straight over the plane, the
                     rest is proxied to the workers, which move to a
                     loopback port; /healthz carries `native_edge`.  0, an
                     armed MISAKA_TLS_CERT (the native tier does not
                     terminate TLS), or a failed build or start leaves the
                     workers on the public port, with one logged line.
                     MISAKA_NATIVE_EDGE_THREADS (default min(8, cores/2),
                     at least 2), MISAKA_NATIVE_EDGE_MAX_CONNS (default
                     4096), MISAKA_PLANE_TIMEOUT_S (30) and MISAKA_MAX_BODY
  MISAKA_PLANE_SERVE "1" serves the compute plane beside the engine's own
                     listener when there are no workers
  MISAKA_PLANE_WINDOW_US / _PIPELINE / _SHM / _SECRET[_FILE] / _DEPTH_MAX
                     the plane's knobs (runtime/frontends.py, runtime/edge.py)
  MISAKA_PLANE_TLS_CERT / _KEY / _CA  mutual TLS on TCP compute planes
                     (all three or none; unix planes ignore them), hot
                     reloaded on a change of the files
  MISAKA_FLEET       N >= 1 makes this process the fleet parent
                     (runtime/fleet.py): N engine replicas, each this app
                     in a subprocess on a loopback port and a plane socket
                     under MISAKA_FLEET_DIR (default MISAKA_CHECKPOINT_DIR,
                     else <tmp>/misaka-fleet-<pid>), the frontend workers
                     routing across them (MISAKA_HTTP_WORKERS, default
                     max(2, N); MISAKA_PLANE_CONNS default 1 for N > 1) and
                     the control server (aggregated /metrics, /status,
                     /healthz, POST /fleet/roll).  MISAKA_FLEET_PROBE_S
                     (0.5), _DRAIN_S (30), _DOWN_GRACE_S (5: the router's
                     wait before the typed 503; a zero-loss roll needs
                     N >= 2), MISAKA_FLEET_PEERS (host:port[:planeport],...
                     remote replicas probed, routed and rolled) with
                     MISAKA_FLEET_PEER_KEY (their admin key),
                     MISAKA_GOSSIP_S (usage gossip cadence, 0.5; 0 off).
                     The parent sets MISAKA_FLEET_REPLICA (the replica's
                     index) and MISAKA_FLEET_RESTORE (a roll replacement's
                     checkpoint, restored before any traffic in place of
                     the auto-restore) for its replicas; it also sets
                     MISAKA_NATIVE_THREADS (the host's cores split between
                     the replicas' native pools) unless it is set
  MISAKA_API_KEYS    the API key file: arms auth on every route but
                     /healthz and /metrics (runtime/edge.py); the app then
                     mints MISAKA_EDGE_INTERNAL_TOKEN unless it is set
  MISAKA_QUOTA       per-tenant quota default, "rps<100,vps<500000,cpu<0.5"
                     (MISAKA_QUOTA_BURST_S burst window, default 2 s)
  MISAKA_ADMISSION_HIGH  the admission watermark in waiting values
  MISAKA_TOKEN_SECRET[_FILE]  arms signed tenant tokens (POST /edge/token)
  MISAKA_EDGE / _AUTH / _QUOTA / _ADMISSION  "0" disarms the whole edge or
                     one stage
  MISAKA_PROGRAMS_DIR  arms the program registry (runtime/registry.py) over
                     this store: the boot network is seeded as the pinned
                     program MISAKA_DEFAULT_PROGRAM (default "default"),
                     uploads at POST /programs serve from their own engines
                     on the boot batch, caps, MISAKA_ENGINE and device, at
                     most MISAKA_REGISTRY_MAX_ACTIVE (default 4) active, the
                     coldest evicted through a checkpoint; a hot swap drains
                     the old engine for up to MISAKA_SWAP_DRAIN_S.  A key
                     file at <dir>/api_keys.json arms auth as MISAKA_API_KEYS
  MISAKA_CANARY      "0" turns the synthetic canary off (runtime/canary.py:
                     on by default, probing the public port every
                     MISAKA_CANARY_INTERVAL_S, default 5 s; /healthz
                     `canary`)
  MISAKA_USAGE       "0" turns the per-program usage ledger off
                     (runtime/usage.py: GET /debug/usage, /usage/export
                     signed with MISAKA_USAGE_SECRET, the `cpu` quota
                     stage of MISAKA_QUOTA; MISAKA_USAGE_LABEL_MAX caps
                     its program labels, and the SLO engine's)
  MISAKA_SLO         default objectives ("p99<25ms,err<0.1%") of the SLO
                     burn-rate engine (utils/slo.py: GET /debug/alerts,
                     /healthz `slo`); MISAKA_SLO_WINDOWS, _MIN_EVENTS
  MISAKA_FAULTS      armed chaos points (utils/faults.py; re-armed at POST
                     /debug/faults)
  MISAKA_CAPTURE     "0" kills the wire recorder (runtime/capture.py: POST
                     /captures/start|stop|export, GET /debug/captures);
                     MISAKA_CAPTURE_MB, _SAMPLE, _DIR,
                     MISAKA_REPLAY_VERIFY_MAX
  MISAKA_SAMPLER     "0" turns the always-on stack sampler off
                     (utils/sampler.py: GET /debug/flamegraph);
                     MISAKA_SAMPLER_HZ, _MAX_STACKS, _DECAY_S, _BUDGET
  MISAKA_TSDB        "0" turns the embedded TSDB off (utils/tsdb.py: GET
                     /debug/series, /debug/dashboard, history in
                     checkpoints); MISAKA_TSDB_INTERVAL_S (5), _MAX_SERIES,
                     _BUDGET
  MISAKA_TSDB_DIR    arms the durable tier: the TSDB's fine and long tiers
                     (MISAKA_TSDB_DISK_MB, _SEG_KB, _LONG_S, _LONG_SLOTS),
                     reloaded at boot; the usage ledger's spool under
                     <dir>/usage (MISAKA_USAGE_SPOOL=0 opts out;
                     MISAKA_USAGE_DISK_MB, _SEG_KB, _FLUSH_S); the
                     always-on capture spool under <dir>/capture
                     (MISAKA_CAPTURE_SPOOL=0 opts out;
                     MISAKA_CAPTURE_DISK_MB, _SEG_KB, _SEG_S; POST
                     /captures/rotate), whose newest rotated segments a
                     ?verify=replay gate also replays
                     (MISAKA_REPLAY_HISTORY, default 2)
  MISAKA_WATCHDOG    the regression watchdog's rules (utils/watchdog.py;
                     "0" off, unset the defaults): /debug/alerts
                     `watchdog`, a paging rule raises /healthz `degraded`;
                     MISAKA_WATCHDOG_RECENT_S, _MIN_POINTS

Refused at boot, naming the ROADMAP item that ports it (the reference
serves it; the port would otherwise ignore it without a word): a mesh
across the processes of a MISAKA_COORDINATOR group (A.7b).
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import sys
import tempfile

if __name__ == "__main__":
    # provisional handlers for the boot window, before the torch imports
    # (exec path only: a library import must not touch the signal table)
    from misaka_tpu_torch.runtime.lifecycle import arm_boot_handlers

    arm_boot_handlers()

from misaka_tpu_torch import PPID_AT_IMPORT as _PPID_AT_START
from misaka_tpu_torch.parallel import multihost
from misaka_tpu_torch.runtime import canary, edge, frontends
from misaka_tpu_torch.runtime.lifecycle import install_guards
from misaka_tpu_torch.runtime.master import AutoCheckpointer, MasterNode, make_http_server
from misaka_tpu_torch.runtime.registry import ProgramRegistry
from misaka_tpu_torch.runtime.topology import Topology

log = logging.getLogger("misaka_tpu_torch.app")


class BootRefusal(SystemExit):
    """What the env asks for is not ported: exit status 2, the reason on
    stderr (and as the exception's text)."""

    def __init__(self, msg: str):
        super().__init__(2)
        self.msg = msg

    def __str__(self) -> str:
        return self.msg


def _refuse(msg: str):
    print(f"misaka_tpu_torch.app: {msg}", file=sys.stderr, flush=True)
    raise BootRefusal(msg)


def caps_from_env(environ=os.environ) -> dict:
    """The capacities MISAKA_STACK_CAP / MISAKA_IN_CAP / MISAKA_OUT_CAP set."""
    caps = {}
    for env_name, field in (
        ("MISAKA_STACK_CAP", "stack_cap"),
        ("MISAKA_IN_CAP", "in_cap"),
        ("MISAKA_OUT_CAP", "out_cap"),
    ):
        v = environ.get(env_name)
        if v:
            caps[field] = int(v)
    return caps


def build_topology_from_env(environ=os.environ) -> Topology:
    caps = caps_from_env(environ)
    path = environ.get("MISAKA_TOPOLOGY")
    if path:
        if path.endswith((".yml", ".yaml")):
            # a reference docker-compose deployment (runtime/compose.py)
            from misaka_tpu_torch.runtime.compose import load_compose

            try:
                return load_compose(path, **caps)
            except ImportError:
                _refuse(f"MISAKA_TOPOLOGY={path}: compose .yml topologies need PyYAML, "
                        "which this host lacks; give a topology .json")
        with open(path) as f:
            return Topology.from_json(f.read(), **caps)
    node_info = environ.get("NODE_INFO")
    if not node_info:
        raise SystemExit("set NODE_INFO (reference JSON shape) or MISAKA_TOPOLOGY (file path)")
    programs = json.loads(environ.get("MISAKA_PROGRAMS", "{}"))
    return Topology.from_node_info_json(node_info, programs, **caps)


# the modules the per-process distributed mode imports, by their packages
_GRPC_PACKAGES = (("grpc", "grpcio"), ("google.protobuf", "protobuf"))


def distributed_role(environ=os.environ) -> str | None:
    """The per-process role the env asks for: "program", "stack", "master"
    (MISAKA_MODE=distributed), or None for the fused engine.  An unknown
    NODE_TYPE exits with the reference's message."""
    node_type = environ.get("NODE_TYPE", "master")
    if node_type in ("program", "stack"):
        return node_type
    if node_type != "master":
        raise SystemExit(f"'{node_type}' not a valid node type")
    return "master" if environ.get("MISAKA_MODE") == "distributed" else None


def require_grpc(what: str) -> None:
    """Refuse the boot of `what` (a per-process role) when grpcio or
    protobuf cannot be imported, naming the missing package.  Never falls
    back to the fused engine: the env asked for a node of a gRPC network."""
    import importlib

    for module, package in _GRPC_PACKAGES:
        try:
            importlib.import_module(module)
        except ImportError as e:
            _refuse(f"{what}: the per-process distributed mode (ROADMAP A.5) speaks "
                    f"gRPC and needs the {package} package (module {module!r}), which "
                    f"this host lacks ({e})")


def check_env(environ=os.environ) -> None:
    """Refuse at boot what the env asks for and this host or the port cannot
    serve, each refusal naming why."""
    role = distributed_role(environ)
    if role is not None:
        require_grpc("MISAKA_MODE=distributed" if role == "master" else f"NODE_TYPE={role}")
        return
    try:
        edge.plane_tls_from_env(environ)
    except (ValueError, OSError) as e:
        raise SystemExit(f"MISAKA_PLANE_TLS_*: {e}") from None
    coordinator = environ.get(multihost.COORDINATOR_ENV)
    if coordinator == "auto":
        _refuse(f"{multihost.COORDINATOR_ENV}=auto: JAX's Cloud TPU autodetection has no "
                "counterpart on a card's host; give host:port with "
                f"{multihost.NUM_PROCESSES_ENV} and {multihost.PROCESS_ID_ENV}")
    if coordinator and int(environ.get(multihost.NUM_PROCESSES_ENV, "1") or 1) > 1 and any(
            int(environ.get(k, "0") or 0) > 1
            for k in ("MISAKA_DATA_PARALLEL", "MISAKA_MODEL_PARALLEL")):
        _refuse("a serving mesh across the processes of a MISAKA_COORDINATOR group "
                "(the reference's global jax.devices()) is not ported yet "
                "(ROADMAP A.7b); each process of a group serves its own network")


def build_master_from_env(environ=os.environ):
    """The master the env asks for: the fused MasterNode, or (with
    MISAKA_MODE=distributed) the distributed control plane, not started."""
    check_env(environ)
    role = distributed_role(environ)
    if role == "master":
        return build_distributed_master_from_env(environ)
    if role is not None:
        raise SystemExit(f"'{role}' not a valid node type for a master: NODE_TYPE={role} "
                         "boots a node server (python -m misaka_tpu_torch.runtime.app)")
    return MasterNode(
        build_topology_from_env(environ),
        chunk_steps=int(environ.get("MISAKA_CHUNK_STEPS", "0") or 0) or 128,
        trace_cap=int(environ.get("MISAKA_TRACE_CAP", "0") or 0) or None,
        batch=int(environ.get("MISAKA_BATCH", "0") or 0) or None,
        engine=environ.get("MISAKA_ENGINE", "auto"),
        trace_instance=int(environ.get("MISAKA_TRACE_INSTANCE", "0") or 0),
        device=environ.get("MISAKA_DEVICE") or None,
        # intStack.go:9-45 is unbounded: capacity grows on a wedge
        stack_autogrow=environ.get("MISAKA_STACK_AUTOGROW", "1") != "0",
        data_parallel=int(environ.get("MISAKA_DATA_PARALLEL", "0") or 0) or None,
        model_parallel=int(environ.get("MISAKA_MODEL_PARALLEL", "0") or 0) or None,
        native_spec_dir=specialize_dir(environ),
    )


def _grpc_port(environ) -> int:
    return int(environ.get("MISAKA_GRPC_PORT", "8001"))


def build_distributed_master_from_env(environ=os.environ):
    """The distributed control plane (runtime/nodes.py) over NODE_INFO's
    peers, at NODE_ADDRS / MISAKA_GRPC_PORT, TLS with CERT_FILE/KEY_FILE."""
    from misaka_tpu_torch.runtime.nodes import MasterNodeProcess, Resolver

    node_info = json.loads(environ.get("NODE_INFO", "{}") or "{}")
    if not node_info:
        raise SystemExit("distributed master requires NODE_INFO")
    return MasterNodeProcess(node_info, resolver=Resolver.from_env(environ),
                             cert_file=environ.get("CERT_FILE"),
                             key_file=environ.get("KEY_FILE"), grpc_port=_grpc_port(environ))


def build_node_from_env(role: str, environ=os.environ):
    """A program or stack node server (runtime/nodes.py), not started; a
    program node loads PROGRAM, and one that does not parse is logged and
    left as NOP, as the reference's (app.go:22-24)."""
    from misaka_tpu_torch.runtime.nodes import ProgramNodeProcess, Resolver, StackNodeProcess

    cert, key = environ.get("CERT_FILE"), environ.get("KEY_FILE")
    if role == "stack":
        return StackNodeProcess(cert_file=cert, key_file=key, grpc_port=_grpc_port(environ))
    node = ProgramNodeProcess(master_uri=environ.get("MASTER_URI", "last_order"),
                              resolver=Resolver.from_env(environ), cert_file=cert,
                              key_file=key, grpc_port=_grpc_port(environ))
    program = environ.get("PROGRAM")
    if program:
        try:
            node.load_program(program)
        except Exception as e:
            log.warning("Could not load default program: %s", e)
    return node


def serve_node(role: str, environ=os.environ) -> None:
    """Boot one program or stack node and park the main thread while its
    gRPC server and execute loop run (the reference blocks in Serve,
    program.go:105); the guards stop it."""
    import threading

    node = build_node_from_env(role, environ)
    install_guards(node.close, environ, start_ppid=_PPID_AT_START)
    node.start()  # logs its gRPC port
    threading.Event().wait()


def serve_distributed_master(environ=os.environ) -> None:
    """Boot the distributed control plane: its Master gRPC service and peer
    prober, MISAKA_AUTORUN, and the shared HTTP surface on MISAKA_PORT
    (TLS from MISAKA_TLS_CERT/KEY, the edge, the canary).  No checkpoint
    or profile dir: the state lives in the peers, and there is no device
    loop.  MISAKA_HTTP_WORKERS and MISAKA_PLANE_SERVE front only the fused
    engine, as in the reference."""
    master = build_distributed_master_from_env(environ)
    httpd = pidfile = None

    def stop() -> None:
        try:
            canary.shutdown()
            master.close()
            if httpd is not None:
                httpd.server_close()
        finally:
            if pidfile:
                _remove(pidfile)

    install_guards(stop, environ, start_ppid=_PPID_AT_START)
    if (edge.keyfile_path(environ) and not environ.get("MISAKA_EDGE_INTERNAL_TOKEN")
            and environ.get("MISAKA_EDGE", "1") != "0"):
        environ["MISAKA_EDGE_INTERNAL_TOKEN"] = os.urandom(16).hex()
    master.start()
    if environ.get("MISAKA_AUTORUN") == "1":
        try:
            master.run()
        except Exception as e:  # peers may not be up yet; /run retries
            log.warning("autorun failed: %s", e)
    if int(environ.get("MISAKA_HTTP_WORKERS", "0") or 0) > 0:
        log.info("MISAKA_HTTP_WORKERS fronts the fused engine only; the distributed "
                 "master serves HTTP itself")
    httpd = make_http_server(master, port=int(environ.get("MISAKA_PORT", "8000")))
    pidfile = _write_pidfile(environ)
    log.info("serving on :%d (engine=distributed-grpc%s)", httpd.server_address[1],
             ", tls" if getattr(httpd, "misaka_tls", False) else "")
    scheme = "https" if environ.get("MISAKA_TLS_CERT") else "http"
    canary.ensure_started(f"{scheme}://127.0.0.1:{httpd.server_address[1]}",
                          server=httpd, environ=environ)
    try:
        httpd.serve_forever()
    finally:
        stop()


def specialize_dir(environ=os.environ) -> str | None:
    """The boot master's native compile cache, or None when the ladder's
    compiled rungs are killed (MISAKA_SPECIALIZE=0): a master climbs
    above the avx2 / generic rung only with a cache dir."""
    if environ.get("MISAKA_SPECIALIZE", "1") in ("0", "off"):
        return None
    from misaka_tpu_torch.core import specialize

    return specialize.default_cache_dir()  # MISAKA_SPEC_CACHE or the build dir


def arm_autockpt(master: MasterNode, environ=os.environ) -> AutoCheckpointer | None:
    """MISAKA_AUTOCKPT: restore the newest valid auto snapshot, then keep
    snapshotting on the interval (None when unset).  A fleet roll's
    replacement (MISAKA_FLEET_RESTORE) skips the restore: its roll
    checkpoint, loaded next, is newer."""
    interval = float(environ.get("MISAKA_AUTOCKPT", "0") or 0)
    if interval <= 0:
        return None
    checkpoint_dir = environ.get("MISAKA_CHECKPOINT_DIR")
    if not checkpoint_dir:
        raise SystemExit("MISAKA_AUTOCKPT requires MISAKA_CHECKPOINT_DIR (snapshots "
                         "need a directory to rotate in)")
    if environ.get("MISAKA_FLEET_RESTORE"):
        log.info("skipping auto-restore: fleet roll checkpoint takes precedence")
    else:
        restored = AutoCheckpointer.restore_latest(master, checkpoint_dir)
        if restored:
            log.info("auto-restored checkpoint %s", restored)
        else:
            log.info("no valid auto checkpoint under %s; fresh state", checkpoint_dir)
    return AutoCheckpointer(master, checkpoint_dir, interval,
                            keep=int(environ.get("MISAKA_AUTOCKPT_KEEP", "4")))


def build_registry_from_env(master: MasterNode, environ=os.environ) -> ProgramRegistry | None:
    """MISAKA_PROGRAMS_DIR: the program registry over that store, seeded
    with the boot master under MISAKA_DEFAULT_PROGRAM from its live
    topology (an auto-restored checkpoint may carry other programs than
    the boot env); None when unset."""
    programs_dir = environ.get("MISAKA_PROGRAMS_DIR")
    if not programs_dir:
        return None
    registry = ProgramRegistry(
        programs_dir,
        batch=int(environ.get("MISAKA_BATCH", "0") or 0) or None,
        engine=environ.get("MISAKA_ENGINE", "auto"),
        caps=caps_from_env(environ),
        device=environ.get("MISAKA_DEVICE") or None,
    )
    default_name = environ.get("MISAKA_DEFAULT_PROGRAM", "default")
    registry.seed(default_name, master)
    log.info("program registry armed (dir %s, default program %r, max_active %d)",
             programs_dir, default_name, registry.max_active)
    return registry


def _write_pidfile(environ=os.environ) -> str | None:
    """This server's pidfile: MISAKA_PIDFILE ("0"/"off": none), by default
    under the temp dir, never the working directory; removed at exit.  An
    unwritable path logs and serves on."""
    spec = environ.get("MISAKA_PIDFILE", "")
    if spec in ("0", "off"):
        return None
    path = spec or os.path.join(tempfile.gettempdir(), f"misaka-torch-app-{os.getpid()}.pid")
    try:
        with open(path, "w") as f:
            f.write(f"{os.getpid()}\n")
    except OSError as e:
        log.warning("pidfile %s unwritable (%s); serving without one", path, e)
        return None

    atexit.register(_remove, path)
    return path


def plane_path(environ=os.environ) -> str:
    """MISAKA_PLANE_SOCKET, by default a socket under the temp dir."""
    return environ.get("MISAKA_PLANE_SOCKET") or os.path.join(
        tempfile.gettempdir(), f"misaka-plane-{os.getpid()}.sock")


def _remove(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def start_native_edge(port: int, engine_port: int, path: str, registry, plane_conns: int,
                      environ=os.environ):
    """The native C++ edge on the public `port`, its workers' loopback port
    picked as its `proxy_port`; None, with one logged line, when
    MISAKA_NATIVE_EDGE=0, a TLS cert is armed (the native tier does not
    terminate TLS), or it fails to build or start (the workers then take
    the public port, as the reference's do)."""
    if environ.get("MISAKA_NATIVE_EDGE", "1") == "0":
        log.info("native edge off (MISAKA_NATIVE_EDGE=0); CPython workers take the public port")
        return None
    if environ.get("MISAKA_TLS_CERT"):
        log.info("native edge off (MISAKA_TLS_CERT: the native tier does not terminate TLS); "
                 "CPython workers take the public port")
        return None
    try:
        return frontends.NativeFrontendSupervisor(
            port=port, proxy_port=frontends.pick_free_port(), plane_path=path,
            registry=registry, healthz_url=f"http://127.0.0.1:{engine_port}/healthz",
            plane_conns=plane_conns, environ=environ)
    except Exception as e:
        log.warning("native edge unavailable (%s); CPython workers take the public port", e)
        return None


def main() -> None:
    environ = os.environ
    if environ.get("MISAKA_LOG_JSON") == "1":
        from misaka_tpu_torch.utils.jsonlog import install

        install(level=logging.INFO)
    else:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    check_env(environ)
    # the process group first, before anything touches the card (a no-op
    # without MISAKA_COORDINATOR), as the reference's app.py:755-760
    if multihost.initialize_from_env(environ):
        log.info("joined process group %s as rank %d of %d",
                 environ[multihost.COORDINATOR_ENV], multihost.process_index(),
                 multihost.process_count())
    role = distributed_role(environ)
    if role == "master":
        serve_distributed_master(environ)
        return
    if role is not None:
        serve_node(role, environ)
        return
    fleet_n = int(environ.get("MISAKA_FLEET", "0") or 0)
    if fleet_n >= 1 and not environ.get("MISAKA_FLEET_REPLICA"):
        # the fleet parent (runtime/fleet.py): N replicas of this app, the
        # frontend workers routing across them and the control server.  A
        # 1-replica roll leaves a gap (a boot outlasts the router's down
        # grace): zero-loss rolls need N >= 2
        from misaka_tpu_torch.runtime.fleet import run_fleet

        run_fleet(fleet_n, environ)
        return
    master = build_master_from_env(environ)
    autockpt = httpd = pidfile = plane = supervisor = registry = native_edge = None

    def stop() -> None:
        # the edge and the workers go first (no new frames), then the
        # device loop (no launch after it), then the sockets; a signal
        # exits through os._exit, past atexit: drop the pidfile here, even
        # when a signal that lands mid-/run makes a close raise
        try:
            if native_edge is not None:
                native_edge.close()
            if supervisor is not None:
                supervisor.close()
            canary.shutdown()
            if autockpt is not None:
                autockpt.close()
            if registry is not None:
                registry.close()  # checkpoints and closes the engines it built
            master.close()
            if plane is not None:
                plane.close()
            if httpd is not None:
                httpd.server_close()
        finally:
            if pidfile:
                _remove(pidfile)

    install_guards(stop, environ, start_ppid=_PPID_AT_START)
    if (edge.keyfile_path(environ) and not environ.get("MISAKA_EDGE_INTERNAL_TOKEN")
            and environ.get("MISAKA_EDGE", "1") != "0"):
        # the per-boot admin credential of this process tree (the workers
        # inherit it through the env), as the reference mints it
        environ["MISAKA_EDGE_INTERNAL_TOKEN"] = os.urandom(16).hex()
    autockpt = arm_autockpt(master, environ)
    fleet_restore = environ.get("MISAKA_FLEET_RESTORE")
    if fleet_restore:
        # a roll's replacement replica: its drained predecessor's verified
        # checkpoint, before any traffic or autorun
        master.load_checkpoint(fleet_restore)
        log.info("restored fleet roll checkpoint %s", fleet_restore)
    registry = build_registry_from_env(master, environ)
    port = int(environ.get("MISAKA_PORT", "8000"))
    workers = int(environ.get("MISAKA_HTTP_WORKERS", "0") or 0)
    server_kw = dict(checkpoint_dir=environ.get("MISAKA_CHECKPOINT_DIR") or None,
                     profile_dir=environ.get("MISAKA_PROFILE_DIR") or None, registry=registry)
    if workers > 0:
        # the multi-process front (runtime/frontends.py): the native edge
        # takes the public port and the workers move to a loopback port as
        # its proxy target, or the workers take it and terminate TLS; the
        # engine's own server is their plain-HTTP proxy target on a free port
        sys.setswitchinterval(0.001)  # many handler threads: no convoys
        httpd = make_http_server(master, port=0, tls=False, **server_kw)
        engine_port = httpd.server_address[1]
        path = plane_path(environ)
        plane = httpd.misaka_plane = frontends.start_compute_plane(master, path,
                                                                   registry=registry)
        plane_conns = int(environ.get("MISAKA_PLANE_CONNS", "2"))
        native_edge = start_native_edge(port, engine_port, path, registry, plane_conns,
                                        environ)
        httpd.misaka_native_edge = native_edge
        worker_port = port if native_edge is None else native_edge.proxy_port
        supervisor = httpd.misaka_supervisor = frontends.FrontendSupervisor(
            workers, worker_port, f"http://127.0.0.1:{engine_port}", path,
            plane_conns=plane_conns)
        log.info("engine http on 127.0.0.1:%d; %d supervised frontend workers on :%d "
                 "(plane %s)%s", engine_port, workers, worker_port, path,
                 f"; native edge on :{port}" if native_edge is not None else "")
    else:
        httpd = make_http_server(master, port=port, **server_kw)
        if environ.get("MISAKA_PLANE_SERVE") == "1":
            # a plane with no workers of its own: frontends elsewhere on
            # this host connect to it, and POST /fleet/drain drives it
            path = plane_path(environ)
            plane = httpd.misaka_plane = frontends.start_compute_plane(master, path,
                                                                       registry=registry)
            log.info("compute plane serving at %s", path)
    pidfile = _write_pidfile(environ)
    if pidfile:
        log.info("pidfile %s", pidfile)
    log.info("serving on :%d (engine=%s%s)", httpd.server_address[1], master.engine_name,
             ", tls" if getattr(httpd, "misaka_tls", False) else "")
    if environ.get("MISAKA_AUTORUN") == "1":
        master.run()
    # the synthetic canary probes the public port (the workers' when they
    # take it) and, with a registry, the canary program's own engine
    scheme = "https" if environ.get("MISAKA_TLS_CERT") else "http"
    public_port = port if workers > 0 else httpd.server_address[1]
    canary.ensure_started(f"{scheme}://127.0.0.1:{public_port}", registry=registry,
                          server=httpd, environ=environ)
    try:
        httpd.serve_forever()
    finally:
        stop()


if __name__ == "__main__":
    main()
