"""Per-process distributed mode: drop-in peers for the reference deployment.

The port's copy of misaka_tpu/runtime/nodes.py.  The fused engine on the
card (misaka_tpu_torch/core) is the product; this module is the
deployment-parity mode: one OS process per node speaking the reference's
gRPC protocol (misaka_tpu_torch/transport), so a node of the port can
replace any container in the reference's docker-compose topology, or mix
with the JAX package's nodes and with original Go nodes on one network.
Nothing here touches the card: the nodes interpret TIS in Python threads
on the host, as the reference's do, and hold no device state.

Three node kinds, mirroring internal/nodes/:
  * ProgramNodeProcess — the TIS interpreter VM (program.go:24-432): registers
    acc/bak, instruction ptr, four cap-1 inbound ports, a free-running
    execute loop, and the Program gRPC service.  Executes the *same parsed
    token rows* as the Go reference (the port's frontend:
    misaka_tpu_torch.tis.parser).
  * StackNodeProcess — shared LIFO storage + the Stack service (stack.go).
  * MasterNodeProcess — control plane: HTTP surface + command broadcast +
    the Master data-plane service (master.go).

Deliberate divergences from the reference (each documented at the site):
  * One reused channel per peer instead of a fresh TLS dial per message
    (quirk #6) — semantics identical, latency strictly better.
  * Transient RPC errors are retried on the same instruction (matching the
    reference's update()-error semantics, program.go:80-92) instead of
    log.Fatalf-ing the process (quirk #8).
  * A cancelled Stack.Pop wakes cleanly instead of leaking a consumer that
    later swallows a value (quirk #4).
  * /compute request/response pairing is serialized (quirk #2).
  * /load dials the target's real gRPC port; the reference dials :8000 where
    nothing listens (quirk #1).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from collections import deque

import grpc
import numpy as np
from google.protobuf import empty_pb2

from misaka_tpu_torch.runtime.master import (
    BroadcastError,
    ComputeTimeout,
    PeerUnavailable,
)
from misaka_tpu_torch.tis.parser import TISParseError, parse
from misaka_tpu_torch.transport import rpc
from misaka_tpu_torch.transport import messenger_pb2 as pb
from misaka_tpu_torch.utils import metrics
from misaka_tpu_torch.utils import tracespan

# Distributed-mode metrics, under the reference's names (the same registry
# the fused master renders at GET /metrics; runtime.master.make_http_server
# serves this control plane too).  One process per node in production, so these are per-node series;
# the loopback test cluster shares one process and simply aggregates.
_C_DIST_REQS = metrics.counter(
    "misaka_dist_compute_requests_total",
    "compute/compute_many calls on the distributed control plane",
)
_C_DIST_VALUES = metrics.counter(
    "misaka_dist_compute_values_total",
    "Values submitted through the distributed compute lanes",
)
_C_DIST_TIMEOUTS = metrics.counter(
    "misaka_dist_compute_timeouts_total",
    "Distributed compute calls that raised ComputeTimeout",
)
_C_DIST_INPUTS = metrics.counter(
    "misaka_dist_inputs_total", "Values handed to program nodes via GetInput"
)
_C_DIST_OUTPUTS = metrics.counter(
    "misaka_dist_outputs_total", "Values received from program nodes via SendOutput"
)
_C_DIST_BROADCASTS = metrics.counter(
    "misaka_dist_broadcasts_total", "Control-plane command fan-outs by command",
    ("command",),
)
_C_STACK_PUSH = metrics.counter(
    "misaka_stack_push_total", "Stack-node Push RPCs served (this process)"
)
_C_STACK_POP = metrics.counter(
    "misaka_stack_pop_total", "Stack-node Pop RPCs served (this process)"
)
_C_PROG_INSTRS = metrics.counter(
    "misaka_program_instructions_total",
    "Instructions committed by program nodes in this process",
)
_C_RPC_RETRIES = metrics.counter(
    "misaka_rpc_retries_total",
    "RPC failures retried with backoff (node execute loops, this process)",
)
_C_DIST_PEER_UNAVAIL = metrics.counter(
    "misaka_dist_peer_unavailable_total",
    "Distributed computes refused fast (PeerUnavailable / HTTP 503) because "
    "a peer was down — distinct from genuine compute timeouts",
)
_G_PEER_STATE = metrics.gauge(
    "misaka_peer_state",
    "Control-plane peer health by name (0=down, 1=degraded, 2=up)",
    ("peer",),
)

_M64 = 1 << 64


def _wrap64(v: int) -> int:
    """Wrap to Go's 64-bit int: acc/bak are `int` (program.go:27-28); local
    arithmetic wraps at 64 bits while the wire truncates to sint32
    (rpc._i32 at every Send/Push/SendOutput)."""
    v &= _M64 - 1
    return v - _M64 if v >= (1 << 63) else v

log = logging.getLogger("misaka_tpu_torch.nodes")

_EMPTY = empty_pb2.Empty
_POLL = 0.05  # seconds between cancellation checks while blocked


class NodeCancelled(Exception):
    """A blocking op was interrupted by Pause/Reset (ctx cancellation,
    program.go:196-204)."""


class Resolver:
    """Node name -> dial target.  The reference hardcodes `<name>:8001`
    (grpcPort, master.go:20); NODE_ADDRS overrides let one host run many
    nodes on distinct ports."""

    def __init__(self, addrs: dict[str, str] | None = None, default_port: int = rpc.GRPC_PORT):
        self._addrs = dict(addrs or {})
        self._port = default_port

    @classmethod
    def from_env(cls, environ) -> "Resolver":
        addrs = json.loads(environ.get("NODE_ADDRS", "{}"))
        port = int(environ.get("MISAKA_GRPC_PORT", rpc.GRPC_PORT))
        return cls(addrs, default_port=port)

    def set_addr(self, name: str, target: str) -> None:
        """Late registration — lets tests bind ephemeral ports first."""
        self._addrs[name] = target

    def resolve(self, name: str) -> str:
        return self._addrs.get(name) or f"{name}:{self._port}"


class _ClientPool:
    """One lazily-dialed, reused client per (service, peer)."""

    def __init__(self, resolver: Resolver, cert_file: str | None):
        self._resolver = resolver
        self._cert = cert_file
        self._clients: dict[tuple[type, str], rpc._Stub] = {}
        self._lock = threading.Lock()

    def get(self, cls, name: str):
        key = (cls, name)
        with self._lock:
            client = self._clients.get(key)
            if client is None:
                client = cls(self._resolver.resolve(name), cert_file=self._cert)
                self._clients[key] = client
            return client

    def close(self) -> None:
        with self._lock:
            for c in self._clients.values():
                c.close()
            self._clients.clear()


class _Lifecycle:
    """isRunning + generation-based cancellation, shared by all node kinds.

    The reference pairs an unsynchronized isRunning flag (quirk #3) with a
    context.Context recreated on every stop (stopNode, program.go:196-204).
    Here: a lock-guarded flag plus a monotonically increasing generation;
    blocked ops capture the generation and bail when it moves.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._running = False
        self._gen = 0
        self._run_signal = threading.Event()

    @property
    def is_running(self) -> bool:
        return self._running

    @property
    def gen(self) -> int:
        return self._gen

    def start(self) -> bool:
        with self._lock:
            if self._running:
                return False
            self._running = True
            self._run_signal.set()
            return True

    def stop(self) -> bool:
        """stopNode: cancel in-flight blocking ops, clear running."""
        with self._lock:
            was = self._running
            self._running = False
            self._gen += 1
            self._run_signal.clear()
            return was

    def cancelled(self, gen: int) -> bool:
        return self._gen != gen

    def check(self, gen: int) -> None:
        if self._gen != gen:
            raise NodeCancelled()

    def wait_for_run(self) -> None:
        self._run_signal.wait(_POLL)


def _await_future(fut: grpc.Future, life: _Lifecycle, gen: int):
    """Block on an in-flight RPC, aborting if the node is paused/reset —
    the Go pattern of passing the node ctx into every client call."""
    while True:
        try:
            return fut.result(timeout=_POLL)
        except grpc.FutureTimeoutError:
            if life.cancelled(gen):
                fut.cancel()
                raise NodeCancelled()


class ProgramNodeProcess:
    """One TIS interpreter as an OS process (ProgramNode, program.go:24-432)."""

    def __init__(
        self,
        master_uri: str,
        resolver: Resolver | None = None,
        cert_file: str | None = None,
        key_file: str | None = None,
        grpc_port: int = rpc.GRPC_PORT,
        host: str = "0.0.0.0",
    ):
        self._master_uri = master_uri
        self._resolver = resolver or Resolver()
        self._cert, self._key = cert_file, key_file
        self._grpc_port = grpc_port
        self._host = host
        self._pool = _ClientPool(self._resolver, cert_file)

        self._life = _Lifecycle()
        self._state_lock = threading.Lock()  # guards acc/bak/ptr/asm swaps
        self.acc = 0
        self.bak = 0
        self.ptr = 0
        # Hold latch for a consumed-but-uncommitted port value: once a source
        # port is read, the value survives instruction retries (transient RPC
        # errors, pause/resume) until the instruction commits — the same
        # consume-then-park discipline as the fused kernel (core/fused.py
        # pass 1).  The reference re-reads the port on retry and silently
        # loses the consumed value (program.go:80-92 + :435-472).
        self._hold: int | None = None
        self._asm: list[list[str]] = [["NOP"]]  # fresh node default (program.go:64)
        self._label_map: dict[str, int] = {}
        # Inbound ports r0..r3: cap-1 queues (bufferSize=1, program.go:21,:60-63).
        self._ports = [queue.Queue(maxsize=1) for _ in range(4)]

        self._shutdown = threading.Event()
        self._loop: threading.Thread | None = None
        self._server: grpc.Server | None = None

    # --- lifecycle ----------------------------------------------------------

    def start(self) -> int:
        """Start the run loop and gRPC server; returns the bound port."""
        self._loop = threading.Thread(target=self._run_loop, daemon=True)
        self._loop.start()
        self._server, port = rpc.make_server(
            {"Program": _ProgramServicer(self)},
            self._grpc_port,
            self._cert,
            self._key,
            host=self._host,
        )
        self._server.start()
        log.info("program node serving grpc on :%d", port)
        self._grpc_port = port
        return port

    def close(self) -> None:
        self._shutdown.set()
        self._life.stop()
        if self._server:
            self._server.stop(grace=0.2)
        if self._loop:
            self._loop.join(timeout=2)
        self._pool.close()

    def load_program(self, source: str) -> None:
        """Parse + install a program (LoadProgram, program.go:178-193); a
        parse error leaves the old program in place."""
        tokens, label_map = parse(source)
        with self._state_lock:
            self._asm = tokens
            self._label_map = label_map

    def run_cmd(self) -> None:
        if self._life.start():
            log.info("node was run")
        else:
            log.info("node is already running")

    def pause_cmd(self) -> None:
        if self._life.stop():
            log.info("node was paused")
        else:
            log.info("node is already paused")

    def reset_cmd(self) -> None:
        self._life.stop()
        self._reset_state()
        log.info("node was reset")

    def _reset_state(self) -> None:
        """resetNode (program.go:207-216): zero registers, fresh ports."""
        with self._state_lock:
            self.acc = 0
            self.bak = 0
            self.ptr = 0
            self._hold = None
            self._ports = [queue.Queue(maxsize=1) for _ in range(4)]

    # --- the interpreter loop ----------------------------------------------

    def _run_loop(self) -> None:
        """Free-running execute loop (program.go:78-92): on error, log and
        retry the same instruction (ptr not advanced)."""
        backoff = rpc.Backoff(
            base=0.05,
            cap=float(os.environ.get("MISAKA_RPC_BACKOFF_MAX", "") or 5.0),
        )
        while not self._shutdown.is_set():
            gen = self._life.gen
            if not self._life.is_running:
                self._life.wait_for_run()
                continue
            try:
                # _state_lock serializes each instruction's commit against
                # pause/reset/load state mutation: a reset arriving while an
                # RPC response is in flight must zero state strictly AFTER
                # the instruction finishes, or the commit would clobber the
                # fresh ptr/acc (observed: OUT completing against a reset
                # left ptr=1, making the lane skip its IN on re-run).
                with self._state_lock:
                    self._life.check(gen)  # stop raced the lock acquisition
                    self._update(gen)
            except NodeCancelled:
                backoff.reset()  # lifecycle moved; retry cadence starts over
                continue
            except TISParseError as e:  # unreachable post-load; defensive
                log.warning("program error: %s", e)
            except rpc.RpcError as e:
                # Reference log.Fatalf's here (quirk #8); retry the SAME
                # instruction instead — with bounded exponential backoff
                # (rpc.Backoff): the retry never gives up, but a dead peer
                # is no longer hammered at poll rate, and no single sleep
                # exceeds MISAKA_RPC_BACKOFF_MAX (default 5s), so recovery
                # after the peer returns stays prompt.
                _C_RPC_RETRIES.inc()
                delay = backoff.next_delay()
                log.warning("rpc error (retry in %.2fs): %s", delay, e)
                self._backoff_wait(delay, gen)
            else:
                backoff.reset()

    def _backoff_wait(self, delay: float, gen: int) -> None:
        """Sleep out a backoff delay, waking early on shutdown or any
        lifecycle transition — a pause/reset/load landing mid-backoff must
        take effect now, not after a multi-second sleep."""
        deadline = time.monotonic() + delay
        while not self._shutdown.is_set():
            if self._life.cancelled(gen) or not self._life.is_running:
                return
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            self._shutdown.wait(min(_POLL, remaining))

    def _update(self, gen: int) -> None:
        """One instruction (update(), program.go:219-432).  Taken jumps set
        ptr and return; everything else falls through to the wrap increment
        `ptr = (ptr+1) % len(asm)` (program.go:429)."""
        # One consistent view of the program for this instruction: a /load
        # swapping self._asm mid-step must not skew the fetch or the wrap.
        asm = self._asm
        self.ptr %= len(asm)
        tokens = asm[self.ptr]
        kind = tokens[0]

        if kind == "NOP":
            pass
        elif kind == "SWP":
            self.acc, self.bak = self.bak, self.acc
        elif kind == "SAV":
            self.bak = self.acc
        elif kind == "NEG":
            self.acc = _wrap64(-self.acc)
        elif kind == "MOV_VAL_LOCAL":
            self._write_local(int(tokens[1]), tokens[2])
        elif kind == "MOV_VAL_NETWORK":
            self._send_value(int(tokens[1]), tokens[2], gen)
        elif kind == "MOV_SRC_LOCAL":
            self._write_local(self._get_from_src(tokens[1], gen), tokens[2])
        elif kind == "MOV_SRC_NETWORK":
            self._send_value(self._get_from_src(tokens[1], gen), tokens[2], gen)
        elif kind in ("ADD_VAL", "SUB_VAL", "ADD_SRC", "SUB_SRC"):
            v = int(tokens[1]) if kind.endswith("_VAL") else self._get_from_src(tokens[1], gen)
            self.acc = _wrap64(self.acc + (v if kind.startswith("ADD") else -v))
        elif kind in ("JMP", "JEZ", "JNZ", "JGZ", "JLZ"):
            taken = (
                kind == "JMP"
                or (kind == "JEZ" and self.acc == 0)
                or (kind == "JNZ" and self.acc != 0)
                or (kind == "JGZ" and self.acc > 0)
                or (kind == "JLZ" and self.acc < 0)
            )
            if taken:
                self.ptr = self._label_map[tokens[1]]
                return  # taken jumps skip the wrap increment (program.go:319)
        elif kind in ("JRO_VAL", "JRO_SRC"):
            v = int(tokens[1]) if kind == "JRO_VAL" else self._get_from_src(tokens[1], gen)
            self._hold = None  # committed (early return skips the shared clear)
            self.ptr = max(0, min(self.ptr + v, len(asm) - 1))  # IntClamp (math.go:17)
            return
        elif kind in ("PUSH_VAL", "PUSH_SRC"):
            v = int(tokens[1]) if kind == "PUSH_VAL" else self._get_from_src(tokens[1], gen)
            client = self._pool.get(rpc.StackClient, tokens[2])
            _await_future(client._Push.future(pb.ValueMessage(value=rpc._i32(v))), self._life, gen)
        elif kind == "POP":
            client = self._pool.get(rpc.StackClient, tokens[1])
            v = _await_future(client._Pop.future(_EMPTY()), self._life, gen).value
            self._write_local(int(v), tokens[2])
        elif kind == "IN":
            client = self._pool.get(rpc.MasterClient, self._master_uri)
            v = _await_future(client._GetInput.future(_EMPTY()), self._life, gen).value
            self._write_local(int(v), tokens[1])
        elif kind in ("OUT_VAL", "OUT_SRC"):
            v = int(tokens[1]) if kind == "OUT_VAL" else self._get_from_src(tokens[1], gen)
            client = self._pool.get(rpc.MasterClient, self._master_uri)
            _await_future(
                client._SendOutput.future(pb.ValueMessage(value=rpc._i32(v))), self._life, gen
            )

        self._hold = None  # instruction committed: release the port latch
        self.ptr = (self.ptr + 1) % len(asm)
        _C_PROG_INSTRS.inc()

    def _write_local(self, v: int, dst: str) -> None:
        """ACC stores, NIL discards (program.go:237-239)."""
        if dst == "ACC":
            self.acc = v

    def _get_from_src(self, src: str, gen: int) -> int:
        """getFromSrc (program.go:435-472): ACC/NIL immediate; ports block
        until a peer's Send lands, cancellable by pause/reset.  A port value
        is latched into self._hold so the instruction can retry (rpc error,
        pause) without losing it; _update clears the latch on commit."""
        if src == "ACC":
            return self.acc
        if src == "NIL":
            return 0
        if self._hold is not None:
            return self._hold
        q = self._ports[int(src[1])]
        while True:
            try:
                v = q.get(timeout=_POLL)
                self._hold = v
                return v
            except queue.Empty:
                self._life.check(gen)

    def _send_value(self, v: int, target: str, gen: int) -> None:
        """MOV to `name:Rk` — the Send RPC (sendValue, program.go:475-506).
        Blocks while the remote port is full (back-pressure via the
        blocking handler, program.go:160-175)."""
        name, port = target.rsplit(":", 1)
        client = self._pool.get(rpc.ProgramClient, name)
        fut = client._Send.future(
            pb.SendMessage(value=rpc._i32(v), register=int(port[1]))
        )
        _await_future(fut, self._life, gen)

    # --- inbound Send (the gRPC handler side) -------------------------------

    def deliver(self, value: int, register: int, context) -> None:
        """Blocking delivery into a cap-1 port (Send handler, program.go:160-175).
        Re-reads self._ports each poll so a reset (fresh queues) receives the
        value instead of stranding it in an orphaned buffer (the reference
        blocks forever on the old channel — strictly better)."""
        if not 0 <= register <= 3:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "not a valid register")
        while context.is_active():
            try:
                self._ports[register].put(int(value), timeout=_POLL)
                return
            except queue.Full:
                continue
        raise NodeCancelled()  # caller went away; nothing to do


class _ProgramServicer:
    """gRPC Program service handlers (program.go:111-175)."""

    def __init__(self, node: ProgramNodeProcess):
        self._node = node

    def run(self, request, context):
        self._node.run_cmd()
        return _EMPTY()

    def pause(self, request, context):
        self._node.pause_cmd()
        return _EMPTY()

    def reset(self, request, context):
        self._node.reset_cmd()
        return _EMPTY()

    def load(self, request, context):
        """Reset then load (Load handler, program.go:150-157); parse errors
        become INVALID_ARGUMENT and leave the old program."""
        self._node.reset_cmd()
        try:
            self._node.load_program(request.program)
        except TISParseError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return _EMPTY()

    def send(self, request, context):
        self._node.deliver(request.value, request.register, context)
        log.debug("received value")
        return _EMPTY()


class StackNodeProcess:
    """Shared LIFO storage process (StackNode, stack.go:17-155).

    The IntStack's empty-check races (quirk #5) and the cancelled-pop
    goroutine leak (quirk #4) are fixed by a single Condition guarding the
    list; pop waits on it and re-checks both emptiness and generation.
    """

    def __init__(
        self,
        cert_file: str | None = None,
        key_file: str | None = None,
        grpc_port: int = rpc.GRPC_PORT,
        host: str = "0.0.0.0",
    ):
        self._cert, self._key = cert_file, key_file
        self._grpc_port = grpc_port
        self._host = host
        self._life = _Lifecycle()
        self._cond = threading.Condition()
        self._stack: list[int] = []
        self._server: grpc.Server | None = None

    def start(self) -> int:
        self._server, port = rpc.make_server(
            {"Stack": _StackServicer(self)},
            self._grpc_port,
            self._cert,
            self._key,
            host=self._host,
        )
        self._server.start()
        log.info("stack node serving grpc on :%d", port)
        self._grpc_port = port
        return port

    def close(self) -> None:
        self._life.stop()
        with self._cond:
            self._cond.notify_all()
        if self._server:
            self._server.stop(grace=0.2)

    def push(self, value: int) -> None:
        with self._cond:
            self._stack.append(int(value))
            self._cond.notify()
        _C_STACK_PUSH.inc()

    def pop_blocking(self, context) -> int:
        """Blocks until a value exists (waitPop, stack.go:133-155); a
        pause/reset cancels with the reference's error message."""
        with self._cond:
            gen = self._life.gen
            while not self._stack:
                if self._life.cancelled(gen) or not context.is_active():
                    context.abort(grpc.StatusCode.CANCELLED, "stack pop cancelled")
                self._cond.wait(_POLL)
            _C_STACK_POP.inc()
            return self._stack.pop()

    def clear(self) -> None:
        with self._cond:
            self._stack.clear()

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._stack)


class _StackServicer:
    """gRPC Stack service handlers (stack.go:63-114)."""

    def __init__(self, node: StackNodeProcess):
        self._node = node

    def run(self, request, context):
        if self._node._life.start():
            log.info("node was run")
        else:
            log.info("node is already running")
        return _EMPTY()

    def pause(self, request, context):
        if self._node._life.stop():
            log.info("node was paused")
        else:
            log.info("node is already paused")
        with self._node._cond:
            self._node._cond.notify_all()
        return _EMPTY()

    def reset(self, request, context):
        self._node._life.stop()
        self._node.clear()
        with self._node._cond:
            self._node._cond.notify_all()
        log.info("node was reset")
        return _EMPTY()

    def push(self, request, context):
        self._node.push(request.value)
        return _EMPTY()

    def pop(self, request, context):
        return pb.ValueMessage(value=rpc._i32(self._node.pop_blocking(context)))


PEER_UP, PEER_DEGRADED, PEER_DOWN = "up", "degraded", "down"
_PEER_STATE_VALUE = {PEER_DOWN: 0.0, PEER_DEGRADED: 1.0, PEER_UP: 2.0}


class _PeerHealth:
    """Per-peer health states for the distributed control plane.

      up        — the last probe (or broadcast RPC) succeeded
      degraded  — 1..down_after-1 consecutive failures: transient blips,
                  traffic still flows (the node retry loops absorb them)
      down      — >= down_after consecutive failures: compute_many fails
                  FAST with PeerUnavailable instead of parking its full
                  timeout against a pipeline that cannot move

    Fed by the master's background prober (transport-level ready()
    checks, no RPC side effects) and by broadcast results; read by the
    compute path and /status; exported as the misaka_peer_state labeled
    gauge (0=down, 1=degraded, 2=up).  One recovery observation flips a
    peer straight back to up — the network heals without master restart.
    """

    def __init__(self, peers, down_after: int = 3):
        self._lock = threading.Lock()
        self._down_after = max(1, int(down_after))
        self._peers: dict[str, dict] = {
            name: {"state": PEER_UP, "failures": 0, "last_error": None}
            for name in peers
        }
        for name in self._peers:
            _G_PEER_STATE.labels(peer=name).set(_PEER_STATE_VALUE[PEER_UP])

    def record_ok(self, name: str) -> None:
        with self._lock:
            p = self._peers.setdefault(
                name, {"state": PEER_UP, "failures": 0, "last_error": None}
            )
            recovered = p["state"] == PEER_DOWN
            p["state"], p["failures"], p["last_error"] = PEER_UP, 0, None
        _G_PEER_STATE.labels(peer=name).set(_PEER_STATE_VALUE[PEER_UP])
        if recovered:
            log.info("peer %s is back up", name)

    def record_failure(self, name: str, error: str) -> None:
        with self._lock:
            p = self._peers.setdefault(
                name, {"state": PEER_UP, "failures": 0, "last_error": None}
            )
            p["failures"] += 1
            p["last_error"] = error
            was = p["state"]
            p["state"] = (
                PEER_DOWN if p["failures"] >= self._down_after else PEER_DEGRADED
            )
            state = p["state"]
        _G_PEER_STATE.labels(peer=name).set(_PEER_STATE_VALUE[state])
        if state == PEER_DOWN and was != PEER_DOWN:
            log.warning("peer %s marked down: %s", name, error)

    def down_peers(self) -> list[str]:
        with self._lock:
            return [n for n, p in self._peers.items() if p["state"] == PEER_DOWN]

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            return {n: dict(p) for n, p in self._peers.items()}


class MasterNodeProcess:
    """Distributed control plane (MasterNode, master.go:29-351): HTTP routes
    served via runtime.master.make_http_server (duck-typed), command fan-out
    over gRPC, and the Master data-plane service for program nodes' IN/OUT.
    """

    def __init__(
        self,
        node_info: dict[str, dict],
        resolver: Resolver | None = None,
        cert_file: str | None = None,
        key_file: str | None = None,
        grpc_port: int = rpc.GRPC_PORT,
        host: str = "0.0.0.0",
    ):
        self.node_info = dict(node_info)
        self._resolver = resolver or Resolver()
        self._cert, self._key = cert_file, key_file
        self._grpc_port = grpc_port
        self._host = host
        self._pool = _ClientPool(self._resolver, cert_file)
        self._life = _Lifecycle()
        # The reference uses cap-1 chans (master.go:58-59); unbounded deques
        # here only relax producer blocking, pairing is what matters.  A
        # Condition (not queue.Queue) so GetInput can re-check cancellation
        # immediately before every dequeue: a handler orphaned by reset must
        # not wake from a stale blocking get holding a fresh epoch's value.
        self._io_cond = threading.Condition()
        self._in_q: "deque[int]" = deque()
        self._out_q: "deque[int]" = deque()
        self._compute_lock = threading.Lock()
        self._stale_outputs = 0
        # bumped by _drain_queues (reset/load): a compute whose request was
        # wiped must NOT mark its missing outputs stale — nothing is coming,
        # and phantom stale entries would mispair every later request (the
        # fused MasterNode guards the same race with its epoch,
        # master.py _collect_slot)
        self._epoch = 0
        self._server: grpc.Server | None = None
        # /status additions (uptime_seconds / requests_total), mirroring the
        # fused MasterNode's observability surface
        self._created_mono = time.monotonic()
        self._requests_total = 0
        # Peer health (up/degraded/down): a background prober drives the
        # transport-level ready() check per peer; compute fails fast with
        # PeerUnavailable while any peer is down (MISAKA_PEER_DOWN_AFTER
        # consecutive failures, default 3; probe cadence MISAKA_PEER_PROBE_S,
        # default 1s — ~3s from peer death to fail-fast).
        self._health = _PeerHealth(
            self.node_info,
            down_after=int(os.environ.get("MISAKA_PEER_DOWN_AFTER", "") or 3),
        )
        self._probe_interval = float(
            os.environ.get("MISAKA_PEER_PROBE_S", "") or 1.0
        )
        self._probe_stop = threading.Event()
        self._prober: threading.Thread | None = None

    def start(self) -> int:
        self._server, port = rpc.make_server(
            {"Master": _MasterServicer(self)},
            self._grpc_port,
            self._cert,
            self._key,
            host=self._host,
        )
        self._server.start()
        self._prober = threading.Thread(
            target=self._probe_loop, daemon=True, name="misaka-peer-probe"
        )
        self._prober.start()
        log.info("master serving grpc on :%d", port)
        self._grpc_port = port
        return port

    def close(self) -> None:
        self._probe_stop.set()
        self._life.stop()
        if self._server:
            self._server.stop(grace=0.2)
        if self._prober is not None:
            self._prober.join(timeout=2)
        self._pool.close()

    def _probe_loop(self) -> None:
        """Background peer-health prober: one transport-level reachability
        check per peer per interval (rpc._Stub.ready — channel READY wait,
        no RPC side effects).  This is what notices a peer that died
        between broadcasts: the data plane is inbound-only (program nodes
        dial the master), so without active probing a dead peer is
        invisible until a request wedges against it.

        Peers are probed CONCURRENTLY (one thread per peer per sweep,
        like _broadcast): each dead peer blocks its ready() call for the
        full probe timeout, so a serial sweep would make down-detection
        latency scale with how many peers are dead — the cadence must
        stay one interval regardless of cluster size."""
        probe_timeout = min(1.0, self._probe_interval)

        def probe(name: str, info: dict) -> None:
            cls = (
                rpc.StackClient
                if info.get("type") == "stack"
                else rpc.ProgramClient
            )
            try:
                ok = self._pool.get(cls, name).ready(timeout=probe_timeout)
            except Exception as e:  # a broken channel counts as down
                self._health.record_failure(name, repr(e))
                return
            if ok:
                self._health.record_ok(name)
            else:
                self._health.record_failure(
                    name, "unreachable (connectivity probe timed out)"
                )

        while not self._probe_stop.wait(self._probe_interval):
            threads = [
                threading.Thread(target=probe, args=(name, info), daemon=True)
                for name, info in self.node_info.items()
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

    # --- command broadcast (master.go:269-351) ------------------------------

    def _broadcast(self, command: str) -> None:
        """Concurrent fan-out, one thread per node; any error fails the whole
        broadcast (master.go:271-294)."""
        errors: list[Exception] = []
        lock = threading.Lock()
        # the HTTP request's trace does not cross thread creation by
        # itself (contextvars are per-thread): hand it to each fan-out
        # thread so the rpc.<Method> spans + wire metadata ride along
        trace = tracespan.current()

        def call(name: str, info: dict) -> None:
            try:
                cls = rpc.StackClient if info.get("type") == "stack" else rpc.ProgramClient
                client = self._pool.get(cls, name)
                with tracespan.use(trace):
                    getattr(client, command)(timeout=10)
                self._health.record_ok(name)
            except Exception as e:  # noqa: BLE001 — collected, not swallowed
                self._health.record_failure(name, str(e))
                with lock:
                    errors.append(e)

        threads = [
            threading.Thread(target=call, args=(name, info))
            for name, info in self.node_info.items()
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        _C_DIST_BROADCASTS.labels(command=command).inc()
        if errors:
            raise BroadcastError(str(errors[0]))

    # --- the HTTP-facing surface (duck-typed for make_http_server) ----------

    def run(self) -> None:
        self._life.start()  # isRunning=true before fan-out (master.go:93)
        self._broadcast("run")
        log.info("network was run")

    def pause(self) -> None:
        self._broadcast("pause")
        self._life.stop()
        log.info("network was paused")

    def reset(self) -> None:
        self._broadcast("reset")
        self._life.stop()
        self._drain_queues()
        log.info("network was reset")

    def load(self, target: str, program: str) -> None:
        """Validate target, reset network, Load the target node
        (master.go:145-195) — at the node's real gRPC port (fixes quirk #1)."""
        if target not in self.node_info:
            from misaka_tpu_torch.runtime.topology import TopologyError

            raise TopologyError(f"node {target} not valid on this network")
        self._broadcast("reset")
        self._life.stop()
        self._drain_queues()
        client = self._pool.get(rpc.ProgramClient, target)
        try:
            client.load(program, timeout=10)
        except grpc.RpcError as e:
            raise BroadcastError(e.details() or str(e))

    def compute(self, value: int, timeout: float = 30.0) -> int:
        """One value in, one out, correlated (fixes quirk #2 — the reference
        pairs whatever output arrives first, master.go:216-219)."""
        return self.compute_many([value], timeout=timeout)[0]

    def compute_many(self, values, timeout: float = 30.0,
                     return_array: bool = False):
        """A FIFO stream of values through the distributed cluster in ONE
        request: len(values) in, len(values) out, pairing strictly ordered.

        This is the /compute_batch (and, via compute_spread, /compute_raw)
        lane for the per-process control plane: the reference moves one
        value per HTTP round trip (master.go:197-224); here a whole stream
        costs one queue append and the pipeline stays full.

        Fails FAST with PeerUnavailable (never a silent full-timeout park)
        when the health plane tracks any peer as down: a value stream
        cannot cross a dead node, so refusing at the door keeps the error
        typed, the latency bounded, and the input queue free of orphans.
        Recovery needs no master restart — the prober flips the peer back
        up and the next request flows.
        """
        # ingress truncates to the sint32 wire exactly like the reference
        # (every value crosses gRPC as sint32 anyway, messenger.proto:34-41)
        arr = np.asarray(values, dtype=np.int64).astype(np.int32)
        if arr.ndim != 1:
            raise ValueError(f"values must be a flat sequence, got shape {arr.shape}")
        if arr.size == 0:
            return np.empty((0,), np.int32) if return_array else []
        down = self._health.down_peers()
        if down:
            _C_DIST_PEER_UNAVAIL.inc()
            raise PeerUnavailable(
                f"peer(s) down: {', '.join(sorted(down))} — compute refused "
                f"(recovers automatically when the peer returns)"
            )
        _C_DIST_REQS.inc()
        _C_DIST_VALUES.inc(arr.size)
        outs: list[int] = []
        with self._compute_lock:
            self._requests_total += 1  # /status reads the int atomically
            deadline = time.monotonic() + timeout
            with self._io_cond:
                epoch = self._epoch
                self._in_q.extend(int(v) for v in arr)
                self._io_cond.notify_all()
                while len(outs) < arr.size:
                    while not self._out_q:
                        if self._epoch != epoch:
                            # reset/load wiped this request: nothing further
                            # is coming and nothing may be marked stale
                            _C_DIST_TIMEOUTS.inc()
                            raise ComputeTimeout(
                                "request wiped by reset/load mid-collect"
                            )
                        down = self._health.down_peers()
                        if down:
                            # a peer died mid-request: fail NOW with the
                            # typed error instead of burning the rest of
                            # the timeout.  The outputs still owed will
                            # surface when the peer returns — stale-mark
                            # them so later pairing survives (the same
                            # discipline as the timeout branch).  Counted
                            # on its OWN series: an alert tuned on real
                            # timeouts must not fire on peer outages.
                            self._stale_outputs += arr.size - len(outs)
                            _C_DIST_PEER_UNAVAIL.inc()
                            raise PeerUnavailable(
                                f"peer(s) down mid-compute: "
                                f"{', '.join(sorted(down))} "
                                f"({len(outs)}/{arr.size} value(s) collected)"
                            )
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            # outputs still owed to this request surface later:
                            # mark them stale so pairing survives the failure
                            self._stale_outputs += arr.size - len(outs)
                            _C_DIST_TIMEOUTS.inc()
                            raise ComputeTimeout(
                                f"no output for {arr.size - len(outs)}/"
                                f"{arr.size} value(s) after {timeout}s"
                            )
                        # slice the wait so a peer going down mid-collect is
                        # noticed within a probe interval, not at timeout
                        self._io_cond.wait(min(remaining, 0.25))
                    if self._epoch != epoch:
                        # outputs now in the queue belong to the NEW epoch:
                        # consuming them would fabricate results for wiped
                        # inputs and starve the next request (the fused
                        # master re-checks per chunk for the same reason)
                        raise ComputeTimeout(
                            "request wiped by reset/load mid-collect"
                        )
                    v = self._out_q.popleft()
                    if self._stale_outputs:
                        self._stale_outputs -= 1
                        continue
                    outs.append(v)
        out = np.asarray(outs, np.int32)
        return out if return_array else out.tolist()

    def compute_spread(self, values, timeout: float = 30.0,
                       return_array: bool = False):
        """Same stream through the single pipeline (no instance striping in
        the distributed mode) — exists so /compute_raw serves here too."""
        return self.compute_many(values, timeout=timeout, return_array=return_array)

    @property
    def is_running(self) -> bool:
        return self._life.is_running

    def status(self) -> dict:
        with self._io_cond:
            in_depth, out_depth = len(self._in_q), len(self._out_q)
        return {
            "running": self._life.is_running,
            "mode": "distributed",
            "served_engine": "distributed-grpc",
            "uptime_seconds": round(time.monotonic() - self._created_mono, 3),
            "requests_total": self._requests_total,
            "nodes": dict(self.node_info),
            # the health plane's view: {name: {state, failures, last_error}}
            # — state "down" is what compute fails fast on (PeerUnavailable)
            "peers": self._health.snapshot(),
            "in_queue": in_depth,
            "out_queue": out_depth,
        }

    def _drain_queues(self) -> None:
        with self._io_cond:
            self._in_q.clear()
            self._out_q.clear()
            self._stale_outputs = 0
            self._epoch += 1
            self._io_cond.notify_all()  # wake waiters to observe the wipe

    # --- data plane (Master service, master.go:233-249) ---------------------

    def get_input_blocking(self, context) -> int:
        """Blocks until a client value exists (GetInput, master.go:233-242).

        The cancellation checks sit immediately before the dequeue: a handler
        whose caller was reset away aborts without consuming a fresh epoch's
        value.  (The reference can lose an input here the same way its
        cancelled stack Pop loses a push, quirk #4.)
        """
        with self._io_cond:
            gen = self._life.gen
            while True:
                if self._life.cancelled(gen) or not context.is_active():
                    context.abort(grpc.StatusCode.CANCELLED, "main input cancelled")
                if self._in_q:
                    _C_DIST_INPUTS.inc()
                    return self._in_q.popleft()
                self._io_cond.wait(_POLL)

    def send_output(self, value: int) -> None:
        with self._io_cond:
            self._out_q.append(int(value))
            self._io_cond.notify_all()
        _C_DIST_OUTPUTS.inc()


class _MasterServicer:
    def __init__(self, node: MasterNodeProcess):
        self._node = node

    def get_input(self, request, context):
        return pb.ValueMessage(value=rpc._i32(self._node.get_input_blocking(context)))

    def send_output(self, request, context):
        self._node.send_output(request.value)
        return _EMPTY()


def build_loopback_cluster(node_info, programs, master_name: str = "last_order"):
    """Spin the whole wire-compatible cluster on loopback ephemeral ports.

    node_info: {name: "program"|"stack"}; programs: {name: source}.  Returns
    (master, close): a started (not yet /run) MasterNodeProcess plus a
    close() that tears everything down in dependency order — master first,
    then program nodes, then stacks — so no free-running execute loop is
    left retrying RPCs against an already-closed peer.  Shared by the
    cross-mode differential suite and the parity replayer's --local mode.
    """
    resolver = Resolver()
    stacks: list[StackNodeProcess] = []
    progs: list[ProgramNodeProcess] = []
    master: MasterNodeProcess | None = None

    def close() -> None:
        for n in ([master] if master is not None else []) + progs + stacks:
            n.close()

    try:
        for name, kind in node_info.items():
            if kind == "stack":
                s = StackNodeProcess(grpc_port=0, host="127.0.0.1")
                resolver.set_addr(name, f"127.0.0.1:{s.start()}")
                stacks.append(s)
        for name, kind in node_info.items():
            if kind == "program":
                p = ProgramNodeProcess(
                    master_uri=master_name, resolver=resolver,
                    grpc_port=0, host="127.0.0.1",
                )
                p.load_program(programs[name])
                resolver.set_addr(name, f"127.0.0.1:{p.start()}")
                progs.append(p)
        master = MasterNodeProcess(
            node_info={n: {"type": k} for n, k in node_info.items()},
            resolver=resolver, grpc_port=0, host="127.0.0.1",
        )
        resolver.set_addr(master_name, f"127.0.0.1:{master.start()}")
    except BaseException:
        close()
        raise
    return master, close
