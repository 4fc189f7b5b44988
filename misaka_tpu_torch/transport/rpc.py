"""Hand-rolled gRPC stubs for the messenger contract.

The port's copy of misaka_tpu/transport/rpc.py: the same method table,
wire truncation, credentials, fault points and trace metadata, so the
port's nodes and the JAX package's (and the Go reference's) mix on one
network.

The image ships grpcio but not grpcio-tools, so instead of generated service
stubs this module declares the method table explicitly (the message classes
are generated, by protoc --python_out: messenger_pb2.py keeps the JAX
package's serialized descriptor byte for byte, so both load in one process
and share their classes).  The table mirrors the reference's three services exactly
(messenger_grpc.pb.go:20-588, generated from messenger.proto:9-28).

Transport policy vs the reference:
  * The reference dials a fresh blocking TLS connection per message
    (program.go:492-565 — SURVEY.md quirk #6, its dominant cost).  Clients
    here hold ONE channel per peer and reuse it; gRPC reconnects under the
    hood.  Semantics are identical, latency is not (strictly better).
  * TLS is optional: with cert/key files configured the server takes TLS
    creds (program.go:98-101) and clients verify against the same
    self-signed cert used as root CA (program.go:52-55); without them both
    sides run insecure — the reference has no insecure mode.
"""

from __future__ import annotations

import time

import grpc
from google.protobuf import empty_pb2

from misaka_tpu_torch.transport import messenger_pb2 as pb
from misaka_tpu_torch.utils import faults
from misaka_tpu_torch.utils import tracespan

# The shared retry-delay policy, re-exported for the node retry loops:
# the pre-r9 loop slept a fixed 50ms forever — a dead peer got hammered
# at 20 req/s per node per instruction, and every retrying node woke in
# lockstep (bounded-exponential + jitter fixes both; utils/backoff.py).
from misaka_tpu_torch.utils.backoff import Backoff  # noqa: F401  (re-export)

RpcError = grpc.RpcError


class InjectedRpcError(grpc.RpcError):
    """A transport failure injected by the fault harness (utils/faults.py
    `rpc_drop`): shaped like any other grpc.RpcError so every retry and
    health-accounting path treats it exactly like a real network fault."""

    def __init__(self, method: str):
        super().__init__(f"injected rpc_drop fault on {method}")
        self.method = method

class _FaultableCallable:
    """A unary-unary callable wrapped with the rpc_delay/rpc_drop fault
    points; passthrough-cheap (two dict lookups) when nothing is armed."""

    __slots__ = ("_inner", "_method")

    def __init__(self, inner, method: str):
        self._inner = inner
        self._method = method

    def _check(self) -> None:
        if not faults.armed():  # the production path: one dict truthiness
            return
        delay = faults.fire("rpc_delay")
        if delay:
            time.sleep(delay)
        if faults.fire("rpc_drop") is not None:
            raise InjectedRpcError(self._method)

    def __call__(self, request, timeout=None):
        self._check()
        trace = tracespan.current()
        if trace is None:  # the production hot path: one contextvar read
            return self._inner(request, timeout=timeout)
        # A request trace is in scope (an HTTP broadcast fan-out, a /load):
        # the ID crosses the wire as gRPC metadata — the peer's server
        # interceptor records the receipt — and the call itself lands in
        # the trace as an rpc.<Method> span.
        t0 = time.monotonic()
        try:
            return self._inner(
                request, timeout=timeout,
                metadata=((tracespan.RPC_METADATA_KEY, trace.trace_id),),
            )
        finally:
            tracespan.add_span(
                trace, "rpc." + self._method.rsplit("/", 1)[-1],
                t0, time.monotonic() - t0, {"path": self._method},
            )

    def future(self, request):
        self._check()
        trace = tracespan.current()
        if trace is not None:
            # propagate the ID; no span — the future's completion happens
            # on a caller-owned schedule this wrapper cannot see
            return self._inner.future(
                request,
                metadata=((tracespan.RPC_METADATA_KEY, trace.trace_id),),
            )
        return self._inner.future(request)

_EMPTY = empty_pb2.Empty
_VALUE = pb.ValueMessage
_SEND = pb.SendMessage
_LOAD = pb.LoadMessage

# service name -> method name -> (request class, response class).  Method
# paths become /grpc.<Service>/<Method>: proto package "grpc" per the
# reference IDL (messenger.proto:3).
SERVICES: dict[str, dict[str, tuple[type, type]]] = {
    "Master": {
        "GetInput": (_EMPTY, _VALUE),
        "SendOutput": (_VALUE, _EMPTY),
    },
    "Program": {
        "Run": (_EMPTY, _EMPTY),
        "Pause": (_EMPTY, _EMPTY),
        "Reset": (_EMPTY, _EMPTY),
        "Load": (_LOAD, _EMPTY),
        "Send": (_SEND, _EMPTY),
    },
    "Stack": {
        "Run": (_EMPTY, _EMPTY),
        "Pause": (_EMPTY, _EMPTY),
        "Reset": (_EMPTY, _EMPTY),
        "Push": (_VALUE, _EMPTY),
        "Pop": (_EMPTY, _VALUE),
    },
}

GRPC_PORT = 8001  # the reference's fixed node port (master.go:20)


def channel_credentials(cert_file: str) -> grpc.ChannelCredentials:
    """Client TLS verifying the server's self-signed cert as root CA
    (credentials.NewClientTLSFromFile(certFile, ""), program.go:52)."""
    with open(cert_file, "rb") as f:
        return grpc.ssl_channel_credentials(root_certificates=f.read())


def server_credentials(cert_file: str, key_file: str) -> grpc.ServerCredentials:
    """Server TLS from cert/key pair (NewServerTLSFromFile, program.go:98)."""
    with open(cert_file, "rb") as f:
        cert = f.read()
    with open(key_file, "rb") as f:
        key = f.read()
    return grpc.ssl_server_credentials([(key, cert)])


def open_channel(target: str, cert_file: str | None = None) -> grpc.Channel:
    if cert_file:
        return grpc.secure_channel(target, channel_credentials(cert_file))
    return grpc.insecure_channel(target)


class _Stub:
    """Typed callables for one service over one (reused) channel."""

    _service: str

    def __init__(
        self,
        target: str,
        cert_file: str | None = None,
        channel: grpc.Channel | None = None,
    ):
        self._owned = channel is None
        self._channel = channel or open_channel(target, cert_file)
        for method, (req_cls, resp_cls) in SERVICES[self._service].items():
            path = f"/grpc.{self._service}/{method}"
            setattr(
                self,
                "_" + method,
                _FaultableCallable(
                    self._channel.unary_unary(
                        path,
                        request_serializer=req_cls.SerializeToString,
                        response_deserializer=resp_cls.FromString,
                    ),
                    path,
                ),
            )

    def ready(self, timeout: float = 1.0) -> bool:
        """Probe peer reachability: wait up to `timeout` for the channel
        to reach READY (triggers a reconnect attempt on an idle or failed
        channel).  Pure transport-level — no RPC is invoked, so probing
        has no side effects on the peer.  This is the control plane's
        peer-health primitive (runtime/nodes.py)."""
        if faults.fire("rpc_drop") is not None:
            return False
        fut = grpc.channel_ready_future(self._channel)
        try:
            fut.result(timeout=timeout)
            return True
        except (grpc.FutureTimeoutError, grpc.RpcError, ValueError):
            # cancel unsubscribes the connectivity watcher: leaving it
            # armed makes grpc's poller thread crash when the channel
            # closes later (ValueError covers exactly that closed-channel
            # race when close() wins over a probe in flight)
            fut.cancel()
            return False

    def close(self) -> None:
        if self._owned:
            self._channel.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MasterClient(_Stub):
    """Program-node-side view of the master (GetInput/SendOutput)."""

    _service = "Master"

    def get_input(self, timeout: float | None = None) -> int:
        return self._GetInput(_EMPTY(), timeout=timeout).value

    def get_input_future(self) -> grpc.Future:
        """Cancellable in-flight GetInput (result().value when done)."""
        return self._GetInput.future(_EMPTY())

    def send_output(self, value: int, timeout: float | None = None) -> None:
        self._SendOutput(_VALUE(value=_i32(value)), timeout=timeout)


class ProgramClient(_Stub):
    _service = "Program"

    def run(self, timeout: float | None = None) -> None:
        self._Run(_EMPTY(), timeout=timeout)

    def pause(self, timeout: float | None = None) -> None:
        self._Pause(_EMPTY(), timeout=timeout)

    def reset(self, timeout: float | None = None) -> None:
        self._Reset(_EMPTY(), timeout=timeout)

    def load(self, program: str, timeout: float | None = None) -> None:
        self._Load(_LOAD(program=program), timeout=timeout)

    def send(self, value: int, register: int, timeout: float | None = None) -> None:
        """Deliver into port R<register>; blocks while the port is full
        (the reference's channel send in the handler, program.go:160-175)."""
        self._Send(_SEND(value=_i32(value), register=register), timeout=timeout)

    def send_future(self, value: int, register: int) -> grpc.Future:
        return self._Send.future(_SEND(value=_i32(value), register=register))


class StackClient(_Stub):
    _service = "Stack"

    def run(self, timeout: float | None = None) -> None:
        self._Run(_EMPTY(), timeout=timeout)

    def pause(self, timeout: float | None = None) -> None:
        self._Pause(_EMPTY(), timeout=timeout)

    def reset(self, timeout: float | None = None) -> None:
        self._Reset(_EMPTY(), timeout=timeout)

    def push(self, value: int, timeout: float | None = None) -> None:
        self._Push(_VALUE(value=_i32(value)), timeout=timeout)

    def pop(self, timeout: float | None = None) -> int:
        """Blocks until the stack is non-empty (waitPop, stack.go:133-155)."""
        return self._Pop(_EMPTY(), timeout=timeout).value

    def pop_future(self) -> grpc.Future:
        return self._Pop.future(_EMPTY())


def _i32(v: int) -> int:
    """Wrap to sint32 range like the reference's int32(v) cast (program.go:498)."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def make_server(
    services: dict[str, object],
    port: int,
    cert_file: str | None = None,
    key_file: str | None = None,
    max_workers: int = 32,
    host: str = "0.0.0.0",
) -> tuple[grpc.Server, int]:
    """Serve `services` ({"Program": servicer, ...}); returns (server, port).

    Servicer objects expose one method per RPC, lowercase_snake, taking
    (request, context) and returning the response message.  Handlers run on
    a thread pool, so blocking inside one (port full, stack empty) blocks
    only its RPC — the reference gets the same from goroutines.
    Pass port=0 to bind an ephemeral port (tests).
    """
    from concurrent import futures

    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        interceptors=(_TraceMetadataInterceptor(),),
    )
    for service_name, servicer in services.items():
        handlers = {}
        for method, (req_cls, resp_cls) in SERVICES[service_name].items():
            fn = getattr(servicer, _snake(method))
            handlers[method] = grpc.unary_unary_rpc_method_handler(
                fn,
                request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString,
            )
        server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(f"grpc.{service_name}", handlers),)
        )
    address = f"{host}:{port}"
    if cert_file and key_file:
        bound = server.add_secure_port(address, server_credentials(cert_file, key_file))
    else:
        bound = server.add_insecure_port(address)
    if bound == 0:
        raise RuntimeError(f"failed to bind gRPC server on {address}")
    return server, bound


class _TraceMetadataInterceptor(grpc.ServerInterceptor):
    """Record inbound trace IDs (x-misaka-trace metadata) as rpc.recv
    tier events — the peer-side proof a request trace crossed the wire,
    surfaced in this process's /debug/perfetto.  Passthrough-cheap: one
    metadata scan per RPC, and only RPCs that carry the key record."""

    def intercept_service(self, continuation, handler_call_details):
        for key, value in handler_call_details.invocation_metadata or ():
            if key == tracespan.RPC_METADATA_KEY:
                tracespan.note_tier(
                    "rpc.recv." + handler_call_details.method.rsplit(
                        "/", 1
                    )[-1],
                    0.0,
                    attrs={
                        "trace_id": value,
                        "path": handler_call_details.method,
                    },
                )
                break
        return continuation(handler_call_details)


def _snake(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i:
            out.append("_")
        out.append(ch.lower())
    return "".join(out)
