"""gRPC transport for the per-process distributed mode.

The port's copy of misaka_tpu/transport: wire-compatible with the
reference's internal/grpc/ package (same proto package, services and
messages, see messenger.proto) and with the JAX package's nodes.  The
fused engine on the card does not use RPC at all; this package lets a
deployment span OS processes and hosts as the reference's docker-compose
topology does, mixing the port's nodes with the JAX package's and with
original Go nodes.  Importing it needs grpcio and protobuf; the fused boot
never does.
"""

from misaka_tpu_torch.transport.rpc import (
    MasterClient,
    ProgramClient,
    StackClient,
    RpcError,
    channel_credentials,
    server_credentials,
    make_server,
)

__all__ = [
    "MasterClient",
    "ProgramClient",
    "StackClient",
    "RpcError",
    "channel_credentials",
    "server_credentials",
    "make_server",
]
