"""Fault injection: named failure points driven by one env spec.

The port's copy of misaka_tpu/utils/faults.py: the same points, spec
grammar, error messages and draw (the module `random`, as the reference
draws), so one MISAKA_FAULTS spec arms the same chaos in both packages.

Spec (env var `MISAKA_FAULTS`, POST /debug/faults `spec=`, or
`configure()`): a comma-separated list of armed fault points,

    MISAKA_FAULTS="ckpt_torn_write=0.5,serve_delay:tenant-a=0.2@0.5"

each entry `name[=value][@probability]`: `name` one of POINTS (an unknown
name is an error at parse time), `value` a float the hook site interprets
(default 1.0), `probability` the chance in [0, 1] that one `fire()`
triggers (default 1.0).  SCOPED_POINTS also take a `:<target>` suffix.

Hook sites in the port (the reference's sites, in the ported code):

  serve_delay[:<program>]  ServeBatcher._run_pass sleeps `value` s before
                           dispatching (runtime/master.py)
  ckpt_crash               save_checkpoint raises before the atomic
                           replace; ckpt_torn_write truncates the file to
                           `value` of its bytes after it
                           (runtime/checkpoint.py)
  swap_during_load         the registry's hot swap sleeps with the park
                           gate closed (runtime/registry.py)
  overload[:<tenant>]      the admission governor sheds (runtime/edge.py);
  quota_exhaust            every quota check reports its bucket empty
  plane_partition[:<addr>] plane dials fail and frames are never written;
  plane_delay              each frame send sleeps `value` s;
  replica_blackhole[:<i>]  the compute plane holds each frame `value` s;
  worker_exit              a frontend worker hard-exits `value` s after
                           boot (runtime/frontends.py)
  replica_kill             the fleet parent SIGKILLs one live replica
                           `value` s after the fleet starts, once per boot
                           (runtime/fleet.py)

  specialize_fail          a per-program specialized build fails: the
                           engine serves one rung down (core/specialize.py)
  jit_fail                 the copy-and-patch splice fails: one rung down
                           (core/jit.py)
  resident_fallback        a native serve call takes the stateless path
                           after a coherent export (core/native_serve.py)
  edge_native_build        the native edge's build fails where a missing
                           toolchain would: the app keeps the CPython
                           workers on the public port (runtime/frontends.py)
  rpc_delay                every RPC of the distributed mode sleeps
                           `value` s before it is sent;
  rpc_drop                 it fails with InjectedRpcError (a grpc.RpcError,
                           retried like a network fault), and a readiness
                           probe reports the peer unreachable
                           (transport/rpc.py)

Checks cost one dict lookup while nothing is armed.  Stdlib only: the
frontend workers import it.
"""

from __future__ import annotations

import os
import random
import threading

POINTS = frozenset({
    "worker_exit",
    "rpc_drop",
    "rpc_delay",
    "ckpt_torn_write",
    "ckpt_crash",
    "swap_during_load",
    "serve_delay",
    "replica_kill",
    "replica_blackhole",
    "overload",
    "quota_exhaust",
    "specialize_fail",
    "edge_native_build",
    "resident_fallback",
    "jit_fail",
    "plane_partition",
    "plane_delay",
})

# Points that accept a ":<qualifier>" suffix scoping the fault to one
# target: `serve_delay:tenant-b=0.05` injects latency into ONLY that
# registry program's serve passes (runtime/master.py ServeBatcher) — the
# per-tenant SLO chaos scenario, where one program must page while its
# neighbors stay green.
SCOPED_POINTS = frozenset(
    {"serve_delay", "replica_blackhole", "overload", "plane_partition"}
)


class FaultSpecError(ValueError):
    """Malformed MISAKA_FAULTS spec (unknown point, bad value/probability)."""


def parse_spec(text: str | None) -> dict[str, tuple[float, float]]:
    """`name[=value][@prob],...` -> {name: (value, probability)}."""
    spec: dict[str, tuple[float, float]] = {}
    for raw in (text or "").split(","):
        entry = raw.strip()
        if not entry:
            continue
        prob = 1.0
        if "@" in entry:
            entry, prob_s = entry.rsplit("@", 1)
            try:
                prob = float(prob_s)
            except ValueError:
                raise FaultSpecError(
                    f"cannot parse probability {prob_s!r} in {raw!r}"
                ) from None
            if not 0.0 <= prob <= 1.0:
                raise FaultSpecError(
                    f"probability must be in [0, 1], got {prob} in {raw!r}"
                )
        value = 1.0
        if "=" in entry:
            entry, value_s = entry.split("=", 1)
            try:
                value = float(value_s)
            except ValueError:
                raise FaultSpecError(
                    f"cannot parse value {value_s!r} in {raw!r}"
                ) from None
        name = entry.strip()
        base = name.split(":", 1)[0]
        if name not in POINTS and not (
            ":" in name and base in SCOPED_POINTS and name[len(base) + 1:]
        ):
            raise FaultSpecError(
                f"unknown fault point {name!r} (known: {sorted(POINTS)}; "
                f"scoped: {sorted(SCOPED_POINTS)} accept ':<target>')"
            )
        spec[name] = (value, prob)
    return spec


# The armed spec is an IMMUTABLE dict swapped whole by configure(): readers
# (the hot RPC / device-loop hook sites) take no lock — a reference read is
# atomic under the GIL, and a reader sees either the old or the new spec,
# never a torn one.  The lock only serializes concurrent configure() calls.
_lock = threading.Lock()
_spec: dict[str, tuple[float, float]] = parse_spec(os.environ.get("MISAKA_FAULTS"))


def configure(text: str | None) -> None:
    """Re-arm from a spec string (tests); None/"" disarms everything."""
    global _spec
    parsed = parse_spec(text)
    with _lock:
        _spec = parsed


def armed() -> bool:
    """True when ANY fault point is armed — the one-dict-truthiness check
    hot paths use to skip their per-point rolls entirely."""
    return bool(_spec)


def active() -> frozenset[str]:
    """The currently armed point names (empty when faults are off)."""
    return frozenset(_spec)


def fire(point: str) -> float | None:
    """Roll the dice for one armed fault point.

    Returns the point's configured value when it triggers, None when the
    point is unarmed or its probability roll misses.  Callers interpret
    the value (seconds, fraction, ...) at the hook site.  Lock-free: one
    dict lookup on the current (immutable) spec.
    """
    armed_point = _spec.get(point)
    if armed_point is None:
        return None
    value, prob = armed_point
    if prob < 1.0 and random.random() >= prob:
        return None
    return value
