"""docker-compose importer: run a reference deployment file as one fused network.

The port's copy of misaka_tpu/runtime/compose.py.  PyYAML is imported
inside `parse_compose` only: a host without it fails there, and the
callers answer that failure (the CLI and the app exit 2, the registry's
compose upload is a 400), while everything else runs.

The reference's topology lives in a docker-compose file: the master service
carries NODE_INFO (cmd/app.go:30-35), each program service carries NODE_TYPE/
PROGRAM envs (docker-compose.yml:32-43), and stack services just declare
NODE_TYPE=stack.  A user migrating from the reference already has such a
file — this module turns it directly into a `Topology`, so

    MISAKA_TOPOLOGY=docker-compose.yml python -m misaka_tpu_torch serve
    python -m misaka_tpu_torch check docker-compose.yml      (or disasm/debug)

runs the exact network their containers ran, fused into one kernel,
without hand-translating anything.

Mapping rules (strict on what matters, lenient on container plumbing):
  * services with environment.NODE_TYPE program/stack become nodes, keyed by
    service name (the reference addresses peers by compose service DNS name,
    program.go:476);
  * a program service's PROGRAM env becomes its TIS source (YAML block
    scalars keep their trailing newline — one NOP slot, parity with Go's
    strings.Split);
  * the master service's NODE_INFO is cross-checked against the services:
    nodes declared in one place but not the other are an error, because the
    reference would break the same way at runtime (unknown target dials);
  * image/build/ports/networks/cert envs are container plumbing — ignored.
"""

from __future__ import annotations

import json

from misaka_tpu_torch.runtime.topology import Topology, TopologyError


class ComposeError(ValueError):
    """Raised when a compose file cannot be mapped onto a network."""


def _env_of(service: dict) -> dict[str, str]:
    env = service.get("environment") or {}
    if isinstance(env, list):  # compose also allows ["KEY=value", ...]
        out = {}
        for item in env:
            key, _, value = str(item).partition("=")
            out[key] = value
        return out
    return {str(k): ("" if v is None else str(v)) for k, v in env.items()}


def parse_compose(text: str, **caps) -> Topology:
    """Parse docker-compose YAML text into a Topology."""
    import yaml

    try:
        doc = yaml.safe_load(text)
    except yaml.YAMLError as e:
        raise ComposeError(f"invalid YAML: {e}") from e
    if not isinstance(doc, dict) or not isinstance(doc.get("services"), dict):
        raise ComposeError("compose file has no services mapping")

    node_info: dict[str, str] = {}
    programs: dict[str, str] = {}
    declared: dict[str, str] | None = None  # master's NODE_INFO view

    for name, service in doc["services"].items():
        env = _env_of(service or {})
        node_type = env.get("NODE_TYPE")
        if node_type in ("program", "stack"):
            node_info[name] = node_type
            if node_type == "program" and "PROGRAM" in env:
                programs[name] = env["PROGRAM"]
        elif node_type == "master":
            raw = env.get("NODE_INFO")
            if raw:
                try:
                    parsed = json.loads(raw)
                    if not isinstance(parsed, dict):
                        raise TypeError(f"expected a JSON object, got {type(parsed).__name__}")
                    declared = {n: spec["type"] for n, spec in parsed.items()}
                except (json.JSONDecodeError, TypeError, KeyError) as e:
                    raise ComposeError(f"master NODE_INFO is not valid: {e}") from e
        # services without NODE_TYPE are unrelated containers; skip

    if not node_info:
        raise ComposeError("no services with NODE_TYPE program/stack found")

    if declared is not None and declared != node_info:
        missing = set(declared) - set(node_info)
        extra = set(node_info) - set(declared)
        mismatched = {
            n
            for n in set(declared) & set(node_info)
            if declared[n] != node_info[n]
        }
        detail = "; ".join(
            part
            for part in (
                f"in NODE_INFO but not deployed: {sorted(missing)}" if missing else "",
                f"deployed but not in NODE_INFO: {sorted(extra)}" if extra else "",
                f"type mismatch: {sorted(mismatched)}" if mismatched else "",
            )
            if part
        )
        raise ComposeError(f"master NODE_INFO disagrees with services ({detail})")

    try:
        return Topology(node_info=node_info, programs=programs, **caps)
    except TopologyError as e:
        raise ComposeError(str(e)) from e


def load_compose(path: str, **caps) -> Topology:
    """Read + parse a compose file from disk (caps: stack_cap/in_cap/out_cap)."""
    with open(path) as f:
        return parse_compose(f.read(), **caps)
