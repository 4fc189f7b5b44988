"""Network topology: the declarative config that compiles to kernel tables.

The port's twin of misaka_tpu/runtime/topology.py.  One `Topology` owns the
node declarations (the reference's NODE_INFO JSON shape, `{name: {"type":
...}}`, master.go:24-26, is accepted verbatim) and every program node's
source, and lowers them to the dense tables the superstep consumes.
`assemble` (tis/native.py) lowers a long program with the native C++
assembler when the host compiler can build it and every other program
with the Python frontend (tis/lower.py); the two are held equal by
tests/test_torch_native.py.

Lane/stack ids are assigned in declaration order; that order is also the
deterministic arbitration priority (core/step.py).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np
import torch

from misaka_tpu_torch.core.engine import CompiledNetwork
from misaka_tpu_torch.tis.lower import DEFAULT_PROGRAM, pad_programs
from misaka_tpu_torch.tis.native import assemble


class TopologyError(ValueError):
    pass


@dataclass
class Topology:
    """Node declarations + per-program-node source text."""

    node_info: dict[str, str]                    # name -> "program" | "stack"
    programs: dict[str, str] = field(default_factory=dict)
    stack_cap: int = 1024
    in_cap: int = 1024
    out_cap: int = 1024

    def __post_init__(self):
        # Never mutate caller-supplied dicts (setdefault below fills gaps).
        self.node_info = dict(self.node_info)
        self.programs = dict(self.programs)
        for name, kind in self.node_info.items():
            if kind not in ("program", "stack"):
                raise TopologyError(f"invalid node type '{kind}' for node '{name}'")
        unknown = set(self.programs) - set(self.lane_ids())
        if unknown:
            raise TopologyError(
                f"programs given for non-program nodes: {sorted(unknown)}"
            )
        # Every program node runs something; a fresh node runs NOP
        # (program.go:64).
        for name in self.lane_ids():
            self.programs.setdefault(name, DEFAULT_PROGRAM)

    @classmethod
    def from_node_info_json(cls, node_info_json: str, programs: dict[str, str] | None = None, **kw) -> "Topology":
        """Accept the reference's NODE_INFO JSON shape (master.go:24-26)."""
        raw = json.loads(node_info_json)
        return cls(
            node_info={name: spec["type"] for name, spec in raw.items()},
            programs=dict(programs or {}),
            **kw,
        )

    @classmethod
    def from_json(cls, text: str, **kw) -> "Topology":
        """Single declarative file: {"nodes": {name: type}, "programs": {name: text}}."""
        raw = json.loads(text)
        return cls(node_info=dict(raw["nodes"]), programs=dict(raw.get("programs", {})), **kw)

    def lane_ids(self) -> dict[str, int]:
        return {
            name: i
            for i, name in enumerate(
                n for n, kind in self.node_info.items() if kind == "program"
            )
        }

    def stack_ids(self) -> dict[str, int]:
        return {
            name: i
            for i, name in enumerate(
                n for n, kind in self.node_info.items() if kind == "stack"
            )
        }

    def with_program(self, target: str, program: str) -> "Topology":
        """A copy with one node reprogrammed (the /load path, master.go:145-195)."""
        if target not in self.node_info:
            raise TopologyError(f"node {target} not valid on this network")
        if self.node_info[target] != "program":
            raise TopologyError(f"node {target} is not a program node")
        new_programs = dict(self.programs)
        new_programs[target] = program
        return Topology(
            node_info=dict(self.node_info),
            programs=new_programs,
            stack_cap=self.stack_cap,
            in_cap=self.in_cap,
            out_cap=self.out_cap,
        )

    def compile(self, batch: int | None = None,
                device: str | torch.device | None = None) -> CompiledNetwork:
        """Lower every node's program and bind the engine for one instance
        (batch=None) or `batch` instances in lockstep, on `device` (None:
        the card, which must exist)."""
        lane_ids = self.lane_ids()
        if not lane_ids:
            raise TopologyError("network has no program nodes")
        stack_ids = self.stack_ids()
        lowered = [
            assemble(self.programs[name], lane_ids, stack_ids)
            for name in lane_ids
        ]
        code, lengths = pad_programs(lowered)
        return CompiledNetwork(
            code=code,
            prog_len=np.asarray(lengths, np.int32),
            num_stacks=max(1, len(stack_ids)),
            stack_cap=self.stack_cap,
            in_cap=self.in_cap,
            out_cap=self.out_cap,
            batch=batch,
            device=device,
        )
