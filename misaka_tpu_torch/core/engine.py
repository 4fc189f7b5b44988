"""Execution engine: chunk runner + host-side I/O for a compiled network.

The port's twin of misaka_tpu/core/engine.py.  `batch=None` runs one
network instance whose state fields carry no leading axis (the JAX
package's unbatched shapes); an integer B runs B independent instances in
lockstep.  The host touches device state only at chunk boundaries (refill
the input rings, drain the output rings).  The feed and pack steps around
the chunk are torch ops; the chunk itself is the fused CUDA kernel on the
card (`fused_runner`, `serve_chunk`) or the plain torch tick loop (`run`).
The plain step and the kernel are batched, so an unbatched state runs as a
batch of one: `as_batch` in (views, no copy), `first` out.

`run` auto-selects the arbitration of the plain tick loop as the JAX
engine's `run` does (`step_fn`, `compact_auto_lanes`, `wide_engine`): the
dense one-hot step (core/step.py) below a lane threshold, the compact-slot
step (core/routing.py) at or above it.  All three steps are bit-identical.
The kernel's plain version (core/fused.py::plain_run) stays the dense step.

Every member keeps the JAX signature and its refusals: the batched-only
members raise on an unbatched network and the single-instance ones on a
batched network, with the JAX messages.  `make_batched_serve` and
`serve_chunk` keep the packed layout [in_rd, in_wr, out_rd, out_wr,
out_buf...] that the master's device loop parses.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from misaka_tpu_torch.core import fused
from misaka_tpu_torch.core import routing
from misaka_tpu_torch.core import trace as trace_mod
from misaka_tpu_torch.core.state import NetworkState, init_state, rebase_rings
from misaka_tpu_torch.core.step import step
from misaka_tpu_torch.device import resolve_device
from misaka_tpu_torch.utils import profiling

# The lane count at or above which the compact-slot step (core/routing.py)
# replaces the dense one-hot step as `run`'s auto choice, and which wide
# step serves there, per platform: the reference's own table (cpu, tpu).
# CUDA is a platform the reference does not name, so it takes the
# reference's default for such a platform: 32 lanes, "compact".
COMPACT_AUTO_LANES = 32
_COMPACT_AUTO_BY_PLATFORM = {"cpu": 0, "tpu": COMPACT_AUTO_LANES}
_WIDE_ENGINE_BY_PLATFORM = {"cpu": "compact", "tpu": "chained"}
_RUN_ENGINES = ("dense", "compact", "chained")


def default_platform() -> str:
    """The platform an entry point runs on when not told: "cuda" with a
    card, else "cpu" (where the entry points then raise unless asked for
    the CPU)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def compact_auto_lanes(platform: str | None = None) -> int:
    """The dense -> wide step auto-switch threshold of `platform` (None: the
    default platform); MISAKA_COMPACT_AUTO_LANES overrides it."""
    env = os.environ.get("MISAKA_COMPACT_AUTO_LANES")
    if env:
        return int(env)
    return _COMPACT_AUTO_BY_PLATFORM.get(platform or default_platform(), COMPACT_AUTO_LANES)


def wide_engine(platform: str | None = None) -> str:
    """The wide-network step of `platform`: "compact" (scatter elections)
    on the CPU and on CUDA, "chained" on a TPU.  Override with
    MISAKA_WIDE_ENGINE=compact|chained."""
    env = os.environ.get("MISAKA_WIDE_ENGINE")
    if env:
        if env not in ("compact", "chained"):
            raise ValueError(f"MISAKA_WIDE_ENGINE must be compact|chained, got {env!r}")
        return env
    return _WIDE_ENGINE_BY_PLATFORM.get(platform or default_platform(), "compact")


_SINGLE_ONLY = ("feed/drain/compute_stream drive a single network instance; "
                "for batch mode write the I/O rings directly (see bench.py)")


def as_batch(state: NetworkState) -> NetworkState:
    """An unbatched state as a batch of one: views of its tensors, no copy.
    The engines write no field in place (the kernel's wrapper clones every
    field it writes), so the caller's state stays as it was."""
    return NetworkState(*(t.unsqueeze(0) for t in state))


def first(state: NetworkState) -> NetworkState:
    """Instance 0 of a batched state (views)."""
    return NetworkState(*(t[0] for t in state))


def counters_of(state: NetworkState) -> torch.Tensor:
    """[in_rd, in_wr, out_rd, out_wr] of every instance: [B, 4], on the
    state's device."""
    return torch.stack([state.in_rd, state.in_wr, state.out_rd, state.out_wr], dim=1)


def pack(state: NetworkState) -> tuple[NetworkState, torch.Tensor]:
    """(state with its output rings drained, the [B, 4 + out_cap] packed
    snapshot of counters and rings): the tail of a serve iteration."""
    packed = torch.cat([counters_of(state), state.out_buf], dim=1)
    return state._replace(out_rd=state.out_wr.clone()), packed


@dataclass
class CompiledNetwork:
    """A lowered network bound to the superstep engines, on one device.

    code/prog_len come from tis.lower.pad_programs.  `batch` instances run
    in lockstep (every state field has a leading [B] axis).  `device=None`
    means the card, which must then exist.
    """

    code: np.ndarray          # [N, L, NFIELDS] int32
    prog_len: np.ndarray      # [N] int32
    num_stacks: int = 1
    stack_cap: int = 1024     # bounded here; a full stack parks the pusher
    in_cap: int = 1024
    out_cap: int = 1024
    batch: int | None = None
    device: torch.device | str | None = None
    _code_t: torch.Tensor = field(init=False, repr=False)
    _len_t: torch.Tensor = field(init=False, repr=False)
    _serve_fns: dict = field(init=False, repr=False)
    _steps: dict = field(init=False, repr=False)

    def __post_init__(self):
        # At least one (possibly phantom) stack keeps kernel shapes nonempty.
        self.num_stacks = max(1, self.num_stacks)
        if self.batch is not None and (not isinstance(self.batch, int) or self.batch < 1):
            raise ValueError(f"batch must be None or an int >= 1, got {self.batch!r}")
        self.device = resolve_device(self.device)
        self.code = np.ascontiguousarray(self.code, dtype=np.int32)
        self.prog_len = np.ascontiguousarray(self.prog_len, dtype=np.int32)
        self._code_t = torch.from_numpy(self.code.copy()).to(self.device)
        self._len_t = torch.from_numpy(self.prog_len.copy()).to(self.device)
        self._serve_fns = {}
        self._steps = {}

    @property
    def num_lanes(self) -> int:
        return self.code.shape[0]

    def init_state(self) -> NetworkState:
        return init_state(
            self.num_lanes, self.num_stacks, self.stack_cap, self.in_cap,
            self.out_cap, batch=self.batch, device=self.device,
        )

    def auto_engine(self) -> str:
        """`run`'s auto choice on this network's device: "dense" below
        compact_auto_lanes() lanes, wide_engine() at or above."""
        platform = self.device.type
        if self.num_lanes < compact_auto_lanes(platform):
            return "dense"
        return wide_engine(platform)

    def step_fn(self, engine: str | None = None):
        """The per-tick step fn(code, prog_len, batched state) -> state of
        `engine` (None: `auto_engine`): core/step.py's dense step, or the
        compact-slot step with this network's route table, with its chain
        table for "chained" (built once each).  All are bit-identical."""
        engine = engine or self.auto_engine()
        if engine not in _RUN_ENGINES:
            raise ValueError(f"engine must be None|dense|compact|chained, got {engine!r}")
        if engine == "dense":
            return step
        fn = self._steps.get(engine)
        if fn is None:
            route = routing.build_route_table(self.code, self.prog_len)
            chain = (routing.build_chain_table(self.code, self.prog_len, route, self.num_stacks)
                     if engine == "chained" else None)
            route = routing.route_on(route, self.device)

            def fn(code, prog_len, state):
                return routing.step_slots(route, code, prog_len, state, chain=chain)

            self._steps[engine] = fn
        return fn

    def run(self, state: NetworkState, num_steps: int, engine: str | None = None
            ) -> NetworkState:
        """Advance `num_steps` supersteps with the plain torch tick loop.

        engine: None auto-selects by lane count on this network's device
        (`auto_engine`); "dense", "compact" or "chained" force a step."""
        fn = self.step_fn(engine)
        batched = state if self.batch is not None else as_batch(state)
        for _ in range(num_steps):
            batched = fn(self._code_t, self._len_t, batched)
        batched = rebase_rings(batched)
        return batched if self.batch is not None else first(batched)

    def init_trace(self, cap: int = 256) -> trace_mod.TraceRing:
        """A fresh per-lane trace ring on this network's device (core/trace.py)."""
        return trace_mod.init_trace(self.num_lanes, cap, self.device)

    def run_traced(self, state: NetworkState, trace: trace_mod.TraceRing, num_steps: int,
                   instance: int = 0):
        """Like `run`, but records fetch/commit/acc into `trace`; returns
        (state, trace).  Unbatched networks record every lane; batched
        networks record the lanes of instance `instance` (instances are
        independent, so its history is exact while all B advance)."""
        if self.batch is None:
            state, trace = trace_mod.run_traced(self._code_t, self._len_t, as_batch(state),
                                                trace, num_steps)
            return first(rebase_rings(state)), trace
        if not (0 <= instance < self.batch):
            raise ValueError(f"instance {instance} out of range [0, {self.batch})")
        state, trace = trace_mod.run_traced(self._code_t, self._len_t, state, trace,
                                            num_steps, instance)
        return rebase_rings(state), trace

    def fused_runner(self, num_steps: int, elide_dead_hi: bool | None = None,
                     count_as: str | None = None):
        """fn(state) -> state, `num_steps` ticks in ONE launch of the fused
        CUDA kernel (on a CUDA device; the plain version on the CPU), for a
        batched network (the unbatched chunk is `make_serve`'s).
        Raises ValueError naming the bound when the network exceeds the
        kernel's; on the card it builds the kernel now.  `fn.variant` is
        the launch-count key of the variant the kernel runs; the launches
        are counted under `count_as` (None: that key).

        elide_dead_hi (None: MISAKA_FUSED_ELIDE_HI == "1", as the JAX
        engine reads it) launches the kernel's elided variant: lanes with
        no 64-bit reader keep acc_hi/bak_hi at their entry values.  The
        lane mask is computed here, from this network's programs, and so
        are the kernel's line records (`fused.decode_lines`)."""
        if self.batch is None:
            raise ValueError("fused_runner requires a batched network")
        if elide_dead_hi is None:
            elide_dead_hi = os.environ.get("MISAKA_FUSED_ELIDE_HI") == "1"
        hi_live = fused.hi_live_mask(self.code, self.prog_len) if elide_dead_hi else None
        return self._kernel_runner(num_steps, hi_live, count_as)

    def _kernel_runner(self, num_steps: int, hi_live: int | None = None,
                       count_as: str | None = None):
        """fn(batched state) -> state through the kernel (see fused_runner):
        bounds checked, records decoded and the kernel built, once."""
        fused.check_kernel_bounds(self.num_lanes, self.num_stacks, self.code.shape[1])
        records = None
        if self.device.type == "cuda":
            records = fused.line_records(self.code, self.prog_len, self.num_stacks,
                                         self.device)
            fused.load_kernel()
        code, lens = self._code_t, self._len_t

        def run(state: NetworkState) -> NetworkState:
            return fused.fused_superstep(code, lens, state, num_steps, hi_live, count_as,
                                         records=records)

        run.variant = fused.variant(hi_live, self.num_lanes)
        return run

    def make_batched_serve(self, runner, num_steps: int):
        """The one-call batched serve iteration: returns (serve_fn, idle_fn)

          serve_fn(state, values [B, in_cap], counts [B]) -> (state, packed)
          idle_fn(state)                                  -> (state, ctrs)

        serve_fn's `packed` is ONE [B, 4 + out_cap] device tensor holding
        each instance's [in_rd, in_wr, out_rd, out_wr, out_buf...] with the
        output ring already drained in the returned state (out_rd :=
        out_wr).  idle_fn skips the feed and the ring: [B, 4] counters only.
        `runner` is the chunk fn of `num_steps` ticks (fused_runner).
        """
        if self.batch is None:
            raise ValueError("make_batched_serve requires a batched network")

        def serve(state, values, counts):
            with profiling.mark("misaka.feed"):
                fed = self.feed_batched(state, values, counts)
            out = runner(fed)
            with profiling.mark("misaka.pack"):
                return pack(out)

        def idle(state):
            state = runner(state)
            return state, counters_of(state)

        return serve, idle

    def make_serve(self, num_steps: int, engine: str = "auto"):
        """The unbatched one-call serve iteration, built once:

          serve(state, values [in_cap], count) -> (state, packed [4 + out_cap])

        feeds the `count` leading entries of `values`, advances `num_steps`
        ticks and packs [in_rd, in_wr, out_rd, out_wr, out_buf...] into ONE
        device tensor, with the returned state's output ring already
        drained (out_rd = out_wr): the caller reads `packed` once.

        engine="auto" runs the chunk as one launch of the full fused kernel
        on the batch-of-one view on a card (counted under
        fused.launch_counts["fused_superstep"]; the reference's unbatched
        path has no elided variant, so MISAKA_FUSED_ELIDE_HI does not apply)
        and the plain tick loop on the CPU; engine="scan" the plain tick
        loop on any device.  Raises ValueError naming the bound when a
        network exceeds the kernel's (on a card, with engine="auto")."""
        if self.batch is not None:
            raise ValueError("serve_chunk drives a single network instance")
        if engine not in ("auto", "scan"):
            raise ValueError(f"engine must be auto|scan, got {engine!r}")
        if engine == "auto" and self.device.type == "cuda":
            advance = self._kernel_runner(num_steps)
        else:
            code, lens = self._code_t, self._len_t

            def advance(state):
                return fused.plain_run(code, lens, state, num_steps)

        def serve(state, values, count):
            with profiling.mark("misaka.feed"):
                fed = self._feed_one(as_batch(state), values, count)
            one = advance(fed)
            with profiling.mark("misaka.pack"):
                packed = torch.cat([counters_of(one)[0], one.out_buf[0]])
                return first(one._replace(out_rd=one.out_wr.clone())), packed

        return serve

    def serve_chunk(self, state: NetworkState, values, count, num_steps: int,
                    engine: str = "auto"):
        """One-call serve iteration (unbatched device loop): `make_serve`'s
        fn for (num_steps, engine), built on first use and kept."""
        key = (num_steps, engine)
        fn = self._serve_fns.get(key)
        if fn is None:
            fn = self._serve_fns[key] = self.make_serve(num_steps, engine)
        return fn(state, values, count)

    # --- host-side I/O (chunk-boundary only) -------------------------------

    def _feed_one(self, state: NetworkState, values, count) -> NetworkState:
        """Append the `count` leading entries of `values` to the input ring
        of a batch-of-one state (caller guarantees count <= free space);
        nothing is uploaded for count 0."""
        count = int(count)
        if count <= 0:
            return state
        vals = torch.from_numpy(np.ascontiguousarray(values[:count], dtype=np.int32)).to(
            self.device)
        idx = ((state.in_wr + torch.arange(count, device=self.device, dtype=torch.int32))
               % self.in_cap).long()
        return state._replace(in_buf=state.in_buf.index_put((idx.new_zeros(count), idx), vals),
                              in_wr=state.in_wr + count)

    def feed(self, state: NetworkState, values) -> tuple[NetworkState, int]:
        """Enqueue up to len(values) inputs of an unbatched network;
        returns (state, accepted_count)."""
        if self.batch is not None:
            raise ValueError(_SINGLE_ONLY)
        values = np.asarray(values, dtype=np.int32)
        c = self.counters(state)
        k = min(len(values), self.in_cap - int(c[1] - c[0]))
        if k == 0:
            return state, 0
        return first(self._feed_one(as_batch(state), values, k)), k

    def drain(self, state: NetworkState) -> tuple[NetworkState, list[int]]:
        """Collect all pending outputs of an unbatched network in order;
        advances out_rd."""
        if self.batch is not None:
            raise ValueError(_SINGLE_ONLY)
        c = self.counters(state)
        rd, wr = int(c[2]), int(c[3])
        if wr == rd:
            return state, []
        buf = state.out_buf.cpu().numpy()
        vals = [int(buf[i % self.out_cap]) for i in range(rd, wr)]
        return state._replace(out_rd=state.out_wr.clone()), vals

    def compute_stream(
        self,
        state: NetworkState,
        values,
        chunk: int = 64,
        max_steps: int = 1_000_000,
        expected: int | None = None,
    ) -> tuple[NetworkState, list[int]]:
        """Feed a value stream and run until `expected` outputs arrive
        (default: one output per input): the reference's /compute called
        sequentially (master.go:197-224), where pairing is unambiguous.
        Pass `expected` for networks whose output count differs from the
        input count (e.g. examples/multiply.json: 2 inputs -> 1)."""
        pending = list(values)
        outputs: list[int] = []
        if expected is None:
            expected = len(pending)
        steps = 0
        while len(outputs) < expected:
            if steps >= max_steps:
                raise RuntimeError(
                    f"network made no full progress after {steps} supersteps "
                    f"({len(outputs)}/{expected} outputs) — deadlock or starvation"
                )
            if pending:
                state, took = self.feed(state, pending)
                pending = pending[took:]
            state = self.run(state, chunk)
            steps += chunk
            state, got = self.drain(state)
            outputs.extend(got)
        return state, outputs

    def feed_batched(self, state: NetworkState, values, counts) -> NetworkState:
        """Append per-instance inputs: values [B, in_cap] int32, counts [B].

        Caller guarantees counts[b] <= free space of instance b.  Only the
        rows with counts > 0 are uploaded; the rest keep their rings.
        """
        if self.batch is None:
            raise ValueError("feed_batched requires a batched network")
        values = np.ascontiguousarray(values, dtype=np.int32)
        counts = np.ascontiguousarray(counts, dtype=np.int32)
        if values.shape != (self.batch, self.in_cap) or counts.shape != (self.batch,):
            raise ValueError(
                f"need values [{self.batch}, {self.in_cap}] and counts "
                f"[{self.batch}], got {values.shape} / {counts.shape}"
            )
        sel = np.flatnonzero(counts)
        if sel.size == 0:
            return state
        dev = self.device
        sel_t = torch.from_numpy(sel).to(dev)
        vals = torch.from_numpy(values[sel]).to(dev)                 # [k, in_cap]
        cnt = torch.from_numpy(counts[sel]).to(dev)                  # [k]
        slots = torch.arange(self.in_cap, device=dev, dtype=torch.int32)
        idx = ((state.in_wr[sel_t][:, None] + slots) % self.in_cap).long()
        mask = slots[None, :] < cnt[:, None]
        rows = state.in_buf[sel_t]
        rows = rows.scatter(1, idx, torch.where(mask, vals, rows.gather(1, idx)))
        return state._replace(
            in_buf=state.in_buf.index_copy(0, sel_t, rows),
            in_wr=state.in_wr.index_add(0, sel_t, cnt),
        )

    def counters(self, state: NetworkState) -> np.ndarray:
        """[in_rd, in_wr, out_rd, out_wr] as ONE host read: [4] unbatched,
        [4, B] batched."""
        return torch.stack(
            [state.in_rd, state.in_wr, state.out_rd, state.out_wr]
        ).cpu().numpy()

    @staticmethod
    def drain_from_snapshot(buf, rd, wr, out_cap):
        """Ragged per-instance gather of pending outputs from a ring
        snapshot: returns [(slot, values)] like drain_batched, with one
        vectorized gather for all active instances."""
        active = np.nonzero(wr > rd)[0]
        if active.size == 0:
            return []
        counts = (wr - rd)[active]
        bounds = np.cumsum(counts)
        seq = np.arange(bounds[-1]) - np.repeat(bounds - counts, counts)
        idx = (np.repeat(rd[active], counts) + seq) % out_cap
        flat = buf[np.repeat(active, counts), idx]
        return list(zip(active.tolist(), np.split(flat, bounds[:-1])))

    def _gather_outputs(self, out_rows: torch.Tensor, rd, wr):
        """[(slot, values)] for the instances with wr > rd, copying only
        their ring rows to the host (`out_rows` is [B, out_cap])."""
        active = np.flatnonzero(wr > rd)
        if active.size == 0:
            return []
        rows = out_rows[torch.from_numpy(active).to(self.device)].cpu().numpy()
        got = self.drain_from_snapshot(rows, rd[active], wr[active], self.out_cap)
        return [(int(active[i]), vals) for i, vals in got]

    def read_packed(self, packed: torch.Tensor):
        """Parse serve_fn's packed snapshot: returns (counters [4, B] as
        `counters` gives them, [(slot, values)] of every instance that
        produced outputs)."""
        ctrs = packed[:, :4].cpu().numpy()
        return ctrs.T, self._gather_outputs(packed[:, 4:], ctrs[:, 2], ctrs[:, 3])

    def drain_batched(self, state: NetworkState, rd=None, wr=None):
        """Collect pending outputs per instance, in order; advances out_rd.
        Returns (state, [(slot, values)]) for instances that produced any."""
        if self.batch is None:
            raise ValueError("drain_batched requires a batched network")
        if rd is None or wr is None:
            c = self.counters(state)
            rd, wr = c[2], c[3]
        if (wr == rd).all():
            return state, []
        outs = self._gather_outputs(state.out_buf, rd, wr)
        out_rd = torch.from_numpy(np.ascontiguousarray(wr, dtype=np.int32)).to(self.device)
        return state._replace(out_rd=out_rd), outs
