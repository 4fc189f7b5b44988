"""The data-parallel mesh: the batch cut into contiguous shards, one per device.

The port's twin of misaka_tpu/parallel/mesh.py for its `data` axis.  The
reference serves B instances over a jax.sharding.Mesh: under `P("data")`
instance b lives on shard b // (B/D), and each device runs the whole fused
kernel on its shard with no traffic between shards (instances are
independent).  Here a mesh is a list of torch devices, one per shard; its
`data` size is D and its `model` size is 1.  `state_specs` has no
counterpart: with model=1 every field shards by batch only.  The `model`
axis (lanes sharded across devices, parallel/routed.py and sharded.py in
the reference) is not ported.

The reference's data parallelism is single-controller: one jit drives every
device, with no collectives.  So is this one: one process issues every
shard's work on its own device and stream and waits once per iteration.

`make_mesh(n)` takes the first n cards and raises ValueError when the host
has fewer, as the reference's reshape does; `make_mesh(n, "cpu")` puts n
shards on the CPU (the tests, as the JAX package's run an 8-device virtual
CPU mesh); `make_mesh(n, [devices])` takes the list as given, and a list
may repeat one card: two shards on one card run the split, the launch per
shard and the gather on one card.  The app's `MISAKA_DATA_PARALLEL=D` on
the card always asks for D distinct cards.

`make_dp_fused_runner` is the port of
misaka_tpu/runtime/master.py::_make_dp_fused_runner, the Pallas kernel under
`shard_map`: the hand-written kernel of csrc/fused_superstep.cu launched
once per shard on that shard's device and stream.  It adds no arithmetic:
gathered, its result is bit for bit one whole-batch launch's.  What bounds
it is what bounds the kernel, its int32 operations, per card: D shards on
D cards take the whole batch's operations over D cards' rate, and shards
that share a card share its rate.  On a CPU shard it runs the kernel's
plain version (core/fused.py::plain_run); on a CUDA shard it launches the
kernel or raises.  Its launches count under `fused.KERNEL_DP`, one per
shard per chunk, whichever variant they run (`run.variant` names it).

`ShardedNetwork` gives the master `CompiledNetwork`'s serving members over
the global batch, so its device loop keeps one shape.  Every shard's feed,
launch and pack is issued before anything waits; the host reads
(`counters`, `read_packed`, `drain_batched`) copy every shard's part
non-blocking into pinned memory and wait once (`_fetch`), so the cards'
work overlaps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from misaka_tpu_torch.core import fused
from misaka_tpu_torch.core.engine import CompiledNetwork, counters_of, pack
from misaka_tpu_torch.core.state import NetworkState
from misaka_tpu_torch.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One device per data shard, in shard order (a device may repeat)."""

    devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.devices), MODEL_AXIS: 1}


def _card(dev: torch.device) -> torch.device:
    """`dev` with its card index (a bare `cuda` is the current card)."""
    if dev.type != "cuda":
        return dev
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise ValueError(f"device cuda:{index} does not exist: the host has "
                         f"{torch.cuda.device_count()} card(s)")
    return torch.device("cuda", index)


def make_mesh(n_devices: int, device=None) -> Mesh:
    """A data mesh of `n_devices` shards.

    device None or "cuda": the first n cards (ValueError when the host has
    fewer); "cpu": n shards on the CPU; a list: one device per shard, as
    given (repeats allowed).  A single card named by its index serves only
    a one-shard mesh."""
    if not isinstance(n_devices, int) or n_devices < 1:
        raise ValueError(f"a mesh needs n_devices >= 1, got {n_devices!r}")
    if isinstance(device, (list, tuple)):
        devices = [_card(resolve_device(d)) for d in device]
        if len(devices) != n_devices:
            raise ValueError(f"{len(devices)} devices given for a mesh of {n_devices}")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a mesh's devices are all cuda or all cpu, got {devices}")
        return Mesh(tuple(devices))
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh((dev,) * n_devices)
    if dev.type != "cuda":
        raise ValueError(f"a mesh runs on cuda or cpu devices, not {dev}")
    if dev.index is not None:
        if n_devices != 1:
            raise ValueError(f"{dev} is one card; give a list of {n_devices} devices")
        return Mesh((_card(dev),))
    have = torch.cuda.device_count()
    if have < n_devices:
        raise ValueError(f"data_parallel={n_devices} needs {n_devices} cards; "
                         f"the host has {have}")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n_devices)))


def shard_state(state: NetworkState, mesh: Mesh) -> list[NetworkState]:
    """Cut every field of a batched state along the batch axis into
    len(mesh.devices) contiguous equal shards (instance b on shard
    b // (B/D), `P("data")`'s order), each an owned copy on its device."""
    d = len(mesh.devices)
    batch = state.pc.shape[0]
    if batch % d:
        raise ValueError(f"batch {batch} not divisible by data_parallel={d}")
    b = batch // d
    return [
        NetworkState(*(t[i * b:(i + 1) * b].to(dev, copy=True) for t in state))
        for i, dev in enumerate(mesh.devices)
    ]


def gather_state(shards: list[NetworkState]) -> NetworkState:
    """The inverse of `shard_state`: the shards joined along the batch axis,
    as owned tensors on the CPU."""
    parts = _fetch([t for shard in shards for t in shard])
    n = len(NetworkState._fields)
    return NetworkState(*(
        torch.from_numpy(np.concatenate(parts[f::n])) for f in range(n)
    ))


def _fetch(tensors: list[torch.Tensor]) -> list[np.ndarray]:
    """Every tensor as an owned host array.  A CUDA tensor is copied
    non-blocking into pinned memory behind an event on its device's current
    stream; every copy is issued before the one wait, so work queued on
    several cards runs on while the copies of the first are in flight."""
    hosts, events = [], []
    for t in tensors:
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(t.device))
            events.append(event)
        else:
            host = t.clone()
        hosts.append(host)
    for event in events:
        event.synchronize()
    return [h.numpy() for h in hosts]


def make_dp_fused_runner(nets: list[CompiledNetwork], num_steps: int,
                         elide_dead_hi: bool | None = None):
    """fn(shards) -> shards: `num_steps` ticks of every shard, one launch of
    the fused kernel per shard on its own device (shard i runs through
    nets[i], a CompiledNetwork of the shard's batch on its device).
    elide_dead_hi as CompiledNetwork.fused_runner.  `fn.variant` is the
    variant every launch runs."""
    runners = [net.fused_runner(num_steps, elide_dead_hi, count_as=fused.KERNEL_DP)
               for net in nets]

    def run(shards: list[NetworkState]) -> list[NetworkState]:
        if len(shards) != len(runners):
            raise ValueError(f"{len(shards)} shards for a runner of {len(runners)}")
        return [r(s) for r, s in zip(runners, shards)]

    run.variant = runners[0].variant
    return run


class ShardedNetwork:
    """A network compiled for a mesh: one CompiledNetwork of B/D instances
    per mesh device, with CompiledNetwork's serving members (init_state,
    run, fused_runner, make_batched_serve, counters, read_packed,
    drain_batched) over the global batch of B.  States are lists of shard
    states; counters, feeds and slot numbers are global."""

    def __init__(self, net: CompiledNetwork, mesh: Mesh):
        d = len(mesh.devices)
        if net.batch % d:
            raise ValueError(f"batch {net.batch} not divisible by data_parallel={d}")
        b = net.batch // d
        self.mesh = mesh
        self.batch = net.batch
        self.nets = [dataclasses.replace(net, batch=b, device=dev) for dev in mesh.devices]
        self._cuts = [(i * b, (i + 1) * b) for i in range(d)]
        self.code, self.prog_len = net.code, net.prog_len
        self.num_stacks, self.stack_cap = net.num_stacks, net.stack_cap
        self.in_cap, self.out_cap = net.in_cap, net.out_cap
        self.device = mesh.devices[0]

    @property
    def num_lanes(self) -> int:
        return self.code.shape[0]

    def init_state(self) -> list[NetworkState]:
        return [net.init_state() for net in self.nets]

    def fused_runner(self, num_steps: int, elide_dead_hi: bool | None = None):
        return make_dp_fused_runner(self.nets, num_steps, elide_dead_hi)

    def run(self, shards: list[NetworkState], num_steps: int) -> list[NetworkState]:
        """`num_steps` ticks of every shard through the plain tick loop."""
        return [net.run(s, num_steps) for net, s in zip(self.nets, shards)]

    def make_batched_serve(self, runner, num_steps: int):
        """CompiledNetwork.make_batched_serve over the shards:

          serve_fn(shards, values [B, in_cap], counts [B]) -> (shards, packed)
          idle_fn(shards)                                  -> (shards, ctrs)

        serve_fn feeds each shard its contiguous rows of the global feed,
        runs `runner` (one launch per shard) and packs each shard on its
        device; nothing waits, and `packed` is the list that `read_packed`
        reads.  idle_fn's ctrs are the global [B, 4] counters, on the host."""

        def serve(shards, values, counts):
            fed = [net.feed_batched(s, values[a:b], counts[a:b])
                   for net, s, (a, b) in zip(self.nets, shards, self._cuts)]
            packs = [pack(s) for s in runner(fed)]
            return [s for s, _ in packs], [p for _, p in packs]

        def idle(shards):
            shards = runner(shards)
            return shards, torch.from_numpy(np.concatenate(_fetch([counters_of(s) for s in shards])))

        return serve, idle

    def counters(self, shards: list[NetworkState]) -> np.ndarray:
        """[in_rd, in_wr, out_rd, out_wr] of every instance: [4, B]."""
        return np.concatenate(_fetch([counters_of(s) for s in shards])).T

    def read_packed(self, packed: list[torch.Tensor]):
        """serve_fn's packed shards as CompiledNetwork.read_packed gives
        them: (counters [4, B], [(global slot, values)])."""
        ctrs = np.concatenate(_fetch([p[:, :4] for p in packed]))
        return ctrs.T, self._gather_outputs([p[:, 4:] for p in packed], ctrs[:, 2], ctrs[:, 3])

    def drain_batched(self, shards: list[NetworkState], rd=None, wr=None):
        """CompiledNetwork.drain_batched over the shards (global rd/wr)."""
        if rd is None or wr is None:
            c = self.counters(shards)
            rd, wr = c[2], c[3]
        if (wr == rd).all():
            return shards, []
        outs = self._gather_outputs([s.out_buf for s in shards], rd, wr)
        wr = np.ascontiguousarray(wr, dtype=np.int32)
        shards = [s._replace(out_rd=torch.from_numpy(wr[a:b].copy()).to(net.device))
                  for net, s, (a, b) in zip(self.nets, shards, self._cuts)]
        return shards, outs

    def _gather_outputs(self, out_rows: list[torch.Tensor], rd, wr):
        """[(global slot, values)] for the instances with wr > rd: each
        shard's active ring rows selected on its device, copied with one
        wait, then cut per instance on the host."""
        picks = []
        for net, rows, (a, b) in zip(self.nets, out_rows, self._cuts):
            active = np.flatnonzero(wr[a:b] > rd[a:b])
            if active.size:
                picks.append((a, active, rows[torch.from_numpy(active).to(net.device)]))
        outs = []
        for (a, active, _), host in zip(picks, _fetch([p[2] for p in picks])):
            got = CompiledNetwork.drain_from_snapshot(
                host, rd[a + active], wr[a + active], self.out_cap)
            outs.extend((a + int(active[i]), vals) for i, vals in got)
        return outs
