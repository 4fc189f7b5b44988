"""The serving mesh: a [data, model] grid of devices.

The port's twin of misaka_tpu/parallel/mesh.py.  The reference serves B
instances over a jax.sharding.Mesh with two axes:

  data   the batch cut into D contiguous shards (instance b on row
         b // (B/D)), with no traffic between rows (instances are
         independent);
  model  a network's program lanes cut into M contiguous slices (lane n on
         column n // (N/M)); inter-lane MOV, stack and ring traffic rides
         collectives over this axis every tick (parallel/routed.py,
         parallel/sharded.py).

Here a mesh is a row-major tuple of D*M torch devices, one per shard
(shard i is row i // M, column i % M); `shape` is {"data": D, "model": M}.
`state_specs` is the reference's table of how each `NetworkState` field is
laid out: lane-major fields (registers, pc, ports, the hold latch,
`retired`) are cut over `model`, the stacks, the rings and `tick` are
replicated over `model` (every shard applies the same agreed update), and
every field is cut over `data` by the batch.  `shard_state` and
`gather_state` follow it.

Both are single-controller, as the reference's jit is: one process issues
every shard's work.  Data parallel (M=1) launches the fused kernel once per
shard on its own device and stream and waits once per iteration
(`make_dp_fused_runner`, the port of
misaka_tpu/runtime/master.py::_make_dp_fused_runner, the Pallas kernel
under `shard_map`: gathered, its result is bit for bit one whole-batch
launch's; on a CPU shard it runs the kernel's plain version, on a CUDA
shard it launches the kernel or raises, counted under `fused.KERNEL_DP`,
one per shard per chunk).  Model parallel (M>1) drives every shard's step
in this thread through `build_lane_sharded_runner`, the shards of a row
meeting at the collectives of core/axis.py; the reference runs no Pallas
kernel on that path (master.py:1359-1363), and neither does the port.

`make_mesh(n)` takes the first n cards and raises ValueError when the host
has fewer, as the reference's reshape does; `make_mesh(n, "cpu")` puts n
shards on the CPU (the tests, as the JAX package's run an 8-device virtual
CPU mesh); `make_mesh(n, [devices])` takes the list as given, and a list
may repeat one card: shards that share a card share its rate.  The app's
MISAKA_DATA_PARALLEL x MISAKA_MODEL_PARALLEL on the card always asks for
that many distinct cards.

`ShardedNetwork` gives the master `CompiledNetwork`'s serving members over
the global batch, so its device loop keeps one shape.  The feed writes
every model shard's replica of a row's rings; counters, the pack and the
reads come from each row's first shard (its replicas are equal), and the
drained `out_rd` goes to every replica.  Every shard's feed, chunk and
pack is issued before anything waits; the host reads copy every row's
part non-blocking into pinned memory and wait once (`_fetch`).

A mesh of a multi-process group (parallel/multihost.py::hybrid_mesh) holds
only this process's devices: its rows are rows `data_offset ...` of a
global data axis of `data_total`, and `shard_state` keeps only those rows'
shards.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from misaka_tpu_torch.core import fused
from misaka_tpu_torch.core.engine import CompiledNetwork, counters_of
from misaka_tpu_torch.core.state import NetworkState, rebase_rings
from misaka_tpu_torch.device import resolve_device
from misaka_tpu_torch.core.axis import Axis, drive

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One device per shard, row-major over [data, model] (a device may
    repeat).  `data_offset`/`data_total` place this process's rows on a
    multi-process group's global data axis (None: all rows are here)."""

    devices: tuple[torch.device, ...]
    model: int = 1
    data_offset: int = 0
    data_total: int | None = None

    @property
    def rows(self) -> int:
        """The data rows held here."""
        return len(self.devices) // self.model

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data_total or self.rows, MODEL_AXIS: self.model}


def _card(dev: torch.device) -> torch.device:
    """`dev` with its card index (a bare `cuda` is the current card)."""
    if dev.type != "cuda":
        return dev
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise ValueError(f"device cuda:{index} does not exist: the host has "
                         f"{torch.cuda.device_count()} card(s)")
    return torch.device("cuda", index)


def make_mesh(n_devices: int, device=None, model_parallel: int = 1) -> Mesh:
    """A [n_devices / model_parallel, model_parallel] mesh.

    device None or "cuda": the first n cards (ValueError when the host has
    fewer); "cpu": n shards on the CPU; a list: one device per shard, as
    given, row-major (repeats allowed).  A single card named by its index
    serves only a one-shard mesh."""
    if not isinstance(n_devices, int) or n_devices < 1:
        raise ValueError(f"a mesh needs n_devices >= 1, got {n_devices!r}")
    if not isinstance(model_parallel, int) or model_parallel < 1:
        raise ValueError(f"model_parallel must be an int >= 1, got {model_parallel!r}")
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices} devices not divisible by model_parallel={model_parallel}")
    mp = model_parallel
    if isinstance(device, (list, tuple)):
        devices = [_card(resolve_device(d)) for d in device]
        if len(devices) != n_devices:
            raise ValueError(f"{len(devices)} devices given for a mesh of {n_devices}")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a mesh's devices are all cuda or all cpu, got {devices}")
        return Mesh(tuple(devices), mp)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh((dev,) * n_devices, mp)
    if dev.type != "cuda":
        raise ValueError(f"a mesh runs on cuda or cpu devices, not {dev}")
    if dev.index is not None:
        if n_devices != 1:
            raise ValueError(f"{dev} is one card; give a list of {n_devices} devices")
        return Mesh((_card(dev),), mp)
    have = torch.cuda.device_count()
    if have < n_devices:
        what = (f"data_parallel={n_devices}" if mp == 1 else
                f"data_parallel={n_devices // mp} x model_parallel={mp}")
        raise ValueError(f"{what} needs {n_devices} cards; the host has {have}")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n_devices)), mp)


# The reference's state_specs (its mesh.py:47-67) as a table: per field,
# the mesh axis each dimension is cut over (None: whole), batched.
_LANE = (DATA_AXIS, MODEL_AXIS)
_LANE_PORT = (DATA_AXIS, MODEL_AXIS, None)
_REPL1 = (DATA_AXIS, None)
_REPL2 = (DATA_AXIS, None, None)
_SCALAR = (DATA_AXIS,)
_SPECS = NetworkState(
    acc=_LANE, bak=_LANE, acc_hi=_LANE, bak_hi=_LANE, pc=_LANE,
    port_val=_LANE_PORT, port_full=_LANE_PORT,
    hold_val=_LANE, holding=_LANE,
    stack_mem=_REPL2, stack_top=_REPL1,
    in_buf=_REPL1, in_rd=_SCALAR, in_wr=_SCALAR,
    out_buf=_REPL1, out_rd=_SCALAR, out_wr=_SCALAR,
    tick=_SCALAR, retired=_LANE,
)
LANE_FIELDS = frozenset(f for f, spec in zip(NetworkState._fields, _SPECS) if MODEL_AXIS in spec)


def state_specs(batched: bool = True) -> NetworkState:
    """Per field, the mesh axis each dimension is cut over, as the
    reference's PartitionSpecs read (`tuple(P(...))`): lane-major fields
    over `model`, the stacks, rings and `tick` replicated over it, the
    leading batch axis (when batched) over `data`."""
    return NetworkState(*(spec if batched else spec[1:] for spec in _SPECS))


def cut_shard(arr, spec, mesh: Mesh, d: int, m: int):
    """Shard (row d, column m) of `arr` under `spec`: its global row's batch
    slice along a `data` dimension, its lane slice along `model`."""
    rows = mesh.shape[DATA_AXIS]
    index = []
    for dim, axis in enumerate(spec):
        if axis is None:
            index.append(slice(None))
            continue
        size = arr.shape[dim]
        parts, which = (rows, mesh.data_offset + d) if axis == DATA_AXIS else (mesh.model, m)
        if size % parts:
            what = "batch" if axis == DATA_AXIS else "lanes"
            knob = "data_parallel" if axis == DATA_AXIS else "model_parallel"
            raise ValueError(f"{what} {size} not divisible by {knob}={parts}")
        step = size // parts
        index.append(slice(which * step, (which + 1) * step))
    return arr[tuple(index)]


def shard_state(state: NetworkState, mesh: Mesh, batched: bool = True) -> list[NetworkState]:
    """The shards of a global state this mesh holds, row-major, each an
    owned copy on its device: every field cut as `state_specs` says."""
    specs = state_specs(batched)
    shards = []
    for i, dev in enumerate(mesh.devices):
        d, m = divmod(i, mesh.model)
        shards.append(NetworkState(*(
            cut_shard(t, spec, mesh, d, m).to(dev, copy=True) for t, spec in zip(state, specs))))
    return shards


def gather_state(shards: list[NetworkState], mesh: Mesh | None = None,
                 batched: bool = True) -> NetworkState:
    """The inverse of `shard_state` over the rows held here: lane fields
    joined along the lanes, replicated fields from each row's first shard
    (`replicas_agree` checks the others), rows joined along the batch, as
    owned tensors on the CPU.  mesh=None: one shard per row."""
    mp = 1 if mesh is None else mesh.model
    parts = _fetch([t for shard in shards for t in shard])
    n = len(NetworkState._fields)
    fields = []
    for f, (name, spec) in enumerate(zip(NetworkState._fields, state_specs(batched))):
        per_shard = parts[f::n]
        rows = []
        for d in range(len(shards) // mp):
            row = per_shard[d * mp:(d + 1) * mp]
            rows.append(np.concatenate(row, axis=spec.index(MODEL_AXIS))
                        if name in LANE_FIELDS else row[0])
        fields.append(torch.from_numpy(np.concatenate(rows) if batched else rows[0]))
    return NetworkState(*fields)


def replicas_agree(shards: list[NetworkState], mesh: Mesh) -> list[str]:
    """The replicated fields whose model replicas differ in some row ([]
    when every replica equals its row's first), compared on the devices."""
    mp = mesh.model
    bad = []
    for f, name in enumerate(NetworkState._fields):
        if name in LANE_FIELDS:
            continue
        for d in range(0, len(shards), mp):
            head = shards[d][f]
            if not all(torch.equal(head, other[f].to(head.device))
                       for other in shards[d + 1:d + mp]):
                bad.append(name)
                break
    return bad


def build_lane_sharded_runner(step1, code, prog_len, mesh: Mesh, num_steps: int,
                              graph: bool | None = None):
    """fn(shards) -> shards: `num_steps` ticks of `step1` on every shard's
    lane slice, then the ring rebase; the scaffolding both lane-sharded
    engines share (parallel/routed.py and parallel/sharded.py differ only
    in `step1`).

    step1(code_local, prog_len_local, state, axis) is one tick of a shard's
    batched state as a generator that yields at each collective of `axis`,
    its member of its row's model axis (core/axis.py); every tick of every
    shard is driven by `core.axis.drive`, in this thread, on each device's
    current stream.

    graph (None: when every shard is on one card) records one tick of every
    shard as a CUDA graph at the first call for those shapes and replays it
    `num_steps` times: one launch a tick in place of the hundreds of ops the
    tick issues, which bound it otherwise (the ticks' ops and results are
    the same: the graph holds the state in buffers of its own, which each
    call fills from the shards and copies out of).  `fn.graphed` says
    which."""
    code = np.asarray(code, dtype=np.int32)
    prog_len = np.asarray(prog_len, dtype=np.int32)
    n_total = code.shape[0]
    mp = mesh.model
    if n_total % mp:
        raise ValueError(f"{n_total} lanes not divisible by model axis size {mp}")
    nl = n_total // mp
    tables, axes = [], []
    for i, dev in enumerate(mesh.devices):
        m = i % mp
        tables.append((torch.from_numpy(code[m * nl:(m + 1) * nl].copy()).to(dev),
                       torch.from_numpy(prog_len[m * nl:(m + 1) * nl].copy()).to(dev)))
        axes.append(Axis(m, mp))
    one_card = mesh.devices[0].type == "cuda" and len(set(mesh.devices)) == 1
    if graph is None:
        graph = one_card
    if graph and not one_card:
        raise ValueError(f"a graphed lane runner runs on one card, not {mesh.devices}")
    graphs: dict = {}  # shard shapes -> (the graph's state buffers, the graph)

    def tick(shards):
        return drive([step1(c, n, s, a) for (c, n), s, a in zip(tables, shards, axes)], mp)

    def run(shards: list[NetworkState]) -> list[NetworkState]:
        if len(shards) != len(mesh.devices):
            raise ValueError(f"{len(shards)} shards for a mesh of {len(mesh.devices)}")
        if not graph:
            for _ in range(num_steps):
                shards = tick(shards)
            return [rebase_rings(s) for s in shards]
        key = tuple(tuple(t.shape) for t in shards[0])
        if key not in graphs:
            graphs[key] = _record_tick(tick, shards, mesh.devices[0])
        bufs, g = graphs[key]
        for buf, s in zip(bufs, shards):
            for b, t in zip(buf, s):
                b.copy_(t)
        for _ in range(num_steps):
            g.replay()
        return [rebase_rings(NetworkState(*(b.clone() for b in buf))) for buf in bufs]

    run.mesh = mesh
    run.graphed = graph
    return run


def _record_tick(tick, shards: list[NetworkState], device: torch.device):
    """(state buffers, a CUDA graph of one `tick` of them that writes its
    result back into them).  The tick runs once first, outside the
    recording, as torch asks; the recording checks only this thread, so
    other threads' work on the card goes on."""
    bufs = [NetworkState(*(t.clone() for t in s)) for s in shards]
    here = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(here)
    with torch.cuda.stream(side):
        tick(bufs)
    here.wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        out = tick(bufs)
        for buf, o in zip(bufs, out):
            for b, t in zip(buf, o):
                if t is not b:
                    b.copy_(t)
    return bufs, g


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
    """A network compiled for a mesh: one CompiledNetwork per shard (its
    row's B/D instances, its column's lane slice, on its device), with
    CompiledNetwork's serving members (init_state, run, fused_runner,
    lane_runner, make_batched_serve, counters, read_packed, drain_batched)
    over the global batch of B.  States are lists of shard states
    (row-major); counters, feeds and slot numbers are global."""

    def __init__(self, net: CompiledNetwork, mesh: Mesh):
        d, mp = mesh.rows, mesh.model
        if net.batch % d:
            raise ValueError(f"batch {net.batch} not divisible by data_parallel={d}")
        if net.num_lanes % mp:
            raise ValueError(f"{net.num_lanes} lanes not divisible by model_parallel={mp}")
        b, nl = net.batch // d, net.num_lanes // mp
        self.mesh = mesh
        self.batch = net.batch
        self.nets = [
            dataclasses.replace(net, code=net.code[(i % mp) * nl:(i % mp + 1) * nl],
                                prog_len=net.prog_len[(i % mp) * nl:(i % mp + 1) * nl],
                                batch=b, device=dev)
            for i, dev in enumerate(mesh.devices)]
        self._heads = self.nets[::mp]  # each row's first shard
        self._cuts = [(r * b, (r + 1) * b) for r in range(d)]
        self.code, self.prog_len = net.code, net.prog_len
        self.num_stacks, self.stack_cap = net.num_stacks, net.stack_cap
        self.in_cap, self.out_cap = net.in_cap, net.out_cap
        self.device = mesh.devices[0]
        self._runners: dict = {}

    @property
    def num_lanes(self) -> int:
        return self.code.shape[0]

    def init_state(self) -> list[NetworkState]:
        return [net.init_state() for net in self.nets]

    def _row_cut(self, i: int) -> tuple[int, int]:
        return self._cuts[i // self.mesh.model]

    def fused_runner(self, num_steps: int, elide_dead_hi: bool | None = None):
        """The data-parallel kernel runner (make_dp_fused_runner); a mesh
        whose lanes are sharded has none (the reference's master.py:1359-1363
        refuses `engine="fused"` there)."""
        if self.mesh.model > 1:
            raise ValueError("model-parallel serving uses the routed engine "
                             "(engine='auto', 'scan', or 'gather')")
        return make_dp_fused_runner(self.nets, num_steps, elide_dead_hi)

    def lane_runner(self, num_steps: int, engine: str = "routed"):
        """The lane-sharded chunk runner of `engine`: "routed"
        (parallel/routed.py, two collectives a tick) or "gather"
        (parallel/sharded.py); built once per (ticks, engine)."""
        key = (num_steps, engine)
        run = self._runners.get(key)
        if run is None:
            from misaka_tpu_torch.parallel import routed, sharded

            if engine not in ("routed", "gather"):
                raise ValueError(f"lane engine must be routed|gather, got {engine!r}")
            make = routed.make_routed_runner if engine == "routed" else sharded.make_sharded_runner
            run = self._runners[key] = make(self.code, self.prog_len, self.mesh, num_steps)
        return run

    def run(self, shards: list[NetworkState], num_steps: int) -> list[NetworkState]:
        """`num_steps` ticks of every shard through the plain steps: each
        shard's tick loop on a data mesh, the routed runner on a lane
        mesh."""
        if self.mesh.model > 1:
            return self.lane_runner(num_steps)(shards)
        return [net.run(s, num_steps) for net, s in zip(self.nets, shards)]

    def feed_batched(self, shards: list[NetworkState], values, counts) -> list[NetworkState]:
        """CompiledNetwork.feed_batched over the shards: each row's rows of
        the global feed, written into every model replica of its rings."""
        return [net.feed_batched(s, values[a:b], counts[a:b])
                for i, (net, s) in enumerate(zip(self.nets, shards))
                for a, b in (self._row_cut(i),)]

    def make_batched_serve(self, runner, num_steps: int):
        """CompiledNetwork.make_batched_serve over the shards:

          serve_fn(shards, values [B, in_cap], counts [B]) -> (shards, packed)
          idle_fn(shards)                                  -> (shards, ctrs)

        serve_fn feeds every shard its row's rows of the global feed, runs
        `runner` and packs each row's first shard on its device (every
        replica's output ring drained alike); nothing waits, and `packed`
        is the list of rows that `read_packed` reads.  idle_fn's ctrs are
        the global [B, 4] counters, on the host."""
        heads = range(0, len(self.nets), self.mesh.model)

        def serve(shards, values, counts):
            out = runner(self.feed_batched(shards, values, counts))
            packs = [torch.cat([counters_of(out[i]), out[i].out_buf], dim=1) for i in heads]
            return [s._replace(out_rd=s.out_wr.clone()) for s in out], packs

        def idle(shards):
            shards = runner(shards)
            return shards, torch.from_numpy(np.concatenate(
                _fetch([counters_of(shards[i]) for i in heads])))

        return serve, idle

    def counters(self, shards: list[NetworkState]) -> np.ndarray:
        """[in_rd, in_wr, out_rd, out_wr] of every instance: [4, B]."""
        return np.concatenate(_fetch([counters_of(s) for s in shards[::self.mesh.model]])).T

    def read_packed(self, packed: list[torch.Tensor]):
        """serve_fn's packed rows as CompiledNetwork.read_packed gives
        them: (counters [4, B], [(global slot, values)])."""
        ctrs = np.concatenate(_fetch([p[:, :4] for p in packed]))
        return ctrs.T, self._gather_outputs([p[:, 4:] for p in packed], ctrs[:, 2], ctrs[:, 3])

    def drain_batched(self, shards: list[NetworkState], rd=None, wr=None):
        """CompiledNetwork.drain_batched over the shards (global rd/wr;
        every replica's out_rd advanced alike)."""
        if rd is None or wr is None:
            c = self.counters(shards)
            rd, wr = c[2], c[3]
        if (wr == rd).all():
            return shards, []
        outs = self._gather_outputs([s.out_buf for s in shards[::self.mesh.model]], rd, wr)
        wr = np.ascontiguousarray(wr, dtype=np.int32)
        shards = [s._replace(out_rd=torch.from_numpy(wr[a:b].copy()).to(net.device))
                  for i, (net, s) in enumerate(zip(self.nets, shards))
                  for a, b in (self._row_cut(i),)]
        return shards, outs

    def _gather_outputs(self, out_rows: list[torch.Tensor], rd, wr):
        """[(global slot, values)] for the instances with wr > rd: each
        row's active ring rows selected on its device, copied with one
        wait, then cut per instance on the host."""
        picks = []
        for net, rows, (a, b) in zip(self._heads, out_rows, self._cuts):
            active = np.flatnonzero(wr[a:b] > rd[a:b])
            if active.size:
                picks.append((a, active, rows[torch.from_numpy(active).to(net.device)]))
        outs = []
        for (a, active, _), host in zip(picks, _fetch([p[2] for p in picks])):
            got = CompiledNetwork.drain_from_snapshot(
                host, rd[a + active], wr[a + active], self.out_cap)
            outs.extend((a + int(active[i]), vals) for i, vals in got)
        return outs
