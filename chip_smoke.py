"""Chip smoke test of misaka_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from misaka_tpu_torch/csrc/ and holds it
against its plain torch version on the card: the full kernel with every
NetworkState field exactly equal (the state is all integers, so the
tolerance is zero), and the elided variant (MISAKA_FUSED_ELIDE_HI) with
every field exact except acc_hi/bak_hi of hi-dead lanes, which must keep
their entry values.  The data-parallel runner (the kernel launched once
per mesh shard, parallel/mesh.py) is held at the served shapes against its
plain version per shard and against one whole-batch launch, on two shards
of one card and, on a host with two or more cards, one shard per card.
Then it serves at B=262144 through `python -m misaka_tpu_torch.runtime.app`
and checks every answer:

- add2 on the default lane (the serve scheduler, striped /compute_raw and
  /compute_batch, 32 coalescing clients, a checkpoint saved and restored,
  /load and /reset);
- reverse_any with stack_cap=16, which must grow its stack to answer;
- add2 again under MISAKA_FUSED_ELIDE_HI=1, served by the elided variant;
- add2 again with MISAKA_DATA_PARALLEL set to the card count, the same
  drill on the mesh path;

and in process, two shards on cuda:0 (`MasterNode(device=["cuda:0",
"cuda:0"], data_parallel=2)`): a striped stream, checkpoints D=2 -> D=1 ->
D=2, and reverse_any's stack grown 16 -> 64.

The unbatched lane (one instance, each chunk one launch of the full kernel
on the batch-of-one view) is held against the plain loop on 17 networks
(128-tick chunks, and 2048 on add2 and reverse_any), also under
MISAKA_FUSED_ELIDE_HI=1; the app is booted with the reference README's env
(no MISAKA_BATCH) and drives /compute, 32 clients, /compute_raw,
/compute_batch, a checkpoint round trip, /load and /reset, with the
kernel's launches counted per iteration, and reverse_any unbatched grows
its stack; two traced servers (unbatched, and MISAKA_BATCH=4096 with
MISAKA_TRACE_INSTANCE=7) answer /debug/isa_trace, and the traced loop on
the card equals the CPU's.

The observability hooks are read on the card: add2 at B=262144 under 32 x
40 small requests through the /metrics delta (device-loop iterations,
which must equal the kernel's launches, chunk seconds, serve queue delay,
HTTP latency) and /debug/perfetto (time per tier), a /profile window that
must hold the kernel's CUDA events and the device loop's CPU ops and
splits an iteration into kernel, copy and host time, the same load with
MISAKA_TRACE_REQUESTS=0 (the tracing overhead); and the README env's B=1
serve call split into feed upload, checks and clones, kernel and packed
read, with the Server-Timing phases of quiet /compute.  Then add2 at
B=262144 again behind N frontend worker processes (MISAKA_HTTP_WORKERS,
runtime/frontends.py: the public port over SO_REUSEPORT, the engine fed
through the compute plane): the same loads through the public port, the
engine's iterations against the kernel's launches, plane frames, a
/profile split set beside the observability phase's, and no worker left
after the engine is terminated.  The `edge` phase arms the edge on the
same path behind the workers (API keys, a per-tenant quota, a token
secret): every typed 401/403/429 and its headers, recovery after
Retry-After, a minted token, the workers' shed counts booked by the
engine; admission shedding a flooding tenant's B-value bodies while a light
tenant's requests all pass; and the edge's cost, the default env against
MISAKA_EDGE=0 in turns a b b a, behind the workers and with none.  The
`registry` phase serves the same add2 with MISAKA_PROGRAMS_DIR behind the
workers, three tenants and the canary over MISAKA_REGISTRY_MAX_ACTIVE=3:
uploads, program-addressed compute behind the workers and direct,
evictions and revivals through checkpoints (a delay line's state carried
across each), a hot swap under 32 clients, the canary's tiers, device
memory released by an eviction (an in-process registry on the card), and
the registry's cost on the default program, a b b a.  The `telemetry`
phase serves the same add2 behind the workers with two tenants, an SLO
objective and a usage secret: the usage ledger's exact counts and its
conservation, the signed export through `usage-report`, a fault injected
on one tenant's serve passes paging that tenant only and clearing, a
capture exported and replayed on the card by `python -m misaka_tpu_torch
replay` (green for add2 and a serialized delay line, a divergent candidate
loud), the ?verify=replay deploy gate's swap and 409, anchors and the
shadow engine in device memory, an unbatched capture replayed, and the
planes' cost, a b b a.  The `observatory` phase serves the same add2
behind the workers with the always-on and durable planes armed
(MISAKA_TSDB_DIR, a 1 s collector, the capture spool rotating, the
watchdog's defaults and a page rule): the integral of /debug/series
against the /metrics counter, the sampler's and the collector's own cost
under load, the device-loop thread's folded stacks, the dashboard and the
flamegraph, the watchdog paging on an injected delay and clearing, a
rotation under a stream (and device memory across rotations in this
process), kill -9 and a relaunch over the same directory (series from
before the kill, the usage export monotone and conserving, the segment
rotated before the kill replayed green on the card), history restored
from a checkpoint alone, and the planes' cost, a b b a.  The `fleet`
phase serves the same add2 from MISAKA_FLEET=2 replicas behind the
workers (runtime/fleet.py) with a remote peer on a TCP plane in mTLS: a
quiescent roll whose restored states equal the roll checkpoints (device
memory per replica pid around it), the load's rate and each replica's
share of frames, the flooded tenant's admissions under usage gossip, the
peer served, refused in plaintext and rolled; on a second fleet beside
it the replica_kill fault, kill -9 of a replica and POST /fleet/roll
under load (zero client errors each), and last the fleet's cost against
one engine, a b b a.  The `model_parallel` phase runs, in process on a
mesh that repeats cuda:0, the lane-sharded engines (parallel/routed.py,
parallel/sharded.py) and the compact and chained one-device steps
(core/routing.py), each held field by field to the fused kernel's result
from the same state at B=262144; a `MasterNode(model_parallel=2)` on two
shards of the card serves add2 (a striped stream, checkpoints mp2 -> mp1
-> mp2, autogrow); and two processes of this script (`--mp-worker`) joined
through MISAKA_COORDINATOR run model=2 each, rank 0 verifying.  That path
launches no kernel.  The `native` phase runs the host C++ tier
(engine="native", core/native_serve.py) on the card's host: its
libraries built from the port's C++ copies with the host compiler, every
rung of its tick ladder exact against the kernel from the same state at
B=262144, the README env served natively beside the card's B=1 lane, a
4096-replica pool's striped stream, checkpoints native -> card -> native,
and a registry engine activating on the JIT rung.  The `native_edge`
phase puts the native C++ edge (csrc/native/frontend.cpp, the default
topology behind MISAKA_HTTP_WORKERS) on the public port in front of the
card's engine with a key file: the reference's parity corpus equal on the
edge and on the engine's own route table, MSK1 streams and small and
quiet /compute on the edge against the workers of the same boot (a b b a,
every answer checked), the edge's plane frames and the kernel's launches
against the loop's iterations, the native decimal codec against numpy
over a million values, and `auto` flipping to the host tier on the CPU
only.  The phases that measure the worker tier pin MISAKA_NATIVE_EDGE=0.
The `distributed` phase boots the reference's add2 network as four
processes of the per-process mode (runtime/nodes.py: a distributed master,
two program nodes, a stack node, speaking gRPC) and drives it over HTTP,
every answer checked (a value past int32 truncated by the sint32 wire),
with nvidia-smi showing no CUDA context of theirs; then Kahn-style random
networks (the reference's cross-mode generator) through a loopback cluster
of the port's nodes and through the kernel at B=1, their output streams
identical.  Where grpcio or protobuf does not import, the phase shows the
boot's refusal naming the missing package instead.  The servers of the
phases from main_path to frontends (the distributed network's four
processes among them) boot ahead, two at a time and paused, while the card
works on the parity phases (`preboot`).

Last it times the kernel and its variants at the served shapes and at
caps 1024, the data-parallel runner against the whole-batch launch, and
the B=1 chunk (kernel, plain loop, traced loop).  The plain version runs
once per network, state and tick count, and every variant from that
state (full, elided, data-parallel, the whole-batch launch) is held to
that one result.
Each phase prints one JSON line and a `split` line with its seconds (the
`done` line repeats them all); the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}

and is printed only when every phase passed.  With no CUDA device the
script exits non-zero before printing any result.  It imports torch, numpy
and misaka_tpu_torch only.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from http.client import HTTPException

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016

# H100 SXM peaks (NVIDIA data sheet): HBM3 at 3.35 TB/s; int32 at 132 SMs x
# 64 INT32 lanes x 1.98 GHz boost = 16.7e12 operations/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# A floor of int32 operations whatever the design, counted from the run's
# own work.  Every lane on every tick, parked or not: fetch its instruction
# (1), test its source for data (2), test its destination for room or win
# its arbitration (2).  Every committed instruction (the rise of `retired`)
# on top: the 64-bit register update (4: lo add, carry, hi add, select), the
# pc advance with wrap (3), the retired count (1), the hold latch clear (1).
# On a hi-dead lane under the elided variant the register update is the lo
# add alone (1), so a commit there costs 6.
OPS_PER_LANE_TICK = 5
OPS_PER_COMMIT = 9
OPS_PER_DEAD_COMMIT = 6

# The served configuration (add2, caps 128/128/16, 2048-tick chunks) and
# the kernel bench's batch.
MAIN_BATCH = 262144
MAIN_CHUNK = 2048
MAIN_CAPS = dict(in_cap=128, out_cap=128, stack_cap=16)
EXAMPLES = os.path.join(ROOT, "examples")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# --- parity helpers -------------------------------------------------------------


def random_program(rng, lane_names, stack_names, length):
    """A random TIS program over every opcode (the shape of
    tests/test_differential.py's generator, rebuilt here from a seed)."""
    lines = []
    srcs = ["ACC", "NIL", "R0", "R1", "R2", "R3", str(rng.integers(-50, 50))]

    def src():
        return srcs[rng.integers(len(srcs))]

    for _ in range(length):
        kind = rng.integers(12)
        if kind == 0:
            lines.append(rng.choice(["NOP", "SWP", "SAV", "NEG"]))
        elif kind == 1:
            lines.append(f"MOV {src()}, {rng.choice(['ACC', 'NIL'])}")
        elif kind == 2:
            lines.append(f"MOV {src()}, {rng.choice(lane_names)}:R{rng.integers(4)}")
        elif kind == 3:
            lines.append(f"ADD {src()}")
        elif kind == 4:
            lines.append(f"SUB {src()}")
        elif kind == 5:
            op = rng.choice(["JMP", "JEZ", "JNZ", "JGZ", "JLZ"])
            lines.append((op, int(rng.integers(length))))
        elif kind == 6:
            lines.append(f"JRO {rng.integers(-3, 4)}")
        elif kind == 7 and stack_names:
            lines.append(f"PUSH {src()}, {rng.choice(stack_names)}")
        elif kind == 8 and stack_names:
            lines.append(f"POP {rng.choice(stack_names)}, {rng.choice(['ACC', 'NIL'])}")
        elif kind == 9:
            lines.append(f"IN {rng.choice(['ACC', 'NIL'])}")
        elif kind == 10:
            lines.append(f"OUT {src()}")
        else:
            lines.append("NOP")
    needed = {l[1] for l in lines if isinstance(l, tuple)}
    out = []
    for i, l in enumerate(lines):
        prefix = f"l{i}: " if i in needed else ""
        out.append(prefix + (f"{l[0]} l{l[1]}" if isinstance(l, tuple) else l))
    return "\n".join(out)


def random_topology(seed, Topology, lanes=(1, 5), stack_cap=4, in_cap=8, out_cap=8):
    """A random network of lanes[0] to lanes[1] - 1 program lanes."""
    rng = np.random.default_rng(seed)
    n_lanes = int(rng.integers(*lanes))
    n_stacks = int(rng.integers(0, 3))
    lanes = [f"n{i}" for i in range(n_lanes)]
    stacks = [f"s{i}" for i in range(n_stacks)]
    node_info = {name: "program" for name in lanes}
    node_info.update({name: "stack" for name in stacks})
    programs = {
        name: random_program(rng, lanes, stacks, int(rng.integers(1, 9)))
        for name in lanes
    }
    return Topology(node_info=node_info, programs=programs,
                    stack_cap=stack_cap, in_cap=in_cap, out_cap=out_cap)


def seeded_inputs(net, rng, n_inputs, lo=-1000, hi=1000):
    """A fresh state with `n_inputs` random values queued per instance."""
    import torch

    s = net.init_state()
    k = min(n_inputs, net.in_cap)
    vals = rng.integers(lo, hi, size=(net.batch, k)).astype(np.int32)
    cols = torch.arange(k, device=net.device)
    return s._replace(
        in_buf=s.in_buf.index_copy(1, cols, torch.from_numpy(vals).to(net.device)),
        in_wr=s.in_wr + k,
    )


def with_random_hi(state, rng):
    """`state` with random acc_hi/bak_hi planes, so that a hi-dead lane's
    'keeps its entry value' is a real check."""
    import torch

    def plane(t):
        v = rng.integers(-(2**31), 2**31, size=tuple(t.shape), dtype=np.int64).astype(np.int32)
        return torch.from_numpy(v).to(t.device)

    return state._replace(acc_hi=plane(state.acc_hi), bak_hi=plane(state.bak_hi))


def held_to_plain(net, want, entry, elide):
    """The hi-dead lanes of the elided variant (elide=True), after holding
    `want` (the plain result, field -> array) to the contract: their
    acc_hi/bak_hi keep the `entry` values."""
    from misaka_tpu_torch.core import fused

    live = fused.hi_live_lanes(net.code, net.prog_len) if elide else [True] * net.num_lanes
    dead = [n for n, is_live in enumerate(live) if not is_live]
    for f in ("acc_hi", "bak_hi"):
        want[f][:, dead] = entry[f][:, dead]
    return dead


def diverged_fields(got, want):
    return [f for f in got if not np.array_equal(got[f], want[f])]


def max_abs_err(got, want):
    return max(
        int(np.abs(got[f].astype(np.int64) - want[f].astype(np.int64)).max(initial=0))
        for f in got
    )


# plain results shared across phases: (network, state, ticks) label -> plain_result
PLAIN = {}


def main_add2_state(net, rng):
    """add2's state at the main path's shapes, as phase_timings times it
    (phase_dp_parity holds its layouts to the same state and plain run)."""
    return with_random_hi(seeded_inputs(net, rng, MAIN_CAPS["in_cap"]), rng)


def plain_result(net, state, steps, key=None):
    """The plain version's result from `state` (field -> array) and its
    time (CUDA events, one call): computed once per (network, state,
    ticks) and held against every variant that starts from that state.
    With `key`, a later phase takes the same result from PLAIN."""
    if key is not None and key in PLAIN:
        return PLAIN[key]
    import torch

    from misaka_tpu_torch.core.state import state_to_numpy

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = net.run(state, steps, engine="dense")
    end.record()
    torch.cuda.synchronize()
    out = state_to_numpy(want), start.elapsed_time(end)
    if key is not None:
        PLAIN[key] = out
    return out


def compare(label, net, state, steps, elide=False, plain=None):
    """Kernel vs plain version from the same state.  The full kernel must
    give every field exactly; the elided variant (elide=True) every field
    but acc_hi/bak_hi of hi-dead lanes, which must equal their entry
    values.  Also checks the kernel left its input state untouched, and
    reports the plain version's time and the instructions the kernel
    committed (the rise of `retired`), in all and on hi-dead lanes.
    `plain` is a `plain_result` of the same (net, state, steps), shared
    with the other variants; without it the plain version runs here."""
    from misaka_tpu_torch.core.state import clone_state, state_to_numpy

    before = clone_state(state)
    got = net.fused_runner(steps, elide_dead_hi=elide)(state)
    want, plain_ms = plain if plain is not None else plain_result(net, state, steps)
    w = {f: a.copy() for f, a in want.items()}
    g, b0 = state_to_numpy(got), state_to_numpy(before)
    a0 = state_to_numpy(state)
    dead = held_to_plain(net, w, a0, elide)
    diverged = diverged_fields(g, w)
    touched = diverged_fields(a0, b0)
    err = max_abs_err(g, w)
    commits = (g["retired"] - a0["retired"]).astype(np.int64)
    row = {"case": label, "batch": net.batch, "lanes": net.num_lanes, "steps": steps,
           "elide": elide, "dead_lanes": len(dead),
           "exact": not diverged and not touched, "max_abs_err": err,
           "out_wr_min": int(g["out_wr"].min()),
           "stack_full": int((g["stack_top"] >= net.stack_cap).any(axis=1).sum()),
           "commits": int(commits.sum()), "dead_commits": int(commits[:, dead].sum()),
           "plain_ms": plain_ms}
    if diverged:
        row["diverged"] = diverged
    if touched:
        row["input_mutated"] = touched
    return row


def phase_parity(ticks=256):
    """The kernel against its plain version from the same seeded states:
    the baselines and the 16- and 32-lane pipelines at caps 8 and 1024
    (`ticks` ticks), deep stacks pushed and drained (310 and 320 ticks),
    and random networks over every opcode (96 ticks)."""
    from misaka_tpu_torch import networks
    from misaka_tpu_torch.runtime.topology import Topology

    rng = np.random.default_rng(SEED)
    rows = []
    for name, make in networks.BASELINE_CONFIGS.items():
        for cap in (8, 1024):
            net = make(in_cap=cap, out_cap=cap, stack_cap=cap).compile(batch=4096, device="cuda")
            rows.append(compare(f"{name}/cap{cap}", net, seeded_inputs(net, rng, 6), ticks))
    # the kernel's 16- and 32-lane builds (every network of 9-32 lanes)
    for n in (16, 32):
        for cap in (8, 1024):
            net = networks.pipeline(n, in_cap=cap, out_cap=cap, stack_cap=cap).compile(
                batch=4096, device="cuda")
            rows.append(compare(f"pipeline{n}/cap{cap}", net, seeded_inputs(net, rng, 6), ticks))
    # deep stacks (tests/test_fused.py:114-155 shapes): push to depth 100 ...
    push = Topology(node_info={"p": "program", "st": "stack"},
                    programs={"p": "IN ACC\nPUSH ACC, st\n"},
                    in_cap=104, out_cap=8, stack_cap=128).compile(batch=4096, device="cuda")
    rows.append(compare("deep_stack_push", push, seeded_inputs(push, rng, 100), 310))
    # ... and drain a prefilled depth-100 stack through OUT
    pop = Topology(node_info={"p": "program", "st": "stack"},
                   programs={"p": "POP st, ACC\nOUT ACC\n"},
                   in_cap=8, out_cap=104, stack_cap=128).compile(batch=4096, device="cuda")
    import torch

    s = pop.init_state()
    fill = torch.from_numpy(rng.integers(-1000, 1000, size=(4096, 1, 100)).astype(np.int32)).cuda()
    s = s._replace(
        stack_mem=torch.cat([fill, s.stack_mem[:, :, 100:]], dim=2),
        stack_top=torch.full_like(s.stack_top, 100),
    )
    rows.append(compare("deep_stack_pop", pop, s, 320))
    # random networks over every opcode (deadlocks are fine: state equality
    # after T ticks needs no liveness)
    for seed in range(48):
        net = random_topology(seed, Topology).compile(batch=2048, device="cuda")
        rows.append(compare(f"random/{seed}", net, seeded_inputs(net, rng, 6, -100, 100), 96))
    for seed in range(100, 112):
        net = random_topology(seed, Topology, lanes=(9, 33)).compile(batch=2048, device="cuda")
        rows.append(compare(f"random_wide/{seed}", net,
                            seeded_inputs(net, rng, 6, -100, 100), 96))
    return report_parity("parity", rows)


def report_parity(phase, rows, **extra):
    bad = [r for r in rows if not r["exact"]]
    emit({"phase": phase, "tolerance": "exact (integer state)", "cases": len(rows),
          "lanes": sorted({r["lanes"] for r in rows}),
          "dead_lanes": sorted({r["dead_lanes"] for r in rows}),
          "failed": bad, "max_abs_err": max(r["max_abs_err"] for r in rows), **extra})
    if bad:
        raise SystemExit(f"{phase}: kernel disagrees with its plain version on {len(bad)} case(s)")
    return max(r["max_abs_err"] for r in rows)


def mixed_seeds(Topology, fused, count, first=200):
    """The first `count` seeds from `first` up whose random network mixes
    hi-live and hi-dead lanes."""
    seeds, seed = [], first
    while len(seeds) < count:
        net = random_topology(seed, Topology, lanes=(2, 9)).compile(batch=1, device="cpu")
        live = fused.hi_live_lanes(net.code, net.prog_len)
        if any(live) and not all(live):
            seeds.append(seed)
        seed += 1
    return seeds


def phase_elided_parity(ticks=256):
    """The elided variant against the plain version, from states with
    random hi planes: the five baselines, overflow64 (hi-live: JLZ on a
    64-bit value), running_total and 8 random networks that mix hi-live and
    hi-dead lanes, at caps 8 and 1024."""
    from misaka_tpu_torch import networks
    from misaka_tpu_torch.core import fused
    from misaka_tpu_torch.runtime.topology import Topology

    rng = np.random.default_rng(SEED + 1)
    tops = dict(networks.BASELINE_CONFIGS)
    for ex in ("overflow64", "running_total"):
        with open(os.path.join(EXAMPLES, f"{ex}.json")) as f:
            text = f.read()
        tops[ex] = lambda text=text, **caps: Topology.from_json(text, **caps)
    for seed in mixed_seeds(Topology, fused, 8):
        tops[f"random_mixed/{seed}"] = lambda seed=seed, **caps: random_topology(
            seed, Topology, lanes=(2, 9), **caps)
    rows = []
    for name, make in tops.items():
        for cap in (8, 1024):
            net = make(in_cap=cap, out_cap=cap, stack_cap=cap).compile(batch=4096, device="cuda")
            state = with_random_hi(seeded_inputs(net, rng, 6, -(2**31), 2**31), rng)
            rows.append(compare(f"{name}/cap{cap}", net, state, ticks, elide=True))
    if not any(0 < r["dead_lanes"] < r["lanes"] for r in rows):
        raise SystemExit("elided parity: no case mixes hi-live and hi-dead lanes")
    return report_parity("elided_parity", rows)


def compare_dp(label, net, state, steps, devices, plain, elide=False):
    """The data-parallel runner, its shards on `devices` (one per shard,
    repeats allowed), and the single whole-batch launch, both held against
    `plain` (a `plain_result` of the whole batch from the same state,
    shared by every variant from it: instances are independent, so the
    plain version per shard is its rows of the whole batch's): every field
    exact (the elided variant: hi-dead lanes' acc_hi / bak_hi at their
    entry values).  Also checks that neither the state nor its shards were
    touched, and that the runner launched once per shard under
    fused.KERNEL_DP."""
    from misaka_tpu_torch.core import fused
    from misaka_tpu_torch.core.state import state_to_numpy
    from misaka_tpu_torch.parallel.mesh import (
        ShardedNetwork, gather_state, make_mesh, shard_state)

    mesh = make_mesh(len(devices), list(devices))
    sharded = ShardedNetwork(net, mesh)
    run = sharded.fused_runner(steps, elide_dead_hi=elide)
    entry = state_to_numpy(state)
    shards = shard_state(state, mesh)
    before = state_to_numpy(gather_state(shards))
    n0 = fused.launch_counts[fused.KERNEL_DP]
    got = state_to_numpy(gather_state(run(shards)))
    launches = fused.launch_counts[fused.KERNEL_DP] - n0
    whole = state_to_numpy(net.fused_runner(steps, elide_dead_hi=elide)(state))
    cards = sorted({d.index for d in mesh.devices})
    want = {f: a.copy() for f, a in plain[0].items()}
    dead = held_to_plain(net, want, entry, elide)
    diverged = diverged_fields(got, want)
    whole_diverged = diverged_fields(whole, want)
    touched = diverged_fields(state_to_numpy(state), entry) + diverged_fields(
        state_to_numpy(gather_state(shards)), before)
    commits = (got["retired"] - entry["retired"]).astype(np.int64)
    row = {"case": label, "batch": net.batch, "shards": len(devices), "cards": len(cards),
           "devices": [str(d) for d in mesh.devices], "lanes": net.num_lanes,
           "steps": steps, "elide": elide, "variant": run.variant, "dead_lanes": len(dead),
           "launches": launches,
           "exact": not diverged and not whole_diverged and not touched
           and launches == len(devices),
           "max_abs_err": max(max_abs_err(got, want), max_abs_err(whole, want)),
           "out_wr_min": int(got["out_wr"].min()),
           "stack_full": int((got["stack_top"] >= net.stack_cap).any(axis=1).sum()),
           "commits": int(commits.sum()), "dead_commits": int(commits[:, dead].sum()),
           "plain_ms": plain[1]}
    if diverged:
        row["diverged_from_plain"] = diverged
    if whole_diverged:
        row["whole_batch_launch_diverged_from_plain"] = whole_diverged
    if touched:
        row["input_mutated"] = touched
    return row


def reverse_any_state(net, rng):
    """reverse_any with a full input ring per instance (MAIN_CAPS' 128
    values) and the 0 sentinel at a seeded position or nowhere, so that in
    one 2048-tick chunk some instances fill the stack and park on it and
    others dump and drain theirs."""
    import torch

    n = net.in_cap
    vals = rng.integers(1, 1000, size=(net.batch, n)) * rng.choice([-1, 1], size=(net.batch, n))
    sentinel = rng.integers(0, n + 1, size=net.batch)  # n: no sentinel in the stream
    has = sentinel < n
    vals[np.flatnonzero(has), sentinel[has]] = 0
    s = net.init_state()
    return s._replace(in_buf=torch.from_numpy(vals.astype(np.int32)).to(net.device),
                      in_wr=torch.full_like(s.in_wr, n))


def phase_dp_parity(batch=MAIN_BATCH, chunk=MAIN_CHUNK):
    """The data-parallel runner (misaka_tpu/runtime/master.py:1438's port)
    at the served shapes: two shards on cuda:0, and one shard per card when
    the host has two or more, on add2, reverse_any (streams that fill its
    stack) and a random network that mixes hi-live and hi-dead lanes, plus
    add2 through the elided variant (HI_DEAD) on two shards.  Each network
    and state runs the plain version once (the whole batch), and every
    layout and variant from that state is held to it; add2's state is the
    one phase_timings times and reverse_any's the one reverse_any_parity
    holds at cap 16, so those phases take these plain runs (PLAIN)."""
    import torch

    from misaka_tpu_torch import networks
    from misaka_tpu_torch.core import fused
    from misaka_tpu_torch.runtime.topology import Topology

    rng = np.random.default_rng(SEED + 4)
    with open(os.path.join(EXAMPLES, "reverse_any.json")) as f:
        reverse_any = Topology.from_json(f.read(), **MAIN_CAPS)
    mixed_seed = mixed_seeds(Topology, fused, 1)[0]
    cards = torch.cuda.device_count()
    layouts = [["cuda:0"] * 2] + ([[f"cuda:{i}" for i in range(cards)]] if cards >= 2 else [])
    rows = []
    for name, top in (("add2", networks.add2(**MAIN_CAPS)), ("reverse_any", reverse_any),
                      (f"random_mixed/{mixed_seed}", random_topology(
                          mixed_seed, Topology, lanes=(2, 9), **MAIN_CAPS))):
        net = top.compile(batch=batch, device="cuda")
        key = ({"add2": "add2/main", "reverse_any": "reverse_any/cap16"}.get(name)
               if (batch, chunk) == (MAIN_BATCH, MAIN_CHUNK) else None)
        if name == "add2":  # phase_timings' state: its plain run is this one
            state = main_add2_state(net, np.random.default_rng(SEED))
        elif name == "reverse_any":  # reverse_any_parity's cap16 state, likewise
            state = reverse_any_state(net, np.random.default_rng(SEED + 3))
        else:
            state = with_random_hi(seeded_inputs(net, rng, net.in_cap, -100, 100), rng)
        # the random network at 512 ticks (was the chunk: a depth cut; the
        # shared states keep the chunk their phases read)
        ticks = chunk if name in ("add2", "reverse_any") else min(chunk, 512)
        plain = plain_result(net, state, ticks, key)  # one plain run per network and state
        for devices in layouts:
            rows.append(compare_dp(f"{name}/{len(devices)}x{len(set(devices))}card",
                                   net, state, ticks, devices, plain))
        if name == "add2":
            rows.append(compare_dp("add2/elided/2x1card", net, state, chunk, layouts[0],
                                   plain, elide=True))
        if name == "reverse_any" and not 0 < rows[-1]["stack_full"] < batch:
            rows[-1]["exact"] = False
            rows[-1]["why"] = f"{rows[-1]['stack_full']} of {batch} instances filled the stack"
        del net, state, plain
    multi = "run" if cards >= 2 else "not run"
    err = report_parity("dp_parity", rows, cards=cards, multi_card=multi,
                        variants=sorted({r["variant"] for r in rows}),
                        detail=[{k: r[k] for k in ("case", "variant", "launches", "stack_full",
                                                   "commits", "plain_ms")} for r in rows])
    return err, rows


# --- unbatched serving: the kernel on the batch-of-one view ---------------------------


def compare_unbatched(label, net, state, values, count, steps):
    """An unbatched `serve_chunk` through the kernel (engine="auto" on the
    card: one launch of the full fused_superstep on the batch-of-one view)
    against `serve_chunk(engine="scan")`, the plain loop on the same card,
    from the same state with the same feed: the packed snapshot and every
    NetworkState field exact (shapes included), the input state untouched,
    and exactly one launch, counted under fused_superstep.  Returns the row
    and the kernel's state (to chain chunks).  The plain version's time is
    CUDA events around its one call."""
    import torch

    from misaka_tpu_torch.core import fused
    from misaka_tpu_torch.core.state import clone_state, state_to_numpy

    before = clone_state(state)
    n0 = dict(fused.launch_counts)
    got, got_packed = net.serve_chunk(state, values, count, steps)
    torch.cuda.synchronize()
    launched = {k: fused.launch_counts[k] - n0[k] for k in n0}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want, want_packed = net.serve_chunk(state, values, count, steps, engine="scan")
    end.record()
    torch.cuda.synchronize()
    g, w = state_to_numpy(got), state_to_numpy(want)
    g["packed"], w["packed"] = got_packed.cpu().numpy(), want_packed.cpu().numpy()
    a0, b0 = state_to_numpy(state), state_to_numpy(before)
    same_shape = [f for f in g if g[f].shape == w[f].shape]
    diverged = [f for f in g if f not in same_shape or not np.array_equal(g[f], w[f])]
    touched = diverged_fields(a0, b0)
    one_full = launched == {k: int(k == fused.KERNEL) for k in n0}
    row = {"case": label, "lanes": net.num_lanes, "steps": steps, "fed": int(count),
           "exact": not diverged and not touched and one_full,
           "max_abs_err": max_abs_err({f: g[f] for f in same_shape},
                                      {f: w[f] for f in same_shape}),
           "out_wr": int(g["out_wr"]), "stack_full": int((g["stack_top"] >= net.stack_cap).any()),
           "commits": int((g["retired"] - a0["retired"]).astype(np.int64).sum()),
           "launches": launched, "plain_ms": start.elapsed_time(end)}
    if diverged:
        row["diverged"] = diverged
    if touched:
        row["input_mutated"] = touched
    return row, got


def unbatched_networks():
    """name -> Topology for the unbatched parity: add2, reverse_any at
    stack_cap=4 (streams fill its stack), overflow64 (64-bit registers),
    mesh8 and pipeline32 (the 8- and 32-lane builds) and 12 seeded random
    networks over every opcode."""
    from misaka_tpu_torch import networks
    from misaka_tpu_torch.runtime.topology import Topology

    caps = dict(in_cap=16, out_cap=16, stack_cap=8)
    tops = {"add2": networks.add2(**caps)}
    with open(os.path.join(EXAMPLES, "reverse_any.json")) as f:
        tops["reverse_any/stack4"] = Topology.from_json(f.read(), **dict(caps, stack_cap=4))
    with open(os.path.join(EXAMPLES, "overflow64.json")) as f:
        tops["overflow64"] = Topology.from_json(f.read(), **caps)
    tops["mesh8"] = networks.mesh8(**caps)
    tops["pipeline32"] = networks.pipeline(32, **caps)
    for seed in range(300, 312):
        tops[f"random/{seed}"] = random_topology(seed, Topology, lanes=(1, 9))
    return tops


LONG_CHUNK_NETWORKS = ("add2", "reverse_any/stack4")


def phase_unbatched_parity(chunks=(128, 2048)):
    """Unbatched serve_chunk on the card (the kernel) against
    serve_chunk(engine="scan") (the plain loop), chunk after chunk from the
    same states, each chunk with a seeded feed: every network a 128-tick
    chunk, then those of LONG_CHUNK_NETWORKS a 2048-tick one (the plain
    loop at B=1 costs about 3.5 ms a tick on the card, so the long chunk is
    cut to those two).  Then a 128-tick chunk of every network again
    under MISAKA_FUSED_ELIDE_HI=1, from states with random hi planes, where
    the unbatched path must still launch the full kernel (the reference's
    unbatched path has no elided variant) and every hi plane must follow
    the plain version."""
    from misaka_tpu_torch.core import fused

    rng = np.random.default_rng(SEED + 6)
    rows = []
    saved = os.environ.get("MISAKA_FUSED_ELIDE_HI")
    try:
        for elide in (False, True):
            if elide:
                os.environ["MISAKA_FUSED_ELIDE_HI"] = "1"
            for name, top in unbatched_networks().items():
                net = top.compile(device="cuda")
                state = net.init_state()
                if elide:
                    state = with_random_hi(state, rng)
                long = not elide and name in LONG_CHUNK_NETWORKS
                for steps in chunks if long else chunks[:1]:
                    vals = rng.integers(-(2**31), 2**31, size=net.in_cap,
                                        dtype=np.int64).astype(np.int32)
                    free = net.in_cap - int(state.in_wr - state.in_rd)
                    row, state = compare_unbatched(
                        f"{name}/{steps}" + ("/elide_env" if elide else ""), net, state,
                        vals, int(rng.integers(1, free + 1)) if free else 0, steps)
                    rows.append(dict(row, elide_env=elide,
                                     dead_lanes=net.num_lanes - sum(
                                         fused.hi_live_lanes(net.code, net.prog_len))))
    finally:
        if saved is None:
            os.environ.pop("MISAKA_FUSED_ELIDE_HI", None)
        else:
            os.environ["MISAKA_FUSED_ELIDE_HI"] = saved
    if not any(r["elide_env"] and r["dead_lanes"] for r in rows):
        raise SystemExit("unbatched parity: no hi-dead lane under MISAKA_FUSED_ELIDE_HI=1")
    return report_parity("unbatched_parity", rows, batch=None, chunks=list(chunks),
                         plain_ms={r["case"]: r["plain_ms"] for r in rows})


# --- the main path over HTTP ------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(port, path, data=None, headers=None, timeout=300):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def post_form(port, path, **fields):
    from urllib.parse import urlencode

    return http(port, path, urlencode(fields).encode())


def status(port):
    return json.loads(http(port, "/status", timeout=60)[1])


def expect(cond, what):
    if not cond:
        raise SystemExit(f"main path check failed: {what}")


def wrap_i32(x):
    return (np.asarray(x, np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


ADD2_NODES = {"misaka1": {"type": "program"}, "misaka2": {"type": "program"},
              "misaka3": {"type": "stack"}}


def _start_app(label, node_info, programs, batch, chunk, caps, device=None, autorun=True,
               **env_extra):
    """Spawn `python -m misaka_tpu_torch.runtime.app`: (Popen, port, t_boot).
    MISAKA_PORT among the extra env pins the port, else a free one."""
    port = int(env_extra.pop("MISAKA_PORT", 0)) or free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("MISAKA_")}
    env.update(
        NODE_INFO=json.dumps(node_info), MISAKA_PROGRAMS=json.dumps(programs),
        MISAKA_PORT=str(port), PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""),
        **env_extra,
    )
    for name, value in (("MISAKA_BATCH", batch), ("MISAKA_CHUNK_STEPS", chunk),
                        *(((f"MISAKA_{k.upper()}", v) for k, v in caps.items()) if caps else ())):
        if value is not None:
            env[name] = str(value)
    if autorun:
        env["MISAKA_AUTORUN"] = "1"
    if device is not None:
        env["MISAKA_DEVICE"] = device
    log_path = os.path.join(ROOT, "build", f"chip_smoke_{label}.log")
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    t_boot = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "misaka_tpu_torch.runtime.app"],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
        )
    return proc, port, t_boot


def _await_app(label, proc, port, autorun=True):
    """Wait until the server runs (autorun=False: until it answers,
    paused); /healthz needs no key, whatever the edge asks of others."""
    deadline = time.monotonic() + 240
    while True:
        expect(proc.poll() is None, f"{label}: server exited early (rc {proc.returncode})")
        try:
            # .get: a native edge answers {"ok": true} until its first push
            if json.loads(http(port, "/healthz", timeout=60)[1]).get("running") or not autorun:
                return
        except (urllib.error.URLError, ConnectionError, OSError):
            pass
        expect(time.monotonic() < deadline, f"{label}: server not ready within 240 s")
        time.sleep(0.5)


def _stop_app(proc):
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


# Servers of later phases booted ahead (preboot), paused: label ->
# (spec, [Popen], port, t_boot, {"ready": t}); PREBOOT_QUEUE holds the
# (label, spec, starter) not started yet.  PREBOOT_LOCK guards both.
PREBOOTED: dict = {}
PREBOOT_QUEUE: list = []
PREBOOT_LOCK = threading.Lock()
# boots at a time: all 11 at once took ~24 s each and slowed the parity
# phases beside them by a third
PREBOOT_PARALLEL = 2


def _start_paused(spec):
    proc, port, t_boot = _start_app(**dict(spec, autorun=False))
    return [proc], port, t_boot


def preboot(items) -> None:
    """Boot the servers of later phases ahead, paused whatever their spec
    says, PREBOOT_PARALLEL at a time in phase order (each waits until the one
    before it answers), so that the boots overlap the card work before
    those phases without crowding it.  `items`: app specs (served_app's
    arguments as a dict, `label` first), or (label, starter) pairs whose
    starter returns ([Popen], port, t_boot).  served_apps takes a
    prebooted app whose spec is equal to its own and /run-s it when the
    spec asks for autorun; a label still queued when its phase comes is
    booted by the phase.  A paused app runs no device loop: it launches
    nothing before its phase."""
    import atexit

    atexit.register(stop_prebooted)  # a phase failed before taking its app
    with PREBOOT_LOCK:
        for item in items:
            if isinstance(item, dict):
                PREBOOT_QUEUE.append((item["label"], dict(item), _start_paused))
            else:
                PREBOOT_QUEUE.append((item[0], None, item[1]))

    def worker():
        while True:
            with PREBOOT_LOCK:
                if not PREBOOT_QUEUE:
                    break
                label, spec, starter = PREBOOT_QUEUE.pop(0)
                procs, port, t_boot = starter() if spec is None else starter(spec)
                box: dict = {}
                PREBOOTED[label] = (spec, procs, port, t_boot, box)
            while all(p.poll() is None for p in procs) and "ready" not in box:
                try:
                    http(port, "/healthz", timeout=10)
                    box["ready"] = time.perf_counter()
                except (urllib.error.URLError, ConnectionError, OSError):
                    time.sleep(0.25)
        # park, never return: the app's parent-death signal (lifecycle's
        # PR_SET_PDEATHSIG) fires when the THREAD that forked it ends
        threading.Event().wait()

    for _ in range(PREBOOT_PARALLEL):
        threading.Thread(target=worker, daemon=True).start()


def take_prebooted(label):
    """`label`'s prebooted entry, out of the pool; None when it is not
    prebooted (a label still queued leaves the queue: the phase boots it)."""
    with PREBOOT_LOCK:
        PREBOOT_QUEUE[:] = [item for item in PREBOOT_QUEUE if item[0] != label]
        return PREBOOTED.pop(label, None)


def stop_prebooted() -> None:
    """Stop every prebooted server no phase took (a phase failed first)."""
    with PREBOOT_LOCK:
        PREBOOT_QUEUE.clear()
        entries = list(PREBOOTED.values())
        PREBOOTED.clear()
    for entry in entries:
        for proc in entry[1]:
            _stop_app(proc)


@contextlib.contextmanager
def served_apps(specs, procs=None):
    """Boot several apps at once (each spec: served_app's arguments as a
    dict, `label` first), or take them from `preboot`, wait until all run,
    yield [(port, boot seconds)]; stop them all on the way out.  `procs`,
    a list, gets the Popens."""
    started, ahead = [], []
    try:
        for spec in specs:
            pre = take_prebooted(spec["label"])
            if pre is not None:
                if pre[0] != spec:
                    _stop_app(pre[1][0])
                    raise SystemExit(f"{spec['label']}: prebooted with another spec")
                started.append((pre[1][0], pre[2], pre[3]))
            else:
                started.append(_start_app(**spec))
            ahead.append(pre[4] if pre is not None else None)
            if procs is not None:
                procs.append(started[-1][0])
        out = []
        for spec, (proc, port, t_boot), box in zip(specs, started, ahead):
            autorun = spec.get("autorun", True)
            if box is None:
                _await_app(spec["label"], proc, port, autorun)
                out.append((port, time.perf_counter() - t_boot))
                continue
            _await_app(spec["label"], proc, port, autorun=False)
            if autorun:
                expect(post_form(port, "/run") == (200, b"Success"), f"{spec['label']}: /run")
                _await_app(spec["label"], proc, port, autorun=True)
            out.append((port, box.get("ready", time.perf_counter()) - t_boot))
        yield out
    finally:
        for proc, _, _ in started:
            _stop_app(proc)


@contextlib.contextmanager
def served_app(label, node_info, programs, batch, chunk, caps, device=None, autorun=True,
               procs=None, **env_extra):
    """Boot `python -m misaka_tpu_torch.runtime.app`, wait until it runs
    (autorun=False: until it answers, paused), yield (port, boot seconds);
    stop it on the way out.  batch, chunk or caps None leave the variable
    unset, as the reference README's quickstart does.  `procs`, a list,
    gets the server's Popen."""
    spec = dict(label=label, node_info=node_info, programs=programs, batch=batch, chunk=chunk,
                caps=caps, device=device, autorun=autorun, **env_extra)
    with served_apps([spec], procs=procs) as [(port, boot_s)]:
        yield port, boot_s


def run_clients(n, target):
    """Run target(i) on n threads; returns (errors, seconds)."""
    errors = []

    def wrap(i):
        try:
            target(i)
        except Exception as e:  # recorded and failed by the caller
            errors.append(repr(e))

    t = time.perf_counter()
    threads = [threading.Thread(target=wrap, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if any(th.is_alive() for th in threads):
        errors.append("a client thread did not finish within 300 s")
    return errors, time.perf_counter() - t


def check_raw(port, vals, query="", want=None):
    t = time.perf_counter()
    code, body = http(port, "/compute_raw" + query, vals.astype("<i4").tobytes())
    secs = time.perf_counter() - t
    want = wrap_i32(vals.astype(np.int64) + 2) if want is None else want
    expect(code == 200 and np.array_equal(np.frombuffer(body, "<i4"), want),
           f"/compute_raw{query} answers differ")
    return secs


def phase_dir(name, fresh=True) -> str:
    """build/chip_<name>: a fixed path, so that the env of an app booted
    ahead (preboot) names the directory its phase makes fresh later."""
    path = os.path.join(ROOT, "build", f"chip_{name}")
    if fresh:
        shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path)
    return path


def main_path_spec(batch=MAIN_BATCH, chunk=MAIN_CHUNK, device=None, data_parallel=None):
    """The app of phase_main_path: add2 on the default lane, checkpoints
    armed (and MISAKA_DATA_PARALLEL with data_parallel)."""
    from misaka_tpu_torch.networks import ADD2_PROGRAMS

    label = "dp" if data_parallel else "main"
    env = {"MISAKA_CHECKPOINT_DIR": phase_dir(f"ckpt_{label}", fresh=False)}
    if data_parallel:
        env["MISAKA_DATA_PARALLEL"] = str(data_parallel)
    return dict(label=label, node_info=ADD2_NODES, programs=ADD2_PROGRAMS, batch=batch,
                chunk=chunk, caps=MAIN_CAPS, device=device, **env)


def phase_main_path(batch=MAIN_BATCH, chunk=MAIN_CHUNK, n_raw=100_000, n_latency=100,
                    device=None, data_parallel=None):
    """Serve add2 on the default lane through the app entry point and check
    every answer.  data_parallel=D serves it on a mesh of D devices
    (MISAKA_DATA_PARALLEL: on the card, D distinct cards), every chunk one
    launch per shard under fused_superstep_dp.  device="cpu" (with a small
    batch, chunk and n_raw) rehearses this phase without a card, through
    the plain version."""
    spec = main_path_spec(batch, chunk, device, data_parallel)
    ckpt_dir = phase_dir(f"ckpt_{spec['label']}")
    try:
        with served_apps([spec]) as [(port, boot_s)]:
            row = drive_main_path(port, batch, chunk, n_raw, n_latency, device, ckpt_dir,
                                  data_parallel)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    row["boot_s"] = boot_s
    emit(row)
    return row


def drive_main_path(port, batch, chunk, n_raw, n_latency, device, ckpt_dir,
                    data_parallel=None):
    key = "fused_superstep_dp" if data_parallel else "fused_superstep"
    per_iteration = data_parallel or 1  # launches per device-loop iteration
    st = status(port)
    launches_at_ready = st["kernel_launches"][key]
    # sequential /compute on a quiet server: the latency samples (the first
    # one also pays the server's first-request warm-up)
    lat = []
    for v in [5, -3, 0, 999] + list(range(-48, 48))[: n_latency - 4]:
        t = time.perf_counter()
        code, body = post_form(port, "/compute", value=str(v))
        lat.append(time.perf_counter() - t)
        expect(code == 200 and json.loads(body) == {"value": v + 2},
               f"/compute {v} -> {code} {body!r}")
    steady = np.sort(np.asarray(lat[1:]))

    # /compute_raw of n_raw values: striped (the default), then pinned
    rng = np.random.default_rng(SEED)
    vals = rng.integers(-(2**31), 2**31, size=n_raw, dtype=np.int64).astype(np.int32)
    striped_s = check_raw(port, vals)
    pinned_s = check_raw(port, vals, "?spread=0")

    # /compute_batch, pinned and spread
    batch_vals = rng.integers(-10**6, 10**6, size=n_raw // 20).astype(np.int32)
    text = ",".join(map(str, batch_vals.tolist()))
    for spread in ("0", "1"):
        code, body = post_form(port, "/compute_batch", values=text, spread=spread)
        expect(code == 200 and json.loads(body)["values"] == (batch_vals + 2).tolist(),
               f"/compute_batch spread={spread}")

    # many clients, many small /compute requests each: they coalesce
    st = status(port)
    passes0, reqs0 = st["serve_passes"], st["requests_total"]
    iters0 = sum(st["kernel_launches"].values())  # one launch per loop iteration
    n_small, per_small = 32, 40

    def small_client(i):
        for j in range(per_small):
            v = i * 10_000 + j
            c, b = post_form(port, "/compute", value=str(v))
            if c != 200 or json.loads(b) != {"value": v + 2}:
                raise RuntimeError(f"/compute {v} -> {c} {b!r}")

    errors, small_s = run_clients(n_small, small_client)
    expect(not errors, f"small-request clients: {errors[:4]}")
    st = status(port)
    passes = st["serve_passes"] - passes0
    requests = st["requests_total"] - reqs0
    small_iters = (sum(st["kernel_launches"].values()) - iters0) // per_iteration
    expect(0 < passes < requests == n_small * per_small,
           f"small requests did not coalesce: {passes} passes for {requests} requests")

    # served throughput: 32 clients each streaming /compute_raw (striped and
    # coalesced by the scheduler)
    n_clients, per_client = 32, n_raw // 8
    streams = [rng.integers(-(2**30), 2**30, size=per_client).astype("<i4")
               for _ in range(n_clients)]
    errors, thr_s = run_clients(n_clients, lambda i: check_raw(port, streams[i]))
    expect(not errors, f"throughput clients: {errors[:4]}")

    # /checkpoint, more traffic, /restore, /run: the answers stay right
    t = time.perf_counter()
    expect(post_form(port, "/checkpoint", name="c1") == (200, b"Success"), "/checkpoint")
    save_s = time.perf_counter() - t
    ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir, "c1.npz"))
    check_raw(port, np.arange(-1000, 1000, dtype=np.int32))
    t = time.perf_counter()
    expect(post_form(port, "/restore", name="c1") == (200, b"Success"), "/restore")
    restore_s = time.perf_counter() - t
    expect(not status(port)["running"], "the network runs after /restore")
    expect(post_form(port, "/run")[0] == 200, "/run after /restore")
    code, body = post_form(port, "/compute", value="41")
    expect(json.loads(body) == {"value": 43}, f"after /restore: {body!r}")
    check_raw(port, vals[:20_000])

    # /load a new misaka1 program (answer v + 11), /run, check
    new_prog = "IN ACC\nADD 10\nMOV ACC, misaka2:R0\nMOV R0, ACC\nOUT ACC\n"
    code, body = post_form(port, "/load", targetURI="misaka1", program=new_prog)
    expect(code == 200 and body == b"Success", f"/load -> {code} {body!r}")
    expect(post_form(port, "/run")[0] == 200, "/run after /load")
    code, body = post_form(port, "/compute", value="5")
    expect(json.loads(body) == {"value": 16}, f"after /load: {body!r}")
    vs = np.arange(-500, 500, dtype=np.int32)
    check_raw(port, vs, want=vs + 11)

    # /reset stops and zeroes; /run again serves
    expect(post_form(port, "/reset") == (200, b"Success"), "/reset")
    st = status(port)
    expect(not st["running"] and st["tick"] == 0, f"status after reset: {st}")
    expect(post_form(port, "/run")[0] == 200, "/run after /reset")
    code, body = post_form(port, "/compute", value="-7")
    expect(json.loads(body) == {"value": 4}, f"after /reset: {body!r}")

    st = status(port)
    launches = st["kernel_launches"]
    want_engine = "native" if device == "cpu" else "fused"  # auto on the CPU: native
    expect(st["engine"] == want_engine and st["device"].startswith(device or "cuda"),
           f"engine {st['engine']} on {st['device']}")
    expect(device == "cpu" or (launches[key] > 0
                               and all(n == 0 for k, n in launches.items() if k != key)),
           f"main path launches: {launches}")
    mesh = st.get("mesh")
    expect(mesh == ({"data": data_parallel, "model": 1} if data_parallel else None),
           f"/status mesh {mesh}")
    return {
        "phase": "dp_path" if data_parallel else "main_path", "mesh": mesh,
        "batch": batch, "chunk_steps": chunk,
        **MAIN_CAPS, "engine": st["engine"], "device": st["device"],
        "kernel_launches": launches, "kernel_launches_at_ready": launches_at_ready,
        "compute_latency_samples": len(steady),
        "compute_latency_first_s": lat[0],
        "compute_latency_p50_s": float(np.percentile(steady, 50)),
        "compute_latency_p90_s": float(np.percentile(steady, 90)),
        "compute_latency_max_s": float(steady[-1]),
        "compute_raw_values": int(vals.size),
        "compute_raw_striped_s": striped_s,
        "compute_raw_striped_values_per_s": vals.size / striped_s,
        "compute_raw_pinned_s": pinned_s,
        "compute_raw_pinned_values_per_s": vals.size / pinned_s,
        "small_clients": n_small, "small_requests": requests, "small_s": small_s,
        "small_requests_per_s": requests / small_s, "serve_passes": passes,
        "small_loop_iterations": small_iters,
        "throughput_clients": n_clients, "throughput_values": n_clients * per_client,
        "throughput_s": thr_s, "served_values_per_s": n_clients * per_client / thr_s,
        "checkpoint_bytes": ckpt_bytes, "checkpoint_save_s": save_s,
        "checkpoint_restore_s": restore_s,
    }


def reverse_any_parity(text, batch, chunk):
    """The kernel against its plain version on reverse_any at the served
    shapes, at stack_cap 16 (where the phase starts) and 64 (where it grows
    to): one chunk from 128 queued values per instance, with the 0 sentinel
    at a seeded position or nowhere, so that some instances fill the stack
    and park on it and others dump and drain theirs."""
    from misaka_tpu_torch.runtime.topology import Topology

    rows = []
    for cap in (16, 64):
        net = Topology.from_json(text, **dict(MAIN_CAPS, stack_cap=cap)).compile(
            batch=batch, device="cuda")
        # the same streams at both caps; at cap 16 phase_dp_parity's plain run
        state = reverse_any_state(net, np.random.default_rng(SEED + 3))
        key = f"reverse_any/cap{cap}" if (batch, chunk) == (MAIN_BATCH, MAIN_CHUNK) else None
        row = compare(f"reverse_any/cap{cap}", net, state, chunk,
                      plain=plain_result(net, state, chunk, key))
        PLAIN.pop(key, None)
        if not 0 < row["stack_full"] < batch:
            row["exact"] = False
            row["why"] = f"{row['stack_full']} of {batch} instances filled the stack"
        rows.append(row)
    return report_parity("autogrow_parity", rows), [
        {k: r[k] for k in ("case", "stack_full", "commits", "plain_ms")} for r in rows]


def autogrow_spec(batch=MAIN_BATCH, chunk=MAIN_CHUNK, device=None):
    """The app of phase_autogrow: reverse_any at stack_cap=16."""
    with open(os.path.join(EXAMPLES, "reverse_any.json")) as f:
        spec = json.load(f)
    nodes = {name: {"type": kind} for name, kind in spec["nodes"].items()}
    return dict(label="autogrow", node_info=nodes, programs=spec["programs"], batch=batch,
                chunk=chunk, caps=MAIN_CAPS, device=device)


def phase_autogrow(batch=MAIN_BATCH, chunk=MAIN_CHUNK, device=None):
    """reverse_any at stack_cap=16: one unspread /compute_batch of 40 values
    and a 0 needs depth 40, so the stack must grow 16 -> 32 -> 64.  First
    the kernel is held against its plain version at these shapes and both
    caps (not in a CPU rehearsal: the comparison needs the card)."""
    with open(os.path.join(EXAMPLES, "reverse_any.json")) as f:
        text = f.read()
    parity_err, parity = (None, None) if device == "cpu" else reverse_any_parity(
        text, batch, chunk)
    with served_apps([autogrow_spec(batch, chunk, device)]) as [(port, boot_s)]:
        cap0 = status(port)["stack_cap"]
        block = list(range(1, 41)) + [0]
        t = time.perf_counter()
        code, body = post_form(port, "/compute_batch", values=",".join(map(str, block)))
        grow_s = time.perf_counter() - t
        expect(code == 200 and json.loads(body)["values"] == [0] + list(range(40, 0, -1)),
               f"reverse_any: {code} {body[:200]!r}")
        st = status(port)
        expect(cap0 == 16 and st["stack_cap"] == 64, f"stack_cap {cap0} -> {st['stack_cap']}")
        code, body = post_form(port, "/compute_batch", values="7,8,9,0")
        expect(json.loads(body)["values"] == [0, 9, 8, 7], f"after growth: {body!r}")
        launches = status(port)["kernel_launches"]
    expect(device == "cpu" or launches["fused_superstep"] > 0, f"autogrow launches {launches}")
    row = {"phase": "autogrow", "network": "reverse_any", "batch": batch, "chunk_steps": chunk,
           "stack_cap_before": cap0, "stack_cap_after": st["stack_cap"],
           "stack_mem_bytes_after": batch * st["stack_cap"] * 4,
           "request_s": grow_s, "boot_s": boot_s, "kernel_launches": launches,
           "parity_max_abs_err": parity_err, "parity": parity}
    emit(row)
    return row


def elided_spec(batch=MAIN_BATCH, chunk=MAIN_CHUNK, device=None):
    from misaka_tpu_torch.networks import ADD2_PROGRAMS

    return dict(label="elided", node_info=ADD2_NODES, programs=ADD2_PROGRAMS, batch=batch,
                chunk=chunk, caps=MAIN_CAPS, device=device, MISAKA_FUSED_ELIDE_HI="1")


def phase_elided_path(batch=MAIN_BATCH, chunk=MAIN_CHUNK, n_raw=100_000, device=None):
    """add2 again, served by the elided variant (MISAKA_FUSED_ELIDE_HI=1)."""
    with served_apps([elided_spec(batch, chunk, device)]) as [(port, boot_s)]:
        for v in (5, -3, 2**31 - 1):
            code, body = post_form(port, "/compute", value=str(v))
            expect(code == 200 and json.loads(body) == {"value": int(wrap_i32(v + 2))},
                   f"elided /compute {v}: {body!r}")
        vals = np.random.default_rng(SEED + 2).integers(
            -(2**31), 2**31, size=n_raw, dtype=np.int64).astype(np.int32)
        raw_s = check_raw(port, vals)
        launches = status(port)["kernel_launches"]
    expect(device == "cpu" or (launches["fused_superstep_elide_hi"] > 0
                               and launches["fused_superstep"] == 0),
           f"elided path launches: {launches}")
    row = {"phase": "elided_path", "batch": batch, "chunk_steps": chunk, "boot_s": boot_s,
           "compute_raw_values": int(vals.size), "compute_raw_s": raw_s,
           "kernel_launches": launches}
    emit(row)
    return row


def readme_programs():
    """The reference README's add2 programs (README.md:178-185): the
    compose file's, without the trailing newline."""
    from misaka_tpu_torch.networks import ADD2_PROGRAMS

    return {k: v.rstrip("\n") for k, v in ADD2_PROGRAMS.items()}


def paused_window(port):
    """/pause, then /status: a reading no chunk can straddle."""
    expect(post_form(port, "/pause") == (200, b"Success"), "/pause")
    return status(port)


def unbatched_specs(device=None):
    """The apps of phase_unbatched_path: the README env (paused, a
    checkpoint dir), and reverse_any unbatched at stack_cap=4."""
    with open(os.path.join(EXAMPLES, "reverse_any.json")) as f:
        spec = json.load(f)
    nodes = {name: {"type": kind} for name, kind in spec["nodes"].items()}
    return [dict(label="unbatched", node_info=ADD2_NODES, programs=readme_programs(),
                 batch=None, chunk=None, caps=None, device=device, autorun=False,
                 MISAKA_CHECKPOINT_DIR=phase_dir("ckpt_unbatched", fresh=False)),
            dict(label="unbatched_autogrow", node_info=nodes, programs=spec["programs"],
                 batch=None, chunk=None, caps={"stack_cap": 4}, device=device)]


def phase_unbatched_path(n_latency=100, n_clients=32, per_client=10, n_raw=10_000,
                         device=None):
    """Boot the app with the reference README's add2 env only (no
    MISAKA_BATCH: one instance; default chunk 128 and caps 1024), /run and
    serve: /compute, 99 sequential /compute (p50, p90), 32 clients x 10
    /compute, /compute_raw and /compute_batch, a checkpoint saved and
    restored, /load and /reset, every answer checked.  /status must say
    engine "fused" with no `batch`, and between two paused readings the
    kernel's launches must rise by one per 128-tick iteration.  Then
    reverse_any unbatched at stack_cap=4 must grow its stack to answer an
    11-value request.  device="cpu" rehearses it through the plain
    version (engine "plain", no launches)."""
    ckpt_dir = phase_dir("ckpt_unbatched")
    key = "fused_superstep"
    rng = np.random.default_rng(SEED + 7)
    readme_spec, grow_spec = unbatched_specs(device)
    try:
        with served_apps([readme_spec]) as [(port, boot_s)]:
            st = status(port)
            expect("batch" not in st and not st["running"], f"README boot status {st}")
            expect(post_form(port, "/run") == (200, b"Success"), "/run")
            code, body = post_form(port, "/compute", value="5")
            expect(code == 200 and json.loads(body) == {"value": 7}, f"/compute 5: {body!r}")
            s0 = paused_window(port)
            expect(post_form(port, "/run")[0] == 200, "/run")
            lat = []
            for v in list(range(-49, 50))[: n_latency - 1]:
                t = time.perf_counter()
                code, body = post_form(port, "/compute", value=str(v))
                lat.append(time.perf_counter() - t)
                expect(code == 200 and json.loads(body) == {"value": v + 2},
                       f"/compute {v} -> {code} {body!r}")
            steady = np.sort(np.asarray(lat))

            def client(i):
                for j in range(per_client):
                    v = i * 1000 + j
                    c, b = post_form(port, "/compute", value=str(v))
                    if c != 200 or json.loads(b) != {"value": v + 2}:
                        raise RuntimeError(f"/compute {v} -> {c} {b!r}")

            errors, clients_s = run_clients(n_clients, client)
            expect(not errors, f"unbatched clients: {errors[:4]}")
            s1 = paused_window(port)
            iterations = (s1["tick"] - s0["tick"]) // 128
            launched = s1["kernel_launches"][key] - s0["kernel_launches"][key]
            expect(device == "cpu" or launched == iterations > 0,
                   f"{launched} launches for {iterations} iterations")
            expect(post_form(port, "/run")[0] == 200, "/run")
            vals = rng.integers(-(2**31), 2**31, size=n_raw, dtype=np.int64).astype(np.int32)
            raw_s = check_raw(port, vals)
            batch_vals = rng.integers(-10**6, 10**6, size=1000).astype(np.int32)
            for spread in ("0", "1"):
                code, body = post_form(port, "/compute_batch",
                                       values=",".join(map(str, batch_vals.tolist())),
                                       spread=spread)
                expect(code == 200 and json.loads(body)["values"] == (batch_vals + 2).tolist(),
                       f"/compute_batch spread={spread}")
            # checkpoint, more traffic, restore: the answers continue
            expect(post_form(port, "/checkpoint", name="u1") == (200, b"Success"), "/checkpoint")
            with np.load(os.path.join(ckpt_dir, "u1.npz")) as data:
                meta = json.loads(bytes(data["__topology__"]).decode())
                expect(meta["batch"] is None and data["pc"].shape == (2,),
                       f"unbatched checkpoint: batch {meta['batch']}, pc {data['pc'].shape}")
            check_raw(port, np.arange(-100, 100, dtype=np.int32))
            expect(post_form(port, "/restore", name="u1") == (200, b"Success"), "/restore")
            expect(post_form(port, "/run")[0] == 200, "/run after /restore")
            code, body = post_form(port, "/compute", value="41")
            expect(json.loads(body) == {"value": 43}, f"after /restore: {body!r}")
            new_prog = "IN ACC\nADD 10\nMOV ACC, misaka2:R0\nMOV R0, ACC\nOUT ACC"
            code, body = post_form(port, "/load", targetURI="misaka1", program=new_prog)
            expect(code == 200 and body == b"Success", f"/load -> {code} {body!r}")
            expect(post_form(port, "/run")[0] == 200, "/run after /load")
            code, body = post_form(port, "/compute", value="5")
            expect(json.loads(body) == {"value": 16}, f"after /load: {body!r}")
            expect(post_form(port, "/reset") == (200, b"Success"), "/reset")
            expect(status(port)["tick"] == 0, "tick after /reset")
            expect(post_form(port, "/run")[0] == 200, "/run after /reset")
            code, body = post_form(port, "/compute", value="-7")
            expect(json.loads(body) == {"value": 4}, f"after /reset: {body!r}")
            st = status(port)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    want_engine = "native" if device == "cpu" else "fused"  # auto on the CPU: native
    launches = st["kernel_launches"]
    expect(st["engine"] == want_engine and "batch" not in st, f"status {st}")
    expect(device == "cpu" or (launches[key] > 0 and all(
        n == 0 for k, n in launches.items() if k != key)), f"unbatched launches {launches}")
    # reverse_any, unbatched, stack_cap=4: the stack must grow to answer
    with served_apps([grow_spec]) as [(gport, _)]:
        block = list(range(1, 11)) + [0]
        t = time.perf_counter()
        code, body = post_form(gport, "/compute_batch", values=",".join(map(str, block)))
        grow_s = time.perf_counter() - t
        expect(code == 200 and json.loads(body)["values"] == [0] + list(range(10, 0, -1)),
               f"unbatched reverse_any: {code} {body[:200]!r}")
        gst = status(gport)
        expect(gst["stack_cap"] == 16 and "batch" not in gst, f"grown status {gst}")
    expect(device == "cpu" or gst["kernel_launches"][key] > 0, f"grow launches {gst}")
    row = {"phase": "unbatched_path", "env": "README.md:178-185 (no MISAKA_BATCH)",
           "engine": st["engine"], "device": st["device"], "chunk_steps": 128,
           "kernel_launches": launches, "boot_s": boot_s,
           "window_iterations": iterations, "window_launches": launched,
           "compute_latency_samples": len(steady),
           "compute_latency_p50_s": float(np.percentile(steady, 50)),
           "compute_latency_p90_s": float(np.percentile(steady, 90)),
           "compute_latency_max_s": float(steady[-1]),
           "clients": n_clients, "client_requests": n_clients * per_client,
           "clients_s": clients_s, "client_requests_per_s": n_clients * per_client / clients_s,
           "compute_raw_values": n_raw, "compute_raw_s": raw_s,
           "compute_raw_values_per_s": n_raw / raw_s,
           "autogrow": {"stack_cap_before": 4, "stack_cap_after": gst["stack_cap"],
                        "request_s": grow_s, "kernel_launches": gst["kernel_launches"]}}
    emit(row)
    return row


def check_isa_trace(port, programs, last=16):
    """GET /debug/isa_trace?last=N: N ticks, oldest first, every lane in
    order within a tick, and each entry's text the program line at its pc.
    /trace answers the same with its Deprecation and Link headers."""
    code, body = http(port, f"/debug/isa_trace?last={last}")
    entries = json.loads(body)["entries"]
    lanes = list(programs)
    expect(code == 200 and len(entries) == last * len(lanes), f"{len(entries)} entries")
    ticks = [e["tick"] for e in entries]
    first = ticks[0]
    expect(ticks == [first + i // len(lanes) for i in range(len(entries))]
           and [e["name"] for e in entries] == lanes * last, "trace not tick-ordered")
    for e in entries:
        line = programs[e["name"]].split("\n")[e["pc"]]
        expect(e["text"] == line, f"trace text {e['text']!r} is not line {e['pc']} ({line!r})")
    req = urllib.request.Request(f"http://127.0.0.1:{port}/trace?last=2")
    with urllib.request.urlopen(req, timeout=60) as r:
        expect(r.headers.get("Deprecation") == "true"
               and "/debug/isa_trace" in (r.headers.get("Link") or ""), "/trace headers")
        expect(len(json.loads(r.read())["entries"]) == 2 * len(lanes), "/trace body")
    return entries


def compare_traced(label, top, batch, steps, rng, instance=7):
    """`run_traced` on the card against the same call on the CPU, from the
    same state (8 seeded values queued per instance): the ring, its write
    counter and every NetworkState field equal.  A batched network records
    instance `instance`."""
    from misaka_tpu_torch.core.state import state_from_numpy, state_to_numpy

    nets = {d: top.compile(batch=batch, device=d) for d in ("cuda", "cpu")}
    host = nets["cpu"]
    entry = state_to_numpy(seeded_inputs(host, rng, 8) if batch else
                           host.feed(host.init_state(), rng.integers(-100, 100, 8))[0])
    out = {}
    for d, net in nets.items():
        kw = {"instance": instance} if batch else {}
        state, ring = net.run_traced(state_from_numpy(entry, d), net.init_trace(64), steps, **kw)
        out[d] = (state_to_numpy(state), ring.buf.cpu().numpy(), int(ring.wr))
    (gs, gb, gw), (ws, wb, ww) = out["cuda"], out["cpu"]
    bad = diverged_fields(gs, ws) + (["buf"] if not np.array_equal(gb, wb) else []) + (
        ["wr"] if gw != ww else [])
    return {"case": label, "batch": batch, "steps": steps, "exact": not bad,
            **({"diverged": bad} if bad else {})}


def traced_specs(traced_batch=4096, device=None):
    """The apps of phase_traced, booted at once, paused; each run in its
    turn: ((label, batch, env) per server, specs)."""
    servers = (("unbatched", None, {}), ("batched", traced_batch, {"MISAKA_TRACE_INSTANCE": "7"}))
    return servers, [dict(label=f"traced_{label}", node_info=ADD2_NODES,
                          programs=readme_programs(), batch=batch, chunk=None, caps=None,
                          device=device, autorun=False, MISAKA_TRACE_CAP="256", **extra)
                     for label, batch, extra in servers]


def phase_traced(traced_batch=4096, device=None):
    """Tracing: a server with MISAKA_TRACE_CAP=256, unbatched, and one with
    MISAKA_BATCH=`traced_batch` and MISAKA_TRACE_INSTANCE=7 (booted at once,
    each run in its turn); each serves
    through the plain version recording (engine "plain-traced", no kernel
    launch), and its /debug/isa_trace is tick-ordered with the programs'
    own lines.  Then in process, `run_traced` on the card against the same
    call on the CPU from the same state: the ring, its counter and every
    field equal (skipped in a CPU rehearsal)."""
    from misaka_tpu_torch import networks
    from misaka_tpu_torch.runtime.topology import Topology

    programs = readme_programs()
    rows = {}
    servers, specs = traced_specs(traced_batch, device)
    with served_apps(specs) as booted:
        for (label, batch, _), (port, boot_s) in zip(servers, booted):
            expect(post_form(port, "/run")[0] == 200, f"traced {label} /run")
            t = time.perf_counter()
            for v in (5, -3, 1000):
                code, body = post_form(port, "/compute", value=str(v))
                expect(code == 200 and json.loads(body) == {"value": v + 2},
                       f"traced {label} /compute {v}: {body!r}")
            compute_s = (time.perf_counter() - t) / 3
            check_raw(port, np.arange(-32, 32, dtype=np.int32))
            entries = check_isa_trace(port, programs)
            expect(post_form(port, "/pause")[0] == 200, f"traced {label} /pause")
            st = status(port)
            expect(st["engine"] == "plain-traced" and ("batch" in st) == (batch is not None)
                   and sum(st["kernel_launches"].values()) == 0, f"traced {label} status {st}")
            rows[label] = {"batch": batch, "boot_s": boot_s, "compute_s": compute_s,
                           "last_tick": entries[-1]["tick"]}
    parity = []
    if device != "cpu":
        rng = np.random.default_rng(SEED + 8)
        add2 = networks.add2(in_cap=16, out_cap=16, stack_cap=8)
        cases = [("add2", add2, None, 256), ("add2/batch64/instance7", add2, 64, 128)]
        cases += [(f"random/{seed}", random_topology(seed, Topology), None, 128)
                  for seed in (300, 301)]
        parity = [compare_traced(name, top, batch, steps, rng)
                  for name, top, batch, steps in cases]
    row = {"phase": "traced", "servers": rows, "card_vs_cpu": parity}
    emit(row)
    if not all(p["exact"] for p in parity):
        raise SystemExit("traced: run_traced on the card differs from the CPU")
    return row


def phase_two_shards(batch=MAIN_BATCH, chunk=MAIN_CHUNK, n_values=100_000,
                     devices=("cuda:0", "cuda:0")):
    """Two shards served on one card, in process: `MasterNode(device=[card,
    card], data_parallel=2)`.  A striped stream of n_values, all right; a
    checkpoint saved at D=2 loads into a D=1 master and one saved there
    loads back at D=2, every field equal after each load and the answers
    right; reverse_any at stack_cap=16 grows to 64 under D=2 and answers
    its reversal.  The launch counts are zeroed just before and read just
    after.  devices=("cpu", "cpu") with small sizes rehearses it without a
    card."""
    from misaka_tpu_torch import networks
    from misaka_tpu_torch.core import fused
    from misaka_tpu_torch.core.state import state_to_numpy
    from misaka_tpu_torch.runtime.master import MasterNode
    from misaka_tpu_torch.runtime.topology import Topology

    def master(top, d):
        return MasterNode(top, chunk_steps=chunk, batch=batch, device=list(devices[:d]),
                          data_parallel=d)

    def same_state(a, b, what):
        sa, sb = state_to_numpy(a.snapshot()), state_to_numpy(b.snapshot())
        bad = diverged_fields(sa, sb)
        expect(not bad, f"{what}: fields {bad} differ after the load")

    for k in fused.launch_counts:
        fused.launch_counts[k] = 0
    rng = np.random.default_rng(SEED + 5)
    vals = rng.integers(-(2**31), 2**31, size=n_values, dtype=np.int64).astype(np.int32)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="ckpt-dp-", dir=os.path.join(ROOT, "build"))
    m2 = master(networks.add2(**MAIN_CAPS), 2)
    m1 = master(networks.add2(**MAIN_CAPS), 1)
    try:
        m2.run()
        t = time.perf_counter()
        out = m2.compute_spread(vals, timeout=300, return_array=True)
        spread_s = time.perf_counter() - t
        expect(np.array_equal(out, wrap_i32(vals.astype(np.int64) + 2)),
               "two shards: compute_spread answers differ")
        m2.pause()
        t = time.perf_counter()
        m2.save_checkpoint(os.path.join(ckpt_dir, "d2.npz"))
        m1.load_checkpoint(os.path.join(ckpt_dir, "d2.npz"))
        d2_to_d1_s = time.perf_counter() - t
        same_state(m1, m2, "D=2 -> D=1")
        m1.run()
        few = vals[:5000]
        expect(np.array_equal(m1.compute_spread(few, timeout=300, return_array=True),
                              wrap_i32(few.astype(np.int64) + 2)), "D=1 after the load")
        m1.pause()
        t = time.perf_counter()
        m1.save_checkpoint(os.path.join(ckpt_dir, "d1.npz"))
        m2.load_checkpoint(os.path.join(ckpt_dir, "d1.npz"))
        d1_to_d2_s = time.perf_counter() - t
        same_state(m2, m1, "D=1 -> D=2")
        m2.run()
        expect(m2.compute(41, timeout=300) == 43, "D=2 after the load")
    finally:
        m1.close()
        m2.close()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del m1, m2
    with open(os.path.join(EXAMPLES, "reverse_any.json")) as f:
        mr = master(Topology.from_json(f.read(), **MAIN_CAPS), 2)
    try:
        cap0 = mr.status()["stack_cap"]
        mr.run()
        t = time.perf_counter()
        out = mr.compute_many(list(range(1, 41)) + [0], timeout=300)
        grow_s = time.perf_counter() - t
        expect(out == [0] + list(range(40, 0, -1)), f"two shards: reverse_any {out[:8]}")
        st = mr.status()
        expect(cap0 == 16 and st["stack_cap"] == 64, f"stack_cap {cap0} -> {st['stack_cap']}")
    finally:
        mr.close()
    del mr
    launches = dict(fused.launch_counts)
    on_card = devices[0] != "cpu"
    expect(not on_card or (launches[fused.KERNEL_DP] > 0 and all(
        n == 0 for k, n in launches.items() if k != fused.KERNEL_DP)),
        f"two-shard launches {launches}")
    row = {"phase": "two_shards", "devices": list(devices), "batch": batch,
           "chunk_steps": chunk, "mesh": st["mesh"], "spread_values": int(vals.size),
           "spread_s": spread_s, "spread_values_per_s": vals.size / spread_s,
           "checkpoint_d2_to_d1_s": d2_to_d1_s, "checkpoint_d1_to_d2_s": d1_to_d2_s,
           "stack_cap_before": cap0, "stack_cap_after": st["stack_cap"],
           "grow_request_s": grow_s, "kernel_launches": launches}
    emit(row)
    return row


# --- timings at the served shapes -------------------------------------------------


# --- the observability hooks on the card -------------------------------------------


def http_full(port, path, data=None, headers=None, timeout=300):
    """(status, headers, body) of one request."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, dict(r.headers), r.read()


def scrape(port):
    from misaka_tpu_torch.utils import metrics

    return metrics.parse_text(http(port, "/metrics", timeout=60)[1].decode())


def histogram_delta(before, after, name, **labels):
    """(uppers, per-bucket counts, sum, count) of one histogram's movement
    between two scrapes."""
    import math

    from misaka_tpu_torch.utils import metrics

    cum = []
    for series, v in after.items():
        n, lbl = metrics.parse_series(series)
        if n != name + "_bucket" or any(lbl.get(k) != v2 for k, v2 in labels.items()):
            continue
        le = math.inf if lbl["le"] == "+Inf" else float(lbl["le"])
        cum.append((le, v - before.get(series, 0.0)))
    cum.sort()
    counts = [int(round(c - (cum[i - 1][1] if i else 0.0))) for i, (_, c) in enumerate(cum)]
    key = metrics.parse_series
    total = sum(v - before.get(k, 0.0) for k, v in after.items()
                if key(k)[0] == name + "_sum" and all(key(k)[1].get(a) == b
                                                      for a, b in labels.items()))
    return tuple(u for u, _ in cum[:-1]), counts, total, sum(counts)


def histogram_summary(before, after, name, **labels):
    """p50, p90 (quantile_from_buckets) and mean of a histogram's movement,
    in ms."""
    from misaka_tpu_torch.utils import metrics

    uppers, counts, total, n = histogram_delta(before, after, name, **labels)
    if not n:
        return {"count": 0}
    return {"count": n, "mean_ms": total / n * 1e3,
            "p50_ms": metrics.quantile_from_buckets(uppers, counts, 0.5) * 1e3,
            "p90_ms": metrics.quantile_from_buckets(uppers, counts, 0.9) * 1e3}


def small_requests(port, n_clients, per_client, base=0):
    """n_clients threads x per_client one-value /compute, every answer
    checked; returns (requests, seconds)."""

    def client(i):
        for j in range(per_client):
            v = base + i * 10_000 + j
            c, b = post_form(port, "/compute", value=str(v))
            if c != 200 or json.loads(b) != {"value": v + 2}:
                raise RuntimeError(f"/compute {v} -> {c} {b!r}")

    errors, secs = run_clients(n_clients, client)
    expect(not errors, f"small-request clients: {errors[:4]}")
    return n_clients * per_client, secs


def perfetto_tiers(port):
    """Total span time per tier (ms) in the flight recorder's window."""
    doc = json.loads(http(port, "/debug/perfetto", timeout=60)[1])
    names = {e["pid"]: e["args"]["name"].split(": ", 1)[-1] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    out: dict = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X":
            t = names.get(e["pid"], str(e["pid"]))
            out[t] = out.get(t, 0.0) + e.get("dur", 0.0) / 1e3
    return out


def _overlap(a0, a1, spans):
    """Length of the union of `spans` ([(t0, t1)], sorted) clipped to [a0, a1]."""
    total, cur0, cur1 = 0.0, None, None
    for t0, t1 in spans:
        t0, t1 = max(t0, a0), min(t1, a1)
        if t1 <= t0:
            continue
        if cur1 is None or t0 > cur1:
            if cur1 is not None:
                total += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    if cur1 is not None:
        total += cur1 - cur0
    return total


SERVE_PARTS = ("misaka.feed", "misaka.checks_clones", "misaka.kernel_launch", "misaka.pack",
               "misaka.read")


def profile_split(trace_path, kernel_symbol="fused_superstep_kernel"):
    """Read one /profile capture (a torch.profiler Chrome trace): the device
    loop's thread is the one that records `misaka.iteration`.  Per
    iteration: kernel ms and copy ms (device events inside it), host ms
    (iteration minus device busy); the host ops with the most self time on
    the loop thread; and each serve-call part's host ms per iteration
    (utils/profiling.py's marks)."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    iters = sorted((e for e in events if e["name"] == "misaka.iteration"),
                   key=lambda e: e["ts"])
    expect(iters, "the profile holds no device-loop iteration (misaka.iteration)")
    tids = collections.Counter(e["tid"] for e in iters)
    loop_tid = tids.most_common(1)[0][0]
    kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") == "kernel" and kernel_symbol in e["name"])
    other_kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                           if e.get("cat") == "kernel" and kernel_symbol not in e["name"])
    copies = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("gpu_memcpy", "gpu_memset"))
    expect(kernels, f"no CUDA kernel event named {kernel_symbol} in the profile")
    loop = sorted((e for e in events if e.get("tid") == loop_tid), key=lambda e: (e["ts"], -e["dur"]))
    loop_ops = {e["name"] for e in loop}
    expect("misaka.kernel_launch" in loop_ops and any(n.startswith("aten::") for n in loop_ops),
           f"the device loop's CPU ops are missing: {sorted(loop_ops)[:20]}")
    rows = []
    for it in iters:
        if it["tid"] != loop_tid:
            continue
        a0, a1 = it["ts"], it["ts"] + it["dur"]
        k = _overlap(a0, a1, kernels)
        c = _overlap(a0, a1, copies) + _overlap(a0, a1, other_kernels)
        busy = _overlap(a0, a1, sorted(kernels + copies + other_kernels))
        rows.append((it["dur"] / 1e3, k / 1e3, c / 1e3, (it["dur"] - busy) / 1e3))
    # self time per op name on the loop thread (nesting by containment)
    self_us: dict = collections.defaultdict(float)
    stack: list = []
    for e in loop:
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
            stack.pop()
        if stack:
            self_us[stack[-1]["name"]] -= e["dur"]
        self_us[e["name"]] += e["dur"]
        stack.append(e)
    host_ops = sorted(((n, us) for n, us in self_us.items()
                       if n != "misaka.iteration" and not n.startswith("cuda")),
                      key=lambda kv: -kv[1])
    n_it = len(rows)
    arr = np.asarray(rows)
    parts = {p: sum(e["dur"] for e in loop if e["name"] == p) / 1e3 / n_it
             for p in SERVE_PARTS}
    return {
        "iterations": n_it,
        "iteration_ms": float(arr[:, 0].mean()), "kernel_ms": float(arr[:, 1].mean()),
        "copy_ms": float(arr[:, 2].mean()), "host_ms": float(arr[:, 3].mean()),
        "iteration_ms_p50": float(np.median(arr[:, 0])),
        "host_ms_p50": float(np.median(arr[:, 3])),
        "largest_host_ops_ms_per_iteration": [[n, us / 1e3 / n_it] for n, us in host_ops[:3]],
        "parts_ms_per_iteration": parts,
        "kernel_events": len(kernels),
    }


def take_profile(port, name, load):
    """/profile/start, run load(), /profile/stop: returns the trace path."""
    expect(post_form(port, "/profile/start", name=name) == (200, b"Success"),
           "/profile/start")
    load()
    code, body = post_form(port, "/profile/stop")
    expect(code == 200, f"/profile/stop -> {code} {body!r}")
    return os.path.join(body.decode(), "trace.json")


def observability_specs(batch=MAIN_BATCH, chunk=MAIN_CHUNK, device=None):
    """The apps of phase_observability, booted at once, the untraced one
    paused until its turn."""
    from misaka_tpu_torch.networks import ADD2_PROGRAMS

    base = dict(node_info=ADD2_NODES, programs=ADD2_PROGRAMS, batch=batch, chunk=chunk,
                caps=MAIN_CAPS, device=device)
    return [dict(base, label="obs", MISAKA_PROFILE_DIR=phase_dir("prof_obs", fresh=False),
                 MISAKA_TRACE_REQUESTS="1"),
            dict(base, label="obs_untraced", autorun=False, MISAKA_TRACE_REQUESTS="0")]


def phase_observability(batch=MAIN_BATCH, chunk=MAIN_CHUNK, n_clients=32, per_client=40,
                        profile_per_client=10, device=None, card=None):
    """The batched main path (add2, the full kernel) under the new hooks:
    32 x 40 one-value /compute, every answer checked, read back through
    the /metrics delta (iterations, chunk seconds, serve queue delay, HTTP
    latency of /compute) and /debug/perfetto (time per tier); the
    iterations counter must equal the kernel launches between two paused
    readings.  A /profile window over 32 x 10 more requests must hold the
    kernel's CUDA events and the device loop's CPU ops, and gives the
    by-phase split of an iteration; a second window over one client's 20
    requests gives the same split without concurrent handlers.  The same load again with
    MISAKA_TRACE_REQUESTS=0 (a second server, booted beside the first and
    paused until its turn) gives the tracing overhead.  device="cpu"
    rehearses it (no kernel: the profile checks are skipped)."""
    prof_dir = phase_dir("prof_obs")
    row = {"phase": "observability", "card": card, "batch": batch, "chunk_steps": chunk,
           **MAIN_CAPS}
    try:
        with served_apps(observability_specs(batch, chunk, device)) as [(port, _), (uport, _)]:
            expect(post_form(port, "/compute", value="1")[1] == b'{"value": 3}\n', "warm-up")
            s0, m0 = paused_window(port), scrape(port)
            expect(post_form(port, "/run")[0] == 200, "/run")
            n, secs = small_requests(port, n_clients, per_client)
            s1, m1 = paused_window(port), scrape(port)
            expect(post_form(port, "/run")[0] == 200, "/run")
            serve = m1['misaka_device_loop_iterations_total{kind="serve"}'] - m0.get(
                'misaka_device_loop_iterations_total{kind="serve"}', 0.0)
            idle = m1['misaka_device_loop_iterations_total{kind="idle"}'] - m0.get(
                'misaka_device_loop_iterations_total{kind="idle"}', 0.0)
            launched = (sum(s1["kernel_launches"].values())
                        - sum(s0["kernel_launches"].values()))
            expect(device == "cpu" or serve + idle == launched > 0,
                   f"iterations {serve} + {idle} != {launched} kernel launches")
            chunk_h = histogram_summary(m0, m1, "misaka_device_loop_chunk_seconds")
            expect(chunk_h["count"] == serve + idle, f"chunk histogram {chunk_h}")
            tiers = perfetto_tiers(port)
            st, hd, _ = http_full(port, "/compute", b"value=7")
            timing = hd.get("Server-Timing", "")
            expect(st == 200 and "pass" in timing and hd.get("X-Misaka-Trace"),
                   f"trace headers {hd}")
            row.update({
                "small_requests": n, "small_s": secs, "small_requests_per_s": n / secs,
                "iterations_serve": serve, "iterations_idle": idle,
                "kernel_launches": launched,
                "chunk_seconds": chunk_h,
                "serve_queue_delay": histogram_summary(
                    m0, m1, "misaka_serve_queue_delay_seconds"),
                "http_compute_latency": histogram_summary(
                    m0, m1, "misaka_http_request_duration_seconds", route="/compute"),
                "serve_passes": m1["misaka_serve_passes_total"] - m0["misaka_serve_passes_total"],
                "perfetto_tier_ms": tiers,
            })
            if device != "cpu":
                trace = take_profile(port, "obs", lambda: small_requests(
                    port, n_clients, profile_per_client, base=5_000_000))
                row["profile"] = profile_split(trace)
                # the same iteration with one client: no handler threads
                # contend with the loop for the interpreter
                trace = take_profile(port, "obs_quiet", lambda: small_requests(
                    port, 1, 20, base=6_000_000))
                row["profile_one_client"] = profile_split(trace)
            # the untraced server's turn, the traced one paused
            expect(post_form(port, "/pause")[0] == 200, "/pause")
            expect(post_form(uport, "/run")[0] == 200, "/run untraced")
            expect(post_form(uport, "/compute", value="1")[1] == b'{"value": 3}\n', "warm-up")
            n2, secs2 = small_requests(uport, n_clients, per_client)
            _, hd, _ = http_full(uport, "/compute", b"value=7")
            expect("X-Misaka-Trace" not in hd, "tracing off still answers a trace ID")
        row.update({"untraced_small_requests_per_s": n2 / secs2,
                    "tracing_rate_ratio": (n / secs) / (n2 / secs2)})
    finally:
        shutil.rmtree(prof_dir, ignore_errors=True)
    emit(row)
    return row


def obs_unbatched_spec(device=None):
    return dict(label="obs_unbatched", node_info=ADD2_NODES, programs=readme_programs(),
                batch=None, chunk=None, caps=None, device=device,
                MISAKA_PROFILE_DIR=phase_dir("prof_obs_unbatched", fresh=False))


def phase_unbatched_observability(n_quiet=99, profile_requests=40, device=None, card=None):
    """The README env (no MISAKA_BATCH, chunk 128, caps 1024): 99 quiet
    /compute, every answer checked, with the medians of their
    Server-Timing phases; then a /profile window over quiet /compute that
    splits the B=1 serve call into the feed upload, fused_superstep's
    checks and clones, the kernel and the packed read."""
    prof_dir = phase_dir("prof_obs_unbatched")
    from misaka_tpu_torch.utils import tracespan

    try:
        with served_apps([obs_unbatched_spec(device)]) as [(port, _)]:
            expect(post_form(port, "/compute", value="1")[1] == b'{"value": 3}\n', "warm-up")
            phases: dict = collections.defaultdict(list)
            lat = []
            for v in list(range(-49, 50))[:n_quiet]:
                t = time.perf_counter()
                code, hd, body = http_full(port, "/compute", f"value={v}".encode())
                lat.append(time.perf_counter() - t)
                expect(code == 200 and json.loads(body) == {"value": v + 2},
                       f"/compute {v} -> {code} {body!r}")
                for k, ms in tracespan.parse_server_timing(hd.get("Server-Timing", "")).items():
                    phases[k].append(ms)
            row = {"phase": "unbatched_observability", "card": card, "env": "README.md:178-185",
                   "chunk_steps": 128, "caps": 1024, "requests": len(lat),
                   "compute_latency_p50_ms": float(np.median(lat)) * 1e3,
                   "server_timing_p50_ms": {k: float(np.median(v)) for k, v in phases.items()}}
            if device != "cpu":

                def quiet():
                    for v in range(profile_requests):
                        code, body = post_form(port, "/compute", value=str(v))
                        expect(json.loads(body) == {"value": v + 2}, f"/compute {v}")

                split = profile_split(take_profile(port, "obs_unbatched", quiet))
                parts = split["parts_ms_per_iteration"]
                row["profile"] = split
                row["serve_call_split_ms"] = {
                    "feed_upload": parts["misaka.feed"],
                    "checks_and_clones": parts["misaka.checks_clones"],
                    "kernel_launch_host": parts["misaka.kernel_launch"],
                    "kernel_device": split["kernel_ms"],
                    "pack": parts["misaka.pack"],
                    "packed_read": parts["misaka.read"],
                }
    finally:
        shutil.rmtree(prof_dir, ignore_errors=True)
    emit(row)
    return row


# --- the multi-process front on the card -------------------------------------------


def frontend_workers() -> int:
    """4 workers, or half the cores on a machine with fewer than 8."""
    cpus = os.cpu_count() or 1
    return 4 if cpus >= 8 else max(1, cpus // 2)


def frontend_pids(parent: int) -> list[int]:
    """The frontend worker processes whose parent is `parent` (/proc)."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read()
        except (OSError, ValueError, IndexError):
            continue  # exited while we looked
        if ppid == parent and b"misaka_tpu_torch.runtime.frontends" in cmd:
            out.append(int(d))
    return out


def pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def frontends_spec(batch=MAIN_BATCH, chunk=MAIN_CHUNK, workers=None, device=None):
    """The app of phase_frontends: add2 behind the workers, the native edge
    off, profiles armed; its plane socket outside the profile dir, which
    the phase makes fresh."""
    from misaka_tpu_torch.networks import ADD2_PROGRAMS

    return dict(label="frontends", node_info=ADD2_NODES, programs=ADD2_PROGRAMS, batch=batch,
                chunk=chunk, caps=MAIN_CAPS, device=device,
                MISAKA_HTTP_WORKERS=str(workers or frontend_workers()),
                MISAKA_NATIVE_EDGE="0",
                MISAKA_PROFILE_DIR=phase_dir("prof_frontends", fresh=False),
                MISAKA_PLANE_SOCKET=os.path.join(ROOT, "build", "chip_frontends.sock"))


def phase_frontends(batch=MAIN_BATCH, chunk=MAIN_CHUNK, n_clients=32, per_client=40,
                    n_quiet=99, stream_values=None, profile_per_client=10, workers=None,
                    device=None, card=None, zero_workers=None):
    """The batched main path (add2, the full kernel) behind the frontend
    workers (MISAKA_HTTP_WORKERS=N, runtime/frontends.py): the loads of
    the served phases through the public port, every answer checked (32 x
    40 one-value /compute, 99 quiet /compute, 32 /compute_raw streams of
    12,500 values); the engine's own reading between two paused windows
    (iterations must equal the kernel's launches; chunk seconds, serve
    queue delay, plane frames and values per frame); a /profile window
    over 32 x 10 requests split by profile_split (the device loop's host ms
    per iteration, to set beside `observability`'s, whose row is
    `zero_workers`); last, the engine is terminated and no worker may be
    left 5 s later.  MISAKA_NATIVE_EDGE=0: this phase measures the worker
    tier, whose figures are compared across PRs (the native edge has a
    phase of its own).  device="cpu" rehearses it (no kernel: no profile;
    the streams default to 400 values, the plain loop's pace)."""
    workers = workers or frontend_workers()
    stream_values = stream_values or (400 if device == "cpu" else 12_500)
    prof_dir = phase_dir("prof_frontends")
    row = {"phase": "frontends", "card": card, "workers": workers,
           "cpu_count": os.cpu_count(), "batch": batch, "chunk_steps": chunk, **MAIN_CAPS}
    procs: list = []
    try:
        with served_apps([frontends_spec(batch, chunk, workers, device)],
                         procs=procs) as [(port, boot_s)]:
            from misaka_tpu_torch.runtime import frontends

            deadline = time.monotonic() + 60
            while status(port).get("frontends", {}).get("alive") != workers:
                expect(time.monotonic() < deadline, f"{workers} workers not alive within 60 s")
                time.sleep(0.2)
            expect(frontends.wait_ready(port, timeout=30), "the public port does not answer")
            pids = frontend_pids(procs[0].pid)
            expect(len(pids) == workers, f"worker processes {pids}, want {workers}")
            # every worker answers: more connections than workers, each
            # one request (the kernel spreads them over the workers)
            small_requests(port, 4 * workers, 1, base=9_000_000)
            s0, m0 = paused_window(port), scrape(port)
            expect(post_form(port, "/run")[0] == 200, "/run")
            n, secs = small_requests(port, n_clients, per_client)
            lat = []
            for v in list(range(-49, 50))[:n_quiet]:
                t = time.perf_counter()
                code, body = post_form(port, "/compute", value=str(v))
                lat.append(time.perf_counter() - t)
                expect(code == 200 and json.loads(body) == {"value": v + 2}, f"/compute {v}")
            rng = np.random.default_rng(SEED + 7)
            streams = [rng.integers(-2**31, 2**31, stream_values, dtype=np.int64).astype(np.int32)
                       for _ in range(n_clients)]
            errors, raw_s = run_clients(n_clients, lambda i: check_raw(port, streams[i]))
            expect(not errors, f"/compute_raw streams: {errors[:4]}")
            s1, m1 = paused_window(port), scrape(port)
            expect(post_form(port, "/run")[0] == 200, "/run")

            def moved(name):
                return m1.get(name, 0.0) - m0.get(name, 0.0)

            serve = moved('misaka_device_loop_iterations_total{kind="serve"}')
            idle = moved('misaka_device_loop_iterations_total{kind="idle"}')
            launched = (sum(s1["kernel_launches"].values())
                        - sum(s0["kernel_launches"].values()))
            expect(device == "cpu" or serve + idle == launched > 0,
                   f"iterations {serve} + {idle} != {launched} kernel launches")
            chunk_h = histogram_summary(m0, m1, "misaka_device_loop_chunk_seconds")
            expect(chunk_h["count"] == serve + idle, f"chunk histogram {chunk_h}")
            frames = moved("misaka_plane_frames_total")
            values = moved("misaka_compute_values_total")
            expect(frames > 0, "no compute-plane frame in the window")
            row.update({
                "boot_s": boot_s, "small_requests": n, "small_s": secs,
                "small_requests_per_s": n / secs,
                "compute_latency_p50_ms": float(np.median(lat)) * 1e3,
                "compute_latency_p90_ms": float(np.percentile(lat, 90)) * 1e3,
                "raw_streams": n_clients, "raw_stream_values": stream_values,
                "served_values_per_s": n_clients * stream_values / raw_s,
                "iterations_serve": serve, "iterations_idle": idle,
                "kernel_launches": launched, "chunk_seconds": chunk_h,
                "serve_queue_delay": histogram_summary(
                    m0, m1, "misaka_serve_queue_delay_seconds"),
                "plane_frames": frames, "values_per_frame": values / frames,
                "plane_pipelined_frames": moved("misaka_plane_pipelined_frames_total"),
                "serve_passes": moved("misaka_serve_passes_total"),
            })
            if device != "cpu":
                trace = take_profile(port, "frontends", lambda: small_requests(
                    port, n_clients, profile_per_client, base=5_000_000))
                row["profile"] = profile_split(trace)
            expect(status(port)["frontends"]["restarts_total"] == 0, "a worker died")
        # served_app terminated the engine: its workers must follow
        t_kill = time.monotonic()
        while any(pid_alive(p) for p in pids):
            expect(time.monotonic() - t_kill < 5, "a frontend worker outlived its engine")
            time.sleep(0.05)
        row["workers_gone_s"] = time.monotonic() - t_kill
    finally:
        shutil.rmtree(prof_dir, ignore_errors=True)
    if zero_workers is not None:
        row["zero_workers"] = {
            "small_requests_per_s": zero_workers["small_requests_per_s"],
            "chunk_seconds": zero_workers["chunk_seconds"],
            "profile_host_ms": zero_workers.get("profile", {}).get("host_ms"),
            "profile_one_client_host_ms": zero_workers.get("profile_one_client",
                                                           {}).get("host_ms"),
        }
    emit(row)
    return row


# --- the edge: API keys, quotas, admission and tenant tokens ---------------------

EDGE_KEYS = [
    {"key": "edge-admin", "tenant": "ops", "admin": True},
    {"key": "edge-alice", "tenant": "alice"},
    {"key": "edge-bob", "tenant": "bob", "quota": "rps<5"},
    {"key": "edge-eve", "tenant": "eve", "disabled": True},
    {"key": "edge-pin", "tenant": "pin", "programs": ["dense"]},
    {"key": "edge-flood", "tenant": "flood"},
]
ADMIN = {"X-Misaka-Key": "edge-admin"}
CHALLENGE = 'Bearer realm="misaka", charset="UTF-8"'


def call(port, path, data=None, headers=None, timeout=120):
    """(status, headers, body) of one request, error statuses included."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def keyed_compute(port, key, v, headers=None):
    """One /compute as `key`: (status, headers, body, seconds)."""
    t = time.perf_counter()
    c, h, b = call(port, "/compute", f"value={v}".encode(),
                   {"X-Misaka-Key": key, **(headers or {})})
    return c, h, b, time.perf_counter() - t


def keyed_window(port):
    """/pause, then /status, as the admin key."""
    expect(call(port, "/pause", b"", ADMIN)[0] == 200, "/pause as admin")
    return json.loads(call(port, "/status", headers=ADMIN)[2])


def latency_ms(secs):
    return {"n": len(secs), "p50_ms": float(np.median(secs)) * 1e3 if secs else None,
            "p90_ms": float(np.percentile(secs, 90)) * 1e3 if secs else None}


def edge_drill(port, workers):
    """Every typed answer of the edge behind the workers, each checked."""
    row = {}
    c, h, b = call(port, "/compute", b"value=1")
    expect(c == 401 and h.get("WWW-Authenticate") == CHALLENGE
           and b == b"API key required (X-Misaka-Key header or Authorization: Bearer <key>)",
           f"/compute without a key -> {c} {b!r}")
    c, h, b = call(port, "/status")
    expect(c == 401 and h.get("WWW-Authenticate") == CHALLENGE, f"/status without a key -> {c}")
    c, h, b = call(port, "/compute_raw", np.arange(4, dtype="<i4").tobytes())
    expect(c == 401 and h.get("WWW-Authenticate") == CHALLENGE, f"/compute_raw no key -> {c}")
    c, _, b = call(port, "/pause", b"", {"X-Misaka-Key": "edge-alice"})
    expect(c == 403 and b == b"this route requires an admin-scoped API key",
           f"/pause as a tenant -> {c} {b!r}")
    expect(keyed_compute(port, "edge-eve", 1)[:3:2] == (403, b"API key disabled"),
           "the disabled key")
    c, _, b, _ = keyed_compute(port, "edge-pin", 1, {"X-Misaka-Program": "other"})
    expect((c, b) == (403, b"API key not authorized for program 'other'"),
           f"the program-pinned key off its program -> {c} {b!r}")
    for key in ("edge-pin", "edge-admin", "edge-alice"):
        c, _, b, _ = keyed_compute(port, key, 40)
        expect((c, json.loads(b)) == (200, {"value": 42}), f"/compute as {key} -> {c} {b!r}")
    # bob (rps<5, a burst of 10) on the plane path while alice computes
    stop = threading.Event()
    alice: list = []

    def neighbour():
        v = 1_000_000
        while not stop.is_set():
            c, _, b, secs = keyed_compute(port, "edge-alice", v)
            alice.append((c == 200 and json.loads(b) == {"value": v + 2}, secs))
            v += 1

    th = threading.Thread(target=neighbour)
    th.start()
    vals = np.arange(16, dtype=np.int32)
    bob = {"admitted": 0, "rejected": 0, "retry_after": 0, "t_end": None, "bad": []}
    lock = threading.Lock()

    def bob_client(i):
        # four at once: bob outruns his 5 requests/s on any host
        while True:
            c, h, b = call(port, "/compute_raw?spread=1", vals.astype("<i4").tobytes(),
                           {"X-Misaka-Key": "edge-bob"})
            with lock:
                if c == 200 and np.array_equal(np.frombuffer(b, "<i4"), vals + 2):
                    bob["admitted"] += 1
                elif (c == 429 and h.get("Retry-After", "").isdigit()
                      and b == b"request rate quota exhausted (5 requests/s)"):
                    bob["rejected"] += 1
                    bob["retry_after"] = max(bob["retry_after"], int(h["Retry-After"]))
                    bob["t_end"] = bob["t_end"] or time.monotonic() + 1.0  # 1 s more
                else:
                    bob["bad"].append((c, b[:200]))
                if (bob["bad"] or bob["admitted"] + bob["rejected"] >= 400
                        or (bob["t_end"] and time.monotonic() > bob["t_end"])):
                    return

    try:
        errors, _ = run_clients(4, bob_client)
    finally:
        stop.set()
        th.join(timeout=60)
    expect(not errors and not bob["bad"], f"bob: {errors[:4]} {bob['bad'][:4]}")
    retry = bob.pop("retry_after")
    del bob["t_end"], bob["bad"]
    expect(bob["rejected"] > 0 and bob["admitted"] >= 10, f"bob's burst: {bob}")
    expect(alice and all(ok for ok, _ in alice), "alice's answers during bob's burst")
    expect(max(s for _, s in alice) < 2.0, "alice waited 2 s or more beside bob")
    # recovery after the advertised wait
    time.sleep(retry + 0.2)
    c, _, b = call(port, "/compute_raw?spread=1", vals.astype("<i4").tobytes(),
                   {"X-Misaka-Key": "edge-bob"})
    expect(c == 200, f"bob after Retry-After {retry} s -> {c} {b!r}")
    # a signed tenant token serves; a tampered one does not
    c, _, b = call(port, "/edge/token", b"tenant=carol&ttl=60", ADMIN)
    expect(c == 200, f"/edge/token -> {c} {b!r}")
    token = json.loads(b)["token"]
    c, _, b, _ = keyed_compute(port, token, 5)
    expect((c, json.loads(b)) == (200, {"value": 7}), f"/compute with a token -> {c} {b!r}")
    bad = token[:-10] + ("A" if token[-10] != "A" else "B") + token[-9:]
    c, _, b, _ = keyed_compute(port, bad, 5)
    expect((c, b) == (401, b"tenant token invalid"), f"a tampered token -> {c} {b!r}")
    # the workers' shed-cache hits reach the engine's series once each
    # worker has shipped a frame: new connections spread over the workers
    series = 'misaka_edge_rejected_total{reason="rate",tenant="bob"}'
    deadline = time.monotonic() + 15
    while True:
        for v in range(8 * workers):
            expect(keyed_compute(port, "edge-alice", v)[0] == 200, "alice's flush request")
        booked = scrape(port).get(series, 0.0)
        if booked >= bob["rejected"] or time.monotonic() > deadline:
            break
    expect(booked == bob["rejected"], f"{series} = {booked}, bob saw {bob['rejected']} 429s")
    row.update(bob=bob, bob_retry_after_s=retry, bob_rejected_booked=booked,
               alice_beside_bob=latency_ms([s for _, s in alice]))
    return row


def admission_drill(port, flood_values, flooders, flood_s):
    """`flooders` clients post flood_values-value /compute_raw bodies as
    tenant "flood" while alice sends one-value /compute: the flood fills
    the backlog past the soft watermark and is shed; alice is not."""
    s0, m0 = keyed_window(port), scrape(port)
    expect(call(port, "/run", b"", ADMIN)[0] == 200, "/run as admin")
    rng = np.random.default_rng(SEED + 11)
    bodies = [rng.integers(-2**31, 2**31, flood_values, dtype=np.int64).astype(np.int32)
              for _ in range(flooders)]
    stop = threading.Event()
    flood = collections.Counter()
    alice: list = []

    def flooder(i):
        body, want = bodies[i].astype("<i4").tobytes(), wrap_i32(bodies[i].astype(np.int64) + 2)
        while not stop.is_set():
            try:
                c, h, b = call(port, "/compute_raw?spread=1", body,
                               {"X-Misaka-Key": "edge-flood"})
            except (ConnectionResetError, BrokenPipeError, urllib.error.URLError) as e:
                # a worker that sheds a bulk body closes without reading
                # it (edge.drain_or_close): the 429 can be lost to the reset
                if isinstance(e, urllib.error.URLError) and not isinstance(
                        e.reason, (ConnectionResetError, BrokenPipeError)):
                    raise
                flood["reset"] += 1
                time.sleep(0.02)
                continue
            if c == 200:
                if not np.array_equal(np.frombuffer(b, "<i4"), want):
                    raise RuntimeError("a flood answer differs")
            elif c == 429 and h.get("Retry-After"):
                time.sleep(0.02)  # knock again soon: the drill wants pressure
            else:
                raise RuntimeError(f"flood -> {c} {b[:200]!r}")
            flood[c] += 1

    def light(i):
        v = 2_000_000 + i * 100_000
        while not stop.is_set():
            c, _, b, secs = keyed_compute(port, "edge-alice", v)
            alice.append((c, c == 200 and json.loads(b) == {"value": v + 2}, secs))
            v += 1

    errors: list = []

    def guarded(fn, i):
        try:
            fn(i)
        except Exception as e:  # recorded, and the drill stops
            errors.append(repr(e))
            stop.set()

    threads = ([threading.Thread(target=guarded, args=(light, i), daemon=True)
                for i in range(4)]
               + [threading.Thread(target=guarded, args=(flooder, i), daemon=True)
                  for i in range(flooders)])
    for th in threads:
        th.start()
    time.sleep(flood_s)
    stop.set()
    for th in threads:
        th.join(timeout=120)
    s1, m1 = keyed_window(port), scrape(port)
    expect(call(port, "/run", b"", ADMIN)[0] == 200, "/run as admin")

    def moved(name):
        return m1.get(name, 0.0) - m0.get(name, 0.0)

    serve = moved('misaka_device_loop_iterations_total{kind="serve"}')
    idle = moved('misaka_device_loop_iterations_total{kind="idle"}')
    launched = sum(s1["kernel_launches"].values()) - sum(s0["kernel_launches"].values())
    alice_429 = sum(1 for c, _, _ in alice if c == 429)
    expect(not errors and flood[200] > 0, f"the flood: {dict(flood)} {errors[:4]}")
    expect(alice and alice_429 == 0 and all(ok for _, ok, _ in alice),
           f"alice beside the flood: {len(alice)} requests, {alice_429} 429s")
    return {"flood_values": flood_values, "flooders": flooders, "flood_s": flood_s,
            "flood_200": flood[200], "flood_429": flood[429], "flood_reset": flood["reset"],
            "flood_shed_booked": moved('misaka_edge_rejected_total{reason="overload",'
                                       'tenant="flood"}'),
            "alice_requests": len(alice), "alice_429": alice_429,
            "alice": latency_ms([s for _, _, s in alice]),
            "iterations_serve": serve, "iterations_idle": idle, "kernel_launches": launched,
            "iterations_equal_launches": serve + idle == launched}


def cost_turn(port, n_clients, per_client, n_quiet):
    """The small-request rate and quiet /compute p50/p90 of one server."""
    expect(post_form(port, "/run")[0] == 200, "/run")
    n, secs = small_requests(port, n_clients, per_client)
    lat = []
    for v in range(n_quiet):
        t = time.perf_counter()
        code, body = post_form(port, "/compute", value=str(v))
        lat.append(time.perf_counter() - t)
        expect(code == 200 and json.loads(body) == {"value": v + 2}, f"/compute {v}")
    expect(post_form(port, "/pause")[0] == 200, "/pause")
    return {"small_requests_per_s": n / secs, **latency_ms(lat)}


def phase_edge(batch=MAIN_BATCH, chunk=MAIN_CHUNK, workers=None, n_clients=32, per_client=10,
               n_quiet=13, flooders=6, flood_s=5.0, device=None, card=None):
    """The edge on the main path (add2 at B, the full kernel) behind N
    frontend workers, in three sets of servers, each set booted at once:

    - the drill: a key file (an admin key, two tenant keys, bob's with
      `rps<5`, a disabled key, a program-pinned key) and a token secret:
      401 with the challenge without a key (compute and /status), 403 off
      scope and for the disabled key, bob's 429 with Retry-After on the
      plane path while alice's answers stay right and on time, recovery
      after the advertised wait, a minted token that serves and a tampered
      one that gets 401, and bob's 429s all booked in the engine's series;
    - admission: the same keys with MISAKA_ADMISSION_HIGH at 4 flood
      bodies and one pass of B/8 values at a time (MISAKA_BATCH_PASSES=1,
      MISAKA_BATCH_MAX=B/8: the engine drains slower than `flooders`
      clients post B-value bodies, so the backlog sits between the soft
      watermark and the hard one, which 6 bodies cannot reach): the
      flood's 429s (some), alice's (none), her p50/p90, iterations against
      launches;
    - the edge's cost: the default env (the chain armed with an empty
      quota, as the reference's default boot) against MISAKA_EDGE=0, in
      turns a b b a, behind the workers and with none: n_clients x
      per_client one-value /compute and quiet /compute p50/p90.  The servers not measured are
      paused.

    Every server pins MISAKA_NATIVE_EDGE=0: the phase measures the edge
    chain behind the worker tier, as in earlier runs.  device="cpu"
    rehearses it at a small B."""
    from misaka_tpu_torch.networks import ADD2_PROGRAMS

    workers = workers or frontend_workers()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="edge-", dir=os.path.join(ROOT, "build"))
    keys = os.path.join(tmp, "keys.json")
    with open(keys, "w") as f:
        json.dump({"keys": EDGE_KEYS}, f)
    base = dict(node_info=ADD2_NODES, programs=ADD2_PROGRAMS, batch=batch, chunk=chunk,
                caps=MAIN_CAPS, device=device)
    flood_values = batch
    row = {"phase": "edge", "card": card, "workers": workers, "cpu_count": os.cpu_count(),
           "batch": batch, "chunk_steps": chunk, **MAIN_CAPS}
    t0 = time.perf_counter()
    keyed = dict(base, MISAKA_API_KEYS=keys, MISAKA_HTTP_WORKERS=str(workers),
                 MISAKA_NATIVE_EDGE="0")
    specs = [dict(keyed, label="edge_drill", MISAKA_TOKEN_SECRET=os.urandom(16).hex(),
                  MISAKA_PLANE_SOCKET=os.path.join(tmp, "drill.sock")),
             dict(keyed, label="edge_admission", MISAKA_ADMISSION_HIGH=str(4 * flood_values),
                  MISAKA_BATCH_PASSES="1", MISAKA_BATCH_MAX=str(flood_values // 8),
                  MISAKA_PLANE_SOCKET=os.path.join(tmp, "admission.sock"))]
    # the cost's servers: a (the default env) and b (MISAKA_EDGE=0), behind
    # the workers and with none
    cost_cfgs = [(cfg, n) for n in (workers, 0) for cfg in ("a", "b")]
    specs += [dict(base, label=f"edge_cost_{cfg}_{n}", MISAKA_HTTP_WORKERS=str(n),
                   MISAKA_NATIVE_EDGE="0",
                   MISAKA_PLANE_SOCKET=os.path.join(tmp, f"{cfg}{n}.sock"),
                   **({"MISAKA_EDGE": "0"} if cfg == "b" else {}))
              for cfg, n in cost_cfgs]
    try:
        # all booted at once; every server but the one measured is paused
        with served_apps(specs) as booted:
            from misaka_tpu_torch.runtime import frontends

            (drill, boot_drill), (adm, _) = booted[:2]
            ports = {c: p for c, (p, _) in zip(cost_cfgs, booted[2:])}
            row["boot_s"] = boot_drill
            keyed_window(drill)
            keyed_window(adm)
            for p in ports.values():
                expect(post_form(p, "/pause")[0] == 200, "/pause")
            for port in (drill, adm, ports[("a", workers)], ports[("b", workers)]):
                expect(frontends.wait_ready(port, timeout=30), "the public port does not answer")
            expect(call(drill, "/run", b"", ADMIN)[0] == 200, "/run as admin")
            row["drill"] = edge_drill(drill, workers)
            keyed_window(drill)
            row["admission"] = admission_drill(adm, flood_values, flooders, flood_s)
            keyed_window(adm)
            # on the CPU (a rehearsal at a small B) the flood rides the hot
            # lane and no kernel launches
            expect(device == "cpu" or (row["admission"]["iterations_equal_launches"]
                                       and row["admission"]["flood_429"] > 0),
                   f"admission: {row['admission']}")
            cost = {}
            for n in (workers, 0):
                a, b = ports[("a", n)], ports[("b", n)]
                health = {cfg: json.loads(http(p, "/healthz")[1]) for cfg, p in (("a", a),
                                                                                ("b", b))}
                expect("edge" in health["a"] and "edge" not in health["b"],
                       f"edge blocks {[h.get('edge') for h in health.values()]}")
                for p in (a, b):
                    # warm-up: the first requests after boot run slower
                    expect(post_form(p, "/run")[0] == 200, "/run")
                    small_requests(p, n_clients, 2, base=7_000_000)
                    expect(post_form(p, "/pause")[0] == 200, "/pause")
                turns = [{"config": cfg, **cost_turn(a if cfg == "a" else b, n_clients,
                                                     per_client, n_quiet)}
                         for cfg in ("a", "b", "b", "a")]

                def mean(cfg, k, turns=turns):
                    return float(np.mean([t[k] for t in turns if t["config"] == cfg]))

                cost["workers" if n else "zero_workers"] = {
                    "workers": n, "turns": turns, "edge": health["a"]["edge"],
                    "rate_ratio_a_over_b": mean("a", "small_requests_per_s")
                    / mean("b", "small_requests_per_s"),
                    "p50_ratio_a_over_b": mean("a", "p50_ms") / mean("b", "p50_ms"),
                    "p90_ratio_a_over_b": mean("a", "p90_ms") / mean("b", "p90_ms"),
                }
            row["cost"] = cost
            launches = [json.loads(call(p, "/status", headers=ADMIN)[2])["kernel_launches"]
                        for p in [drill, adm, *ports.values()]]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    from misaka_tpu_torch.core import fused

    row["kernel_launches"] = sum(k.get(fused.KERNEL, 0) for k in launches)
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    return row


# --- the program registry: per-program engines, eviction, hot swap, canary ---------

REG_ADD10 = "IN ACC\nADD 10\nOUT ACC\n"
REG_ADD20 = "IN ACC\nADD 20\nOUT ACC\n"
# a delay line: output i is input i-1 (0 on a fresh instance); BAK holds
# the last value, the state an eviction must carry
REG_DELAY = "IN ACC\nSWP\nOUT ACC\nSWP\nSAV\n"
# every delay request ends with this value, so every instance it has used
# holds it: a request's first output says whether its instance is fresh
DELAY_LAST = 777


def engine_port(label) -> int:
    """The engine's own HTTP port behind the workers, from the app's log."""
    with open(os.path.join(ROOT, "build", f"chip_smoke_{label}.log")) as f:
        m = re.search(r"engine http on 127\.0\.0\.1:(\d+)", f.read())
    expect(m is not None, f"{label}: no engine port in the log")
    return int(m.group(1))


def series(scraped, name, **labels):
    """One series' value in a parse_text scrape (0 when absent)."""
    from misaka_tpu_torch.utils import metrics

    for k, v in scraped.items():
        n, lbl = metrics.parse_series(k)
        if n == name and all(lbl.get(a) == b for a, b in labels.items()):
            return v
    return 0.0


def program_raw(port, name, vals, header=False, query="?spread=1"):
    """One program-addressed /compute_raw (its path, or X-Misaka-Program on
    the legacy route): (status, int32 answers or body, seconds)."""
    t = time.perf_counter()
    path = "/compute_raw" if header else f"/programs/{name}/compute_raw"
    c, _, b = call(port, path + query, np.asarray(vals, "<i4").tobytes(),
                   {"X-Misaka-Program": name} if header else None)
    return c, np.frombuffer(b, "<i4") if c == 200 else b, time.perf_counter() - t


def program_compute(port, name, v):
    """One /compute with X-Misaka-Program: (status, body)."""
    c, _, b = call(port, "/compute", f"value={v}".encode(), {"X-Misaka-Program": name})
    return c, b


class DelayModel:
    """The delay program's expected answers.  Every delay request is pinned
    to one instance (`?spread=0`, compute_many: the rotating slot start,
    0 after each activation, one step per request), so the k-th request
    of an engine's life lands on instance k; each ends with DELAY_LAST, so
    its first output is DELAY_LAST when an earlier request, of this life
    or one before it, used the instance, and 0 when it is fresh: revived
    state answers DELAY_LAST on instance 0, a fresh engine 0."""

    def __init__(self):
        self.used = 0   # instances any life has used so far
        self.k = 0      # the next instance of the current life

    def check(self, out, vals, new_life):
        if new_life:
            self.k = 0
        want = [DELAY_LAST if self.k < self.used else 0] + list(vals[:-1])
        expect(list(np.asarray(out).tolist()) == want, f"delay {list(out)} != {want}")
        self.k += 1
        self.used = max(self.used, self.k)
        return want[0] == DELAY_LAST


def delay_request(port, model, x, header=False):
    """One pinned delay request of [x, DELAY_LAST] (its path, or
    X-Misaka-Program), checked against the model; the activations counter
    says whether it began a new life.  Returns its row."""
    before = scrape(port)
    vals = [x, DELAY_LAST]
    c, out, secs = program_raw(port, "delay", vals, header=header, query="?spread=0")
    expect(c == 200, f"delay: {c} {out!r}")
    act = series(scrape(port), "misaka_program_activations_total", program="delay") - series(
        before, "misaka_program_activations_total", program="delay")
    revived = model.check(out, vals, act > 0) and act > 0
    return {"header": header, "seconds": secs, "activated": int(act), "revived_state": revived}


def eviction_window(before, after):
    """What the registry did between two scrapes: evictions and activations
    per program, and the checkpoint saves (count, seconds)."""
    from misaka_tpu_torch.utils import metrics

    moved = {}
    for k, v in after.items():
        n, lbl = metrics.parse_series(k)
        if n in ("misaka_program_evictions_total", "misaka_program_activations_total") \
                and v - before.get(k, 0.0):
            moved.setdefault(n.split("_")[2], {})[lbl["program"]] = int(v - before.get(k, 0.0))
    n_save = series(after, "misaka_checkpoint_save_seconds_count") - series(
        before, "misaka_checkpoint_save_seconds_count")
    s_save = series(after, "misaka_checkpoint_save_seconds_sum") - series(
        before, "misaka_checkpoint_save_seconds_sum")
    return {"evictions": moved.get("evictions", {}), "activations": moved.get("activations", {}),
            "checkpoint_saves": int(n_save), "checkpoint_seconds": s_save}


def min_allocated(samples=40, gap_s=0.005):
    """torch.cuda.memory_allocated() at rest: the least of `samples`
    readings `gap_s` apart (an engine's idle iteration holds a transient
    copy of the fields it writes)."""
    import torch

    out = []
    for _ in range(samples):
        torch.cuda.synchronize()
        out.append(torch.cuda.memory_allocated())
        time.sleep(gap_s)
    return min(out)


def registry_memory(batch, device):
    """In this process: a ProgramRegistry on `device` at the served width
    with max_active 2 activates, evicts and revives; on a card
    memory_allocated() after each eviction must be within 5% of one
    engine's state of its value before the activation that evicted.  Then
    every engine is closed and the launches must equal the loop's
    iterations plus the warm-ups (all loops stopped: exact)."""
    from misaka_tpu_torch.core import fused
    from misaka_tpu_torch.runtime import master as tmaster
    from misaka_tpu_torch.runtime.registry import ProgramRegistry

    card = device != "cpu"
    iters0 = tmaster.M_ITER_SERVE.value + tmaster.M_ITER_IDLE.value
    warm0, launch0 = tmaster.M_WARM_TOTAL.value, fused.launch_counts[fused.KERNEL]
    reg = ProgramRegistry(None, batch=batch, caps=MAIN_CAPS, max_active=2, device=device)
    row = {"max_active": 2, "steps": []}
    model = DelayModel()
    try:
        for name, src in (("a10", REG_ADD10), ("a20", REG_ADD20), ("delay", REG_DELAY)):
            reg.publish(name, tis=src)

        def touch(name, x):
            before = min_allocated() if card else 0
            t = time.perf_counter()
            acts = reg.list_programs()["programs"][name]["versions"]
            new_life = not any(v["active"] for v in acts.values())
            with reg.lease(name) as m:
                if name == "delay":
                    out = m.compute_many([x, DELAY_LAST])
                    model.check(out, [x, DELAY_LAST], new_life)
                else:
                    add = 10 if name == "a10" else 20
                    vals = np.arange(x, x + 1000, dtype=np.int32)
                    expect(np.array_equal(m.compute_coalesced(vals, return_array=True),
                                          vals + add), f"{name} answers")
                state = m._state
                state_bytes = sum(t_.numel() * t_.element_size() for t_ in state)
                del m, state
            secs = time.perf_counter() - t
            after = min_allocated() if card else 0
            row["steps"].append({"program": name, "seconds": secs, "activated": new_life,
                                 "active": [n for n, _ in reg.active_versions()],
                                 "allocated_before": before, "allocated_after": after,
                                 "state_bytes": state_bytes})
            return before, after, state_bytes

        touch("a10", 1)
        touch("delay", 11)
        # a20 evicts a10 (the least recently used), a10 then evicts delay,
        # delay then evicts a20 and must answer from its revived state
        for name, x in (("a20", 21), ("a10", 31), ("delay", 41)):
            before, after, state_bytes = touch(name, x)
            expect(not card or abs(after - before) <= 0.05 * state_bytes,
                   f"device memory after evicting for {name}: {before} -> {after} "
                   f"(one engine's state: {state_bytes} bytes)")
        expect(model.k == 1 and model.used == 1, "delay revived on instance 0")
        row["delay_revived"] = True
    finally:
        reg.close()
    iters = tmaster.M_ITER_SERVE.value + tmaster.M_ITER_IDLE.value - iters0
    warm = tmaster.M_WARM_TOTAL.value - warm0
    launches = fused.launch_counts[fused.KERNEL] - launch0
    row.update(iterations=int(iters), warmups=int(warm), kernel_launches=launches,
               released_after_close=min_allocated() if card else None)
    expect(not card or launches == iters + warm,
           f"in process: launches {launches} != iterations {iters} + warm-ups {warm}")
    return row


def phase_registry(batch=MAIN_BATCH, chunk=MAIN_CHUNK, workers=None, n_clients=32,
                   per_client=10, n_quiet=13, swap_clients=32, n_stream=20_000, device=None,
                   card=None):
    """The program registry on the main path: add2 at B (the full kernel)
    behind N frontend workers with MISAKA_PROGRAMS_DIR (a fresh directory
    on local disk), MISAKA_REGISTRY_MAX_ACTIVE=3 and a canary every second.

    1. publish add10 and delay (TIS) and reverse_any (topology JSON);
    2. serve each through /programs/<name>/compute_raw (add10 striped,
       n_stream values) and X-Misaka-Program, behind the workers and
       direct on the engine's own port; the default still answers +2, an
       unknown program the typed 404 on both paths;
    3. alternating requests (three tenants and `_canary` over a cap of 3)
       force evictions: each request's client seconds, the evictions,
       activations and checkpoint seconds it caused; delay continues its
       sequence across every round trip;
    4. 32 clients post to add10 while it is republished as ADD 20: no
       error, every answer +10 or +20, no +10 after a +20 within a client,
       one swap, the longest request across it;
    5. in this process, a registry on the card at max_active 2: device
       memory released by each eviction (registry_memory);
    6. the /healthz canary block: every tier ok, no failing tier;
    7. launches: in process exactly the iterations plus the warm-ups; in
       the server (its engines never all stop) bounded by two /status
       readings around one /metrics;
    8. then, with that server stopped, the registry's cost on the default
       program: two servers booted beside it, paused, a (MISAKA_PROGRAMS_DIR
       set) and b (unset), the small-request rate and quiet /compute
       p50/p90 in turns a b b a, the partner paused.

    Every server pins MISAKA_NATIVE_EDGE=0 (the worker tier, as in earlier
    runs).  device="cpu" rehearses it at a small B."""
    from misaka_tpu_torch.core import fused
    from misaka_tpu_torch.networks import ADD2_PROGRAMS
    from misaka_tpu_torch.runtime import frontends

    workers = workers or frontend_workers()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="registry-", dir=os.path.join(ROOT, "build"))
    base = dict(node_info=ADD2_NODES, programs=ADD2_PROGRAMS, batch=batch, chunk=chunk,
                caps=MAIN_CAPS, device=device, MISAKA_HTTP_WORKERS=str(workers),
                MISAKA_NATIVE_EDGE="0")
    row = {"phase": "registry", "card": card, "workers": workers, "batch": batch,
           "chunk_steps": chunk, **MAIN_CAPS}
    t0 = time.perf_counter()
    with open(os.path.join(EXAMPLES, "reverse_any.json")) as f:
        reverse_text = f.read()
    try:
        # the cost's servers (8.) boot beside the drill's, paused
        cost = [dict(base, label=f"registry_cost_{cfg}", autorun=False,
                     MISAKA_PLANE_SOCKET=os.path.join(tmp, f"{cfg}.sock"),
                     **({"MISAKA_PROGRAMS_DIR": os.path.join(tmp, "cost_a")} if cfg == "a"
                        else {}))
                for cfg in ("a", "b")]
        drill = dict(base, label="registry", MISAKA_PROGRAMS_DIR=os.path.join(tmp, "programs"),
                     MISAKA_REGISTRY_MAX_ACTIVE="3", MISAKA_CANARY_INTERVAL_S="1",
                     MISAKA_PLANE_SOCKET=os.path.join(tmp, "reg.sock"))
        procs = []
        with served_apps([drill, *cost], procs=procs) as [(pub, boot_s), (cost_a, _),
                                                           (cost_b, _)]:
            row["boot_s"] = boot_s
            eng = engine_port("registry")
            expect(frontends.wait_ready(pub, timeout=30), "the public port does not answer")
            # the canary's first cycle publishes and activates `_canary`:
            # let it finish before the tenants' activations begin
            deadline = time.monotonic() + 120
            while not ((json.loads(http(pub, "/healthz")[1]).get("canary") or {}).get(
                    "tiers") or {}).get("engine"):
                expect(time.monotonic() < deadline, "the canary's engine never came up")
                time.sleep(0.5)
            # 1. publish
            versions = {}
            for name, field, src in (("add10", "program", REG_ADD10),
                                     ("delay", "program", REG_DELAY),
                                     ("reverse_any", "topology", reverse_text)):
                c, _, b = call(pub, "/programs", urlencode_form(name=name, **{field: src}))
                expect(c == 200, f"publish {name}: {c} {b!r}")
                out = json.loads(b)
                expect(out["created"] and out["name"] == name and not out["swapped"],
                       f"publish {name}: {out}")
                versions[name] = out["version"]
            row["versions"] = versions
            # 2. serve each, behind the workers (pub) and direct (eng);
            # reverse_any first, so that it never serves after a revival
            # (a dumped instance parks on its empty stack for good)
            served = []
            rev_vals = [7, 8, 9, 0]
            for port, header in ((pub, False), (eng, True)):
                c, out, secs = program_raw(port, "reverse_any", rev_vals, header=header)
                expect(c == 200 and out.tolist() == [0, 9, 8, 7], f"reverse_any: {c} {out!r}")
                served.append({"program": "reverse_any", "port": "public" if port == pub
                               else "engine", "seconds": secs})
            rng = np.random.default_rng(SEED + 9)
            for port in (pub, eng):
                vals = rng.integers(-2**20, 2**20, size=n_stream).astype(np.int32)
                for header in (False, True):
                    c, out, secs = program_raw(port, "add10", vals, header=header)
                    expect(c == 200 and np.array_equal(out, vals + 10), f"add10 striped: {c}")
                    served.append({"program": "add10", "port": "public" if port == pub
                                   else "engine", "header": header, "seconds": secs})
                c, b = program_compute(port, "add10", 5)
                expect(c == 200 and json.loads(b) == {"value": 15}, f"add10 /compute: {c} {b!r}")
                c, b = post_form(port, "/compute", value="5")
                expect(c == 200 and json.loads(b) == {"value": 7}, f"default: {c} {b!r}")
                for path, hdr in (("/programs/ghost/compute_raw", None),
                                  ("/compute_raw", {"X-Misaka-Program": "ghost"})):
                    c, _, b = call(port, path, np.asarray([1], "<i4").tobytes(), hdr)
                    expect(c == 404 and b == b"unknown program 'ghost'", f"ghost: {c} {b!r}")
            model = DelayModel()
            for i, (port, header) in enumerate(((pub, False), (eng, True), (pub, True),
                                                (eng, False))):
                r = delay_request(port, model, 100 + i, header)
                served.append({"program": "delay", "port": "public" if port == pub
                               else "engine", **r})
            row["served"] = served
            # 3. evict and revive: alternating add10 and delay, 3 tenants
            # and the canary over a cap of 3, 2 rounds of each (was 3; every
            # round still evicts and revives)
            rounds = []
            s_all = scrape(pub)
            for i in range(2):
                for name in ("add10", "delay"):
                    before = scrape(pub)
                    if name == "delay":
                        r = delay_request(pub, model, 200 + i)
                    else:
                        vals = np.arange(i * 100, i * 100 + 100, dtype=np.int32)
                        c, out, secs = program_raw(pub, "add10", vals)
                        expect(c == 200 and np.array_equal(out, vals + 10), "add10 round trip")
                        r = {"seconds": secs}
                    rounds.append({"program": name, **r,
                                   **eviction_window(before, scrape(pub))})
            total = eviction_window(s_all, scrape(pub))
            revivals = [r["seconds"] for r in rounds if r.get("activations", {}).get(
                r["program"])]
            row["evict_revive"] = {
                "rounds": rounds, **total,
                "checkpoint_seconds_each": (total["checkpoint_seconds"]
                                            / max(1, total["checkpoint_saves"])),
                "reviving_request_s": revivals,
                "delay_revived_state": sum(1 for r in rounds if r.get("revived_state")),
            }
            expect(sum(total["evictions"].values()) >= 2 and revivals,
                   f"no evictions forced: {total}")
            expect(row["evict_revive"]["delay_revived_state"] >= 1,
                   "delay never answered from revived state")
            # 4. hot swap under load
            row["hot_swap"] = hot_swap_drill(pub, swap_clients)
            # 5. device memory, in this process
            row["memory"] = registry_memory(batch, device or "cuda")
            # 6. the canary
            deadline = time.monotonic() + 60
            while True:
                health = json.loads(http(pub, "/healthz")[1])
                can = health.get("canary") or {}
                if can.get("failing_tier") is None and all(
                        (can.get("tiers") or {}).get(t) for t in ("edge", "plane", "engine",
                                                                  "full")):
                    break
                expect(time.monotonic() < deadline, f"canary not green: {can}")
                time.sleep(0.5)
            row["canary"] = can
            # each activation's split, from the server's log
            with open(os.path.join(ROOT, "build", "chip_smoke_registry.log")) as f:
                row["engines_up"] = [
                    {"program": m[0], "seconds": float(m[1]), "build_s": float(m[2]),
                     "restore_s": float(m[3]), "warm_s": float(m[4])}
                    for m in re.findall(r"program (\S+)@\w+: engine up in ([\d.]+)s \(build "
                                        r"([\d.]+), restore ([\d.]+), warm-up ([\d.]+)\)",
                                        f.read())]
            # 7. launches in the server, bounded (its engines keep ticking)
            l1 = status(pub)["kernel_launches"][fused.KERNEL]
            m = scrape(pub)
            l2 = status(pub)["kernel_launches"][fused.KERNEL]
            it = sum(series(m, "misaka_device_loop_iterations_total", kind=k)
                     for k in ("serve", "idle"))
            warm = series(m, "misaka_engine_warm_total")
            n_engines = len(status(pub)["programs"]["active"])
            row["launches"] = {"status_before": l1, "iterations": it, "warmups": warm,
                               "status_after": l2, "active_engines": n_engines}
            expect(device == "cpu" or l1 - n_engines - 1 <= it + warm <= l2,
                   f"server launches: {row['launches']}")
            launches = [l2]
            # 8. the registry's cost on the default program, the drill's
            # server stopped
            _stop_app(procs[0])
            for p in (cost_a, cost_b):
                expect(frontends.wait_ready(p, timeout=30), "the public port does not answer")
                expect(post_form(p, "/run")[0] == 200, "/run")
                small_requests(p, n_clients, 2, base=7_000_000)  # warm-up
                expect(post_form(p, "/pause")[0] == 200, "/pause")
            turns = [{"config": cfg, **cost_turn(cost_a if cfg == "a" else cost_b, n_clients,
                                                 per_client, n_quiet)}
                     for cfg in ("a", "b", "b", "a")]

            def mean(cfg, k):
                return float(np.mean([t[k] for t in turns if t["config"] == cfg]))

            row["cost"] = {
                "turns": turns,
                "rate_ratio_a_over_b": mean("a", "small_requests_per_s")
                / mean("b", "small_requests_per_s"),
                "p50_ratio_a_over_b": mean("a", "p50_ms") / mean("b", "p50_ms"),
                "p90_ratio_a_over_b": mean("a", "p90_ms") / mean("b", "p90_ms"),
                "a_programs": status(cost_a).get("programs"),
            }
            launches += [status(p)["kernel_launches"][fused.KERNEL] for p in (cost_a, cost_b)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row["kernel_launches"] = sum(launches) + row["memory"]["kernel_launches"]
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    return row


def urlencode_form(**fields) -> bytes:
    from urllib.parse import urlencode

    return urlencode(fields).encode()


def hot_swap_drill(port, n_clients):
    """n_clients post [v, v+1] to add10 while it is republished as ADD 20
    (once every client has an answer; stopped once every client has one
    from after the publish returned): every answer +10 or +20, never +10
    after +20 within a client, no error, one swap; the longest request
    across it."""
    c, out, _ = program_raw(port, "add10", [0])  # active before the load starts
    expect(c == 200 and out.tolist() == [10], f"add10 before the swap: {c} {out!r}")
    before = scrape(port)
    stop = threading.Event()
    seen = [[] for _ in range(n_clients)]  # (delta, seconds, finished at)

    def client(i):
        v = i * 1_000_000
        while not stop.is_set():
            c, out, secs = program_raw(port, "add10", [v, v + 1])
            if c != 200:
                raise RuntimeError(f"add10 during the swap: {c} {out!r}")
            d = int(out[0]) - v
            if d not in (10, 20) or int(out[1]) - (v + 1) != d:
                raise RuntimeError(f"add10 during the swap answered {out.tolist()} for {v}")
            if seen[i] and seen[i][-1][0] == 20 and d == 10:
                raise RuntimeError("a +10 after a +20")
            seen[i].append((d, secs, time.monotonic()))
            v += 2

    result = {}

    def publish():
        deadline = time.monotonic() + 120
        while not all(seen) and time.monotonic() < deadline:
            time.sleep(0.05)
        t = time.perf_counter()
        c, _, b = call(port, "/programs", urlencode_form(name="add10", program=REG_ADD20))
        result["publish"] = (c, b, time.perf_counter() - t)
        done = time.monotonic()
        while not all(s and s[-1][2] > done for s in seen) and time.monotonic() < deadline:
            time.sleep(0.05)
        stop.set()

    pub = threading.Thread(target=publish)
    pub.start()
    errors, secs = run_clients(n_clients, client)
    stop.set()
    pub.join()
    expect(not errors, f"hot swap clients: {errors[:4]}")
    c, b, publish_s = result["publish"]
    expect(c == 200 and json.loads(b)["swapped"], f"republish add10: {c} {b!r}")
    swaps = series(scrape(port), "misaka_program_swaps_total", program="add10") - series(
        before, "misaka_program_swaps_total", program="add10")
    expect(swaps == 1, f"swaps {swaps}")
    answers = [d for s in seen for d, _, _ in s]
    expect(answers.count(20) > 0 and answers.count(10) > 0, "both versions answered")
    c, out, _ = program_raw(port, "add10", [1])
    expect(c == 200 and out.tolist() == [21], "add10 after the swap")
    times = [t for s in seen for _, t, _ in s]
    return {"clients": n_clients, "requests": len(answers), "plus10": answers.count(10),
            "plus20": answers.count(20), "errors": 0, "swaps": swaps,
            "publish_s": publish_s, "longest_request_s": max(times),
            "p50_request_s": float(np.median(times)), "seconds": secs}


# --- the telemetry planes: ledger, SLO, faults, capture and replay ------------------

TELE_SECRET = "chip-usage-secret"
# an equivalent rewrite of the delay line (a trailing NOP: a new version
# ID, the same answers) and add2's twin that adds 3 (the same state shapes)
TELE_DELAY_V2 = REG_DELAY + "NOP\n"
TELE_DELAY_V3 = REG_DELAY + "NOP\nNOP\n"


def add3_topology_json() -> str:
    from misaka_tpu_torch.networks import ADD2_PROGRAMS

    progs = dict(ADD2_PROGRAMS)
    progs["misaka2"] = progs["misaka2"].replace("ADD 1", "ADD 2")
    return json.dumps({"nodes": {k: v["type"] for k, v in ADD2_NODES.items()},
                       "programs": progs})


def usage_rows(port):
    return json.loads(http(port, "/debug/usage", timeout=60)[1])


def usage_delta(before, after, name):
    b = before["programs"].get(name, {})
    return {k: after["programs"].get(name, {}).get(k, 0) - b.get(k, 0)
            for k in ("requests", "values", "cpu_seconds", "queue_seconds")}


def alert_states(port):
    progs = json.loads(http(port, "/debug/alerts", timeout=60)[1])["programs"]
    return {p: progs.get(p, {}).get("state") for p in ("tenant-a", "tenant-b", "default")}


def start_replay(args, device):
    """Start `python -m misaka_tpu_torch replay ...` in the background (the
    replays of one phase run side by side): a handle for finish_replay."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("MISAKA_")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "misaka_tpu_torch", "replay", *args]
    if device is not None:
        cmd += ["--device", device]
    return time.perf_counter(), subprocess.Popen(
        cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_replay(handle):
    """(rc, output lines, seconds) of a start_replay."""
    t, proc = handle
    try:
        out, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    return proc.returncode, out.splitlines(), time.perf_counter() - t


def kill_replays(handles):
    """Stop the replays a failed phase left running."""
    for _, proc in handles:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def run_replay(args, device):
    """`python -m misaka_tpu_torch replay ...`: (rc, output lines, seconds)."""
    return finish_replay(start_replay(args, device))


def slo_drill(eng, pub, fault_s, n_clients=9, hol_s=4.0):
    """serve_delay:tenant-a=fault_s armed over POST /debug/faults: tenant-a
    pages on /debug/alerts and /healthz turns degraded while tenant-b and
    the default stay ok and tenant-b gets no 429; cleared, everything
    returns to ok.  n_clients small-request clients, spread over the three
    programs, post to the engine's own port meanwhile: behind the workers
    a plane connection answers its frames in order, so a faulted tenant's
    frame holds its neighbours' frames queued behind it (their latency
    counts from the worker's receipt).  That effect is read after the
    drill, with the fault armed again for hol_s: tenant-b's latency
    through the public port against the engine's port, states not held."""
    stop = threading.Event()
    answers = {"tenant-a": [], "tenant-b": [], "default": []}

    def client(port, prog, i, lat=None):
        add = {"tenant-a": 10, "tenant-b": 20, "default": 2}[prog]
        v = i * 1_000_000
        path = "/compute_raw" if prog == "default" else f"/programs/{prog}/compute_raw"
        while not stop.is_set():
            t = time.perf_counter()
            c, _, b = call(port, path + "?spread=1", np.asarray([v], "<i4").tobytes())
            if c == 200 and np.frombuffer(b, "<i4").tolist() != [v + add]:
                raise RuntimeError(f"{prog} answered {np.frombuffer(b, '<i4')} for {v}")
            answers[prog].append(c)
            if lat is not None:
                lat.append(time.perf_counter() - t)
            v += 1

    def arm(spec):
        c, _, b = call(eng, "/debug/faults", urlencode_form(spec=spec))
        want = {"armed": [spec.split("=")[0]] if spec else []}
        expect(c == 200 and json.loads(b) == want, f"/debug/faults {spec!r}: {c} {b!r}")

    progs = ("tenant-a", "tenant-b", "default")
    out = {}
    th = threading.Thread(target=lambda: out.setdefault("errors", run_clients(
        n_clients, lambda i: client(eng, progs[i % 3], i))[0]))
    th.start()
    try:
        deadline = time.monotonic() + 60
        while alert_states(eng) != {"tenant-a": "ok", "tenant-b": "ok", "default": "ok"}:
            expect(time.monotonic() < deadline, f"not all ok before the fault: "
                                                f"{alert_states(eng)}")
            time.sleep(0.25)
        arm(f"serve_delay:tenant-a={fault_s}")
        t0 = time.perf_counter()
        while alert_states(eng)["tenant-a"] != "page":
            expect(time.perf_counter() - t0 < 60, f"tenant-a never paged: {alert_states(eng)}")
            time.sleep(0.2)
        out["page_after_s"] = time.perf_counter() - t0
        out["paged_states"] = alert_states(eng)
        health = json.loads(http(pub, "/healthz")[1])
        out["paged_health"] = {"slo": health.get("slo"), "degraded": health.get("degraded")}
        alerts = json.loads(http(eng, "/debug/alerts")[1])["programs"]["tenant-a"]
        out["exemplars"] = len(alerts.get("exemplars") or [])
        expect(out["paged_states"] == {"tenant-a": "page", "tenant-b": "ok", "default": "ok"},
               f"paged states {out['paged_states']}")
        expect(out["paged_health"] == {"slo": "page", "degraded": True},
               f"/healthz while paging: {out['paged_health']}")
        arm("")
        t1 = time.perf_counter()
        while alert_states(eng) != {"tenant-a": "ok", "tenant-b": "ok", "default": "ok"}:
            expect(time.perf_counter() - t1 < 90, f"no recovery: {alert_states(eng)}")
            time.sleep(0.25)
        out["recover_after_s"] = time.perf_counter() - t1
        health = json.loads(http(pub, "/healthz")[1])
        expect(health.get("slo") == "ok" and health.get("degraded") is False,
               f"/healthz after recovery: {health}")
    finally:
        stop.set()
        th.join()
    expect(not out["errors"], f"drill clients: {out['errors'][:4]}")
    out["statuses"] = {p: dict(collections.Counter(v)) for p, v in answers.items()}
    expect(set(out["statuses"]["tenant-b"]) == {200}, f"tenant-b: {out['statuses']}")
    # the plane's head-of-line effect: tenant-b behind the workers and
    # direct, with tenant-a faulted and loaded through the workers
    hol = {}
    for armed in (False, True):
        if armed:
            arm(f"serve_delay:tenant-a={fault_s}")
        stop.clear()
        lat_pub, lat_eng = [], []
        jobs = [lambda i: client(pub, "tenant-a", i), lambda i: client(pub, "tenant-b", i,
                                                                         lat_pub),
                lambda i: client(eng, "tenant-b", i, lat_eng)]
        timer = threading.Timer(hol_s, stop.set)
        timer.start()
        errors, _ = run_clients(3, lambda i: jobs[i](i))
        timer.join()
        expect(not errors, f"head-of-line clients: {errors[:4]}")
        hol["faulted" if armed else "healthy"] = {"tenant_b_public": latency_ms(lat_pub),
                                                  "tenant_b_engine": latency_ms(lat_eng)}
    arm("")
    out["head_of_line"] = hol
    return out


def capture_memory(batch, device, n_delay=40):
    """In this process, on the card: an anchor's size and the time to cut
    it; device memory across capture start -> stop -> start (the second
    anchor replaces the first); a shadow engine's build, restore and
    per-record replay; the registry's ?verify=replay gate refusing a
    mutant with memory back where it was (the shadow freed)."""
    import gc

    import torch

    from misaka_tpu_torch.core import fused
    from misaka_tpu_torch.runtime import capture
    from misaka_tpu_torch.runtime import master as tmaster
    from misaka_tpu_torch.runtime.registry import ProgramRegistry, ReplayDivergence

    card = device != "cpu"
    launch0 = fused.launch_counts[fused.KERNEL]
    mem = min_allocated if card else (lambda: 0)
    row = {}
    reg = ProgramRegistry(None, batch=batch, caps=MAIN_CAPS, device=device)
    capture.configure({"MISAKA_CAPTURE_SAMPLE": "1.0"})
    try:
        reg.publish("d", tis=REG_DELAY)
        with reg.lease("d") as m:
            m0 = mem()
            t = time.perf_counter()
            a1 = capture.anchor_from_master("d", m)
            if card:
                torch.cuda.synchronize()
            row["anchor_cut_s"] = time.perf_counter() - t
            row["anchor_bytes"] = sum(x.numel() * x.element_size() for x in a1["state"])
            capture.start(anchors={"d": a1})
            del a1
            m1 = mem()
            capture.stop()
            m2 = mem()
            capture.start(anchors={"d": capture.anchor_from_master("d", m)})
            m3 = mem()
            row["memory"] = {"before": m0, "started": m1, "stopped": m2, "restarted": m3}
            expect(not card or (abs(m1 - m0 - row["anchor_bytes"]) <= 0.05 * row["anchor_bytes"]
                                and m2 == m1 and abs(m3 - m1) <= 0.05 * row["anchor_bytes"]),
                   f"anchor memory {row['memory']} (one anchor: {row['anchor_bytes']})")
            for i in range(n_delay):  # serialized: one pinned request at a time
                vals = np.asarray([i, DELAY_LAST], np.int32)
                out = m.compute_many(vals, return_array=True)
                capture.note("http", program="d", trace=None, inbound=False,
                             vals=vals.tobytes(), resp=out.astype("<i4").tobytes(),
                             status=200, tick=int(m._ticks_done), op="many")
            capture.stop()
            topo = m._topology
            del m
        anchor, recs = capture.verify_bundle("d")
        before = mem()
        t = time.perf_counter()
        shadow = tmaster.MasterNode(topo, batch=batch, device=device)
        row["shadow_build_s"] = time.perf_counter() - t
        t = time.perf_counter()
        shadow.restore(anchor["state"])
        shadow.run()
        row["shadow_restore_s"] = time.perf_counter() - t
        t = time.perf_counter()
        diffs = capture.replay_records(shadow, recs)
        row["replay_s_per_record"] = (time.perf_counter() - t) / len(recs)
        row["replayed_records"] = len(recs)
        shadow.close()
        del shadow
        gc.collect()
        expect(diffs == [], f"in-process replay diverged: {diffs[:2]}")
        after = mem()
        row["shadow_memory"] = {"before": before, "after_freed": after}
        expect(not card or abs(after - before) <= 0.05 * row["anchor_bytes"],
               f"memory after the shadow was freed: {before} -> {after}")
        before = mem()
        t = time.perf_counter()
        try:
            reg.publish("d", tis=REG_ADD10, verify="replay")
            raise SystemExit("main path check failed: the gate admitted a mutant")
        except ReplayDivergence as e:
            row["gate_409_diffs"] = len(e.diffs)
            del e
        row["gate_s"] = time.perf_counter() - t
        gc.collect()
        after = mem()
        row["gate_memory"] = {"before": before, "after": after}
        expect(not card or abs(after - before) <= 0.05 * row["anchor_bytes"],
               f"memory after the refused gate: {before} -> {after}")
    finally:
        capture.configure()
        capture.start()  # drop the anchors: the ring and its clones go
        capture.stop()
        reg.close()
    row["kernel_launches"] = fused.launch_counts[fused.KERNEL] - launch0
    return row


def phase_telemetry(batch=MAIN_BATCH, chunk=MAIN_CHUNK, workers=None, n_clients=32,
                    per_client=20, n_raw_clients=32, raw_values=12_500, n_quiet=13,
                    capture_clients=32, n_delay=40, n_b1=100, slo_ms=250, fault_s=0.5,
                    drill_clients=9, min_events=3, canary=True, device=None, card=None):
    """The telemetry planes on the main path: add2 at B (the full kernel)
    behind N frontend workers with MISAKA_PROGRAMS_DIR, two tenants
    (tenant-a +10, tenant-b +20), MISAKA_SLO="p99<{slo_ms}ms" over windows
    shrunk to 2/4/8/16 s, and a usage secret.

    1. ledger: n_clients x per_client /compute and n_raw_clients x
       raw_values-value /compute_raw on the engine's own port, counted
       exactly per program on /debug/usage; behind the workers the values
       exactly (requests are the plane's frames); cpu_seconds summed over
       programs, `_canary` included, against the pass-wall anchor within
       5%; /usage/export verified by `python -m misaka_tpu_torch
       usage-report`;
    2. SLO drill (slo_drill, a fault of fault_s on tenant-a's passes);
    3. capture: the delay line re-published (a fresh engine, its slot
       cursor at 0) and anchored with the rest at /captures/start, 32
       clients striping add2 behind the workers while delay is served one
       pinned request at a time, the segment exported and replayed on the
       card by `python -m misaka_tpu_torch replay` (green for add2 and
       delay), a candidate adding 3 (diverges at the first record's index
       0), the deploy gate (an equivalent delay swaps, ADD 10 answers
       409 and the old version keeps serving);
    4. in this process: capture_memory;
    5. the README env (unbatched, B=1): 100 /compute captured and
       replayed green;
    6. the cost, a b b a: a with MISAKA_USAGE=0 MISAKA_CAPTURE=0 and no
       MISAKA_SLO, b with the ledger, MISAKA_SLO and a recording.

    Every server pins MISAKA_NATIVE_EDGE=0 (the worker tier, as in earlier
    runs).

    device="cpu" rehearses it at a small B (no memory checks; canary=False,
    a looser objective and a longer fault there: on the CPU every idle
    engine burns a core, and the plain version serves in seconds)."""
    from misaka_tpu_torch.core import fused
    from misaka_tpu_torch.networks import ADD2_PROGRAMS
    from misaka_tpu_torch.runtime import frontends

    workers = workers or frontend_workers()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="telemetry-", dir=os.path.join(ROOT, "build"))
    base = dict(node_info=ADD2_NODES, programs=ADD2_PROGRAMS, batch=batch, chunk=chunk,
                caps=MAIN_CAPS, device=device, MISAKA_HTTP_WORKERS=str(workers),
                MISAKA_NATIVE_EDGE="0")
    row = {"phase": "telemetry", "card": card, "workers": workers, "batch": batch,
           "chunk_steps": chunk, **MAIN_CAPS}
    t0 = time.perf_counter()
    launches = []
    replays = []  # the background replays, stopped if the phase fails
    rng = np.random.default_rng(SEED + 11)
    try:
        with served_app("telemetry", MISAKA_PROGRAMS_DIR=os.path.join(tmp, "programs"),
                        MISAKA_SLO=f"p99<{slo_ms}ms", MISAKA_SLO_WINDOWS="2,4,8,16",
                        MISAKA_SLO_MIN_EVENTS=str(min_events), MISAKA_USAGE_SECRET=TELE_SECRET,
                        MISAKA_CAPTURE_DIR=os.path.join(tmp, "captures"),
                        MISAKA_PLANE_SOCKET=os.path.join(tmp, "tele.sock"),
                        **({} if canary else {"MISAKA_CANARY": "0"}), **base) as (pub, boot_s):
            row["boot_s"] = boot_s
            eng = engine_port("telemetry")
            expect(frontends.wait_ready(pub, timeout=30), "the public port does not answer")
            for name, src in (("tenant-a", REG_ADD10), ("tenant-b", REG_ADD20)):
                c, _, b = call(pub, "/programs", urlencode_form(name=name, program=src))
                expect(c == 200, f"publish {name}: {c} {b!r}")
                c, out, _ = program_raw(pub, name, [1])
                expect(c == 200 and out.tolist() == [1 + (10 if name == "tenant-a" else 20)],
                       f"{name}: {c} {out!r}")
            # 1. the ledger
            u0 = usage_rows(eng)
            n, secs = small_requests(eng, n_clients, per_client, base=9_000_000)
            raw = [rng.integers(-2**20, 2**20, size=raw_values).astype(np.int32)
                   for _ in range(n_raw_clients)]

            def raw_client(i):
                c, out, _ = program_raw(eng, "tenant-a", raw[i])
                if c != 200 or not np.array_equal(out, raw[i] + 10):
                    raise RuntimeError(f"tenant-a raw {i}: {c}")

            errors, raw_s = run_clients(n_raw_clients, raw_client)
            expect(not errors, f"ledger raw clients: {errors[:4]}")
            u1 = usage_rows(eng)
            d_def, d_a = usage_delta(u0, u1, "default"), usage_delta(u0, u1, "tenant-a")
            expect((d_def["requests"], d_def["values"]) == (n, n),
                   f"default booked {d_def} for {n} requests")
            expect((d_a["requests"], d_a["values"]) == (n_raw_clients,
                                                        n_raw_clients * raw_values),
                   f"tenant-a booked {d_a}")
            vals = rng.integers(-2**20, 2**20, size=raw_values).astype(np.int32)
            pub_reqs = 16

            def pub_client(i):
                c, _, b = call(pub, "/compute_raw", vals.tobytes())
                if c != 200 or not np.array_equal(np.frombuffer(b, "<i4"), vals + 2):
                    raise RuntimeError(f"public /compute_raw: {c} {b[:200]!r}")

            errors, _ = run_clients(pub_reqs, pub_client)
            expect(not errors, f"public stream: {errors[:4]}")
            u2 = usage_rows(eng)
            d_pub = usage_delta(u1, u2, "default")
            expect(d_pub["values"] == pub_reqs * raw_values and 1 <= d_pub["requests"] <= pub_reqs,
                   f"behind the workers: {d_pub}")
            cpu_total = sum(p["cpu_seconds"] for p in u2["programs"].values())
            expect(abs(cpu_total - u2["pass_seconds_total"]) <= 0.05 * u2["pass_seconds_total"],
                   f"conservation: {cpu_total} vs {u2['pass_seconds_total']}")
            env = {k: v for k, v in os.environ.items() if not k.startswith("MISAKA_")}
            env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
            rep = subprocess.run(
                [sys.executable, "-m", "misaka_tpu_torch", "usage-report", "--url",
                 f"http://127.0.0.1:{pub}", "--secret", TELE_SECRET],
                cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
            expect(rep.returncode == 0, f"usage-report: {rep.returncode} {rep.stderr[-300:]}")
            report = json.loads(rep.stdout)
            expect(report["verified"] and report["programs"]["tenant-a"]["values"]
                   >= n_raw_clients * raw_values and "_canary" not in report["programs"],
                   f"usage report {report}")
            row["ledger"] = {
                "small_requests": n, "small_seconds": secs, "raw_seconds": raw_s,
                "default": d_def, "tenant_a": d_a, "public_stream": d_pub,
                "cpu_seconds_total": cpu_total, "pass_seconds_total": u2["pass_seconds_total"],
                "conservation_ratio": cpu_total / u2["pass_seconds_total"],
                "canary_cpu_seconds": u2["programs"].get("_canary", {}).get("cpu_seconds"),
                "report_periods": report["periods"]}
            # 2. SLO
            row["slo"] = slo_drill(eng, pub, fault_s, drill_clients)
            # 3. capture: delay re-published, so its engine is fresh (slot
            # cursor 0, as a shadow's) when the capture anchors it
            c, _, b = call(pub, "/programs", urlencode_form(name="delay", program=REG_DELAY))
            expect(c == 200, f"publish delay: {c} {b!r}")
            c, out, _ = program_raw(pub, "delay", [5, DELAY_LAST], query="?spread=0")
            expect(c == 200 and out.tolist() == [0, 5], f"delay first: {c} {out!r}")
            c, _, b = call(pub, "/programs", urlencode_form(name="delay", program=TELE_DELAY_V2))
            expect(c == 200 and json.loads(b)["swapped"], f"delay v2: {c} {b!r}")
            t = time.perf_counter()
            c, _, b = call(pub, "/captures/start", b"")
            row_cap = {"start_s": time.perf_counter() - t}
            st = json.loads(b)
            expect(c == 200 and st["recording"] and {"default", "delay"} <= set(st["anchors"]),
                   f"/captures/start: {c} {b!r}")
            row_cap["anchored"] = sorted(st["anchors"])

            def cap_client(i):
                for j in range(5):
                    v = rng_vals[i][j]
                    check_raw(pub, v)

            rng_vals = [[rng.integers(-1000, 1000, size=64).astype(np.int32) for _ in range(5)]
                        for _ in range(capture_clients)]
            th = threading.Thread(target=lambda: row_cap.setdefault(
                "errors", run_clients(capture_clients, cap_client)[0]))
            th.start()
            for i in range(n_delay):
                # pinned request i lands on instance i mod B of the fresh v2
                c, out, _ = program_raw(pub, "delay", [i, DELAY_LAST], query="?spread=0")
                want = [DELAY_LAST if i >= batch else 0, i]
                expect(c == 200 and out.tolist() == want, f"delay {i}: {out!r} != {want}")
            th.join()
            expect(not row_cap["errors"], f"capture clients: {row_cap['errors'][:4]}")
            dbg = json.loads(http(pub, "/debug/captures?n=0")[1])
            row_cap.update(records=dbg["records"], ring_bytes=dbg["ring_bytes"],
                           dropped=dbg["dropped"])
            expect(call(pub, "/captures/stop", b"")[0] == 200, "/captures/stop")
            seg = os.path.join(tmp, "captures", "telemetry.mskcap")
            t = time.perf_counter()
            c, _, b = call(pub, "/captures/export", urlencode_form(path=seg))
            row_cap["export_s"] = time.perf_counter() - t
            exp = json.loads(b)
            expect(c == 200 and exp["dropped"] == 0, f"export: {c} {b!r}")
            row_cap["anchor_file_bytes"] = {k: os.path.getsize(v) for k, v in
                                            exp["anchors"].items()}
            # every anchored program in one process: add2 and delay green,
            # tenant-b anchored with nothing recorded
            cand = os.path.join(tmp, "add3.json")
            with open(cand, "w") as f:
                f.write(add3_topology_json())
            # the segment and the add3 candidate, replayed side by side
            handles = [start_replay([seg], device),
                       start_replay([seg, "--program", "default", "--candidate", cand], device)]
            replays += handles
            rc, lines, secs = finish_replay(handles[0])
            green = {ln.split(":")[0] for ln in lines if "replay green" in ln}
            expect(rc == 0 and {"default", "delay"} <= green, f"replay: {rc} {lines[-4:]}")
            replayed = {"segment": {"seconds": secs, "lines": lines}}
            rc, lines, secs = finish_replay(handles[1])
            expect(rc == 1 and lines[0].startswith("DIVERGENCE offset=0 ")
                   and "first_diff_index=0 " in lines[0] and "DIVERGED on" in lines[-1],
                   f"candidate add3: {rc} {lines[:2]} {lines[-1:]}")
            replayed["candidate_add3"] = {"seconds": secs, "first": lines[0], "last": lines[-1]}
            row_cap["replays"] = replayed
            # the deploy gate
            t = time.perf_counter()
            c, _, b = call(pub, "/programs?verify=replay",
                           urlencode_form(name="delay", program=TELE_DELAY_V3))
            row_cap["gate_green_s"] = time.perf_counter() - t
            expect(c == 200 and json.loads(b)["swapped"], f"gate, equivalent: {c} {b!r}")
            t = time.perf_counter()
            c, _, b = call(pub, "/programs?verify=replay",
                           urlencode_form(name="delay", program=REG_ADD10))
            row_cap["gate_409_s"] = time.perf_counter() - t
            body = json.loads(b) if c == 409 else {}
            expect(c == 409 and body.get("diffs") and "diverged" in body.get("error", ""),
                   f"gate, mutant: {c} {b[:200]!r}")
            row_cap["gate_409_diffs"] = len(body["diffs"])
            c, out, _ = program_raw(pub, "delay", [9, DELAY_LAST], query="?spread=0")
            expect(c == 200 and out.tolist() == [0, 9], f"delay after the 409: {c} {out!r}")
            row["capture"] = row_cap
            launches.append(status(eng)["kernel_launches"][fused.KERNEL])
        # 4. in this process
        row["in_process"] = capture_memory(batch, device or "cuda", n_delay=n_delay)
        launches.append(row["in_process"]["kernel_launches"])
        # 5. the B=1 kernel: the README env, captured and replayed
        with served_app("telemetry_b1", ADD2_NODES, readme_programs(), None, None, None,
                        device=device, MISAKA_CAPTURE_DIR=os.path.join(tmp, "captures")) \
                as (port, _):
            expect(call(port, "/captures/start", b"")[0] == 200, "B=1 /captures/start")
            for v in range(n_b1):
                c, b = post_form(port, "/compute", value=str(v))
                expect(c == 200 and json.loads(b) == {"value": v + 2}, f"B=1 /compute {v}")
            seg1 = os.path.join(tmp, "captures", "b1.mskcap")
            c, _, b = call(port, "/captures/export", urlencode_form(path=seg1))
            expect(c == 200 and json.loads(b)["records"] == n_b1, f"B=1 export: {c} {b!r}")
            launches.append(status(port)["kernel_launches"][fused.KERNEL])
        b1_replay = start_replay([seg1], device)  # runs while the cost servers boot
        replays.append(b1_replay)
        # 6. the cost, a b b a
        cost = [dict(base, label=f"telemetry_cost_{cfg}", autorun=False,
                     MISAKA_PLANE_SOCKET=os.path.join(tmp, f"{cfg}.sock"),
                     **({"MISAKA_USAGE": "0", "MISAKA_CAPTURE": "0"} if cfg == "a"
                        else {"MISAKA_SLO": f"p99<{slo_ms}ms"}))
                for cfg in ("a", "b")]
        with served_apps(cost) as [(cost_a, _), (cost_b, _)]:
            rc, lines, secs = finish_replay(b1_replay)
            expect(rc == 0 and lines == [f"default: replay green — {n_b1} requests "
                                         "byte-for-byte identical"],
                   f"B=1 replay: {rc} {lines[-3:]}")
            row["b1_replay"] = {"records": n_b1, "seconds": secs}
            for p in (cost_a, cost_b):
                expect(frontends.wait_ready(p, timeout=30), "the public port does not answer")
                expect(post_form(p, "/run")[0] == 200, "/run")
                small_requests(p, n_clients, 2, base=7_000_000)  # warm-up
                expect(post_form(p, "/pause")[0] == 200, "/pause")
            expect(call(cost_b, "/captures/start", b"")[0] == 200, "b: /captures/start")
            turns = [{"config": cfg, **cost_turn(cost_a if cfg == "a" else cost_b, n_clients,
                                                 per_client, n_quiet)}
                     for cfg in ("a", "b", "b", "a")]
            b_cap = json.loads(http(cost_b, "/debug/captures?n=0")[1])
            expect(b_cap["recording"] and b_cap["records"] > 0, f"b recorded {b_cap}")

            def mean(cfg, k):
                return float(np.mean([t[k] for t in turns if t["config"] == cfg]))

            row["cost"] = {
                "turns": turns, "b_ring_bytes": b_cap["ring_bytes"],
                "b_records": b_cap["records"],
                "rate_ratio_b_over_a": mean("b", "small_requests_per_s")
                / mean("a", "small_requests_per_s"),
                "p50_ratio_b_over_a": mean("b", "p50_ms") / mean("a", "p50_ms"),
                "p90_ratio_b_over_a": mean("b", "p90_ms") / mean("a", "p90_ms"),
            }
            launches += [status(p)["kernel_launches"][fused.KERNEL] for p in (cost_a, cost_b)]
    finally:
        kill_replays(replays)
        shutil.rmtree(tmp, ignore_errors=True)
    row["kernel_launches"] = sum(launches)
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    return row


# --- the observatory: the always-on and durable planes ---------------------------------

# the watchdog drill's page rule: p99 of the engine's /compute over a bound
# of the latency buckets (1 s), so an unfaulted request never reads past it
# and a request held by the injected delay always does
OBS_HOT_RULE = ("hot=misaka_http_request_duration_seconds:p99{route=/compute}"
                ">1 for 2s ->page")
OBS_FAULT_S = 1.5


def observatory_rules():
    """MISAKA_WATCHDOG: the default rules at a 1 s interval, plus the
    drill's page rule."""
    from misaka_tpu_torch.utils import watchdog

    return ",".join([r.spec for r in watchdog.default_rules(1.0)] + [OBS_HOT_RULE])


def stream_for(port, seconds, n_clients, n_values, rng, gap_s=0.0):
    """n_clients threads posting /compute_raw of n_values (striped) for
    `seconds`, every answer checked: [(start, end)] per request (monotonic)
    and the errors."""
    vals = [rng.integers(-2**20, 2**20, size=n_values).astype(np.int32)
            for _ in range(n_clients)]
    spans = [[] for _ in range(n_clients)]
    stop_at = time.monotonic() + seconds

    def client(i):
        while time.monotonic() < stop_at:
            t = time.monotonic()
            c, _, b = call(port, "/compute_raw", vals[i].tobytes())
            if c != 200 or not np.array_equal(np.frombuffer(b, "<i4"), vals[i] + 2):
                raise RuntimeError(f"/compute_raw: {c} {b[:200]!r}")
            spans[i].append((t, time.monotonic()))
            if gap_s:
                time.sleep(gap_s)

    errors, _ = run_clients(n_clients, client)
    return [sp for per in spans for sp in per], errors


def series_points(port, name, window="15m"):
    q = json.loads(http(port, f"/debug/series?name={name}&window={window}", timeout=60)[1])
    return [(row["stage_s"], pt) for row in q["series"] for pt in row["points"]]


def collector_samples(port) -> int:
    """How many samples the TSDB collector has taken (its /debug/series
    index)."""
    return json.loads(http(port, "/debug/series", timeout=60)[1])["samples"]


def series_integral(pts, t0, t1):
    """The values a counter's rate points (stage width, [slot start, mean
    rate, max]) account for between t0 and t1: each point's rate over the
    time since the point before it.  A point's rate is its sample's delta
    over the collector's true period, which the governor may stretch past
    the slot width (a stretched period leaves slots empty); the slot
    starts quantize the sample times by up to one width, an error that
    telescopes to the two edges of a steady stream."""
    total, prev = 0.0, None
    for w, (t, avg, _mx) in sorted(pts, key=lambda p: p[1][0]):
        if t0 - w <= t <= t1:
            total += avg * ((t - prev) if prev is not None else w)
        prev = t
    return total


def device_loop_shares(flame):
    """The device-loop thread's samples in the folded stacks of
    /debug/flamegraph: in all, under the kernel's ctypes launch
    (core/fused.py::_launch), under the synchronising read of the packed
    outputs (core/engine.py::read_packed), and the commonest leaf frames."""
    loop = {k: v for k, v in flame["stacks"].items() if "(_device_loop)" in k.split(";")[0]}
    total = sum(loop.values())
    leaves = collections.Counter()
    for k, v in loop.items():
        leaves[k.split(";")[-1]] += v
    share = (lambda pat: sum(v for k, v in loop.items() if pat in k) / total) if total else (
        lambda pat: None)
    return {"samples": total, "launch_share": share("_launch (fused.py)"),
            "read_share": share("read_packed (engine.py)"),
            "top_leaves": [[k, v] for k, v in leaves.most_common(6)]}


def spooled(tsdb_dir, prefix, kind):
    """The frames of `kind` on disk in one spool (read only, as an export)."""
    from misaka_tpu_torch.utils.spool import SegmentSpool

    out = []
    SegmentSpool(tsdb_dir, prefix=prefix).read_frames(
        lambda fr: out.append(fr) if fr.get("k") == kind else None)
    return out


def poll(cond, what, deadline_s=60.0, every=0.25):
    deadline = time.monotonic() + deadline_s
    while True:
        got = cond()
        if got:
            return got
        expect(time.monotonic() < deadline, f"{what}: not within {deadline_s:.0f} s")
        time.sleep(every)


def export_totals(port):
    from misaka_tpu_torch.runtime import usage

    body = http(port, "/usage/export", timeout=120)[1].decode()
    return usage.totals_from_lines([json.loads(ln) for ln in body.splitlines() if ln])


def rotation_memory(batch, device, rotations=3):
    """In this process, on the card: an engine at the served shapes with the
    capture spool armed over it (anchors cut by the same kind of closure
    the server passes); each rotation's seconds and device memory before
    and after it (the old anchor must be freed: within 5% of before)."""
    import torch

    from misaka_tpu_torch import networks
    from misaka_tpu_torch.core import fused
    from misaka_tpu_torch.runtime import capture
    from misaka_tpu_torch.runtime import master as tmaster

    card = device != "cpu"
    mem = min_allocated if card else (lambda: 0)
    launch0 = fused.launch_counts[fused.KERNEL]
    tmp = tempfile.mkdtemp(prefix="rotation-", dir=os.path.join(ROOT, "build"))
    m = tmaster.MasterNode(networks.add2(**MAIN_CAPS), chunk_steps=MAIN_CHUNK, batch=batch,
                           device=device)
    m.run()
    rows = []
    try:
        env = {"MISAKA_TSDB_DIR": tmp, "MISAKA_CAPTURE_SEG_S": "9999",
               "MISAKA_CAPTURE_DISK_MB": "100000"}
        expect(capture.ensure_spool(env, anchor_fn=lambda: {
            "default": capture.anchor_from_master("default", m)}) is not None,
            "in-process capture spool")
        vals = np.arange(64, dtype=np.int32)
        for i in range(rotations):
            for _ in range(3):
                out = m.compute_coalesced(vals, return_array=True)
                capture.note("http", program="default", trace=None, inbound=False,
                             vals=vals.tobytes(), resp=out.astype("<i4").tobytes(),
                             status=200, tick=int(m._ticks_done), op="coalesced")
            before = mem()
            t = time.perf_counter()
            res = capture.rotate_now()
            if card:
                torch.cuda.synchronize()
            secs = time.perf_counter() - t
            after = mem()
            expect(res is not None and res["records"] == 3, f"rotation {i}: {res}")
            rows.append({"seconds": secs, "before": before, "after": after,
                         "anchor_file_bytes": sum(os.path.getsize(a)
                                                  for a in res["anchors"].values())})
            expect(not card or abs(after - before) <= 0.05 * before,
                   f"device memory across rotation {i}: {before} -> {after}")
    finally:
        capture.shutdown_spool()
        capture.stop()  # the spool re-armed the ring at each rotation
        capture.start()  # drop the anchors: the ring and its clones go
        capture.stop()
        m.close()
        del m
        shutil.rmtree(tmp, ignore_errors=True)
    return {"rotations": rows, "kernel_launches": fused.launch_counts[fused.KERNEL] - launch0}


def phase_observatory(batch=MAIN_BATCH, chunk=MAIN_CHUNK, workers=None, series_s=20.0,
                      stream_clients=8, stream_values=512, drill_clients=4, n_clients=32,
                      per_client=10, n_quiet=13, seg_s=20, device=None, card=None):
    """The always-on and durable planes on the main path: add2 at B (the
    full kernel) behind N frontend workers with MISAKA_PROGRAMS_DIR,
    MISAKA_TSDB_DIR (a 1 s collector), the capture spool rotating every
    seg_s, MISAKA_WATCHDOG (the defaults and OBS_HOT_RULE) and a
    checkpoint dir:

    1. series: a stream on the public port for series_s; the integral of
       /debug/series for misaka_compute_values_total (series_integral)
       against the /metrics delta, within 10%: the slot starts quantize
       the samples' times by up to one 1 s interval, which moves the
       integral by at most one interval's values at each edge of the
       stream, 2 of its >= 20 intervals;
       the sampler's rate and self-cost and the collector's cost per
       sample read under that load, and the device-loop thread's shares of
       the launch and of the read in the folded stacks;
    2. /debug/dashboard filled, /debug/flamegraph in JSON and HTML;
    3. the watchdog: serve_delay=OBS_FAULT_S over POST /debug/faults pages
       the rule (onset seconds), /healthz degraded, exemplars resolving at
       /debug/requests/<id>; cleared, the rule clears (seconds), all with
       drill_clients on the engine's own port (behind the workers the
       public traffic rides the plane, not the engine's HTTP histogram);
    4. rotation: POST /captures/rotate under a stream (its seconds, the
       longest request overlapping it), and in this process device memory
       across rotations (rotation_memory);
    5. POST /checkpoint;
    6. kill -9 of the app, relaunched over the same MISAKA_TSDB_DIR:
       /debug/series answers 15m and 7d windows with points from before
       the kill, the usage export is monotone and conserves against the
       pass-wall anchor within 5%, and the segment rotated before the
       kill replays green on the card (`python -m misaka_tpu_torch
       replay`, run while step 7's servers boot);
    7. the cost, a b b a behind the workers: a with MISAKA_SAMPLER=0
       MISAKA_TSDB=0 MISAKA_WATCHDOG=0, b the default boot; b first
       restores step 5's checkpoint and must answer /debug/series with the
       points from before it (history through the checkpoint alone: b's
       TSDB starts empty).

    Every server pins MISAKA_NATIVE_EDGE=0 (the worker tier, as in earlier
    runs).  device="cpu" rehearses it at a small B (no memory checks)."""
    from misaka_tpu_torch.core import fused
    from misaka_tpu_torch.networks import ADD2_PROGRAMS
    from misaka_tpu_torch.runtime import frontends

    workers = workers or frontend_workers()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="observatory-", dir=os.path.join(ROOT, "build"))
    tsdb_dir, ckpt_dir = os.path.join(tmp, "tsdb"), os.path.join(tmp, "ckpt")
    base = dict(node_info=ADD2_NODES, programs=ADD2_PROGRAMS, batch=batch, chunk=chunk,
                caps=MAIN_CAPS, device=device, MISAKA_HTTP_WORKERS=str(workers),
                MISAKA_NATIVE_EDGE="0", MISAKA_CHECKPOINT_DIR=ckpt_dir)
    # canary traffic would join the replayed stream; a 64 MiB ring rotated
    # every seg_s (or at 48 MiB) keeps each segment whole (no eviction)
    obs = dict(base, MISAKA_PROGRAMS_DIR=os.path.join(tmp, "programs"), MISAKA_CANARY="0",
               MISAKA_TSDB_DIR=tsdb_dir, MISAKA_TSDB_INTERVAL_S="1",
               MISAKA_WATCHDOG=observatory_rules(), MISAKA_WATCHDOG_RECENT_S="3",
               MISAKA_USAGE_FLUSH_S="1", MISAKA_CAPTURE_SEG_S=str(seg_s),
               MISAKA_CAPTURE_MB="64", MISAKA_CAPTURE_SEG_KB=str(48 * 1024),
               MISAKA_CAPTURE_DISK_MB="4096",
               # the drill servers' collector may take 5% of a core (the
               # default 1% governs it to ~10 s a sample under this load on
               # the card's host, and every drill below waits on its
               # samples); the cost pair's b keeps the default
               MISAKA_TSDB_BUDGET="0.05")
    row = {"phase": "observatory", "card": card, "workers": workers, "batch": batch,
           "chunk_steps": chunk, **MAIN_CAPS, "hot_rule": OBS_HOT_RULE, "fault_s": OBS_FAULT_S}
    t0 = time.perf_counter()
    launches = []
    replays = []  # the background replay, stopped if the phase fails
    rng = np.random.default_rng(SEED + 12)
    try:
        procs = []
        with served_app("observatory", procs=procs,
                        MISAKA_PLANE_SOCKET=os.path.join(tmp, "obs1.sock"), **obs) as (pub,
                                                                                     boot_s):
            row["boot_s"] = boot_s
            eng = engine_port("observatory")
            expect(frontends.wait_ready(pub, timeout=30), "the public port does not answer")
            # 1. series
            c0 = series(scrape(eng), "misaka_compute_values_total")
            t_a = time.time()
            s0 = collector_samples(eng)
            time.sleep(2.5)  # quiet intervals: the collector's baseline
            # a governed collector can stretch its period past these
            # waits: the integral needs one sample inside each quiet edge
            poll(lambda: collector_samples(eng) > s0, "a collector sample before the stream",
                 60.0, 0.1)
            out = {}
            th = threading.Thread(target=lambda: out.update(zip(("spans", "errors"), stream_for(
                pub, series_s, stream_clients, stream_values, rng))))
            th.start()
            time.sleep(series_s * 0.8)
            flame = json.loads(http(eng, "/debug/flamegraph", timeout=60)[1])
            index = json.loads(http(eng, "/debug/series", timeout=60)[1])
            th.join()
            expect(not out["errors"], f"series stream: {out['errors'][:4]}")
            s1 = collector_samples(eng)
            time.sleep(3.5)  # the last intervals' samples land
            poll(lambda: collector_samples(eng) > s1, "a collector sample after the stream",
                 60.0, 0.1)
            c1 = series(scrape(eng), "misaka_compute_values_total")
            t_b = time.time()
            pts = series_points(eng, "misaka_compute_values_total", "5m")
            integral = series_integral(pts, t_a, t_b)
            delta = c1 - c0
            row["series"] = {
                "seconds": series_s, "requests": len(out["spans"]), "counter_delta": delta,
                "integral": integral, "ratio": integral / delta, "tolerance": 0.10,
                "stage_s": sorted({w for w, _ in pts}),
                "points": [pt[:2] for _, pt in pts if t_a - 1 <= pt[0] <= t_b],
                "collector": {k: index[k] for k in ("interval_s", "effective_interval_s",
                                                    "budget", "sample_cost_us", "samples",
                                                    "series_count", "dropped_series")},
                "collector_duty": index["sample_cost_us"] / 1e6 / index["interval_s"],
                "sampler": {k: flame[k] for k in ("rate_hz", "effective_hz", "budget",
                                                  "sample_cost_us", "samples",
                                                  "distinct_stacks")},
                "sampler_duty": flame["sample_cost_us"] / 1e6 * flame["effective_hz"],
                "device_loop": device_loop_shares(flame)}
            expect(delta == len(out["spans"]) * stream_values,
                   f"counter delta {delta} for {len(out['spans'])} requests")
            expect(abs(integral - delta) <= 0.10 * delta,
                   f"series integral {integral} against the counter delta {delta}")
            # 2. dashboard and flamegraph
            c, _, page = call(eng, "/debug/dashboard?window=5m")
            m = re.search(r"const DATA = (.*);\n", page.decode())
            data = json.loads(m.group(1)) if c == 200 and m else {"panels": []}
            filled = [p["title"] for p in data["panels"]
                      if any(r["points"] for r in p["series"])]
            expect(c == 200 and "Throughput (values/s)" in filled,
                   f"dashboard: {c}, filled panels {filled}")
            c, h, html = call(eng, "/debug/flamegraph?html=1")
            expect(c == 200 and h["Content-Type"].startswith("text/html")
                   and b"misaka continuous profiler" in html, f"flamegraph html: {c}")
            row["dashboard"] = {"panels": len(data["panels"]), "filled": filled,
                                "page_bytes": len(page), "flamegraph_html_bytes": len(html)}
            # 3. the watchdog
            row["watchdog"] = watchdog_drill(eng, drill_clients)
            # 4. rotation under a stream (the ring emptied first)
            c, _, b = call(eng, "/captures/rotate", b"")
            expect(c == 200, f"/captures/rotate: {c} {b!r}")
            out = {}  # a light stream: its records are replayed after the kill
            th = threading.Thread(target=lambda: out.update(zip(("spans", "errors"), stream_for(
                pub, 4.0, drill_clients, stream_values, rng, gap_s=0.1))))
            th.start()
            time.sleep(1.5)
            poll(lambda: json.loads(http(eng, "/debug/captures?n=0")[1])["records"] > 0,
                 "records in the ring", 30, 0.1)
            r0 = time.monotonic()
            c, _, b = call(eng, "/captures/rotate", b"")
            r1 = time.monotonic()
            th.join()
            expect(c == 200 and not out["errors"], f"rotation: {c} {b[:200]!r} {out['errors'][:2]}")
            rotated = json.loads(b)
            expect(rotated.get("records", 0) > 0, f"rotation: {rotated}")
            segment = rotated["path"]
            during = [e - s for s, e in out["spans"] if s < r1 and e > r0]
            spool = json.loads(http(eng, "/debug/captures?n=0")[1])["spool"]
            row["rotation"] = {"seconds": r1 - r0, "records": rotated["records"],
                               "requests_overlapping": len(during),
                               "longest_overlapping_s": max(during, default=None),
                               "p50_stream_s": float(np.median([e - s for s, e in out["spans"]])),
                               "spool": spool}
            # 5. the checkpoint (history rides it as __tsdb__)
            t_ckpt = time.time()  # a timestamp, held against the series' points
            t = time.perf_counter()
            c, _, b = call(eng, "/checkpoint", urlencode_form(name="obs"))
            expect(c == 200, f"/checkpoint: {c} {b!r}")
            row["checkpoint_s"] = time.perf_counter() - t
            # 6. kill -9, once the traffic's slots and a usage frame are on disk
            poll(lambda: any(r[0] == "misaka_compute_values_total" and r[3] > 0
                             for fr in spooled(tsdb_dir, "tsdb-fine", "slots")
                             for r in fr["rows"]), "values on disk", 30)
            poll(lambda: any(fr["programs"].get("default", {}).get("values", 0) > 0
                             for fr in spooled(os.path.join(tsdb_dir, "usage"), "usage",
                                               "usage")), "usage frame on disk", 30)
            totals1 = export_totals(eng)
            launches.append(status(eng)["kernel_launches"][fused.KERNEL])
            t_kill = time.time()
            os.kill(procs[0].pid, 9)
            procs[0].wait(timeout=60)
        with served_app("observatory_relaunch",
                        MISAKA_PLANE_SOCKET=os.path.join(tmp, "obs2.sock"), **obs) as (pub,
                                                                                     boot_s):
            eng = engine_port("observatory_relaunch")
            kill = {"relaunch_boot_s": boot_s}
            for window in ("15m", "7d"):
                pts = series_points(eng, "misaka_compute_values_total", window)
                before = [pt for _, pt in pts if pt[0] < t_kill and pt[1] > 0]
                expect(before, f"window={window}: no points from before the kill in {pts[:4]}")
                kill[f"points_before_kill_{window}"] = len(before)
            expect(frontends.wait_ready(pub, timeout=30), "the public port does not answer")
            spans, errors = stream_for(pub, 2.0, drill_clients, stream_values, rng)
            expect(not errors, f"after the relaunch: {errors[:4]}")
            want = totals1["cumulative"]["default"]["values"] + len(spans) * stream_values
            totals2 = poll(lambda: (lambda t: t if t["cumulative"].get("default", {}).get(
                "values", 0) >= want else None)(export_totals(eng)), "post-restart accrual", 30)
            regress = [(p, f) for p, r in totals1["cumulative"].items() for f, v in r.items()
                       if totals2["cumulative"].get(p, {}).get(f, -1) < v - 1e-6]
            expect(not regress and totals2["pass_wall_seconds"]
                   >= totals1["pass_wall_seconds"] - 1e-6, f"usage went back: {regress}")
            wall, cpu = totals2["pass_wall_seconds"], totals2["cpu_seconds_total"]
            expect(abs(wall - cpu) <= 0.05 * max(wall, cpu), f"conservation {cpu} / {wall}")
            kill.update(pass_wall_before=totals1["pass_wall_seconds"], pass_wall_after=wall,
                        cpu_seconds_after=cpu, conservation_ratio=cpu / wall)
            launches.append(status(eng)["kernel_launches"][fused.KERNEL])
        row["kill"] = kill
        # 4b. device memory across rotations, in this process
        row["rotation_memory"] = rotation_memory(batch, device or "cuda")
        launches.append(row["rotation_memory"]["kernel_launches"])
        # the segment rotated before the kill, replayed while the cost servers boot
        replay = start_replay([segment], device)
        replays.append(replay)
        # 7. the cost, a b b a (b restores the checkpoint of step 5 first)
        off = {"a": {"MISAKA_SAMPLER": "0", "MISAKA_TSDB": "0", "MISAKA_WATCHDOG": "0"}, "b": {}}
        cost = [dict(base, label=f"observatory_cost_{cfg}", autorun=False,
                     MISAKA_PLANE_SOCKET=os.path.join(tmp, f"cost_{cfg}.sock"), **off[cfg])
                for cfg in ("a", "b")]
        with served_apps(cost) as [(cost_a, _), (cost_b, _)]:
            ports = {"a": cost_a, "b": cost_b}
            rc, lines, secs = finish_replay(replay)
            expect(rc == 0 and any(ln.startswith("default: replay green") for ln in lines),
                   f"replay of the segment rotated before the kill: {rc} {lines[-3:]}")
            kill["replay"] = {"rc": rc, "seconds": secs, "lines": lines}
            c, _, b = call(cost_b, "/restore", urlencode_form(name="obs"))
            expect(c == 200, f"b: /restore: {c} {b!r}")
            # b keeps the default 5 s interval: the checkpoint's 1 s slots
            # have no ring of that width there, its 60 s slots do (2h)
            pts = series_points(cost_b, "misaka_compute_values_total", "2h")
            restored = [pt for _, pt in pts if pt[0] < t_ckpt and pt[1] > 0]
            expect(restored, f"history from the checkpoint: {pts[:4]}")
            row["checkpoint_history_points"] = len(restored)
            for p in ports.values():
                expect(frontends.wait_ready(p, timeout=30), "the public port does not answer")
                expect(post_form(p, "/run")[0] == 200, "/run")
                small_requests(p, n_clients, 2, base=7_000_000)  # warm-up
                expect(post_form(p, "/pause")[0] == 200, "/pause")
            turns = [{"config": cfg, **cost_turn(ports[cfg], n_clients, per_client, n_quiet)}
                     for cfg in ("a", "b", "b", "a")]

            def mean(cfg, k):
                return float(np.mean([t[k] for t in turns if t["config"] == cfg]))

            def spread(cfg, k):
                v = [t[k] for t in turns if t["config"] == cfg]
                return (max(v) - min(v)) / float(np.mean(v))

            metrics_ = (("rate", "small_requests_per_s"), ("p50", "p50_ms"), ("p90", "p90_ms"))
            row["cost"] = {
                "turns": turns,
                **{f"{k}_ratio_b_over_a": mean("b", m_) / mean("a", m_) for k, m_ in metrics_},
                **{f"{k}_spread_{cfg}": spread(cfg, m_) for k, m_ in metrics_[:2]
                   for cfg in "ab"}}
            launches += [status(p)["kernel_launches"][fused.KERNEL] for p in ports.values()]
    except BaseException:
        row["seconds"] = time.perf_counter() - t0
        emit(row)  # what was measured before the failure
        raise
    finally:
        kill_replays(replays)
        shutil.rmtree(tmp, ignore_errors=True)
    row["kernel_launches"] = sum(launches)
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    return row


def watchdog_drill(eng, n_clients, deadline_s=90):
    """OBS_HOT_RULE fired through the server: n_clients post /compute to
    the engine's port while serve_delay=OBS_FAULT_S is armed over POST
    /debug/faults; the seconds until the rule pages (with /healthz
    degraded and exemplars that resolve), then, the fault cleared, until
    it clears."""
    stop = threading.Event()

    def client(i):
        v = 5_000_000 + i * 100_000
        while not stop.is_set():
            c, b = post_form(eng, "/compute", value=str(v))
            if c != 200 or json.loads(b) != {"value": v + 2}:
                raise RuntimeError(f"/compute {v} -> {c} {b!r}")
            v += 1

    def hot():
        wd = json.loads(http(eng, "/debug/alerts", timeout=60)[1])["watchdog"]
        return wd, next(r for r in wd["rules"] if r["rule"] == "hot")

    out = {}
    th = threading.Thread(target=lambda: out.setdefault("errors", run_clients(n_clients,
                                                                               client)[0]))
    th.start()
    try:
        poll(lambda: "value" in hot()[1], "the hot rule's first value", 30)
        wd, rule = hot()
        expect(wd["state"] == "ok", f"watchdog before the fault: {wd['state']}")
        t = time.monotonic()
        c, _, b = call(eng, "/debug/faults", urlencode_form(spec=f"serve_delay={OBS_FAULT_S}"))
        expect(c == 200, f"arm the fault: {c} {b!r}")
        wd, rule = poll(lambda: (lambda w: w if w[0]["state"] == "page" else None)(hot()),
                        "the page", deadline_s)
        onset = time.monotonic() - t
        health = json.loads(http(eng, "/healthz")[1])
        ex = (rule.get("exemplars") or [{}])[0]
        c, _, b = call(eng, ex.get("href", "/debug/requests/none"))
        expect(rule["state"] == "page" and health["watchdog"] == "page" and health["degraded"]
               and c == 200 and json.loads(b)["trace_id"] == ex["trace_id"],
               f"paged: {rule} {health.get('watchdog')} {c}")
        paged = {"value": rule.get("value"), "exemplar_ms": ex.get("duration_ms")}
        t = time.monotonic()
        c, _, b = call(eng, "/debug/faults", urlencode_form(spec=""))
        expect(c == 200, f"clear the fault: {c} {b!r}")
        poll(lambda: hot()[0]["state"] == "ok", "the clear", deadline_s)
        clear = time.monotonic() - t
        health = json.loads(http(eng, "/healthz")[1])
        expect(health["watchdog"] == "ok" and not health["degraded"], f"after: {health}")
    finally:
        stop.set()
        th.join(timeout=120)
    expect(not out.get("errors"), f"drill clients: {out.get('errors', ['hung'])[:4]}")
    return {"onset_s": onset, "clear_s": clear, **paged}


# --- the fleet: N engine replicas behind the router, rolls, a remote peer, gossip ---------

FLEET_KEYS = [
    {"key": "fleet-admin", "tenant": "ops", "admin": True},
    {"key": "fleet-load", "tenant": "load"},
    {"key": "fleet-flood", "tenant": "flood", "quota": "rps<20"},
]
FLEET_ADMIN = {"X-Misaka-Key": "fleet-admin"}
FLEET_LOAD = {"X-Misaka-Key": "fleet-load"}
FLEET_FLOOD_RPS = 20.0
FLEET_BURST_S = 2.0  # MISAKA_QUOTA_BURST_S's default


def plane_certs(directory):
    """(cert, key) of one self-signed EC pair (its own CA, so the pair is
    the fleet's trust domain), or None when this host has no openssl."""
    if shutil.which("openssl") is None:
        return None
    cert, key = os.path.join(directory, "plane.pem"), os.path.join(directory, "plane.key")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "ec", "-pkeyopt",
                    "ec_paramgen_curve:prime256v1", "-nodes", "-keyout", key, "-out", cert,
                    "-days", "1", "-subj", "/CN=misaka-fleet",
                    "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
                   check=True, capture_output=True, timeout=60)
    return cert, key


class FleetLoad:
    """Clients on the public port until stop(): n_small threads of
    one-value /compute and n_raw threads of `values`-value /compute_raw,
    every answer checked; a failure is recorded, never raised."""

    def __init__(self, port, n_small, n_raw, values=512, headers=None):
        self.port, self.values, self.headers = port, values, headers or {}
        self.errors: list[str] = []
        self.requests = 0
        self.served_values = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = (
            [threading.Thread(target=self._small, args=(i,), daemon=True) for i in range(n_small)]
            + [threading.Thread(target=self._raw, args=(i,), daemon=True) for i in range(n_raw)])

    def _note(self, n_values):
        with self._lock:
            self.requests += 1
            self.served_values += n_values

    def _small(self, i):
        j = 0
        while not self._stop.is_set():
            v = 1_000_000 + i * 100_000 + j
            j += 1
            try:
                c, _, b = call(self.port, "/compute", f"value={v}".encode(), self.headers)
                if c != 200 or json.loads(b) != {"value": v + 2}:
                    raise RuntimeError(f"/compute {v} -> {c} {b[:80]!r}")
                self._note(1)
            except Exception as e:  # recorded: the drill fails on any
                self.errors.append(repr(e))

    def _raw(self, i):
        rng = np.random.default_rng(SEED + 7000 + i)
        while not self._stop.is_set():
            vals = rng.integers(-1000, 1000, self.values).astype("<i4")
            try:
                c, _, b = call(self.port, "/compute_raw", vals.tobytes(), self.headers)
                if c != 200 or not np.array_equal(np.frombuffer(b, "<i4"), vals + 2):
                    raise RuntimeError(f"/compute_raw -> {c} {b[:80]!r}")
                self._note(self.values)
            except Exception as e:
                self.errors.append(repr(e))

    def start(self):
        self.t0 = time.perf_counter()
        for t in self._threads:
            t.start()
        return self

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=300)
        secs = time.perf_counter() - self.t0
        return {"requests": self.requests, "values": self.served_values, "seconds": secs,
                "errors": len(self.errors), "first_errors": self.errors[:3]}


def fleet_get(port, path, headers=None):
    c, _, b = call(port, path, headers=headers if headers is not None else FLEET_ADMIN)
    expect(c == 200, f"GET {path} -> {c} {b[:200]!r}")
    return json.loads(b)


def fleet_state(port):
    return fleet_get(port, "/fleet")


def smi_apps() -> dict[int, int]:
    """Device memory per compute process, MiB, as nvidia-smi lists them
    (none where the card's processes sit outside this pid namespace)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    mem = {}
    for line in out.strip().splitlines():
        pid, _, mib = line.partition(",")
        if pid.strip().isdigit() and mib.strip().isdigit():
            mem[int(pid)] = int(mib)
    return mem


def card_memory_used() -> int:
    """The card's used memory, MiB (every process's, contexts included)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return int(out.strip().splitlines()[0])


def serial_load(port, values, n_small=30, n_raw=10) -> None:
    """n_small /compute, then n_raw `values`-value /compute_raw, one at a
    time, every answer checked."""
    rng = np.random.default_rng(SEED + 4242)
    for v in range(n_small):
        c, _, b = call(port, "/compute", f"value={v}".encode(), FLEET_LOAD)
        expect(c == 200 and json.loads(b) == {"value": v + 2}, f"/compute {v} -> {c}")
    for _ in range(n_raw):
        vals = rng.integers(-1000, 1000, values).astype("<i4")
        c, _, b = call(port, "/compute_raw", vals.tobytes(), FLEET_LOAD)
        expect(c == 200 and np.array_equal(np.frombuffer(b, "<i4"), vals + 2),
               f"/compute_raw -> {c}")


def fleet_memory(port) -> dict:
    """Each replica's device memory (its /status), nvidia-smi's list and
    the card's used memory."""
    return {"replicas": replica_memory(port), "smi_apps": smi_apps(),
            "card_used_mib": card_memory_used()}


def check_roll_memory(before, after) -> dict:
    """Across a quiescent roll: every old replica pid gone, and each
    replacement's device memory within 5% of its predecessor's, per pid
    from nvidia-smi where it lists the replicas, else each replica's own
    allocated bytes (its /status); the card's used memory (contexts and
    every process's allocator pool) is printed beside them.  A replica's
    own number is the bytes its allocator holds booted and paused, before
    any chunk ran: after serving, what it holds (and its peak) swings by a
    serve buffer set with how the last passes overlapped."""
    if not before["smi_apps"]:
        print("fleet: nvidia-smi lists no compute process on this host (pid namespace): "
              "device memory per replica pid from each replica's /status", flush=True)
    for i, old in before["replicas"].items():
        new = after["replicas"][i]
        expect(new["pid"] != old["pid"] and not pid_alive(old["pid"])
               and old["pid"] not in after["smi_apps"],
               f"replica {i}: the old pid {old['pid']} outlived the roll")
        a, b = old["allocated_bytes"], new["allocated_bytes"]
        expect(abs(b - a) <= 0.05 * a, f"replica {i}: device memory across the roll {old} -> {new}")
        smi_old, smi_new = before["smi_apps"].get(old["pid"]), after["smi_apps"].get(new["pid"])
        expect(smi_old is None
               or (smi_new is not None and abs(smi_new - smi_old) <= 0.05 * smi_old),
               f"replica {i}: nvidia-smi memory {smi_old} -> {smi_new} MiB")
    return {"before": before, "after": after}


def replica_memory(port) -> dict[str, dict]:
    """Each replica's pid and caching-allocator bytes on its card, from its
    /status through the control server."""
    st = fleet_get(port, "/status")
    pids = {str(r["replica"]): r["pid"] for r in st["fleet"]["replicas"] if not r.get("remote")}
    return {i: {"pid": pids[i], **r.get("device_memory", {})} for i, r in st["replicas"].items()}


def plane_frames(scraped) -> dict[str, float]:
    """misaka_plane_frames_total per replica label of an aggregated scrape."""
    from misaka_tpu_torch.utils import metrics

    out = {}
    for k, v in scraped.items():
        name, labels = metrics.parse_series(k)
        if name == "misaka_plane_frames_total" and "replica" in labels:
            out[labels["replica"]] = v
    return out


def fleet_scrape(port):
    from misaka_tpu_torch.utils import metrics

    return metrics.parse_text(call(port, "/metrics", headers=FLEET_ADMIN)[2].decode())


def roll_fleet(port):
    c, _, b = call(port, "/fleet/roll", b"", FLEET_ADMIN, timeout=900)
    expect(c == 200, f"/fleet/roll -> {c} {b[:300]!r}")
    report = json.loads(b)
    expect(report["ok"] is True, f"roll report {report}")
    return report


def state_arrays(path):
    with np.load(path) as z:
        return {k: z[k].copy() for k in z.files if k != "__tsdb__"}


def same_state(a, b):
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def kill_fault_drill(port, n_clients, deadline_s):
    """The replica_kill fault's fleet under light load: zero errors until
    one replica was killed and respawned, and the fault fired once."""
    load = FleetLoad(port, n_clients, 0).start()
    t0 = time.monotonic()
    try:
        while True:
            st = fleet_state(port)
            if st["restarts_total"] >= 1 and st["up"] == st["configured"]:
                break
            expect(time.monotonic() - t0 < deadline_s,
                   f"replica_kill: no kill and respawn within {deadline_s:.0f} s: {st}")
            time.sleep(0.25)
        time.sleep(2.0)  # it fires once: nothing more dies
    finally:
        out = load.stop()
    st = fleet_state(port)
    return {**out, "restarts_total": st["restarts_total"], "up": st["up"],
            "seconds_to_healed": time.monotonic() - t0}


def kill9_drill(port, n_small, n_raw, values) -> dict:
    """kill -9 of the replica the fault spared, under n_small + n_raw
    clients: zero client errors, and the seconds from the kill to the
    respawned replica's healthy probe."""
    st = fleet_state(port)
    victim = next(r for r in st["replicas"] if r["restarts"] == 0)
    load = FleetLoad(port, n_small, n_raw, values).start()
    time.sleep(1.0)
    os.kill(victim["pid"], signal.SIGKILL)
    t_kill = time.monotonic()
    idx = victim["replica"]
    poll(lambda: (s := fleet_state(port))["replicas"][idx]["state"] == "up"
         and s["replicas"][idx]["restarts"] >= 1, "respawn", 240.0, 0.1)
    respawn_s = time.monotonic() - t_kill
    time.sleep(1.0)
    out = load.stop()
    return {**out, "replica": idx, "respawn_to_healthy_s": respawn_s}


def print_log_excerpt(label, tail=60):
    """A failed phase's server log on stderr: its lines about replica
    deaths, respawns and errors, then its last `tail` lines."""
    path = os.path.join(ROOT, "build", f"chip_smoke_{label}.log")
    try:
        with open(path, errors="replace") as f:
            lines = f.read().splitlines()
    except OSError as e:
        print(f"{label}: no log ({e})", file=sys.stderr, flush=True)
        return
    pick = re.compile(r"replica \d|died|respawn|breaker|Error|Traceback|exiting")
    for line in [ln for ln in lines if pick.search(ln)][-80:] + ["..."] + lines[-tail:]:
        print(f"{label}: {line[:400]}", file=sys.stderr, flush=True)


def second_fleet_drill(port, n_small, n_raw, values):
    """The second fleet (booted with replica_kill), beside the first's
    drills: the fault under light load, kill -9 of the other replica and
    then POST /fleet/roll, each under n_small + n_raw clients; zero client
    errors through all three.  A failure is returned, not raised (this
    runs on a thread of its own)."""
    try:
        out = {"replica_kill": kill_fault_drill(port, 4, 240.0)}
        out["kill"] = kill9_drill(port, n_small, n_raw, values)
        load = FleetLoad(port, n_small, n_raw, values).start()
        time.sleep(1.0)
        report = roll_fleet(port)
        time.sleep(1.0)
        out["roll"] = {**load.stop(), "report": report,
                       "checkpoint_s": roll_checkpoint_seconds("fleet_cost_b")}
        return out
    except BaseException as e:  # surfaced by the caller's check
        return {"failed": repr(e)}


def gossip_drill(port, flooders, flood_s):
    """A flooded tenant (rps<FLEET_FLOOD_RPS per engine) across the fleet:
    its aggregate admitted requests against one engine's quota for the
    same window (rate x window + the burst)."""
    admitted = [0]
    rejected = [0]
    lock = threading.Lock()
    t_end = time.monotonic() + flood_s

    def flood(i):
        while time.monotonic() < t_end:
            c, _, _ = call(port, "/compute", f"value={i}".encode(), {"X-Misaka-Key": "fleet-flood"})
            with lock:
                if c == 200:
                    admitted[0] += 1
                elif c == 429:
                    rejected[0] += 1
                else:
                    raise RuntimeError(f"flood /compute -> {c}")

    errors, secs = run_clients(flooders, flood)
    expect(not errors, f"flood: {errors[:3]}")
    single = FLEET_FLOOD_RPS * secs + FLEET_FLOOD_RPS * FLEET_BURST_S
    return {"flooders": flooders, "seconds": secs, "admitted": admitted[0],
            "rejected_429": rejected[0], "single_engine_quota": single,
            "admitted_over_single_quota": admitted[0] / single}


def phase_fleet(batch=MAIN_BATCH, chunk=MAIN_CHUNK, workers=None, n_clients=32, per_client=20,
                n_streams=8, stream_values=512, kill_after_s=10, flooders=12, flood_s=5.0,
                n_quiet=8, device=None, card=None):
    """The replicated engine fleet on the main path (runtime/fleet.py):
    add2 at B (the full kernel) in MISAKA_FLEET=2 replicas behind N
    frontend workers with a key file (an admin key, a load key, a flooded
    tenant's `rps<20`), plus a remote peer: a third engine at the same
    shapes serving its compute plane on TCP (MISAKA_PLANE_SERVE=1) with
    plane mTLS (certificates from openssl; without openssl it runs
    plaintext and this is printed) and joined through MISAKA_FLEET_PEERS.
    Booted at once with them: a second fleet with MISAKA_FAULTS=
    replica_kill=<kill_after_s> and one engine behind the same workers,
    the cost's pair.

    1. each replica's engine (the card's kernel, or the phase fails);
    2. quiescent, first (the fleet boots paused): each replica's device
       memory before any chunk ran, a short serial load, /pause, POST
       /fleet/roll (the peer driven through drain -> checkpoint ->
       readmit), a checkpoint: each replica's restored
       state equals its roll checkpoint (np.load); the old pids gone and
       each replacement's device memory, restored and paused, within 5%
       of its predecessor's (per pid from nvidia-smi where it lists them,
       else the replica's own allocated bytes from its /status), the
       card's used memory beside;
    3. load: n_clients x per_client small /compute and n_streams x
       per_client /compute_raw of stream_values each, together through the
       public port: requests/s, values/s, each replica's and the peer's
       share of plane frames (aggregated /metrics);
    4. the flooded tenant: aggregate admitted against one engine's quota
       (usage gossip reconciles the engines' buckets);
    5. each replica's kernel launches from its /status (through the
       control server; this fleet is never killed), then the peer: a
       direct mTLS PlaneClient computes on its plane, a plaintext dial is
       refused and counted;
    6. meanwhile, on a thread, the second fleet (booted running: a crash
       respawn comes back in the base env's run state): its replica_kill
       fires once under a light load; kill -9 of its other replica, then
       POST /fleet/roll, each under a continuous load (n_clients/2 small,
       n_streams/2 streams): zero client errors through all three, the
       respawn-to-healthy seconds, each replica's drain, checkpoint and
       boot seconds;
    7. the cost: one engine (a) against the second fleet (b), a b b a,
       n_clients x per_client small /compute and n_quiet quiet /compute
       each turn, the servers not measured paused.

    device="cpu" rehearses it at a small B."""
    from misaka_tpu_torch.networks import ADD2_PROGRAMS
    from misaka_tpu_torch.runtime import frontends

    workers = workers or frontend_workers()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="fleet-", dir=os.path.join(ROOT, "build"))
    keys = os.path.join(tmp, "keys.json")
    with open(keys, "w") as f:
        json.dump({"keys": FLEET_KEYS}, f)
    certs = plane_certs(tmp)
    row = {"phase": "fleet", "card": card, "workers": workers, "replicas": 2,
           "cpu_count": os.cpu_count(), "batch": batch, "chunk_steps": chunk, **MAIN_CAPS,
           "plane_tls": certs is not None}
    if certs is None:
        print("fleet: openssl unavailable on this host: the peer's plane runs without TLS "
              "(the CPU tests carry plane mTLS)", flush=True)
    tls_env = ({"MISAKA_PLANE_TLS_CERT": certs[0], "MISAKA_PLANE_TLS_KEY": certs[1],
                "MISAKA_PLANE_TLS_CA": certs[0]} if certs else {})
    base = dict(node_info=ADD2_NODES, programs=ADD2_PROGRAMS, batch=batch, chunk=chunk,
                caps=MAIN_CAPS, device=device)
    peer_key = os.urandom(16).hex()
    peer_http, peer_plane_port = free_port(), free_port()
    peer_plane = f"127.0.0.1:{peer_plane_port}"
    fleet_dir = os.path.join(tmp, "fleet")
    # all four boot at once: the peer, the cost's engine, the second fleet
    # and the fleet under test (which finds its peer by the pinned ports)
    specs = [
        dict(base, label="fleet_peer", MISAKA_HTTP_WORKERS="0", MISAKA_PLANE_SERVE="1",
             MISAKA_PORT=str(peer_http), MISAKA_PLANE_SOCKET=peer_plane,
             MISAKA_CHECKPOINT_DIR=os.path.join(tmp, "peer"), MISAKA_API_KEYS=keys,
             MISAKA_EDGE_INTERNAL_TOKEN=peer_key, **tls_env),
        # the single engine behind the worker tier (a fleet starts no native edge)
        dict(base, label="fleet_cost_a", MISAKA_HTTP_WORKERS=str(workers),
             MISAKA_NATIVE_EDGE="0", MISAKA_PLANE_SOCKET=os.path.join(tmp, "a.sock")),
        dict(base, label="fleet_cost_b", MISAKA_FLEET="2", MISAKA_HTTP_WORKERS=str(workers),
             MISAKA_FLEET_DIR=os.path.join(tmp, "fleet_b"),
             MISAKA_FAULTS=f"replica_kill={kill_after_s}"),
        dict(base, label="fleet", autorun=False, MISAKA_FLEET="2",
             MISAKA_HTTP_WORKERS=str(workers),
             MISAKA_FLEET_DIR=fleet_dir, MISAKA_API_KEYS=keys,
             MISAKA_FLEET_PEERS=f"127.0.0.1:{peer_http}:{peer_plane_port}",
             MISAKA_FLEET_PEER_KEY=peer_key, **tls_env),
    ]
    t0 = time.perf_counter()
    try:
        with served_apps(specs) as booted:
            (_, peer_boot), (cost_a, _), (cost_b, _), (port, boot_s) = booted
            # the second fleet's kill fires kill_after_s after it is up:
            # its drills (the fault, then a roll under load) start now,
            # beside the first fleet's
            second: dict = {}
            second_thread = threading.Thread(target=lambda: second.update(second_fleet_drill(
                cost_b, n_clients // 2, n_streams // 2, stream_values)))
            second_thread.start()
            row["boot_s"] = boot_s
            row["peer_boot_s"] = peer_boot
            st = poll(lambda: (s := fleet_state(port))["up"] == s["configured"] == 3 and s,
                      "fleet and peer up", 120.0)
            expect(frontends.wait_ready(port, timeout=30), "the public port does not answer")
            row["engines"] = {i: r.get("engine")
                              for i, r in fleet_get(port, "/status")["replicas"].items()}
            expect(device == "cpu" or all(e == "fused" for e in row["engines"].values()),
                   f"a replica is not on the card's kernel: {row['engines']}")
            # 2. quiescent, first: the restored state is the roll
            # checkpoint, and each replacement holds its predecessor's
            # device memory
            # the fleet boots paused: each replica's device memory before
            # any chunk ran, then a short serial load gives the state a
            # history for the roll to carry
            on_card = device != "cpu"
            mem_before = fleet_memory(port) if on_card else None
            expect(call(port, "/run", b"", FLEET_ADMIN)[0] == 200, "fleet /run")
            serial_load(port, stream_values)
            expect(call(port, "/pause", b"", FLEET_ADMIN)[0] == 200, "fleet /pause")
            quiet_report = roll_fleet(port)
            quiet_report["checkpoint_s"] = roll_checkpoint_seconds("fleet")
            expect(call(port, "/checkpoint", b"name=verify-b", FLEET_ADMIN)[0] == 200,
                   "checkpoint verify-b")
            expect(len(quiet_report["replicas"]) == 3 and quiet_report["replicas"][2]["remote"]
                   and quiet_report["replicas"][2]["restored"] is False,
                   f"the peer's roll entry: {quiet_report['replicas'][-1]}")
            restored = {}
            for entry in quiet_report["replicas"]:
                if entry.get("remote"):
                    continue
                i = entry["replica"]
                rdir = os.path.join(fleet_dir, f"replica-{i}")
                restored[i] = same_state(state_arrays(os.path.join(rdir, "verify-b.npz")),
                                         state_arrays(entry["checkpoint"]))
            expect(all(restored.values()) and len(restored) == 2,
                   f"restored state against the roll checkpoint: {restored}")
            row["quiescent_roll"] = {"report": quiet_report, "restored_equal": restored}
            health = fleet_get(port, "/healthz", headers={})
            row["healthz_running_after_paused_roll"] = health["running"]
            expect(health["running"] is False, "a paused fleet's roll resumed a replica")
            if on_card:  # the replacements, restored and paused: no chunk ran
                row["memory"] = check_roll_memory(mem_before, fleet_memory(port))
            expect(call(port, "/run", b"", FLEET_ADMIN)[0] == 200, "fleet /run")
            st = fleet_state(port)


            # 3. the load's rate and the replicas' shares of frames
            before, peer_before = fleet_scrape(port), scrape(peer_http)

            def client(i):
                if i < n_clients:
                    for j in range(per_client):
                        v = i * 10_000 + j
                        c, _, b = call(port, "/compute", f"value={v}".encode(), FLEET_LOAD)
                        if c != 200 or json.loads(b) != {"value": v + 2}:
                            raise RuntimeError(f"/compute {v} -> {c} {b[:80]!r}")
                else:
                    rng = np.random.default_rng(SEED + i)
                    for _ in range(per_client):
                        vals = rng.integers(-1000, 1000, stream_values).astype("<i4")
                        c, _, b = call(port, "/compute_raw", vals.tobytes(), FLEET_LOAD)
                        if c != 200 or not np.array_equal(np.frombuffer(b, "<i4"), vals + 2):
                            raise RuntimeError(f"/compute_raw -> {c}")

            errors, secs = run_clients(n_clients + n_streams, client)
            expect(not errors, f"fleet load: {errors[:3]}")
            after, peer_after = fleet_scrape(port), scrape(peer_http)
            f0, f1 = plane_frames(before), plane_frames(after)
            frames = {i: f1.get(i, 0.0) - f0.get(i, 0.0) for i in f1}
            frames["peer"] = (peer_after.get("misaka_plane_frames_total", 0.0)
                              - peer_before.get("misaka_plane_frames_total", 0.0))
            total = sum(frames.values()) or 1.0
            row["load"] = {
                "requests_per_s": (n_clients + n_streams) * per_client / secs,
                "small_requests_per_s": n_clients * per_client / secs,
                "values_per_s": (n_clients + n_streams * stream_values) * per_client / secs,
                "seconds": secs, "frames": frames,
                "frame_share": {i: f / total for i, f in frames.items()},
            }

            # 4. usage gossip bounds the flooded tenant
            row["gossip"] = gossip_drill(port, flooders, flood_s)
            agg = fleet_scrape(port)
            row["gossip"]["hub_rounds_ok"] = agg.get('misaka_fleet_gossip_total{status="ok"}')
            expect((row["gossip"]["hub_rounds_ok"] or 0) > 0, "no gossip round")

            # 5. the peer's plane: mTLS served, plaintext refused
            # the replicas' launches (this fleet is never killed: the
            # replacements' counts, read before the peer drill)
            launches = {i: r["kernel_launches"]
                        for i, r in fleet_get(port, "/status")["replicas"].items()}
            row["replica_launches"] = launches
            from misaka_tpu_torch.core import fused

            expect(device == "cpu" or all(k.get(fused.KERNEL, 0) > 0 for k in launches.values()),
                   f"a replica served without launching the kernel: {launches}")
            row["peer"] = peer_plane_checks(peer_plane, peer_http, certs)
            peer_frames = (scrape(peer_http).get("misaka_plane_frames_total", 0.0)
                           - peer_before.get("misaka_plane_frames_total", 0.0))
            row["peer"]["router_frames"] = peer_frames
            expect(peer_frames > 0, "the router sent the peer no frame")

            # launches of the peer (its whole life)
            peer_status = fleet_get(peer_http, "/status")
            row["peer_launches"] = peer_status["kernel_launches"]
            expect(call(peer_http, "/pause", b"", FLEET_ADMIN)[0] == 200, "peer /pause")
            second_thread.join(timeout=400)
            try:
                expect("failed" not in second and second.get("roll"),
                       f"the second fleet: {second}")
                fault = second["replica_kill"]
                expect(fault["errors"] == 0 and fault["restarts_total"] == 1,
                       f"replica_kill fleet: {fault}")
                expect(second["kill"]["errors"] == 0, f"kill -9 under load: {second['kill']}")
                expect(second["roll"]["errors"] == 0, f"roll under load: {second['roll']}")
            except SystemExit:
                # why its replicas died, and how each respawn ended
                print_log_excerpt("fleet_cost_b")
                raise
            row["replica_kill"] = fault
            row["kill"] = second["kill"]
            row["roll_under_load"] = second["roll"]

            # 7. the cost: one engine against a 2-replica fleet, both
            # behind the workers
            for p in (cost_a, cost_b):
                expect(post_form(p, "/run")[0] == 200, "/run")
                small_requests(p, n_clients, 2, base=7_000_000)
                expect(post_form(p, "/pause")[0] == 200, "/pause")
            turns = [{"config": cfg, **cost_turn(cost_a if cfg == "a" else cost_b, n_clients,
                                                 per_client, n_quiet)}
                     for cfg in ("a", "b", "b", "a")]

            def mean(cfg, k):
                return float(np.mean([t[k] for t in turns if t["config"] == cfg]))

            def spread(cfg, k):
                v = [t[k] for t in turns if t["config"] == cfg]
                return (max(v) - min(v)) / float(np.mean(v))

            row["cost"] = {"turns": turns, "a": "one engine", "b": "MISAKA_FLEET=2",
                           "rate_ratio_b_over_a": mean("b", "small_requests_per_s")
                           / mean("a", "small_requests_per_s"),
                           "rate_spread_a": spread("a", "small_requests_per_s"),
                           "rate_spread_b": spread("b", "small_requests_per_s"),
                           "p50_ratio_b_over_a": mean("b", "p50_ms") / mean("a", "p50_ms")}
            b_status = status(cost_b)
            a_status = status(cost_a)
            row["fleet_launches"] = (
                sum(k.get(fused.KERNEL, 0) for k in launches.values())
                + row["peer_launches"].get(fused.KERNEL, 0)
                + sum(r.get("kernel_launches", {}).get(fused.KERNEL, 0)
                      for r in b_status["replicas"].values())
                + a_status["kernel_launches"].get(fused.KERNEL, 0))
            expect(device == "cpu" or row["fleet_launches"] > 0, "the fleet launched no kernel")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    return row


def roll_checkpoint_seconds(label) -> dict[str, float]:
    """Each replica's and peer's roll checkpoint seconds, from the fleet
    parent's log (the last roll's line per replica)."""
    with open(os.path.join(ROOT, "build", f"chip_smoke_{label}.log")) as f:
        text = f.read()
    return {f"{kind} {i}": float(secs) for kind, i, secs in re.findall(
        r"(replica|peer) (\d+): roll checkpoint \S+ written(?: and verified)? in ([0-9.]+)s",
        text)}


def peer_plane_checks(addr, http_port, certs):
    """A PlaneClient in this process computes on the peer's TCP plane (in
    mTLS when certs), and a plaintext dial is refused with a counted
    close."""
    from misaka_tpu_torch.runtime import frontends

    env = {"MISAKA_PLANE_TLS_CERT": certs[0], "MISAKA_PLANE_TLS_KEY": certs[1],
           "MISAKA_PLANE_TLS_CA": certs[0]} if certs else {}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        client = frontends.PlaneClient(addr, conns=1, timeout=60)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = {"tls": certs is not None}
    try:
        expect(call(http_port, "/run", b"", FLEET_ADMIN)[0] == 200, "peer /run")
        vals = np.arange(-64, 64, dtype="<i4")
        got = np.frombuffer(client.compute_raw(vals.tobytes(), timeout=60, key="fleet-load"),
                            "<i4")
        expect(np.array_equal(got, vals + 2), "the peer's plane answered wrong")
        out["direct_compute_ok"] = True
    finally:
        client.close()
    if certs is not None:
        before = scrape(http_port).get(
            'misaka_plane_tls_rejected_total{reason="plaintext"}', 0.0)
        _, host, port = frontends.parse_plane_addr(addr)
        raw = socket.create_connection((host, port), timeout=5)
        try:
            raw.sendall(b"\x08\x00\x00\x00\x00\x00\x00\x00plaintext!")
            raw.settimeout(5)
            try:
                data = raw.recv(64)
            except (ConnectionResetError, TimeoutError):
                data = b""
        finally:
            raw.close()
        expect(data == b"", "a plaintext dial got an answer from the mTLS plane")
        after = poll(lambda: scrape(http_port).get(
            'misaka_plane_tls_rejected_total{reason="plaintext"}', 0.0) > before and True,
                     "the plaintext refusal counted", 10.0)
        out["plaintext_refused"] = bool(after)
    return out


# --- model parallel: the lane-sharded engines on a mesh that repeats one card ------


MP_AUTOGROW = dict(
    node_info={"p": "program", "q": "program", "st": "stack"},
    programs={
        # p pushes until the 0 sentinel, then emits it and drains its stack
        # (reverse_any's program); q is a second lane so that the lanes
        # divide by model_parallel=2 (reverse_any alone has one lane)
        "p": ("top: IN ACC\nJEZ dump\nPUSH ACC, st\nJMP top\n"
              "dump: OUT ACC\npop: POP st, ACC\nOUT ACC\nJMP pop\n"),
        "q": "NOP\n",
    },
)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def wall_ms(fn, device):
    """(fn(), its wall milliseconds from a synchronized start to a
    synchronized end): a host-driven chunk's time as served."""
    _sync(device)
    t = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t) * 1e3


def kernel_result(net, state, ticks):
    """The fused kernel's result from `state` (a state on the device; on a
    CPU state its plain version) and the chunk's time."""
    run = net.fused_runner(ticks, elide_dead_hi=False)
    out, ms = wall_ms(lambda: run(state), net.device)
    if net.device.type == "cuda":
        ms = cuda_time_ms(lambda: run(state), 3)
    return out, ms


def state_diff(got, want):
    """(the fields of `got` that differ from `want`, the largest absolute
    difference), compared on the device: full-width states stay there."""
    import torch

    bad, err = [], 0
    for f, a, b in zip(got._fields, got, want):
        b = b.to(a.device)
        if not torch.equal(a, b):
            bad.append(f)
            err = max(err, int((a.long() - b.long()).abs().max()))
    return bad, err


def shards_diff(shards, whole, mesh):
    """state_diff of every shard against its cut of `whole`."""
    from misaka_tpu_torch.parallel.mesh import shard_state

    bad, err = set(), 0
    for got, want in zip(shards, shard_state(whole, mesh)):
        b, e = state_diff(got, want)
        bad.update(b)
        err = max(err, e)
    return sorted(bad), err


def commits_of(out, entry) -> int:
    return int((out.retired.long() - entry.retired.long()).sum())


def lane_case(label, net, state, want, devices, mp, ticks, engine, graph=None):
    """One lane-sharded runner from `state` on a mesh of `devices` (row-major,
    model=mp; `graph` as build_lane_sharded_runner's), held field by field to
    `want` (the kernel's result from the same state), its model replicas
    equal and its input untouched, on the device.  `ms` is the call's wall
    time, the graph's recording (on a card: one tick) included."""
    from misaka_tpu_torch.parallel import make_routed_runner, make_sharded_runner
    from misaka_tpu_torch.parallel.mesh import make_mesh, replicas_agree, shard_state

    mesh = make_mesh(len(devices), list(devices), model_parallel=mp)
    make = make_routed_runner if engine == "routed" else make_sharded_runner
    run = make(net.code, net.prog_len, mesh, ticks, graph=graph)
    shards = shard_state(state, mesh)
    out, ms = wall_ms(lambda: run(shards), devices[0])
    diverged, err = shards_diff(out, want, mesh)
    replicas = replicas_agree(out, mesh)
    touched, _ = shards_diff(shards, state, mesh)
    row = {"case": label, "engine": engine, "mesh": mesh.shape, "devices": len(devices),
           "lanes": net.num_lanes, "batch": net.batch, "ticks": ticks, "graphed": run.graphed,
           "ms": ms, "exact": not diverged and not replicas and not touched,
           "max_abs_err": err, "out_wr_min": int(min(int(s.out_wr.min()) for s in out)),
           "commits": sum(commits_of(o, s) for o, s in zip(out, shards))}
    for key, bad in (("diverged_from_kernel", diverged), ("replicas_differ", replicas),
                     ("input_mutated", touched)):
        if bad:
            row[key] = bad
    return row


def torch_device_type(device) -> str:
    import torch

    return torch.device(device).type


def mp_runner_cases(batch, chunk, ticks, device, eager_ticks=64):
    """The routed and gather runners against the kernel: add2 at mp2 for one
    `chunk`-tick chunk (and for `eager_ticks` without the CUDA graph, the
    ops issued one by one); mesh8
    at mp2, mp4 and mp8 and dp2 x mp2 (four shards) for `ticks` ticks; every
    shard on `device`.  The kernel runs once per network, state and tick
    count."""
    from misaka_tpu_torch import networks

    rng = np.random.default_rng(SEED + 13)
    rows, kernel = [], {}
    add2 = networks.add2(**MAIN_CAPS).compile(batch=batch, device=device)
    state = main_add2_state(add2, rng)
    want, kernel["add2"] = kernel_result(add2, state, chunk)
    for engine in ("routed", "gather"):
        rows.append(lane_case("add2/mp2", add2, state, want, [device] * 2, 2, chunk, engine))
    if torch_device_type(device) == "cuda":
        want, kernel["add2/eager"] = kernel_result(add2, state, eager_ticks)
        for engine in ("routed", "gather"):
            rows.append(lane_case("add2/mp2/eager", add2, state, want, [device] * 2, 2,
                                  eager_ticks, engine, graph=False))
    del state, want
    mesh8 = networks.mesh8(**MAIN_CAPS).compile(batch=batch, device=device)
    state = with_random_hi(seeded_inputs(mesh8, rng, MAIN_CAPS["in_cap"]), rng)
    want, kernel["mesh8"] = kernel_result(mesh8, state, ticks)
    for label, n, mp in (("mesh8/mp2", 2, 2), ("mesh8/mp4", 4, 4), ("mesh8/mp8", 8, 8),
                         ("mesh8/dp2xmp2", 4, 2)):
        for engine in ("routed", "gather"):
            rows.append(lane_case(label, mesh8, state, want, [device] * n, mp, ticks, engine))
    return rows, kernel


def mp_single_device_cases(batch, ticks, device, dense_rows=8192):
    """The compact and chained steps (core/routing.py) on one device: on
    pipeline32 against the kernel; on a fuzzed 64-lane network (past the
    kernel's 32-lane bound) against each other at the whole batch and
    against the dense step on its first `dense_rows` instances (the dense
    step's election matrices are [B, 64, 256] per tick)."""
    from misaka_tpu_torch import networks
    from misaka_tpu_torch.core import fused
    from misaka_tpu_torch.core.engine import CompiledNetwork
    from misaka_tpu_torch.core.state import NetworkState
    from misaka_tpu_torch.runtime.topology import Topology

    rng = np.random.default_rng(SEED + 17)
    rows = []
    pipe = networks.pipeline(32, **MAIN_CAPS).compile(batch=batch, device=device)
    state = seeded_inputs(pipe, rng, MAIN_CAPS["in_cap"])
    want, kernel_ms = kernel_result(pipe, state, ticks)
    for engine in ("compact", "chained"):
        out, ms = wall_ms(lambda: pipe.run(state, ticks, engine=engine), device)
        bad, err = state_diff(out, want)
        rows.append({"case": "pipeline32", "engine": engine, "lanes": 32, "batch": batch,
                     "ticks": ticks, "ms": ms, "kernel_ms": kernel_ms, "exact": not bad,
                     "max_abs_err": err, "commits": commits_of(out, state),
                     **({"diverged": bad} if bad else {})})
    del state, want, out
    seed = SEED + 29
    top = random_topology(seed, Topology, lanes=(64, 65), **MAIN_CAPS)
    wide = top.compile(batch=batch, device=device)
    expect(wide.num_lanes == 64 and wide.num_lanes > fused.MAX_LANES, "the fuzzed network's lanes")
    state = seeded_inputs(wide, rng, MAIN_CAPS["in_cap"])
    outs = {}
    for engine in ("compact", "chained"):
        outs[engine] = wall_ms(lambda: wide.run(state, ticks, engine=engine), device)
    k = min(dense_rows, batch)
    small = CompiledNetwork(code=wide.code, prog_len=wide.prog_len, num_stacks=wide.num_stacks,
                            stack_cap=wide.stack_cap, in_cap=wide.in_cap, out_cap=wide.out_cap,
                            batch=k, device=device)
    head = NetworkState(*(t[:k].clone() for t in state))
    dense, dense_ms = wall_ms(lambda: small.run(head, ticks, engine="dense"), device)
    for engine, (got, ms) in outs.items():
        bad, err = state_diff(NetworkState(*(t[:k] for t in got)), dense)
        if engine == "chained":
            vs, e2 = state_diff(got, outs["compact"][0])
            bad += [f"{f} (vs compact)" for f in vs]
            err = max(err, e2)
        rows.append({"case": f"fuzzed64/seed{seed}", "engine": engine, "lanes": 64,
                     "batch": batch, "ticks": ticks, "ms": ms, "dense_rows": k,
                     "dense_ms": dense_ms, "exact": not bad, "max_abs_err": err,
                     "commits": commits_of(got, state), **({"diverged": bad} if bad else {})})
    return rows


def mp_master_drill(batch, chunk, n_values, devices, engine, ckpt_dir, grow=True):
    """`MasterNode(device=devices, model_parallel=2)` serving add2: a striped
    n_values stream, every answer checked, and its replicas equal after;
    then (grow=True) a checkpoint at mp2 -> mp1 (the kernel's master on
    devices[0]) -> mp2, every field equal after each load, and a stack
    grown by autogrow under mp2 (16 -> 64), replicas equal after."""
    from misaka_tpu_torch import networks
    from misaka_tpu_torch.core import fused
    from misaka_tpu_torch.core.state import state_to_numpy
    from misaka_tpu_torch.parallel.mesh import replicas_agree
    from misaka_tpu_torch.runtime.master import MasterNode
    from misaka_tpu_torch.runtime.topology import Topology

    def mp_master(top):
        return MasterNode(top, chunk_steps=chunk, batch=batch, device=list(devices),
                          model_parallel=2, engine="gather" if engine == "gather" else "auto")

    def same(a, b, what):
        bad = diverged_fields(state_to_numpy(a.snapshot()), state_to_numpy(b.snapshot()))
        expect(not bad, f"{what}: fields {bad} differ after the load")

    def replicas(m, what):
        with m._state_lock:
            bad = replicas_agree(m._state, m._mesh)
        expect(not bad, f"{what}: model replicas of {bad} differ")

    rng = np.random.default_rng(SEED + 19)
    vals = rng.integers(-(2**31), 2**31, size=n_values, dtype=np.int64).astype(np.int32)
    row = {"engine": engine}
    for k in fused.launch_counts:
        fused.launch_counts[k] = 0
    m2 = mp_master(networks.add2(**MAIN_CAPS))
    try:
        expect(m2.engine_name == engine and m2.status()["mesh"] == {"data": 1, "model": 2},
               f"mp master: {m2.engine_name} {m2.status()['mesh']}")
        m2.run()
        t = time.perf_counter()
        out = m2.compute_spread(vals, timeout=600, return_array=True)
        row["spread_s"] = time.perf_counter() - t
        expect(np.array_equal(out, wrap_i32(vals.astype(np.int64) + 2)),
               f"mp2 {engine}: compute_spread answers differ")
        row["spread_values"] = int(vals.size)
        row["spread_values_per_s"] = vals.size / row["spread_s"]
        expect(m2.compute(41, timeout=300) == 43, "mp2: /compute")
        m2.pause()
        replicas(m2, "after the stream")
        row["mp_launches"] = dict(fused.launch_counts)
        expect(all(n == 0 for n in row["mp_launches"].values()),
               f"the lane-sharded master launched a kernel: {row['mp_launches']}")
        if grow:
            m1 = MasterNode(networks.add2(**MAIN_CAPS), chunk_steps=chunk, batch=batch,
                            device=devices[0])
            try:
                t = time.perf_counter()
                m2.save_checkpoint(os.path.join(ckpt_dir, "mp2.npz"))
                m1.load_checkpoint(os.path.join(ckpt_dir, "mp2.npz"))
                row["checkpoint_mp2_to_mp1_s"] = time.perf_counter() - t
                same(m1, m2, "mp2 -> mp1")
                m1.run()
                few = vals[:5000]
                expect(np.array_equal(m1.compute_spread(few, timeout=300, return_array=True),
                                      wrap_i32(few.astype(np.int64) + 2)), "mp1 after the load")
                m1.pause()
                t = time.perf_counter()
                m1.save_checkpoint(os.path.join(ckpt_dir, "mp1.npz"))
                m2.load_checkpoint(os.path.join(ckpt_dir, "mp1.npz"))
                row["checkpoint_mp1_to_mp2_s"] = time.perf_counter() - t
                same(m2, m1, "mp1 -> mp2")
                replicas(m2, "after the restore")
                m2.run()
                expect(m2.compute(-7, timeout=300) == -5, "mp2 after the load")
            finally:
                m1.close()
    finally:
        m2.close()
    del m2
    if not grow:
        return row
    for k in fused.launch_counts:
        fused.launch_counts[k] = 0
    mg = mp_master(Topology(**MP_AUTOGROW, **MAIN_CAPS))
    try:
        cap0 = mg.status()["stack_cap"]
        mg.run()
        t = time.perf_counter()
        out = mg.compute_many(list(range(1, 41)) + [0], timeout=600)
        row["grow_request_s"] = time.perf_counter() - t
        expect(out == [0] + list(range(40, 0, -1)), f"mp2 autogrow: {out[:8]}")
        cap1 = mg.status()["stack_cap"]
        expect(cap0 == 16 and cap1 == 64, f"mp2 stack_cap {cap0} -> {cap1}")
        mg.pause()
        replicas(mg, "after the autogrow")
        row.update(stack_cap_before=cap0, stack_cap_after=cap1)
        expect(all(n == 0 for n in fused.launch_counts.values()),
               f"the lane-sharded master launched a kernel: {fused.launch_counts}")
    finally:
        mg.close()
    del mg
    return row


MP_WORKER_PROCS = 2


def mp_worker(port, rank, out_path, batch, ticks, device):
    """One process of the two-process drill: joins the gloo group through
    MISAKA_COORDINATOR, runs both lane-sharded engines on its row of add2
    (model=2 over two shards on `device`, the data axis across the
    processes) and hands rank 0 a digest of each field of its rows; rank 0
    holds them to the kernel's result of the whole batch and writes the
    verdict."""
    import hashlib

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    os.environ.update({"MISAKA_COORDINATOR": f"127.0.0.1:{port}",
                       "MISAKA_NUM_PROCESSES": str(MP_WORKER_PROCS),
                       "MISAKA_PROCESS_ID": str(rank)})
    from misaka_tpu_torch import networks
    from misaka_tpu_torch.core.state import state_to_numpy
    from misaka_tpu_torch.parallel import (
        hybrid_mesh, initialize_from_env, make_global_state, make_routed_runner,
        make_sharded_runner)
    from misaka_tpu_torch.parallel.mesh import gather_state, replicas_agree

    def digests(arrays):
        return {f: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
                for f, v in arrays.items()}

    expect(initialize_from_env(), "the process group")
    mesh = hybrid_mesh(model_parallel=2, device=[device, device])
    expect(mesh.shape == {"data": MP_WORKER_PROCS, "model": 2} and mesh.data_offset == rank,
           f"hybrid mesh {mesh.shape} at {mesh.data_offset}")
    net = networks.add2(**MAIN_CAPS).compile(batch=batch, device=device)
    state = seeded_inputs(net, np.random.default_rng(SEED + 23), MAIN_CAPS["in_cap"])
    mine = {}
    for engine, make in (("routed", make_routed_runner), ("gather", make_sharded_runner)):
        out = make(net.code, net.prog_len, mesh, ticks)(make_global_state(state, mesh))
        expect(not replicas_agree(out, mesh), f"rank {rank} {engine}: replicas differ")
        mine[engine] = digests(state_to_numpy(gather_state(out, mesh)))
    reports = [None] * MP_WORKER_PROCS
    dist.all_gather_object(reports, {"rank": rank, "offset": mesh.data_offset, "digests": mine})
    if rank == 0:
        want = state_to_numpy(net.fused_runner(ticks, elide_dead_hi=False)(state))
        rows = batch // MP_WORKER_PROCS
        verdict = {"ranks": MP_WORKER_PROCS, "batch": batch, "ticks": ticks, "exact": True,
                   "bad": []}
        for rep in reports:
            part = digests({f: v[rep["offset"] * rows:(rep["offset"] + 1) * rows]
                            for f, v in want.items()})
            for engine, got in rep["digests"].items():
                bad = [f for f in part if got[f] != part[f]]
                if bad:
                    verdict["exact"] = False
                    verdict["bad"].append({"rank": rep["rank"], "engine": engine, "fields": bad})
        verdict["out_wr_min"] = int(want["out_wr"].min())
        bad_mods = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "misaka_tpu"))
        verdict["jax_free"] = not bad_mods
        with open(out_path, "w") as f:
            json.dump(verdict, f)
    dist.barrier()
    dist.destroy_process_group()
    print("MP_WORKER_OK", flush=True)


def mp_two_processes(batch, ticks, device):
    """Two processes of this script (`--mp-worker`) on the card: a gloo group
    over localhost through MISAKA_COORDINATOR, each rank model=2 over two
    shards of `device`; rank 0 verifies every rank's rows."""
    port = free_port()
    out = os.path.join(ROOT, "build", f"mp_workers_{os.getpid()}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    env = {k: v for k, v in os.environ.items() if not k.startswith("MISAKA_")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mp-worker",
                               str(port), str(r), out, str(batch), str(ticks), device],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(MP_WORKER_PROCS)]
    logs = []
    t = time.perf_counter()
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t
    for p, log in zip(procs, logs):
        expect(p.returncode == 0 and "MP_WORKER_OK" in log, f"mp worker failed:\n{log[-3000:]}")
    with open(out) as f:
        verdict = json.load(f)
    os.unlink(out)
    expect(verdict["exact"] and verdict["jax_free"], f"two-process drill: {verdict}")
    verdict["seconds"] = seconds
    return verdict


def phase_model_parallel(batch=MAIN_BATCH, chunk=MAIN_CHUNK, ticks=128, serve_chunk=64,
                         n_values=100_000, device="cuda:0", card=None):
    """Model parallel (ROADMAP A.7) and the wide-lane steps (A.9) on a mesh
    that repeats one card, in process, at the served shapes (B=262144, caps
    128/128/16): the routed and gather runners held field by field to the
    fused kernel's result from the same state (add2 at mp2 for one
    `chunk`-tick chunk; mesh8 at mp2, mp4, mp8 and dp2 x mp2 for `ticks`);
    the compact and chained one-device steps (pipeline32 against the
    kernel, a fuzzed 64-lane network); `MasterNode(model_parallel=2)` on
    two shards of the card serving add2 (a striped stream, checkpoints
    mp2 -> mp1 -> mp2, autogrow; routed, then the stream again on gather);
    and two processes joined through MISAKA_COORDINATOR.  The path launches
    no kernel (the reference's master.py:1359-1363): every launch counted
    here is a comparison's.  Its times are the routed and gather chunk
    times beside the kernel's.  `ticks` is 128, not 256: the script's time
    limit forces fewer; the masters run `serve_chunk`-tick chunks, so a
    restore's flush and an autogrow's stalled chunks stay short.
    device="cpu" with small sizes rehearses it without a card."""
    t0 = time.perf_counter()
    split = {}
    rows, kernel = mp_runner_cases(batch, chunk, ticks, device)
    split["runners"] = time.perf_counter() - t0
    t = time.perf_counter()
    single = mp_single_device_cases(batch, ticks, device)
    split["single_device"] = time.perf_counter() - t
    failed = [r for r in rows + single if not r["exact"]]
    if failed:
        emit({"phase": "model_parallel", "failed": failed})
        raise SystemExit("a lane-sharded or wide-lane step disagrees with the kernel")
    t = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="ckpt-mp-", dir=os.path.join(ROOT, "build"))
    try:
        routed = mp_master_drill(batch, serve_chunk, n_values, (device, device), "routed",
                                 ckpt_dir)
        gather = mp_master_drill(batch, serve_chunk, n_values, (device, device), "gather",
                                 ckpt_dir, grow=False)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    split["master"] = time.perf_counter() - t
    t = time.perf_counter()
    procs = mp_two_processes(batch, ticks, device)
    split["two_processes"] = time.perf_counter() - t
    times = {}
    for r in rows:
        net = "add2/eager" if r["case"] == "add2/mp2/eager" else r["case"].split("/")[0]
        t = times.setdefault(r["case"], {"ticks": r["ticks"], "kernel_ms": kernel[net],
                                         "graphed": r["graphed"]})
        t[f"{r['engine']}_ms"] = r["ms"]
    row = {"phase": "model_parallel", "card": card, "batch": batch, **MAIN_CAPS,
           "runners": rows, "single_device": single, "master": {"routed": routed,
                                                                "gather": gather},
           "two_processes": procs, "chunk_ms": times, "kernel_ms": kernel,
           "max_abs_err": max(r.get("max_abs_err", 0) for r in rows + single),
           "seconds": split}
    emit(row)
    return row


def cuda_time_ms(fn, reps):
    """Mean device time per call of `fn` after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_breakdown_ms(fn, reps=3):
    """Device time per call of `fn`, split into the fused kernel and the
    rest (the wrapper's clones of the fields the kernel writes), from
    torch.profiler; None where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernel = other = 0.0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue  # host-side ops; their kernels are counted as their own events
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if "fused_superstep_kernel" in e.key:
            kernel += us
        else:
            other += us
    if kernel == 0.0:
        return None
    return {"kernel_ms": kernel / reps / 1e3, "copy_ms": other / reps / 1e3}


def bound(net, state, check, steps):
    """The least time the card could take for one chunk of this run's work:
    the larger of bytes over HBM rate and int32 operations over the int32
    rate.  Bytes: every field read once, every field but the pass-through
    ones written once; the elided variant leaves out the hi rows of hi-dead
    lanes.  Operations: OPS_PER_LANE_TICK on every lane-tick, plus each
    committed instruction's update (cheaper on a hi-dead lane).  `state`
    is batched (an unbatched one as its batch-of-one view)."""
    batch = state.pc.shape[0]
    nbytes = {f: t.numel() * t.element_size() for f, t in zip(state._fields, state)}
    bytes_moved = 2 * sum(nbytes.values()) - sum(
        nbytes[f] for f in ("in_buf", "in_wr", "out_rd"))
    bytes_moved -= 2 * 2 * check["dead_lanes"] * batch * 4  # acc_hi, bak_hi rows
    lane_ticks = batch * steps * net.num_lanes
    dead = check["dead_commits"] if check["elide"] else 0
    ops = (lane_ticks * OPS_PER_LANE_TICK + (check["commits"] - dead) * OPS_PER_COMMIT
           + dead * OPS_PER_DEAD_COMMIT)
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"lane_ticks": lane_ticks, "commits": check["commits"],
            "dead_commits": dead, "bytes": bytes_moved, "int32_ops": ops,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def geometry(net, hi_mode, batch):
    """The launch geometry of the instantiation that runs `net` in
    `hi_mode`, as the CUDA runtime reports it on card 0, and the waves
    `batch` instances take: batch / (blocks per SM x block x SMs)."""
    import torch

    from misaka_tpu_torch.core import fused

    blocks, threads = fused.occupancy(net.num_lanes, net.code.shape[1], hi_mode)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"hi_mode": hi_mode, "blocks_per_sm": blocks, "block": threads, "sms": sms,
            "batch": batch, "waves": batch / (blocks * threads * sms)}


def wide_timing(name, top, check_steps=128):
    """The full kernel on a wider network at the main path's batch, caps and
    chunk (the 8- and 32-lane builds, whose geometry differs from add2's):
    held against the plain version over `check_steps` ticks, then timed over
    the chunk, its bound counted from that chunk's commits."""
    from misaka_tpu_torch.core import fused
    from misaka_tpu_torch.core.state import state_to_numpy

    net = top.compile(batch=MAIN_BATCH, device="cuda")
    state = seeded_inputs(net, np.random.default_rng(SEED), MAIN_CAPS["in_cap"])
    check = compare(f"{name}/short", net, state, check_steps)
    if not check["exact"]:
        emit({"phase": "timings", "failed": [check]})
        raise SystemExit(f"kernel disagrees with its plain version on {name}")
    run = net.fused_runner(MAIN_CHUNK, elide_dead_hi=False)
    out = state_to_numpy(run(state))
    commits = int((out["retired"] - state_to_numpy(state)["retired"]).astype(np.int64).sum())
    counted = {"commits": commits, "dead_commits": 0, "elide": False, "dead_lanes": 0}
    return {"lanes": net.num_lanes, "exact": True, "max_abs_err": check["max_abs_err"],
            "checked_steps": check_steps, "ms": cuda_time_ms(lambda: run(state), 3),
            "geometry": geometry(net, fused.HI_FULL, MAIN_BATCH),
            "device_breakdown": device_breakdown_ms(lambda: run(state), 2) or "not measured",
            **bound(net, state, counted, MAIN_CHUNK)}


def phase_timings(smi, dp_check):
    """At the main path's shapes: the full kernel and the elided variant,
    each held against the plain version from the same input state, then
    timed in turns (full, elided, elided, full) with their bounds (one
    plain run, shared by both checks); the
    data-parallel runner with two shards on cuda:0 from the same state,
    held to the whole-batch launch and timed in turns with it (whole, dp,
    dp, whole), its bound the whole batch's over the one card it runs on
    (`dp_check`: phase_dp_parity's add2 row at these shapes, for the plain
    version's time); the full kernel at caps 1024, the big-capacity row;
    and the 8- and 32-lane builds (`wide_timing`)."""
    from misaka_tpu_torch import networks
    from misaka_tpu_torch.core import fused
    from misaka_tpu_torch.core.state import state_to_numpy
    from misaka_tpu_torch.parallel.mesh import ShardedNetwork, gather_state, make_mesh, shard_state

    rng = np.random.default_rng(SEED)
    net = networks.add2(**MAIN_CAPS).compile(batch=MAIN_BATCH, device="cuda")
    state = main_add2_state(net, rng)
    # one plain run for both variants: phase_dp_parity's, from this state
    plain = plain_result(net, state, MAIN_CHUNK, "add2/main")
    PLAIN.pop("add2/main", None)
    full = compare("main_path/add2", net, state, MAIN_CHUNK, plain=plain)
    elided = compare("main_path/add2/elided", net, state, MAIN_CHUNK, elide=True, plain=plain)
    big_net = networks.add2(in_cap=1024, out_cap=1024, stack_cap=1024).compile(
        batch=MAIN_BATCH, device="cuda")
    big_state = seeded_inputs(big_net, rng, 1024)
    big = compare("add2/cap1024", big_net, big_state, MAIN_CHUNK)
    failed = [c for c in (full, elided, big) if not c["exact"]]
    if failed:
        emit({"phase": "timings", "failed": failed})
        raise SystemExit("kernel disagrees with its plain version at the timed shapes")
    run_full = net.fused_runner(MAIN_CHUNK, elide_dead_hi=False)
    run_elided = net.fused_runner(MAIN_CHUNK, elide_dead_hi=True)
    turns = {"full": [], "elided": []}
    for which in ("full", "elided", "elided", "full"):
        fn = run_full if which == "full" else run_elided
        turns[which].append(cuda_time_ms(lambda: fn(state), 10))
    mesh = make_mesh(2, ["cuda:0", "cuda:0"])
    run_dp = ShardedNetwork(net, mesh).fused_runner(MAIN_CHUNK, elide_dead_hi=False)
    shards = shard_state(state, mesh)
    dp_diverged = diverged_fields(state_to_numpy(gather_state(run_dp(shards))),
                                  state_to_numpy(run_full(state)))
    if dp_diverged:
        raise SystemExit(f"DP runner differs from the whole-batch launch in {dp_diverged}")
    dp_turns = {"whole": [], "dp": []}
    for which in ("whole", "dp", "dp", "whole"):
        fn = (lambda: run_full(state)) if which == "whole" else (lambda: run_dp(shards))
        dp_turns[which].append(cuda_time_ms(fn, 10))
    run_big = big_net.fused_runner(MAIN_CHUNK, elide_dead_hi=False)
    big_ms = cuda_time_ms(lambda: run_big(big_state), 5)
    wide = {name: wide_timing(name, top) for name, top in (
        ("mesh8", networks.mesh8(**MAIN_CAPS)), ("pipeline32", networks.pipeline(32, **MAIN_CAPS)))}
    row = {
        "phase": "timings", "card": smi, "network": "add2", "batch": MAIN_BATCH,
        "ticks": MAIN_CHUNK, **MAIN_CAPS,
        "full": {"exact": full["exact"], "max_abs_err": full["max_abs_err"],
                 "ms": float(np.mean(turns["full"])), "ms_turns": turns["full"],
                 "plain_ms": full["plain_ms"],
                 "geometry": geometry(net, fused.HI_FULL, MAIN_BATCH),
                 "device_breakdown": device_breakdown_ms(lambda: run_full(state))
                 or "not measured",
                 **bound(net, state, full, MAIN_CHUNK)},
        "elided": {"exact": elided["exact"], "max_abs_err": elided["max_abs_err"],
                   "dead_lanes": elided["dead_lanes"],
                   "ms": float(np.mean(turns["elided"])), "ms_turns": turns["elided"],
                   "plain_ms": elided["plain_ms"],
                   "geometry": geometry(net, fused.HI_DEAD, MAIN_BATCH),
                   "device_breakdown": device_breakdown_ms(lambda: run_elided(state))
                   or "not measured",
                   **bound(net, state, elided, MAIN_CHUNK)},
        "dp": {"shards": 2, "cards": 1, "exact": True, "max_abs_err": 0,
               "variant": run_dp.variant,
               "ms": float(np.mean(dp_turns["dp"])), "ms_turns": dp_turns["dp"],
               "whole_batch_ms": float(np.mean(dp_turns["whole"])),
               "whole_batch_ms_turns": dp_turns["whole"],
               "plain_ms": dp_check["plain_ms"],
               "geometry": geometry(net, fused.HI_FULL, MAIN_BATCH // 2),
               "device_breakdown": device_breakdown_ms(lambda: run_dp(shards))
               or "not measured",
               # the whole batch's work on the one card both shards share
               **bound(net, state, full, MAIN_CHUNK)},
        "cap1024": {"caps": 1024, "exact": big["exact"], "max_abs_err": big["max_abs_err"],
                    "ms": big_ms, "plain_ms": big["plain_ms"],
                    "device_breakdown": device_breakdown_ms(lambda: run_big(big_state), 2)
                    or "not measured",
                    **bound(big_net, big_state, big, MAIN_CHUNK)},
        "wide": wide,
        "library_ms": None,
    }
    emit(row)
    return row


def phase_unbatched_timings(smi, steps_list=(128, 2048)):
    """add2 at B=1 with the README server's default caps (1024), a chunk of
    128 ticks (the served one) and of 2048, each with an 8-value feed: held
    kernel against plain first, then the card's own times (CUDA events,
    many calls from the same input state) of serve_chunk through the
    kernel, with the kernel alone from torch.profiler; of serve_chunk under
    engine="scan" (the plain loop on the card: the one call of the check,
    CUDA events); and of one traced 128-tick chunk (run_traced, ring of
    256).  The bound counts this run's operations; at one thread a chunk is
    bound by the latency of its serial ticks, which the bound does not
    see."""
    from misaka_tpu_torch import networks
    from misaka_tpu_torch.core.engine import as_batch

    net = networks.add2().compile(device="cuda")
    rng = np.random.default_rng(SEED + 9)
    vals = rng.integers(-1000, 1000, size=net.in_cap).astype(np.int32)
    rows = {}
    for steps in steps_list:
        state = net.init_state()
        check, _ = compare_unbatched(f"add2/B=1/{steps}", net, state, vals, 8, steps)
        if not check["exact"]:
            emit({"phase": "unbatched_timings", "failed": [check]})
            raise SystemExit(f"unbatched kernel disagrees with its plain version at {steps}")
        rows[steps] = {
            "exact": True, "max_abs_err": check["max_abs_err"], "commits": check["commits"],
            "ms": cuda_time_ms(lambda: net.serve_chunk(state, vals, 8, steps), 20),
            "device_breakdown": device_breakdown_ms(
                lambda: net.serve_chunk(state, vals, 8, steps), 5) or "not measured",
            "plain_ms": check["plain_ms"],
            **bound(net, as_batch(state), dict(check, dead_lanes=0, elide=False,
                                               dead_commits=0), steps),
        }
    fed, _ = net.feed(net.init_state(), vals[:8])
    trace = net.init_trace(256)
    rows[steps_list[0]]["traced_ms"] = cuda_time_ms(
        lambda: net.run_traced(fed, trace, steps_list[0]), 1)
    row = {"phase": "unbatched_timings", "card": smi, "network": "add2", "batch": None,
           "caps": 1024, "fed": 8, "chunks": rows,
           "note": "one thread: the chunk is bound by the latency of its serial ticks"}
    emit(row)
    return row


def ptxas_summary(report: str):
    """Registers, spills, stack and shared memory per kernel instantiation
    (max lanes, hi mode: 0 full, 1 mask, 2 all lanes hi-dead)."""
    out = []
    for m in re.finditer(
        r"fused_superstep_kernelILi(\d+)ELi(\d+)EE.*?\n\s+(\d+) bytes stack frame, (\d+) bytes "
        r"spill stores, (\d+) bytes spill loads\nptxas info\s+: Used (\d+) registers(.*)",
        report,
    ):
        smem = re.search(r"(\d+) bytes smem", m.group(7))
        out.append({"max_lanes": int(m.group(1)), "hi_mode": int(m.group(2)),
                    "registers": int(m.group(6)), "stack_bytes": int(m.group(3)),
                    "spill_stores": int(m.group(4)), "spill_loads": int(m.group(5)),
                    "static_smem": int(smem.group(1)) if smem else 0})
    return out


def host_cpu() -> dict:
    """The host CPU's model, core count and SIMD flags, from /proc/cpuinfo
    (the first processor's fields; vendor, family and model numbers where
    the machine gives no model name): the native tier runs on it."""
    import platform

    first, cores = {}, 0
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            key = key.strip()
            if key == "processor":
                cores += 1
            first.setdefault(key, value.strip())
    model = first.get("model name") or " ".join(
        f"{k} {first[k]}" for k in ("vendor_id", "cpu family", "model", "stepping")
        if first.get(k)) or platform.processor()
    if not model and shutil.which("lscpu"):
        out = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
        model = next((line.split(":", 1)[1].strip() for line in out.splitlines()
                      if line.startswith("Model name")), "")
    flags = set(first.get("flags", "").split())
    return {"model": model or "unknown", "cores": cores,
            "simd": [f for f in ("avx2", "avx512f", "fma") if f in flags],
            "cpuinfo_fields": sorted(k for k in first if k)}


NATIVE_PREBUILD = {}  # start_native_builds: the build dir, the spec dir, the builds' futures


def start_native_builds():
    """Start the native tier's builds, each on its own thread, so that they
    run beside the kernel's nvcc: the interpreter, the assembler, the JIT's
    stencils, the native edge and the decimal codec from the port's C++
    copies, and the specialized interpreters of add2 and mesh8 at the
    parity caps (128/128/16).  phase_native waits for them and reports each
    one's seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from misaka_tpu_torch import networks
    from misaka_tpu_torch.core import cinterp, jit, specialize
    from misaka_tpu_torch.runtime import frontends
    from misaka_tpu_torch.tis import native as tis_native
    from misaka_tpu_torch.utils import textcodec

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="native-", dir=os.path.join(ROOT, "build"))
    spec_dir = os.path.join(tmp, "spec")
    caps = dict(in_cap=128, out_cap=128, stack_cap=16)

    def timed(fn):
        t = time.perf_counter()
        ok = fn()
        return {"ok": bool(ok), "wall_s": time.perf_counter() - t}

    jobs = {"interpreter": cinterp.NATIVE.available, "assembler": tis_native.NATIVE.available,
            "frontend": frontends._FRONTEND_LIB.available,
            "textcodec": textcodec._NATIVE.available}
    if jit.supported():
        jobs["stencils"] = lambda: jit.build_stencils(spec_dir)
    for name in ("add2", "mesh8"):
        net = getattr(networks, name)(**caps).compile(device="cpu")
        jobs[f"specialized/{name}"] = lambda net=net: specialize.build(net, cache_dir=spec_dir)
    pool = ThreadPoolExecutor(len(jobs))
    futures = {k: pool.submit(timed, fn) for k, fn in jobs.items()}
    pool.shutdown(wait=False)
    NATIVE_PREBUILD.update(tmp=tmp, spec_dir=spec_dir, futures=futures)


def native_lowering(reps=20):
    """tis/native.py's two lowerers, best of `reps`, on every program of
    pipeline32 (the widest served network) and on one program each of 8
    to 1024 lines, their tables equal: where the native backend wins
    (`assemble` takes it from NATIVE_MIN_LINES lines)."""
    from misaka_tpu_torch import networks
    from misaka_tpu_torch.tis import native as tis_native
    from misaka_tpu_torch.tis.lower import lower_program

    top = networks.pipeline(32)
    lanes, stacks = top.lane_ids(), top.stack_ids()
    cases = [("pipeline32", [top.programs[n] for n in lanes])]
    for n in (8, 16, 32, 64, 256, 1024):
        lines = []
        for i in range(n // 4):
            lines += [f"L{i}: IN ACC", "ADD 2", "OUT ACC", f"JGZ L{i}"]
        cases.append((f"{n} lines", ["\n".join(lines)]))

    def best_ms(fn, progs):
        best = float("inf")
        for _ in range(reps):
            t = time.perf_counter()
            for p in progs:
                fn(p, lanes, stacks)
            best = min(best, time.perf_counter() - t)
        return best * 1e3

    rows = []
    for label, progs in cases:
        for p in progs:
            a, b = lower_program(p, lanes, stacks), tis_native.assemble_native(p, lanes, stacks)
            expect(np.array_equal(a.code, b.code), f"lowering {label}: the backends differ")
        rows.append({"case": label, "programs": len(progs),
                     "lines": sum(p.count("\n") + 1 for p in progs),
                     "python_ms": best_ms(lower_program, progs),
                     "native_ms": best_ms(tis_native.assemble_native, progs)})
    return {"reps": reps, "native_min_lines": tis_native.NATIVE_MIN_LINES, "cases": rows}


NATIVE_RUNGS = ("jit", "specialized", "auto", "generic", "scalar")
RUNNING_TOTAL_PROGRAM = "IN ACC\nMOV ACC, misaka1:R0\nSWP\nADD R0\nOUT ACC\nSAV"


def native_rung(info) -> str:
    """The live rung a pool's simd_info names."""
    if info["jit"]:
        return "jit"
    if info["specialized"]:
        return "specialized"
    return "avx2" if info["avx2"] else ("generic" if info["width"] else "scalar")


def native_pool_case(label, cpu_net, state_np, want, rung, ticks, spec_dir):
    """One NativePool rung asked for by its env from `state_np` (numpy
    arrays of the kernel's entry state), `ticks` ticks in one stateless
    call, held field by field to `want` (the kernel's result, numpy; stack
    slots compared below each top: pops leave residue in the kernel, the
    interpreter's export zero-pads)."""
    from misaka_tpu_torch.core import cinterp, jit, specialize

    prev = os.environ.get("MISAKA_SIMD")
    lib, prog = None, None
    if rung == "specialized":
        so = specialize.build(cpu_net, cache_dir=spec_dir)
        expect(so is not None, f"{label}: specialized build failed")
        lib = cinterp.load_specialized(so)
    if rung in ("generic", "scalar"):
        os.environ["MISAKA_SIMD"] = "generic" if rung == "generic" else "0"
    try:
        pool = cinterp.NativePool(cpu_net.code, cpu_net.prog_len, cpu_net.num_stacks,
                                  cpu_net.stack_cap, cpu_net.in_cap, cpu_net.out_cap,
                                  replicas=cpu_net.batch, lib=lib)
    finally:
        if prev is None:
            os.environ.pop("MISAKA_SIMD", None)
        else:
            os.environ["MISAKA_SIMD"] = prev
    try:
        if rung == "jit":
            prog = jit.prepare(cpu_net, cache_dir=spec_dir)
            expect(prog is not None and pool.jit_arm(prog) == 0, f"{label}: jit did not arm")
        got_rung = native_rung(pool.simd_info())
        # auto: AVX2 where the CPU has it, else the generic group tick
        allowed = ("avx2", "generic") if rung == "auto" else (rung,)
        expect(got_rung in allowed, f"{label}: asked for {rung}, ran {got_rung}")
        # the pool writes the chunk's state into the arrays it is given:
        # each rung gets its own copy of the entry state
        entry = {k: v.copy() for k, v in state_np.items()}
        t = time.perf_counter()
        out, _ = pool.idle(entry, ticks)
        ms = (time.perf_counter() - t) * 1e3
    finally:
        pool.close()
        if prog is not None:
            prog.close()
    bad = []
    for f, w in want.items():
        g = np.asarray(out[f])
        if f == "stack_mem":
            col = np.arange(w.shape[-1])
            keep = col < want["stack_top"][..., None]
            g, w = np.where(keep, g, 0), np.where(keep, w, 0)
        w = np.asarray(w)
        if g.dtype != w.dtype:
            g, w = g.astype(np.int64), w.astype(np.int64)
        if not np.array_equal(g, w):
            bad.append(f)
    expect(not bad, f"{label} ({rung}): fields differ from the kernel: {bad}")
    return {"case": label, "rung": got_rung, "ms": ms, "replicas": cpu_net.batch,
            "ticks": ticks, "exact": True}


def native_parity(batch, ticks, device, spec_dir, rungs_for=("add2", "mesh8")):
    """Every rung this host offers on add2 and mesh8, the auto rung on
    pipeline32, each against the kernel from the same state; then
    NativeServe unbatched against the kernel's B=1 view."""
    import torch

    from misaka_tpu_torch import networks
    from misaka_tpu_torch.core import jit
    from misaka_tpu_torch.core.native_serve import NativeServe
    from misaka_tpu_torch.core.state import state_to_numpy

    caps = dict(in_cap=128, out_cap=128, stack_cap=16)
    rows = []
    rng = np.random.default_rng(SEED + 14)
    offered = [r for r in NATIVE_RUNGS if r != "jit" or jit.supported()]
    for name, top in (("add2", networks.add2(**caps)), ("mesh8", networks.mesh8(**caps)),
                      ("pipeline32", networks.pipeline(32, **caps))):
        net = top.compile(batch=batch, device=device)
        cpu_net = top.compile(batch=batch, device="cpu")
        state = seeded_inputs(net, rng, 24)
        want_state, kernel_ms = kernel_result(net, state, ticks)
        want = state_to_numpy(want_state)
        entry = state_to_numpy(state)
        del want_state
        for rung in (offered if name in rungs_for else ("auto",)):
            row = native_pool_case(f"{name}/{rung}", cpu_net, entry, want, rung, ticks, spec_dir)
            row["kernel_ms"] = kernel_ms
            rows.append(row)
        del state
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    # NativeServe, unbatched, against the kernel's B=1 view
    top = networks.add2(**caps)
    net1 = top.compile(device=device)
    serve = net1.make_serve(128, "auto")
    ns = NativeServe(top.compile(device="cpu"))
    s_dev = net1.init_state()
    s_nat = top.compile(device="cpu").init_state()
    try:
        for it in range(8):
            vals = np.zeros((net1.in_cap,), np.int32)
            count = int(rng.integers(0, 6))
            vals[:count] = rng.integers(-1000, 1000, size=count)
            s_dev, p_dev = serve(s_dev, vals, count)
            s_nat, p_nat = ns.serve_chunk(s_nat, vals, count, 128)
            s_nat = ns.export_resident(s_nat) or s_nat
            expect(np.array_equal(p_dev.cpu().numpy(), p_nat), f"NativeServe packed, chunk {it}")
            a, b = state_to_numpy(s_dev), state_to_numpy(s_nat)
            col = np.arange(a["stack_mem"].shape[-1])
            for s in (a, b):
                s["stack_mem"] = np.where(col < s["stack_top"][..., None], s["stack_mem"], 0)
            bad = [f for f in a if not np.array_equal(a[f], b[f])]
            expect(not bad, f"NativeServe state, chunk {it}: {bad}")
        expect(int(s_nat.out_wr) > 0, "NativeServe computed nothing")
    finally:
        ns.close()
    rows.append({"case": "add2/unbatched", "rung": "interpreter", "chunks": 8, "ticks": 128,
                 "exact": True})
    return rows


def phase_native(batch=MAIN_BATCH, ticks=128, served_batch=4096, n_latency=100,
                 n_clients=32, per_client=10, n_raw=100_000, device=None, card=None,
                 unbatched_row=None):
    """The native host tier (engine="native", core/native_serve.py) on the
    card's host, while no other server of this script is up:

    1. build: the interpreter, the assembler, the JIT's stencils and the
       specialized interpreters of add2 and mesh8 from the port's C++
       copies with the host compiler (start_native_builds, beside the
       kernel's nvcc; seconds each), the host CPU, the SIMD rung `auto`
       picks, both lowerers timed (native_lowering); the card's `auto` path
       builds no native engine (the native handle counters are 0 here, and
       an in-process batched master on the card serves "fused");
    2. parity: at B=`batch`, caps 128/128/16, every rung this host offers
       (jit, specialized, avx2 or generic, scalar; each asked for by its
       env and asserted as the rung that ran) on add2 and mesh8, the auto
       rung on pipeline32, `ticks` ticks in one call against the kernel
       from the same state, every field exact; NativeServe unbatched
       against the kernel's B=1 view, 8 chunks;
    3. served: the README env with MISAKA_ENGINE=native (unbatched): 99
       quiet /compute (p50, p90) and n_clients x per_client, beside the
       card's B=1 lane from `unbatched_row` (the unbatched_path phase);
       then a running total loaded over /load, checkpointed, continued on
       the card's unbatched kernel in this process, checkpointed back and
       restored into the native server: the totals carry on.  At the same
       time MISAKA_BATCH=`served_batch` natively: n_raw values striped on
       /compute_raw (every answer checked, values/s, the ladder's rung
       from /status), a checkpoint restored into a fused master on the
       card at the same batch and back;
    4. registry: one program uploaded to an in-process native registry
       engine at B=`served_batch` activates on the jit rung (seconds, the
       misaka_native_jit_total{status="armed"} delta).

    device="cpu" rehearses it (the kernel's plain version in its place)."""
    from misaka_tpu_torch import networks
    from misaka_tpu_torch.core import cinterp, jit
    from misaka_tpu_torch.runtime.master import MasterNode
    from misaka_tpu_torch.runtime import frontends
    from misaka_tpu_torch.runtime.registry import ProgramRegistry
    from misaka_tpu_torch.tis import native as tis_native
    from misaka_tpu_torch.utils import nativelib, textcodec

    device = device or "cuda"
    if not NATIVE_PREBUILD:
        start_native_builds()
    tmp, spec_dir = NATIVE_PREBUILD["tmp"], NATIVE_PREBUILD["spec_dir"]
    steps = {}
    try:
        created = cinterp._C_CREATED.labels(kind="pool").value + \
            cinterp._C_CREATED.labels(kind="interp").value
        expect(created == 0, f"native engines built before the native phase: {created}")
        if device != "cpu":
            m = MasterNode(networks.add2(), batch=8, device=device)
            expect(m.engine_name == "fused", f"auto on the card: {m.engine_name}")
            m.close()
        # 1. the builds, started beside the kernel's nvcc (start_native_builds)
        t_step = time.perf_counter()
        builds = {}
        for name, fut in NATIVE_PREBUILD["futures"].items():
            builds[name] = fut.result()
            expect(builds[name]["ok"], f"{name}: the host compiler could not build it")
        for name, lib in (("interpreter", cinterp.NATIVE), ("assembler", tis_native.NATIVE),
                          ("frontend", frontends._FRONTEND_LIB),
                          ("textcodec", textcodec._NATIVE)):
            builds[name].update(seconds=lib.build_seconds, so=os.path.relpath(lib.so_path(), ROOT))
        steps["builds_wait"] = time.perf_counter() - t_step
        probe = cinterp.NativePool(networks.add2().compile(device="cpu").code,
                                   networks.add2().compile(device="cpu").prog_len,
                                   1, 16, 16, 16, replicas=16, threads=1)
        auto_rung = native_rung(probe.simd_info())
        probe.close()
        cpu = host_cpu()
        lowering = native_lowering()
        emit({"phase": "native_build", "builds": builds, "beside": "the kernel's nvcc",
              "host_cpu": cpu, "auto_rung": auto_rung, "cxx": nativelib.cxx(),
              "lowering": lowering})
        # 2. parity against the kernel
        t = time.perf_counter()
        rows = native_parity(batch, ticks, device, spec_dir)
        parity_s = steps["parity"] = time.perf_counter() - t
        emit({"phase": "native_parity", "tolerance": "exact (integer state; stack slots "
              "below each top)", "cases": rows, "seconds": parity_s, "card": card})
        # 3. served
        t_step = time.perf_counter()
        ckpt_dir = os.path.join(tmp, "ckpt")
        os.makedirs(ckpt_dir)
        specs = [dict(label="native_unbatched", node_info=ADD2_NODES, programs=readme_programs(),
                      batch=None, chunk=None, caps=None, device=device, autorun=False,
                      MISAKA_ENGINE="native", MISAKA_CHECKPOINT_DIR=ckpt_dir),
                 dict(label="native_batched", node_info=ADD2_NODES, programs=readme_programs(),
                      batch=served_batch, chunk=None, caps=None, device=device,
                      MISAKA_ENGINE="native", MISAKA_CHECKPOINT_DIR=ckpt_dir,
                      MISAKA_SPEC_CACHE=spec_dir)]
        with served_apps(specs) as [(uport, u_boot), (bport, b_boot)]:
            st = status(uport)
            expect(st["engine"] == "native" and st["device"] == "cpu" and "batch" not in st,
                   f"native unbatched status {st}")
            expect(post_form(uport, "/run") == (200, b"Success"), "/run")
            lat = []
            for v in list(range(-49, 50))[: n_latency - 1]:
                t = time.perf_counter()
                code, body = post_form(uport, "/compute", value=str(v))
                lat.append(time.perf_counter() - t)
                expect(code == 200 and json.loads(body) == {"value": v + 2},
                       f"native /compute {v} -> {code} {body!r}")
            quiet = np.sort(np.asarray(lat))

            def client(i):
                for j in range(per_client):
                    v = i * 1000 + j
                    c, b = post_form(uport, "/compute", value=str(v))
                    if c != 200 or json.loads(b) != {"value": v + 2}:
                        raise RuntimeError(f"/compute {v} -> {c} {b!r}")

            errors, clients_s = run_clients(n_clients, client)
            expect(not errors, f"native clients: {errors[:4]}")
            ust = status(uport)
            expect(all(n == 0 for n in ust["kernel_launches"].values()),
                   f"the native server launched the kernel: {ust['kernel_launches']}")
            # the running total across engines: native -> card -> native
            code, body = post_form(uport, "/load", targetURI="misaka1",
                                   program=RUNNING_TOTAL_PROGRAM)
            expect(code == 200, f"/load running total: {body!r}")
            expect(post_form(uport, "/run")[0] == 200, "/run")
            got = [json.loads(post_form(uport, "/compute", value=str(v))[1])["value"]
                   for v in (5, 3, 10)]
            expect(got == [5, 8, 18], f"native running total {got}")
            expect(post_form(uport, "/checkpoint", name="rt") == (200, b"Success"), "/checkpoint")
            card_m = MasterNode(networks.add2(), device=device)
            card_m.load_checkpoint(os.path.join(ckpt_dir, "rt.npz"))
            card_m.run()
            expect(card_m.compute(2) == 20, "the card's master did not continue the total")
            card_engine = card_m.engine_name
            card_m.save_checkpoint(os.path.join(ckpt_dir, "rt2.npz"))
            card_m.close()
            expect(post_form(uport, "/restore", name="rt2") == (200, b"Success"), "/restore")
            expect(post_form(uport, "/run")[0] == 200, "/run")
            code, body = post_form(uport, "/compute", value="1")
            expect(json.loads(body) == {"value": 21}, f"native after the card: {body!r}")
            # the batched native server: the striped stream, its rung, a
            # checkpoint round trip through the card's fused master
            bst = status(bport)
            expect(bst["engine"] == "native" and bst["batch"] == served_batch, f"{bst}")
            rng = np.random.default_rng(SEED + 15)
            vals = rng.integers(-(2**31), 2**31, size=n_raw, dtype=np.int64).astype(np.int32)
            raw_s = check_raw(bport, vals)
            b_rung = native_rung(status(bport)["native"])
            expect(post_form(bport, "/checkpoint", name="b1") == (200, b"Success"), "/checkpoint")
            b_tick = status(bport)["tick"]
            fm = MasterNode(networks.add2(), batch=served_batch, device=device)
            fm.load_checkpoint(os.path.join(ckpt_dir, "b1.npz"))
            f_tick = fm.status()["tick"]
            fm.run()
            expect(fm.compute_spread(list(range(10_000))) == list(range(2, 10_002)),
                   "the card's fused master after the native checkpoint")
            f_engine = fm.engine_name
            fm.save_checkpoint(os.path.join(ckpt_dir, "b2.npz"))
            fm.close()
            expect(post_form(bport, "/restore", name="b2") == (200, b"Success"), "/restore b2")
            expect(post_form(bport, "/run")[0] == 200, "/run")
            check_raw(bport, np.arange(-5000, 5000, dtype=np.int32))
            blaunch = status(bport)["kernel_launches"]
            expect(all(n == 0 for n in blaunch.values()), f"native batched launched {blaunch}")
        steps["served"] = time.perf_counter() - t_step
        # 4. registry activation on the jit rung
        t_step = time.perf_counter()
        reg = ProgramRegistry(os.path.join(tmp, "registry"), batch=served_batch,
                              engine="native", device="cpu")
        try:
            armed0 = jit.M_JIT.labels(status="armed").value
            reg.publish("add10", tis="IN ACC\nADD 10\nOUT ACC")
            t = time.perf_counter()
            with reg.lease("add10") as m:
                activation_s = time.perf_counter() - t
                r_rung = native_rung(m.status()["native"])
                expect(m.compute_many([5]) == [15], "registry native engine")
            armed = jit.M_JIT.labels(status="armed").value - armed0
        finally:
            reg.close()
        steps["registry"] = time.perf_counter() - t_step
        expect(not jit.supported() or (r_rung == "jit" and armed >= 1),
               f"registry engine rung {r_rung}, jit armed delta {armed}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row = {"phase": "native", "card": card, "host_cpu": cpu, "auto_rung": auto_rung,
           "builds": builds, "lowering": lowering, "steps_s": steps, "parity_cases": len(rows),
           "parity_ms": {r["case"]: r.get("ms") for r in rows},
           "kernel_ms": {r["case"].split("/")[0]: r["kernel_ms"] for r in rows if "kernel_ms" in r},
           "unbatched": {"boot_s": u_boot, "compute_latency_samples": len(quiet),
                         "compute_latency_p50_s": float(np.percentile(quiet, 50)),
                         "compute_latency_p90_s": float(np.percentile(quiet, 90)),
                         "clients": n_clients, "client_requests": n_clients * per_client,
                         "client_requests_per_s": n_clients * per_client / clients_s},
           "card_b1_lane": None if unbatched_row is None else {
               k: unbatched_row[k] for k in ("compute_latency_p50_s", "compute_latency_p90_s",
                                             "client_requests_per_s")},
           "running_total_via": card_engine,
           "batched": {"batch": served_batch, "boot_s": b_boot, "rung": b_rung,
                       "compute_raw_values": n_raw, "compute_raw_s": raw_s,
                       "compute_raw_values_per_s": n_raw / raw_s,
                       "checkpoint_tick_native": b_tick, "checkpoint_tick_card": f_tick,
                       "card_engine": f_engine},
           "registry": {"rung": r_rung, "activation_s": activation_s,
                        "jit_armed_delta": armed}}
    expect(b_tick == f_tick, f"checkpoint ticks {b_tick} vs {f_tick}")
    emit(row)
    return row


# --- the native edge: the C++ epoll frontend on the public port ------------------

# the keys of the reference's native edge tests: an admin, two `vps<4`
# tenants with the same spec (the 413 probe sends each tier its own, so that
# the process's buckets never mix legs) and a disabled key
NE_KEYS = [
    {"key": "adm-secret", "tenant": "ops", "admin": True},
    {"key": "tiny-a-secret", "tenant": "tiny-a", "quota": "vps<4"},
    {"key": "tiny-b-secret", "tenant": "tiny-b", "quota": "vps<4"},
    {"key": "eve-secret", "tenant": "eve", "disabled": True},
]
NE_ADMIN = {"X-Misaka-Key": "adm-secret"}
# compared byte for byte when present on either side; the per-request ones
# (Date, Server, Server-Timing, X-Misaka-Trace) are not
NE_PARITY_HEADERS = ("content-type", "content-length", "retry-after", "www-authenticate")


def raw_call(port, method, path, body=None, headers=None, timeout=120):
    """(status, lower-cased headers, body) of one request sent as given
    (http.client adds no Content-Type of its own)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        conn.close()


def native_edge_corpus():
    """(label, method, path, body, headers, how): the reference's parity
    corpus (tests/test_native_edge.py).  how: "bytes" (status, body and the
    parity headers equal), "413" (the same with each tier's own tenant),
    "shape" (status and the typed message), "keys" (status and the JSON
    keys: the engine's /status, proxied)."""
    from misaka_tpu_torch.utils import wire

    msk = {**NE_ADMIN, "Content-Type": wire.CONTENT_TYPE, "Accept": wire.CONTENT_TYPE}
    i32 = lambda *v: np.asarray(v, "<i4").tobytes()  # noqa: E731
    good = wire.pack(i32(1, 2, 3))
    return [
        ("raw_legacy", "POST", "/compute_raw", i32(1, 2, 3, 4), NE_ADMIN, "bytes"),
        ("raw_msk1", "POST", "/compute_raw", wire.pack(i32(10, 20, 30)), msk, "bytes"),
        ("form_compute", "POST", "/compute", b"value=7", NE_ADMIN, "bytes"),
        ("batch_mixed_widths", "POST", "/compute_batch", b"values=5,-17,300&spread=1",
         NE_ADMIN, "bytes"),
        ("401_missing", "POST", "/compute_raw", i32(1, 2), {}, "bytes"),
        ("401_unknown", "POST", "/compute_raw", i32(1, 2), {"X-Misaka-Key": "who-is-this"},
         "bytes"),
        ("403_disabled", "POST", "/compute_raw", i32(1, 2), {"X-Misaka-Key": "eve-secret"},
         "bytes"),
        ("413_burst", "POST", "/compute_raw", i32(*range(16)), None, "413"),
        ("400_msk1_short", "POST", "/compute_raw", b"short", msk, "bytes"),
        ("400_msk1_truncated", "POST", "/compute_raw", good[:-4], msk, "bytes"),
        ("400_msk1_garbage", "POST", "/compute_raw", b"\xff" * 12, msk, "bytes"),
        ("400_misaligned", "POST", "/compute_raw", b"\x01\x02\x03", NE_ADMIN, "bytes"),
        ("404_program", "POST", "/programs/no-such-prog/compute_raw", i32(1, 2), NE_ADMIN,
         "shape"),
        ("status_401_proxied", "GET", "/status", None, {}, "bytes"),
        ("status_proxied", "GET", "/status", None, NE_ADMIN, "keys"),
    ]


def native_edge_parity(edge_port, engine_port):
    """Each corpus case on the public port (the native edge) and on the
    engine's own port (the CPython route table): the rows, every one equal."""
    rows = []
    for label, method, path, body, headers, how in native_edge_corpus():
        if how == "413":
            want = raw_call(engine_port, method, path, body, {"X-Misaka-Key": "tiny-a-secret"})
            got = raw_call(edge_port, method, path, body, {"X-Misaka-Key": "tiny-b-secret"})
            got = (got[0], got[1], got[2].replace(b"tiny-b", b"tiny-a"))
            expect(want[0] == 413 and b"split the request" in want[2]
                   and "retry-after" not in got[1], f"413 burst: {want} / {got}")
        else:
            want = raw_call(engine_port, method, path, body, headers)
            got = raw_call(edge_port, method, path, body, headers)
        expect(got[1].get("server") == "misaka-native-edge/1" or how in ("shape", "keys")
               or label.endswith("proxied"), f"{label}: not answered by the native edge")
        if how == "shape":
            same = got[0] == want[0] == 404 and all(
                b"cannot route to program 'no-such-prog'" in b for b in (got[2], want[2]))
        elif how == "keys":
            same = got[0] == want[0] == 200 and (json.loads(got[2]).keys()
                                                 == json.loads(want[2]).keys())
        else:
            same = (got[0], got[2]) == (want[0], want[2]) and all(
                got[1].get(h) == want[1].get(h) for h in NE_PARITY_HEADERS)
        expect(same, f"native edge parity {label}: edge {got[0]} {got[2][:120]!r} "
               f"!= engine {want[0]} {want[2][:120]!r}")
        rows.append({"case": label, "status": got[0], "bytes": len(got[2]), "equal": how})
    # every success answer is add2's, not just equal
    from misaka_tpu_torch.utils import wire

    ok = raw_call(edge_port, "POST", "/compute_raw", wire.pack(np.asarray([10, -20], "<i4")
                                                               .tobytes()),
                  {**NE_ADMIN, "Content-Type": wire.CONTENT_TYPE, "Accept": wire.CONTENT_TYPE})
    expect(ok[0] == 200 and np.frombuffer(wire.unpack(ok[2]), "<i4").tolist() == [12, -18],
           f"MSK1 answer {ok}")
    return rows


def native_edge_turn(port, streams, n_clients, per_client, n_quiet, base):
    """One turn of the load on `port`, every answer checked: the MSK1
    /compute_raw streams at once, n_clients x per_client one-value
    /compute, then n_quiet quiet /compute.  Returns the turn's figures."""
    from misaka_tpu_torch.utils import wire

    msk = {**NE_ADMIN, "Content-Type": wire.CONTENT_TYPE, "Accept": wire.CONTENT_TYPE}

    def stream(i):
        c, _, b = raw_call(port, "POST", "/compute_raw", wire.pack(streams[i].tobytes()), msk)
        want = wrap_i32(streams[i].astype(np.int64) + 2)
        if c != 200 or not np.array_equal(np.frombuffer(wire.unpack(b), "<i4"), want):
            raise RuntimeError(f"MSK1 stream {i}: {c} {b[:80]!r}")

    errors, raw_s = run_clients(len(streams), stream)
    expect(not errors, f"MSK1 streams on :{port}: {errors[:4]}")

    def small(i):
        for j in range(per_client):
            v = base + i * 1000 + j
            c, _, b = raw_call(port, "POST", "/compute", f"value={v}".encode(), NE_ADMIN)
            if c != 200 or json.loads(b) != {"value": v + 2}:
                raise RuntimeError(f"/compute {v}: {c} {b!r}")

    errors, small_s = run_clients(n_clients, small)
    expect(not errors, f"small requests on :{port}: {errors[:4]}")
    lat = []
    for v in list(range(-49, 50))[:n_quiet]:
        t = time.perf_counter()
        c, _, b = raw_call(port, "POST", "/compute", f"value={v}".encode(), NE_ADMIN)
        lat.append(time.perf_counter() - t)
        expect(c == 200 and json.loads(b) == {"value": v + 2}, f"quiet /compute {v}: {b!r}")
    values = sum(s.size for s in streams)
    return {"stream_values_per_s": values / raw_s,
            "small_requests_per_s": n_clients * per_client / small_s,
            "quiet_p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "quiet_p90_ms": float(np.percentile(lat, 90)) * 1e3}


def codec_timing(n=1_000_000, reps=3):
    """n int32 values formatted and parsed in this process by the native
    codec and by numpy (MISAKA_NATIVE_CODEC=1, 0): equal bytes and arrays,
    the best of `reps` in ms per million values each way."""
    from misaka_tpu_torch.utils import textcodec

    vals = np.random.default_rng(SEED + 21).integers(
        -(2**31), 2**31, size=n, dtype=np.int64).astype(np.int32)
    saved = os.environ.get("MISAKA_NATIVE_CODEC")
    out, texts = {}, {}
    try:
        for name, knob in (("native", "1"), ("numpy", "0")):
            os.environ["MISAKA_NATIVE_CODEC"] = knob
            fmt, parse = [], []
            for _ in range(reps):
                t = time.perf_counter()
                text = textcodec.ints_to_dec(vals, b",")
                fmt.append(time.perf_counter() - t)
                t = time.perf_counter()
                back = textcodec.dec_to_ints(text)
                parse.append(time.perf_counter() - t)
                expect(np.array_equal(back, vals), f"{name} codec round trip")
            texts[name] = text
            out[name] = {"format_ms_per_million": min(fmt) * 1e9 / n,
                         "parse_ms_per_million": min(parse) * 1e9 / n}
    finally:
        if saved is None:
            os.environ.pop("MISAKA_NATIVE_CODEC", None)
        else:
            os.environ["MISAKA_NATIVE_CODEC"] = saved
    expect(texts["native"] == texts["numpy"], "the native codec's bytes differ from numpy's")
    return {"values": n, "bytes": len(texts["native"]), **out}


def worker_port(label) -> int:
    """The loopback port of the workers behind a native edge (app log)."""
    with open(os.path.join(ROOT, "build", f"chip_smoke_{label}.log")) as f:
        m = re.search(r"frontend workers on :(\d+) \(plane [^)]*\); native edge on :\d+", f.read())
    expect(m is not None, f"{label}: no native edge in the app log")
    return int(m.group(1))


def phase_native_edge(batch=MAIN_BATCH, chunk=MAIN_CHUNK, workers=None, n_streams=32,
                      stream_values=3_125, n_clients=32, per_client=10, n_quiet=49,
                      codec_values=1_000_000, batch_values=100_000, device=None, card=None):
    """The native C++ edge (runtime/frontends.py NativeFrontendSupervisor over
    csrc/native/frontend.cpp) on the public port in front of the card's
    engine: add2 at B, caps 128/128/16, `chunk` ticks, N workers, the
    default MISAKA_NATIVE_EDGE and a key file (the reference's native edge
    test keys: an admin, two vps<4 tenants, a disabled key).

    1. the edge is up: /healthz `native_edge.up` and misaka_native_edge_up 1;
    2. parity: the reference's corpus on the public port and on the
       engine's own port (the CPython route table): status, body and
       content-type/-length, retry-after, www-authenticate equal;
    3. load, every answer checked, on the edge (a) and on the workers of
       the same boot through their loopback port (b), a b b a: n_streams
       concurrent MSK1 /compute_raw streams of stream_values values,
       n_clients x per_client one-value /compute, n_quiet quiet /compute;
       between two paused windows around it the engine's reading:
       misaka_native_edge_plane_frames_total rose, the kernel's launches
       advanced and equal the device loop's iterations;
    4. the codec: codec_values values formatted and parsed in this process
       by the native codec and by numpy (equal bytes, ms per million each
       way), and one batch_values-value /compute_batch through the edge
       (striped: spread=1), its answer checked;
    5. the flip: MasterNode(device) with `auto` serves the fused kernel on
       the card, MasterNode(device="cpu", batch=4) the native tier.

    The edge's threads (default min(8, cores/2)), the workers and the
    engine share the host's cores with this script's clients: the row
    reports the counts.  device="cpu" rehearses it at a small B (the
    engine there is the native tier: no launches)."""
    from misaka_tpu_torch import networks
    from misaka_tpu_torch.core import fused
    from misaka_tpu_torch.networks import ADD2_PROGRAMS
    from misaka_tpu_torch.runtime.master import MasterNode

    workers = workers or frontend_workers()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="native-edge-", dir=os.path.join(ROOT, "build"))
    keys = os.path.join(tmp, "keys.json")
    with open(keys, "w") as f:
        json.dump({"keys": NE_KEYS}, f)
    row = {"phase": "native_edge", "card": card, "workers": workers,
           "cpu_count": os.cpu_count(), "batch": batch, "chunk_steps": chunk, **MAIN_CAPS}
    t0 = time.perf_counter()
    try:
        with served_app("native_edge", ADD2_NODES, ADD2_PROGRAMS, batch, chunk, MAIN_CAPS,
                        device=device, MISAKA_HTTP_WORKERS=str(workers), MISAKA_API_KEYS=keys,
                        MISAKA_PLANE_SOCKET=os.path.join(tmp, "plane.sock")) as (pub, boot_s):
            eng, wport = engine_port("native_edge"), worker_port("native_edge")
            # 1. up: the engine's /healthz block and the series
            deadline = time.monotonic() + 30
            while True:
                hz = json.loads(http(eng, "/healthz")[1])
                if hz.get("native_edge", {}).get("up") and hz["frontends"]["alive"] == workers:
                    break
                expect(time.monotonic() < deadline, f"native edge not up: {hz}")
                time.sleep(0.2)
            expect(series(scrape(eng), "misaka_native_edge_up") == 1, "misaka_native_edge_up")
            row.update(boot_s=boot_s, edge_threads=hz["native_edge"]["threads"])
            # 2. parity
            row["parity"] = native_edge_parity(pub, eng)
            # 3. load, between paused windows
            rng = np.random.default_rng(SEED + 19)
            streams = [rng.integers(-2**31, 2**31, stream_values, dtype=np.int64)
                       .astype(np.int32) for _ in range(n_streams)]

            def window():
                expect(call(eng, "/pause", b"", NE_ADMIN)[0] == 200, "/pause")
                st = json.loads(call(eng, "/status", headers=NE_ADMIN)[2])
                time.sleep(1.1)  # the watcher pumps the edge's counters every 0.5 s
                return st, scrape(eng)

            s0, m0 = window()
            expect(call(eng, "/run", b"", NE_ADMIN)[0] == 200, "/run")
            turns = []
            for i, (tier, port) in enumerate((("edge", pub), ("workers", wport),
                                              ("workers", wport), ("edge", pub))):
                turns.append(dict(tier=tier, **native_edge_turn(
                    port, streams, n_clients, per_client, n_quiet, base=i * 100_000)))
            s1, m1 = window()
            expect(call(eng, "/run", b"", NE_ADMIN)[0] == 200, "/run")

            def moved(name):
                return m1.get(name, 0.0) - m0.get(name, 0.0)

            serve = moved('misaka_device_loop_iterations_total{kind="serve"}')
            idle = moved('misaka_device_loop_iterations_total{kind="idle"}')
            launched = (sum(s1["kernel_launches"].values())
                        - sum(s0["kernel_launches"].values()))
            edge_frames = moved("misaka_native_edge_plane_frames_total")
            expect(edge_frames > 0, "no plane frame from the native edge in the window")
            expect(device == "cpu" or serve + idle == launched > 0,
                   f"iterations {serve} + {idle} != {launched} kernel launches")
            row.update({
                "turns": turns,
                "edge": {k: [t[k] for t in turns if t["tier"] == "edge"] for k in turns[0]
                         if k != "tier"},
                "workers_tier": {k: [t[k] for t in turns if t["tier"] == "workers"]
                                 for k in turns[0] if k != "tier"},
                "stream_values": stream_values, "streams": n_streams,
                "small_requests": n_clients * per_client, "quiet_requests": n_quiet,
                "window": {"iterations_serve": serve, "iterations_idle": idle,
                           "kernel_launches": launched, "edge_plane_frames": edge_frames,
                           "plane_frames": moved("misaka_plane_frames_total"),
                           "edge_requests": moved("misaka_native_edge_requests_total"),
                           "edge_proxied": moved("misaka_native_edge_proxied_total")},
            })
            # 4. the codec: one bulk /compute_batch through the edge
            vals = rng.integers(-2**31, 2**31, batch_values, dtype=np.int64).astype(np.int32)
            t = time.perf_counter()
            c, _, b = raw_call(pub, "POST", "/compute_batch",
                               b"spread=1&values=" + ",".join(map(str, vals.tolist())).encode(),
                               NE_ADMIN)
            bulk_s = time.perf_counter() - t
            expect(c == 200 and np.array_equal(np.asarray(json.loads(b)["values"], np.int64),
                                               wrap_i32(vals.astype(np.int64) + 2)),
                   f"/compute_batch of {batch_values} through the edge: {c}")
            row["compute_batch"] = {"values": batch_values, "seconds": bulk_s}
            hz = json.loads(http(eng, "/healthz")[1])
            row["native_edge_block"] = hz["native_edge"]
            row["kernel_launches"] = json.loads(
                call(eng, "/status", headers=NE_ADMIN)[2])["kernel_launches"].get(
                fused.KERNEL, 0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row["codec"] = codec_timing(codec_values)
    # 5. the flip
    m = MasterNode(networks.add2(), batch=8, device=device or "cuda")
    card_engine = m.engine_name
    m.close()
    m = MasterNode(networks.add2(), batch=4, device="cpu")
    cpu_engine = m.engine_name
    m.run()
    expect(m.compute_many([5, 6]) == [7, 8], "the native-auto CPU master")
    m.close()
    expect(cpu_engine == "native" and (device == "cpu" or card_engine == "fused"),
           f"auto: card {card_engine}, cpu {cpu_engine}")
    row["auto"] = {"card": card_engine, "cpu": cpu_engine}
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    return row


# --- the per-process distributed mode (runtime/nodes.py) ------------------------

# the cross-mode check's shapes (the reference's tests/test_cross_mode.py)
KAHN_CAPS = dict(stack_cap=64, in_cap=32, out_cap=32)
KAHN_INPUTS = 8
KAHN_TICKS = 768
KAHN_CHUNK = 128  # ticks per B=1 serve call: 6 calls cover KAHN_TICKS


def kahn_network(seed):
    """A deterministic (Kahn-style) random network: (node_info, programs,
    outputs per input).  Every inbound port has one sender lane, each stack
    one owner lane, one lane runs IN and one OUT, jumps target forward
    segment boundaries only: any legal interleaving of a free-running
    cluster gives the lockstep engine's output stream (the reference's
    tests/test_cross_mode.py::gen_network, seed for seed)."""
    rng = np.random.default_rng(seed)
    n_lanes = int(rng.integers(1, 5))
    n_stacks = int(rng.integers(0, 3))
    lanes = [f"n{i}" for i in range(n_lanes)]
    stacks = [f"s{i}" for i in range(n_stacks)]
    stack_owner = {s: int(rng.integers(n_lanes)) for s in stacks}

    def imm():
        return int(rng.integers(-50, 50))

    programs = {}
    outs_per_input = 1
    for i, name in enumerate(lanes):
        segments: list[list[str]] = []
        owned = [s for s in stacks if stack_owner[s] == i]
        for _ in range(int(rng.integers(0, 5))):
            kind = int(rng.integers(0, 12))
            if kind <= 3:  # local register op
                segments.append([rng.choice(["NOP", "SWP", "SAV", "NEG", f"ADD {imm()}",
                                             f"SUB {imm()}", f"MOV {imm()}, ACC",
                                             "MOV ACC, NIL"])])
            elif kind <= 5 and owned:  # balanced round trip on an own stack
                s = rng.choice(owned)
                src = rng.choice(["ACC", str(imm())])
                segments.append([f"PUSH {src}, {s}", f"POP {s}, ACC"])
            elif kind <= 7:  # self-send round trip on a private port R1-R3
                port = int(rng.integers(1, 4))
                src = rng.choice(["ACC", str(imm())])
                segments.append([f"MOV {src}, {name}:R{port}", f"MOV R{port}, ACC"])
            elif kind <= 9:  # forward conditional or unconditional jump
                segments.append([rng.choice(["JMP", "JEZ", "JNZ", "JGZ", "JLZ"])])
            else:  # JRO with a static offset: skips its partner or falls through
                segments.append(["JRO 2", "NEG"] if rng.integers(2) else ["JRO 1"])
        lines = ["IN ACC" if i == 0 else "MOV R0, ACC"]
        bound_labels = {}
        for j, seg in enumerate(segments):
            if len(seg) == 1 and seg[0] in ("JMP", "JEZ", "JNZ", "JGZ", "JLZ"):
                tgt = int(rng.integers(j + 1, len(segments) + 1))
                bound_labels.setdefault(tgt, f"b{tgt}")
                segments[j] = [f"{seg[0]} b{tgt}"]
        if i == n_lanes - 1:
            tail = ["OUT ACC"]
            if rng.integers(3) == 0:  # a constant too: 2 outputs per input
                tail.append(f"OUT {imm()}")
                outs_per_input = 2
        else:
            tail = [f"MOV ACC, {lanes[i + 1]}:R0"]
        for j, seg in enumerate(segments):
            if j in bound_labels:
                lines.append(f"{bound_labels[j]}:")
            lines.extend(seg)
        if len(segments) in bound_labels:
            lines.append(f"{bound_labels[len(segments)]}:")
        lines.extend(tail)
        programs[name] = "\n".join(lines)
    node_info = {name: "program" for name in lanes}
    node_info.update({s: "stack" for s in stacks})
    return node_info, programs, outs_per_input


def kahn_inputs(seed, offset=1000):
    """The reference's inputs for a generated network's seed."""
    return np.random.default_rng(offset + seed).integers(-100, 100, size=KAHN_INPUTS).tolist()


def lockstep_outputs(node_info, programs, inputs, device, engine="auto"):
    """The lockstep side of the cross-mode check: the network unbatched
    through `CompiledNetwork.serve_chunk` (engine="auto": on the card each
    128-tick call is one launch of the fused kernel on the batch-of-one
    view, on the CPU the plain loop; "scan" the plain loop anywhere), every
    input fed in the first call, KAHN_TICKS ticks in all; the outputs in
    order."""
    from misaka_tpu_torch.runtime.topology import Topology

    net = Topology(node_info=node_info, programs=programs, **KAHN_CAPS).compile(device=device)
    state = net.init_state()
    feed = np.zeros(net.in_cap, np.int32)
    feed[:len(inputs)] = inputs
    count, outs = len(inputs), []
    for _ in range(KAHN_TICKS // KAHN_CHUNK):
        state, packed = net.serve_chunk(state, feed, count, KAHN_CHUNK, engine=engine)
        count = 0
        p = packed.cpu().numpy()
        outs.extend(int(p[4 + i % net.out_cap]) for i in range(int(p[2]), int(p[3])))
    return outs


def cluster_stream(master, inputs, expect_n, timeout=30.0):
    """The free-running side: stream `inputs` into a running distributed
    master's input queue (the GetInput side, master.go:233-242) and wait
    for `expect_n` outputs, in order.  `master` is either package's
    MasterNodeProcess."""
    with master._io_cond:
        master._in_q.extend(int(v) for v in inputs)
        master._io_cond.notify_all()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with master._io_cond:
            if len(master._out_q) >= expect_n:
                return list(master._out_q)[:expect_n]
        time.sleep(0.01)
    with master._io_cond:
        got = list(master._out_q)
    raise AssertionError(f"cluster produced {len(got)}/{expect_n} outputs in {timeout} s: {got}")


def cluster_outputs(node_info, programs, inputs, expect_n, timeout=30.0):
    """`inputs` through the port's nodes on loopback ports in this process
    (runtime/nodes.py::build_loopback_cluster), closed after."""
    from misaka_tpu_torch.runtime.nodes import build_loopback_cluster

    master, close = build_loopback_cluster(node_info, programs)
    try:
        master.run()
        return cluster_stream(master, inputs, expect_n, timeout)
    finally:
        close()


def grpc_versions() -> dict | None:
    """{"grpcio": v, "protobuf": v} where both import, else None."""
    try:
        import google.protobuf
        import grpc
    except ImportError:
        return None
    return {"grpcio": grpc.__version__, "protobuf": google.protobuf.__version__}


def smi_compute_apps() -> list[str]:
    """nvidia-smi's compute-app rows (pid per CUDA context; the pid reads
    1 where the card's processes sit outside this pid namespace)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return [line.strip() for line in out.strip().splitlines() if line.strip()]


DIST_MISAKA1 = "IN ACC\nADD 1\nMOV ACC, misaka2:R0\nMOV R0, ACC\nOUT ACC"
DIST_MISAKA2 = "MOV R0, ACC\nADD 1\nPUSH ACC, misaka3\nPOP misaka3, ACC\nMOV ACC, misaka1:R0"


def start_distributed(label="dist"):
    """The reference's add2 network (docker-compose.yml: a distributed
    master, program nodes misaka1 and misaka2, stack misaka3) as four
    `python -m misaka_tpu_torch.runtime.app` processes on free loopback
    ports, started together: ([Popen], HTTP port, t_boot)."""
    names = ("last_order", "misaka1", "misaka2", "misaka3")
    grpc_ports = {n: free_port() for n in names}
    http_port = free_port()
    base = {k: v for k, v in os.environ.items() if not k.startswith("MISAKA_")}
    base.update(NODE_ADDRS=json.dumps({n: f"127.0.0.1:{p}" for n, p in grpc_ports.items()}),
                PYTHONPATH=ROOT + os.pathsep + base.get("PYTHONPATH", ""))
    envs = {
        "last_order": dict(MISAKA_MODE="distributed", NODE_INFO=json.dumps(ADD2_NODES),
                           MISAKA_PORT=str(http_port)),
        "misaka1": dict(NODE_TYPE="program", PROGRAM=DIST_MISAKA1),
        "misaka2": dict(NODE_TYPE="program", PROGRAM=DIST_MISAKA2),
        "misaka3": dict(NODE_TYPE="stack"),
    }
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    procs, t_boot = {}, time.perf_counter()
    try:
        for n in names:
            with open(os.path.join(ROOT, "build", f"chip_smoke_{label}_{n}.log"), "w") as log:
                procs[n] = subprocess.Popen(
                    [sys.executable, "-m", "misaka_tpu_torch.runtime.app"], cwd=ROOT,
                    env={**base, **envs[n], "MISAKA_GRPC_PORT": str(grpc_ports[n])},
                    stdout=log, stderr=subprocess.STDOUT)
    except BaseException:
        for p in procs.values():
            _stop_app(p)
        raise
    return list(procs.values()), http_port, t_boot


def phase_distributed(card=None, n_quiet=49, n_raw=250, seeds=(0, 1, 2, 3), device="cuda"):
    """The per-process distributed mode.  Where grpcio and protobuf import:
    the reference's add2 network as four processes (start_distributed),
    driven over HTTP: /run, /compute for 5, -3, 1000 and 0, one value past
    int32 (the sint32 wire truncates it, as the JAX package's distributed
    master answers), n_quiet quiet /compute (p50, p90), a striped
    /compute_raw of n_raw values (values/s), /pause, /reset, /load and a
    bad /load (400), every answer checked; nvidia-smi lists no CUDA context
    of the four (none of their pids, and no row more than before they
    booted).  Then the cross-mode check: Kahn networks of `seeds` through a
    loopback cluster of the port's nodes in this process and unbatched
    through the fused kernel on the card (lockstep_outputs; the launch
    counts zeroed just before and read just after), each output stream
    identical, the kernel's also to the plain loop's on the CPU.  Where
    they do not import: the app's boot in process with NODE_TYPE=program
    and with MISAKA_MODE=distributed must exit naming the missing package.
    device="cpu" rehearses it without a card (the plain loop on both
    sides, no nvidia-smi)."""
    from misaka_tpu_torch.core import fused
    from misaka_tpu_torch.runtime import app

    versions = grpc_versions()
    if versions is None:
        refusals = {}
        for env in ({"NODE_TYPE": "program"}, {"MISAKA_MODE": "distributed"}):
            try:
                app.check_env(env)
            except SystemExit as e:
                refusals[next(iter(env.items()))[1]] = str(e)
        expect(len(refusals) == 2 and all(
            ("grpcio" in msg or "protobuf" in msg) and "lacks" in msg
            for msg in refusals.values()), f"distributed boots did not refuse: {refusals}")
        row = {"phase": "distributed", "card": card, "mode": "refused",
               "host": "the card's host lacks grpcio or protobuf", "refusals": refusals}
        emit(row)
        return row

    on_card = device != "cpu"
    pre = take_prebooted("distributed")
    procs, port, t_boot = pre[1:4] if pre is not None else start_distributed()
    # the CUDA contexts of this script now: its own and one per server of a
    # later phase booted ahead (each holds one once it answers)
    contexts = 1
    for *_, box in list(PREBOOTED.values()):
        poll(lambda box=box: "ready" in box, "a server booted ahead answers", 120)
        contexts += 1
    smi_before = smi_compute_apps() if on_card else []
    try:
        deadline = time.monotonic() + 120
        while True:  # the master answers, then /run reaches every peer
            for p in procs:
                expect(p.poll() is None, f"distributed node exited early (rc {p.returncode})")
            try:
                if post_form(port, "/run") == (200, b"Success"):
                    break
            except (OSError, HTTPException):  # not up yet, or a peer not yet (400)
                pass
            expect(time.monotonic() < deadline, "the distributed network did not run in 120 s")
            time.sleep(0.25)
        ready = pre[4].get("ready") if pre is not None else None
        boot_s = (ready or time.perf_counter()) - t_boot
        health = json.loads(http(port, "/healthz", timeout=60)[1])
        expect(health["engine"] == "distributed-grpc" and health["running"], f"/healthz {health}")
        for v in (5, -3, 1000, 0, 2**31 + 5):
            code, body = post_form(port, "/compute", value=str(v))
            want = int(wrap_i32(int(wrap_i32(v)) + 2))
            expect(code == 200 and json.loads(body) == {"value": want},
                   f"distributed /compute {v} -> {code} {body!r}")
        lat = []
        for v in list(range(-24, 25))[:n_quiet]:
            t = time.perf_counter()
            code, body = post_form(port, "/compute", value=str(v))
            lat.append(time.perf_counter() - t)
            expect(code == 200 and json.loads(body) == {"value": v + 2},
                   f"distributed /compute {v} -> {code} {body!r}")
        vals = np.random.default_rng(SEED + 16).integers(
            -(2**31), 2**31, size=n_raw, dtype=np.int64).astype(np.int32)
        raw_s = check_raw(port, vals)
        expect(post_form(port, "/pause") == (200, b"Success"), "/pause")
        expect(post_form(port, "/reset") == (200, b"Success"), "/reset")
        add10 = DIST_MISAKA2.replace("ADD 1", "ADD 10")
        expect(post_form(port, "/load", targetURI="misaka2", program=add10) == (200, b"Success"),
               "/load")
        expect(post_form(port, "/run") == (200, b"Success"), "/run after /load")
        code, body = post_form(port, "/compute", value="1")
        expect(json.loads(body) == {"value": 12}, f"after /load: {body!r}")
        try:
            code, body = post_form(port, "/load", targetURI="misaka2", program="FROB 3")
        except urllib.error.HTTPError as e:
            code, body = e.code, e.read()
        expect(code == 400 and b"not a valid instruction" in body, f"bad /load {code} {body!r}")
        st = status(port)
        expect(st["served_engine"] == "distributed-grpc" and "device_memory" not in st,
               f"/status {st}")
        smi_after = smi_compute_apps() if on_card else []
        pids = {str(p.pid) for p in procs}
        expect(not on_card or (not pids & set(smi_after)
                               and len(smi_before) == len(smi_after) == contexts),
               f"a node holds a CUDA context: {smi_before} -> {smi_after} rows, where this "
               f"script and its servers hold {contexts} (node pids {sorted(pids)})")
    finally:
        for p in procs:
            _stop_app(p)

    # the cross-mode check: the free-running cluster against the kernel
    cases, t_cross, launches = [], time.perf_counter(), {}
    for seed in seeds:
        node_info, programs, per_input = kahn_network(seed)
        inputs = kahn_inputs(seed)
        for k in fused.launch_counts:
            fused.launch_counts[k] = 0
        got = lockstep_outputs(node_info, programs, inputs, device)
        for k, n in fused.launch_counts.items():
            launches[k] = launches.get(k, 0) + n
        plain = lockstep_outputs(node_info, programs, inputs, "cpu")
        expect(len(got) == KAHN_INPUTS * per_input, f"seed {seed}: the engine emitted {got}")
        cluster = cluster_outputs(node_info, programs, inputs, len(got))
        expect(got == plain == cluster,
               f"seed {seed}: kernel {got}, plain {plain}, cluster {cluster}")
        cases.append({"seed": seed, "lanes": sum(k == "program" for k in node_info.values()),
                      "stacks": sum(k == "stack" for k in node_info.values()),
                      "outputs": len(got)})
    expect(not on_card or (launches.get(fused.KERNEL, 0) > 0 and all(
        n == 0 for k, n in launches.items() if k != fused.KERNEL)),
        f"cross-mode launches {launches}")
    steady = np.sort(np.asarray(lat))
    row = {"phase": "distributed", "card": card, "mode": "four processes", **versions,
           "boot_s": boot_s, "compute_latency_p50_ms": float(np.percentile(steady, 50)) * 1e3,
           "compute_latency_p90_ms": float(np.percentile(steady, 90)) * 1e3,
           "quiet_requests": len(lat), "compute_raw_values": int(vals.size),
           "compute_raw_s": raw_s, "values_per_s": vals.size / raw_s,
           "smi_compute_apps_before": smi_before, "smi_compute_apps_after": smi_after,
           "cross_mode": cases, "cross_mode_s": time.perf_counter() - t_cross,
           "kernel_launches": launches.get(fused.KERNEL, 0)}
    emit(row)
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from misaka_tpu_torch.core import fused
    from misaka_tpu_torch.csrc import build

    t_all = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    emit({"phase": "device", "name": name, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    split = {}  # seconds per phase

    def timed(phase, fn, *args, **kw):
        t = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            split[phase] = time.perf_counter() - t
            print(json.dumps({"split": phase, "seconds": split[phase]}), flush=True)

    # the native tier's host builds run on threads beside nvcc
    start_native_builds()
    t = time.perf_counter()
    build.build(fused.KERNEL)
    split["build"] = time.perf_counter() - t
    emit({"phase": "build", "kernel": fused.KERNEL, "seconds": split["build"],
          "ptxas": ptxas_summary(build.ptxas_report(fused.KERNEL))})

    # The servers of the phases from main_path to frontends boot now, two
    # at a time, paused, while the card works on the parity phases (each
    # ~10 s of boot that no longer waits in its phase); each runs at its
    # phase's start.
    ahead = [main_path_spec(), autogrow_spec(), elided_spec(),
             main_path_spec(data_parallel=count), *unbatched_specs(), *traced_specs()[1],
             *observability_specs(), obs_unbatched_spec()]
    if grpc_versions():  # the distributed phase's four processes (no card)
        ahead.append(("distributed", start_distributed))
    preboot(ahead + [frontends_spec()])

    # depth cut to make room for the native and native_edge phases (every
    # case kept, their exactness resolved by earlier runs at the deeper
    # settings): the baselines' and pipelines' parity and the elided parity
    # at 64 ticks (was 256), the unbatched long chunk 256 ticks (was 2048)
    max_err = timed("parity", phase_parity, ticks=64)
    max_err_elided = timed("elided_parity", phase_elided_parity, ticks=64)
    max_err_dp, dp_rows = timed("dp_parity", phase_dp_parity)
    max_err_unbatched = timed("unbatched_parity", phase_unbatched_parity, chunks=(128, 256))

    # Each served phase runs in a fresh server process, whose launch counts
    # start at 0 when it boots (a prebooted one stays paused, launching
    # nothing, until its phase runs it); the counts are read from its
    # /status at the end of the phase.  The in-process two-shard phase zeroes this
    # process's counts just before it and reads them just after.
    for k in fused.launch_counts:
        fused.launch_counts[k] = 0
    # depth cut: the main and data-parallel lanes' streams 25,000 values
    # (was 100,000; the pinned stream 196 chunks, was 782)
    main_row = timed("main_path", phase_main_path, n_raw=25_000)
    grow_row = timed("autogrow", phase_autogrow)
    elided_row = timed("elided_path", phase_elided_path)
    dp_row = timed("dp_path", phase_main_path, data_parallel=count, n_raw=25_000)
    two_row = timed("two_shards", phase_two_shards)
    unbatched_row = timed("unbatched_path", phase_unbatched_path)
    timed("traced", phase_traced)
    # depth cut to make room for the native and native_edge phases (every
    # check kept; these figures were resolved by earlier runs):
    # observability and frontends 32 x 10 requests (was 32 x 40), frontends
    # 49 quiet (was 99); the edge's flood 3 s (was 5); the registry's stream
    # 10,000 values (was 20,000); telemetry 32 x 3,125 raw values (was
    # 12,500), 8 capture clients (was 32), 10 delay requests (was 40), 25
    # B=1 requests (was 100); observatory 4 stream clients (was 8); fleet
    # 32 x 10 requests and 4 quiet a cost turn (was 32 x 20 and 8);
    # model_parallel 25,000 served values (was 100,000)
    obs_row = timed("observability", phase_observability, card=smi, per_client=10)
    obs_unbatched_row = timed("unbatched_observability", phase_unbatched_observability,
                              card=smi)
    # the per-process nodes, when no other server of this script is up (its
    # nvidia-smi check counts the card's contexts before and after)
    dist_row = timed("distributed", phase_distributed, card=smi)
    fe_row = timed("frontends", phase_frontends, card=smi, zero_workers=obs_row, per_client=10,
                   n_quiet=49)
    edge_row = timed("edge", phase_edge, card=smi, flood_s=3.0)
    registry_row = timed("registry", phase_registry, card=smi, n_stream=10_000)
    telemetry_row = timed("telemetry", phase_telemetry, card=smi, raw_values=3_125,
                          capture_clients=8, n_delay=10, n_b1=25)
    observatory_row = timed("observatory", phase_observatory, card=smi, stream_clients=4)
    fleet_row = timed("fleet", phase_fleet, card=smi, per_client=10, n_quiet=4)
    timed("model_parallel", phase_model_parallel, card=smi, n_values=25_000)
    # the host tier, while no other server of this script is up
    timed("native", phase_native, card=smi, unbatched_row=unbatched_row)
    # the native edge in front of the card's engine (after `native`, whose
    # first check is that no native engine was built before it)
    ne_row = timed("native_edge", phase_native_edge, card=smi)
    emit({"phase": "dp_plumbing", "card": smi, "data_parallel": count,
          **{f"{k}_{lane}": row[k] for lane, row in (("lane", main_row), ("dp", dp_row))
             for k in ("compute_latency_p50_s", "compute_raw_striped_values_per_s",
                       "served_values_per_s", "small_requests_per_s")}})

    timing = timed("timings", phase_timings, smi,
                   next(r for r in dp_rows if r["case"] == "add2/2x1card"))
    full, elided, big, dp = timing["full"], timing["elided"], timing["cap1024"], timing["dp"]
    one = timed("unbatched_timings", phase_unbatched_timings, smi)["chunks"][128]
    emit({"kernels": [
        {
            "name": fused.KERNEL, "route": "cuda",
            "source": "misaka_tpu_torch/csrc/fused_superstep.cu",
            "replaces": "misaka_tpu/core/fused.py:80",
            "launches": main_row["kernel_launches"][fused.KERNEL]
            + grow_row["kernel_launches"][fused.KERNEL] + edge_row["kernel_launches"]
            + registry_row["kernel_launches"] + telemetry_row["kernel_launches"]
            + observatory_row["kernel_launches"] + fleet_row["fleet_launches"]
            + ne_row["kernel_launches"] + dist_row.get("kernel_launches", 0),
            "max_abs_err": max(max_err, full["max_abs_err"], big["max_abs_err"],
                               grow_row["parity_max_abs_err"]),
            "ms": full["ms"], "plain_ms": full["plain_ms"],
            "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
            "library_ms": None, "exact": True,
            "big_capacity": {"caps": 1024, "ms": big["ms"], "plain_ms": big["plain_ms"],
                             "bound_ms": big["bound_ms"], "bound_by": big["bound_by"]},
            # launches between two paused readings of the observability phase
            "observability_window_launches": obs_row["kernel_launches"],
            # the same behind the frontend workers (the frontends phase)
            "frontends_window_launches": fe_row["kernel_launches"],
            # the edge phase's servers (counted in `launches` above)
            "edge_launches": edge_row["kernel_launches"],
            # the registry phase's servers, every engine of each, and its
            # in-process registry (counted in `launches` above)
            "registry_launches": registry_row["kernel_launches"],
            # the telemetry phase's servers (every engine of each) and its
            # in-process registry (counted in `launches` above); the replay
            # subprocesses' shadows launch in processes of their own
            "telemetry_launches": telemetry_row["kernel_launches"],
            # the observatory phase's servers (the killed one read before
            # the kill) and its in-process rotation engine
            "observatory_launches": observatory_row["kernel_launches"],
            # the fleet phase's engines: its replicas read before the kill,
            # the peer, the replica_kill fleet's replicas and the cost's
            # single engine
            "fleet_launches": fleet_row["fleet_launches"],
            # the native_edge phase's server, behind the C++ edge
            "native_edge_launches": ne_row["kernel_launches"],
            # the distributed phase's cross-mode check, B=1 in this process
            # (none where the host lacks grpcio: the phase then only refuses)
            "distributed_launches": dist_row.get("kernel_launches", 0),
            # B=1, 128 ticks: the unbatched lane's chunk (launches from its server)
            "unbatched": {"launches": unbatched_row["kernel_launches"][fused.KERNEL],
                          "observability_profile_iterations":
                          obs_unbatched_row["profile"]["iterations"],
                          "ms": one["ms"], "plain_ms": one["plain_ms"],
                          "max_abs_err": max(max_err_unbatched, one["max_abs_err"]),
                          "bound_ms": one["bound_ms"], "bound_by": one["bound_by"],
                          "ticks": 128, "caps": 1024},
        },
        {
            "name": fused.KERNEL_ELIDE, "route": "cuda",
            "source": "misaka_tpu_torch/csrc/fused_superstep.cu",
            "replaces": "misaka_tpu/core/fused.py:100",
            "launches": elided_row["kernel_launches"][fused.KERNEL_ELIDE],
            "max_abs_err": max(max_err_elided, elided["max_abs_err"]),
            "ms": elided["ms"], "plain_ms": elided["plain_ms"],
            "bound_ms": elided["bound_ms"], "bound_by": elided["bound_by"],
            "library_ms": None, "exact": True,
        },
        {
            "name": fused.KERNEL_DP, "route": "cuda",
            "source": "misaka_tpu_torch/csrc/fused_superstep.cu",
            "wrapper": "misaka_tpu_torch/parallel/mesh.py",
            "replaces": "misaka_tpu/runtime/master.py:1438",
            "launches": dp_row["kernel_launches"][fused.KERNEL_DP]
            + two_row["kernel_launches"][fused.KERNEL_DP],
            "max_abs_err": max(max_err_dp, dp["max_abs_err"]),
            "ms": dp["ms"], "plain_ms": dp["plain_ms"],
            "bound_ms": dp["bound_ms"], "bound_by": dp["bound_by"],
            "library_ms": None, "exact": True, "variant": dp["variant"],
            "shards": dp["shards"], "cards": dp["cards"],
            "whole_batch_ms": dp["whole_batch_ms"],
        },
    ]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_all, "split": split})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mp-worker"]:
        # one process of phase_model_parallel's two-process drill
        port_, rank_, out_, batch_, ticks_, device_ = sys.argv[2:8]
        mp_worker(int(port_), int(rank_), out_, int(batch_), int(ticks_), device_)
        sys.exit(0)
    sys.exit(main())
