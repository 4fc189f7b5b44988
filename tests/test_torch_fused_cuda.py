"""The fused CUDA kernel against its plain torch version, on the card.

Every test needs an NVIDIA GPU and nvcc; without a card each one skips
(decided inside the test).  Run on the card from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_cuda.py

Tolerance: exact equality of every NetworkState field (all integers).  The
cases reuse chip_smoke.py's helpers: the five BASELINE_CONFIGS at caps 8
and 1024, 16- and 32-stage pipelines and random networks of 9-32 lanes
(the kernel's widest builds), deep-stack push at stack_cap 128, and random
networks over every opcode.

The elided variant (elide_dead_hi) is held to its contract from states with
random hi planes: every field exact, except acc_hi/bak_hi of hi-dead lanes,
which must keep their entry values; on the baselines, overflow64 and
running_total, and random networks that mix hi-live and hi-dead lanes.

The unbatched lane: B=1 `serve_chunk` through the kernel against the plain
loop (chip_smoke.compare_unbatched), also under MISAKA_FUSED_ELIDE_HI=1,
where it must stay the full kernel; the traced loop on the card against
the CPU; an unbatched master's launches, one per iteration.

The observability hooks on the card: the device-loop chunk histogram
counts one observation per kernel launch (batched and unbatched), and a
profile taken through /profile/start|stop holds the kernel's CUDA events
and the device loop's CPU ops.

Model parallel on a mesh that repeats the card: both lane-sharded runners,
graphed and eager, and the compact and chained one-device steps, against
the kernel.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from misaka_tpu_torch import networks
from misaka_tpu_torch.core import fused
from misaka_tpu_torch.runtime.topology import Topology

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def check(row):
    assert row["exact"], row


@pytest.mark.parametrize("cap", [8, 1024])
@pytest.mark.parametrize("name", sorted(networks.BASELINE_CONFIGS))
def test_kernel_matches_plain_on_baselines(card, name, cap):
    net = networks.BASELINE_CONFIGS[name](in_cap=cap, out_cap=cap, stack_cap=cap).compile(
        batch=1024, device=card)
    state = chip_smoke.seeded_inputs(net, np.random.default_rng(cap), 6)
    check(chip_smoke.compare(name, net, state, 200))


@pytest.mark.parametrize("seed", range(16))
def test_kernel_matches_plain_on_random_networks(card, seed):
    net = chip_smoke.random_topology(seed, Topology).compile(batch=512, device=card)
    state = chip_smoke.seeded_inputs(net, np.random.default_rng(seed), 6, -100, 100)
    check(chip_smoke.compare(f"random/{seed}", net, state, 96))


@pytest.mark.parametrize("n", [16, 32])
def test_kernel_matches_plain_on_wide_pipelines(card, n):
    net = networks.pipeline(n, in_cap=8, out_cap=8, stack_cap=8).compile(batch=1024, device=card)
    state = chip_smoke.seeded_inputs(net, np.random.default_rng(n), 6)
    row = chip_smoke.compare(f"pipeline{n}", net, state, 3 * n + 40)
    check(row)
    assert row["out_wr_min"] > 0


@pytest.mark.parametrize("seed", range(100, 106))
def test_kernel_matches_plain_on_wide_random_networks(card, seed):
    net = chip_smoke.random_topology(seed, Topology, lanes=(9, 33)).compile(
        batch=512, device=card)
    state = chip_smoke.seeded_inputs(net, np.random.default_rng(seed), 6, -100, 100)
    check(chip_smoke.compare(f"random_wide/{seed}", net, state, 96))


def test_kernel_deep_stack_push(card):
    net = Topology(node_info={"p": "program", "st": "stack"},
                   programs={"p": "IN ACC\nPUSH ACC, st\n"},
                   in_cap=104, out_cap=8, stack_cap=128).compile(batch=256, device=card)
    state = chip_smoke.seeded_inputs(net, np.random.default_rng(1), 100)
    check(chip_smoke.compare("push", net, state, 310))
    assert (net.fused_runner(310)(state).stack_top == 100).all()


def test_serve_pair_through_kernel_matches_plain(card):
    net = networks.mesh8(in_cap=8, out_cap=8, stack_cap=8).compile(batch=256, device=card)
    k_serve, _ = net.make_batched_serve(net.fused_runner(64), 64)
    p_serve, _ = net.make_batched_serve(lambda s: net.run(s, 64), 64)
    rng = np.random.default_rng(2)
    ks = ps = net.init_state()
    for _ in range(4):
        vals = rng.integers(-50, 50, size=(256, 8)).astype(np.int32)
        counts = rng.integers(0, 3, size=256).astype(np.int32)
        ks, kp = k_serve(ks, vals, counts)
        ps, pp = p_serve(ps, vals, counts)
        assert torch.equal(kp, pp)


def test_launches_are_counted_and_bad_inputs_refused(card):
    net = networks.add2(in_cap=8, out_cap=8, stack_cap=8).compile(batch=128, device=card)
    before = fused.launch_counts[fused.KERNEL]
    net.fused_runner(16)(net.init_state())
    assert fused.launch_counts[fused.KERNEL] == before + 1
    bad = net.init_state()._replace(acc=torch.zeros((128, 2), dtype=torch.int64, device=card))
    with pytest.raises(ValueError, match="state.acc"):
        net.fused_runner(16)(bad)
    assert fused.launch_counts[fused.KERNEL] == before + 1


EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def elided_case(label, net, seed, steps=128):
    rng = np.random.default_rng(seed)
    state = chip_smoke.with_random_hi(
        chip_smoke.seeded_inputs(net, rng, 6, -(2**31), 2**31), rng)
    return chip_smoke.compare(label, net, state, steps, elide=True)


@pytest.mark.parametrize("cap", [8, 1024])
@pytest.mark.parametrize("name", sorted(networks.BASELINE_CONFIGS))
def test_elided_kernel_matches_plain_on_baselines(card, name, cap):
    net = networks.BASELINE_CONFIGS[name](in_cap=cap, out_cap=cap, stack_cap=cap).compile(
        batch=1024, device=card)
    row = elided_case(name, net, cap)
    check(row)
    if name in ("add2", "ring4"):
        assert row["dead_lanes"] == row["lanes"]  # the all-dead instantiation


@pytest.mark.parametrize("example", ["overflow64", "running_total"])
def test_elided_kernel_matches_plain_on_examples(card, example):
    with open(os.path.join(EXAMPLES, f"{example}.json")) as f:
        text = f.read()
    net = Topology.from_json(text, in_cap=8, out_cap=8, stack_cap=8).compile(
        batch=1024, device=card)
    check(elided_case(example, net, 3))


def test_elided_kernel_matches_plain_on_mixed_random_networks(card):
    for seed in chip_smoke.mixed_seeds(Topology, fused, 8):
        net = chip_smoke.random_topology(seed, Topology, lanes=(2, 9)).compile(
            batch=512, device=card)
        row = elided_case(f"random_mixed/{seed}", net, seed, 96)
        assert 0 < row["dead_lanes"] < row["lanes"]
        check(row)


def test_elided_launches_counted_under_their_own_key(card):
    net = networks.add2(in_cap=8, out_cap=8, stack_cap=8).compile(batch=128, device=card)
    before = dict(fused.launch_counts)
    net.fused_runner(16, elide_dead_hi=True)(net.init_state())
    assert fused.launch_counts[fused.KERNEL_ELIDE] == before[fused.KERNEL_ELIDE] + 1
    assert fused.launch_counts[fused.KERNEL] == before[fused.KERNEL]
    records = fused.line_records(net.code, net.prog_len, net.num_stacks, net.device)
    with pytest.raises(ValueError, match="hi_live mask"):
        fused.fused_superstep(net._code_t, net._len_t, net.init_state(), 4, hi_live=1 << 5,
                              records=records)
    with pytest.raises(ValueError, match="line records"):
        fused.fused_superstep(net._code_t, net._len_t, net.init_state(), 4, records=None)


def test_elided_call_on_an_all_live_network_counts_as_the_full_kernel(card):
    """overflow64's lanes are all hi-live: the elided call's mask covers
    every lane, the C entry runs the full kernel, and the launch is counted
    under the full kernel's key."""
    with open(os.path.join(EXAMPLES, "overflow64.json")) as f:
        net = Topology.from_json(f.read(), in_cap=8, out_cap=8, stack_cap=8).compile(
            batch=128, device=card)
    before = dict(fused.launch_counts)
    net.fused_runner(16, elide_dead_hi=True)(net.init_state())
    assert fused.launch_counts[fused.KERNEL] == before[fused.KERNEL] + 1
    assert fused.launch_counts[fused.KERNEL_ELIDE] == before[fused.KERNEL_ELIDE]


# --- the data-parallel runner (misaka_tpu/runtime/master.py:1438's port) --------


def dp_layouts():
    """Two shards on one card, and one shard per card when there are two
    or more (decided inside the test)."""
    n = torch.cuda.device_count()
    return [["cuda:0"] * 2] + ([[f"cuda:{i}" for i in range(n)]] if n >= 2 else [])


def dp_network(name):
    if name == "add2":
        return networks.add2(in_cap=8, out_cap=8, stack_cap=8)
    if name == "reverse_any":
        with open(os.path.join(EXAMPLES, "reverse_any.json")) as f:
            return Topology.from_json(f.read(), in_cap=8, out_cap=8, stack_cap=4)
    seed = chip_smoke.mixed_seeds(Topology, fused, 1)[0]
    return chip_smoke.random_topology(seed, Topology, lanes=(2, 9))


@pytest.mark.parametrize("name", ["add2", "reverse_any", "mixed"])
def test_dp_runner_matches_plain_and_the_whole_batch_launch(card, name):
    """Gathered shards equal the plain version per shard and one launch over
    the whole batch, every field; the input state and its shards stay
    untouched; one launch per shard under fused_superstep_dp."""
    net = dp_network(name).compile(batch=1024, device=card)
    rng = np.random.default_rng(7)
    state = chip_smoke.with_random_hi(chip_smoke.seeded_inputs(net, rng, 8, -100, 100), rng)
    for devices in dp_layouts():
        check(chip_smoke.compare_dp(name, net, state, 96, devices))


def test_dp_runner_elided_variant(card):
    net = networks.add2(in_cap=8, out_cap=8, stack_cap=8).compile(batch=1024, device=card)
    rng = np.random.default_rng(9)
    state = chip_smoke.with_random_hi(chip_smoke.seeded_inputs(net, rng, 6, -(2**31), 2**31), rng)
    for devices in dp_layouts():
        row = chip_smoke.compare_dp("add2/elided", net, state, 128, devices, elide=True)
        check(row)
        assert row["variant"] == fused.KERNEL_ELIDE and row["dead_lanes"] == 2


def test_dp_launches_count_shards_under_their_own_key(card):
    from misaka_tpu_torch.parallel.mesh import ShardedNetwork, make_mesh, shard_state

    net = networks.add2(in_cap=8, out_cap=8, stack_cap=8).compile(batch=256, device=card)
    mesh = make_mesh(2, ["cuda:0", "cuda:0"])
    run = ShardedNetwork(net, mesh).fused_runner(16, elide_dead_hi=True)
    before = dict(fused.launch_counts)
    run(shard_state(net.init_state(), mesh))
    assert fused.launch_counts[fused.KERNEL_DP] == before[fused.KERNEL_DP] + 2
    for key in (fused.KERNEL, fused.KERNEL_ELIDE):
        assert fused.launch_counts[key] == before[key]
    assert run.variant == fused.KERNEL_ELIDE


def test_two_shards_on_one_card_serve(card):
    from misaka_tpu_torch.runtime.master import MasterNode

    m = MasterNode(networks.add2(in_cap=8, out_cap=8, stack_cap=8), chunk_steps=64,
                   batch=256, device=["cuda:0", "cuda:0"], data_parallel=2)
    m.run()
    try:
        vals = np.arange(-3000, 3000, dtype=np.int32)
        assert np.array_equal(m.compute_spread(vals, timeout=120, return_array=True), vals + 2)
        assert m.compute_coalesced([5], timeout=120) == [7]
        st = m.status()
        assert st["mesh"] == {"data": 2, "model": 1} and st["engine"] == "fused"
    finally:
        m.close()


# --- the wrapper contract of the redesigned kernel --------------------------------


def test_ring_counters_near_the_rebase_threshold_match_plain(card):
    """Counters just below 2^30 before the chunk: the kernel's own rebase
    gives plain_run's rebased in_rd/in_wr/out_rd/out_wr (and every other
    field)."""
    from misaka_tpu_torch.core.state import REBASE_THRESHOLD

    net = networks.add2(in_cap=6, out_cap=5, stack_cap=4).compile(batch=512, device=card)
    rng = np.random.default_rng(11)
    state = chip_smoke.seeded_inputs(net, rng, 6)
    base = torch.full_like(state.in_rd, REBASE_THRESHOLD - 3) + torch.from_numpy(
        rng.integers(0, 3, size=512).astype(np.int32)).to(card)
    state = state._replace(in_rd=base, in_wr=base + 6, out_rd=base + 4, out_wr=base + 4)
    row = chip_smoke.compare("add2/near_rebase", net, state, 200)
    check(row)
    out = net.fused_runner(200)(state)
    assert (out.in_rd <= REBASE_THRESHOLD).all() and (out.out_rd <= REBASE_THRESHOLD).all()
    assert not torch.equal(out.out_rd, state.out_rd)  # the out ring was rebased too


def test_in_buf_passes_through_and_the_input_state_is_untouched(card):
    from misaka_tpu_torch.core.state import clone_state

    net = networks.mesh8(in_cap=8, out_cap=8, stack_cap=8).compile(batch=256, device=card)
    state = chip_smoke.seeded_inputs(net, np.random.default_rng(5), 6)
    before = clone_state(state)
    out = net.fused_runner(64)(state)
    assert out.in_buf is state.in_buf
    for f in state._fields:
        assert torch.equal(getattr(state, f), getattr(before, f)), f
        if f != "in_buf":
            assert getattr(out, f).data_ptr() != getattr(state, f).data_ptr(), f


@pytest.mark.parametrize("hi_mode", [fused.HI_FULL, fused.HI_MASK, fused.HI_DEAD])
def test_occupancy_is_at_least_one_block_per_sm(card, hi_mode):
    """Every lane bound and hi mode, with small tables and with 128 KB of
    line records, past the default 48 KB of shared memory, which the
    occupancy counts as the launch does."""
    for n_lanes in (1, 2, 3, 4, 8, 16, 32):
        small, threads = fused.occupancy(n_lanes, 8, hi_mode)
        big, _ = fused.occupancy(n_lanes, 8192 // n_lanes, hi_mode)
        assert 1 <= big <= small and threads >= 32, (n_lanes, hi_mode, small, big, threads)
        assert big == 1, (n_lanes, hi_mode, big)  # 128 KB of records: one block per SM


# --- unbatched serving: the full kernel on the batch-of-one view ---------------------


@pytest.mark.parametrize("name", ["add2", "reverse_any/stack4", "overflow64", "mesh8",
                                  "pipeline32", "random/300", "random/305"])
def test_unbatched_kernel_matches_plain_input_untouched(card, name):
    """B=1 serve_chunk through the kernel against serve_chunk(engine="scan")
    from the same unbatched states, chunk after chunk with a feed: the
    packed snapshot and every field exact, the input untouched, one launch
    of the full kernel per chunk (chip_smoke.compare_unbatched)."""
    net = chip_smoke.unbatched_networks()[name].compile(device=card)
    rng = np.random.default_rng(4)
    state = net.init_state()
    for steps in (64, 300):
        vals = rng.integers(-(2**31), 2**31, size=net.in_cap, dtype=np.int64).astype(np.int32)
        free = net.in_cap - int(state.in_wr - state.in_rd)
        row, state = chip_smoke.compare_unbatched(name, net, state, vals, min(free, 5), steps)
        check(row)
    assert tuple(state.pc.shape) == (net.num_lanes,) and state.tick.dim() == 0


def test_unbatched_runs_the_full_kernel_under_elide_env(card, monkeypatch):
    """The reference's unbatched path has no elided variant: under
    MISAKA_FUSED_ELIDE_HI=1 add2's hi planes (random at entry) still follow
    the plain version, and the launch counts as the full kernel."""
    monkeypatch.setenv("MISAKA_FUSED_ELIDE_HI", "1")
    net = networks.add2(in_cap=16, out_cap=16, stack_cap=8).compile(device=card)
    rng = np.random.default_rng(6)
    state = chip_smoke.with_random_hi(net.init_state(), rng)
    vals = rng.integers(-(2**31), 2**31, size=16, dtype=np.int64).astype(np.int32)
    row, out = chip_smoke.compare_unbatched("add2/elide_env", net, state, vals, 6, 128)
    check(row)
    assert not torch.equal(out.acc_hi, state.acc_hi)  # IN rewrote the hi words


@pytest.mark.parametrize("batch", [None, 64])
def test_traced_loop_on_card_matches_cpu(card, batch):
    row = chip_smoke.compare_traced("add2", networks.add2(in_cap=16, out_cap=16, stack_cap=8),
                                    batch, 200, np.random.default_rng(8))
    check(row)


def test_unbatched_master_serves_through_the_kernel(card):
    from misaka_tpu_torch.runtime.master import MasterNode

    m = MasterNode(networks.add2(in_cap=16, out_cap=16, stack_cap=8), chunk_steps=64,
                   device=card)
    m.run()
    try:
        assert m.compute(5, timeout=60) == 7
        m.pause()
        s0, n0 = m.status(), dict(fused.launch_counts)
        m.run()
        vals = np.arange(-200, 200, dtype=np.int32)
        assert np.array_equal(m.compute_coalesced(vals, timeout=120, return_array=True), vals + 2)
        m.pause()
        s1 = m.status()
        assert s1["engine"] == "fused" and "batch" not in s1
        assert fused.launch_counts[fused.KERNEL] - n0[fused.KERNEL] == \
            (s1["tick"] - s0["tick"]) // 64 > 0
        assert fused.launch_counts[fused.KERNEL_ELIDE] == n0[fused.KERNEL_ELIDE]
    finally:
        m.close()


def test_unbatched_master_refuses_networks_beyond_the_kernel(card):
    from misaka_tpu_torch.runtime.master import MasterNode

    wide = networks.pipeline(33, in_cap=8, out_cap=8, stack_cap=8)
    with pytest.raises(ValueError, match="MAX_LANES=32"):
        MasterNode(wide, device=card)
    MasterNode(wide, device=card, engine="scan").close()  # the plain loop takes any width


def _chunk_count():
    from misaka_tpu_torch.runtime import master as master_mod

    return sum(sum(child.snapshot()[0]) for _, child in master_mod.M_CHUNK_SECONDS._items())


@pytest.mark.parametrize("batch", [64, None], ids=["batched", "unbatched"])
def test_chunk_histogram_counts_one_observation_per_launch(card, batch):
    from misaka_tpu_torch.runtime.master import MasterNode

    m = MasterNode(networks.add2(in_cap=16, out_cap=16, stack_cap=8), chunk_steps=64,
                   batch=batch, device=card)
    try:
        m.run()
        assert m.compute(5, timeout=60) == 7
        m.pause()
        c0, n0 = _chunk_count(), fused.launch_counts[fused.KERNEL]
        m.run()
        vals = np.arange(-300, 300, dtype=np.int32)
        assert np.array_equal(m.compute_coalesced(vals, timeout=120, return_array=True), vals + 2)
        m.pause()
        launched = fused.launch_counts[fused.KERNEL] - n0
        assert launched > 0 and _chunk_count() - c0 == launched
    finally:
        m.close()


def test_profile_on_the_card_holds_the_kernel_and_the_loop(card, tmp_path):
    import json
    import threading
    import urllib.request

    from misaka_tpu_torch.runtime.master import MasterNode, make_http_server
    from misaka_tpu_torch.utils import profiling

    m = MasterNode(networks.add2(in_cap=16, out_cap=16, stack_cap=8), chunk_steps=64,
                   batch=64, device=card)
    h = make_http_server(m, port=0, profile_dir=str(tmp_path))
    threading.Thread(target=h.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{h.server_address[1]}"

    def post(path, body=b""):
        with urllib.request.urlopen(urllib.request.Request(base + path, data=body),
                                    timeout=120) as r:
            return r.status, r.read().decode()

    try:
        m.run()
        assert post("/profile/start", b"name=card") == (200, "Success")
        for v in range(8):
            assert post("/compute", f"value={v}".encode())[1] == '{"value": %d}\n' % (v + 2)
        loop_tid = m._loop.native_id
        code, out = post("/profile/stop")
        assert code == 200
        with open(f"{out}/{profiling.TRACE_FILE}") as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
        assert any("fused_superstep" in k for k in kernels), sorted(kernels)[:20]
        loop_ops = {e["name"] for e in events if e.get("tid") == loop_tid}
        assert {"misaka.iteration", "misaka.checks_clones", "misaka.kernel_launch"} <= loop_ops
    finally:
        h.shutdown()
        h.server_close()
        m.close()


# --- model parallel on a mesh that repeats the card (PR 13) ---------------------------


@pytest.mark.parametrize("engine", ["routed", "gather"])
@pytest.mark.parametrize("mp,dp", [(2, 1), (4, 1), (2, 2)])
def test_lane_runners_match_the_kernel_graphed_and_eager(card, engine, mp, dp):
    """mesh8 at B=4096 over mp x dp shards of cuda:0: the graphed runner
    (one CUDA graph a tick) and the eager one give the kernel's result,
    every field, twice in a row from the same state, replicas equal."""
    row = chip_smoke.lane_case(f"mesh8/{dp}x{mp}", *_mesh8_case(card), ["cuda:0"] * (mp * dp),
                               mp, 96, engine)
    check(row)
    assert row["graphed"]
    eager = chip_smoke.lane_case(f"mesh8/{dp}x{mp}/eager", *_mesh8_case(card),
                                 ["cuda:0"] * (mp * dp), mp, 96, engine, graph=False)
    check(eager)
    assert not eager["graphed"]


def _mesh8_case(card):
    net = networks.mesh8(**chip_smoke.MAIN_CAPS).compile(batch=4096, device=card)
    rng = np.random.default_rng(41)
    state = chip_smoke.with_random_hi(chip_smoke.seeded_inputs(net, rng, 128), rng)
    want, _ = chip_smoke.kernel_result(net, state, 96)
    return net, state, want


def test_compact_and_chained_steps_match_the_kernel(card):
    """pipeline32 (the kernel's widest build) at B=4096: the compact and
    chained one-device steps against the kernel, 96 ticks."""
    net = networks.pipeline(32, **chip_smoke.MAIN_CAPS).compile(batch=4096, device=card)
    state = chip_smoke.seeded_inputs(net, np.random.default_rng(43), 128)
    want, _ = chip_smoke.kernel_result(net, state, 96)
    from misaka_tpu_torch.core.state import state_to_numpy

    for engine in ("compact", "chained"):
        got = state_to_numpy(net.run(state, 96, engine=engine))
        assert chip_smoke.diverged_fields(got, want) == [], engine
