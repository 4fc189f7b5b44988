"""core/routing.py (the compact-slot and chained elections) against the
JAX package's, and the wide-engine selection of core/engine.py.

- `build_route_table` / `build_chain_table` equal the JAX ones on every
  network of networks.py and on fuzzed programs.
- `step_slots`, compact and chained, equals the JAX `step_slots` (its
  `run(engine="compact")`, vmapped when batched) and the port's dense step
  after N ticks: batched and unbatched, fuzzed programs up to 64 lanes, and
  the 32- and 64-lane pipelines; one tick at a time on a fuzzed network.
- MISAKA_COMPACT_AUTO_LANES / MISAKA_WIDE_ENGINE, as tests/test_scale.py
  pins them for the JAX engine.

Every comparison is exact: the state is integers.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from misaka_tpu import networks as jnetworks
from misaka_tpu.core import routing as jrouting
from misaka_tpu.core.engine import CompiledNetwork as JNet
from misaka_tpu_torch import networks
from misaka_tpu_torch.core import engine as tengine
from misaka_tpu_torch.core import routing
from misaka_tpu_torch.core.engine import CompiledNetwork
from misaka_tpu_torch.core.state import NetworkState, state_from_numpy, state_to_numpy
from misaka_tpu_torch.tis import isa
from misaka_tpu_torch.tis.lower import lower_program, pad_programs
from tests.test_differential import random_program

torch.set_num_threads(1)

CAPS = dict(in_cap=8, out_cap=8, stack_cap=8)
NETWORKS = {
    "add2": lambda m: m.add2(**CAPS),
    "acc_loop": lambda m: m.acc_loop(**CAPS),
    "ring4": lambda m: m.ring(4, **CAPS),
    "ring8": lambda m: m.ring(8, **CAPS),
    "sorter": lambda m: m.sorter(**CAPS),
    "mesh8": lambda m: m.mesh8(**CAPS),
    "pipeline8": lambda m: m.pipeline(8, **CAPS),
    "pipeline32": lambda m: m.pipeline(32, **CAPS),
}


def fuzz_tables(seed, n_lanes):
    """Random programs (every opcode, self-sends, contended stacks, ports,
    IN and OUT) lowered by the port: (code, prog_len, n_stacks)."""
    rng = np.random.default_rng(seed)
    n_stacks = int(rng.integers(1, 3))
    lane_names = [f"n{i}" for i in range(n_lanes)]
    stack_names = [f"s{i}" for i in range(n_stacks)]
    lane_ids = {name: i for i, name in enumerate(lane_names)}
    stack_ids = {name: i for i, name in enumerate(stack_names)}
    programs = [random_program(rng, lane_names, stack_names, int(rng.integers(1, 9)))
                for _ in lane_names]
    code, lengths = pad_programs([lower_program(p, lane_ids, stack_ids) for p in programs])
    return code, lengths, n_stacks


def both_nets(code, prog_len, n_stacks, batch, stack_cap=4):
    kw = dict(code=code, prog_len=prog_len, num_stacks=n_stacks, stack_cap=stack_cap,
              in_cap=8, out_cap=8, batch=batch)
    return JNet(**kw), CompiledNetwork(**kw, device="cpu")


def fed_state(net, rng, n=6):
    """A fresh state with n seeded inputs queued in every instance."""
    s = state_to_numpy(net.init_state())
    shape = (n,) if net.batch is None else (net.batch, n)
    s["in_buf"][..., :n] = rng.integers(-100, 100, size=shape)
    s["in_wr"][...] = n
    return s


def jax_run(jnet, entry, ticks, engine):
    js = jnet.init_state()._replace(**{f: jnp.asarray(v) for f, v in entry.items()})
    out = jnet.run(js, ticks, engine=engine)
    return {f: np.asarray(getattr(out, f)) for f in out._fields}


def assert_fields_equal(got, want, what=""):
    for f in NetworkState._fields:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{f} {what}")


# --- the tables ----------------------------------------------------------------


def _assert_tables_equal(code, prog_len, n_stacks):
    route, jroute = routing.build_route_table(code, prog_len), jrouting.build_route_table(
        code, prog_len)
    assert route.n_send == jroute.n_send
    for f in ("dest_to_slot", "slot_lane", "slot_port"):
        np.testing.assert_array_equal(getattr(route, f), getattr(jroute, f), err_msg=f)
        assert getattr(route, f).dtype == np.int32
    chain = routing.build_chain_table(code, prog_len, route, n_stacks)
    jchain = jrouting.build_chain_table(code, prog_len, jroute, n_stacks)
    assert chain == jchain


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_tables_equal_jax_on_every_network(name):
    net = NETWORKS[name](networks).compile(device="cpu")
    jnet = NETWORKS[name](jnetworks).compile()
    np.testing.assert_array_equal(net.code, jnet.code)
    _assert_tables_equal(net.code, net.prog_len, net.num_stacks)


@pytest.mark.parametrize("seed,n_lanes", [(0, 4), (1, 9), (2, 16), (3, 40), (4, 64)])
def test_tables_equal_jax_on_fuzzed_networks(seed, n_lanes):
    code, lengths, n_stacks = fuzz_tables(8000 + seed, n_lanes)
    _assert_tables_equal(code, lengths, n_stacks)


def test_route_table_refuses_a_destination_out_of_range():
    code, lengths, _ = fuzz_tables(5, 4)
    code = code.copy()
    code[0, 0] = 0
    code[0, 0, isa.F_OP], code[0, 0, isa.F_TGT] = isa.OP_MOV_NET, 9  # lane 9 of 4
    with pytest.raises(ValueError, match="out of range"):
        routing.build_route_table(code, lengths)
    with pytest.raises(ValueError, match="out of range"):
        jrouting.build_route_table(code, lengths)


# --- the steps -------------------------------------------------------------------


@pytest.mark.parametrize("seed,n_lanes,batch", [
    (0, 4, 3), (1, 8, None), (2, 16, 3), (3, 32, None), (4, 40, 2), (5, 64, 2),
])
def test_compact_and_chained_equal_jax_and_dense_fuzzed(seed, n_lanes, batch):
    """Random networks up to 64 lanes, batched and unbatched: the port's
    compact and chained steps against the JAX compact step and the port's
    dense step after 64 ticks."""
    code, lengths, n_stacks = fuzz_tables(3000 + seed, n_lanes)
    jnet, tnet = both_nets(code, lengths, n_stacks, batch)
    entry = fed_state(tnet, np.random.default_rng(seed))
    want = jax_run(jnet, entry, 64, "compact")
    dense = state_to_numpy(tnet.run(state_from_numpy(entry), 64, engine="dense"))
    assert_fields_equal(dense, want, "dense vs jax")
    for engine in ("compact", "chained"):
        got = state_to_numpy(tnet.run(state_from_numpy(entry), 64, engine=engine))
        assert_fields_equal(got, want, engine)
    assert int(np.asarray(want["retired"]).sum()) > 0


@pytest.mark.parametrize("n_lanes", [32, 64])
@pytest.mark.parametrize("batch", [None, 4])
def test_wide_pipelines_equal_jax(n_lanes, batch):
    """pipeline(32) and pipeline(64): one value laps every lane (v + N)."""
    top, jtop = networks.pipeline(n_lanes, **CAPS), jnetworks.pipeline(n_lanes, **CAPS)
    tnet, jnet = top.compile(batch=batch, device="cpu"), jtop.compile(batch=batch)
    entry = fed_state(tnet, np.random.default_rng(n_lanes), n=3)
    ticks = 3 * n_lanes + 16
    want = jax_run(jnet, entry, ticks, "compact")
    for engine in ("dense", "compact", "chained"):
        got = state_to_numpy(tnet.run(state_from_numpy(entry), ticks, engine=engine))
        assert_fields_equal(got, want, engine)
    outs = want["out_buf"][..., :3]
    np.testing.assert_array_equal(outs, entry["in_buf"][..., :3] + n_lanes)


def test_chained_equals_jax_chained_tick_by_tick():
    """The JAX chained step and the port's, one tick at a time on a fuzzed
    16-lane network (batched), with the port's dense step beside them."""
    code, lengths, n_stacks = fuzz_tables(77, 16)
    jnet, tnet = both_nets(code, lengths, n_stacks, 2)
    entry = fed_state(tnet, np.random.default_rng(77))
    state = state_from_numpy(entry)
    for tick in range(24):
        want = jax_run(jnet, state_to_numpy(state), 1, "chained")
        chained = state_to_numpy(tnet.run(state, 1, engine="chained"))
        dense = state_to_numpy(tnet.run(state, 1, engine="dense"))
        assert_fields_equal(chained, want, f"chained, tick {tick}")
        assert_fields_equal(dense, want, f"dense, tick {tick}")
        state = state_from_numpy(chained)


def test_step_slots_one_instance_equals_jax_step_slots():
    """The port's step_slots on a batch of one against the JAX step_slots on
    the unbatched state, six ticks, compact and chained."""
    code, lengths, n_stacks = fuzz_tables(91, 8)
    jnet, tnet = both_nets(code, lengths, n_stacks, None)
    entry = fed_state(tnet, np.random.default_rng(91))
    route = routing.build_route_table(code, lengths)
    chain = routing.build_chain_table(code, lengths, route, n_stacks)
    jroute = jrouting.build_route_table(code, lengths)
    jchain = jrouting.build_chain_table(code, lengths, jroute, n_stacks)
    code_t, len_t = torch.from_numpy(code), torch.from_numpy(lengths)
    for ch, jch in ((None, None), (chain, jchain)):
        t = state_from_numpy({f: v[None] for f, v in entry.items()})
        j = jnet.init_state()._replace(**{f: jnp.asarray(v) for f, v in entry.items()})
        for _ in range(6):
            t = routing.step_slots(route, code_t, len_t, t, chain=ch)
            j = jrouting.step_slots(jroute, jnp.asarray(code), jnp.asarray(lengths), j,
                                    chain=jch)
        got = {f: v[0] for f, v in state_to_numpy(t).items()}
        assert_fields_equal(got, {f: np.asarray(getattr(j, f)) for f in j._fields})


def test_chained_is_one_device_only():
    code, lengths, n_stacks = fuzz_tables(1, 4)
    route = routing.build_route_table(code, lengths)
    chain = routing.build_chain_table(code, lengths, route, n_stacks)
    net = CompiledNetwork(code=code, prog_len=lengths, num_stacks=n_stacks, batch=1,
                          device="cpu")
    from misaka_tpu_torch.core.axis import Axis

    with pytest.raises(ValueError, match="single-chip"):
        routing.step_slots(route, net._code_t, net._len_t, net.init_state(),
                           axis=Axis(0, 2), chain=chain)


# --- the selection ---------------------------------------------------------------


def test_compact_auto_lanes_platform_and_override(monkeypatch):
    """The dense -> compact threshold per platform: the reference's own
    entries for cpu and tpu, its default (32) for cuda, a platform it does
    not name; MISAKA_COMPACT_AUTO_LANES overrides."""
    monkeypatch.delenv("MISAKA_COMPACT_AUTO_LANES", raising=False)
    assert tengine.compact_auto_lanes("cpu") == 0
    assert tengine.compact_auto_lanes("tpu") == 32 == tengine.COMPACT_AUTO_LANES
    assert tengine.compact_auto_lanes("cuda") == 32
    expected = 32 if torch.cuda.is_available() else 0
    assert tengine.compact_auto_lanes() == expected
    monkeypatch.setenv("MISAKA_COMPACT_AUTO_LANES", "7")
    assert tengine.compact_auto_lanes() == tengine.compact_auto_lanes("cuda") == 7


def test_wide_engine_platform_and_override(monkeypatch):
    """The wide step per platform (chained on a TPU, compact on the CPU
    and on CUDA) and MISAKA_WIDE_ENGINE; the auto path and step_fn honor
    it, and a bad value raises as the JAX engine's does."""
    from misaka_tpu.core.engine import wide_engine as j_wide_engine

    monkeypatch.delenv("MISAKA_WIDE_ENGINE", raising=False)
    assert tengine.wide_engine("cpu") == "compact" == j_wide_engine()
    assert tengine.wide_engine("tpu") == "chained"
    assert tengine.wide_engine("cuda") == "compact"
    monkeypatch.setenv("MISAKA_WIDE_ENGINE", "chained")
    assert tengine.wide_engine() == "chained" == j_wide_engine()
    monkeypatch.setenv("MISAKA_COMPACT_AUTO_LANES", "2")
    net = networks.pipeline(4, **CAPS).compile(device="cpu")
    assert net.auto_engine() == "chained"
    assert net.step_fn() is net.step_fn("chained")
    monkeypatch.setenv("MISAKA_WIDE_ENGINE", "bogus")
    with pytest.raises(ValueError, match="MISAKA_WIDE_ENGINE") as exc:
        tengine.wide_engine()
    with pytest.raises(ValueError, match="MISAKA_WIDE_ENGINE") as jexc:
        j_wide_engine()
    assert str(exc.value) == str(jexc.value)


def test_cpu_auto_selects_compact_small_net(monkeypatch):
    """On the CPU even the 2-lane add2 auto-runs the compact step (the
    reference's threshold 0 there), and the kernel's plain version stays
    the dense step."""
    monkeypatch.delenv("MISAKA_WIDE_ENGINE", raising=False)
    monkeypatch.delenv("MISAKA_COMPACT_AUTO_LANES", raising=False)
    net = networks.add2(**CAPS).compile(batch=2, device="cpu")
    assert net.auto_engine() == "compact"
    assert net.step_fn() is net.step_fn("compact")
    assert net.step_fn("dense") is tengine.step
    with pytest.raises(ValueError, match="dense|compact|chained"):
        net.run(net.init_state(), 1, engine="bogus")
