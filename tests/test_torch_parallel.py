"""The port's lane-sharded runners against the JAX package's, on the same
mesh shapes: the cases of tests/test_parallel.py.

Both lane-sharded engines, the statically-routed two-collective one
(parallel/routed.py, the default) and the first-generation occupancy-gather
one (parallel/sharded.py), must give every field of the JAX runner's
result, and of the port's one-device dense step, for any program and any
[data, model] factorization.  The port's shards live on the CPU
(`make_mesh(n, "cpu", model_parallel=m)`), the JAX package's on the
8-device virtual CPU mesh of tests/conftest.py.  Every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from misaka_tpu import networks as jnetworks
from misaka_tpu.core.engine import CompiledNetwork as JNet
from misaka_tpu.parallel import make_mesh as j_make_mesh
from misaka_tpu.parallel import make_routed_runner as j_routed
from misaka_tpu.parallel import make_sharded_runner as j_sharded
from misaka_tpu.parallel import shard_state as j_shard_state
from misaka_tpu_torch import networks
from misaka_tpu_torch.core.engine import CompiledNetwork
from misaka_tpu_torch.core.state import NetworkState, state_from_numpy, state_to_numpy
from misaka_tpu_torch.parallel import (
    build_route_table,
    make_mesh,
    make_routed_runner,
    make_sharded_runner,
    shard_state,
    state_specs,
)
from misaka_tpu_torch.parallel.mesh import LANE_FIELDS, gather_state, replicas_agree
from tests.test_torch_routing import fuzz_tables

torch.set_num_threads(1)

FACTORIES = {"gather": (make_sharded_runner, j_sharded), "routed": (make_routed_runner, j_routed)}


@pytest.fixture(params=sorted(FACTORIES))
def factories(request):
    return FACTORIES[request.param]


def fed(net, rng, n=4):
    s = state_to_numpy(net.init_state())
    s["in_buf"][:, :n] = rng.integers(-100, 100, size=(net.batch, n))
    s["in_wr"][:] = n
    return s


def run_both(factories, tnet, jnet, mp, dp, steps, seed=0, n_inputs=4):
    """(the port's sharded result, the JAX sharded result, the port's dense
    result), each a dict of global arrays, from one seeded state."""
    make, jmake = factories
    entry = fed(tnet, np.random.default_rng(seed), n_inputs)
    mesh = make_mesh(mp * dp, "cpu", model_parallel=mp)
    shards = shard_state(state_from_numpy(entry), mesh)
    out = make(tnet.code, tnet.prog_len, mesh, steps)(shards)
    assert replicas_agree(out, mesh) == []
    got = state_to_numpy(gather_state(out, mesh))
    assert_fields_equal(state_to_numpy(gather_state(shards, mesh)), entry, "input touched")
    jmesh = j_make_mesh(mp * dp, model_parallel=mp)
    js = jnet.init_state()._replace(**{f: jnp.asarray(v) for f, v in entry.items()})
    jout = jmake(jnet.code, jnet.prog_len, jmesh, num_steps=steps)(j_shard_state(js, jmesh))
    want = {f: np.asarray(getattr(jout, f)) for f in jout._fields}
    dense = state_to_numpy(tnet.run(state_from_numpy(entry), steps, engine="dense"))
    return got, want, dense


def assert_fields_equal(got, want, what=""):
    for f in NetworkState._fields:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{f} {what}")


def nets(name, batch, **kw):
    caps = dict(in_cap=8, out_cap=8, **kw)
    make = {"mesh8": lambda m: m.mesh8(**caps), "add2": lambda m: m.add2(**caps),
            "ring8": lambda m: m.ring(8, **caps)}[name]
    return make(networks).compile(batch=batch, device="cpu"), make(jnetworks).compile(batch=batch)


@pytest.mark.parametrize("name,mp,dp,batch,steps", [
    ("mesh8", 4, 2, 4, 60),   # dp2 x mp4
    ("mesh8", 8, 1, 2, 60),   # pure lane parallel
    ("add2", 2, 4, 8, 80),
    ("ring8", 4, 2, 4, 100),
    ("add2", 1, 8, 8, 60),    # data parallel only: the whole lane axis per shard
])
def test_sharded_equals_jax_and_dense(factories, name, mp, dp, batch, steps):
    tnet, jnet = nets(name, batch)
    got, want, dense = run_both(factories, tnet, jnet, mp, dp, steps)
    assert_fields_equal(got, want, "vs the JAX runner")
    assert_fields_equal(got, dense, "vs the dense step")
    assert int(got["out_wr"].sum()) > 0  # it computed
    if name == "add2":
        np.testing.assert_array_equal(got["out_wr"], 4)  # every instance, all 4 values


@pytest.mark.parametrize("seed", range(6))
def test_fuzzed_programs_equal_jax(factories, seed):
    """Random programs (every opcode, self-sends, stacks, jumps) across
    shard boundaries (mp=4), the JAX runner's generator seeds."""
    code, lengths, n_stacks = fuzz_tables(7000 + seed, 4)
    kw = dict(code=code, prog_len=lengths, num_stacks=n_stacks, stack_cap=4, in_cap=8,
              out_cap=8, batch=2)
    got, want, dense = run_both(factories, CompiledNetwork(**kw, device="cpu"), JNet(**kw),
                                mp=4, dp=2, steps=48, seed=seed, n_inputs=6)
    assert_fields_equal(got, want, "vs the JAX runner")
    assert_fields_equal(got, dense, "vs the dense step")


def test_collectives_actually_cross_shards(factories):
    """On mp=4 a value read at lane a0 (shard 0) arrives at lane a3 (shard
    3) and comes out +4."""
    make, _ = factories
    net = networks.mesh8(in_cap=8, out_cap=8).compile(batch=1, device="cpu")
    mesh = make_mesh(4, "cpu", model_parallel=4)
    s = state_to_numpy(net.init_state())
    s["in_buf"][:, 0] = 50
    s["in_wr"][:] = 1
    out = gather_state(make(net.code, net.prog_len, mesh, 40)(
        shard_state(state_from_numpy(s), mesh)), mesh)
    assert int(out.out_wr[0]) == 1 and int(out.out_buf[0, 0]) == 54


def test_route_table_compactness():
    """The routed engine's election traffic scales with the active edge set,
    not with every lane x port."""
    net = networks.mesh8(in_cap=8, out_cap=8).compile(device="cpu")
    route = build_route_table(net.code, net.prog_len)
    n_dests = net.num_lanes * 4
    assert 0 < route.n_send < n_dests
    assert route.slot_lane.shape == (route.n_send,)
    assert (route.slot_lane >= 0).all() and (route.slot_lane < net.num_lanes).all()
    assert (route.slot_port >= 0).all() and (route.slot_port < 4).all()
    full = route.slot_lane * 4 + route.slot_port
    np.testing.assert_array_equal(route.dest_to_slot[full], np.arange(route.n_send))


def test_make_mesh_validates_divisibility():
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(8, "cpu", model_parallel=3)
    with pytest.raises(ValueError, match="not divisible"):
        j_make_mesh(8, model_parallel=3)
    mesh = make_mesh(8, "cpu", model_parallel=4)
    assert mesh.shape == dict(j_make_mesh(8, model_parallel=4).shape) == {"data": 2, "model": 4}


def test_lane_count_must_divide_model_axis(factories):
    make, _ = factories
    net = networks.add2().compile(device="cpu")  # 2 lanes
    with pytest.raises(ValueError, match="not divisible"):
        make(net.code, net.prog_len, make_mesh(8, "cpu", model_parallel=4), 4)


def test_state_specs_are_the_reference_table():
    """Which fields shard over `model` and which replicate: the JAX
    PartitionSpecs, batched and not."""
    from misaka_tpu.parallel import state_specs as j_specs

    for batched in (True, False):
        for f, spec, jspec in zip(NetworkState._fields, state_specs(batched), j_specs(batched)):
            assert spec == tuple(jspec), f
    assert LANE_FIELDS == {"acc", "bak", "acc_hi", "bak_hi", "pc", "port_val", "port_full",
                           "hold_val", "holding", "retired"}


@pytest.mark.parametrize("mp,dp", [(1, 4), (2, 2), (4, 1), (2, 4)])
def test_shard_and_gather_are_inverse_and_follow_the_jax_layout(mp, dp):
    """shard_state cuts every field where the JAX sharding puts it (lane
    fields over `model`, the rest replicated), gather_state joins them
    back, and every shard owns its storage."""
    tnet, jnet = nets("mesh8", 8)
    entry = fed(tnet, np.random.default_rng(mp * 10 + dp))
    for f in ("acc", "pc", "retired"):
        entry[f] = np.random.default_rng(3).integers(-50, 50, size=entry[f].shape).astype(np.int32)
    mesh = make_mesh(mp * dp, "cpu", model_parallel=mp)
    whole = state_from_numpy(entry)
    shards = shard_state(whole, mesh)
    jmesh = j_make_mesh(mp * dp, model_parallel=mp)
    js = j_shard_state(jnet.init_state()._replace(
        **{f: jnp.asarray(v) for f, v in entry.items()}), jmesh)
    jdev = {d: i for i, d in enumerate(jmesh.devices.reshape(-1))}
    for f in NetworkState._fields:
        for jpart in getattr(js, f).addressable_shards:
            part = getattr(shards[jdev[jpart.device]], f)
            np.testing.assert_array_equal(part.numpy(), np.asarray(jpart.data), err_msg=f)
    back = state_to_numpy(gather_state(shards, mesh))
    assert_fields_equal(back, entry)
    ptrs = [t.untyped_storage().data_ptr() for shard in shards for t in shard]
    assert len(set(ptrs)) == len(ptrs)
    assert not set(ptrs) & {t.untyped_storage().data_ptr() for t in whole}
