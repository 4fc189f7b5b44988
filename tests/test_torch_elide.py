"""The kernel's elided variant (elide_dead_hi) on the CPU side of the port.

A lane is hi-live when its program has a conditional jump or a JRO whose
source is ACC: only those read the high word of the 64-bit ACC.  The port's
mask (`fused.hi_live_lanes`) must equal the reference's on every baseline
and example network (tests/test_fused.py::_hi_live_lanes).

On a CPU state `fused_runner(elide_dead_hi=True)` runs the plain version,
which computes the full 64-bit state.  The contract the CUDA kernel is held
to on the card (tests/test_torch_fused_cuda.py, chip_smoke.py) is the JAX
kernel's: every field as the plain version's, except `acc_hi`/`bak_hi` of
hi-dead lanes, which keep their entry values.  The JAX kernel runs here in
Pallas interpret mode from the same seeded state to pin that contract.

The switch is MISAKA_FUSED_ELIDE_HI=1, read when a network is compiled, so
the mask follows the programs through /load.
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from misaka_tpu import networks as jnet
from misaka_tpu.runtime.topology import Topology as JTopology
from misaka_tpu_torch import networks as tnet
from misaka_tpu_torch.core import fused
from misaka_tpu_torch.core.state import state_from_numpy, state_to_numpy
from misaka_tpu_torch.runtime.master import MasterNode
from misaka_tpu_torch.runtime.topology import Topology
from tests.test_fused import _hi_live_lanes

torch.set_num_threads(1)

CAPS = dict(in_cap=8, out_cap=8, stack_cap=8)
EXAMPLES = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "*.json")))
# one hi-live lane (branches on ACC) beside one hi-dead lane
MIXED = {
    "nodes": {"sign": "program", "plus": "program"},
    "programs": {
        "sign": "IN ACC\nJLZ n\nMOV ACC, plus:R0\nJMP e\nn: MOV 0, plus:R0\ne: NOP",
        "plus": "MOV R0, ACC\nADD 2000000000\nADD 2000000000\nSAV\nOUT ACC",
    },
}


def _pairs():
    for name in sorted(jnet.BASELINE_CONFIGS):
        yield name, jnet.BASELINE_CONFIGS[name](**CAPS), tnet.BASELINE_CONFIGS[name](**CAPS)
    for path in EXAMPLES:
        with open(path) as f:
            text = f.read()
        yield os.path.basename(path), JTopology.from_json(text, **CAPS), Topology.from_json(text, **CAPS)


@pytest.mark.parametrize("name,jtop,ttop", list(_pairs()), ids=lambda v: v if isinstance(v, str) else "")
def test_hi_live_mask_matches_reference(name, jtop, ttop):
    jnet_c = jtop.compile(batch=2)
    tnet_c = ttop.compile(batch=2, device="cpu")
    want = _hi_live_lanes(jnet_c)
    assert fused.hi_live_lanes(tnet_c.code, tnet_c.prog_len) == want
    assert fused.hi_live_mask(tnet_c.code, tnet_c.prog_len) == sum(
        1 << n for n, live in enumerate(want) if live)
    if name in ("add2", "ring4"):
        assert not any(want)
    if name in ("sorter", "overflow64.json"):
        assert all(want)


def _seeded_state(net, rng, n_inputs=6):
    """A state with queued inputs and random acc_hi/bak_hi planes, so that
    'equals its entry value' means something."""
    s = state_to_numpy(net.init_state())
    s["in_buf"][:, :n_inputs] = rng.integers(-(2**31), 2**31, size=(net.batch, n_inputs))
    s["in_wr"][:] = n_inputs
    for f in ("acc_hi", "bak_hi"):
        s[f] = rng.integers(-(2**31), 2**31, size=s[f].shape).astype(np.int32)
    return s


@pytest.mark.parametrize("which", ["add2", "mixed"])
def test_elided_contract_matches_the_jax_kernel(which):
    if which == "add2":
        jtop, ttop = jnet.add2(**CAPS), tnet.add2(**CAPS)
    else:
        import json

        text = json.dumps(MIXED)
        jtop, ttop = JTopology.from_json(text, **CAPS), Topology.from_json(text, **CAPS)
    jn = jtop.compile(batch=128)
    tn = ttop.compile(batch=128, device="cpu")
    entry = _seeded_state(tn, np.random.default_rng(5))
    steps = 60
    jstate = jn.init_state()._replace(**{f: jnp.asarray(v) for f, v in entry.items()})
    jout = jn.fused_runner(steps, block_batch=128, interpret=True, elide_dead_hi=True)(jstate)
    jout = {f: np.asarray(getattr(jout, f)) for f in jout._fields}
    tout = state_to_numpy(tn.fused_runner(steps, elide_dead_hi=True)(state_from_numpy(entry)))
    plain = state_to_numpy(tn.run(state_from_numpy(entry), steps))
    assert all(np.array_equal(tout[f], plain[f]) for f in plain)  # CPU: the plain version
    live = fused.hi_live_lanes(tn.code, tn.prog_len)
    if which == "mixed":
        assert live == [True, False]
    for f in plain:
        if f in ("acc_hi", "bak_hi"):
            for n, is_live in enumerate(live):
                want = plain[f][:, n] if is_live else entry[f][:, n]
                np.testing.assert_array_equal(jout[f][:, n], want, err_msg=f"{f} lane {n}")
        else:
            np.testing.assert_array_equal(jout[f], plain[f], err_msg=f)
    assert plain["out_wr"].min() > 0


def test_elided_runner_on_cpu_counts_no_launch():
    net = tnet.sorter(**CAPS).compile(batch=8, device="cpu")
    before = dict(fused.launch_counts)
    s = state_from_numpy(_seeded_state(net, np.random.default_rng(1)))
    out = net.fused_runner(20, elide_dead_hi=True)(s)
    want = net.run(s, 20)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert fused.launch_counts == before


@pytest.mark.parametrize("hi_live,n_lanes,key", [
    (None, 2, fused.KERNEL), (0b11, 2, fused.KERNEL), (2**32 - 1, 32, fused.KERNEL),
    (0, 2, fused.KERNEL_ELIDE), (0b01, 2, fused.KERNEL_ELIDE), (2**31 - 1, 32, fused.KERNEL_ELIDE),
])
def test_launch_key_names_the_variant_the_kernel_runs(hi_live, n_lanes, key):
    """A mask over every lane runs the full kernel (the C entry picks its
    instantiation from the mask), so its launch counts as the full kernel's."""
    assert fused.variant(hi_live, n_lanes) == key


@pytest.mark.parametrize("name", ["sorter", "overflow64.json"])
def test_all_live_networks_count_as_the_full_kernel(name):
    net = {n: t for n, _, t in _pairs()}[name].compile(batch=2, device="cpu")
    mask = fused.hi_live_mask(net.code, net.prog_len)
    assert fused.variant(mask, net.num_lanes) == fused.KERNEL


def test_env_switch_reaches_the_served_path(monkeypatch):
    """MISAKA_FUSED_ELIDE_HI=1 hands the chunk wrapper the mask of the
    programs being served, recomputed when /load compiles a new network;
    unset, the wrapper gets no mask (the full kernel)."""
    seen = []
    real = fused.fused_superstep

    def spy(code, prog_len, state, num_steps, hi_live=None, count_as=None, **kw):
        seen.append(hi_live)
        return real(code, prog_len, state, num_steps, hi_live, count_as, **kw)

    monkeypatch.setattr(fused, "fused_superstep", spy)
    monkeypatch.setenv("MISAKA_FUSED_ELIDE_HI", "1")
    monkeypatch.setenv("MISAKA_NATIVE_AUTO", "0")  # the kernel wrapper's path on the CPU
    m = MasterNode(tnet.add2(**CAPS), chunk_steps=16, batch=2, device="cpu")
    m.run()
    try:
        assert m.compute_coalesced([5]) == [7]
        assert seen and set(seen) == {0}  # add2: no hi-live lane
        m.load("misaka1", "IN ACC\nJGZ p\nNOP\np: ADD 1\nMOV ACC, misaka2:R0\n"
                          "MOV R0, ACC\nOUT ACC\n")
        seen.clear()
        m.run()
        assert m.compute_coalesced([5]) == [7]
        assert set(seen) == {0b01}  # lane 0 branches now
    finally:
        m.close()
    monkeypatch.delenv("MISAKA_FUSED_ELIDE_HI")
    seen.clear()
    m = MasterNode(tnet.add2(**CAPS), chunk_steps=16, batch=2, device="cpu")
    m.run()
    try:
        assert m.compute_coalesced([1]) == [3]
        assert set(seen) == {None}
    finally:
        m.close()
