"""The port's disassembler gives misaka_tpu's text, line for line.

misaka_tpu_torch keeps its own copy of tis/disasm.py.  Every baseline
config, every examples/*.json network and a fuzzed corpus of random
programs is lowered once (the tables are pinned equal in
tests/test_torch_tis.py) and disassembled by both packages: the texts must
be identical (exact string equality), with the networks' own names and with
the positional defaults.  Malformed rows raise the same error type and
message in both, and the port's text lowers back to the same table.
"""

import glob
import os

import numpy as np
import pytest

from misaka_tpu.tis import disasm as jdisasm
from misaka_tpu.tis import isa as jisa
from misaka_tpu_torch import networks as tnet
from misaka_tpu_torch.runtime.topology import Topology
from misaka_tpu_torch.tis import disasm as tdisasm
from misaka_tpu_torch.tis.lower import lower_program
from tests.test_differential import build_random_network

EXAMPLES = sorted(
    glob.glob(os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples", "*.json"))
)


def port_topologies():
    tops = {name: make for name, make in sorted(tnet.BASELINE_CONFIGS.items())}
    for path in EXAMPLES:
        tops[os.path.basename(path)] = lambda path=path: Topology.from_json(open(path).read())
    return tops


@pytest.mark.parametrize("name", sorted(port_topologies()))
def test_network_text_matches_jax(name):
    top = port_topologies()[name]()
    net = top.compile(device="cpu")
    lanes, stacks = list(top.lane_ids()), list(top.stack_ids())
    want = jdisasm.disassemble_network(net.code, net.prog_len, lanes, stacks)
    got = tdisasm.disassemble_network(net.code, net.prog_len, lanes, stacks)
    assert got == want
    for i in range(net.num_lanes):
        # positional default names, padding rows included
        assert tdisasm.disassemble_program(net.code[i]) == jdisasm.disassemble_program(
            net.code[i])
        # and the text lowers back to the same table
        again = lower_program(got[lanes[i]], top.lane_ids(), top.stack_ids())
        np.testing.assert_array_equal(again.code, net.code[i, : again.length])


@pytest.mark.parametrize("seed", range(12))
def test_fuzzed_text_matches_jax(seed):
    code, lengths, n_stacks, _, _ = build_random_network(seed)
    lanes = [f"n{i}" for i in range(code.shape[0])]
    stacks = [f"s{i}" for i in range(n_stacks)]
    assert tdisasm.disassemble_network(code, lengths, lanes, stacks) == \
        jdisasm.disassemble_network(code, lengths, lanes, stacks)


def test_every_opcode_renders_like_jax():
    lanes, stacks = ["a", "b"], ["s"]
    for op in range(jisa.NUM_OPS):
        for src in range(jisa.SRC_R3 + 1):
            row = np.array([op, src, -7, jisa.DST_NIL, 1, 3, 4], np.int32)
            assert tdisasm.disassemble_line(row, lanes, ["s", "t"]) == \
                jdisasm.disassemble_line(row, lanes, ["s", "t"])
    assert tdisasm.disassemble_line([0] * 7, lanes, stacks) == "NOP"


@pytest.mark.parametrize("row", [
    [99, 0, 0, 0, 0, 0, 0],                          # unknown opcode
    [jisa.OP_ADD, 42, 0, 0, 0, 0, 0],                # unknown source
    [jisa.OP_MOV_LOCAL, jisa.SRC_ACC, 0, 9, 0, 0, 0],  # unknown destination
], ids=["opcode", "source", "destination"])
def test_malformed_rows_raise_like_jax(row):
    with pytest.raises(jdisasm.TISDisasmError) as want:
        jdisasm.disassemble_line(row, ["a"], ["s"])
    with pytest.raises(tdisasm.TISDisasmError) as got:
        tdisasm.disassemble_line(row, ["a"], ["s"])
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)
