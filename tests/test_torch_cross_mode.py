"""Mixed clusters and the cross-mode check, at tier-1 depth.

The reference's tests/test_cross_mode.py (slow-marked, 40 seeds a suite)
holds its free-running gRPC cluster against its lockstep engine.  Here, on
the CPU:

- mixed clusters both ways: the port's program nodes against the JAX
  package's master and stack, then the JAX package's program nodes against
  the port's master and stack, each giving an all-JAX cluster's output
  stream on the add2 programs and on 4 Kahn-style seeds (the wire, the
  interpreter and the control plane are interchangeable node by node);
- the port's cluster against the port's lockstep engine (the plain loop on
  the CPU, through the same `chip_smoke.lockstep_outputs` the card's check
  runs through the fused kernel at B=1): identical streams for 4 Kahn
  seeds, equal multisets for 2 contended seeds (reference :268, :305).

The generators are chip_smoke.py's copies of the reference's, seed for
seed.  Every cluster is closed in a finally.
"""

import numpy as np
import pytest

pytest.importorskip("grpc")

import chip_smoke  # noqa: E402
from misaka_tpu.runtime import nodes as jnodes  # noqa: E402
from misaka_tpu_torch.runtime import nodes as tnodes  # noqa: E402

ADD2 = ({"misaka1": "program", "misaka2": "program", "misaka3": "stack"},
        {"misaka1": chip_smoke.DIST_MISAKA1, "misaka2": chip_smoke.DIST_MISAKA2}, 1)
KAHN_SEEDS = (0, 1, 2, 3)


@pytest.fixture(autouse=True)
def _quiet_backoff(monkeypatch):
    # a node that dials a peer still booting retries within 0.2 s
    monkeypatch.setenv("MISAKA_RPC_BACKOFF_MAX", "0.2")


def build_mixed_cluster(node_info, programs, program_pkg, infra_pkg,
                        master_name="last_order"):
    """build_loopback_cluster with the program nodes from `program_pkg` and
    the master and stacks from `infra_pkg` (either package's nodes module):
    (master, close), close in dependency order."""
    resolver = infra_pkg.Resolver()
    stacks, progs, master = [], [], None

    def close():
        for n in ([master] if master is not None else []) + progs + stacks:
            n.close()

    try:
        for name, kind in node_info.items():
            if kind == "stack":
                s = infra_pkg.StackNodeProcess(grpc_port=0, host="127.0.0.1")
                stacks.append(s)
                resolver.set_addr(name, f"127.0.0.1:{s.start()}")
        for name, kind in node_info.items():
            if kind == "program":
                p = program_pkg.ProgramNodeProcess(master_uri=master_name, resolver=resolver,
                                                   grpc_port=0, host="127.0.0.1")
                progs.append(p)
                p.load_program(programs[name])
                resolver.set_addr(name, f"127.0.0.1:{p.start()}")
        master = infra_pkg.MasterNodeProcess(
            node_info={n: {"type": k} for n, k in node_info.items()}, resolver=resolver,
            grpc_port=0, host="127.0.0.1")
        resolver.set_addr(master_name, f"127.0.0.1:{master.start()}")
    except BaseException:
        close()
        raise
    return master, close


def _stream(program_pkg, infra_pkg, node_info, programs, inputs, expect_n):
    master, close = build_mixed_cluster(node_info, programs, program_pkg, infra_pkg)
    try:
        master.run()
        return chip_smoke.cluster_stream(master, inputs, expect_n)
    finally:
        close()


def _network(case):
    if case == "add2":
        return ADD2, [5, -3, 1000, 0, 2**31 - 1, -(2**31), 7, 41]
    seed = int(case.removeprefix("kahn"))
    return chip_smoke.kahn_network(seed), chip_smoke.kahn_inputs(seed)


_ALL_JAX: dict = {}


def _all_jax(case):
    """The all-JAX cluster's output stream for a case (once per process)."""
    if case not in _ALL_JAX:
        (node_info, programs, per_input), inputs = _network(case)
        _ALL_JAX[case] = _stream(jnodes, jnodes, node_info, programs, inputs,
                                 len(inputs) * per_input)
    return _ALL_JAX[case]


@pytest.mark.parametrize("case", ["add2"] + [f"kahn{s}" for s in KAHN_SEEDS])
@pytest.mark.parametrize("programs_from", ["port", "jax"])
def test_mixed_cluster_matches_all_jax(case, programs_from):
    """programs_from="port": the port's program nodes against the JAX
    package's master and stack; "jax": the JAX package's program nodes
    against the port's master and stack.  Both give the all-JAX stream."""
    (node_info, programs, per_input), inputs = _network(case)
    program_pkg, infra_pkg = (tnodes, jnodes) if programs_from == "port" else (jnodes, tnodes)
    want = _all_jax(case)
    got = _stream(program_pkg, infra_pkg, node_info, programs, inputs, len(want))
    assert len(want) == len(inputs) * per_input
    assert got == want, f"{case}: mixed {got} != all-JAX {want}"
    if case == "add2":  # the sint32 wire wraps 2**31 - 1 + 2
        assert want == [7, -1, 1002, 2, -(2**31) + 1, -(2**31) + 2, 9, 43]


@pytest.mark.parametrize("seed", KAHN_SEEDS)
def test_port_cluster_matches_port_lockstep(seed):
    """A Kahn network's free-running stream through the port's nodes equals
    the port's lockstep engine's (the plain loop on the CPU, the path the
    card's check runs through the kernel at B=1), and the all-JAX
    cluster's."""
    node_info, programs, per_input = chip_smoke.kahn_network(seed)
    inputs = chip_smoke.kahn_inputs(seed)
    engine = chip_smoke.lockstep_outputs(node_info, programs, inputs, "cpu")
    assert len(engine) == chip_smoke.KAHN_INPUTS * per_input, (
        f"seed {seed}: the engine emitted {engine}\n" + "\n---\n".join(programs.values()))
    cluster = chip_smoke.cluster_outputs(node_info, programs, inputs, len(engine))
    assert cluster == engine, (f"seed {seed}: cluster {cluster} != engine {engine}\n"
                               + "\n---\n".join(programs.values()))
    assert engine == _all_jax(f"kahn{seed}")


def _gen_contended(seed):
    """Several lanes race for one stack (and possibly a port and the OUT
    grant): the reference's tests/test_cross_mode.py::gen_contended."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(-20, 20))
    n_workers = int(rng.integers(2, 4))
    via_port = bool(rng.integers(2))
    node_info = {"head": "program", "st": "stack"}
    programs = {"head": "IN ACC\nPUSH ACC, st\n"}
    for w in range(n_workers):
        node_info[f"w{w}"] = "program"
        sink = "MOV ACC, tail:R0" if via_port else "OUT ACC"
        programs[f"w{w}"] = f"POP st, ACC\nADD {k}\n{sink}\n"
    if via_port:
        node_info["tail"] = "program"
        programs["tail"] = "MOV R0, ACC\nOUT ACC\n"
    return node_info, programs, k


def _gen_contended_in(seed):
    """Several lanes race IN for one input stream, with mixed sinks, each
    consumer then OUTs a lane tag (1000 + w): the reference's
    tests/test_cross_mode.py::gen_contended_in."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(-20, 20))
    n_workers = int(rng.integers(2, 5))
    node_info, programs = {}, {}
    uses_port = uses_stack = False
    for w in range(n_workers):
        sink = rng.choice(["out", "port", "stack"])
        lines = ["IN ACC", f"ADD {k}"]
        if sink == "out":
            lines.append("OUT ACC")
        elif sink == "port":
            lines.append("MOV ACC, tail:R0")
            uses_port = True
        else:
            lines.append("PUSH ACC, st")
            uses_stack = True
        lines.append(f"OUT {1000 + w}")
        node_info[f"w{w}"] = "program"
        programs[f"w{w}"] = "\n".join(lines)
    if uses_port:
        node_info["tail"] = "program"
        programs["tail"] = "MOV R0, ACC\nOUT ACC\n"
    if uses_stack:
        node_info["st"] = "stack"
        node_info["drain"] = "program"
        programs["drain"] = "POP st, ACC\nOUT ACC\n"
    return node_info, programs, k, n_workers


@pytest.mark.parametrize("seed", [0, 1])
def test_contended_multi_in_conservation(seed):
    """2-4 lanes race IN (reference :268): in both modes every input is
    consumed once (the value multiset) with one consumer-lane tag each."""
    node_info, programs, k, n_workers = _gen_contended_in(seed)
    inputs = chip_smoke.kahn_inputs(seed, offset=3000)
    expect_vals = sorted(v + k for v in inputs)
    valid_tags = set(range(1000, 1000 + n_workers))
    engine = chip_smoke.lockstep_outputs(node_info, programs, inputs, "cpu")
    cluster = chip_smoke.cluster_outputs(node_info, programs, inputs, 2 * len(inputs))
    for mode, outs in (("engine", engine), ("cluster", cluster)):
        assert sorted(o for o in outs if o < 1000) == expect_vals, (mode, outs)
        tags = [o for o in outs if o >= 1000]
        assert len(tags) == len(inputs) and set(tags) <= valid_tags, (mode, outs)


@pytest.mark.parametrize("seed", [0, 1])
def test_contended_multiset_equal(seed):
    """Lanes share a stack (reference :305): the engine's lowest-lane
    arbitration and the cluster's free-running races give the same output
    multiset."""
    node_info, programs, k = _gen_contended(seed)
    inputs = chip_smoke.kahn_inputs(seed, offset=2000)
    expect = sorted(v + k for v in inputs)
    engine = chip_smoke.lockstep_outputs(node_info, programs, inputs, "cpu")
    assert sorted(engine) == expect
    cluster = chip_smoke.cluster_outputs(node_info, programs, inputs, len(engine))
    assert sorted(cluster) == expect
