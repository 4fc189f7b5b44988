"""Stack autogrow in the port's master: the cases of tests/test_autogrow.py.

The reference's stacks are unbounded (intStack.go:9-45); a master with
static shapes parks a pusher on a full stack instead.  The port's device
loop, like the JAX master's, detects the wedge (a request in flight,
nothing moving, a stack at capacity) and doubles the capacity, padding
stack_mem with zeros, up to a byte budget.

The network is a reverser that needs depth len(values): push every value
until a 0 sentinel, then emit the sentinel and pop everything back out.
The port runs on the CPU here (the kernel's plain version); on the card the
same kernel serves the grown capacity, which it takes at run time.
"""

import threading
import time

import pytest
import torch

from misaka_tpu_torch.runtime import app
from misaka_tpu_torch.runtime.master import ComputeTimeout, MasterNode
from misaka_tpu_torch.runtime.topology import Topology

torch.set_num_threads(1)

REVERSER = (
    "top: IN ACC\n"
    "JEZ dump\n"
    "PUSH ACC, st\n"
    "JMP top\n"
    "dump: OUT ACC\n"
    "pop: POP st, ACC\n"
    "OUT ACC\n"
    "JMP pop\n"
)


def reverser_top(stack_cap=8):
    return Topology(node_info={"p": "program", "st": "stack"}, programs={"p": REVERSER},
                    in_cap=64, out_cap=64, stack_cap=stack_cap)


def _master(batch=1, **kw):
    return MasterNode(reverser_top(), chunk_steps=32, batch=batch, device="cpu", **kw)


def run_reverser(master, n=40, timeout=60.0):
    vals = list(range(1, n + 1))
    try:
        outs = master.compute_many(vals + [0], timeout=timeout)
    finally:
        master.pause()
    assert outs == [0] + vals[::-1]


def test_autogrow_one_instance():
    master = _master()
    master.run()
    try:
        run_reverser(master)
        # 8 -> >= 64 for depth 40, and the topology followed
        assert master._net.stack_cap >= 64
        assert master._topology.stack_cap == master._net.stack_cap
        assert master.status()["stack_cap"] == master._net.stack_cap
        assert master._state.stack_mem.shape[-1] == master._net.stack_cap
    finally:
        master.close()


def test_autogrow_batched():
    master = _master(batch=4)
    master.run()
    try:
        run_reverser(master, n=24)
        assert master._net.stack_cap >= 32
    finally:
        master.close()


def test_autogrow_disabled_stays_wedged():
    master = _master(stack_autogrow=False)
    master.run()
    try:
        with pytest.raises(ComputeTimeout):
            master.compute_many(list(range(1, 21)) + [0], timeout=1.0)
    finally:
        master.close()
    assert master._net.stack_cap == 8  # untouched


def test_autogrow_respects_budget():
    master = _master(stack_grow_max_bytes=8 * 4)  # one doubling exceeds it
    master.run()
    try:
        with pytest.raises(ComputeTimeout):
            master.compute_many(list(range(1, 21)) + [0], timeout=1.0)
        assert master._grow_blocked  # logged once, left parked
    finally:
        master.close()
    assert master._net.stack_cap == 8


def test_status_responsive_during_grow(monkeypatch):
    """The grow compiles the new network outside the state lock: /status
    stays responsive while it runs.  Compile time is simulated with a sleep
    in Topology.compile on the grow path only.  A grow under the lock
    blocks one poll for the whole simulated compile, so the trip-wire is a
    fraction of that compile (as tests/test_autogrow.py's), not a fixed
    wall-clock number that a loaded box could cross."""
    real_compile = Topology.compile
    grew = threading.Event()
    SIM_COMPILE_S = 3.0

    def slow_compile(self, *a, **k):
        if self.stack_cap > 8:
            grew.set()
            time.sleep(SIM_COMPILE_S)
        return real_compile(self, *a, **k)

    master = _master()
    monkeypatch.setattr(Topology, "compile", slow_compile)
    latencies, errors = [], []
    stop = threading.Event()

    def poll_status():
        try:
            while not stop.is_set():
                t0 = time.monotonic()
                assert "stack_cap" in master.status()
                latencies.append(time.monotonic() - t0)
                time.sleep(0.02)
        except Exception as e:  # recorded and failed below
            errors.append(e)

    poller = threading.Thread(target=poll_status)
    try:
        master.run()
        poller.start()
        run_reverser(master, n=20, timeout=90)
    finally:
        stop.set()
        poller.join(10)
        master.close()
    assert not poller.is_alive() and not errors, errors
    assert grew.is_set() and master._net.stack_cap >= 32
    worst = max(latencies)
    assert worst < 0.5 * SIM_COMPILE_S, f"status blocked {worst:.2f}s during grow"


def test_restore_pads_pre_grow_snapshot():
    master = _master()
    master.run()
    try:
        snap = master.snapshot()  # stack_cap=8 shapes
        run_reverser(master)      # grows to >= 64
        grown = master._net.stack_cap
        master.restore(snap)      # padded, not refused
        assert master._state.stack_mem.shape[-1] == grown
        assert torch.equal(master._state.stack_mem[..., :8], snap.stack_mem)
        master.run()
        run_reverser(master, n=4)  # the restored state serves
    finally:
        master.close()


def test_restore_rejects_true_shape_mismatch():
    m1 = _master()
    m2 = MasterNode(
        Topology(node_info={"a": "program", "b": "program"},
                 programs={"a": "IN ACC\nOUT ACC", "b": "NOP"},
                 in_cap=64, out_cap=64, stack_cap=8),
        chunk_steps=32, device="cpu",
    )
    with pytest.raises(ValueError, match="snapshot shapes"):
        m1.restore(m2.snapshot())


def test_autogrow_not_triggered_by_starvation():
    # a stalled request whose stacks are not full (a sink that never emits)
    sink = Topology(node_info={"p": "program"}, programs={"p": "top: IN ACC\nJMP top"},
                    in_cap=8, out_cap=8, stack_cap=8)
    master = MasterNode(sink, chunk_steps=16, device="cpu")
    master.run()
    try:
        with pytest.raises(ComputeTimeout):
            master.compute_many([1, 2], timeout=1.0)
    finally:
        master.close()
    assert master._net.stack_cap == 8


@pytest.mark.parametrize("env,grow", [({}, True), ({"MISAKA_STACK_AUTOGROW": "0"}, False)])
def test_app_env_switches_autogrow(env, grow):
    m = app.build_master_from_env({
        "NODE_INFO": '{"p": {"type": "program"}, "st": {"type": "stack"}}',
        "MISAKA_PROGRAMS": '{"p": "IN ACC\\nOUT ACC"}',
        "MISAKA_BATCH": "1", "MISAKA_DEVICE": "cpu", **env,
    })
    assert m._grow is grow
