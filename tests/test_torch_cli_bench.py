"""`python -m misaka_tpu_torch bench`: the JAX CLI's add-2 throughput smoke
on the port's fused runner (misaka_tpu/__main__.py::cmd_bench).

On the CPU the run is the kernel's plain version; the state it leaves
equals, field by field (exact: every field is int32 or bool), what the JAX
package's `net.run` leaves from the same inputs.  The command keeps the
JAX CLI's arguments, its two checks with their messages and exit status 1,
and its last line; without a card and without `--device cpu` it raises
naming how to ask for the CPU.  The `cuda`-marked case runs the command on
the card (it skips here):

    python -m pytest --noconftest -m cuda tests/test_torch_cli_bench.py
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from misaka_tpu_torch import __main__ as tmain
from misaka_tpu_torch.core import fused

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bench_line(out: str) -> dict:
    lines = out.strip().splitlines()
    assert len(lines) == 1, out  # the bench prints its one JSON line, nothing else
    row = json.loads(lines[0])
    assert set(row) == {"metric", "value", "unit"}
    assert row["metric"] == "add2_cli_smoke" and row["unit"] == "inputs/sec"
    assert row["value"] > 0
    return row


def test_bench_on_the_cpu_prints_the_reference_line():
    out = subprocess.run(
        [sys.executable, "-m", "misaka_tpu_torch", "bench", "--device", "cpu", "--batch", "32",
         "--values", "8"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert out.returncode == 0, out.stderr
    bench_line(out.stdout)


def test_bench_state_equals_the_jax_run():
    """The port's bench path (bench_setup + fused_runner, elide_dead_hi off)
    against the JAX package's (compile(batch) + net.run), every field."""
    from misaka_tpu import networks as jnet
    from misaka_tpu_torch.core.state import state_to_numpy

    batch, per = 32, 8
    ticks = tmain.bench_ticks(per)
    net, state, vals = tmain.bench_setup(batch, per, "cpu")
    got = state_to_numpy(net.fused_runner(ticks, elide_dead_hi=False)(state))

    jnet_ = jnet.add2(in_cap=per, out_cap=per, stack_cap=16).compile(batch=batch)
    jstate = jnet_.init_state()._replace(in_buf=vals, in_wr=np.full((batch,), per, np.int32))
    want = jnet_.run(jstate, ticks)
    assert ticks == 14 * per + 64  # misaka_tpu/__main__.py::cmd_bench's
    for f in want._fields:
        w = np.asarray(getattr(want, f))
        assert got[f].dtype == w.dtype, f
        np.testing.assert_array_equal(got[f], w, err_msg=f)
    assert (got["out_wr"] == per).all()


def test_bench_leaves_the_kernel_count_alone_on_the_cpu(capsys):
    """On the CPU the plain version runs: no launch is counted."""
    before = dict(fused.launch_counts)
    assert tmain.main(["bench", "--device", "cpu", "--batch", "16", "--values", "4"]) == 0
    bench_line(capsys.readouterr().out)
    assert fused.launch_counts == before


def test_bench_short_of_outputs_exits_1(capsys, monkeypatch):
    """Too few ticks to retire every value: the reference's message, status 1."""
    monkeypatch.setattr(tmain, "bench_ticks", lambda per: 20)
    assert tmain.main(["bench", "--device", "cpu", "--batch", "16", "--values", "8"]) == 1
    cap = capsys.readouterr()
    assert cap.out == ""
    assert cap.err.startswith("error: only ") and cap.err.rstrip().endswith(
        "/8 outputs after 20 ticks")


def test_bench_wrong_outputs_exit_1(capsys, monkeypatch):
    """Outputs that are not the inputs plus 2: the reference's mismatch message."""
    setup = tmain.bench_setup

    def wrong_program(batch, per, device=None):
        net, state, vals = setup(batch, per, device)
        return net, state, vals + 1

    monkeypatch.setattr(tmain, "bench_setup", wrong_program)
    assert tmain.main(["bench", "--device", "cpu", "--batch", "16", "--values", "4"]) == 1
    cap = capsys.readouterr()
    assert cap.out == "" and cap.err == "error: output mismatch\n"


def test_bench_without_a_card_names_the_cpu_request(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    monkeypatch.delenv("MISAKA_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmain.main(["bench", "--batch", "16", "--values", "4"])
    out = subprocess.run(
        [sys.executable, "-m", "misaka_tpu_torch", "bench", "--batch", "16", "--values", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "MISAKA_DEVICE"},
    )
    assert out.returncode != 0
    assert "MISAKA_DEVICE=cpu" in out.stderr and out.stdout == ""


def test_bench_device_from_the_env(capsys, monkeypatch):
    """MISAKA_DEVICE=cpu stands for --device cpu, as for `debug`."""
    monkeypatch.setenv("MISAKA_DEVICE", "cpu")
    assert tmain.main(["bench", "--batch", "16", "--values", "4"]) == 0
    bench_line(capsys.readouterr().out)


@pytest.mark.cuda
def test_bench_on_the_card():
    """The command on the card: one build or load of the kernel, the
    warm-up and the timed run each one launch, the reference's line."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "misaka_tpu_torch", "bench"], cwd=ROOT, capture_output=True,
        text=True, timeout=600, env={k: v for k, v in os.environ.items()
                                     if k != "MISAKA_DEVICE"},
    )
    assert out.returncode == 0, out.stderr
    bench_line(out.stdout)
    before = fused.launch_counts[fused.KERNEL]
    assert tmain.main(["bench", "--device", "cuda", "--batch", "4096", "--values", "8"]) == 0
    assert fused.launch_counts[fused.KERNEL] - before == 2
