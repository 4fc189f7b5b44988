"""The port's debugger and CLI answer as misaka_tpu's.

tests/test_debug.py's cases, each on the JAX `Debugger` and the port's
`Debugger(device="cpu")` from the same inputs: breakpoint hits, the tick
count, outputs, `inspect` (full 64-bit registers), `stacks`, `listing`,
`history` and the errors, every answer equal (exact).  The CLI's check,
disasm and scripted debug sessions print what the JAX CLI prints (the
debugger's banner names its package), and a compose file on a host
without PyYAML exits with status 2.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from misaka_tpu import networks as jnet
from misaka_tpu.__main__ import main as jcli
from misaka_tpu.debug import Debugger as JDebugger
from misaka_tpu.runtime.topology import Topology as JTopology
from misaka_tpu_torch import networks as tnet
from misaka_tpu_torch.__main__ import main as tcli
from misaka_tpu_torch.debug import Debugger as TDebugger
from misaka_tpu_torch.runtime.topology import Topology as TTopology

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPS = dict(in_cap=8, out_cap=8, stack_cap=8)


@pytest.fixture()
def dbgs():
    return JDebugger(jnet.add2(**CAPS)), TDebugger(tnet.add2(**CAPS), device="cpu")


def both(dbgs, call):
    """call(debugger) on both; the answers must be equal."""
    want, got = (call(d) for d in dbgs)
    assert got == want
    return got


def test_breakpoint_stops_at_line(dbgs):
    both(dbgs, lambda d: d.feed([5]))
    both(dbgs, lambda d: d.add_breakpoint("misaka2", 2))
    assert both(dbgs, lambda d: d.run(max_ticks=100)) == [("misaka2", 2)]
    info = both(dbgs, lambda d: d.inspect("misaka2"))
    assert (info["acc"], info["pc"]) == (7, 2)


def test_step_through_completion(dbgs):
    both(dbgs, lambda d: d.feed([1]))
    assert both(dbgs, lambda d: d.step(40)) == []
    assert both(dbgs, lambda d: d.tick) == 40
    assert both(dbgs, lambda d: d.outputs()) == [3]


def test_inspect_ports_and_stacks(dbgs):
    both(dbgs, lambda d: d.feed([9]))
    both(dbgs, lambda d: d.add_breakpoint("misaka2", 3))
    both(dbgs, lambda d: d.run(max_ticks=100))
    assert both(dbgs, lambda d: d.stacks()) == {"misaka3": [11]}
    for lane in ("misaka1", "misaka2"):
        info = both(dbgs, lambda d: d.inspect(lane))
        assert set(info) == {"acc", "bak", "pc", "ports", "holding", "hold_val", "retired"}


def test_listing_shows_cursor_and_breakpoint(dbgs):
    both(dbgs, lambda d: d.add_breakpoint("misaka1", 2))
    lines = both(dbgs, lambda d: d.listing("misaka1")).split("\n")
    assert lines[0].startswith("-> ") and lines[2].startswith("  B")
    both(dbgs, lambda d: d.feed([3]))
    both(dbgs, lambda d: d.step(3))
    both(dbgs, lambda d: d.listing("misaka2"))


@pytest.mark.parametrize("last", [None, 1, 5])
def test_history_listing(dbgs, last):
    both(dbgs, lambda d: d.feed([4, 6]))
    both(dbgs, lambda d: d.step(10))
    hist = both(dbgs, lambda d: d.history(last=last))
    assert "misaka1" in hist and "pc=" in hist


def test_reset(dbgs):
    both(dbgs, lambda d: d.feed([1]))
    both(dbgs, lambda d: d.step(10))
    both(dbgs, lambda d: d.reset())
    assert both(dbgs, lambda d: d.tick) == 0
    assert both(dbgs, lambda d: d.inspect("misaka1"))["acc"] == 0
    assert both(dbgs, lambda d: d.history()) == ""


def test_bad_lane_and_line(dbgs):
    for call, err in ((lambda d: d.inspect("nope"), KeyError),
                      (lambda d: d.add_breakpoint("misaka1", 99), ValueError),
                      (lambda d: d.add_breakpoint("misaka1", -1), ValueError)):
        msgs = []
        for d in dbgs:
            with pytest.raises(err) as e:
                call(d)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_inspect_shows_64_bit_registers():
    """overflow64 carries ACC past 2^31: inspect reads the full register."""
    with open(os.path.join(ROOT, "examples", "overflow64.json")) as f:
        text = f.read()
    dbgs = (JDebugger(JTopology.from_json(text, **CAPS)),
            TDebugger(TTopology.from_json(text, **CAPS), device="cpu"))
    both(dbgs, lambda d: d.feed([2**31 - 1, 2**31 - 1, 5]))
    lanes = list(TTopology.from_json(text).lane_ids())
    wide = []
    for _ in range(8):
        both(dbgs, lambda d: d.step(7))
        for lane in lanes:
            wide.append(both(dbgs, lambda d: d.inspect(lane))["acc"])
    assert any(abs(v) >= 2**31 for v in wide)
    both(dbgs, lambda d: d.outputs())
    both(dbgs, lambda d: d.history(last=4))


@pytest.mark.parametrize("name", ["sorter", "mesh8", "ring4"])
def test_session_on_other_networks(name):
    dbgs = (JDebugger(jnet.BASELINE_CONFIGS[name](**CAPS)),
            TDebugger(tnet.BASELINE_CONFIGS[name](**CAPS), device="cpu"))
    lanes = list(tnet.BASELINE_CONFIGS[name]().lane_ids())
    both(dbgs, lambda d: d.feed([3, -4, 0, 9]))
    both(dbgs, lambda d: d.add_breakpoint(lanes[-1], 1))
    for _ in range(4):
        both(dbgs, lambda d: d.run(max_ticks=60))
        both(dbgs, lambda d: [d.inspect(lane) for lane in lanes])
    both(dbgs, lambda d: d.clear_breakpoints())
    both(dbgs, lambda d: d.step(100))
    both(dbgs, lambda d: (d.outputs(), d.stacks(), d.tick, d.history(last=3)))


# --- CLI ---------------------------------------------------------------------


def cli_both(capsys, argv):
    """Run both CLIs; returns (status, stdout) after checking they agree."""
    outs = []
    for main in (jcli, tcli):
        rc = main(list(argv))
        outs.append((rc, capsys.readouterr().out))
    assert outs[1] == outs[0]
    return outs[1]


@pytest.mark.parametrize("name", sorted(tnet.BASELINE_CONFIGS))
def test_cli_check_and_disasm_match_jax(capsys, name):
    rc, out = cli_both(capsys, ["check", name])
    assert rc == 0 and out.startswith("ok: ")
    rc, out = cli_both(capsys, ["disasm", name])
    assert rc == 0 and out.startswith("# --- ")


def test_cli_check_files_match_jax(tmp_path, capsys):
    spec = {"nodes": {"a": "program"}, "programs": {"a": "IN ACC\nOUT ACC"}}
    path = tmp_path / "net.json"
    path.write_text(json.dumps(spec))
    assert cli_both(capsys, ["check", str(path)]) == (0, "ok: 1 program node(s), "
                                                         "0 stack node(s)\n  a: 2 line(s)\n")
    assert cli_both(capsys, ["check", "/nonexistent.json"])[0] == 1
    capsys.readouterr()


DEBUG_SCRIPT = "\n".join([
    "help", "feed 5", "break misaka2 2", "run", "print misaka2", "stacks", "list misaka1",
    "out", "step 100", "out", "trace 4", "break nope 1", "print", "bogus", "clear",
    "feed 1 2", "step", "step 3", "reset", "print misaka1", "quit",
])


def test_cli_debug_scripted_matches_jax():
    """The interactive debugger driven through a pipe: every line after the
    banner equals the JAX CLI's."""
    env = {"PYTHONPATH": ROOT, "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
           "HOME": os.environ.get("HOME", ROOT), "MISAKA_DEVICE": "cpu",
           "OMP_NUM_THREADS": "1"}
    outs = []
    for pkg in ("misaka_tpu", "misaka_tpu_torch"):
        proc = subprocess.run([sys.executable, "-m", pkg, "debug", "add2"], input=DEBUG_SCRIPT,
                              capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
        assert proc.returncode == 0, proc.stderr
        banner, rest = proc.stdout.split("\n", 1)
        assert banner.startswith(f"{pkg} debugger — lanes: misaka1, misaka2")
        outs.append(rest)
    assert outs[1] == outs[0]
    assert "BREAK [('misaka2', 2)]" in outs[1] and '"acc": 7' in outs[1] and "[7]" in outs[1]


@pytest.mark.parametrize("argv,why", [
    (["check", "deploy.yml"], "PyYAML"), (["disasm", "deploy.yaml"], "PyYAML"),
    (["debug", "deploy.yml", "--device", "cpu"], "PyYAML")],
    ids=["argv1-A.10", "argv2-A.10", "argv3-A.10"])
def test_cli_unported_commands_exit_2(capsys, monkeypatch, tmp_path, argv, why):
    """The CLI leftovers (ROADMAP A.10) answer status 2 where this host
    cannot serve them: a compose file (the repo's deploy/docker-compose.yml)
    on a host without PyYAML (hidden here).  No command exits 2 for want of
    a port: `bench` runs (tests/test_torch_cli_bench.py)."""
    argv = list(argv)
    for i, a in enumerate(argv):
        if a.startswith("deploy."):
            argv[i] = str(tmp_path / a)
            shutil.copy(os.path.join(ROOT, "deploy", "docker-compose.yml"), argv[i])
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert tcli(argv) == 2
    err = capsys.readouterr().err
    assert err.startswith("error: ") and why in err


ADD2_COMPOSE = """services:
  misaka1:
    environment:
      NODE_TYPE: program
      PROGRAM: |
        IN ACC
        ADD 1
        MOV ACC, misaka2:R0
        MOV R0, ACC
        OUT ACC
  misaka2:
    environment:
      NODE_TYPE: program
      PROGRAM: |
        MOV R0, ACC
        ADD 1
        PUSH ACC, misaka3
        POP misaka3, ACC
        MOV ACC, misaka1:R0
  misaka3:
    environment:
      NODE_TYPE: stack
"""


def test_cli_replay_and_usage_report_run(capsys, tmp_path, monkeypatch):
    """The two commands of the telemetry planes, served since the planes
    were ported: `replay` drives an exported segment green on the CPU (a
    compose candidate too, refused with status 2 without PyYAML), and
    `usage-report` verifies the signed export and prints the totals the
    JAX CLI prints for the same server."""
    import threading

    from misaka_tpu_torch.runtime import capture
    from misaka_tpu_torch.runtime import master as tmaster

    monkeypatch.setenv("MISAKA_USAGE_SECRET", "k")
    # a server starts the process-wide sampler, TSDB and watchdog, which
    # would outlive the test
    for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG"):
        monkeypatch.setenv(switch, "0")
    m = tmaster.MasterNode(tnet.add2(in_cap=8, out_cap=8, stack_cap=8), chunk_steps=16,
                           batch=2, device="cpu")
    httpd = tmaster.make_http_server(m, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    m.run()
    try:
        capture.start(anchors={"default": capture.anchor_from_master("default", m)})
        for v in range(3):
            assert m.compute_coalesced([v]) == [v + 2]
            capture.note("http", program=None, trace=None, inbound=False,
                         vals=bytes([v, 0, 0, 0]), resp=bytes([v + 2, 0, 0, 0]), status=200,
                         tick=0)
        capture.stop()
        seg = capture.export(str(tmp_path / "cli.mskcap"))["path"]
        capsys.readouterr()
        assert tcli(["replay", seg, "--device", "cpu"]) == 0
        assert capsys.readouterr().out == "default: replay green — 3 requests byte-for-byte identical\n"
        # a compose candidate (runtime/compose.py): the same add2 network
        # replays green; without PyYAML it is refused with status 2
        yml = tmp_path / "new.yml"
        yml.write_text(ADD2_COMPOSE)
        assert tcli(["replay", seg, "--candidate", str(yml), "--device", "cpu"]) == 0
        capsys.readouterr()
        monkeypatch.setitem(sys.modules, "yaml", None)
        assert tcli(["replay", seg, "--candidate", str(yml), "--device", "cpu"]) == 2
        assert "PyYAML" in capsys.readouterr().err
        reports = []
        for cli in (tcli, jcli):
            assert cli(["usage-report", "--url", base, "--secret", "k"]) == 0
            reports.append(json.loads(capsys.readouterr().out))
        assert reports[0] == reports[1] and reports[0]["verified"] is True
        assert reports[0]["programs"]["default"]["requests"] >= 3
        assert tcli(["usage-report", "--url", base, "--secret", "wrong"]) == 1
        assert "failed HMAC verification" in capsys.readouterr().err
    finally:
        capture.configure()
        httpd.shutdown()
        m.close()
