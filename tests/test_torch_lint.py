"""The repo's own lint rules hold over the port, and the port's own linter
(misaka_tpu_torch/lint) is the reference's (misaka_tpu/lint).

- `python -m misaka_tpu.lint --no-baseline misaka_tpu_torch chip_smoke.py`
  and `python -m misaka_tpu_torch.lint` with its defaults (the port's tree,
  its empty baseline) both report no finding: the port starts clean and
  stays clean;
- the two linters give identical findings (rule, path, line, column,
  scope, message, fingerprint) over the reference's tree (misaka_tpu/,
  tools/, bench.py) with the reference's baseline, and over every seeded
  fixture of tests/test_lint.py (each rule's bad seeds and good twins), all
  checkers at once, and over an unparsable file;
- MSK001's lock registry derives from the port's own runtime/usage.py and
  utils/slo.py what it derives from the reference's;
- the port's CLI keeps the reference's exit codes (1 on a new finding, 0
  once baselined, 2 on a usage error).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest

import test_lint as reference_cases
from misaka_tpu import lint as jlint
from misaka_tpu.lint import engine as jengine
from misaka_tpu.lint.__main__ import BASELINE_DEFAULT as J_BASELINE
from misaka_tpu.lint.__main__ import DEFAULT_ROOTS as J_ROOTS
from misaka_tpu_torch import lint as tlint
from misaka_tpu_torch.lint import engine as tengine
from misaka_tpu_torch.lint.checkers import LockDiscipline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every seeded source of tests/test_lint.py: the bad seeds and their good twins
SEEDS = sorted(n for n in dir(reference_cases) if n.startswith(("BAD_MSK", "GOOD_MSK")))


def rows(findings):
    """Everything a finding carries, its fingerprint included, in order."""
    return [(*dataclasses.astuple(f), f.fingerprint) for f in findings]


def test_port_has_no_lint_findings():
    out = subprocess.run(
        [sys.executable, "-m", "misaka_tpu.lint", "--no-baseline", "misaka_tpu_torch",
         "chip_smoke.py"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "lint: 0 new finding(s), 0 baselined" in out.stdout + out.stderr, out.stdout


def test_port_linter_defaults_report_nothing():
    """`python -m misaka_tpu_torch.lint`: the port's roots, its baseline."""
    out = subprocess.run([sys.executable, "-m", "misaka_tpu_torch.lint"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout == ""
    assert "lint: 0 new finding(s), 0 baselined, 0 stale" in out.stderr, out.stderr
    assert "6 rule(s)" in out.stderr


def test_port_roots_and_baseline():
    from misaka_tpu_torch.lint.__main__ import BASELINE_DEFAULT, DEFAULT_ROOTS, repo_base

    assert DEFAULT_ROOTS == ("misaka_tpu_torch", "chip_smoke.py")
    assert repo_base() == ROOT
    assert tlint.load_baseline(os.path.join(ROOT, BASELINE_DEFAULT)) == set()


def test_linters_agree_on_the_reference_tree():
    roots = [r for r in J_ROOTS if os.path.exists(os.path.join(ROOT, r))]
    want = jlint.run_tree(roots, jlint.ALL_CHECKERS, base=ROOT)
    got = tlint.run_tree(roots, tlint.ALL_CHECKERS, base=ROOT)
    assert want, "the reference's tree has baselined findings"
    assert rows(got) == rows(want)
    baseline = jlint.load_baseline(os.path.join(ROOT, J_BASELINE))
    assert tlint.load_baseline(os.path.join(ROOT, J_BASELINE)) == baseline
    j_new, j_kept, j_stale = jengine.apply_baseline(want, baseline)
    t_new, t_kept, t_stale = tengine.apply_baseline(got, baseline)
    assert (rows(t_new), rows(t_kept), t_stale) == (rows(j_new), rows(j_kept), j_stale)
    assert tlint.format_findings(got) == jlint.format_findings(want)


@pytest.mark.parametrize("name", SEEDS)
def test_linters_agree_on_every_seed(name):
    """Each fixture under all six checkers at once: the same findings, and a
    bad seed's rule caught by the port's linter."""
    source = textwrap.dedent(getattr(reference_cases, name))
    want = jlint.run_source(source, jlint.ALL_CHECKERS)
    got = tlint.run_source(source, tlint.ALL_CHECKERS)
    assert rows(got) == rows(want)
    if name.startswith("BAD_"):
        assert name.split("_")[1] in {f.rule for f in got}


def test_linters_agree_on_an_unparsable_file(tmp_path):
    """A file that does not parse is one located MSK000 finding in both."""
    (tmp_path / "broken.py").write_text("def f(:\n    pass\n")
    want = jlint.run_tree(["broken.py"], jlint.ALL_CHECKERS, base=str(tmp_path))
    got = tlint.run_tree(["broken.py"], tlint.ALL_CHECKERS, base=str(tmp_path))
    assert [f.rule for f in got] == ["MSK000"]
    assert rows(got) == rows(want)


def test_port_msk001_registry_from_its_own_modules():
    """The port's usage ledger and SLO windows derive the acquirer sets the
    reference's test pins for the reference's modules."""
    checker = LockDiscipline()
    for rel, lock, expect_some in [
        ("misaka_tpu_torch/runtime/usage.py", "_lock", {"account", "snapshot", "reset"}),
        ("misaka_tpu_torch/utils/slo.py", "_lock", {"set_objectives", "_windows_for"}),
    ]:
        path = os.path.join(ROOT, rel)
        with open(path, encoding="utf-8") as fh:
            module = tengine.Module(path, rel, fh.read())
        reg = checker.module_locks(module)
        assert lock in reg, f"{rel}: module lock {lock} not derived"
        missing = expect_some - reg[lock]
        assert not missing, f"{rel}: {lock} acquirers missing {missing}"


def test_port_lint_cli_exit_codes(tmp_path):
    """1 on a fresh finding, 0 once it is baselined, 2 on an unknown rule."""
    victim = tmp_path / "victim.py"
    victim.write_text("import time\n\n\ndef f(s):\n    return time.time() - s\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    cmd = [sys.executable, "-m", "misaka_tpu_torch.lint", str(victim),
           "--baseline", str(tmp_path / "b.txt")]
    r1 = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=120)
    assert r1.returncode == 1, r1.stdout + r1.stderr
    assert "MSK005" in r1.stdout
    r2 = subprocess.run(cmd + ["--update-baseline"], capture_output=True, text=True,
                        env=env, timeout=120)
    assert r2.returncode == 0, r2.stdout + r2.stderr
    r3 = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=120)
    assert r3.returncode == 0, r3.stdout + r3.stderr
    r4 = subprocess.run(cmd + ["--rules", "MSK999"], capture_output=True, text=True,
                        env=env, timeout=120)
    assert r4.returncode == 2 and "unknown rule" in r4.stderr, r4.stdout + r4.stderr
