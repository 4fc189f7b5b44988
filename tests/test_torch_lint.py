"""The repo's own lint rules hold over the port: `python -m misaka_tpu.lint
--no-baseline misaka_tpu_torch chip_smoke.py` reports no finding (no
baseline either: the port starts clean and stays clean)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_has_no_lint_findings():
    out = subprocess.run(
        [sys.executable, "-m", "misaka_tpu.lint", "--no-baseline", "misaka_tpu_torch",
         "chip_smoke.py"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "lint: 0 new finding(s), 0 baselined" in out.stdout + out.stderr, out.stdout
