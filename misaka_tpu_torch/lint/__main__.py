"""CLI: `python -m misaka_tpu_torch.lint` — the port's lint entry point.

Exit codes: 0 clean (baselined findings allowed), 1 new findings,
2 engine/usage error.  Stale baseline entries print as warnings but do
not fail the run — paying down debt must never break the build that
paid it; `--update-baseline` rewrites the file (hand-edit the
justification comments back in afterward, or start from git diff).
"""

from __future__ import annotations

import argparse
import os
import sys

from misaka_tpu_torch.lint.checkers import ALL_CHECKERS, checker_for
from misaka_tpu_torch.lint.engine import (
    LintError,
    apply_baseline,
    format_findings,
    load_baseline,
    run_tree,
    save_baseline,
)

# What the port's lint run covers: the package and its chip smoke
# script.  tests/ are deliberately out — they monkeypatch, hold locks
# across helpers, and spin short-lived joined-in-fixture threads in
# shapes every rule here would (correctly, uselessly) flag.
DEFAULT_ROOTS = ("misaka_tpu_torch", "chip_smoke.py")

BASELINE_DEFAULT = os.path.join("misaka_tpu_torch", "lint", "baseline.txt")


def repo_base() -> str:
    # misaka_tpu_torch/lint/__main__.py -> the directory holding misaka_tpu_torch/
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m misaka_tpu_torch.lint",
        description="project static analysis (rules MSK001-MSK006)",
    )
    ap.add_argument("roots", nargs="*", default=None,
                    help=f"files/dirs to lint (default: {DEFAULT_ROOTS})")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: {BASELINE_DEFAULT})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from the current findings")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset (e.g. MSK001,MSK005)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for c in ALL_CHECKERS:
            print(f"{c.rule}  {c.summary}")
        return 0

    base = repo_base()
    roots = args.roots or [r for r in DEFAULT_ROOTS
                           if os.path.exists(os.path.join(base, r))]
    baseline_path = os.path.join(
        base, args.baseline if args.baseline else BASELINE_DEFAULT)

    try:
        checkers = ALL_CHECKERS if args.rules is None else tuple(
            checker_for(r.strip()) for r in args.rules.split(","))
        findings = run_tree(roots, checkers, base)
    except LintError as e:
        print(f"lint: {e}", file=sys.stderr)
        return 2

    if args.update_baseline:
        save_baseline(
            baseline_path, findings,
            header=("misaka lint baseline — pre-existing findings judged "
                    "intentional.\nEach entry should carry a justification "
                    "comment; see docs/STATIC_ANALYSIS.md."),
        )
        print(f"lint: wrote {len(findings)} fingerprints to "
              f"{os.path.relpath(baseline_path, base)}")
        return 0

    baseline = set() if args.no_baseline else load_baseline(baseline_path)
    new, suppressed, stale = apply_baseline(findings, baseline)

    if new:
        print(format_findings(new))
    for fp in sorted(stale):
        print(f"lint: warning: stale baseline entry (debt paid? remove the "
              f"line): {fp}", file=sys.stderr)
    print(f"lint: {len(new)} new finding(s), {len(suppressed)} baselined, "
          f"{len(stale)} stale baseline entr(ies) — "
          f"{len(ALL_CHECKERS if args.rules is None else checkers)} rule(s)",
          file=sys.stderr)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
