"""Project lint engine: the repo's recurring bug classes as machine checks.

The port's own copy of misaka_tpu/lint: the same rules, fingerprints,
inline disables, baseline format and exit codes, over the port's tree.
The reference's review history kept re-finding the same defect shapes —
lock self-deadlocks (twice in the usage and SLO modules, again in the
admission governor), `except OSError` around HTTP calls that raise
`http.client.HTTPException` (twice in the fleet), thread-per-close leaks
(the ComputePlane accept thread), unbounded client-minted metric labels
(until `metrics.capped_label`), wall-clock duration math, and keep-alive
desync on undrained POST bodies.  This package turns each of those into a
stdlib-only AST checker with a rule ID, so the PATTERN fails the lint run
the day it is reintroduced instead of costing another review round.

Rule catalog (docs/STATIC_ANALYSIS.md has the originating incidents):

  MSK001  lock-discipline   calling a function that acquires lock L while
                            lexically inside `with L:` (self-deadlock)
  MSK002  exception-breadth `except OSError` around post_form/urlopen/
                            getresponse sites (miss HTTPException); bare
                            `except:` anywhere
  MSK003  label-cardinality client-derived tenant/program metric labels
                            not laundered through metrics.capped_label
  MSK004  thread-lifecycle  threading.Thread neither daemonized nor
                            reachable from a join path
  MSK005  clock-discipline  time.time() arithmetic used as a duration
                            (must be time.monotonic())
  MSK006  handler-drain     POST route bodies answering an error before
                            consuming-or-closing the request body

Pre-existing, deliberate findings live in
misaka_tpu_torch/lint/baseline.txt (one fingerprint per line, `#`
justification comments; the port has none); NEW findings fail the run.
Entry point: `python -m misaka_tpu_torch.lint`.
"""

from misaka_tpu_torch.lint.engine import (  # noqa: F401
    Finding,
    LintError,
    Module,
    format_findings,
    load_baseline,
    run_source,
    run_tree,
    save_baseline,
)
from misaka_tpu_torch.lint.checkers import ALL_CHECKERS, checker_for  # noqa: F401
