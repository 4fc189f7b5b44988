"""Service-objective specs: the MISAKA_SLO grammar.

The port's copy of the spec grammar of misaka_tpu/utils/slo.py
(`SLOSpecError`, `Objective`, `parse_spec`), comma-separated objectives::

    "p99<25ms,err<0.1%"

  * ``p<NN><T>``  latency: at most (100-NN)% of requests may exceed T
                  (units us, ms, s);
  * ``err<P%``    error rate: at most P% of requests may fail.

The program registry (runtime/registry.py) validates an upload's `slo`
field with it, so a malformed spec is the reference's 400, and stores a
good one in the version's metadata.  The burn-rate engine that would act
on it (sliding windows, the /healthz `slo` state) is not ported yet
(ROADMAP A.4): a stored spec stays inert.
"""

from __future__ import annotations

import re


class SLOSpecError(ValueError):
    """Malformed MISAKA_SLO / per-program objective spec."""


_LAT_RE = re.compile(r"^p(\d{1,2}(?:\.\d+)?)<(\d+(?:\.\d+)?)(us|ms|s)$")
_ERR_RE = re.compile(r"^err<(\d+(?:\.\d+)?)%$")
_UNIT = {"us": 1e-6, "ms": 1e-3, "s": 1.0}


class Objective:
    """One declared objective: a bad-event predicate + an error budget."""

    __slots__ = ("name", "kind", "quantile", "threshold_s", "budget")

    def __init__(self, name, kind, budget, quantile=None, threshold_s=None):
        self.name = name            # the spec text, e.g. "p99<25ms"
        self.kind = kind            # "latency" | "error"
        self.budget = budget        # allowed bad fraction, in (0, 1)
        self.quantile = quantile    # latency only: 0.99 for p99
        self.threshold_s = threshold_s  # latency only: seconds


def parse_spec(text: str) -> list[Objective]:
    """``"p99<25ms,err<0.1%"`` -> [Objective, ...] (raises SLOSpecError)."""
    objectives: list[Objective] = []
    for raw in (text or "").split(","):
        item = raw.strip()
        if not item:
            continue
        m = _LAT_RE.match(item)
        if m:
            q = float(m.group(1)) / 100.0
            if not 0.0 < q < 1.0:
                raise SLOSpecError(f"quantile out of range in {item!r}")
            threshold = float(m.group(2)) * _UNIT[m.group(3)]
            if threshold <= 0:
                raise SLOSpecError(f"threshold must be > 0 in {item!r}")
            objectives.append(Objective(item, "latency", budget=1.0 - q, quantile=q,
                                        threshold_s=threshold))
            continue
        m = _ERR_RE.match(item)
        if m:
            budget = float(m.group(1)) / 100.0
            if not 0.0 < budget < 1.0:
                raise SLOSpecError(f"error budget out of range in {item!r}")
            objectives.append(Objective(item, "error", budget=budget))
            continue
        raise SLOSpecError(
            f"cannot parse objective {item!r} (grammar: pNN<T[us|ms|s] or err<P%)"
        )
    return objectives
