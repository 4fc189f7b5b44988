"""Bounded exponential backoff with jitter: the one retry-delay policy.

The port's own copy of misaka_tpu/utils/backoff.py (stdlib only: the
frontend supervisor and the HTTP client must never import torch).  Two
retry loops share the curve: the frontend supervisor respawning dead
workers (runtime/frontends.py) and the client riding out a server-restart
window (client.py); the compute plane's dial guard uses it too.

The policy: delay doubles from `base` up to `cap`, and every sleep is
jittered uniformly over [delay/2, delay] so a fleet of retriers
decorrelates instead of waking in lockstep.  No single sleep exceeds
`cap` seconds, so recovery latency after the peer returns is bounded.
"""

from __future__ import annotations

import random


class Backoff:
    """Stateful attempt counter over the shared delay curve; `delay_for`
    is the stateless form for callers that track their own streaks (the
    frontend supervisor's per-slot fast-crash counts)."""

    def __init__(self, base: float = 0.05, cap: float = 5.0,
                 factor: float = 2.0):
        if not (0 < base <= cap):
            raise ValueError(f"need 0 < base <= cap, got ({base}, {cap})")
        self.base = float(base)
        self.cap = float(cap)
        self.factor = float(factor)
        self.attempts = 0

    def delay_for(self, attempt: int) -> float:
        """The jittered sleep for a given zero-based attempt number."""
        delay = min(self.cap, self.base * self.factor ** max(0, attempt))
        return delay * (0.5 + 0.5 * random.random())

    def next_delay(self) -> float:
        """The next sleep in seconds (advances the attempt counter)."""
        delay = self.delay_for(self.attempts)
        self.attempts += 1
        return delay

    def reset(self) -> None:
        self.attempts = 0
