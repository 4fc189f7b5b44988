"""In-process collectives over the `model` axis of a lane-sharded mesh.

The reference's lane-sharded steps (its parallel/routed.py and sharded.py)
run under `shard_map` and agree through `lax.pmin`, `lax.psum` and
`lax.all_gather` over the `model` mesh axis, inside one process: the lane
axis never crosses a process (its multihost.py:11-16).  The port writes each
shard's step once, SPMD, against an `Axis` member with `index`, `size`,
`pmin`, `psum` and `all_gather`; core/routing.py's `axis=None` is one
device, with no member at all.

The binding: a shard's step is a generator that yields at each collective
(`keys = yield from axis.pmin(keys)`).  One thread drives every shard of the
mesh (`drive`): it advances each shard to its next collective in turn,
issuing that shard's torch ops on its device's current stream; when every
shard of a data row has reached the collective, it does the reduction once,
on the row's first device, and resumes each shard with the result (on the
shard's own device: a copy when the devices differ).  On one card every
shard's work goes to that card's one stream in the order it was issued, so
no shard reads another's tensor before it is written and no event is
needed; across cards torch's copies order the two devices' streams.  One
thread rather than one per shard: torch gives up and takes back the
interpreter lock around every op, so shard threads contend for it on every
op, and then each op costs several times what it costs one thread.

The reductions are integer min, integer sum and concatenation: exact, and
the same whatever order the shards arrive in.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Collective(NamedTuple):
    """What a shard's step yields at a collective."""

    op: str             # "pmin" | "psum" | "all_gather"
    x: torch.Tensor
    dim: int = 0        # all_gather's concatenation dimension


class Axis:
    """One shard's view of the `model` axis (the port's `lax.axis_index`
    and its collectives).  Each collective is a generator: `y = yield from
    axis.pmin(x)` inside a step that `drive` runs."""

    def __init__(self, index: int, size: int):
        if not 0 <= index < size:
            raise ValueError(f"member {index} of an axis of {size}")
        self.index = index
        self.size = size

    def pmin(self, x: torch.Tensor):
        """Elementwise minimum over the members."""
        return (yield Collective("pmin", x))

    def psum(self, x: torch.Tensor):
        """Elementwise sum over the members, in x's dtype (int32 wraps)."""
        return (yield Collective("psum", x))

    def all_gather(self, x: torch.Tensor, dim: int = 0):
        """The members' x concatenated along `dim` in member order (jax's
        all_gather with `tiled=True`)."""
        return (yield Collective("all_gather", x, dim))


def finish(gen):
    """The value of a step generator that reaches no collective (a step
    run with axis=None)."""
    try:
        request = next(gen)
    except StopIteration as done:
        return done.value
    gen.close()
    raise RuntimeError(f"a one-device step reached a collective ({request.op})")


def _combine(requests: list[Collective]) -> torch.Tensor:
    op, dim = requests[0].op, requests[0].dim
    if any(r.op != op or r.dim != dim for r in requests):
        raise RuntimeError(f"shards of one row reached different collectives: "
                           f"{[r.op for r in requests]}")
    dev = requests[0].x.device
    xs = [r.x.to(dev) for r in requests]
    if len(xs) == 1:
        return xs[0]
    if op == "pmin":
        return torch.stack(xs).amin(dim=0)
    if op == "psum":
        return torch.stack(xs).sum(dim=0, dtype=xs[0].dtype)
    if op == "all_gather":
        return torch.cat(xs, dim=dim)
    raise RuntimeError(f"unknown collective {op!r}")


def drive(gens: list, size: int) -> list:
    """Run the step generators of every shard of a mesh (row-major, rows of
    `size` shards) to their ends, meeting at each collective; returns each
    generator's value.  A shard that ends while a row-mate waits at a
    collective, or that raises, ends the run with an error."""
    n = len(gens)
    results: list = [None] * n
    sends: list = [None] * n
    live = list(range(n))
    while live:
        waiting = {}
        for i in live:
            try:
                waiting[i] = gens[i].send(sends[i])
            except StopIteration as done:
                results[i] = done.value
        if not waiting:
            break
        for row in sorted({i // size for i in waiting}):
            members = range(row * size, (row + 1) * size)
            if any(i not in waiting for i in members):
                raise RuntimeError(f"row {row}: a shard ended while the others wait "
                                   "at a collective")
            result = _combine([waiting[i] for i in members])
            for i in members:
                sends[i] = result.to(waiting[i].x.device)
        live = sorted(waiting)
    return results
