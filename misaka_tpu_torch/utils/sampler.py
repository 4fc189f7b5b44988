"""Always-on continuous profiler: a wall-clock stack sampler for the
whole process, served as flamegraph data at GET /debug/flamegraph.

The port's copy of misaka_tpu/utils/sampler.py (stdlib only).
utils/profiling.py answers what the card did during a window an operator
opened; this answers what the process is doing now and did over the last
minutes, with nobody having pressed record.  A daemon thread samples
every Python thread's stack ~67 times a second (``sys._current_frames``:
one dict snapshot, no tracing hooks) and aggregates the samples as folded
stacks (``root;child;leaf count``), keyed by thread name so the serving
tiers (the device loop, the batcher's workers, the HTTP handlers, the
plane's connections) read as separate roots.

Labels are cached per code object; a parked thread's fold is reused
through its leaf frame's identity; and a duty-cycle governor measures
each sample's wall cost and stretches the period to stay under
``MISAKA_SAMPLER_BUDGET`` (2%) of one core (the payload reports
``effective_hz`` next to ``rate_hz``).

Memory is bounded: at most ``MISAKA_SAMPLER_MAX_STACKS`` distinct stacks
(past the cap, ``(other)``), and every ``MISAKA_SAMPLER_DECAY_S`` seconds
all counts halve (below 1 an entry is pruned): an exponentially decayed
window over recent behaviour.

A sampler sees the threads CPython knows; the native host tier's C++
pool threads (core/native_serve.py) are invisible to it.  So while a pool
serves, the payload carries the pool's MEASURED per-thread busy/idle
nanosecond counters (``native_pool``, from
core/native_serve.pool_counters) next to the CPython aggregate, and
omits the key when no pool serves.

``GET /debug/flamegraph`` serves JSON ({folded, stacks, ...}); ``?html=1``
a self-contained viewer.  ``MISAKA_SAMPLER=0`` never starts the thread;
stop() and start() toggle it live.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

DEFAULT_HZ = 67.0  # ~15ms period; prime-ish vs common 10/100ms loops
# The duty-cycle budget: the fraction of one core the sampler may spend
# on itself.  A sample's cost is O(threads x stack depth) and a serving
# box can run hundreds of threads; an always-on profiler must never
# become the workload, so the loop measures its own per-sample cost and
# stretches the period to stay under budget (the nominal rate holds on
# normal thread counts; a pathological box samples slower, not harder).
DEFAULT_BUDGET = 0.02


class StackSampler:
    """The sampling thread + folded-stack aggregate."""

    def __init__(self, hz: float = DEFAULT_HZ, max_stacks: int = 4096,
                 decay_s: float = 120.0, budget: float = DEFAULT_BUDGET):
        self.hz = max(1.0, min(250.0, float(hz)))
        self.max_stacks = max(16, int(max_stacks))
        self.decay_s = max(1.0, float(decay_s))
        self.budget = min(0.5, max(0.001, float(budget)))
        self._cost_ema = 0.0  # EMA of one sample's wall seconds
        self._lock = threading.Lock()
        self._stacks: dict[str, float] = {}
        # code object -> "name (file.py)" label cache: the walk must be
        # allocation-free per frame — formatting per frame per sample was
        # measured as a double-digit-% GIL tax on a 100+-thread serving
        # box (the A/B gate caught it).  Keyed by the code object itself
        # (stable, hashable); labels carry no line number so one function
        # is one cache entry.
        self._labels: dict = {}
        # thread ident -> name, refreshed only when an unknown ident
        # appears (threading.enumerate is O(threads) per call)
        self._names: dict[int, str] = {}
        # thread ident -> (leaf frame, f_lasti, folded str): a PARKED
        # thread (socket recv, lock wait, queue get — most of a serving
        # box at any instant) keeps the same leaf frame object at the
        # same instruction between samples, so its fold is reusable with
        # two attribute reads instead of a full stack walk.  A running
        # thread advances f_lasti and misses the cache, which is exactly
        # the set worth walking.  Holding the leaf frame pins one popped
        # chain per thread for at most one period — replaced on miss,
        # pruned when the ident disappears.
        self._fold_cache: dict[int, tuple] = {}
        self._samples = 0
        self._started_mono: float | None = None
        self._last_decay = time.monotonic()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # --- lifecycle ----------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        if self.running:
            return
        self._stop.clear()
        self._started_mono = time.monotonic()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="misaka-sampler"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2)
        self._thread = None

    # --- the sampling loop --------------------------------------------------

    def _current_period(self) -> float:
        """The governed period: nominal 1/hz, stretched whenever one
        sample's measured cost would blow the duty-cycle budget."""
        return max(1.0 / self.hz, self._cost_ema / self.budget)

    def _loop(self) -> None:
        me = threading.get_ident()
        while not self._stop.wait(self._current_period()):
            t0 = time.perf_counter()
            try:
                self._sample_once(me)
            except Exception:  # pragma: no cover — a sampler crash must
                pass           # never take serving down with it
            dt = time.perf_counter() - t0
            self._cost_ema = (
                dt if self._cost_ema == 0.0
                else 0.8 * self._cost_ema + 0.2 * dt
            )

    def _sample_once(self, skip_ident: int) -> None:
        frames = sys._current_frames()
        labels = self._labels
        names = self._names
        cache = self._fold_cache
        folded: list[str] = []
        for ident, leaf in frames.items():
            if ident == skip_ident:
                continue  # the sampler must not profile itself
            lasti = leaf.f_lasti
            hit = cache.get(ident)
            if hit is not None and hit[0] is leaf and hit[1] == lasti:
                folded.append(hit[2])  # parked since last sample
                continue
            parts: list[str] = []
            frame = leaf
            depth = 0
            while frame is not None and depth < 64:
                code = frame.f_code
                label = labels.get(code)
                if label is None:
                    if len(labels) >= 32768:  # pathological code churn
                        labels.clear()
                    label = labels[code] = (
                        f"{code.co_name} "
                        f"({os.path.basename(code.co_filename)})"
                    )
                parts.append(label)
                frame = frame.f_back
                depth += 1
            name = names.get(ident)
            if name is None:
                self._names = names = {
                    t.ident: t.name for t in threading.enumerate()
                    if t.ident is not None
                }
                if ident not in names:
                    # cache the fallback too: a C-created thread running
                    # Python never registers with threading, and an
                    # uncached miss would rebuild the whole names dict
                    # on EVERY sample it is on-CPU
                    names[ident] = f"thread-{ident}"
                name = names[ident]
            parts.append(name)
            stack = ";".join(reversed(parts))
            cache[ident] = (leaf, lasti, stack)
            folded.append(stack)
        if len(cache) >= len(frames):
            # prune dead idents EVERY sample a dead entry exists (>=:
            # steady state is cache == frames - 1, the sampler's own
            # thread is sampled but never cached): a cached leaf frame
            # pins its whole chain (and every local in it) — an exited
            # worker's multi-MB locals must not live as long as the
            # always-on sampler does
            for ident in list(cache):
                if ident not in frames:
                    del cache[ident]
        now = time.monotonic()
        with self._lock:
            self._samples += 1
            for stack in folded:
                if stack in self._stacks:
                    self._stacks[stack] += 1
                elif len(self._stacks) < self.max_stacks:
                    self._stacks[stack] = 1
                else:
                    # cap reached: new stack shapes fold into one bucket
                    # (bounded memory beats completeness for an always-on
                    # profiler; decay frees slots over time)
                    self._stacks["(other)"] = \
                        self._stacks.get("(other)", 0) + 1
            if now - self._last_decay >= self.decay_s:
                self._last_decay = now
                for k in list(self._stacks):
                    half = self._stacks[k] / 2.0
                    if half < 1.0:
                        del self._stacks[k]
                    else:
                        self._stacks[k] = half

    # --- the read side ------------------------------------------------------

    def snapshot(self) -> tuple[dict[str, float], int]:
        with self._lock:
            return dict(self._stacks), self._samples

    @staticmethod
    def _fold(stacks: dict) -> str:
        return "\n".join(
            f"{stack} {int(round(count))}"
            for stack, count in sorted(
                stacks.items(), key=lambda kv: -kv[1]
            )
        )

    def folded(self) -> str:
        """The collapse-format text (``stack count`` per line) every
        flamegraph tool ingests (flamegraph.pl, speedscope, inferno)."""
        stacks, _ = self.snapshot()
        return self._fold(stacks)

    def payload(self) -> dict:
        stacks, samples = self.snapshot()
        out = {
            "enabled": True,
            "running": self.running,
            "rate_hz": self.hz,
            "effective_hz": round(1.0 / self._current_period(), 2),
            "budget": self.budget,
            "sample_cost_us": round(self._cost_ema * 1e6, 1),
            "samples": samples,
            "distinct_stacks": len(stacks),
            "max_stacks": self.max_stacks,
            "decay_s": self.decay_s,
            "uptime_s": round(
                time.monotonic() - self._started_mono, 3
            ) if self._started_mono is not None else 0.0,
            "stacks": {
                k: round(v, 2) for k, v in sorted(
                    stacks.items(), key=lambda kv: -kv[1]
                )
            },
            # folded from the SAME snapshot as "stacks" — a second
            # snapshot here could disagree with it mid-sample
            "folded": self._fold(stacks),
        }
        try:
            # the measured C++ split (None when no pool serves): "time in
            # the native pool" next to "time in CPython", one view
            from misaka_tpu_torch.core import native_serve

            pool = native_serve.pool_counters()
            if pool is not None:
                out["native_pool"] = pool
        except Exception:  # the payload must always answer
            pass
        return out


_lock = threading.Lock()
_sampler: StackSampler | None = None


def enabled(environ=os.environ) -> bool:
    return environ.get("MISAKA_SAMPLER", "1") != "0"


def get() -> StackSampler | None:
    return _sampler


def ensure_started(environ=os.environ) -> StackSampler | None:
    """Start (or return) the process-global sampler — called by
    make_http_server, so every serving process profiles itself from
    boot; library/test use never pays for a thread it didn't ask for.
    None when MISAKA_SAMPLER=0."""
    global _sampler
    if not enabled(environ):
        return None
    with _lock:
        if _sampler is None:
            try:
                hz = float(environ.get("MISAKA_SAMPLER_HZ", "") or DEFAULT_HZ)
            except ValueError:
                hz = DEFAULT_HZ
            try:
                max_stacks = int(
                    environ.get("MISAKA_SAMPLER_MAX_STACKS", "") or 4096
                )
            except ValueError:
                max_stacks = 4096
            try:
                decay_s = float(
                    environ.get("MISAKA_SAMPLER_DECAY_S", "") or 120.0
                )
            except ValueError:
                decay_s = 120.0
            try:
                budget = float(
                    environ.get("MISAKA_SAMPLER_BUDGET", "") or DEFAULT_BUDGET
                )
            except ValueError:
                budget = DEFAULT_BUDGET
            _sampler = StackSampler(
                hz=hz, max_stacks=max_stacks, decay_s=decay_s, budget=budget
            )
        if not _sampler.running:
            _sampler.start()
    return _sampler


def shutdown() -> None:
    """Stop the global sampler (tests; the A/B's off side)."""
    global _sampler
    with _lock:
        if _sampler is not None:
            _sampler.stop()
            _sampler = None


def debug_payload() -> dict:
    s = _sampler
    if s is None:
        return {
            "enabled": enabled(),
            "running": False,
            "stacks": {},
            "folded": "",
            "hint": "sampler not started (MISAKA_SAMPLER=0, or no HTTP "
                    "server in this process)",
        }
    return s.payload()


# --- the self-contained HTML viewer -----------------------------------------

_VIEWER = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>misaka flamegraph</title>
<style>
 body { font: 13px system-ui, sans-serif; margin: 16px; background: #fff; }
 h1 { font-size: 16px; } .meta { color: #555; margin-bottom: 8px; }
 .bar { height: 18px; margin-bottom: 10px; background: #eee; border-radius: 3px;
        overflow: hidden; max-width: 720px; }
 .bar > div { height: 100%%; background: #c0504d; float: left; }
 .frame { position: absolute; height: 17px; overflow: hidden;
          white-space: nowrap; font-size: 11px; line-height: 17px;
          border: 1px solid #fff; border-radius: 2px; cursor: default;
          text-overflow: ellipsis; padding: 0 2px; box-sizing: border-box; }
 #graph { position: relative; width: 100%%; }
</style></head><body>
<h1>misaka continuous profiler</h1>
<div class="meta" id="meta"></div>
<div class="meta" id="native"></div>
<div class="bar" id="nativebar" title="native pool busy fraction"></div>
<div id="graph"></div>
<script>
const DATA = %s;
const meta = document.getElementById('meta');
meta.textContent = `rate ${DATA.rate_hz} Hz | samples ${DATA.samples} | ` +
  `distinct stacks ${DATA.distinct_stacks} | decay ${DATA.decay_s}s`;
const np = DATA.native_pool;
if (np) {
  const frac = np.busy_fraction;
  const inline = np.caller_inline_ns || 0;
  document.getElementById('native').textContent =
    `native C++ pool: ${np.threads} threads, worker busy ` +
    `${(np.busy_ns/1e9).toFixed(2)}s + caller-inline ` +
    `${(inline/1e9).toFixed(2)}s vs idle ${(np.idle_ns/1e9).toFixed(2)}s ` +
    `(${(frac*100).toFixed(1)}%% busy)`;
  const fill = document.createElement('div');
  fill.style.width = (frac*100).toFixed(2) + '%%';
  document.getElementById('nativebar').appendChild(fill);
} else {
  document.getElementById('native').textContent =
    'native C++ pool: not serving';
  document.getElementById('nativebar').remove();
}
// Build a frame tree from the folded stacks and render it as nested
// proportional boxes (the flamegraph shape), depth growing downward.
const root = {name: 'all', value: 0, children: {}};
for (const [stack, count] of Object.entries(DATA.stacks)) {
  let node = root; root.value += count;
  for (const part of stack.split(';')) {
    if (!node.children[part])
      node.children[part] = {name: part, value: 0, children: {}};
    node = node.children[part];
    node.value += count;
  }
}
const ROW = 18, graph = document.getElementById('graph');
const palette = x => `hsl(${20 + 40 * x}, 70%%, 60%%)`;
let maxDepth = 0;
function render(node, x0, x1, depth) {
  maxDepth = Math.max(maxDepth, depth);
  let x = x0;
  const kids = Object.values(node.children)
    .sort((a, b) => b.value - a.value);
  for (const kid of kids) {
    const w = (x1 - x0) * kid.value / node.value;
    if (w > 0.0008) {
      const div = document.createElement('div');
      div.className = 'frame';
      div.style.left = (x * 100) + '%%';
      div.style.width = (w * 100) + '%%';
      div.style.top = (depth * ROW) + 'px';
      div.style.background = palette(Math.abs(
        kid.name.split('').reduce((h, c) => (h * 31 + c.charCodeAt(0)) %% 97, 7)
      ) / 97);
      div.textContent = kid.name;
      div.title = `${kid.name} — ${kid.value.toFixed(0)} samples ` +
        `(${(100 * kid.value / root.value).toFixed(1)}%% of all)`;
      graph.appendChild(div);
      render(kid, x, x + w, depth + 1);
    }
    x += w;
  }
}
if (root.value > 0) render(root, 0, 1, 0);
graph.style.height = ((maxDepth + 1) * ROW) + 'px';
</script></body></html>
"""


def render_html() -> str:
    """The GET /debug/flamegraph?html=1 body: the current payload baked
    into the self-contained viewer (no external assets)."""
    return _VIEWER % json.dumps(debug_payload())
