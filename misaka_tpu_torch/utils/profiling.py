"""torch.profiler integration: device-level tracing of the live device loop.

The port of misaka_tpu/utils/profiling.py, whose captures go through
jax.profiler.  Here a capture is a `torch.profiler.profile` session that
records CPU ops and, on the card, CUDA activity (kernels, copies) through
CUPTI, written as one Chrome trace (`trace.json`, loadable in Perfetto or
chrome://tracing) into the capture's directory.

Two surfaces, as in the reference:
  * `capture(log_dir)` -- context manager for scripts (records the caller's
    thread);
  * `Profiler` -- the start/stop handle behind POST /profile/start and
    /profile/stop (runtime/master.py), over a `LoopCapture`.  One capture
    at a time per process.

torch.profiler records the CPU ops of the thread that starts it (and the
tasks it hands to torch's own pools), not of other Python threads.  A
capture asked for by an HTTP handler thread would miss the device loop's
ops (feed, checks, clones, pack), so the server hands the session to
`LoopCapture`: the device-loop thread begins and ends it at an iteration
boundary.

On the card a capture requires CUDA activity: `start` raises ProfilerError
(409 on the route) and says why when CUPTI cannot record it, rather than
quietly writing a CPU-only trace.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from contextlib import contextmanager

import torch

TRACE_FILE = "trace.json"
_NULL = contextlib.nullcontext()


def mark(name: str):
    """A named range (record_function) in a capture that records this
    thread; otherwise a no-op that costs one thread-local check.  The
    serving path marks its phases with it: misaka.iteration (one device-loop
    iteration), misaka.feed_cut, misaka.feed, misaka.checks_clones,
    misaka.kernel_launch, misaka.pack and misaka.read."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


class ProfilerError(RuntimeError):
    pass


_cuda_probe: tuple[bool, str | None] | None = None
_probe_lock = threading.Lock()


def cuda_unavailable_reason() -> str | None:
    """None when torch.profiler records CUDA activity in this process;
    otherwise why not.  Probed once: a short capture around one kernel on
    the card must yield a device event."""
    global _cuda_probe
    with _probe_lock:
        if _cuda_probe is None:
            _cuda_probe = (True, None)
            if not torch.cuda.is_available():
                _cuda_probe = (False, "no CUDA device in this process")
            elif torch.profiler.ProfilerActivity.CUDA not in torch.profiler.supported_activities():
                _cuda_probe = (False, "this torch build's profiler has no CUDA activity (CUPTI)")
            else:
                try:
                    x = torch.ones(1024, device="cuda")
                    with torch.profiler.profile(activities=[
                            torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
                        (x * 2).sum().item()
                    if not any(e.device_type == torch.autograd.DeviceType.CUDA
                               for e in prof.events()):
                        _cuda_probe = (False, "CUPTI recorded no CUDA activity in a probe "
                                              "capture (profiling permissions or driver)")
                except Exception as e:  # CUPTI errors surface here
                    _cuda_probe = (False, f"CUDA activity cannot be recorded: {e}")
        return _cuda_probe[1]


class Session:
    """One capture into `log_dir`.  `begin` and `end` must run on the same
    thread: the one whose CPU ops are recorded."""

    def __init__(self, log_dir: str, cuda: bool):
        self.log_dir = log_dir
        self.cuda = cuda
        self.thread_id: int | None = None  # the recorded thread's native id (the trace's tid)
        self.error: BaseException | None = None
        self.ended = False
        self._prof = None

    @property
    def begun(self) -> bool:
        return self._prof is not None

    def begin(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        self._prof = prof
        self.thread_id = threading.get_native_id()

    def end(self) -> str:
        """Stop the capture and write the trace; returns log_dir."""
        if not self.ended:
            self.ended = True
            if self._prof is None:  # never began: an empty capture
                self.begin()
            self._prof.stop()
            os.makedirs(self.log_dir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(self.log_dir, TRACE_FILE))
        return self.log_dir


@contextmanager
def capture(log_dir: str, cuda: bool | None = None):
    """Capture a torch.profiler trace of the enclosed block (the caller's
    thread; CUDA activity on a card unless cuda=False) into `log_dir`."""
    if cuda is None:
        cuda = torch.cuda.is_available()
    if cuda:
        reason = cuda_unavailable_reason()
        if reason:
            raise ProfilerError(reason)
    s = Session(log_dir, cuda)
    s.begin()
    try:
        yield s
    finally:
        s.end()


class LoopCapture:
    """The hand-off between the thread that asks for a capture and the
    serving thread that records it (the master's device loop).

    The loop calls `service()` at every iteration boundary and
    `loop_exit()` when it stops; `begin`/`end` are called from any other
    thread.  A capture asked for while no loop runs begins when the loop
    next starts; a capture whose loop stops is ended (written) then."""

    def __init__(self, loop_alive, wake=lambda: None, timeout: float = 30.0):
        self._alive = loop_alive
        self._wake = wake
        self._timeout = timeout
        self._cond = threading.Condition()
        self._want: Session | None = None
        self._active: Session | None = None

    # --- the loop's side ---------------------------------------------------

    def pending(self) -> bool:
        return self._want is not self._active

    def service(self) -> None:
        with self._cond:
            want, active = self._want, self._active
            if want is active:
                return
            if active is not None:
                try:
                    active.end()
                except Exception as e:
                    active.error = e
                self._active = None
            if want is not None:
                try:
                    want.begin()
                    self._active = want
                except Exception as e:
                    want.error = e
                    self._want = None
            self._cond.notify_all()

    def loop_exit(self) -> None:
        with self._cond:
            if self._active is not None:
                try:
                    self._active.end()
                except Exception as e:
                    self._active.error = e
                if self._want is self._active:
                    self._want = None
                self._active = None
            self._cond.notify_all()

    # --- the asking side -----------------------------------------------------

    def _wait(self, done) -> None:
        deadline = time.monotonic() + self._timeout
        while not done() and self._alive():
            self._wake()
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise ProfilerError(f"the device loop did not reach an iteration "
                                    f"boundary within {self._timeout:.0f}s")
            self._cond.wait(min(0.1, remaining))

    def begin(self, session: Session) -> None:
        with self._cond:
            self._want = session
            self._wait(lambda: session.begun or session.error is not None)
            if session.error is not None:
                raise ProfilerError(f"profiler start failed: {session.error}")

    def end(self, session: Session) -> str:
        with self._cond:
            if self._want is session:
                self._want = None
            self._wait(lambda: session.ended or not session.begun)
            if session.error is not None:
                raise ProfilerError(f"profiler stop failed: {session.error}")
        # ended by the loop, or never begun (no loop ran): end() then
        # writes the (empty) capture on this thread
        return session.end()


# One capture at a time per process: the profiler's CUDA tracing is global.
_active_lock = threading.Lock()
_active: "Profiler | None" = None


class Profiler:
    """Start/stop handle over one capture at a time (process-wide); `host`
    (a LoopCapture) runs each session on the thread it records."""

    def __init__(self, host: LoopCapture):
        self._host = host
        self._session: Session | None = None
        self._started_mono: float | None = None

    def start(self, log_dir: str, cuda: bool = False) -> None:
        global _active
        with _active_lock:
            if _active is not None:
                other = _active._session
                raise ProfilerError(
                    f"a torch profiler capture is already running: writing to "
                    f"{other.log_dir} for {time.monotonic() - _active._started_mono:.0f}s"
                    f" -- POST /profile/stop to finish it first (one capture at a "
                    f"time per process)")
            if cuda:
                reason = cuda_unavailable_reason()
                if reason:
                    raise ProfilerError(f"profiling on the card needs CUDA activity: {reason}")
            session = Session(log_dir, cuda)
            self._host.begin(session)
            self._session = session
            self._started_mono = time.monotonic()
            _active = self

    def stop(self) -> str:
        """Stop the capture; returns the directory the trace was written
        to.  The handle resyncs even when writing fails."""
        global _active
        with _active_lock:
            if self._session is None:
                raise ProfilerError("profiler is not capturing")
            session, self._session = self._session, None
            self._started_mono = None
            if _active is self:
                _active = None
            return self._host.end(session)
