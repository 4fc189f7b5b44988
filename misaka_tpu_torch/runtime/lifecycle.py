"""Process-lifecycle guards: no server may outlive its operator.

The port's own copy of misaka_tpu/runtime/lifecycle.py.  A forgotten
server holds the card (its CUDA context and the device loop) and its
HTTP port, so the app arms:

  * SIGTERM/SIGINT    -> stop the device loop, then exit 0 (130 for
                         SIGINT): the CUDA context and the socket are freed
  * atexit            -> the same stop on any normal interpreter exit
  * orphan watchdog   -> if the parent process dies (getppid() changes),
                         the server exits.  Opt out for deliberate daemons
                         with MISAKA_ORPHAN_OK=1; off when already
                         init-parented at startup (container PID 1)
  * MISAKA_TTL_S=N    -> stop + exit after N seconds no matter what
"""

from __future__ import annotations

import atexit
import logging
import os
import signal
import threading

_log = logging.getLogger("misaka_tpu_torch.lifecycle")
_POLL_S = 2.0


def arm_boot_handlers() -> None:
    """Provisional SIGTERM/SIGINT handlers for the boot window.

    Server entrypoints call this BEFORE their heavy torch imports: a signal
    that lands mid-boot must still exit clean (0 / 130) -- nothing holds the
    card yet, and the operator contract (TERM => orderly exit) starts at
    exec, not at "fully booted".  install_guards() replaces these with the
    stop-aware handlers once the node exists.
    """
    signal.signal(signal.SIGTERM, lambda *_: os._exit(0))
    signal.signal(signal.SIGINT, lambda *_: os._exit(130))


def install_guards(stop, environ=os.environ, start_ppid: int | None = None) -> None:
    """Arm all guards around `stop()` (idempotent, must tolerate re-entry).

    `stop` should halt device work (e.g. master.pause).  Exit paths call it
    and then leave via os._exit so a wedged device loop or a blocked
    serve_forever cannot keep the process (and the chip) alive anyway.

    `start_ppid` is the parent pid observed as early as possible in process
    startup (app.py captures it before the heavy torch imports): if the parent
    died during our multi-second boot, getppid() has already moved to the
    reaper and polling alone would never notice.
    """
    done = threading.Event()

    def stop_once() -> None:
        if done.is_set():
            return
        done.set()
        try:
            stop()
        except Exception as e:  # pragma: no cover — best-effort on the way out
            _log.warning("stop raised during shutdown: %s", e)

    def die(reason: str, code: int = 0) -> None:
        _log.info("exiting: %s", reason)
        stop_once()
        os._exit(code)

    # Signal handlers run on the main thread, which may be blocked inside
    # serve_forever — socketserver.shutdown() would deadlock there, so exit
    # via os._exit after stopping device work (the OS reclaims sockets).
    signal.signal(signal.SIGTERM, lambda *_: die("SIGTERM"))
    signal.signal(signal.SIGINT, lambda *_: die("SIGINT", code=130))
    atexit.register(stop_once)

    ttl = float(environ.get("MISAKA_TTL_S", "0") or 0)
    parent = start_ppid if start_ppid is not None else os.getppid()
    watch_orphan = parent > 1 and environ.get("MISAKA_ORPHAN_OK") != "1"

    if watch_orphan:
        # Kernel-level guard: SIGTERM on parent death (no polling, no race
        # once armed).  prctl only covers deaths AFTER the call, so recheck
        # getppid() for a parent that died during our slow boot.
        _arm_pdeathsig()
        if os.getppid() != parent:
            die(f"parent {parent} died during startup (orphan watchdog; "
                "set MISAKA_ORPHAN_OK=1 to daemonize)")

    if not (ttl or watch_orphan):
        return

    def watchdog() -> None:
        deadline = (ttl and (_now() + ttl)) or None
        while True:
            if done.wait(_POLL_S):
                return
            if watch_orphan and os.getppid() != parent:
                die(f"parent {parent} died (orphan watchdog; "
                    "set MISAKA_ORPHAN_OK=1 to daemonize)")
            if deadline and _now() > deadline:
                die(f"MISAKA_TTL_S={ttl:g} deadline reached")

    threading.Thread(target=watchdog, name="misaka-lifecycle", daemon=True).start()


def _arm_pdeathsig() -> None:
    """Linux PR_SET_PDEATHSIG: deliver SIGTERM when the parent dies."""
    try:
        import ctypes

        PR_SET_PDEATHSIG = 1
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(PR_SET_PDEATHSIG, signal.SIGTERM, 0, 0, 0)
    except Exception:  # pragma: no cover — polling watchdog still covers us
        pass


def _now() -> float:
    import time

    return time.monotonic()
