"""Append-only segment spool: the durability primitive under the
telemetry planes (TSDB retention in utils/tsdb.py, the usage ledger in
runtime/usage.py).

The port's copy of misaka_tpu/utils/spool.py, with the same framing, so
a segment written by either package reads back in the other
(tests/test_torch_spool.py).  A spool is a directory of numbered segment
files, each MAGIC (8 bytes) followed by u32-LE length-prefixed JSON
frames: the .mskcap framing without the manifest sidecar, because a
spool's tail is a live append target.  The writer appends frames and
fsyncs on flush(); a crash mid-append leaves at most one torn frame at
the tail, which reload() truncates away before appending after it.

Rotation and retention: past ``segment_bytes`` the writer rolls to the
next sequence number; past ``budget_bytes`` the oldest segments are
unlinked first, each reported through the caller's ``on_evict`` (and a
failed write through ``on_error``).

One thread appends (the TSDB collector, or the usage flusher).  Readers
(an export's walk, the boot reload) stop at the first torn frame instead
of raising.  Stdlib only.
"""

from __future__ import annotations

import json
import logging
import os
import struct

from misaka_tpu_torch.utils import metrics

log = logging.getLogger("misaka_tpu_torch.spool")

# One shared error family across every spooling plane (TSDB retention,
# the usage ledger, capture rotation) — the watchdog's spool-health rule
# watches this name.
M_SPOOL_ERRORS = metrics.counter(
    "misaka_spool_errors_total",
    "Telemetry spool write/read failures, by plane",
    ("plane",),
)

MAGIC = b"MSKSPL1\n"
_LEN = struct.Struct("<I")
_MAX_FRAME = 64 << 20

DEFAULT_SEGMENT_BYTES = 4 << 20


class SpoolError(Exception):
    """Unusable spool directory or malformed segment content."""


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class SegmentSpool:
    """One spool directory: numbered ``<prefix>-<seq>.seg`` segments."""

    def __init__(self, directory: str, prefix: str = "spool", *,
                 budget_bytes: int = 64 << 20,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 on_evict=None, on_error=None):
        self.dir = directory
        self.prefix = prefix
        self.budget_bytes = max(1 << 16, int(budget_bytes))
        self.segment_bytes = max(1 << 12, int(segment_bytes))
        self._on_evict = on_evict or (lambda n: None)
        self._on_error = on_error or (lambda: None)
        self._fd = None
        self._active_seq = -1
        self._active_bytes = 0
        self._next_seq = 0
        self.evicted = 0
        self.errors = 0

    # --- layout -------------------------------------------------------------

    def _path(self, seq: int) -> str:
        return os.path.join(self.dir, f"{self.prefix}-{seq:08d}.seg")

    def segments(self) -> list[tuple[int, str]]:
        """[(seq, path)] sorted oldest-first (missing dir -> [])."""
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        want = f"{self.prefix}-"
        for name in names:
            if not (name.startswith(want) and name.endswith(".seg")):
                continue
            try:
                seq = int(name[len(want):-len(".seg")])
            except ValueError:
                continue
            out.append((seq, os.path.join(self.dir, name)))
        out.sort()
        return out

    def disk_bytes(self) -> int:
        total = 0
        for _, path in self.segments():
            try:
                total += os.path.getsize(path)
            except OSError:
                pass
        return total

    # --- reload (boot) ------------------------------------------------------

    def reload(self, fn=None) -> int:
        """Walk every retained frame oldest-first, truncating torn tails
        in place, then position the writer after the newest frame.
        ``fn(frame_dict)`` per frame; returns frames seen.  Unreadable
        segments are counted + skipped, never fatal — a booting server
        must come up even over a mangled spool."""
        os.makedirs(self.dir, exist_ok=True)
        frames = 0
        segs = self.segments()
        for seq, path in segs:
            self._next_seq = max(self._next_seq, seq + 1)
            try:
                frames += self._walk_one(path, fn, repair=True)
            except (OSError, SpoolError) as e:
                log.warning("spool %s: skipping unreadable segment %s: %s",
                            self.prefix, path, e)
                self._record_error()
        # keep appending to the newest segment when it has headroom
        if segs:
            seq, path = segs[-1]
            try:
                size = os.path.getsize(path)
            except OSError:
                size = self.segment_bytes
            if 0 < size < self.segment_bytes:
                try:
                    self._fd = open(path, "ab")
                    self._active_seq = seq
                    self._active_bytes = size
                except OSError as e:
                    log.warning("spool %s: cannot reopen %s: %s",
                                self.prefix, path, e)
                    self._record_error()
        return frames

    def _walk_one(self, path: str, fn, repair: bool) -> int:
        """Frames of one segment; with ``repair`` a torn tail is
        truncated away in place (crash recovery), without it the walk
        just stops there (a reader racing the live appender)."""
        frames = 0
        with open(path, "r+b" if repair else "rb") as f:
            magic = f.read(len(MAGIC))
            if magic != MAGIC:
                raise SpoolError(f"bad magic {magic!r}")
            good = f.tell()
            while True:
                raw = f.read(4)
                if not raw:
                    break
                if len(raw) < 4:
                    self._truncate_tail(f, path, good, repair)
                    break
                (length,) = _LEN.unpack(raw)
                if length > _MAX_FRAME:
                    self._truncate_tail(f, path, good, repair)
                    break
                blob = f.read(length)
                if len(blob) < length:
                    self._truncate_tail(f, path, good, repair)
                    break
                try:
                    frame = json.loads(blob.decode())
                except (ValueError, UnicodeDecodeError):
                    self._truncate_tail(f, path, good, repair)
                    break
                good = f.tell()
                frames += 1
                if fn is not None:
                    fn(frame)
        return frames

    def _truncate_tail(self, f, path: str, good: int, repair: bool) -> None:
        if not repair:
            return
        log.warning("spool %s: torn tail in %s, truncating to %d bytes",
                    self.prefix, path, good)
        f.truncate(good)
        f.flush()
        os.fsync(f.fileno())

    def read_frames(self, fn) -> int:
        """Read-only walk of every retained frame oldest-first (exports;
        safe against the live appender: stops at a torn tail)."""
        frames = 0
        for _, path in self.segments():
            try:
                frames += self._walk_one(path, fn, repair=False)
            except (OSError, SpoolError):
                continue
        return frames

    # --- append (the single writer) -----------------------------------------

    def append(self, obj: dict) -> bool:
        """Serialize + buffer one frame (no fsync until flush()).
        Returns False (and counts the error) when the write fails — the
        caller's telemetry tick must never die on a full disk."""
        blob = json.dumps(obj, separators=(",", ":")).encode()
        try:
            if self._fd is None:
                os.makedirs(self.dir, exist_ok=True)
                seq = self._next_seq
                self._next_seq = seq + 1
                f = open(self._path(seq), "ab")
                if f.tell() == 0:
                    f.write(MAGIC)
                self._fd = f
                self._active_seq = seq
                self._active_bytes = f.tell()
            self._fd.write(_LEN.pack(len(blob)))
            self._fd.write(blob)
            self._active_bytes += 4 + len(blob)
            return True
        except (OSError, ValueError) as e:
            log.warning("spool %s: append failed: %s", self.prefix, e)
            self._close_fd()
            self._record_error()
            return False

    def flush(self) -> None:
        """fsync the active segment, rotate past ``segment_bytes``, and
        evict oldest segments past ``budget_bytes``."""
        if self._fd is not None:
            try:
                self._fd.flush()
                os.fsync(self._fd.fileno())
            except (OSError, ValueError) as e:
                log.warning("spool %s: fsync failed: %s", self.prefix, e)
                self._close_fd()
                self._record_error()
            else:
                if self._active_bytes >= self.segment_bytes:
                    self._close_fd()
                    _fsync_dir(self.dir)
        self._enforce_budget()

    def _enforce_budget(self) -> None:
        segs = self.segments()
        sizes = {}
        total = 0
        for seq, path in segs:
            try:
                sizes[seq] = os.path.getsize(path)
            except OSError:
                sizes[seq] = 0
            total += sizes[seq]
        evicted = 0
        for seq, path in segs:
            if total <= self.budget_bytes:
                break
            if seq == self._active_seq:
                break  # never evict the live append target
            try:
                os.unlink(path)
            except OSError as e:
                log.warning("spool %s: evict of %s failed: %s",
                            self.prefix, path, e)
                self._record_error()
                continue
            total -= sizes[seq]
            evicted += 1
        if evicted:
            self.evicted += evicted
            log.warning(
                "spool %s: disk budget %.1f MiB exceeded — evicted %d "
                "oldest segment(s)", self.prefix,
                self.budget_bytes / (1 << 20), evicted,
            )
            try:
                self._on_evict(evicted)
            except Exception:  # pragma: no cover — counters must not kill IO
                pass

    def _record_error(self) -> None:
        self.errors += 1
        try:
            self._on_error()
        except Exception:  # pragma: no cover
            pass

    def _close_fd(self) -> None:
        if self._fd is not None:
            try:
                self._fd.close()
            except OSError:
                pass
            self._fd = None
            self._active_seq = -1
            self._active_bytes = 0

    def close(self) -> None:
        self.flush()
        self._close_fd()
