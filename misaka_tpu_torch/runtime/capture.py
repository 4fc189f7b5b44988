"""Wire-level traffic capture and deterministic shadow replay.

The port's copy of misaka_tpu/runtime/capture.py.  Every serving surface
records what it was asked and answered (raw input values, response
values, status, trace ID, program, engine tick); a recorded stream plus
its starting state (an anchor: `MasterNode.snapshot()`, on the engine's
device) then drives a shadow `MasterNode` running a candidate program
version, which must reproduce every response byte for byte.  The
`.mskcap` segment and its anchor checkpoints are the reference's formats
byte for byte: a segment written by either package replays in the other.

Surfaces, each request recorded once, where it terminated:

  "http"    the engine's compute routes (/compute, /compute_batch,
            /compute_raw)
  "plane"   engine-side compute-plane frames (and the plane's edge
            rejections)
  "worker"  frontend workers' locally terminated rejects (shed cache,
            backlog cap), shipped up in frame metadata
  "edge"    the native C++ edge's locally terminated rejects (401, 413,
            shed cache, overload), drained by its supervisor
            (runtime/frontends.py), sampled in C++

Knobs, re-read by configure():

  MISAKA_CAPTURE=0          kill switch: start() refuses, every hook stays
                            one falsy attribute load (RECORDING)
  MISAKA_CAPTURE_MB         ring budget in MiB (default 16; the oldest
                            records evict first, counted)
  MISAKA_CAPTURE_SAMPLE     sampling rate (default 1.0); a request with an
                            inbound X-Misaka-Trace is always recorded
  MISAKA_CAPTURE_DIR        default directory of exported segments
  MISAKA_REPLAY_VERIFY_MAX  newest records a ?verify=replay gate replays
                            (default 256)

Replay soundness, as in the reference: one anchor per active program at
start(); a program whose records the ring evicted since its anchor is
refused; per-program traffic must be serialized for byte-exactness (the
scheduler coalesces concurrent callers nondeterministically, which a
stateless network does not see and a stateful one does); arm in a quiet
window.

The always-on spool (MISAKA_TSDB_DIR): a daemon rotates the ring into
spool-<seq>.mskcap segments under <dir>/capture (MISAKA_CAPTURE_SEG_KB,
_SEG_S, _DISK_MB; POST /captures/rotate cuts one), and a verify gate also
replays the newest rotated segments (MISAKA_REPLAY_HISTORY).

Stdlib and numpy on the record path; torch only where an anchor is read
back (load_anchor_checkpoint), through the masters handed in otherwise.
"""

from __future__ import annotations

import base64
import hashlib
import json
import logging
import os
import random
import struct
import threading
import time
from collections import deque

from misaka_tpu_torch.utils import metrics

log = logging.getLogger("misaka_tpu_torch.capture")

MAGIC = b"MSKCAP1\n"
_LEN = struct.Struct("<I")
# per-record bookkeeping overhead (dict + key strings + counters), used
# for the MISAKA_CAPTURE_MB budget accounting
_REC_OVERHEAD = 160
_MAX_FRAME = 64 << 20

M_RECORDS = metrics.counter(
    "misaka_capture_records_total",
    "Captured wire records, by serving surface",
    ("surface",),
)
M_DROPPED = metrics.counter(
    "misaka_capture_dropped_total",
    "Capture records evicted by the MISAKA_CAPTURE_MB ring budget",
)
M_SAMPLED_OUT = metrics.counter(
    "misaka_capture_sampled_out_total",
    "Requests skipped by MISAKA_CAPTURE_SAMPLE while recording",
)
M_RING_BYTES = metrics.gauge(
    "misaka_capture_ring_bytes",
    "Current capture ring memory footprint (payloads + overhead)",
)
M_RECORDING = metrics.gauge(
    "misaka_capture_recording",
    "1 while a capture is armed, else 0",
)
M_REPLAY_RUNS = metrics.counter(
    "misaka_replay_runs_total",
    "Shadow replay runs, by verdict",
    ("verdict",),
)
M_REPLAY_DIVERGENCES = metrics.counter(
    "misaka_replay_divergences_total",
    "Individual replayed records whose response bytes diverged",
)


class CaptureError(RuntimeError):
    """Capture/replay plane refusal (killed, torn segment, unsound replay)."""


# module-level fast flag: every hook is `if capture.RECORDING: ...` — one
# attribute load when idle, and MISAKA_CAPTURE=0 keeps it False forever
RECORDING = False

_lock = threading.Lock()
_ring: deque = deque()
_ring_bytes = 0
_seq = 0
_dropped = 0
_sampled_out = 0
_dropped_since_anchor: dict = {}
_anchors: dict = {}
_started_unix = 0.0

_KILLED = False
_BUDGET = 16 << 20
_SAMPLE = 1.0
_DIR = "captures"
_VERIFY_MAX = 256


def configure(environ=os.environ) -> None:
    """(Re-)read the env knobs — called at import; tests and the bench
    A/B call it again after toggling the environment."""
    global _KILLED, _BUDGET, _SAMPLE, _DIR, _VERIFY_MAX
    _KILLED = environ.get("MISAKA_CAPTURE", "1") == "0"
    try:
        mb = float(environ.get("MISAKA_CAPTURE_MB", "") or 16)
    except ValueError:
        mb = 16.0
    _BUDGET = max(1 << 16, int(mb * (1 << 20)))
    try:
        _SAMPLE = min(1.0, max(0.0, float(
            environ.get("MISAKA_CAPTURE_SAMPLE", "") or 1.0
        )))
    except ValueError:
        _SAMPLE = 1.0
    _DIR = environ.get("MISAKA_CAPTURE_DIR", "") or "captures"
    try:
        _VERIFY_MAX = max(1, int(
            environ.get("MISAKA_REPLAY_VERIFY_MAX", "") or 256
        ))
    except ValueError:
        _VERIFY_MAX = 256


configure()


def available() -> bool:
    return not _KILLED


def recording() -> bool:
    return RECORDING


def sample_rate() -> float:
    return _SAMPLE


def mem_bytes() -> int:
    return _ring_bytes


# ---------------------------------------------------------------------------
# Anchors
# ---------------------------------------------------------------------------

def anchor_from_master(label: str, master) -> dict | None:
    """Snapshot one engine into a replay anchor: deep-copied state
    pytree, tick, and the same topology metadata save_checkpoint embeds.
    Returns None for masters without the MasterNode snapshot surface
    (the distributed control plane cannot anchor)."""
    snap = getattr(master, "snapshot", None)
    topo = getattr(master, "_topology", None)
    if snap is None or topo is None:
        return None
    # batch=None is a real mode (single-instance serving, no batch axis
    # on the state arrays) — preserve it so the shadow rebuilds the same
    # shape, don't coerce to 1
    batch = getattr(master, "_batch", None)
    batch = int(batch) if batch is not None else None
    return {
        "label": label,
        "state": snap(),
        "tick": int(getattr(master, "_ticks_done", 0) or 0),
        "batch": batch,
        "engine": getattr(master, "engine_name", None),
        "meta": {
            "nodes": topo.node_info,
            "programs": topo.programs,
            "stack_cap": topo.stack_cap,
            "in_cap": topo.in_cap,
            "out_cap": topo.out_cap,
            "batch": batch,
        },
    }


def write_anchor_checkpoint(path: str, anchor: dict) -> None:
    """One anchor -> a load_checkpoint-compatible .npz in the reference's
    format, written durably (runtime/checkpoint.py: tmp + fsync, the
    sha256 manifest sidecar, atomic replaces, a directory fsync)."""
    from misaka_tpu_torch.core.state import state_to_numpy
    from misaka_tpu_torch.runtime import checkpoint as ckpt

    arrays = state_to_numpy(anchor["state"])
    arrays[ckpt.TOPOLOGY_KEY] = ckpt.topology_blob(anchor["meta"])
    ckpt.write_checkpoint(path, arrays, anchor["batch"])


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------

def start(anchors: dict | None = None) -> dict:
    """Arm the recorder: reset the ring, install per-program anchors.
    Refuses under MISAKA_CAPTURE=0 and when already recording."""
    global RECORDING, _ring_bytes, _seq, _dropped, _sampled_out
    global _anchors, _started_unix, _dropped_since_anchor
    if _KILLED:
        raise CaptureError(
            "capture disabled (MISAKA_CAPTURE=0 is the kill switch)"
        )
    with _lock:
        if RECORDING:
            raise CaptureError("a capture is already recording")
        _ring.clear()
        _ring_bytes = 0
        _seq = 0
        _dropped = 0
        _sampled_out = 0
        _dropped_since_anchor = {}
        _anchors = dict(anchors or {})
        _started_unix = time.time()
        RECORDING = True
    M_RECORDING.set(1)
    M_RING_BYTES.set(0)
    return status()


def stop() -> dict:
    """Disarm; the ring and anchors stay readable for export/replay."""
    global RECORDING
    with _lock:
        RECORDING = False
    M_RECORDING.set(0)
    return status()


def status() -> dict:
    with _lock:
        return {
            "recording": RECORDING,
            "available": not _KILLED,
            "records": len(_ring),
            "ring_bytes": _ring_bytes,
            "budget_bytes": _BUDGET,
            "sample": _SAMPLE,
            "dropped": _dropped,
            "sampled_out": _sampled_out,
            "started_unix": _started_unix if RECORDING or _ring else None,
            "anchors": {
                k: {"tick": a["tick"], "batch": a["batch"],
                    "engine": a.get("engine")}
                for k, a in _anchors.items()
            },
        }


def _evict_locked() -> None:
    global _ring_bytes, _dropped
    while _ring_bytes > _BUDGET and _ring:
        old = _ring.popleft()
        _ring_bytes -= old["_sz"]
        _dropped += 1
        label = old["program"]
        _dropped_since_anchor[label] = (
            _dropped_since_anchor.get(label, 0) + 1
        )
        M_DROPPED.inc()


def note(surface: str, *, program: str | None, trace: str | None,
         inbound: bool, vals: bytes, resp: bytes, status: int,
         tick: int | None, reqs: int = 1, op: str = "coalesced",
         segs=None, t: float | None = None) -> None:
    """Record one terminated request (or coalesced plane frame).

    ``vals``/``resp`` are raw little-endian int32 payload bytes for
    successes (the byte-for-byte replay comparands); ``resp`` is UTF-8
    reject text otherwise.  ``op`` names the compute lane ("coalesced"
    or "many") so replay drives the identical code path."""
    global _seq, _ring_bytes, _sampled_out
    if not RECORDING:
        return
    if not inbound and _SAMPLE < 1.0 and random.random() >= _SAMPLE:
        with _lock:
            _sampled_out += 1
        M_SAMPLED_OUT.inc()
        return
    label = program if program else "default"
    rec = {
        "surface": surface,
        "program": label,
        "trace": trace,
        "inbound": bool(inbound),
        "t": time.time() if t is None else t,
        "tick": tick,
        "status": int(status),
        "op": op,
        "reqs": int(reqs),
        "n": len(vals) // 4,
        "vals": vals,
        "resp": resp,
    }
    if segs:
        rec["segs"] = segs
    rec["_sz"] = len(vals) + len(resp) + _REC_OVERHEAD
    with _lock:
        if not RECORDING:
            return
        rec["seq"] = _seq
        _seq += 1
        _ring.append(rec)
        _ring_bytes += rec["_sz"]
        _evict_locked()
        ring_bytes = _ring_bytes
    M_RECORDS.labels(surface=surface).inc()
    M_RING_BYTES.set(ring_bytes)


def ingest(surface: str, rows, pre_sampled: bool = False) -> None:
    """Locally-terminated rejects shipped up from the edge/worker tiers:
    bounded rows of {t, program, trace, in, status, reason, n}.  The C++
    edge applies MISAKA_CAPTURE_SAMPLE itself (pre_sampled=True); worker
    rows sample here."""
    if not RECORDING:
        return
    for row in rows:
        try:
            inbound = bool(row.get("in"))
            if (not pre_sampled and not inbound and _SAMPLE < 1.0
                    and random.random() >= _SAMPLE):
                M_SAMPLED_OUT.inc()
                continue
            reason = str(row.get("reason") or "reject")
            note(
                surface,
                program=row.get("program") or None,
                trace=row.get("trace") or None,
                inbound=True,  # sampling already settled above
                vals=b"",
                resp=reason.encode(),
                status=int(row.get("status") or 0),
                tick=None,
                reqs=1,
                op="reject",
                t=float(row["t"]) if row.get("t") is not None else None,
            )
        except (TypeError, ValueError, KeyError):
            continue  # a malformed row must never hurt the serving path


def records(program: str | None = None, limit: int | None = None) -> list:
    """Newest-last copies of the ring (optionally one program's)."""
    with _lock:
        out = list(_ring)
    if program is not None:
        out = [r for r in out if r["program"] == program]
    if limit is not None and len(out) > limit:
        out = out[-limit:]
    return out


def dropped_since_anchor(program: str) -> int:
    with _lock:
        return _dropped_since_anchor.get(program, 0)


def anchor(program: str) -> dict | None:
    with _lock:
        return _anchors.get(program)


def debug_payload(limit: int = 100) -> dict:
    """GET /debug/captures: recorder status + the newest records with
    value previews (full payloads live in exports, not the debug JSON)."""
    payload = status()
    rows = []
    for r in records(limit=limit):
        rows.append({
            "seq": r["seq"],
            "surface": r["surface"],
            "program": r["program"],
            "trace": r["trace"],
            "inbound": r["inbound"],
            "t": round(r["t"], 6),
            "tick": r["tick"],
            "status": r["status"],
            "op": r["op"],
            "reqs": r["reqs"],
            "n": r["n"],
            "vals_head": _preview(r["vals"]),
            "resp_head": (
                _preview(r["resp"]) if r["status"] == 200
                else r["resp"][:80].decode("utf-8", "replace")
            ),
        })
    payload["preview"] = rows
    sp = spool_status()
    if sp is not None:
        payload["spool"] = sp
    return payload


def _preview(raw: bytes, k: int = 8) -> list:
    import numpy as np

    return np.frombuffer(raw[: 4 * k], dtype="<i4").tolist()


# ---------------------------------------------------------------------------
# Segment files (length-prefixed append-only, fsync + manifest)
# ---------------------------------------------------------------------------

def _segment_manifest_path(path: str) -> str:
    return f"{path}.manifest"


def _record_to_json(rec: dict) -> dict:
    out = {k: v for k, v in rec.items()
           if k not in ("vals", "resp", "_sz")}
    out["vals_b64"] = base64.b64encode(rec["vals"]).decode()
    out["resp_b64"] = base64.b64encode(rec["resp"]).decode()
    return out


def _record_from_json(obj: dict) -> dict:
    rec = dict(obj)
    rec["vals"] = base64.b64decode(rec.pop("vals_b64", ""))
    rec["resp"] = base64.b64decode(rec.pop("resp_b64", ""))
    return rec


def write_segment(path: str, anchor_files: dict | None = None) -> dict:
    """The current ring -> one segment file: MAGIC, then u32-length-
    prefixed JSON frames (frame 0 is the header), tmp+fsync'd with a
    sha256 manifest sidecar and atomic replaces — the r9 durable-
    checkpoint discipline for wire records."""
    from misaka_tpu_torch.runtime.checkpoint import _fsync_dir

    recs = records()
    st = status()
    header = {
        "format": 1,
        "kind": "header",
        "started_unix": st["started_unix"],
        "saved_unix": round(time.time(), 3),
        "sample": st["sample"],
        "budget_bytes": st["budget_bytes"],
        "dropped": st["dropped"],
        "records": len(recs),
        "anchors": {
            label: {
                "tick": a["tick"], "batch": a["batch"],
                "engine": a.get("engine"),
                "dropped_since_anchor": dropped_since_anchor(label),
                "file": (anchor_files or {}).get(label),
            }
            for label, a in _anchors.items()
        },
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    mtmp = f"{_segment_manifest_path(path)}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(MAGIC)
            for obj in [header] + [_record_to_json(r) for r in recs]:
                blob = json.dumps(obj, separators=(",", ":")).encode()
                f.write(_LEN.pack(len(blob)))
                f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        h = hashlib.sha256()
        with open(tmp, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        size = os.path.getsize(tmp)
        with open(mtmp, "w") as f:
            json.dump({
                "format": 1,
                "sha256": h.hexdigest(),
                "size": size,
                "saved_unix": round(time.time(), 3),
                "records": len(recs),
            }, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        os.replace(mtmp, _segment_manifest_path(path))
    except BaseException:
        for leftover in (tmp, mtmp):
            try:
                os.unlink(leftover)
            except OSError:
                pass
        raise
    _fsync_dir(os.path.dirname(os.path.abspath(path)))
    return header


def verify_segment(path: str) -> dict:
    """Durability gate before any replay trusts a segment: the manifest
    sidecar's size + sha256 must match (CaptureError with evidence
    otherwise); without a sidecar, the frame walk itself must complete."""
    if not os.path.exists(path):
        raise CaptureError(f"no capture segment at {path}")
    mpath = _segment_manifest_path(path)
    if os.path.exists(mpath):
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise CaptureError(f"unreadable segment manifest {mpath}: {e}")
        size = os.path.getsize(path)
        if size != manifest.get("size"):
            raise CaptureError(
                f"segment {path} is {size} bytes; manifest says "
                f"{manifest.get('size')} (torn write?)"
            )
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        if h.hexdigest() != manifest.get("sha256"):
            raise CaptureError(
                f"segment {path} sha256 mismatch vs manifest (corrupt)"
            )
        return manifest
    header, recs = read_segment(path)  # structural walk is the fallback
    return {"format": 1, "records": len(recs), "sha256": None}


def read_segment(path: str, verify: bool = False):
    """-> (header dict, [records]) with payload bytes decoded."""
    if verify:
        verify_segment(path)
    frames = []
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise CaptureError(
                f"{path} is not a capture segment (bad magic {magic!r})"
            )
        while True:
            raw = f.read(4)
            if not raw:
                break
            if len(raw) < 4:
                raise CaptureError(f"segment {path}: torn length prefix")
            (length,) = _LEN.unpack(raw)
            if length > _MAX_FRAME:
                raise CaptureError(
                    f"segment {path}: frame of {length} bytes exceeds "
                    f"the {_MAX_FRAME}-byte cap"
                )
            blob = f.read(length)
            if len(blob) < length:
                raise CaptureError(f"segment {path}: torn frame")
            try:
                frames.append(json.loads(blob.decode()))
            except (ValueError, UnicodeDecodeError) as e:
                raise CaptureError(f"segment {path}: bad frame JSON: {e}")
    if not frames or frames[0].get("kind") != "header":
        raise CaptureError(f"segment {path}: missing header frame")
    return frames[0], [_record_from_json(o) for o in frames[1:]]


def export(path: str | None = None) -> dict:
    """Segment + per-program anchor checkpoints to disk; returns the
    header plus the paths written.  Works recording or stopped (the ring
    persists until the next start())."""
    if not _ring and not _anchors:
        raise CaptureError("nothing captured (POST /captures/start first)")
    if path is None:
        os.makedirs(_DIR, exist_ok=True)
        path = os.path.join(
            _DIR, f"capture-{time.strftime('%Y%m%d-%H%M%S')}.mskcap"
        )
    else:
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
    anchor_files = {}
    with _lock:
        anchors = dict(_anchors)
    for label, a in anchors.items():
        apath = f"{path}.anchor.{label}.npz"
        write_anchor_checkpoint(apath, a)
        anchor_files[label] = os.path.basename(apath)
    header = write_segment(path, anchor_files=anchor_files)
    return {
        "path": path,
        "records": header["records"],
        "dropped": header["dropped"],
        "anchors": {
            label: os.path.join(os.path.dirname(path), fname)
            for label, fname in anchor_files.items()
        },
    }


# ---------------------------------------------------------------------------
# Continuous spooling (the always-on recorder)
# ---------------------------------------------------------------------------
#
# With MISAKA_TSDB_DIR set (MISAKA_CAPTURE_SPOOL=0 opts this plane out), a
# rotation daemon arms the ring at boot and, whenever the ring grows past
# MISAKA_CAPTURE_SEG_KB or ages past MISAKA_CAPTURE_SEG_S, exports it as a
# finalized ``spool-<seq>.mskcap`` segment (manifest and one anchor per
# program: each rotated segment replays on its own) and re-arms with fresh
# anchors cut at the rotation.  Records landing between the export and the
# ring reset are the rotation's bounded loss, counted on
# misaka_capture_spool_dropped_total; the oldest segment groups are
# evicted under MISAKA_CAPTURE_DISK_MB.  A crash loses at most the ring
# not yet rotated (segments are written atomically).  Each rotation cuts
# fresh anchors on the engines' devices (MasterNode.snapshot() clones)
# and drops the old ones with the stopped ring.

M_SPOOL_DROPPED = metrics.counter(
    "misaka_capture_spool_dropped_total",
    "Capture records lost at spool rotation boundaries plus on-disk "
    "segments evicted by the MISAKA_CAPTURE_DISK_MB budget",
)
M_SPOOL_ROTATIONS = metrics.counter(
    "misaka_capture_spool_rotations_total",
    "Capture spool segment rotations",
)
M_SPOOL_BYTES = metrics.gauge(
    "misaka_capture_spool_bytes",
    "On-disk footprint of the capture spool (segments + anchors)",
)

_spool_mu = threading.Lock()
_spool: dict | None = None


def spool_dir(environ=os.environ) -> str | None:
    root = environ.get("MISAKA_TSDB_DIR")
    if not root or environ.get("MISAKA_CAPTURE_SPOOL", "1") == "0":
        return None
    return os.path.join(root, "capture")


def _env_float(environ, name: str, default: float) -> float:
    try:
        return float(environ.get(name, "") or default)
    except ValueError:
        return default


def ensure_spool(environ=os.environ, anchor_fn=None) -> dict | None:
    """Arm the rotation daemon (idempotent; None when the master switch
    is unset or capture is killed).  ``anchor_fn() -> {label: anchor}``
    cuts fresh per-program anchors at boot and at every rotation — the
    HTTP server passes the same closure /captures/start uses."""
    global _spool
    d = spool_dir(environ)
    if d is None or _KILLED:
        return None
    with _spool_mu:
        if _spool is not None:
            return _spool
        os.makedirs(d, exist_ok=True)
        # crash hygiene: a kill mid-export leaves only tmp files behind
        for name in os.listdir(d):
            if ".tmp." in name:
                try:
                    os.unlink(os.path.join(d, name))
                except OSError:
                    pass
        next_seq = 0
        for seq, _ in _spool_groups(d):
            next_seq = max(next_seq, seq + 1)
        st = {
            "dir": d,
            "budget_bytes": int(_env_float(
                environ, "MISAKA_CAPTURE_DISK_MB", 256.0) * (1 << 20)),
            "seg_bytes": int(_env_float(
                environ, "MISAKA_CAPTURE_SEG_KB", 4096.0) * 1024),
            "seg_s": max(0.05, _env_float(
                environ, "MISAKA_CAPTURE_SEG_S", 300.0)),
            "anchor_fn": anchor_fn,
            "next_seq": next_seq,
            "rotations": 0,
            "evicted_segments": 0,
            "last_rotate_mono": time.monotonic(),
            "stop": threading.Event(),
        }
        st["poll_s"] = min(1.0, max(0.05, st["seg_s"] / 4.0))
        _spool = st
    if not RECORDING:
        try:
            start(anchors=_cut_anchors(st))
        except CaptureError:
            pass  # an operator capture already runs; ride it
    threading.Thread(
        target=_spool_loop, args=(st,), daemon=True,
        name="misaka-capture-spool",
    ).start()
    return st


def _cut_anchors(st: dict) -> dict:
    fn = st.get("anchor_fn")
    if fn is None:
        return {}
    try:
        return fn() or {}
    except Exception:
        log.warning("capture spool: anchor cut failed", exc_info=True)
        return {}


def _spool_loop(st: dict) -> None:
    while not st["stop"].wait(st["poll_s"]):
        try:
            if not RECORDING and not _KILLED:
                # always-on: re-arm after an operator stop/export
                try:
                    start(anchors=_cut_anchors(st))
                except CaptureError:
                    pass
            with _lock:
                n, nbytes = len(_ring), _ring_bytes
            age = time.monotonic() - st["last_rotate_mono"]
            if n and (nbytes >= st["seg_bytes"] or age >= st["seg_s"]):
                rotate_now()
        except Exception:  # pragma: no cover — the recorder must never
            log.warning("capture spool tick failed", exc_info=True)
            from misaka_tpu_torch.utils import spool as spool_mod

            spool_mod.M_SPOOL_ERRORS.labels(plane="capture").inc()


def rotate_now() -> dict | None:
    """Finalize the current ring as the next spool segment and re-arm
    with fresh anchors (the daemon's trigger; POST /captures/rotate for
    a deterministic operator cut).  None when the ring is empty."""
    with _spool_mu:
        st = _spool
        if st is None:
            raise CaptureError(
                "capture spool not armed (set MISAKA_TSDB_DIR)"
            )
        with _lock:
            if not _ring:
                return None
        seq = st["next_seq"]
        st["next_seq"] = seq + 1
        path = os.path.join(st["dir"], f"spool-{seq:08d}.mskcap")
        try:
            result = export(path)
        except OSError as e:
            log.warning("capture spool: rotation export failed: %s", e)
            from misaka_tpu_torch.utils import spool as spool_mod

            spool_mod.M_SPOOL_ERRORS.labels(plane="capture").inc()
            return None
        anchors = _cut_anchors(st)
        with _lock:
            ring_now = len(_ring)
        stop()
        lost = max(0, ring_now - result["records"])
        try:
            start(anchors=anchors)
        except CaptureError:  # pragma: no cover — killed mid-rotation
            pass
        if lost:
            M_SPOOL_DROPPED.inc(lost)
        M_SPOOL_ROTATIONS.inc()
        st["rotations"] += 1
        st["last_rotate_mono"] = time.monotonic()
        _enforce_spool_budget(st)
        return result


def _spool_groups(directory: str) -> list[tuple[int, list[str]]]:
    """[(seq, [segment + manifest + anchor paths])] oldest-first."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    groups: dict[int, list[str]] = {}
    for name in names:
        if not name.startswith("spool-"):
            continue
        stem = name.split(".mskcap")[0]
        try:
            seq = int(stem[len("spool-"):])
        except ValueError:
            continue
        groups.setdefault(seq, []).append(os.path.join(directory, name))
    return sorted((seq, sorted(paths)) for seq, paths in groups.items())


def _enforce_spool_budget(st: dict) -> None:
    groups = _spool_groups(st["dir"])
    sizes = []
    total = 0
    for seq, paths in groups:
        size = 0
        for p in paths:
            try:
                size += os.path.getsize(p)
            except OSError:
                pass
        sizes.append(size)
        total += size
    evicted = 0
    for (seq, paths), size in zip(groups, sizes):
        if total <= st["budget_bytes"] or len(groups) - evicted <= 1:
            break
        for p in paths:
            try:
                os.unlink(p)
            except OSError:
                pass
        total -= size
        evicted += 1
    if evicted:
        st["evicted_segments"] += evicted
        M_SPOOL_DROPPED.inc(evicted)
        log.warning(
            "capture spool: disk budget %.1f MiB exceeded — evicted %d "
            "oldest segment group(s)",
            st["budget_bytes"] / (1 << 20), evicted,
        )
    M_SPOOL_BYTES.set(total)


def spool_status() -> dict | None:
    with _spool_mu:
        st = _spool
        if st is None:
            return None
        groups = _spool_groups(st["dir"])
        return {
            "dir": st["dir"],
            "segments": len(groups),
            "rotations": st["rotations"],
            "evicted_segments": st["evicted_segments"],
            "budget_bytes": st["budget_bytes"],
            "segment_bytes": st["seg_bytes"],
            "segment_seconds": st["seg_s"],
            "disk_bytes": sum(
                os.path.getsize(p)
                for _, paths in groups for p in paths
                if os.path.exists(p)
            ),
        }


def shutdown_spool() -> None:
    """Tests: stop the rotation daemon (the ring keeps recording)."""
    global _spool
    with _spool_mu:
        if _spool is not None:
            _spool["stop"].set()
            _spool = None


def history_segments(directory: str | None = None,
                     environ=os.environ) -> list[str]:
    """Finalized spool segments oldest-first (the replay sweep's input)."""
    d = directory or spool_dir(environ)
    if d is None:
        return []
    return [
        paths[0]
        for _, paths in _spool_groups(d)
        if paths and paths[0].endswith(".mskcap")
    ]


def history_bundles(program: str, limit_segments: int = 2,
                    directory: str | None = None) -> list[tuple]:
    """Newest-first [(anchor_path, replayable records, segment_path)]
    from the on-disk spool history for one program — what widens
    verify=replay past the in-memory window.  Unsound segments (missing
    or drop-tainted anchors) are skipped, not fatal: the in-memory
    bundle is the gate's floor, history is extra evidence."""
    out: list[tuple] = []
    for path in reversed(history_segments(directory)):
        if len(out) >= max(0, limit_segments):
            break
        try:
            header, recs = read_segment(path, verify=True)
        except CaptureError:
            continue
        info = (header.get("anchors") or {}).get(program)
        if not info or int(info.get("dropped_since_anchor") or 0):
            continue
        fname = info.get("file")
        if not fname:
            continue
        apath = os.path.join(os.path.dirname(os.path.abspath(path)), fname)
        if not os.path.exists(apath):
            continue
        sel = replayable([r for r in recs if r["program"] == program])
        if sel:
            out.append((apath, sel, path))
    return out


def load_anchor_checkpoint(path: str):
    """Anchor .npz (either package's) -> (meta dict, NetworkState on the
    CPU) after the durability gate.  Read by hand, not through
    MasterNode.load_checkpoint: a candidate replay restores the old state
    into a master compiled from another topology."""
    from misaka_tpu_torch.core.state import NetworkState, state_from_numpy
    from misaka_tpu_torch.runtime import checkpoint as ckpt

    meta, arrays = ckpt.read_checkpoint(path, NetworkState._fields)
    return meta, state_from_numpy(arrays)


# ---------------------------------------------------------------------------
# Shadow replay
# ---------------------------------------------------------------------------

def replayable(recs) -> list:
    """The records a shadow can drive: engine-terminated successes."""
    return [
        r for r in recs
        if r["surface"] in ("http", "plane") and r["status"] == 200
        and r["n"] > 0
    ]


def replay_records(master, recs, preview: int = 8) -> list:
    """Drive records sequentially through ``master`` (already restored
    to the anchor) and compare response bytes exactly.  Returns one diff
    dict per divergent record — empty means byte-for-byte green."""
    import numpy as np

    diffs = []
    for offset, rec in enumerate(recs):
        values = np.frombuffer(rec["vals"], dtype="<i4")
        if rec["op"] == "many":
            out = master.compute_many(values, return_array=True)
        else:
            out = master.compute_coalesced(values, return_array=True)
        actual = np.asarray(out).astype("<i4").tobytes()
        if actual != rec["resp"]:
            exp = np.frombuffer(rec["resp"], dtype="<i4")
            act = np.frombuffer(actual, dtype="<i4")
            k = min(len(exp), len(act))
            first = int(np.argmax(exp[:k] != act[:k])) if (
                k and (exp[:k] != act[:k]).any()
            ) else k
            diffs.append({
                "offset": offset,
                "seq": rec["seq"],
                "trace": rec["trace"],
                "program": rec["program"],
                "tick": rec["tick"],
                "n": rec["n"],
                "first_diff_index": first,
                "expected_len": len(exp),
                "actual_len": len(act),
                "expected_head": exp[
                    first: first + preview
                ].tolist(),
                "actual_head": act[first: first + preview].tolist(),
            })
            M_REPLAY_DIVERGENCES.inc()
    M_REPLAY_RUNS.labels(
        verdict="divergent" if diffs else "green"
    ).inc()
    return diffs


def format_diff(d: dict) -> str:
    """The loud per-request line a divergence renders."""
    return (
        f"DIVERGENCE offset={d['offset']} seq={d['seq']} "
        f"trace={d['trace'] or '-'} program={d['program']} "
        f"n={d['n']} first_diff_index={d['first_diff_index']} "
        f"expected={d['expected_head']} actual={d['actual_head']}"
    )


def verify_bundle(program: str, limit: int | None = None):
    """(anchor, records) for an in-process ?verify=replay gate — refuses
    (CaptureError) when the capture cannot soundly verify ``program``:
    no anchor, no records, or a non-contiguous stream since the anchor."""
    if _KILLED:
        raise CaptureError("capture disabled (MISAKA_CAPTURE=0)")
    a = anchor(program)
    if a is None:
        raise CaptureError(
            f"no capture anchor for program {program!r} "
            "(POST /captures/start while it serves, then retry)"
        )
    lost = dropped_since_anchor(program)
    if lost:
        raise CaptureError(
            f"capture ring evicted {lost} records for program "
            f"{program!r} since its anchor; replay would be unsound "
            "(raise MISAKA_CAPTURE_MB or shorten the window)"
        )
    recs = replayable(records(program=program))
    if not recs:
        raise CaptureError(
            f"no replayable captured requests for program {program!r}"
        )
    if limit is None:
        limit = _VERIFY_MAX
    return a, recs[-limit:]


# ---------------------------------------------------------------------------
# Load models
# ---------------------------------------------------------------------------

def fit_load_model(recs, series=None, tenant_series=None) -> dict:
    """Fit arrival-rate / batch-size / tenant-mix distributions from a
    capture into the JSON load model ``bench.py --model`` consumes.

    ``series`` optionally carries TSDB history rows
    ([(unix, requests_per_s), ...]) to widen the arrival fit beyond the
    capture window.  With the durable long-horizon tier retained (days
    of 5m slots), the same rows also yield a ``diurnal`` section — 24
    UTC hour-of-day weights normalized to mean 1.0 — and
    ``tenant_series`` ({tenant: rows}) yields per-tenant arrival rates
    (``tenants_arrival``), so --model replays a realistic day instead
    of a flat Poisson stream."""
    import numpy as np

    recs = [r for r in recs if r["surface"] in ("http", "plane")]
    if not recs:
        raise CaptureError("cannot fit a load model from zero records")
    ts = np.array(sorted(r["t"] for r in recs), dtype=np.float64)
    sizes = np.array([max(1, r["n"]) for r in recs], dtype=np.float64)
    duration = float(ts[-1] - ts[0]) if len(ts) > 1 else 0.0
    total_reqs = int(sum(r["reqs"] for r in recs))
    rate = total_reqs / duration if duration > 0 else float(total_reqs)
    if len(ts) > 2:
        gaps = np.diff(ts)
        gaps = gaps[gaps > 0]
        cv = float(gaps.std() / gaps.mean()) if len(gaps) > 1 and \
            gaps.mean() > 0 else 1.0
    else:
        cv = 1.0
    if series:
        vals = [float(v) for _, v in series if v is not None and v > 0]
        if vals:
            # TSDB history widens the fit past the capture window: blend
            # the long-run observed rate with the capture's own
            rate = 0.5 * rate + 0.5 * (sum(vals) / len(vals))
    uppers = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096]
    hist = []
    prev = 0
    for u in uppers:
        w = int(((sizes > prev) & (sizes <= u)).sum())
        if w:
            hist.append([u, w])
        prev = u
    over = int((sizes > uppers[-1]).sum())
    if over:
        hist.append([int(sizes.max()), over])
    tenants: dict = {}
    for r in recs:
        tenants[r["program"]] = tenants.get(r["program"], 0) + r["reqs"]
    statuses: dict = {}
    for r in recs:
        statuses[str(r["status"])] = statuses.get(str(r["status"]), 0) + 1
    diurnal = _fit_diurnal(series)
    tenants_arrival = {}
    for tenant, rows in (tenant_series or {}).items():
        vals = [float(v) for _, v in rows if v is not None and v >= 0]
        if vals:
            tenants_arrival[tenant] = round(sum(vals) / len(vals), 6)
    out = {
        "format": 1,
        "fitted_unix": round(time.time(), 3),
        "source": {"records": len(recs), "requests": total_reqs,
                   "duration_s": round(duration, 3)},
        "arrival": {"rate_rps": round(rate, 3),
                    "interarrival_cv": round(cv, 3)},
        "values": {
            "mean": round(float(sizes.mean()), 3),
            "p50": int(np.percentile(sizes, 50)),
            "p90": int(np.percentile(sizes, 90)),
            "p99": int(np.percentile(sizes, 99)),
            "max": int(sizes.max()),
            "hist": hist,
        },
        "tenants": {
            k: round(v / max(1, total_reqs), 6) for k, v in tenants.items()
        },
        "status_mix": statuses,
    }
    if diurnal:
        out["diurnal"] = diurnal
    if tenants_arrival:
        out["tenants_arrival"] = tenants_arrival
    return out


def _fit_diurnal(series) -> dict | None:
    """24 UTC hour-of-day weights (mean 1.0) from TSDB history rows, or
    None when the rows span fewer than two distinct hours — a short
    capture has no day shape worth replaying."""
    if not series:
        return None
    sums = [0.0] * 24
    counts = [0] * 24
    for t, v in series:
        if v is None or v < 0:
            continue
        hour = int(float(t) // 3600) % 24
        sums[hour] += float(v)
        counts[hour] += 1
    covered = [sums[h] / counts[h] for h in range(24) if counts[h]]
    if sum(1 for c in counts if c) < 2 or not covered:
        return None
    mean = sum(covered) / len(covered)
    if mean <= 0:
        return None
    weights = [
        round(sums[h] / counts[h] / mean, 4) if counts[h] else 1.0
        for h in range(24)
    ]
    return {
        "hour_weights_utc": weights,
        "hours_observed": sum(1 for c in counts if c),
    }
