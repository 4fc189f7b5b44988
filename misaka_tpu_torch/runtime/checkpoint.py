""".npz checkpoints: the durable file format both packages read and write.

The port's own copy of the file-level half of misaka_tpu/runtime/master.py's
checkpointing (`CheckpointError`, `_fsync_dir`, `manifest_path`,
`_zip_intact`, `verify_checkpoint`, and the write discipline of
`save_checkpoint`).  The format is the reference's, byte for byte:

- `<name>.npz`: one member per `NetworkState` field with its dtype (int32,
  bool for `port_full`/`holding`) and `__topology__`, the uint8 bytes of a
  JSON object {nodes, programs, stack_cap, in_cap, out_cap, batch}; an
  unbatched network writes `"batch": null` and arrays without the B axis;
  and `__tsdb__` (TSDB_KEY), the uint8 bytes of utils/tsdb.py's history
  snapshot, when the saver includes history.
- `<name>.npz.manifest`: JSON {format: 1, sha256, size, saved_unix, batch}.

A save is tmp file + fsync, then the manifest tmp + fsync, then the data
file's atomic rename (the commit point), then the manifest's, then a
directory fsync.  `verify_checkpoint` rejects a torn or corrupt file before
anything reads it.  The `ckpt_crash` and `ckpt_torn_write` fault points
(utils/faults.py) break a MasterNode save on demand.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
import zipfile

import numpy as np

from misaka_tpu_torch.utils import faults

log = logging.getLogger("misaka_tpu_torch.checkpoint")

TOPOLOGY_KEY = "__topology__"
TSDB_KEY = "__tsdb__"


class CheckpointError(ValueError):
    """A checkpoint failed durability verification (truncated, checksum
    mismatch, or CRC-corrupt) and was rejected before any state swap.  A
    ValueError, so /restore answers it as a 400 like other bad content."""


def _fsync_dir(directory: str) -> None:
    """Make a rename in `directory` durable (best effort: some filesystems
    refuse fsync on a directory; the rename is atomic all the same)."""
    try:
        dfd = os.open(directory or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


def manifest_path(path: str) -> str:
    """The durability sidecar of a checkpoint file (size + sha256)."""
    return path + ".manifest"


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _zip_intact(path: str) -> str | None:
    """None when `path` is a valid zip whose every member passes its CRC;
    otherwise the reason it is not."""
    try:
        with zipfile.ZipFile(path) as z:
            bad = z.testzip()
        return f"CRC mismatch in member {bad!r}" if bad is not None else None
    except zipfile.BadZipFile as e:
        return f"not a readable npz ({e})"
    except OSError as e:
        return f"unreadable ({e})"


def verify_checkpoint(path: str) -> None:
    """Raise CheckpointError unless `path` matches its manifest (exact size
    and sha256).  Without a manifest, or with a stale one (a crash between
    the data and manifest renames), the zip CRC walk decides: an intact
    file is accepted, a corrupt one rejected."""

    def reject(reason: str) -> CheckpointError:
        return CheckpointError(f"checkpoint {path} rejected: {reason}")

    def mismatch(reason: str) -> None:
        broken = _zip_intact(path)
        if broken is not None:
            raise reject(f"{reason}; {broken}")
        log.warning("checkpoint %s: %s, but the file is an intact npz -- "
                    "accepting (committed data, stale sidecar)", path, reason)

    mpath = manifest_path(path)
    if not os.path.exists(mpath):
        broken = _zip_intact(path)
        if broken is not None:
            raise reject(broken)
        return
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        want_size = int(manifest["size"])
        want_sha = str(manifest["sha256"])
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise reject(f"unreadable manifest {mpath} ({e})") from e
    try:
        size = os.path.getsize(path)
    except OSError as e:
        raise reject(f"unreadable ({e})") from e
    if size != want_size:
        mismatch(f"{size} bytes on disk vs {want_size} in the manifest "
                 f"(torn write or stale manifest)")
        return
    if _sha256_file(path) != want_sha:
        mismatch("sha256 mismatch against the manifest")


def topology_blob(meta: dict) -> np.ndarray:
    """The `__topology__` member: the JSON object as a uint8 array."""
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def write_checkpoint(path: str, arrays: dict[str, np.ndarray], batch: int | None,
                     fault_points: bool = False) -> None:
    """Write `arrays` (field name -> array, `__topology__` included) to
    `path` durably, with its manifest.  `fault_points` (MasterNode's
    save_checkpoint) arms the reference's chaos points there
    (utils/faults.py): `ckpt_crash` raises between the tmp writes and the
    replaces, `ckpt_torn_write` truncates the committed file to `value`
    of its bytes (the torn write the manifest must reject at load)."""
    pid = os.getpid()
    tmp = f"{path}.tmp.{pid}"
    mtmp = f"{manifest_path(path)}.tmp.{pid}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        manifest = {
            "format": 1,
            "sha256": _sha256_file(tmp),
            "size": os.path.getsize(tmp),
            "saved_unix": round(time.time(), 3),
            "batch": batch,
        }
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if fault_points and faults.fire("ckpt_crash") is not None:
            raise OSError("injected ckpt_crash fault (crash before atomic replace)")
        os.replace(tmp, path)  # the commit point
        os.replace(mtmp, manifest_path(path))
    except BaseException:
        for leftover in (tmp, mtmp):
            try:
                os.unlink(leftover)
            except OSError:
                pass
        raise
    _fsync_dir(os.path.dirname(os.path.abspath(path)))
    torn = faults.fire("ckpt_torn_write") if fault_points else None
    if torn is not None:
        with open(path, "r+b") as f:
            f.truncate(int(manifest["size"] * max(0.0, min(1.0, torn))))


def read_checkpoint(path: str, fields) -> tuple[dict, dict[str, np.ndarray]]:
    """Verify, then read `path`: returns (topology meta, {field: array}) for
    the names in `fields` present in the file, each an owned copy.  A
    checkpoint written before the 64-bit registers lacks the hi planes;
    those states were int32-exact, so the hi word is the lo word's sign."""
    verify_checkpoint(path)
    with np.load(path) as data:
        meta = json.loads(bytes(data[TOPOLOGY_KEY]).decode())
        arrays = {f: np.array(data[f]) for f in fields if f in data.files}
    for hi, lo in (("acc_hi", "acc"), ("bak_hi", "bak")):
        if hi not in arrays and lo in arrays:
            arrays[hi] = arrays[lo] >> 31
    return meta, arrays
