"""Program registry: multi-tenant serving of versioned TIS networks.

The port's twin of misaka_tpu/runtime/registry.py, with the same names,
errors, metric series and on-disk layout, so a store written by either
package boots in the other and the same upload gets the same version ID.
The reference's whole "model management" surface was one mutable slot
(POST /load reprogrammed THE running network, master.go:145-195); the
registry turns it into many versioned networks, each served by its own
engine:

  * **upload & version**: programs arrive as TIS source or topology JSON;
    each upload is compiled FIRST (a parse error never touches a serving
    engine), canonicalized and content-addressed: the version ID is the
    sha256 of the canonical source, so identical uploads dedup to one
    version.  ``name@<version>`` addresses an exact version; the mutable
    ``name@latest`` alias (and bare ``name``) follows publishes.
  * **per-program engines**: each *active* program version owns a full
    MasterNode (its own device loop, ServeBatcher and NetworkState on the
    registry's device), so cross-request coalescing stays per program.
    Activation is lazy (first compute) and warmed before serving.
  * **LRU eviction**: MISAKA_REGISTRY_MAX_ACTIVE (default 4) caps live
    engines; the coldest idle one is paused, checkpointed through the
    durable save_checkpoint path (manifest + atomic replace) and closed,
    and a later activation restores its state through the manifest gate.
  * **hot swap**: publishing a new version under a live engine builds and
    warms the replacement first, then parks alias-addressed requests for
    the flip, installs the new engine, and lets in-flight requests drain
    on the old one (MISAKA_SWAP_DRAIN_S, default 30 s) before it is
    checkpointed and closed.

The persistent store (``MISAKA_PROGRAMS_DIR``) survives restarts::

    <dir>/<name>/versions/<version>.json   canonical source + metadata
    <dir>/<name>/aliases.json              {"latest": "<version>"}
    <dir>/<name>/state-<version>.npz       eviction checkpoint (+ .manifest)

``ProgramRegistry(None)`` keeps sources in memory and eviction checkpoints
in a registry-owned temporary directory.

The telemetry planes reach in as the reference's do: an upload's ``slo``
spec is installed into the burn-rate engine (utils/slo.py) when its
version becomes ``latest``; a listing carries each program's usage ledger
(runtime/usage.py); ``?verify=replay`` gates a publish on a shadow engine,
built on the registry's device from the capture's anchor, replaying the
program's captured requests byte for byte (runtime/capture.py), and
with the capture spool armed the newest rotated segments too
(MISAKA_REPLAY_HISTORY); the ``swap_during_load`` fault point
(utils/faults.py) holds the park gate.  Left out, each answered as the
reference answers: a ``compose`` upload on a host without PyYAML is a
400.  Each activated engine's native compile cache (core/specialize.py,
core/jit.py) lives beside its version store, ``<dir>/<name>/native``, so
a reactivation or a restart reuses the content-keyed builds.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import re
import tempfile
import threading
import time
import weakref

from misaka_tpu_torch.runtime import edge as edge_mod
from misaka_tpu_torch.runtime import usage
from misaka_tpu_torch.runtime.topology import Topology
from misaka_tpu_torch.utils import faults, metrics, slo

log = logging.getLogger("misaka_tpu_torch.registry")

# Program names share the checkpoint-name discipline (make_http_server):
# an unauthenticated form field must never choose server-side paths.
NAME_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")
VERSION_LEN = 12  # hex chars of sha256

# --- the metrics plane --------------------------------------------------------
# Registry series carry a `program` label; _program_label caps the distinct
# values (MISAKA_REGISTRY_LABEL_MAX, default 64) so an upload flood
# collapses to program="other" instead of minting unbounded series.
M_PROG_REQS = metrics.counter(
    "misaka_program_requests_total",
    "Compute requests routed through the program registry, by program",
    ("program",),
)
M_PROG_VALUES = metrics.counter(
    "misaka_program_values_total",
    "Values routed through the program registry, by program",
    ("program",),
)
M_PROG_ACTIVE = metrics.gauge(
    "misaka_program_active_engines",
    "Per-program engine instances currently active (live registry)",
)
M_PROG_UPLOADS = metrics.counter(
    "misaka_program_uploads_total",
    "Program uploads accepted (deduped uploads count too)",
)
M_PROG_ACTIVATIONS = metrics.counter(
    "misaka_program_activations_total",
    "Engine activations (cold start or checkpoint revival), by program",
    ("program",),
)
M_PROG_EVICTIONS = metrics.counter(
    "misaka_program_evictions_total",
    "Engines drained + checkpointed out of the active set, by program",
    ("program",),
)
M_PROG_SWAPS = metrics.counter(
    "misaka_program_swaps_total",
    "Live hot-swaps completed (new version published under traffic), by program",
    ("program",),
)

_label_lock = threading.Lock()
_label_seen: set[str] = set()


def _program_label(name: str) -> str:
    """`name`, or "other" once the label-cardinality budget is spent."""
    with _label_lock:
        if name in _label_seen:
            return name
        cap = int(os.environ.get("MISAKA_REGISTRY_LABEL_MAX", "") or 64)
        if len(_label_seen) < cap:
            _label_seen.add(name)
            return name
    return "other"


class RegistryError(ValueError):
    """A registry operation the caller got wrong (bad name, bad source,
    publishing over the seeded boot program)."""


class ReplayDivergence(RegistryError):
    """A ``?verify=replay`` publish whose candidate answered captured
    traffic differently: the swap was refused (the reference's 409).
    `.diffs` carries the per-request diff dicts (trace ID, record offset,
    expected and actual heads) the HTTP surface renders as the body."""

    def __init__(self, message: str, diffs: list | None = None):
        super().__init__(message)
        self.diffs = diffs or []


class ProgramNotFound(KeyError):
    """An unknown program name or version: the typed 404.

    A KeyError subclass, so the compute plane (runtime/frontends.py, which
    imports no torch) answers it as 404 without importing this module."""

    def __str__(self) -> str:  # KeyError's str() quotes its arg; keep prose
        return self.args[0] if self.args else "program not found"


def canonical_topology(topology: Topology) -> str:
    """The canonical source text the content address is taken over: one
    sorted-key JSON form, so the same network uploaded as TIS source or as
    topology JSON (any key order) dedups to one ID."""
    return json.dumps(
        {
            "nodes": dict(topology.node_info),
            "programs": dict(topology.programs),
            "stack_cap": topology.stack_cap,
            "in_cap": topology.in_cap,
            "out_cap": topology.out_cap,
        },
        sort_keys=True,
        separators=(",", ":"),
    )


def version_of(canonical: str) -> str:
    return hashlib.sha256(canonical.encode()).hexdigest()[:VERSION_LEN]


def topology_from_canonical(canonical: str) -> Topology:
    raw = json.loads(canonical)
    return Topology(
        node_info=raw["nodes"],
        programs=raw["programs"],
        stack_cap=int(raw["stack_cap"]),
        in_cap=int(raw["in_cap"]),
        out_cap=int(raw["out_cap"]),
    )


class _Engine:
    """One active program version's serving state.

    ``ready`` latches once ``master`` is installed (or ``error`` set);
    ``leases`` counts requests currently inside the engine; ``retired``
    marks an engine removed from the active set whose last lease-holder
    must close it (a hot-swap drain that outlived its timeout)."""

    __slots__ = ("master", "leases", "ready", "error", "retired", "closed")

    def __init__(self, master=None):
        self.master = master
        self.leases = 0
        self.ready = threading.Event()
        if master is not None:
            self.ready.set()
        self.error: BaseException | None = None
        self.retired = False
        self.closed = False


class _Entry:
    """One program name: its uploaded versions + the mutable alias map."""

    __slots__ = ("versions", "aliases", "pinned")

    def __init__(self):
        self.versions: dict[str, dict] = {}   # version -> metadata
        self.aliases: dict[str, str] = {}     # "latest" -> version
        self.pinned = False                   # the seeded boot program


class ProgramRegistry:
    """Versioned multi-program serving over per-program MasterNode engines.

    One registry per serving process, thread-safe throughout: one condition
    guards the bookkeeping (entries, engines, LRU, swap/publish gates);
    engine builds, checkpoint saves and warm-ups run off the lock, so one
    program's activation never stalls another program's traffic.  Every
    engine is built on `device` (None: the card, as every entry point of
    the port; tests pass "cpu")."""

    def __init__(
        self,
        programs_dir: str | None = None,
        *,
        batch: int | None = None,
        engine: str = "auto",
        chunk_steps: int = 128,
        max_active: int | None = None,
        caps: dict | None = None,
        drain_timeout_s: float | None = None,
        device=None,
    ):
        self._dir = programs_dir
        self._tmpdir = None
        if programs_dir is None:
            self._tmpdir = tempfile.TemporaryDirectory(prefix="misaka-registry-")
            self._dir = self._tmpdir.name
        self._batch = batch
        self._engine = engine
        self._chunk = int(chunk_steps)
        self._caps = dict(caps or {})
        self._device = device
        if max_active is None:
            max_active = int(os.environ.get("MISAKA_REGISTRY_MAX_ACTIVE", "") or 4)
        self._max_active = max(1, int(max_active))
        if drain_timeout_s is None:
            drain_timeout_s = float(os.environ.get("MISAKA_SWAP_DRAIN_S", "") or 30.0)
        self._drain_s = float(drain_timeout_s)
        self._cond = threading.Condition()
        self._entries: dict[str, _Entry] = {}
        self._engines: dict[tuple[str, str], _Engine] = {}
        self._lru: dict[tuple[str, str], float] = {}
        self._swapping: set[str] = set()
        self._publishing: set[str] = set()
        # keys mid-deactivation: their drain checkpoint is being written
        # off the lock, and a re-activation must wait for it (or it would
        # build a fresh engine against a stale or absent snapshot)
        self._evicting: set[tuple[str, str]] = set()
        self._default: str | None = None
        self._closed = False
        if programs_dir is not None:
            self._load_store()
        ref = weakref.ref(self)
        M_PROG_ACTIVE.set_function(lambda: len(r._engines) if (r := ref()) is not None else 0)

    # --- persistence ----------------------------------------------------------

    def _name_dir(self, name: str) -> str:
        return os.path.join(self._dir, name)

    def _version_path(self, name: str, version: str) -> str:
        return os.path.join(self._name_dir(name), "versions", f"{version}.json")

    def _alias_path(self, name: str) -> str:
        return os.path.join(self._name_dir(name), "aliases.json")

    def _state_path(self, name: str, version: str) -> str:
        return os.path.join(self._name_dir(name), f"state-{version}.npz")

    def _load_store(self) -> None:
        """Boot: re-register every persisted program (nothing activates)."""
        try:
            names = sorted(os.listdir(self._dir))
        except OSError:
            return
        for name in names:
            if not NAME_RE.match(name):
                continue
            vdir = os.path.join(self._name_dir(name), "versions")
            try:
                vfiles = sorted(os.listdir(vdir))
            except OSError:
                continue
            entry = _Entry()
            for vf in vfiles:
                if not vf.endswith(".json"):
                    continue
                try:
                    with open(os.path.join(vdir, vf)) as f:
                        meta = json.load(f)
                    version = vf[: -len(".json")]
                    if version_of(meta["source"]) != version:
                        raise ValueError("content address mismatch")
                    entry.versions[version] = meta
                except (OSError, ValueError, KeyError) as e:
                    log.warning("registry: skipping corrupt version file %s/%s (%s)",
                                name, vf, e)
            if not entry.versions:
                continue
            try:
                with open(self._alias_path(name)) as f:
                    aliases = json.load(f)
                if aliases.get("latest") in entry.versions:
                    entry.aliases = {"latest": aliases["latest"]}
            except (OSError, ValueError):
                pass
            if "latest" not in entry.aliases:
                # fall back to the newest upload on record
                entry.aliases["latest"] = max(
                    entry.versions, key=lambda v: entry.versions[v].get("created_unix", 0))
            self._entries[name] = entry
            spec = entry.versions[entry.aliases["latest"]].get("slo")
            if spec:
                try:  # the latest version's objectives survive restarts
                    slo.set_objectives(name, spec)
                except slo.SLOSpecError:
                    log.warning("registry: ignoring corrupt slo spec on %s@%s",
                                name, entry.aliases["latest"])
            # persisted quota overrides are installed by install_quotas()
            # once make_http_server has built the process chain
            log.info("registry: loaded program %s (%d version(s), latest %s)",
                     name, len(entry.versions), entry.aliases["latest"])

    def _persist_version(self, name: str, version: str, meta: dict,
                         overwrite: bool = False) -> None:
        path = self._version_path(name, version)
        if os.path.exists(path) and not overwrite:
            return  # content-addressed: identical by construction
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, path)

    def _persist_aliases(self, name: str, aliases: dict) -> None:
        path = self._alias_path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(aliases, f)
        os.replace(tmp, path)

    # --- source parsing -------------------------------------------------------

    def parse_source(self, *, tis: str | None = None, topology_json: str | None = None,
                     compose: str | None = None) -> Topology:
        """One uploaded source body -> a Topology (exactly one form given).

        TIS source wraps into a single-node network (node "main"), line
        endings normalized (trailing newlines are kept: they cost a NOP
        slot, reference parity).  A topology JSON's own caps override the
        registry's.  Compose YAML maps through runtime/compose.py (PyYAML
        needed: without it the upload is refused)."""
        given = [s for s in (tis, topology_json, compose) if s is not None]
        if len(given) != 1:
            raise RegistryError(
                "provide exactly one of: program (TIS source), "
                "topology (JSON), compose (YAML)"
            )
        if tis is not None:
            source = tis.replace("\r\n", "\n")
            if not source.strip():
                raise RegistryError("empty TIS source")
            return Topology(node_info={"main": "program"}, programs={"main": source},
                            **self._caps)
        if topology_json is not None:
            try:
                raw = json.loads(topology_json)
            except ValueError as e:
                raise RegistryError(f"topology is not valid JSON: {e}") from e
            if not isinstance(raw, dict) or "nodes" not in raw:
                raise RegistryError('topology JSON must be {"nodes": ..., "programs": ...}')
            caps = dict(self._caps)
            for field in ("stack_cap", "in_cap", "out_cap"):
                if field in raw:
                    caps[field] = int(raw[field])
            return Topology(node_info=dict(raw["nodes"]),
                            programs=dict(raw.get("programs", {})), **caps)
        from misaka_tpu_torch.runtime.compose import ComposeError, parse_compose

        try:
            return parse_compose(compose, **self._caps)
        except ImportError:
            raise RegistryError("compose uploads need PyYAML, which this host lacks; "
                                "upload TIS source or topology JSON") from None
        except ComposeError as e:
            raise RegistryError(str(e)) from e

    # --- seeding (the boot program) ------------------------------------------

    def seed(self, name: str, master, topology: Topology | None = None) -> str:
        """Register the boot network + its LIVE engine under `name`.

        The seeded program is pinned: never LRU-evicted, never hot-swapped
        by publish (it stays under the /run /pause /reset /load lifecycle
        the HTTP surface binds to this master)."""
        if not NAME_RE.match(name):
            raise RegistryError(f"invalid program name {name!r}")
        topo = topology if topology is not None else master._topology
        canonical = canonical_topology(topo)
        version = version_of(canonical)
        meta = {"source": canonical, "created_unix": round(time.time(), 3), "seeded": True}
        with self._cond:
            entry = self._entries.setdefault(name, _Entry())
            entry.pinned = True
            entry.versions.setdefault(version, meta)
            entry.aliases["latest"] = version
            self._engines[(name, version)] = _Engine(master)
            self._lru[(name, version)] = time.monotonic()
            self._default = name
        master.program_label = name
        if self._tmpdir is None:
            self._persist_version(name, version, meta)
            self._persist_aliases(name, dict(entry.aliases))
        return version

    @property
    def default_name(self) -> str | None:
        return self._default

    @property
    def max_active(self) -> int:
        return self._max_active

    def waiting_values(self) -> int:
        """The ServeBatcher backlog summed over every active engine: the
        edge admission signal (the seeded default's engine is the boot
        master, so the sum covers the whole process)."""
        with self._cond:
            masters = [e.master for e in self._engines.values() if e.master is not None]
        total = 0
        for m in masters:
            b = getattr(m, "_batcher", None)
            if b is not None:
                total += b.waiting_values()
        return total

    def install_quotas(self, chain) -> None:
        """Install every program's latest `quota` override into an edge
        chain.  make_http_server calls this after building the process
        chain: the registry loads its store before the chain exists."""
        with self._cond:
            specs = {
                name: entry.versions[entry.aliases["latest"]].get("quota")
                for name, entry in self._entries.items()
                if entry.aliases.get("latest") in entry.versions
            }
        for name, spec in specs.items():
            if spec:
                try:
                    chain.set_program_quota(name, spec)
                except edge_mod.QuotaSpecError:
                    log.warning("registry: ignoring corrupt quota spec on %s", name)

    # --- publish / hot swap ---------------------------------------------------

    def publish(self, name: str, *, tis: str | None = None, topology_json: str | None = None,
                compose: str | None = None, slo_spec: str | None = None,
                quota_spec: str | None = None, verify: str | None = None) -> dict:
        """Upload one program version; hot-swap the live engine when the
        `latest` alias moves under it.

        Compile-first: the source is parsed, lowered and compiled at the
        registry's batch on its device before any bookkeeping mutates, so a
        bad upload is a 400 that touches nothing.  `slo_spec` (MISAKA_SLO
        grammar) and `quota_spec` (MISAKA_QUOTA grammar) are validated
        here and stored in the version's metadata; both overrides are
        installed (the SLO engine, the edge chain) when the version becomes
        `latest`.  verify="replay" first replays the program's captured
        requests on a shadow engine of the candidate (`_verify_replay`):
        ReplayDivergence on any differing byte, RegistryError when the
        capture cannot soundly verify it; either touches nothing."""
        if not NAME_RE.match(name):
            raise RegistryError(f"invalid program name {name!r}")
        if verify not in (None, "", "replay"):
            raise RegistryError(f"unknown verify mode {verify!r} (supported: replay)")
        if slo_spec is not None:
            try:
                slo.parse_spec(slo_spec)  # validate-first, like the source
            except slo.SLOSpecError as e:
                raise RegistryError(f"invalid slo spec: {e}") from e
        if quota_spec is not None:
            try:
                edge_mod.parse_quota_spec(quota_spec)
            except edge_mod.QuotaSpecError as e:
                raise RegistryError(f"invalid quota spec: {e}") from e
        topo = self.parse_source(tis=tis, topology_json=topology_json, compose=compose)
        topo.compile(batch=self._batch, device=self._device)  # raises before any swap
        if verify == "replay":
            self._verify_replay(name, topo)
        canonical = canonical_topology(topo)
        version = version_of(canonical)
        meta = {"source": canonical, "created_unix": round(time.time(), 3)}
        if slo_spec is not None:
            meta["slo"] = slo_spec
        if quota_spec is not None:
            meta["quota"] = quota_spec
        with self._cond:
            entry = self._entries.get(name)
            if entry is not None and entry.pinned:
                raise RegistryError(f"program {name!r} is the seeded boot program; "
                                    f"reprogram it through POST /load")
            while name in self._publishing:
                self._cond.wait()
            self._publishing.add(name)
        try:
            with self._cond:
                entry = self._entries.setdefault(name, _Entry())
                created = version not in entry.versions
                changed = False
                if created:
                    entry.versions[version] = meta
                else:
                    # dedup keeps the stored meta; an slo/quota
                    # re-declaration on a known version still lands
                    for field, spec in (("slo", slo_spec), ("quota", quota_spec)):
                        if spec is not None and entry.versions[version].get(field) != spec:
                            entry.versions[version][field] = spec
                            changed = True
                meta = entry.versions[version]
                prev = entry.aliases.get("latest")
                old_key = (name, prev) if prev is not None else None
                need_swap = prev is not None and prev != version and old_key in self._engines
            self._persist_version(name, version, meta, overwrite=changed)
            M_PROG_UPLOADS.inc()
            swapped = False
            if need_swap:
                self._hot_swap(name, version, old_key)
                swapped = True
            else:
                with self._cond:
                    entry.aliases["latest"] = version
                self._persist_aliases(name, {"latest": version})
            # the new `latest` owns this program's objectives and quota: a
            # latest without a spec clears the override back to the env
            # defaults.  A refused install (the SLO override budget) must
            # not fail the upload: the program serves under the defaults.
            try:
                slo.set_objectives(name, meta.get("slo"))
            except slo.SLOSpecError as e:
                log.warning("registry: slo override for %s not installed: %s", name, e)
            try:
                edge_mod.current().set_program_quota(name, meta.get("quota"))
            except edge_mod.QuotaSpecError as e:
                log.warning("registry: quota override for %s not installed: %s", name, e)
            return {"name": name, "version": version, "created": created, "latest": version,
                    "swapped": swapped}
        finally:
            with self._cond:
                self._publishing.discard(name)
                self._cond.notify_all()

    def _hot_swap(self, name: str, version: str, old_key: tuple[str, str]) -> None:
        """Replace the live alias engine with `version` under traffic.

          1. build, warm and run the new engine with no gate closed: live
             traffic keeps flowing to the old version meanwhile;
          2. close the park gate (`_swapping`): alias-addressed requests
             arriving now wait (they will serve on the new version);
          3. flip the alias, install the new engine, retire the old one
             from the active set (no new lease can reach it), open the
             gate: parked requests resolve the new alias and go;
          4. drain: wait for the old engine's in-flight leases, then
             checkpoint it (`name@<old>` revives with its state) and close
             it.

        The `swap_during_load` fault point (utils/faults.py) sleeps with
        the gate closed, widening the parked window."""
        new_master = self._build_master(name, version, fresh=True)
        with self._cond:
            self._swapping.add(name)
        try:
            entry = self._entries[name]
            delay = faults.fire("swap_during_load")
            if delay is not None:
                time.sleep(max(0.0, delay))
            with self._cond:
                entry.aliases["latest"] = version
                # Retire only a READY old engine.  A mid-build placeholder
                # (an explicit name@<old> activation still building) is
                # left alone: its builder installs it under the old key.
                old = self._engines.get(old_key)
                if old is not None and old.ready.is_set() and old.error is None \
                        and not old.closed:
                    del self._engines[old_key]
                    self._lru.pop(old_key, None)
                    # gate re-activation of the old version in the same
                    # critical section that removes it: a name@<old>
                    # request must wait for the drain checkpoint
                    self._evicting.add(old_key)
                else:
                    old = None
                # Install the replacement only if no engine occupies the
                # new key: an explicit name@<new> activation may have got
                # there first; ours is then surplus and discarded below.
                surplus = None
                if (name, version) in self._engines:
                    surplus = new_master
                else:
                    self._engines[(name, version)] = _Engine(new_master)
                    self._lru[(name, version)] = time.monotonic()
        finally:
            with self._cond:
                self._swapping.discard(name)
                self._cond.notify_all()
        self._persist_aliases(name, {"latest": version})
        M_PROG_SWAPS.labels(program=_program_label(name)).inc()
        log.info("program %s hot-swapped %s -> %s", name, old_key[1], version)
        if surplus is not None:
            self._deactivate_engine((name, version), surplus, checkpoint=False)
        if old is not None:
            self._retire(old_key, old)

    def _verify_replay(self, name: str, topo) -> None:
        """The ``?verify=replay`` deploy gate: drive the program's newest
        captured requests (MISAKA_REPLAY_VERIFY_MAX) through a shadow
        engine compiled from the candidate, on the registry's device,
        restored to the capture's anchor state first.  Any differing byte,
        or an anchor the candidate cannot hold, raises ReplayDivergence;
        an unsound capture (no anchor, evicted records, the recorder
        killed) raises RegistryError.  No live engine is touched, and the
        shadow's device state is freed when the gate returns (close() and
        the `del` below drop the last references)."""
        from misaka_tpu_torch.runtime import capture as capture_mod
        from misaka_tpu_torch.runtime.master import MasterNode

        try:
            anchor, recs = capture_mod.verify_bundle(name)
        except capture_mod.CaptureError as e:
            raise RegistryError(f"verify=replay refused: {e}") from e
        shadow = MasterNode(topo, chunk_steps=self._chunk, batch=self._batch,
                            engine=self._engine, device=self._device)
        try:
            try:
                shadow.restore(anchor["state"])
            except ValueError as e:
                # a candidate that cannot hold the anchor state is not
                # answer-compatible with the capture
                raise ReplayDivergence(
                    f"candidate for {name!r} cannot restore the capture anchor: {e}") from e
            shadow.run()
            diffs = capture_mod.replay_records(shadow, recs)
        finally:
            try:
                shadow.close()
            except Exception:
                log.warning("replay shadow close failed", exc_info=True)
            # a ReplayDivergence's traceback keeps this frame: it must not
            # keep the shadow's device state too
            del shadow
        if diffs:
            for d in diffs:
                log.warning("registry: %s", capture_mod.format_diff(d))
            raise ReplayDivergence(
                f"candidate for {name!r} diverged on {len(diffs)}/{len(recs)} captured "
                f"requests", diffs=diffs)
        log.info("registry: verify=replay green for %s (%d captured requests byte-identical)",
                 name, len(recs))
        self._verify_replay_history(name, topo, capture_mod, MasterNode)

    def _verify_replay_history(self, name, topo, capture_mod, MasterNode) -> None:
        """With the capture spool armed, widen the gate past the live ring:
        replay the newest MISAKA_REPLAY_HISTORY rotated segments (default
        2) against the candidate too, each on a shadow restored to that
        segment's anchor.  Unsound segments are skipped (the ring's bundle
        above is the gate's floor); a divergence on any swept segment
        refuses the deploy as loudly."""
        try:
            depth = int(os.environ.get("MISAKA_REPLAY_HISTORY", "") or 2)
        except ValueError:
            depth = 2
        if depth <= 0 or capture_mod.spool_status() is None:
            return
        for apath, hrecs, seg in capture_mod.history_bundles(name, limit_segments=depth):
            try:
                _meta, state = capture_mod.load_anchor_checkpoint(apath)
            except Exception as e:
                log.warning("registry: history anchor %s unreadable: %s", apath, e)
                continue
            shadow = MasterNode(topo, chunk_steps=self._chunk, batch=self._batch,
                                engine=self._engine, device=self._device)
            try:
                try:
                    shadow.restore(state)
                except ValueError as e:
                    raise ReplayDivergence(
                        f"candidate for {name!r} cannot restore the history anchor "
                        f"from {seg}: {e}") from e
                shadow.run()
                diffs = capture_mod.replay_records(shadow, hrecs)
            finally:
                try:
                    shadow.close()
                except Exception:
                    log.warning("replay shadow close failed", exc_info=True)
                del shadow
            if diffs:
                for d in diffs:
                    log.warning("registry: %s", capture_mod.format_diff(d))
                raise ReplayDivergence(
                    f"candidate for {name!r} diverged on {len(diffs)}/{len(hrecs)} requests "
                    f"from history segment {seg}", diffs=diffs)
            log.info("registry: verify=replay history green for %s over %s (%d requests)",
                     name, os.path.basename(seg), len(hrecs))

    def _retire(self, key: tuple[str, str], eng: _Engine) -> None:
        """Drain a just-replaced engine and deactivate it (checkpoint +
        close).  _hot_swap already put `key` in `_evicting`; this method
        releases that gate, except when the drain outlives
        MISAKA_SWAP_DRAIN_S: the engine is then still live with in-flight
        leases, the gate stays armed, and the last lease-holder's _checkin
        writes the drain checkpoint and releases it."""
        deadline = time.monotonic() + self._drain_s
        with self._cond:
            while eng.leases > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    eng.retired = True
                    log.warning("program %s@%s: %d request(s) still in flight after "
                                "%.0fs drain; closing when they finish",
                                key[0], key[1], eng.leases, self._drain_s)
                    return  # the gate stays armed for _checkin
                self._cond.wait(min(0.25, remaining))
            if eng.closed:
                self._evicting.discard(key)
                self._cond.notify_all()
                return
            eng.closed = True
        self._deactivate_guarded(key, eng.master, checkpoint=True)

    # --- activation / eviction -----------------------------------------------

    def _build_master(self, name: str, version: str, fresh: bool = False):
        """Construct, restore (unless `fresh`), warm and run one engine.
        Runs off the registry lock."""
        with self._cond:
            entry = self._entries.get(name)
            if entry is None or version not in entry.versions:
                raise ProgramNotFound(f"unknown program {name!r}@{version}")
            source = entry.versions[version]["source"]
        from misaka_tpu_torch.runtime.master import MasterNode

        t0 = time.perf_counter()
        master = MasterNode(topology_from_canonical(source), chunk_steps=self._chunk,
                            batch=self._batch, engine=self._engine, device=self._device,
                            # the native ladder's compiled rungs, cached beside
                            # the version store (reused on reactivation)
                            native_spec_dir=os.path.join(self._name_dir(name), "native"))
        master.program_label = name
        t1 = time.perf_counter()
        ckpt = self._state_path(name, version)
        if not fresh and os.path.exists(ckpt):
            try:
                master.load_checkpoint(ckpt)  # manifest-verified restore
                log.info("program %s@%s: state restored from eviction checkpoint",
                         name, version)
            except Exception as e:
                # a corrupt eviction checkpoint costs the state, never the
                # activation: the manifest gate already rejected it
                log.warning("program %s@%s: eviction checkpoint rejected (%s); "
                            "activating with fresh state", name, version, e)
        t2 = time.perf_counter()
        # the first chunk's one-time costs on throwaway state, so the first
        # (possibly parked-behind-a-swap) request never pays them
        master.warm()
        master.run()
        t3 = time.perf_counter()
        log.info("program %s@%s: engine up in %.3fs (build %.3f, restore %.3f, warm-up %.3f)",
                 name, version, t3 - t0, t1 - t0, t2 - t1, t3 - t2)
        return master

    def _deactivate_guarded(self, key, master, checkpoint: bool) -> None:
        """Deactivate with the re-activation gate held, then release it.
        The caller added `key` to `_evicting` in the same critical section
        that removed the engine from `_engines`; _checkout parks on the
        gate until the drain checkpoint is committed."""
        try:
            self._deactivate_engine(key, master, checkpoint)
        finally:
            with self._cond:
                self._evicting.discard(key)
                self._cond.notify_all()

    def _deactivate_engine(self, key, master, checkpoint: bool) -> None:
        name, version = key
        try:
            master.pause()
        except Exception:  # deactivation is best-effort
            log.exception("pausing %s@%s failed", name, version)
        if checkpoint:
            try:
                os.makedirs(self._name_dir(name), exist_ok=True)
                master.save_checkpoint(self._state_path(name, version), include_history=False)
            except Exception:
                log.exception("eviction checkpoint for %s@%s failed; state lost",
                              name, version)
        try:
            master.close()
        except Exception:
            log.exception("closing %s@%s failed", name, version)

    def _evict_over_cap(self, exclude: tuple[str, str]) -> None:
        """Drop the least-recently-used idle engines until the active set
        (ready + building) fits MISAKA_REGISTRY_MAX_ACTIVE.  Runs off the
        lock per victim, on the activating thread; never evicts the pinned
        boot program, a busy engine, or `exclude`."""
        while True:
            with self._cond:
                if len(self._engines) <= self._max_active:
                    return
                candidates = [
                    k for k, e in self._engines.items()
                    if k != exclude and e.ready.is_set() and e.error is None
                    and e.leases == 0 and not self._entries[k[0]].pinned
                ]
                if not candidates:
                    return  # everything is busy or pinned: run over cap
                victim = min(candidates, key=lambda k: self._lru.get(k, 0.0))
                eng = self._engines.pop(victim)
                self._lru.pop(victim, None)
                eng.closed = True
                self._evicting.add(victim)  # same critical section as the pop
            log.info("registry: evicting cold program %s@%s", *victim)
            self._deactivate_guarded(victim, eng.master, checkpoint=True)
            M_PROG_EVICTIONS.labels(program=_program_label(victim[0])).inc()

    def deactivate(self, ref: str | None = None) -> bool:
        """Evict one program's active engine now; True when an engine was
        active and is now checkpointed and closed."""
        with self._cond:
            name, version = self._resolve_locked(ref)
            if self._entries[name].pinned:
                raise RegistryError(f"program {name!r} is the seeded boot program")
            key = (name, version)
            eng = self._engines.get(key)
            if eng is None:
                return False
            deadline = time.monotonic() + self._drain_s
            while (eng.leases > 0 or not eng.ready.is_set()) and time.monotonic() < deadline:
                # not ready: an activation is mid-build; wait for it like a
                # lease
                self._cond.wait(0.25)
            if eng.leases > 0 or not eng.ready.is_set():
                raise RegistryError(f"program {name}@{version} is busy "
                                    f"({eng.leases} request(s) in flight)")
            if self._engines.get(key) is not eng:
                return False  # evicted or retired by someone else meanwhile
            del self._engines[key]
            self._lru.pop(key, None)
            eng.closed = True
            self._evicting.add(key)  # same critical section as the pop
        self._deactivate_guarded(key, eng.master, checkpoint=True)
        M_PROG_EVICTIONS.labels(program=_program_label(name)).inc()
        return True

    # --- request-side surface ------------------------------------------------

    def _resolve_locked(self, ref: str | None) -> tuple[str, str]:
        """`ref` -> (name, version); callers hold self._cond.  None or ""
        is the seeded default; "name" and "name@latest" follow the alias;
        "name@<version>" is exact.  Unknowns raise ProgramNotFound."""
        if ref is None or ref == "":
            if self._default is None:
                raise ProgramNotFound("no default program seeded")
            ref = self._default
        name, _, version = str(ref).partition("@")
        entry = self._entries.get(name)
        if entry is None:
            raise ProgramNotFound(f"unknown program {name!r}")
        if version in ("", "latest"):
            version = entry.aliases.get("latest")
            if version is None:
                raise ProgramNotFound(f"program {name!r} has no versions")
        elif version not in entry.versions:
            raise ProgramNotFound(f"program {name!r} has no version {version!r}")
        return name, version

    def resolve(self, ref: str | None) -> tuple[str, str]:
        with self._cond:
            return self._resolve_locked(ref)

    def _checkout(self, ref: str | None):
        """Resolve + lease one engine, activating it if cold.  Parks while
        the program's alias is mid-swap (re-resolving after, so a parked
        request serves on the new version)."""
        deadline = time.monotonic() + self._drain_s
        while True:
            build = False
            with self._cond:
                if self._closed:
                    raise RegistryError("registry is closed")
                name, version = self._resolve_locked(ref)
                if name in self._swapping:
                    # parked: the publish gate is closed for the flip
                    if not self._cond.wait(0.05) and time.monotonic() > deadline:
                        raise RegistryError(f"program {name!r} swap did not complete "
                                            f"within {self._drain_s}s")
                    continue
                key = (name, version)
                if key in self._evicting:
                    # this version's drain checkpoint is being committed:
                    # wait for it, deadline-bounded (a wedged save must
                    # surface as a typed error)
                    self._cond.wait(0.05)
                    if time.monotonic() > deadline:
                        raise RegistryError(f"program {name}@{version} deactivation did "
                                            f"not complete within {self._drain_s}s")
                    continue
                eng = self._engines.get(key)
                if eng is None:
                    eng = _Engine()
                    self._engines[key] = eng
                    self._lru[key] = time.monotonic()
                    build = True
                elif eng.ready.is_set() and eng.error is None:
                    eng.leases += 1
                    self._lru[key] = time.monotonic()
                    return key, eng
            if build:
                try:
                    self._evict_over_cap(exclude=key)
                    master = self._build_master(name, version)
                except BaseException as e:
                    with self._cond:
                        eng.error = e
                        if self._engines.get(key) is eng:
                            del self._engines[key]
                            self._lru.pop(key, None)
                        eng.ready.set()
                        self._cond.notify_all()
                    raise
                doomed = False
                with self._cond:
                    if self._closed:
                        # close() ran while this engine was building:
                        # installing it would leak a running master
                        eng.error = RegistryError("registry is closed")
                        self._engines.pop(key, None)
                        self._lru.pop(key, None)
                        eng.ready.set()
                        self._cond.notify_all()
                        doomed = True
                    else:
                        eng.master = master
                        eng.ready.set()
                        eng.leases += 1
                        self._lru[key] = time.monotonic()
                        self._cond.notify_all()
                if doomed:
                    self._deactivate_engine(key, master, checkpoint=False)
                    raise RegistryError("registry is closed")
                M_PROG_ACTIVATIONS.labels(program=_program_label(name)).inc()
                return key, eng
            # someone else is building (or it raced away): wait and retry
            eng.ready.wait(timeout=60.0)
            with self._cond:
                if eng.error is None and eng.ready.is_set() \
                        and self._engines.get(key) is eng and not eng.retired:
                    eng.leases += 1
                    self._lru[key] = time.monotonic()
                    return key, eng
                if isinstance(eng.error, BaseException):
                    raise RegistryError(
                        f"activating {name}@{version} failed: {eng.error}") from eng.error
            # evicted or retired between resolve and lease: retry

    def _checkin(self, key, eng: _Engine) -> None:
        close = False
        with self._cond:
            eng.leases -= 1
            if eng.leases == 0:
                self._cond.notify_all()
                if eng.retired and not eng.closed:
                    eng.closed = True
                    self._evicting.add(key)  # same critical section
                    close = True
        if close:
            # a hot-swap drain timed out and handed closing to the last
            # request out: the engine is quiescent now, so the drain
            # checkpoint is still written
            self._deactivate_guarded(key, eng.master, checkpoint=True)

    @contextlib.contextmanager
    def lease(self, ref: str | None = None, values: int = 0):
        """The request-side entry point: resolve `ref`, activate if
        needed, park through a swap, count the per-program series, and
        yield the engine for the request's lifetime, with the program made
        current on this thread (runtime/usage.py: utils/jsonlog.py writes
        it on the lines logged meanwhile)."""
        key, eng = self._checkout(ref)
        label = _program_label(key[0])
        M_PROG_REQS.labels(program=label).inc()
        if values:
            M_PROG_VALUES.labels(program=label).inc(values)
        try:
            with usage.program_scope(key[0]):
                yield eng.master
        finally:
            self._checkin(key, eng)

    # --- introspection --------------------------------------------------------

    def list_programs(self) -> dict:
        with self._cond:
            active = {k: e.leases for k, e in self._engines.items()
                      if e.ready.is_set() and e.error is None}
            programs = {}
            for name, entry in self._entries.items():
                programs[name] = {
                    "latest": entry.aliases.get("latest"),
                    "pinned": entry.pinned,
                    "default": name == self._default,
                    # the usage ledger: None until the program serves
                    "usage": usage.program_snapshot(name),
                    "versions": {
                        v: {
                            "created_unix": meta.get("created_unix"),
                            "active": (name, v) in active,
                            "leases": active.get((name, v), 0),
                            "checkpoint": os.path.exists(self._state_path(name, v)),
                        }
                        for v, meta in entry.versions.items()
                    },
                }
        return {"max_active": self._max_active, "active_engines": len(active),
                "programs": programs}

    def info(self, name: str) -> dict:
        listing = self.list_programs()
        if name not in listing["programs"]:
            raise ProgramNotFound(f"unknown program {name!r}")
        return {"name": name, **listing["programs"][name]}

    def summary(self) -> dict:
        """The /status payload: small, no filesystem walks."""
        with self._cond:
            return {
                "max_active": self._max_active,
                "active": sorted(f"{n}@{v}" for (n, v), e in self._engines.items()
                                 if e.ready.is_set() and e.error is None),
                "names": sorted(self._entries),
                "default": self._default,
            }

    def active_versions(self) -> list[tuple[str, str]]:
        """Active (name, version) pairs, least-recently-used first."""
        with self._cond:
            return sorted(self._engines, key=lambda k: self._lru.get(k, 0.0))

    def active_masters(self) -> list[tuple[str, object]]:
        """(name, master) for every ready engine."""
        with self._cond:
            return [(n, e.master) for (n, _v), e in self._engines.items()
                    if e.ready.is_set() and e.error is None and e.master is not None]

    # --- lifecycle ------------------------------------------------------------

    def close(self) -> None:
        """Checkpoint + close every registry-built engine (the pinned boot
        engine belongs to the caller and is left running).  In-flight
        leases get a bounded grace window to finish first."""
        with self._cond:
            self._closed = True  # no new checkouts past this point
            self._cond.notify_all()
            victims = [(k, e) for k, e in self._engines.items()
                       if not self._entries[k[0]].pinned and e.ready.is_set()
                       and e.error is None and not e.closed]
            deadline = time.monotonic() + min(self._drain_s, 10.0)
            while any(e.leases > 0 for _, e in victims):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    log.warning("registry close: request(s) still in flight after the "
                                "grace window; closing anyway")
                    break
                self._cond.wait(min(0.25, remaining))
            for k, e in victims:
                self._engines.pop(k, None)
                self._lru.pop(k, None)
                e.closed = True
            self._cond.notify_all()
        for k, e in victims:
            self._deactivate_engine(k, e.master, checkpoint=True)
        if self._tmpdir is not None:
            self._tmpdir.cleanup()
            self._tmpdir = None
