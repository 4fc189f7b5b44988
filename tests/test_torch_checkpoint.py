""".npz checkpoints move between the JAX package and the port, both ways.

A JAX `MasterNode.save_checkpoint` file loads into the port's master, and a
port checkpoint loads into the JAX master: the installed state equals the
saved one field by field, stays equal after further ticks of each
package's engine, and keeps serving the same answers.  A truncated file, a
flipped byte and a batch mismatch are refused before anything is swapped;
a JAX checkpoint carrying its metric history (`__tsdb__`) loads, and so
does one written before the 64-bit registers (no hi planes).  The HTTP
routes answer as the JAX server's, and a restored state's in-flight values
never pair with a later request (the restore flush).

running_total keeps a total per instance, so every comparison below is of
real, stateful state.
"""

import json
import os
import threading
import urllib.error
import urllib.parse
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

from misaka_tpu.runtime.master import CheckpointError as JCheckpointError
from misaka_tpu.runtime.master import MasterNode as JMaster
from misaka_tpu.runtime.master import make_http_server as j_http
from misaka_tpu.runtime.topology import Topology as JTopology
from misaka_tpu_torch import networks
from misaka_tpu_torch.core.state import NetworkState, state_from_numpy, state_to_numpy
from misaka_tpu_torch.runtime.checkpoint import CheckpointError, manifest_path
from misaka_tpu_torch.runtime.master import MasterNode, make_http_server
from misaka_tpu_torch.runtime.topology import Topology
from misaka_tpu_torch.utils import tsdb as ttsdb

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
CAPS = dict(in_cap=8, out_cap=8, stack_cap=8)
BATCH = 4
TICKS = 40


def running_total_text():
    with open(os.path.join(EXAMPLES, "running_total.json")) as f:
        return f.read()


def jax_master():
    return JMaster(JTopology.from_json(running_total_text(), **CAPS), chunk_steps=32,
                   batch=BATCH, engine="scan")


def port_master(**kw):
    return MasterNode(Topology.from_json(running_total_text(), **CAPS), chunk_steps=32,
                      batch=BATCH, device="cpu", **kw)


def jax_fields(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def assert_fields_equal(a: dict, b: dict):
    assert set(a) == set(b) == set(NetworkState._fields)
    for f in NetworkState._fields:
        assert a[f].dtype == b[f].dtype, f
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def serve_some(master, seed):
    """Stateful traffic: stripes over every instance, then a pinned stream."""
    rng = np.random.default_rng(seed)
    master.run()
    master.compute_spread(rng.integers(-500, 500, size=32).astype(np.int32))
    master.compute_many(rng.integers(-500, 500, size=5).astype(np.int32))
    master.pause()


def advance_both(jm, tm):
    """TICKS more ticks of each package's own engine from its live state."""
    j = jax_fields(jm._net.run(jm.snapshot(), TICKS))
    t = state_to_numpy(tm._net.run(tm.snapshot(), TICKS))
    return j, t


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    jm, tm = jax_master(), port_master()
    try:
        serve_some(jm, 1)
        path = str(tmp_path / "jax.npz")
        jm.save_checkpoint(path)
        tm.load_checkpoint(path)
        assert not tm.is_running  # paused, as the JAX master leaves it
        assert_fields_equal(state_to_numpy(tm.snapshot()), jax_fields(jm.snapshot()))
        assert tm._topology.programs == jm._topology.programs
        j, t = advance_both(jm, tm)
        assert_fields_equal(t, j)
        # both keep serving the same answers from the restored totals
        jm.run()
        tm.run()
        vals = np.arange(1, 41, dtype=np.int32)
        assert tm.compute_spread(vals) == jm.compute_spread(vals)
    finally:
        jm.close()
        tm.close()


def test_port_checkpoint_loads_into_jax(tmp_path):
    # no collector in this process (an earlier test's may run): no history
    # blob, as the JAX master writes none without one (a checkpoint with
    # history crosses both ways in tests/test_torch_observatory.py)
    ttsdb.shutdown()
    jm, tm = jax_master(), port_master()
    try:
        serve_some(tm, 2)
        path = str(tmp_path / "port.npz")
        tm.save_checkpoint(path)
        with open(manifest_path(path)) as f:
            manifest = json.load(f)
        assert manifest["format"] == 1 and manifest["batch"] == BATCH
        assert manifest["size"] == os.path.getsize(path)
        with np.load(path) as data:
            assert "__tsdb__" not in data.files
            assert data["holding"].dtype == bool and data["acc"].dtype == np.int32
        jm.load_checkpoint(path)
        assert_fields_equal(jax_fields(jm.snapshot()), state_to_numpy(tm.snapshot()))
        j, t = advance_both(jm, tm)
        assert_fields_equal(j, t)
        jm.run()
        tm.run()
        vals = np.arange(-20, 20, dtype=np.int32)
        assert jm.compute_spread(vals) == tm.compute_spread(vals)
    finally:
        jm.close()
        tm.close()


def test_jax_checkpoint_with_tsdb_history_loads(tmp_path):
    jm, tm = jax_master(), port_master()
    try:
        serve_some(jm, 3)
        plain = str(tmp_path / "plain.npz")
        jm.save_checkpoint(plain)
        with np.load(plain) as data:
            arrays = {k: data[k] for k in data.files}
        arrays["__tsdb__"] = np.frombuffer(b"metric history blob", np.uint8)
        path = str(tmp_path / "with_tsdb.npz")
        np.savez(path, **arrays)  # no manifest: the zip CRC walk verifies
        tm.load_checkpoint(path)
        assert_fields_equal(state_to_numpy(tm.snapshot()), jax_fields(jm.snapshot()))
    finally:
        jm.close()
        tm.close()


def test_checkpoint_without_hi_planes_sign_extends(tmp_path):
    tm = port_master()
    try:
        serve_some(tm, 4)
        path = str(tmp_path / "full.npz")
        tm.save_checkpoint(path)
        with np.load(path) as data:
            arrays = {k: data[k] for k in data.files if k not in ("acc_hi", "bak_hi")}
        arrays["acc"][0, 0] = -5
        old = str(tmp_path / "old.npz")
        np.savez(old, **arrays)
        tm.load_checkpoint(old)
        st = state_to_numpy(tm.snapshot())
        np.testing.assert_array_equal(st["acc_hi"], arrays["acc"] >> 31)
        np.testing.assert_array_equal(st["bak_hi"], arrays["bak"] >> 31)
        assert st["acc_hi"][0, 0] == -1
    finally:
        tm.close()


@pytest.mark.parametrize("damage", ["truncate", "flip"])
def test_corrupt_checkpoint_is_refused_before_any_swap(tmp_path, damage):
    tm = port_master()
    try:
        serve_some(tm, 5)
        path = str(tmp_path / "c.npz")
        tm.save_checkpoint(path)
        if damage == "truncate":
            with open(path, "r+b") as f:
                f.truncate(os.path.getsize(path) // 2)
        else:  # one byte of the stack_mem member's data
            with zipfile.ZipFile(path) as z:
                info = z.getinfo("stack_mem.npy")
            with open(path, "r+b") as f:
                f.seek(info.header_offset + 26)
                name_len, extra_len = np.frombuffer(f.read(4), "<u2")
                f.seek(info.header_offset + 30 + int(name_len) + int(extra_len)
                       + info.file_size - 1)
                b = f.read(1)
                f.seek(-1, 1)
                f.write(bytes([b[0] ^ 0xFF]))
        state = tm._state
        with pytest.raises(CheckpointError, match="rejected"):
            tm.load_checkpoint(path)
        assert tm._state is state  # nothing swapped
        tm.run()
        with pytest.raises(CheckpointError, match="rejected"):
            tm.load_checkpoint(path)
        assert tm.is_running  # nothing stopped
        # the JAX package refuses the same file
        jm = jax_master()
        with pytest.raises(JCheckpointError):
            jm.load_checkpoint(path)
        jm.close()
    finally:
        tm.close()


def test_batch_mismatch_is_refused(tmp_path):
    tm = port_master()
    other = MasterNode(Topology.from_json(running_total_text(), **CAPS), chunk_steps=32,
                       batch=2, device="cpu")
    try:
        path = str(tmp_path / "b2.npz")
        other.save_checkpoint(path)
        net = tm._net
        with pytest.raises(ValueError, match="batch=2 does not match"):
            tm.load_checkpoint(path)
        assert tm._net is net
    finally:
        tm.close()
        other.close()


def test_restore_flush_discards_in_flight_values():
    """A snapshot holding values in its input ring: after restore those
    values' outputs have no request, and must never reach a new one."""
    m = MasterNode(networks.add2(**CAPS), chunk_steps=32, batch=1, device="cpu")
    try:
        st = m._net.feed_batched(m.snapshot(), np.full((1, 8), 100, np.int32),
                                 np.array([5], np.int32))
        m.restore(st)
        assert m._restore_flush
        m.run()
        for v in (5, -3, 0):
            assert m.compute_many([v], timeout=30) == [v + 2]
    finally:
        m.close()


def test_restore_installs_owned_copies():
    m = port_master()
    try:
        snap = m.snapshot()
        m.restore(snap)
        assert all(a.data_ptr() != b.data_ptr() for a, b in zip(m._state, snap))
        arrays = state_to_numpy(snap)
        m.restore(state_from_numpy(arrays))
        arrays["acc"][:] = 7  # the caller's arrays stay theirs
        assert int(m._state.acc.abs().sum()) == 0
    finally:
        m.close()


# --- the HTTP routes ------------------------------------------------------------


def _serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(base, path, **fields):
    req = urllib.request.Request(base + path, data=urllib.parse.urlencode(fields).encode())
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_checkpoint_routes_match_jax(tmp_path, monkeypatch):
    # The answers depend on which instance each /compute lands on.  With
    # the serve scheduler on, that follows how often its workers rotated
    # the start slot (timing, in either package); with it off, one caller's
    # requests rotate it once each, the same on both masters.
    for switch in ("MISAKA_SAMPLER", "MISAKA_TSDB", "MISAKA_WATCHDOG", "MISAKA_SERVE_BATCH"):
        monkeypatch.setenv(switch, "0")
    jm, tm = jax_master(), port_master()
    jh = j_http(jm, port=0, checkpoint_dir=str(tmp_path / "jax"))
    th = make_http_server(tm, port=0, checkpoint_dir=str(tmp_path / "port"))
    jb, tb = _serve(jh), _serve(th)
    try:
        steps = [
            ("/run", {}), ("/compute", {"value": "5"}), ("/compute", {"value": "6"}),
            ("/checkpoint", {"name": "c1"}), ("/checkpoint", {"name": "../up"}),
            ("/checkpoint", {"name": ""}), ("/compute", {"value": "100"}),
            ("/restore", {"name": "c1"}), ("/compute", {"value": "1"}),  # paused: 400
            ("/run", {}), ("/compute", {"value": "1"}), ("/restore", {"name": "a/b"}),
        ]
        for path, fields in steps:
            assert _post(tb, path, **fields) == _post(jb, path, **fields), (path, fields)
        # the same file names on disk, and the port's file loads in the JAX
        # package
        assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
        with zipfile.ZipFile(tmp_path / "port" / "c1.npz") as z:
            assert "__topology__.npy" in z.namelist()
        jm.load_checkpoint(str(tmp_path / "port" / "c1.npz"))
        # a missing and a damaged file: 400 on both, the reason named
        for base, d in ((jb, "jax"), (tb, "port")):
            assert _post(base, "/restore", name="nosuch")[0] == 400
            with open(tmp_path / d / "c1.npz", "r+b") as f:
                f.truncate(100)
            code, body = _post(base, "/restore", name="c1")
            assert code == 400 and body.startswith(b"error restoring checkpoint:")
    finally:
        for h, m in ((jh, jm), (th, tm)):
            h.shutdown()
            h.server_close()
            m.close()
