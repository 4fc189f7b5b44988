"""The port's segment spool (utils/spool.py) against the JAX package's.

The spool cases of tests/test_durable.py on both packages: a torn tail
truncated in place and appended after, a garbage frame body cut away, the
disk budget evicting the oldest segments (never the active one) with the
newest frames kept whole.  Each case writes the same frames (drawn from a
numpy generator with a fixed seed) through both packages into two
directories, and the two directories must hold the same bytes, file by
file.  Then the cross-package reads: a segment written by either package
reloads in the other with the same frames, its torn tail repaired, and
the other package appends after it.
"""

import os
import struct

import numpy as np
import pytest

from misaka_tpu.utils import spool as jspool
from misaka_tpu_torch.utils import spool as tspool

SPOOLS = {"jax": jspool, "torch": tspool}


def frames(n, seed=3):
    rng = np.random.default_rng(seed)
    return [{"i": i, "v": [int(x) for x in rng.integers(-2**31, 2**31 - 1, size=4)],
             "pad": "x" * int(rng.integers(0, 300))} for i in range(n)]


def dir_bytes(d):
    return {name: open(os.path.join(d, name), "rb").read() for name in sorted(os.listdir(d))}


def write(mod, d, objs, **kw):
    evicted = []
    sp = mod.SegmentSpool(str(d), prefix="t", on_evict=evicted.append, **kw)
    for obj in objs:
        assert sp.append(obj)
        sp.flush()
    segs = [os.path.basename(p) for _, p in sp.segments()]
    sp.close()
    return segs, evicted


def test_segments_byte_equal_across_packages(tmp_path):
    objs = frames(50)
    out = {name: write(mod, tmp_path / name, objs) for name, mod in SPOOLS.items()}
    assert out["jax"] == out["torch"]
    assert dir_bytes(tmp_path / "jax") == dir_bytes(tmp_path / "torch")
    blob = next(iter(dir_bytes(tmp_path / "torch").values()))
    assert blob.startswith(b"MSKSPL1\n")


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_torn_tail_truncated_and_continued_across_packages(tmp_path, writer, reader):
    objs = frames(3)
    write(SPOOLS[writer], tmp_path, objs)
    [path] = [os.path.join(tmp_path, n) for n in os.listdir(tmp_path)]
    good_size = os.path.getsize(path)
    with open(path, "ab") as f:  # a kill mid-append: a length past the end
        f.write(struct.pack("<I", 64) + b"torn")
    sp = SPOOLS[reader].SegmentSpool(str(tmp_path), prefix="t")
    seen = []
    assert sp.reload(seen.append) == 3
    assert seen == objs and os.path.getsize(path) == good_size
    assert sp.append({"i": 3})
    sp.flush()
    sp.close()
    for mod in SPOOLS.values():  # both read the continued segment back
        seen = []
        sp = mod.SegmentSpool(str(tmp_path), prefix="t")
        assert sp.reload(seen.append) == 4
        sp.close()
        assert seen == objs + [{"i": 3}]


@pytest.mark.parametrize("name", list(SPOOLS))
def test_garbage_tail_truncated_equal(tmp_path, name):
    results = {}
    for pkg, mod in SPOOLS.items():
        d = tmp_path / pkg
        write(mod, d, [{"ok": True}])
        [path] = [os.path.join(d, n) for n in os.listdir(d)]
        blob = b"\xff\xfe not json"
        with open(path, "ab") as f:
            f.write(struct.pack("<I", len(blob)) + blob)
        sp = SPOOLS[name].SegmentSpool(str(d), prefix="t")
        seen = []
        results[pkg] = (sp.reload(seen.append), seen)
        sp.close()
    assert results["jax"] == results["torch"] == (1, [{"ok": True}])
    assert dir_bytes(tmp_path / "jax") == dir_bytes(tmp_path / "torch")


def test_budget_evicts_oldest_never_active_equal(tmp_path):
    objs = frames(400, seed=11)
    for obj in objs:
        obj["pad"] = "x" * 400
    out = {name: write(mod, tmp_path / name, objs, budget_bytes=1 << 16,
                       segment_bytes=1 << 12) for name, mod in SPOOLS.items()}
    assert out["jax"] == out["torch"]
    assert dir_bytes(tmp_path / "jax") == dir_bytes(tmp_path / "torch")
    segs, evicted = out["torch"]
    assert segs and segs[0] != "t-00000000.seg" and sum(evicted) > 0
    sp = tspool.SegmentSpool(str(tmp_path / "torch"), prefix="t")
    ids = []
    sp.read_frames(lambda fr: ids.append(fr["i"]))
    assert sp.disk_bytes() <= 1 << 16
    sp.close()
    assert ids == list(range(ids[0], 400))  # a contiguous newest suffix


def test_spool_errors_series_equal():
    for mod in SPOOLS.values():
        assert mod.MAGIC == b"MSKSPL1\n"
    assert tspool.M_SPOOL_ERRORS.name == jspool.M_SPOOL_ERRORS.name
    assert tspool.M_SPOOL_ERRORS.labelnames == jspool.M_SPOOL_ERRORS.labelnames == ("plane",)
