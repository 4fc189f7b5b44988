"""The port's native assembler, build scaffolding and C++ copies.

- The port's C++ sources (misaka_tpu_torch/csrc/native/*.cpp, *.hpp) are
  byte-equal to the reference's (native/) and are what the port builds,
  into build/misaka_tpu_torch/native-<hash>/ (never beside the source,
  never the reference's native/*.so); the native edge's library hashes its
  three units as the reference's loader does, so a header change rebuilds
  it.
- tis/native.py's `assemble_native` equals the port's Python lowerer and
  JAX's `assemble_native` on a corpus, on the error taxonomy (messages
  included) and on fuzzed programs; runtime/topology.py lowers through it.
- utils/nativelib.py's content tag: a fresh build embeds it, a binary with
  a stale or missing tag is rebuilt.
- utils/intmath.py against misaka_tpu/utils/intmath.py.
"""

import ctypes
import filecmp
import os
import shutil

import numpy as np
import pytest

from misaka_tpu.tis import native as jnative
from misaka_tpu.utils import intmath as jintmath
from misaka_tpu_torch.tis import native as tnative
from misaka_tpu_torch.tis.lower import TISLowerError, lower_program
from misaka_tpu_torch.tis.parser import TISParseError
from misaka_tpu_torch.utils import intmath as tintmath
from misaka_tpu_torch.utils import nativelib
from tests.test_differential import random_program
from tests.torch_native_helpers import every_handle_closed, small_pools  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = ("interpreter.cpp", "stencils.cpp", "assembler.cpp", "textcodec.cpp", "frontend.cpp",
          "msk_http.hpp", "msk_frame.hpp")

LANES = {"misaka1": 0, "misaka2": 1}
STACKS = {"misaka3": 0}

CORPUS = [
    "IN ACC\nADD 1\nMOV ACC, misaka2:R0\nMOV R0, ACC\nOUT ACC\n",
    "MOV R0, ACC\nADD 1\nPUSH ACC, misaka3\nPOP misaka3, ACC\nMOV ACC, misaka1:R0\n",
    "start: NOP\nJMP start\nJEZ START\nJNZ start\nJGZ start\nJLZ start",
    "# comment\n\nlbl:\nlbl2: SWP\nSAV\nNEG",
    "MOV -3, NIL\nMOV 7, misaka2:R3\nSUB R2\nJRO -1\nJRO ACC",
    "PUSH 3, misaka3\nPUSH R1, misaka3\nPOP misaka3, NIL\nIN NIL\nOUT 12\nOUT R3",
    "ADD 2147483650",  # int32 wrap
]


@pytest.mark.parametrize("name", COPIES)
def test_cpp_copies_byte_equal(name):
    """The port keeps its own copy of each C++ source, equal to the
    reference's byte for byte."""
    assert filecmp.cmp(os.path.join(REPO, "native", name),
                       os.path.join(REPO, "misaka_tpu_torch", "csrc", "native", name),
                       shallow=False)


@pytest.mark.parametrize("module", ["assembler", "interpreter"])
def test_libraries_build_from_the_port_copy_into_build_dir(module):
    from misaka_tpu_torch.core import cinterp

    lib = {"assembler": tnative.NATIVE, "interpreter": cinterp.NATIVE}[module]
    assert lib.available()
    assert lib.src == os.path.join(REPO, "misaka_tpu_torch", "csrc", "native", f"{module}.cpp")
    so = lib.so_path()
    assert so.startswith(os.path.join(REPO, "build", "misaka_tpu_torch", "native-"))
    assert os.path.basename(os.path.dirname(so)) == f"native-{nativelib.src_hash(lib.src)}"
    assert lib._so_matches_src(so)


@pytest.mark.parametrize("module", ["textcodec", "frontend"])
def test_edge_libraries_hash_like_the_reference(module):
    from misaka_tpu.runtime import frontends as jfe
    from misaka_tpu.utils import textcodec as jcodec
    from misaka_tpu_torch.runtime import frontends as tfe
    from misaka_tpu_torch.utils import textcodec as tcodec

    lib, ref = {"textcodec": (tcodec._NATIVE, jcodec._NATIVE),
                "frontend": (tfe._FRONTEND_LIB, jfe._FRONTEND_LIB)}[module]
    assert lib.available()
    assert lib.src_hash() == ref._src_hash()
    so = lib.so_path()
    assert so.startswith(os.path.join(REPO, "build", "misaka_tpu_torch", "native-"))
    assert os.path.basename(os.path.dirname(so)) == f"native-{lib.src_hash()}"
    assert lib._so_matches_src(so)


def test_a_header_change_rebuilds_a_multi_part_library(tmp_path):
    if not toolchain():
        pytest.skip("no C++ compiler")
    (tmp_path / "part.hpp").write_text("static int answer() { return 41; }\n")
    (tmp_path / "probe.cpp").write_text(
        '#include "part.hpp"\n'
        'extern "C" int probe_answer() { return answer(); }\n'
        '#ifndef MISAKA_SRC_HASH\n#define MISAKA_SRC_HASH "unbuilt"\n#endif\n'
        'extern "C" const char probe_tag[] = "MISAKA-SRC-HASH:" MISAKA_SRC_HASH;\n')

    def load():
        nl = nativelib.NativeLib("probe", lambda lib: None, src=str(tmp_path / "probe.cpp"),
                                 build_root=str(tmp_path / "b"), parts=("part.hpp", "probe.cpp"))
        lib = nl.load()
        return nl, lib.probe_answer()

    first, got = load()
    assert got == 41
    first_so = first.so_path()
    (tmp_path / "part.hpp").write_text("static int answer() { return 42; }\n")
    second, got = load()
    assert got == 42 and second.so_path() != first_so
    assert second.src_hash() == nativelib.src_hash(tmp_path / "part.hpp", tmp_path / "probe.cpp")


@pytest.mark.parametrize("idx", range(len(CORPUS)))
def test_corpus_parity(idx):
    program = CORPUS[idx]
    want = lower_program(program, LANES, STACKS)
    got = tnative.assemble_native(program, LANES, STACKS)
    ref = jnative.assemble_native(program, LANES, STACKS)
    assert got.length == want.length == ref.length
    np.testing.assert_array_equal(got.code, want.code)
    np.testing.assert_array_equal(got.code, np.asarray(ref.code))


@pytest.mark.parametrize(
    "program,exc",
    [
        ("FROB 1", TISParseError),
        ("MOV 1,ACC", TISParseError),
        ("JMP nowhere", TISParseError),
        ("a:\nA:", TISParseError),
        ("MOV ACC, ghost:R0", TISLowerError),
        ("PUSH 1, ghost", TISLowerError),
    ],
)
def test_error_parity(program, exc):
    with pytest.raises(exc) as native_err:
        tnative.assemble_native(program, LANES, STACKS)
    with pytest.raises(exc) as py_err:
        lower_program(program, LANES, STACKS)
    with pytest.raises(ValueError) as jax_err:
        jnative.assemble_native(program, LANES, STACKS)
    assert str(native_err.value) == str(py_err.value) == str(jax_err.value)


@pytest.mark.parametrize("seed", range(25))
def test_fuzz_parity(seed):
    rng = np.random.default_rng(1000 + seed)
    program = random_program(rng, list(LANES), list(STACKS), int(rng.integers(1, 12)))
    want = lower_program(program, LANES, STACKS)
    got = tnative.assemble_native(program, LANES, STACKS)
    ref = jnative.assemble_native(program, LANES, STACKS)
    np.testing.assert_array_equal(got.code, want.code, err_msg=program)
    np.testing.assert_array_equal(got.code, np.asarray(ref.code), err_msg=program)


def test_topology_lowers_through_assemble(monkeypatch):
    """runtime/topology.py compiles through `assemble`: a program of
    NATIVE_MIN_LINES lines or more through the native backend, shorter ones
    through the Python frontend, and the tables equal the Python
    frontend's."""
    from misaka_tpu_torch import networks

    calls = []
    real = tnative.assemble_native

    def spy(*a, **k):
        calls.append(a[0])
        return real(*a, **k)

    monkeypatch.setattr(tnative, "assemble_native", spy)
    top = networks.mesh8(in_cap=8, out_cap=8, stack_cap=8)
    lanes, stacks = top.lane_ids(), top.stack_ids()
    names = list(lanes)
    long_prog = "\n".join(["IN ACC", "ADD 1", "OUT ACC"] + ["NOP"] * tnative.NATIVE_MIN_LINES)
    top.programs[names[0]] = long_prog
    net = top.compile(device="cpu")
    assert calls == [long_prog]
    assert all(top.programs[n].count("\n") + 1 < tnative.NATIVE_MIN_LINES for n in names[1:])
    for name, i in lanes.items():
        low = lower_program(top.programs[name], lanes, stacks)
        np.testing.assert_array_equal(net.code[i, :low.length], low.code)


# --- the content tag: stale and tagless builds are rebuilt -----------------

SRC = """
extern "C" {
#ifndef MISAKA_SRC_HASH
#define MISAKA_SRC_HASH "unbuilt"
#endif
__attribute__((used)) const char misaka_src_hash_tag[] =
    "MISAKA-SRC-HASH:" MISAKA_SRC_HASH;
int misaka_probe() { return %d; }
}
"""


def probe_lib(tmp, version):
    src = os.path.join(tmp, "probe.cpp")
    with open(src, "w") as f:
        f.write(SRC % version)

    def configure(lib):
        lib.misaka_probe.restype = ctypes.c_int

    return nativelib.NativeLib("probe", configure, src=src, build_root=os.path.join(tmp, "b"))


def toolchain():
    return shutil.which(nativelib.cxx()) is not None


@pytest.mark.skipif(not toolchain(), reason="no C++ toolchain")
def test_fresh_build_embeds_hash_in_build_dir(tmp_path):
    nl = probe_lib(str(tmp_path), 1)
    lib = nl.load()
    assert lib is not None and lib.misaka_probe() == 1
    so = nl.so_path()
    assert os.path.dirname(so) == os.path.join(
        str(tmp_path), "b", f"native-{nativelib.src_hash(nl.src)}")
    with open(so, "rb") as f:
        assert b"MISAKA-SRC-HASH:" + nativelib.src_hash(nl.src).encode() in f.read()
    assert not [p for p in os.listdir(os.path.dirname(so)) if ".tmp." in p]


@pytest.mark.skipif(not toolchain(), reason="no C++ toolchain")
def test_stale_so_is_rebuilt(tmp_path):
    """A v1 binary at the v2 source's path (newer mtime) is never trusted."""
    d1, d2 = tmp_path / "v1", tmp_path / "v2"
    d1.mkdir(), d2.mkdir()
    nl1 = probe_lib(str(d1), 1)
    assert nl1.load().misaka_probe() == 1
    nl2 = probe_lib(str(d2), 2)
    os.makedirs(os.path.dirname(nl2.so_path()))
    shutil.copy(nl1.so_path(), nl2.so_path())
    future = os.path.getmtime(nl2.src) + 3600
    os.utime(nl2.so_path(), (future, future))
    assert not nl2._so_matches_src(nl2.so_path())
    assert nl2.load().misaka_probe() == 2


@pytest.mark.skipif(not toolchain(), reason="no C++ toolchain")
def test_tagless_so_is_rebuilt(tmp_path):
    d1, d2 = tmp_path / "v1", tmp_path / "doctored"
    d1.mkdir(), d2.mkdir()
    nl1 = probe_lib(str(d1), 3)
    assert nl1.load() is not None
    with open(nl1.so_path(), "rb") as f:
        data = f.read()
    nl2 = probe_lib(str(d2), 3)
    os.makedirs(os.path.dirname(nl2.so_path()))
    with open(nl2.so_path(), "wb") as f:
        f.write(data.replace(b"MISAKA-SRC-HASH:", b"XXXXXX-XXX-XXXX:"))
    assert not nl2._so_matches_src(nl2.so_path())
    assert nl2.load().misaka_probe() == 3
    assert nl2._so_matches_src(nl2.so_path())


def test_missing_toolchain_latches_unavailable(tmp_path, monkeypatch):
    monkeypatch.setattr(nativelib, "cxx", lambda: str(tmp_path / "no-such-compiler"))
    nl = probe_lib(str(tmp_path), 4)
    assert nl.load() is None
    assert not nl.available()  # latched: no second compiler run
    assert nl._failed


def test_so_env_override_raises_loudly(tmp_path, monkeypatch):
    from misaka_tpu_torch.core import cinterp

    monkeypatch.setenv("MISAKA_PROBE_SO", str(tmp_path / "missing.so"))
    nl = nativelib.NativeLib("interpreter", cinterp._configure, so_env="MISAKA_PROBE_SO")
    with pytest.raises(OSError):
        nl.load()


@pytest.mark.parametrize("ctrs", [(-1, 0, 0, 0), (5, 4, 0, 0), (0, 100, 0, 0),
                                  (0, 0, 3, 2), (0, 0, 0, 99)])
def test_seed_counters_rejects_hostile(ctrs):
    from misaka_tpu_torch import networks
    from misaka_tpu_torch.core.cinterp import NativeInterpreter

    net = networks.add2(in_cap=8, out_cap=8, stack_cap=8).compile(device="cpu")
    with NativeInterpreter(net.code, net.prog_len, net.num_stacks, net.stack_cap,
                           net.in_cap, net.out_cap) as it:
        before = it.export_arrays()
        with pytest.raises(ValueError):
            it.seed_counters(*ctrs)
        after = it.export_arrays()
        for k in before:
            np.testing.assert_array_equal(before[k], after[k], err_msg=k)


def test_buildinfo_interp_row_matches_jax():
    """The build row of the interpreter: the source hash its build embeds,
    the same as the JAX package's (the sources are byte-equal)."""
    from misaka_tpu.utils import buildinfo as jbuildinfo
    from misaka_tpu_torch.core import cinterp
    from misaka_tpu_torch.utils import buildinfo, metrics

    assert cinterp.available()
    got = buildinfo.info()["native"]["interp"]
    assert got == nativelib.src_hash(cinterp.NATIVE.src)
    want = jbuildinfo._native_labels().get("interp", "absent")
    assert want in (got, "absent")  # absent: the JAX build is not on disk
    buildinfo.install_metric()
    assert f'native_interp="{got}"' in metrics.render()
