"""Build-and-load scaffolding for the native C++ host tier.

The port's copy of misaka_tpu/utils/nativelib.py.  The three native
components (tis/native.py the assembler, core/cinterp.py the interpreter,
core/jit.py's stencil object) are compiled with the host C++ compiler from
the port's own copies of the sources (misaka_tpu_torch/csrc/native/*.cpp)
on first use, never beside the source: each library goes to
`build/misaka_tpu_torch/native-<hash>/lib<name>.so` at the repository
root, keyed by the source's content hash.  Builds are atomic (a temporary
name, then `os.replace`), so concurrent processes race benignly.

Staleness is decided by CONTENT: each .cpp embeds a
"MISAKA-SRC-HASH:<sha256[:16]>" tag injected at build time, and the loader
scans the .so bytes for the tag of the current source; a binary with a
wrong or missing tag is rebuilt.  A library built from several units (the
native edge: frontend.cpp includes msk_http.hpp and msk_frame.hpp) names
them as `parts`, and its hash is the sha256 of their concatenation in that
order (the reference Makefile's `cat ... | sha256sum`), so a change to a
header rebuilds it; the units' directory is passed as an include path.
A process-wide failure latch makes an unavailable toolchain answer
"unavailable" at once on every later call instead of retrying the
compiler.

`so_env` names an environment variable that, when set, OVERRIDES the .so
path and disables the rebuild (an instrumented build whose bytes never
match the default flags' hash); a load failure through it raises instead
of latching quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

_TAG = b"MISAKA-SRC-HASH:"

NATIVE_SRC = Path(__file__).resolve().parent.parent / "csrc" / "native"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "misaka_tpu_torch"

# -pthread: the interpreter's serving pool runs std::thread workers;
# -fopenmp-simd honours the SIMD loop pragmas (no OpenMP runtime)
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread", "-fopenmp-simd")


def cxx() -> str:
    """The host C++ compiler of every native build: the `g++` on PATH, else
    $CXX.  $CXX comes last: a toolchain's CXX may be a wrapper that links
    the C++ runtime statically (the card's machine's is), and a second C++
    runtime inside a torch process crashes the assembler at its first
    call."""
    return shutil.which("g++") or os.environ.get("CXX") or "g++"


BUILD_TIMEOUT_S = 120.0  # a compile that takes longer fails (and latches)


def compile_atomic(args: list[str], out: str) -> None:
    """Run the host compiler on `args` into `out`: a temporary name, then
    an atomic swap.  Truncating a .so that a process has dlopen'd rewrites
    its mapped pages; os.replace gives the new build a fresh inode, and
    concurrent builds of one output race benignly.  A failed compile
    raises RuntimeError with the tail of the compiler's stderr."""
    tmp = f"{out}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        try:
            subprocess.run([cxx(), *args, "-o", tmp], check=True, capture_output=True,
                           timeout=BUILD_TIMEOUT_S)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(
                f"{cxx()} exited {e.returncode}: "
                f"{(e.stderr or b'').decode(errors='replace')[-400:]}") from e
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def src_hash(*paths: str | os.PathLike) -> str:
    """sha256[:16] of the files' bytes, concatenated in the order given."""
    h = hashlib.sha256()
    for path in paths:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build_dir(*srcs: str | os.PathLike, root: str | os.PathLike = BUILD_ROOT) -> Path:
    """`<root>/native-<hash of srcs>/` (root: build/misaka_tpu_torch)."""
    return Path(root) / f"native-{src_hash(*srcs)}"


class NativeLib:
    """Lazy loader for one shared object built from one C++ source file:
    csrc/native/<name>.cpp into build/misaka_tpu_torch/native-<hash>/
    (`src` and `build_root` name others).  `parts`: the units the source
    includes and itself, in hash order, as file names beside the source."""

    def __init__(self, name: str, configure: Callable[[ctypes.CDLL], None],
                 so_env: str | None = None, *, src: str | os.PathLike | None = None,
                 build_root: str | os.PathLike | None = None,
                 parts: tuple[str, ...] | None = None):
        self.name = name
        self._src = str(src) if src is not None else str(NATIVE_SRC / f"{name}.cpp")
        src_dir = os.path.dirname(self._src)
        self._parts = (tuple(os.path.join(src_dir, p) for p in parts) if parts
                       else (self._src,))
        self._build_root = Path(build_root) if build_root is not None else BUILD_ROOT
        self._so_env = so_env
        self._configure = configure  # declares restype/argtypes; may raise
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self._failed = False
        self.build_seconds: float | None = None

    @property
    def src(self) -> str:
        return self._src

    def src_hash(self) -> str:
        """The content tag of this library's sources (every part)."""
        return src_hash(*self._parts)

    def so_path(self) -> str:
        return str(build_dir(*self._parts, root=self._build_root) / f"libmisaka_{self.name}.so")

    def _so_matches_src(self, so: str) -> bool:
        """True iff the on-disk .so embeds the current source's hash tag."""
        try:
            with open(so, "rb") as f:
                data = f.read()
        except OSError:
            return False
        i = data.find(_TAG)
        if i < 0:
            return False
        want = self.src_hash().encode()
        return data[i + len(_TAG): i + len(_TAG) + len(want)] == want

    def _build(self, so: str) -> None:
        import time

        t0 = time.perf_counter()
        os.makedirs(os.path.dirname(so), exist_ok=True)
        compile_atomic([*CXX_FLAGS, f"-I{os.path.dirname(self._src)}",
                        f'-DMISAKA_SRC_HASH="{self.src_hash()}"', self._src], so)
        self.build_seconds = time.perf_counter() - t0

    def load(self) -> ctypes.CDLL | None:
        with self._lock:
            if self._lib is not None or self._failed:
                return self._lib
            override = self._so_env and os.environ.get(self._so_env)
            if override:
                try:
                    lib = ctypes.CDLL(override)
                    self._configure(lib)
                    self._lib = lib
                except Exception:
                    # loud: an armed override that fails to load means the
                    # caller is not testing what it thinks
                    self._failed = True
                    raise
                return self._lib
            try:
                so = self.so_path()
                if not self._so_matches_src(so):
                    self._build(so)
                lib = ctypes.CDLL(so)
                self._configure(lib)
                self._lib = lib
            except Exception:
                self._failed = True
            return self._lib

    def available(self) -> bool:
        return self.load() is not None
