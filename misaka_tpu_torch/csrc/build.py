"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each `.cu` file under this directory is compiled on first use into
`build/misaka_tpu_torch/<name>-<hash>/lib<name>.so` at the repository root,
keyed by a hash of the source and the flags, so a changed source rebuilds
and an unchanged one loads at once.  The sources have a plain `extern "C"`
interface (no PyTorch headers), so a build takes seconds.  ptxas's register,
spill and shared-memory report is saved beside the library as `ptxas.txt`.

No nvcc means no kernel: `build` raises.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent
BUILD_ROOT = CSRC.parent.parent / "build" / "misaka_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_loaded_keys: dict[str, str] = {}


def nvcc_path() -> str:
    """The nvcc binary: on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "misaka_tpu_torch cannot be built"
    )


def build(name: str) -> Path:
    """Compile csrc/<name>.cu into its content-keyed build directory (once);
    returns the shared library's path."""
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"{name}-{key}"
    lib = out_dir / f"lib{name}.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    (out_dir / "ptxas.txt").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


def ptxas_report(name: str) -> str:
    """The saved `-Xptxas -v` output of the current build of `name`."""
    return (build(name).parent / "ptxas.txt").read_text()


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu's library, once per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build(name)
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
            _loaded_keys[name] = path.parent.name.rsplit("-", 1)[1]  # the content key
        return lib


def loaded_keys() -> dict[str, str]:
    """{kernel name: build key} of every library this process has loaded
    ({} before the first build)."""
    with _lock:
        return dict(_loaded_keys)
