"""Build identity: the `misaka_build_info` gauge and the /status `build`
block (the port of misaka_tpu/utils/buildinfo.py).

A constant `misaka_build_info` gauge valued 1 whose labels carry the
identity, so `count by (git_sha) (misaka_build_info)` shows a mixed-version
fleet; the same dict rides /status as `build`.  The port stamps `torch`
where the reference stamps `jax`, and its `native` block holds the build
key (csrc/build.py: a hash of the .cu source and the nvcc flags) of every
CUDA kernel this process has loaded: `{}` before the first build, and
always `{}` on the CPU.  The host C++ libraries are the reference's rows
(`_native_labels`): once the interpreter (core/cinterp.py) or the decimal
codec (utils/textcodec.py) has loaded in this process, `native` carries
`interp` or `textcodec`, the source hash its build embeds; the gauge's
`native_interp` label carries the interpreter's, "absent" before.

git is asked once (`MISAKA_BUILD_SHA` wins; "unknown" without either).
"""

from __future__ import annotations

import os
import subprocess
import sys

from misaka_tpu_torch import __version__
from misaka_tpu_torch.csrc import build
from misaka_tpu_torch.utils import metrics

_base_cache: dict | None = None


def _git_sha() -> str:
    env = os.environ.get("MISAKA_BUILD_SHA")
    if env:
        return env
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        out = subprocess.run(
            ["git", "-C", repo, "rev-parse", "--short=12", "HEAD"],
            capture_output=True, text=True, timeout=5,
        )
        sha = out.stdout.strip()
        if out.returncode == 0 and sha:
            return sha
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown"


def info() -> dict:
    """The build-identity dict (/status `build` block).  Everything but
    `native` is computed once; `native` reads the kernels loaded so far."""
    global _base_cache
    if _base_cache is None:
        torch_mod = sys.modules.get("torch")
        _base_cache = {
            "version": __version__,
            "git_sha": _git_sha(),
            "python": ".".join(str(v) for v in sys.version_info[:3]),
            "torch": getattr(torch_mod, "__version__", "unloaded"),
        }
    return {**_base_cache, "native": {**build.loaded_keys(), **_native_labels()}}


def _native_labels() -> dict[str, str]:
    """The source hash (utils/nativelib.py embeds it at build time) of each
    host C++ library loaded in this process, by the reference's row name."""
    from misaka_tpu_torch.core import cinterp
    from misaka_tpu_torch.utils import textcodec

    return {name: lib.src_hash()
            for name, lib in (("interp", cinterp.NATIVE), ("textcodec", textcodec._NATIVE))
            if lib._lib is not None}


def install_metric() -> None:
    """Register misaka_build_info (value 1, identity in labels) into the
    default registry; make_http_server calls it, so every serving process
    stamps itself."""
    i = info()
    g = metrics.gauge(
        "misaka_build_info",
        "Build identity (constant 1; the identity lives in the labels)",
        ("version", "git_sha", "python", "torch", "native_interp"),
    )
    g.labels(
        version=i["version"], git_sha=i["git_sha"], python=i["python"],
        torch=i["torch"], native_interp=i["native"].get("interp", "absent"),
    ).set(1)
