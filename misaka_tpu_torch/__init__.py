"""misaka_tpu_torch: the PyTorch/CUDA port of misaka_tpu for an NVIDIA H100.

Same TIS networks, same `NetworkState`, same HTTP surface; the chunk step
runs as a hand-written CUDA kernel (csrc/fused_superstep.cu) on the card and
as the plain torch superstep (core/step.py) on the CPU.  This package imports
torch and numpy only: nothing of JAX and nothing of misaka_tpu.
"""

__version__ = "0.1.0"

# The parent pid at the earliest importable moment, before torch spends
# seconds importing: runtime/lifecycle.py compares getppid() against it to
# notice a launching shell that died during the boot.
import os as _os

PPID_AT_IMPORT = _os.getppid()
