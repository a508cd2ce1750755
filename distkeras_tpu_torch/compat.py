"""Device resolution and the kernel-build settings of the port.

Every entry point of the package (``Model.build``, ``ServingEngine``,
the kernel wrappers) runs on the CUDA card unless the caller asks for
the CPU with ``device="cpu"``. ``resolve_device`` is the one place that
decides: it raises when CUDA is asked for (the default) and absent —
nothing carries on quietly on the CPU.

The build settings only say WHERE and HOW the hand-written kernels are
compiled (``kernels.load``); none of them selects a fallback:

* ``DKT_NVCC`` — the ``nvcc`` binary (default: ``$CUDA_HOME/bin/nvcc``,
  else ``/usr/local/cuda/bin/nvcc``, else ``nvcc`` on the PATH);
* ``DKT_KERNEL_BUILD_DIR`` — where the shared libraries go (default
  ``distkeras_tpu_torch/_build``, listed in ``.gitignore``);
* ``DKT_NVCC_FLAGS`` — extra flags appended to every compile (e.g.
  ``-Xptxas -v`` to print register and shared-memory use).
"""

from __future__ import annotations

import os
import shutil

import torch

#: the package root (csrc/ and the default build directory live here)
PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None``/"cuda" mean the CUDA
    card (raises when there is none), anything else is taken as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    return dev


def nvcc_path() -> str:
    explicit = os.environ.get("DKT_NVCC")
    if explicit:
        return explicit
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: set DKT_NVCC or CUDA_HOME to the CUDA toolkit")
    return found


def build_dir() -> str:
    return os.environ.get("DKT_KERNEL_BUILD_DIR") or os.path.join(
        PACKAGE_DIR, "_build")


def extra_nvcc_flags() -> list:
    return os.environ.get("DKT_NVCC_FLAGS", "").split()
