"""distkeras_tpu_torch: the PyTorch / CUDA port of ``distkeras_tpu`` for
one NVIDIA H100.

This first slice serves ``zoo.transformer_lm`` through a paged
continuous-batching ``serving.ServingEngine``. Its two attention kernels
are hand-written CUDA C++ for ``sm_90a`` (``csrc/``), built at first use
into ``_build/`` and bound with ``ctypes`` (``kernels``). Entry points
run on the CUDA card unless the caller passes ``device="cpu"``, which
selects each kernel's plain PyTorch version (the CPU tests' path).

The package imports ``torch`` and ``numpy`` only: nothing of JAX and
nothing of ``distkeras_tpu``.
"""

__version__ = "0.1.0"
