"""distkeras_tpu_torch: the PyTorch / CUDA port of ``distkeras_tpu`` for
one NVIDIA H100.

It serves ``zoo.transformer_lm`` through a paged continuous-batching
``serving.ServingEngine`` (float, int8 or int4 KV pages), continues
prompts with ``Model.generate`` over a slab KV cache, and trains with
``parallel.SingleTrainer`` / ``Model.fit``. Its attention kernels are
hand-written CUDA C++ for ``sm_90a`` (``csrc/``), built at first use
into ``_build/`` and bound with ``ctypes`` (``kernels``). Entry points
run on the CUDA card unless the caller passes ``device="cpu"``, which
selects each kernel's plain PyTorch version (the CPU tests' path).
The JAX package's observability (``obs``: metrics registry, spans,
exporters, the training tape, the engine's request tracer, flight
recorder, SLOs and time series) and resilience (``resilience``: fault
points, retry policies, ``TrainingSupervisor``) layers are ported too.

The package imports ``torch`` and ``numpy`` only: nothing of JAX and
nothing of ``distkeras_tpu``.
"""

__version__ = "0.1.0"
