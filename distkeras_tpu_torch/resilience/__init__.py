"""``distkeras_tpu_torch.resilience`` — the fault-tolerance subsystem
(mirrors ``distkeras_tpu/resilience``).

The immune system over the fast paths (kernels, continuous batching)
and the eyes (obs telemetry): every failure mode the repo claims to
handle is injectable (``faults``), bounded-retryable (``retry``), and
supervised (``supervisor``); the serving layer degrades gracefully
(deadlines, load shedding, poisoned-request isolation — see
``serving/``). ``tests/test_torch_resilience.py`` holds the
invariants against the JAX package (crash-anywhere resume
bitwise-identity, clean preemption, bounded rollback).

Quick tour::

    from distkeras_tpu_torch import resilience
    from distkeras_tpu_torch.resilience import faults

    faults.inject("ckpt.write", nth=2)        # or DKT_FAULTS=...
    sup = resilience.TrainingSupervisor(trainer, max_restarts=3)
    result = sup.run(dataset)                 # survives the fault
    assert result.restarts <= 3
"""

from distkeras_tpu_torch.resilience import faults  # noqa: F401
from distkeras_tpu_torch.resilience.faults import InjectedFault  # noqa: F401
from distkeras_tpu_torch.resilience.retry import (  # noqa: F401
    RetryPolicy, classify_retryable, io_retry, no_retry)
from distkeras_tpu_torch.resilience.supervisor import (  # noqa: F401
    AnomalyDetected, AnomalyGuard, SupervisedRun, TrainingSupervisor)
