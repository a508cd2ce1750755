"""Learning-rate schedules: ``step -> lr`` functions of the optimizer's
0-d int32 step counter (a tensor on the parameters' device), returning a
0-d float32 tensor on the same device, so a scheduled update needs no
host sync.

Mirrors ``distkeras_tpu/ops/schedules.py``: the same families, formulas
and names. Accepted anywhere a ``learning_rate`` float is
(``get_optimizer("sgd", learning_rate=cosine_decay(0.1, 10_000))``).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Union

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]  # int32 step -> f32 lr


def constant(value: float) -> Schedule:
    v = float(value)
    return lambda step: torch.full((), v, dtype=torch.float32,
                                   device=step.device)


def exponential_decay(init_value: float, decay_steps: int,
                      decay_rate: float, staircase: bool = False) -> Schedule:
    v, k, r = float(init_value), int(decay_steps), float(decay_rate)

    def fn(step):
        p = step.float() / k
        if staircase:
            p = torch.floor(p)
        return v * torch.pow(torch.tensor(r, dtype=torch.float32,
                                          device=step.device), p)

    return fn


def cosine_decay(init_value: float, decay_steps: int,
                 alpha: float = 0.0, warmup_steps: int = 0) -> Schedule:
    """Linear warmup (0 -> init) over ``warmup_steps``, then cosine decay to
    ``alpha * init_value`` over the remaining ``decay_steps``."""
    v, k, a, w = float(init_value), int(decay_steps), float(alpha), \
        int(warmup_steps)

    def fn(step):
        s = step.float()
        warm = v * s / max(w, 1)
        t = torch.clamp((s - w) / max(k, 1), 0.0, 1.0)
        cos = v * (a + (1 - a) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(s < w, warm, cos).float()

    return fn


def piecewise_constant(boundaries: Sequence[int],
                       values: Sequence[float]) -> Schedule:
    """``values[i]`` for steps in ``[boundaries[i-1], boundaries[i])``;
    needs ``len(values) == len(boundaries) + 1``."""
    if len(values) != len(boundaries) + 1:
        raise ValueError(
            f"need len(values) == len(boundaries) + 1, got "
            f"{len(values)} values / {len(boundaries)} boundaries")
    bs = torch.tensor(list(boundaries), dtype=torch.int32)
    vs = torch.tensor(list(values), dtype=torch.float32)

    def fn(step):
        idx = (step >= bs.to(step.device)).sum()
        return vs.to(step.device)[idx]

    return fn


SCHEDULES = {
    "constant": constant,
    "exponential_decay": exponential_decay,
    "cosine_decay": cosine_decay,
    "piecewise_constant": piecewise_constant,
}


def get_schedule(sched: Union[str, Schedule, float], **kwargs) -> Schedule:
    if callable(sched):
        return sched
    if isinstance(sched, (int, float)):
        return constant(sched)
    try:
        factory = SCHEDULES[sched]
    except KeyError:
        raise ValueError(f"Unknown schedule {sched!r}; "
                         f"known: {sorted(SCHEDULES)}")
    return factory(**kwargs)
