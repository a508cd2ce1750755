"""Per-step training telemetry tape: where did the step time go
(mirrors ``distkeras_tpu/obs/tape.py``).

The reference's entire training telemetry was two wall-clock stamps
(``Trainer.record_training_start/stop``). The tape keeps that number
but decomposes it the way an MLPerf-style report does:

* **phase breakdown** — ``data_wait`` (host blocked on the input
  pipeline), ``device`` (dispatch + epoch scan + result fetch),
  ``validation``, ``checkpoint``, and the derived ``host`` remainder;
* **rates** — examples (imgs/tokens) per second per epoch;
* **MFU** — ``rate x flops_per_example / peak_flops`` when both terms
  are known (``flops_per_example`` given by the caller, ``peak_flops``
  from ``detect_peak_flops``: the card's published bf16 peak);
* **goodput** — productive device seconds (device phase minus kernel
  build seconds that landed inside it) over TOTAL wall seconds since
  ``train_begin``, checkpoint/restore/compile included. A run that
  spends half its wall clock compiling or checkpointing has goodput
  ~0.5 no matter how fast its steps are.

Every ``epoch_end`` returns a flat ``logs`` dict the trainers merge
into the callback logs, so ``CSVLogger``/``TensorBoardLogger`` pick the
breakdown up with zero new wiring. ``NULL_TAPE`` is the disabled-path
object: every method a no-op, so instrumented loops stay branch-free.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

from distkeras_tpu_torch.obs import collectors
from distkeras_tpu_torch.utils.profiling import now

#: dense bf16 tensor-core peak per card, by ``torch.cuda.get_device_name``
#: substring (NVIDIA's published H100 figures, without sparsity: SXM
#: 989 TFLOP/s, PCIe 756 TFLOP/s). The JAX package's table holds TPU
#: peaks; none of them applies here.
BF16_PEAK_FLOPS = (
    ("h100 pcie", 756e12),
    ("h100", 989e12),
)


def detect_peak_flops():
    """``(peak_flops_or_None, device_kind)`` of CUDA device 0;
    ``(None, "cpu")`` without a card, so MFU is absent there (as it is
    for an unknown device)."""
    import torch
    if not torch.cuda.is_available():
        return None, "cpu"
    kind = torch.cuda.get_device_name(0)
    low = kind.lower()
    for sub, peak in BF16_PEAK_FLOPS:
        if sub in low:
            return peak, kind
    return None, kind


class _NullTape:
    """Disabled telemetry: every hook a no-op (single shared instance)."""

    enabled = False

    def phase(self, name):
        return contextlib.nullcontext()

    def train_begin(self):
        pass

    def train_end(self):
        pass

    def epoch_end(self, examples, steps=None):
        return {}

    def watch(self, name, fn):
        pass

    def mark_warm(self, name=None):
        pass

    def check_recompiles(self):
        return {}

    def set_flops_per_example(self, flops):
        pass

    def snapshot(self):
        return {}


NULL_TAPE = _NullTape()


class TrainingTape:
    """One tape per ``train()`` run. ``unit`` names the example axis in
    the logs keys (``examples``/``imgs``/``tokens`` ->
    ``examples_per_sec``/...). All state also lands on the registry
    (histograms ``<name>.phase_s{phase=}``, gauges ``<name>.goodput``
    etc.) so the unified snapshot carries it."""

    enabled = True

    def __init__(self, name: str = "train", unit: str = "examples",
                 registry=None, flops_per_example: Optional[float] = None,
                 peak_flops="auto"):
        from distkeras_tpu_torch.obs import get_registry
        self.name = name
        self.unit = unit
        self.registry = registry if registry is not None else get_registry()
        self.flops_per_example = flops_per_example
        if peak_flops == "auto":
            peak_flops, _ = detect_peak_flops()
        self.peak_flops = peak_flops
        self.detector = collectors.RecompileDetector(self.registry)
        self._lock = threading.Lock()
        self._phase_totals: Dict[str, float] = {}
        self._epoch_phase: Dict[str, float] = {}
        #: compile seconds observed DURING the device phase (per-phase
        #: deltas of the process-global totals) — the deduction that
        #: makes goodput's "productive device time" honest without
        #: charging validator/serving compiles against the device phase
        self._device_compile = 0.0
        self._t0 = None
        self._t_epoch = None
        self._t_end = None
        self._compile0 = None
        self._compile_end = None
        self._device_total = 0.0
        self._examples_total = 0
        self._epochs = 0
        # the prefix is a trainer CLASS name — a bounded, code-defined
        # set, not runtime data (lint_metric_names.py)
        self._hist = self.registry.histogram(  # lint: allow-dynamic-metric-name
            f"{name}.phase_s")

    # -- phases -----------------------------------------------------------
    @contextlib.contextmanager
    def phase(self, phase: str):
        device = phase == "device"
        if device:
            c0 = collectors.compile_totals()["seconds"]
        t0 = now()
        try:
            yield
        finally:
            dt = now() - t0
            with self._lock:
                self._phase_totals[phase] = \
                    self._phase_totals.get(phase, 0.0) + dt
                self._epoch_phase[phase] = \
                    self._epoch_phase.get(phase, 0.0) + dt
                if device:
                    self._device_total += dt
                    # global-totals delta over the phase window: a
                    # concurrent thread's compile can still land here,
                    # but a validator/serving compile OUTSIDE the phase
                    # no longer deflates productive device time
                    self._device_compile += (
                        collectors.compile_totals()["seconds"] - c0)
            self._hist.observe(dt, phase=phase)

    # -- recompile plumbing (delegates to the detector) -------------------
    def watch(self, name, fn):
        try:
            self.detector.watch(name, fn)
        except TypeError:
            pass                    # not a jitted callable: nothing to do

    def mark_warm(self, name=None):
        self.detector.mark_warm(name)

    def check_recompiles(self):
        return self.detector.check()

    def set_flops_per_example(self, flops: Optional[float]):
        if flops:
            self.flops_per_example = float(flops)

    # -- lifecycle --------------------------------------------------------
    def train_begin(self):
        self._t0 = self._t_epoch = now()
        self._t_end = self._compile_end = None
        self._compile0 = collectors.compile_totals()["seconds"]

    def train_end(self):
        """Freeze the goodput window: ``snapshot()`` after this stops
        charging wall time (and other subsystems' compiles) that
        accrued AFTER training finished to this run's goodput."""
        self._t_end = now()
        self._compile_end = collectors.compile_totals()["seconds"]

    def epoch_end(self, examples: int, steps: Optional[int] = None) -> Dict:
        """Close out one epoch; returns the logs dict (floats only —
        unknown values are OMITTED, not None, so CSV/TensorBoard
        loggers never see non-numeric cells)."""
        if self._t0 is None:
            self.train_begin()
        t = now()
        epoch_wall = max(t - self._t_epoch, 1e-12)
        self._t_epoch = t
        with self._lock:
            phases = dict(self._epoch_phase)
            self._epoch_phase = {}
            self._examples_total += int(examples)
            self._epochs += 1
            device_total = self._device_total
            device_compile = self._device_compile
        accounted = sum(phases.values())
        host = max(epoch_wall - accounted, 0.0)

        wall = max(t - self._t0, 1e-12)
        compile_s = collectors.compile_totals()["seconds"] - self._compile0
        # productive device time excludes only the compile seconds that
        # landed INSIDE the device phase (first-epoch step compiles) —
        # validator/serving compiles elsewhere in the process charge
        # the wall denominator, not the device numerator
        productive = max(device_total - device_compile, 0.0)
        goodput = min(productive / wall, 1.0)

        rate = examples / epoch_wall
        # checkpoint/validation emit 0.0 on epochs where the phase
        # didn't run: CSVLogger freezes its header on the FIRST epoch's
        # keys, so a key appearing only on checkpoint epochs would be
        # silently dropped from the whole CSV
        logs = {f"{self.unit}_per_sec": rate,
                "data_wait_s": phases.get("data_wait", 0.0),
                "device_s": phases.get("device", 0.0),
                "host_s": host,
                "checkpoint_s": phases.get("checkpoint", 0.0),
                "validation_s": phases.get("validation", 0.0),
                "goodput": goodput}
        if self.flops_per_example and self.peak_flops:
            logs["mfu"] = rate * self.flops_per_example / self.peak_flops
            # bounded prefix: the tape/trainer class name (see _hist)
            self.registry.gauge(  # lint: allow-dynamic-metric-name
                f"{self.name}.mfu").set(logs["mfu"])
        g = self.registry.gauge
        g(f"{self.name}.{self.unit}_per_sec").set(rate)
        g(f"{self.name}.goodput").set(goodput)
        g(f"{self.name}.compile_s").set(compile_s)
        self.check_recompiles()
        collectors.memory_watermark(self.registry)
        return logs

    # -- views ------------------------------------------------------------
    def snapshot(self) -> Dict:
        with self._lock:
            phases = dict(self._phase_totals)
            device_compile = self._device_compile
        t_end = self._t_end if self._t_end is not None else now()
        wall = (t_end - self._t0) if self._t0 is not None else 0.0
        compile_now = (self._compile_end if self._compile_end is not None
                       else collectors.compile_totals()["seconds"])
        compile_s = (compile_now - self._compile0
                     if self._compile0 is not None else 0.0)
        productive = max(phases.get("device", 0.0) - device_compile, 0.0)
        out = {"unit": self.unit, "epochs": self._epochs,
               "examples": self._examples_total,
               "wall_s": wall, "phases_s": phases,
               "compile_s": compile_s,
               "goodput": (min(productive / wall, 1.0) if wall > 0
                           else None),
               "recompiles": self.detector.counts()}
        if (self.flops_per_example and self.peak_flops and wall > 0
                and self._examples_total):
            out["mfu"] = (self._examples_total / wall
                          * self.flops_per_example / self.peak_flops)
        return out


def resolve_tape(telemetry, name: str, unit: str = "examples"):
    """THE trainer `telemetry=` kwarg policy, in one place:
    ``False`` (or obs disabled) -> ``NULL_TAPE``; ``None`` -> a fresh
    auto tape; anything else is a user-configured tape used as-is."""
    from distkeras_tpu_torch import obs
    if telemetry is False or not obs.enabled():
        return NULL_TAPE
    if telemetry is None:
        return TrainingTape(name=name, unit=unit)
    return telemetry


def timed_stream(iterable, tape):
    """Iterate while charging time blocked on ``next()`` to the tape's
    ``data_wait`` phase — the input-pipeline stall signal, wrapped
    around any trainer stream (Prefetcher or plain generator)."""
    it = iter(iterable)
    while True:
        with tape.phase("data_wait"):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item
