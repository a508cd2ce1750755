"""Telemetry collectors of the port (mirrors
``distkeras_tpu/obs/collectors.py``, whose signals are XLA's).

Three signals the generic counters can't see:

* **Kernel builds** — the port has no XLA compile; its compile time is
  the time ``kernels`` spends building the hand-written CUDA libraries
  with ``nvcc`` and loading them (``kernels.build`` / ``kernels.library``
  call ``note_compile``). They feed the same process-global totals
  (count + seconds) that JAX feeds from ``jax.monitoring``, so the
  goodput accounting (``obs.tape``) subtracts a cold build as it
  subtracts an XLA compile.
* **Recompiles** — ``RecompileDetector.watch(name, fn)`` keeps JAX's
  contract: ``fn`` exposes ``_cache_size()``, and after ``mark_warm()``
  any growth means the hot path compiled again, which ``check()`` warns
  about once, naming the function. The port's executable cache is its
  set of loaded kernel libraries (``KERNEL_LIBRARIES``): a library
  built and loaded after warm-up is the port's recompile.
* **Device-memory watermarks** — ``memory_watermark()`` folds
  ``utils.profiling.device_memory_stats`` (``torch.cuda.memory_stats``)
  into per-device gauges whose ``max`` field is the high-water mark
  across calls.
"""

from __future__ import annotations

import threading
import warnings
import weakref
from typing import Dict, Optional

_lock = threading.Lock()
_totals = {"count": 0, "seconds": 0.0}


class RecompileWarning(UserWarning):
    """A watched compiled function recompiled after warm-up."""


def note_compile(seconds: float, count: int = 1) -> None:
    """Add ``count`` builds taking ``seconds`` to the process-global
    compile totals (``kernels`` calls this for every library it builds
    or loads)."""
    with _lock:
        _totals["count"] += int(count)
        _totals["seconds"] += float(seconds)


def compile_totals() -> Dict[str, float]:
    """Process-global ``{"count", "seconds"}`` of kernel builds and
    loads in this process."""
    with _lock:
        return dict(_totals)


class _KernelLibraries:
    """The port's executable cache, as ``RecompileDetector`` reads one:
    ``_cache_size()`` is the number of kernel libraries loaded."""

    @staticmethod
    def _cache_size() -> int:
        from distkeras_tpu_torch import kernels
        return len(kernels._libs)


#: watch this under a name to catch a kernel library loaded after warm-up
KERNEL_LIBRARIES = _KernelLibraries()


class RecompileDetector:
    """Tracks executable-cache growth of named compiled functions.

    Lifecycle: ``watch`` each hot function right after building it,
    ``mark_warm()`` once the warm-up call(s) ran, then ``check()``
    periodically (each epoch / every N serving iterations). ``check``
    warns ONCE per observed growth step, so a leak that recompiles
    every step does not also flood stderr every step.

    Holds watched objects via weakref where the callable supports it
    (falling back to a strong reference otherwise) so watching never
    extends an executable's lifetime.
    """

    def __init__(self, registry=None):
        from distkeras_tpu_torch.obs import get_registry
        self.registry = registry if registry is not None else get_registry()
        self._watched: Dict[str, Dict] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _cache_size(fn) -> Optional[int]:
        try:
            return int(fn._cache_size())
        except Exception:
            return None

    def watch(self, name: str, fn) -> None:
        """Track ``fn`` (an object with ``_cache_size()``, e.g.
        ``KERNEL_LIBRARIES``) under ``name``. Raises if it exposes no
        ``_cache_size`` (nothing to track)."""
        if not hasattr(fn, "_cache_size"):
            raise TypeError(
                f"{name}: object has no _cache_size(); pass an object "
                "that counts its compiled executables")
        try:
            ref = weakref.ref(fn)
        except TypeError:
            ref = lambda fn=fn: fn          # not weakref-able: strong
        with self._lock:
            self._watched[name] = {
                "ref": ref,
                "warm": None,                # cache size at mark_warm
                "warned_at": None,           # size already warned about
                "last": None,                # last observed size (kept
            }                                # after the fn is GC'd)

    def mark_warm(self, name: Optional[str] = None) -> None:
        """Freeze the current cache size(s) as the expected steady
        state; growth past it is a recompile."""
        with self._lock:
            entries = ([self._watched[name]] if name is not None
                       else list(self._watched.values()))
            for e in entries:
                fn = e["ref"]()
                if fn is not None:
                    e["warm"] = self._cache_size(fn)

    def counts(self) -> Dict[str, int]:
        """Compile count per watched function — live cache size, or the
        last observed size once the function has been GC'd (a finished
        trainer's epoch program stays visible in the final snapshot)."""
        out = {}
        with self._lock:
            items = list(self._watched.items())
        for name, e in items:
            fn = e["ref"]()
            size = self._cache_size(fn) if fn is not None else None
            if size is not None:
                e["last"] = size
            if size is not None or e["last"] is not None:
                out[name] = size if size is not None else e["last"]
        return out

    def check(self, warn: bool = True) -> Dict[str, int]:
        """Poll watched functions; returns ``{name:
        recompiles_after_warm}`` for those that grew past their warm
        size (empty when all quiet). Updates the registry counters
        either way."""
        grew: Dict[str, int] = {}
        with self._lock:
            items = list(self._watched.items())
        gauge = self.registry.gauge("jit.compile_count")
        for name, e in items:
            fn = e["ref"]()
            if fn is None:
                continue
            size = self._cache_size(fn)
            if size is None:
                continue
            e["last"] = size
            gauge.set(size, fn=name)
            warm = e["warm"]
            if warm is None or size <= warm:
                continue
            grew[name] = size - warm
            if warn and e["warned_at"] != size:
                e["warned_at"] = size
                warnings.warn(
                    f"compiled function {name!r} recompiled after "
                    f"warm-up ({size - warm} new executable(s), cache "
                    f"size {warm} -> {size}) — a hot step retracing "
                    "usually means unstable shapes/dtypes (shape leak)",
                    RecompileWarning, stacklevel=2)
        return grew


def memory_watermark(registry=None):
    """Record per-device ``bytes_in_use`` gauges (watermark = ``max``
    across calls). Returns the stats list, or None where the backend
    exposes none (virtual CPU devices)."""
    from distkeras_tpu_torch.obs import get_registry
    from distkeras_tpu_torch.utils.profiling import device_memory_stats
    registry = registry if registry is not None else get_registry()
    stats = device_memory_stats()
    if not stats:
        return None
    gauge = registry.gauge("device.bytes_in_use")
    for s in stats:
        if s.get("bytes_in_use") is not None:
            gauge.set(s["bytes_in_use"], device=s["device"])
    return stats
