"""ctypes binding of the host data library (``csrc/host/dkt_data.cc``).

The port's copy of ``distkeras_tpu/data/native.py`` (``_build`` :39,
``_load`` :66, ``native_available`` :108, ``native_status`` :112,
``gather`` :126, ``one_hot`` :150, ``minmax_fit`` :167, ``minmax_scale``
:180, ``read_csv`` :198), over the port's own copy of the C++ source.
The library runs on the host, as JAX's does: a multithreaded
permutation gather (every trainer's epoch shuffle), one-hot, column
min/max and min-max scaling, and a CSV parser. Every entry point has a
numpy path, taken when

  * the library cannot be built (no ``g++``) or loaded,
  * ``DKT_DISABLE_NATIVE=1`` is set, or
  * the input is below ``_MIN_NATIVE_BYTES`` (threads do not pay).

The library is compiled on first use with ``g++ -O3 -std=c++17 -fPIC
-pthread -shared`` into the port's build directory (``compat.build_dir``,
beside the kernel libraries), under a file name that carries a hash of
the source and the flags, as ``kernels`` names its libraries: an edited
source rebuilds and an unchanged one is reused. It compiles to a
per-process temporary name and is renamed into place, so concurrent
builds never leave a truncated library. The seconds spent are the
port's compile time (``obs.collectors.note_compile``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from distkeras_tpu_torch import compat

_SRC = os.path.join(compat.PACKAGE_DIR, "csrc", "host", "dkt_data.cc")
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]

_lib = None
_lib_path: Optional[str] = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None

# below this many bytes the ctypes/threading overhead beats the win
_MIN_NATIVE_BYTES = 1 << 22  # 4 MiB


def library_path() -> str:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(compat.build_dir(),
                        f"libdkt_data-{h.hexdigest()[:16]}.so")


def _build(path: str) -> Optional[str]:
    """Compile the shared library to ``path``; an error string or None."""
    from distkeras_tpu_torch.utils.profiling import now
    t0 = now()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, "-o", tmp, _SRC]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        if os.path.exists(tmp):
            os.unlink(tmp)
        return f"g++ unavailable: {e}"
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        return f"build failed: {proc.stderr[-500:]}"
    try:
        os.replace(tmp, path)
    except OSError as e:
        os.unlink(tmp)
        return f"rename failed: {e}"
    from distkeras_tpu_torch.obs import collectors
    collectors.note_compile(now() - t0, 1)
    return None


def _load():
    """Load (building if needed) the library, or None on failure."""
    global _lib, _lib_path, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    if os.environ.get("DKT_DISABLE_NATIVE") == "1":
        _build_error = "disabled via DKT_DISABLE_NATIVE"
        return None
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        if not os.path.exists(_SRC):
            _build_error = f"source not found: {_SRC}"
            return None
        path = library_path()
        if not os.path.exists(path):
            err = _build(path)
            if err is not None:
                _build_error = err
                return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            _build_error = f"load failed: {e}"
            return None
        c = ctypes
        lib.dkt_gather.argtypes = [c.c_char_p, c.POINTER(c.c_int64),
                                   c.c_char_p, c.c_int64, c.c_int64, c.c_int]
        lib.dkt_one_hot.argtypes = [c.POINTER(c.c_int64), c.POINTER(c.c_float),
                                    c.c_int64, c.c_int64, c.c_int]
        lib.dkt_one_hot.restype = c.c_int64
        lib.dkt_col_minmax.argtypes = [
            c.POINTER(c.c_float), c.c_int64, c.c_int64,
            c.POINTER(c.c_float), c.POINTER(c.c_float), c.c_int]
        lib.dkt_minmax_scale.argtypes = [
            c.POINTER(c.c_float), c.c_int64, c.c_int64,
            c.POINTER(c.c_float), c.POINTER(c.c_float),
            c.c_float, c.c_float, c.POINTER(c.c_float), c.c_int]
        lib.dkt_csv_parse_f32.argtypes = [c.c_char_p, c.c_int64, c.c_char,
                                          c.POINTER(c.c_float), c.c_int64]
        lib.dkt_csv_parse_f32.restype = c.c_int64
        _lib, _lib_path = lib, path
        return _lib


def native_available() -> bool:
    return _load() is not None


def native_status() -> str:
    if _load() is not None:
        return f"native: {_lib_path}"
    return f"fallback: {_build_error}"


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def gather(src: np.ndarray, perm: np.ndarray, *, threads: int = 0
           ) -> np.ndarray:
    """``src[perm]`` for row-major arrays, multithreaded in native mode:
    the epoch shuffle of every trainer (``shard_epoch_data``)."""
    src = np.ascontiguousarray(src)
    lib = _load()
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
    n = len(perm)
    if lib is None or n * row_bytes < _MIN_NATIVE_BYTES:
        return src[perm]
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    if n and (perm.min() < 0 or perm.max() >= len(src)):
        raise IndexError("perm out of range")
    out = np.empty((n,) + src.shape[1:], src.dtype)
    lib.dkt_gather(src.ctypes.data_as(ctypes.c_char_p), _i64p(perm),
                   out.ctypes.data_as(ctypes.c_char_p),
                   n, row_bytes, threads)
    return out


def one_hot(labels: np.ndarray, num_classes: int, *, threads: int = 0
            ) -> np.ndarray:
    """Labels ``[n]`` -> one-hot ``[n, num_classes]`` float32. Out-of-range
    labels give all-zero rows (both paths)."""
    labels = np.ascontiguousarray(labels, dtype=np.int64).reshape(-1)
    n = len(labels)
    lib = _load()
    if lib is None or n * num_classes * 4 < _MIN_NATIVE_BYTES:
        out = np.zeros((n, num_classes), np.float32)
        ok = (labels >= 0) & (labels < num_classes)
        out[np.arange(n)[ok], labels[ok]] = 1.0
        return out
    out = np.zeros((n, num_classes), np.float32)
    lib.dkt_one_hot(_i64p(labels), _f32p(out), n, num_classes, threads)
    return out


def minmax_fit(x: np.ndarray, *, threads: int = 0):
    """Column-wise (min, max) of ``[n, d]`` float32."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    n, d = x.shape
    lib = _load()
    if lib is None or x.nbytes < _MIN_NATIVE_BYTES:
        return x.min(axis=0), x.max(axis=0)
    mins = np.empty((d,), np.float32)
    maxs = np.empty((d,), np.float32)
    lib.dkt_col_minmax(_f32p(x), n, d, _f32p(mins), _f32p(maxs), threads)
    return mins, maxs


def minmax_scale(x: np.ndarray, mins, maxs, lo: float = 0.0, hi: float = 1.0,
                 *, threads: int = 0) -> np.ndarray:
    """Affine rescale to [lo, hi] per column; degenerate columns -> lo."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    n, d = x.shape
    mins = np.ascontiguousarray(mins, dtype=np.float32)
    maxs = np.ascontiguousarray(maxs, dtype=np.float32)
    lib = _load()
    if lib is None or x.nbytes < _MIN_NATIVE_BYTES:
        rng = maxs - mins
        scale = np.where(rng > 0, (hi - lo) / np.where(rng > 0, rng, 1), 0.0)
        return (x * scale + (lo - mins * scale)).astype(np.float32)
    out = np.empty_like(x)
    lib.dkt_minmax_scale(_f32p(x), n, d, _f32p(mins), _f32p(maxs),
                         lo, hi, _f32p(out), threads)
    return out


def read_csv(path, *, sep: str = ",", skip_header: bool = False,
             dtype=np.float32) -> np.ndarray:
    """Numeric CSV -> ``[rows, cols]`` array (the native ``strtof``
    parser when available). The column count comes from the first data
    line; tabs count as separators whatever ``sep`` is, and a field
    that is only whitespace is no field."""
    with open(path, "rb") as f:
        buf = f.read()
    if skip_header:
        nl = buf.find(b"\n")
        buf = buf[nl + 1:] if nl >= 0 else b""
    first = buf.split(b"\n", 1)[0].strip()
    if not first:
        return np.empty((0, 0), dtype)
    cols = len([t for t in first.replace(b"\t", sep.encode())
                .split(sep.encode()) if t.strip()])
    lib = _load()
    if lib is None:
        rows = [
            [float(t) for t in line.replace(b"\t", sep.encode())
             .split(sep.encode()) if t.strip()]
            for line in buf.split(b"\n") if line.strip()]
        return np.asarray(rows, dtype)
    max_vals = buf.count(b"\n") * cols + cols + 1
    out = np.empty((max_vals,), np.float32)
    n = lib.dkt_csv_parse_f32(buf, len(buf), sep.encode()[0] if sep else b",",
                              _f32p(out), max_vals)
    if n < 0:
        raise ValueError(f"malformed numeric CSV: {path}")
    if cols == 0 or n % cols != 0:
        raise ValueError(
            f"ragged CSV: {n} values not divisible by {cols} columns")
    return out[:n].reshape(-1, cols).astype(dtype, copy=False)
