"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
of its own with a plain C interface, loaded with ``ctypes``; a source may
hold several kernels, each with its own exported launcher and launch
count (``flash_bwd.cu`` holds dq and dk/dv, ``decode_attention.cu`` the
float and int8 slab decode, ``paged_decode.cu`` the float, int8 and
int4 paged decode, each with and without the tree ancestor mask,
``quant_matmul.cu`` the int8 and packed-int4 quantized matmul,
``sampling.cu`` the fused sampling epilogue, ``moe_gemm.cu`` the MoE
expert up-projection with the token gather fused in, ``moe_bwd.cu`` the
fused expert block's backward: dx/dz/gy/row dots and dw1, ``prng.cu``
the threefry draw of ``ops.prng``). The first
call of ``library`` (or an explicit ``build``) compiles every source
whose library is missing, one
``nvcc`` process per source, all started together. A library's file
name carries a hash of its source, the ``csrc/`` headers it includes
(``sm90.cuh``, the Hopper primitives; ``moe_tc.cuh``, the mainloop
``moe_gemm.cu`` and ``moe_bwd.cu`` share; ``dequant.cuh``, the integer
conversion of ``quant_matmul.cu``, ``paged_decode.cu`` and
``decode_attention.cu``) and
the flags, so an edited source or header rebuilds
and an unchanged one is reused. Where the libraries go and
which ``nvcc`` runs is set in ``compat``.

Every wrapper adds one to its kernel's launch count where it launches
the kernel, and nowhere else (``launch_counts`` / ``reset_launch_counts``),
so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import subprocess
import threading
from typing import Dict, Iterable, Optional

from distkeras_tpu_torch import compat

#: kernel name -> source file under csrc/
SOURCES = {"flash_fwd": "flash_fwd.cu", "paged_decode": "paged_decode.cu",
           "flash_bwd_dq": "flash_bwd.cu", "flash_bwd_dkv": "flash_bwd.cu",
           "decode_attention": "decode_attention.cu",
           "decode_attention_q8": "decode_attention.cu",
           "paged_decode_q8": "paged_decode.cu",
           "paged_decode_q4": "paged_decode.cu",
           "paged_decode_anc": "paged_decode.cu",
           "paged_decode_q8_anc": "paged_decode.cu",
           "paged_decode_q4_anc": "paged_decode.cu",
           "quant_matmul_q8": "quant_matmul.cu",
           "quant_matmul_q4": "quant_matmul.cu",
           "sample_epilogue": "sampling.cu",
           "moe_gather_gemm1": "moe_gemm.cu",
           "moe_bwd_dx": "moe_bwd.cu", "moe_bwd_dw1": "moe_bwd.cu",
           "prng": "prng.cu"}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
#: the flash kernels' packed-sequence ids: q-side and k-side int32
#: pointers (null without ids) and their batch stride
_SEGMENTS = [_P, _P, _L]
#: C signatures of the exported launchers (all return a cudaError_t)
_SIGNATURES = {
    "flash_fwd": ("dkt_flash_fwd",
                  [_P] * 5 + [_I] * 7 + [_L] * 12 + [_F, _I, _I]
                  + _SEGMENTS + [_P]),
    "paged_decode": ("dkt_paged_decode",
                     [_P] * 9 + [_I] * 11 + [_F, _I, _P]),
    "flash_bwd_dq": ("dkt_flash_bwd_dq",
                     [_P] * 7 + [_I] * 7 + [_L] * 15 + [_F, _I, _I]
                     + _SEGMENTS + [_P]),
    "flash_bwd_dkv": ("dkt_flash_bwd_dkv",
                      [_P] * 8 + [_I] * 7 + [_L] * 18 + [_F, _I, _I]
                      + _SEGMENTS + [_P]),
    "decode_attention": ("dkt_decode_attention",
                         [_P] * 7 + [_I] * 5 + [_L] * 4 + [_I] * 5
                         + [_F, _P]),
    "decode_attention_q8": ("dkt_decode_attention_q8",
                            [_P] * 9 + [_I] * 4 + [_L] * 6 + [_I] * 5
                            + [_F, _P]),
    "paged_decode_q8": ("dkt_paged_decode_q8",
                        [_P] * 11 + [_I] * 10 + [_F, _I, _P]),
    "paged_decode_q4": ("dkt_paged_decode_q4",
                        [_P] * 11 + [_I] * 10 + [_F, _I, _P]),
    "paged_decode_anc": ("dkt_paged_decode_anc",
                         [_P] * 10 + [_I] * 11 + [_F, _I, _P]),
    "paged_decode_q8_anc": ("dkt_paged_decode_q8_anc",
                            [_P] * 12 + [_I] * 10 + [_F, _I, _P]),
    "paged_decode_q4_anc": ("dkt_paged_decode_q4_anc",
                            [_P] * 12 + [_I] * 10 + [_F, _I, _P]),
    "quant_matmul_q8": ("dkt_quant_matmul_q8",
                        [_P, _I] + [_P] * 3 + [_I] * 7 + [_P]),
    "quant_matmul_q4": ("dkt_quant_matmul_q4",
                        [_P, _I] + [_P] * 3 + [_I] * 7 + [_P]),
    "sample_epilogue": ("dkt_sample_epilogue",
                        [_P, _I, _L] + [_P] * 5 + [_I, _I, _P]),
    "moe_gather_gemm1": ("dkt_moe_gather_gemm1",
                         [_P, _I] + [_P] * 5 + [_I] * 10 + [_P]),
    "moe_bwd_dx": ("dkt_moe_bwd_dx", [_P] * 14 + [_I] * 7 + [_P]),
    "moe_bwd_dw1": ("dkt_moe_bwd_dw1", [_P] * 4 + [_I] * 6 + [_P]),
    "prng": ("dkt_prng", [_P, _I, _L, _I, _F, _F, _P, _P]),
}

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}     # source file -> loaded library
_launches: Dict[str, int] = {name: 0 for name in SOURCES}
#: compiler output of the last build, per source (ptxas notes with
#: ``DKT_NVCC_FLAGS="-Xptxas -v"``)
build_log: Dict[str, str] = {}


def _csrc(source: str) -> str:
    return os.path.join(compat.PACKAGE_DIR, "csrc", source)


def _nvcc_command(source: str, out: str):
    return [compat.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-o", out, _csrc(source)] + compat.extra_nvcc_flags()


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _inputs(source: str) -> list:
    """The source and every ``csrc/`` header it includes with quotes,
    directly or through another header, in the order first met."""
    seen, todo = [], [source]
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.append(name)
        with open(_csrc(name), "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())]
    return seen


def _library_path(source: str) -> str:
    h = hashlib.sha256()
    for name in _inputs(source):
        h.update(name.encode())
        with open(_csrc(name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(compat.extra_nvcc_flags()).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(compat.build_dir(),
                        f"lib{stem}-{h.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the sources of the named kernels (default: all) whose
    libraries are missing, one ``nvcc`` per source, in parallel; returns
    ``{name: library path}``. Raises with the compiler's output when a
    compile fails."""
    names = list(SOURCES if names is None else names)
    os.makedirs(compat.build_dir(), exist_ok=True)
    sources = sorted({SOURCES[name] for name in names})
    paths = {src: _library_path(src) for src in sources}
    procs = []
    for src in sources:
        if os.path.exists(paths[src]):
            continue
        tmp = f"{paths[src]}.{os.getpid()}.tmp"
        procs.append((src, tmp, subprocess.Popen(
            _nvcc_command(src, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, tmp, proc in procs:
        out, _ = proc.communicate()
        build_log[src] = out
        if proc.returncode != 0:
            failed.append(f"--- nvcc failed for {src} "
                          f"(exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, paths[src])
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: paths[SOURCES[name]] for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library holding one kernel (every missing library is
    built on first use)."""
    lib = _libs.get(SOURCES[name])
    if lib is not None:
        return lib
    with _lock:
        if SOURCES[name] not in _libs:
            paths = build([n for n in SOURCES if SOURCES[n] not in _libs])
            for n, path in paths.items():
                dll = _libs.get(SOURCES[n])
                if dll is None:
                    dll = _libs[SOURCES[n]] = ctypes.CDLL(path)
                    dll.dkt_error_string.argtypes = [_I]
                    dll.dkt_error_string.restype = ctypes.c_char_p
                sym, argtypes = _SIGNATURES[n]
                fn = getattr(dll, sym)
                fn.argtypes = argtypes
                fn.restype = _I
        return _libs[SOURCES[name]]


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise when a launcher reported a CUDA error (a refused launch
    never runs, and a later synchronize would not say so)."""
    if err != 0:
        msg = lib.dkt_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


@functools.lru_cache(maxsize=None)
def num_sms(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``: what the
    kernels' split plans size their grids by."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def count_launch(name: str) -> None:
    # worker threads (parallel.async_host) launch concurrently
    with _count_lock:
        _launches[name] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0
