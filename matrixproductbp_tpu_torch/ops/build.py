"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles at first use with ``nvcc`` for ``sm_90a`` into a shared
library of its own with a plain C interface, loaded with ``ctypes``.  A
library is cached under ``matrixproductbp_tpu_torch/_build/`` by the hash of
its source, the headers under ``csrc/``, the flags and its macros, so a
checkout builds each (source, macros) pair exactly once; the ``-Xptxas -v``
report (registers, shared memory, spills per kernel) is kept beside it.
Sources in :data:`PER_SHAPE` take their sizes as macros (``-D``) and are
built once per shape; the others (:data:`SOURCES`) take none.
:func:`build_all` starts one ``nvcc`` per missing library, all at once.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

__all__ = ["SOURCES", "PER_SHAPE", "library", "build_all", "build_log"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: dynamic shared memory one H100 block may use (232,448 bytes); the
#: wrappers refuse shapes that need more
SMEM_PER_BLOCK = 232448
#: shared memory of one H100 SM, and what each resident block reserves
SMEM_PER_SM, SMEM_RESERVED = 233472, 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
_LP = ctypes.POINTER(ctypes.c_longlong)

#: every source under ``csrc/`` and the launchers it exports, with their
#: ``argtypes`` (each launcher returns a CUDA error code as ``int``)
_SIGNATURES = {
    "stta_scans": {
        "stta_merge_w": [_I, _P, _LP, _P, _LP, _P, _P] + [_I] * 8 + [_L, _P],
        "stta_merge_f": ([_I, _P, _LP, _P, _LP, _P, _L, _P, _P, _P, _P, _P]
                         + [_I] * 9 + [_L, _P]),
        "stta_mpem3_w": [_I, _P, _LP, _P, _P] + [_I] * 7 + [_L, _P],
        "stta_mpem3_f": ([_I, _P, _LP, _P, _P, _P, _P, _P] + [_I] * 8
                         + [_L, _P]),
    },
    "cholqr": {
        "cholqr": [_I, _P, _P, _P, _I, _I, _I, _D, _I, _L, _P],
    },
    "jacobi_eigh": {
        "jacobi_eigh": [_P, _P, _P, _I, _I, _I, _I, _L, _P],
    },
    "merge_f_staged": {
        "merge_f_staged": ([_P, _LP, _P, _LP, _P, _L, _P, _P, _P, _P, _P]
                           + [_I] * 8 + [_L, _P]),
    },
    "merge_f_cluster": {
        "merge_f_cluster": ([_P, _LP, _P, _LP, _P, _L, _P, _P, _P, _P, _P]
                            + [_I] * 8 + [_L, _P]),
        "merge_f_cluster_occupancy": [_L],
    },
    "merge_w_staged": {
        "merge_w_staged": [_P, _LP, _P, _LP, _P, _P] + [_I] * 7 + [_L, _P],
    },
    "merge_streamed": {
        "merge_w_streamed": [_I, _P, _LP, _P, _LP, _P, _P, _P] + [_I] * 8
                            + [_L, _P],
        "merge_f_streamed": ([_I, _P, _LP, _P, _LP, _P, _L, _P, _P, _P, _P,
                              _P, _P] + [_I] * 9 + [_L, _P]),
    },
    # one of the two launchers a build (WD_KIND 0: W, 1: F)
    "merge_wide": {
        "merge_w_wide": [_P, _LP, _P, _LP, _P, _P] + [_I] * 7 + [_L, _P],
        "merge_f_wide": ([_P, _LP, _P, _LP, _P, _L, _P, _P, _P, _P, _P]
                         + [_I] * 8 + [_L, _P]),
        "merge_wide_occupancy": [_L],
    },
    "cholqr_staged": {
        "cholqr_staged": [_P, _P, _P, _I, _I, _I, _D, _L, _P],
    },
    # one of the two launchers a build (M3_SL > 0: F, else W); the clock
    # counters with M3_CLOCKS=1 only
    "mpem3_staged": {
        "mpem3_f_staged": [_P, _LP, _P, _P, _P, _P, _P] + [_I] * 7
                          + [_L, _P],
        "mpem3_w_staged": [_P, _LP, _P, _P] + [_I] * 6 + [_L, _P],
        "mpem3_staged_clocks": [_P],
    },
}
#: sources built once per shape, with their sizes as macros
PER_SHAPE = ("merge_f_staged", "merge_f_cluster", "merge_w_staged",
             "merge_wide", "cholqr_staged", "mpem3_staged")
#: sources built once, without macros
SOURCES = tuple(n for n in _SIGNATURES if n not in PER_SHAPE)


def _nvcc() -> str:
    path = shutil.which("nvcc")
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if path is None and os.path.exists(default):
        path = default
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _flags(defines=()) -> list:
    return NVCC_FLAGS + [f"-D{d}" for d in defines]


def _paths(name: str, defines=()):
    src = os.path.join(_CSRC, name + ".cu")
    h = hashlib.sha256()
    for path in [src] + sorted(os.path.join(_CSRC, f)
                               for f in os.listdir(_CSRC)
                               if f.endswith(".cuh")):
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(_flags(defines)).encode())
    stem = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}")
    return src, stem + ".so", stem + ".log"


def _target(t):
    """A build target: a source's name, or (name, macros) for a source of
    :data:`PER_SHAPE`, the macros a tuple of ``"NAME=value"`` strings."""
    name, defines = (t, ()) if isinstance(t, str) else (t[0], tuple(t[1]))
    if (name in PER_SHAPE) != bool(defines):
        raise ValueError(f"{name}: macros are given exactly for the sources "
                         f"built per shape {PER_SHAPE}")
    return name, defines


def build_all(targets=SOURCES) -> dict:
    """Compile every target (see :func:`_target`) whose library is
    missing, one ``nvcc`` each, all started together; return {target:
    library path}.  Writes go to temporary names first, so concurrent
    builds never load a half-written file."""
    libs, running = {}, []
    for t in targets:
        name, defines = _target(t)
        src, lib, log = _paths(name, defines)
        libs[t] = lib
        if os.path.exists(lib):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *_flags(defines), "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((proc, src, tmp, lib, log))
    errors = []
    for proc, src, tmp, lib, log in running:
        try:
            out, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {src}:\n{err}")
                continue
            with open(log + ".tmp", "w") as fh:
                fh.write(out + err)
            os.replace(log + ".tmp", log)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def build_log(name: str, defines=()) -> str:
    """The ``-Xptxas -v`` report of one source's build."""
    _, _, log = _paths(name, tuple(defines))
    with open(log) as fh:
        return fh.read()


@functools.lru_cache(maxsize=None)
def library(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """Build (at first use) and load one source's library, with ``argtypes``
    and ``restype`` declared for every launcher it exports; ``defines``
    are the macros of a source built per shape."""
    t = (name, defines) if defines else name
    lib = ctypes.CDLL(build_all((t,))[t])
    for fn, argtypes in _SIGNATURES[name].items():
        if not hasattr(lib, fn):
            continue
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib
