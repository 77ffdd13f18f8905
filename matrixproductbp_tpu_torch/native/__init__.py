"""The C++ graph builder and BFS partitioner, loaded through ctypes.

Counterpart of ``matrixproductbp_tpu/native``.  ``graphbuild.cpp`` is the
port's own copy of the JAX package's source.  g++ builds it at first use
into the port's ``_build/`` directory, under a name keyed by the hash of the
source and the flags, so a checkout builds it once; the write goes to a
temporary name first, so concurrent first uses never load a half-written
file.  Nothing is built or loaded in the JAX package's directory.

:func:`load` returns None when the library cannot be built or loaded (no
g++, a failed build); ``graph_from_edges(native=None)`` and
``parallel.partition_nodes(native=None)`` then take their numpy paths, and
``native=True`` raises.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

from ..ops.build import BUILD_DIR

__all__ = ["load", "build_graph_native", "partition_native"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "graphbuild.cpp")
#: no ``-march=native``: the library must run on any x86-64 host the
#: checkout is copied to
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]


def _lib_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libgraphbuild_{h.hexdigest()[:16]}.so")


def _compile(out: str):
    """g++ the source into ``out`` (through a temporary name beside it);
    raises RuntimeError when g++ is absent or the build fails."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the graph builder cannot be built")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, _SRC],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {_SRC}:\n{proc.stderr}")
        os.replace(tmp, out)
    except subprocess.TimeoutExpired as exc:
        raise RuntimeError(f"g++ timed out on {_SRC}") from exc
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _build() -> str:
    """The library's path, compiled first if it is missing; raises
    RuntimeError as :func:`_compile` does."""
    lib = _lib_path()
    if not os.path.exists(lib):
        _compile(lib)
    return lib


@functools.lru_cache(maxsize=None)
def load():
    """The library with every function's ``argtypes`` and ``restype``
    declared, built at first use; None when it cannot be built or loaded."""
    try:
        lib = ctypes.CDLL(_build())
    except (RuntimeError, OSError):
        return None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.mpbp_graph_degrees.restype = ctypes.c_int32
    lib.mpbp_graph_degrees.argtypes = [ctypes.c_int32, ctypes.c_int64,
                                       i32p, i32p, i32p]
    lib.mpbp_graph_build.restype = None
    lib.mpbp_graph_build.argtypes = [ctypes.c_int32, ctypes.c_int64, i32p,
                                     i32p, ctypes.c_int32, i32p, i32p, i32p,
                                     i32p, u8p, i32p, i32p]
    lib.mpbp_partition.restype = None
    lib.mpbp_partition.argtypes = [ctypes.c_int32, ctypes.c_int64, i32p,
                                   i32p, ctypes.c_int32, i32p, i32p]
    return lib


def _check_int32(n: int, what: str):
    if not 0 <= n < 2 ** 31:
        raise ValueError(f"{what} = {n} does not fit the builder's int32")


def build_graph_native(N: int, pairs: np.ndarray, dmax_req=None):
    """The ``Graph`` fields (E, dmax, edge_src, edge_dst, rev_edge, in_edges,
    in_mask, nbr, degree) of the unique undirected ``pairs`` [m, 2], or
    None when the library is unavailable.  ``dmax_req`` below the largest
    degree raises ValueError, as the numpy path does."""
    lib = load()
    if lib is None:
        return None
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    m = len(pairs)
    _check_int32(N, "N")
    _check_int32(2 * m, "E")
    if m and (pairs.min() < 0 or pairs.max() >= N):
        raise ValueError(f"edge endpoints must lie in [0, {N})")
    u = np.ascontiguousarray(pairs[:, 0], np.int32)
    v = np.ascontiguousarray(pairs[:, 1], np.int32)
    degree = np.zeros(N, np.int32)
    dmax = int(lib.mpbp_graph_degrees(N, m, u, v, degree))
    if dmax_req is not None:
        if dmax_req < dmax:
            raise ValueError(f"dmax={dmax_req} is below the max degree {dmax}")
        dmax = dmax_req
    dmax = max(dmax, 1)
    _check_int32(N * dmax, "N * dmax")
    E = 2 * m
    edge_src = np.zeros(E, np.int32)
    edge_dst = np.zeros(E, np.int32)
    rev_edge = np.zeros(E, np.int32)
    in_edges = np.zeros((N, dmax), np.int32)
    in_mask = np.zeros((N, dmax), np.uint8)
    nbr = np.zeros((N, dmax), np.int32)
    lib.mpbp_graph_build(N, m, u, v, dmax, edge_src, edge_dst, rev_edge,
                         in_edges.reshape(-1), in_mask.reshape(-1),
                         nbr.reshape(-1), degree)
    return (E, dmax, edge_src, edge_dst, rev_edge, in_edges,
            in_mask.astype(bool), nbr, degree)


def partition_native(graph, nparts: int, order: np.ndarray):
    """The greedy balanced BFS partition ``part[N]`` grown from the seeds in
    ``order`` (a permutation of the nodes), or None when the library is
    unavailable."""
    lib = load()
    if lib is None:
        return None
    if nparts < 1:
        raise ValueError(f"nparts must be at least 1: {nparts}")
    order = np.ascontiguousarray(order, np.int32)
    if order.shape != (graph.N,) or not np.array_equal(
            np.sort(order), np.arange(graph.N)):
        raise ValueError("order must be a permutation of the graph's nodes")
    part = np.zeros(graph.N, np.int32)
    lib.mpbp_partition(graph.N, graph.E,
                       np.ascontiguousarray(graph.edge_src, np.int32),
                       np.ascontiguousarray(graph.edge_dst, np.int32),
                       nparts, order, part)
    return part
