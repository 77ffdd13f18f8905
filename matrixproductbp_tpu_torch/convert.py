"""Carry a BP state between numpy arrays and the port.

The keys are those of the JAX package's checkpoint format
(``matrixproductbp_tpu/checkpoint.py:38-42, 62-74``): ``state.*``,
``tables.*``, ``graph.*`` and a ``meta`` entry holding UTF-8 JSON, so a
``.npz`` written by the JAX ``save_checkpoint`` loads with
``from_numpy_state(dict(np.load(path)))``, and ``np.savez(path,
**to_numpy_state(bp))`` writes one the JAX ``load_checkpoint`` reads.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .bp import MPBP, graph_arrays, resolve_device
from .factors import RecursiveFactorTables
from .graph import Graph

__all__ = ["from_numpy_state", "to_numpy_state"]

_FORMAT_VERSION = 1
_STATE_LEAVES = ("phi", "psi", "msg_cores", "msg_logz", "bel_cores",
                 "bel_logz", "f")
_TABLE_LEAVES = ("Py", "Pyp", "Pxy", "Pyy", "Py0")
_GRAPH_LEAVES = ("edge_src", "edge_dst", "rev_edge", "in_edges", "in_mask",
                 "nbr", "degree")


def _host_copy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", copy=True).numpy()


def to_numpy_state(bp: MPBP, step: int = 0, extra: dict | None = None
                   ) -> dict:
    """Host copies of all arrays of ``bp`` (later changes to ``bp`` do not
    reach them), plus the JSON ``meta`` entry carrying ``step`` and the
    JSON-serialisable ``extra``."""
    arrays = {}
    for name in _STATE_LEAVES:
        arrays["state." + name] = _host_copy(getattr(bp, name))
    for name in _TABLE_LEAVES:
        arrays["tables." + name] = _host_copy(getattr(bp.tables, name))
    for name in _GRAPH_LEAVES:
        arrays["graph." + name] = np.asarray(getattr(bp.graph, name))
    tb = bp.tables
    meta = {
        "format_version": _FORMAT_VERSION,
        "step": int(step),
        "periodic": bool(bp.periodic),
        "graph.N": int(bp.graph.N),
        "graph.E": int(bp.graph.E),
        "graph.dmax": int(bp.graph.dmax),
        "graph.infinite": bool(bp.graph.infinite),
        "tables.yy_off": tb.yy_off,
        "tables.ydims": list(tb.ydims) if tb.ydims is not None else None,
        "extra": extra or {},
    }
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                   dtype=np.uint8)
    return arrays


def from_numpy_state(arrays: dict, meta: dict | None = None,
                     device=None) -> MPBP:
    """Rebuild an :class:`MPBP` on ``device`` (default: the CUDA card) from
    :func:`to_numpy_state`'s arrays; ``meta`` defaults to the decoded
    ``arrays["meta"]``."""
    if meta is None:
        meta = json.loads(bytes(np.asarray(arrays["meta"])).decode("utf-8"))
    if meta.get("format_version") != _FORMAT_VERSION:
        raise ValueError(
            f"unsupported state format {meta.get('format_version')}")
    dev = resolve_device(device)
    graph = Graph(meta["graph.N"], meta["graph.E"], meta["graph.dmax"],
                  *(np.asarray(arrays["graph." + n]) for n in _GRAPH_LEAVES),
                  infinite=meta.get("graph.infinite", False))
    ydims = meta.get("tables.ydims")
    tables = RecursiveFactorTables(
        *(torch.as_tensor(np.asarray(arrays["tables." + n]), device=dev)
          for n in _TABLE_LEAVES),
        meta.get("tables.yy_off"), tuple(ydims) if ydims is not None else None)
    state = {n: torch.as_tensor(np.asarray(arrays["state." + n]), device=dev)
             for n in _STATE_LEAVES}
    return MPBP(tables=tables, garrays=graph_arrays(graph, dev), graph=graph,
                periodic=bool(meta.get("periodic", False)), **state)
