"""PyTorch/CUDA port of ``matrixproductbp_tpu`` (Matrix Product Belief
Propagation), for one NVIDIA H100.

The JAX package stays the reference; this package keeps its module names,
argument orders and array layouts.  It imports torch and numpy only.  Entry
points that make state (``mpbp``, the models' ``mpbp_*``,
``from_numpy_state``) place it on the CUDA card unless the caller passes
``device="cpu"``; every later call runs on the state's device.  Factors come
from ``build_tables`` over per-node ``FactorSpec``s or from a model's own
table function (SIS, SIRS, heterogeneous SIS and Glauber in ``models``).
``bp_sweep`` and ``iterate`` run ``method="sketch"``, ``"qr"`` and
``"randomized"`` (dense and banded ``prob_yy``), damping and
``iterate(polish=n)``; ``bp_sweep_chunked`` and ``iterate(chunk=,
schedule="seidel", shuffle=True)`` sweep in node chunks, Jacobi or
Gauss-Seidel, and ``bigsweep`` sweeps large graphs in place with
marginal-only beliefs.  The hand-written CUDA kernels (``csrc/*.cu``: the
sketch sweep's four time scans, the randomized merge's CholQR, and the
batched Jacobi eigensolver behind the card's small SVDs) are built with
``nvcc`` at first use; on CPU tensors their plain PyTorch versions run
instead.
"""

from .graph import (Graph, graph_from_edges, random_regular_graph,
                    erdos_renyi_graph, erdos_renyi_gnm, random_tree,
                    star_graph, path_graph)
from .factors import (RecursiveFactorTables, FactorSpec, TraceFactorSpec,
                      DampedFactorSpec, RestrictedFactorSpec, build_tables,
                      build_tables_t, transition_probs)
from .ops.truncation import (SVDTrunc, TruncThresh, TruncBond, TruncBondMax,
                             TruncBondThresh, default_truncator)
from .ops.tensortrain import TensorTrain, compress
from .ops.stta import SeededSketches
from .bp import (MPBP, mpbp, bp_sweep, bp_sweep_chunked, iterate, beliefs,
                 means, bethe_free_energy, resolve_device)
from . import bigsweep
from .convert import from_numpy_state, to_numpy_state

__all__ = [
    "Graph", "graph_from_edges", "random_regular_graph", "erdos_renyi_graph",
    "erdos_renyi_gnm", "random_tree", "star_graph", "path_graph",
    "RecursiveFactorTables", "FactorSpec", "TraceFactorSpec",
    "DampedFactorSpec", "RestrictedFactorSpec", "build_tables",
    "build_tables_t", "transition_probs",
    "SVDTrunc", "TruncThresh", "TruncBond", "TruncBondMax", "TruncBondThresh",
    "default_truncator", "TensorTrain", "compress", "SeededSketches", "MPBP",
    "mpbp", "bp_sweep", "bp_sweep_chunked", "bigsweep", "iterate", "beliefs",
    "means", "bethe_free_energy", "resolve_device", "from_numpy_state",
    "to_numpy_state",
]
