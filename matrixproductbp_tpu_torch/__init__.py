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
marginal-only beliefs.  The observables (two-time, pair and alternate
marginals, the pair-route free energy, ``logprob``), the enumeration
oracles (``exact``), the observation builders, the soft-margin sampler
(``sampling``) and SMC (``smc``) read a state on its device.  Time-varying
tables (``build_tables_t``), periodic (trace-closed) states
(``periodic_mpbp``, ``periodic=True``) and the symmetry-collapsed infinite
graphs of ``infinite`` run through the same calls.  ``stationary`` runs the
T -> infinity mode on uniform single-core messages (``mpbp_stationary*``,
``iterate_stationary``), and ``checkpoint`` saves and restores a state in
the JAX package's file format (``CheckpointManager`` writes
asynchronously).  ``parallel`` partitions the graph and sweeps it over
``torch.distributed`` ranks by halo exchange (``halo_mpbp``,
``halo_sweep``), and ``smc_sample(group=)`` splits SMC's particles over
ranks; ``graph_from_edges`` builds with the C++ builder of ``native`` where
g++ builds it.  The hand-written CUDA kernels (``csrc/*.cu``: the
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
from .ops.tensortrain import (TensorTrain, flat_tt, rand_tt, evaluate,
                              lognorm, normalization, normalize,
                              normalize_eachmatrix, marginals,
                              twovar_marginals, orthogonalize_left,
                              orthogonalize_right, compress, tt_sum, tt_dot,
                              bond_ranks)
from .ops.mpem import (mpem3_to_mpem2, mpem3_to_mpem2_periodic,
                       evaluate_mpem3, evaluate_mpem3_periodic)
from .ops.stta import SeededSketches
from .bp import (MPBP, mpbp, periodic_mpbp, bp_sweep, bp_sweep_chunked, iterate, beliefs,
                 beliefs_tu, pair_beliefs, pair_beliefs_as_tt,
                 pair_beliefs_as_mpem, pair_lognorms, belief_lognorms,
                 bethe_free_energy_pair, bethe_free_energy, means,
                 autocorrelations, autocovariances, pair_correlations,
                 alternate_marginals, alternate_correlations, logprob,
                 expectation, reset, reset_messages, reset_beliefs,
                 reset_observations, is_periodic, is_free_dynamics, getT,
                 getN, nstates, CB_BP, resolve_device)
from .observations import (pair_observations_directed,
                           pair_observations_nondirected,
                           pair_obs_undirected_to_directed)
from .infinite import (infinite_regular_graph, infinite_bipartite_graph,
                       mpbp_infinite_graph, periodic_mpbp_infinite_graph,
                       mpbp_infinite_bipartite_graph,
                       bethe_free_energy_infinite_bipartite)
from .stationary import (TruncVUMPS, UniformMessage, mpbp_stationary,
                         mpbp_stationary_infinite_graph,
                         mpbp_stationary_infinite_bipartite_graph,
                         iterate_stationary, beliefs_stationary,
                         bethe_free_energy_stationary)
from .checkpoint import save_checkpoint, load_checkpoint, CheckpointManager
from .utils import mean_with_uncertainty
from . import bigsweep
from . import exact
from . import sampling
from . import smc
from . import parallel
from .convert import from_numpy_state, to_numpy_state
from .exact import (exact_prob, site_marginals, exact_marginals,
                    exact_pair_marginals, exact_alternate_marginals,
                    exact_autocorrelations, exact_autocovariances,
                    exact_marginal_expectations,
                    exact_pair_marginal_expectations,
                    exact_alternate_marginal_expectations)
from .sampling import (SoftMarginSampler, sample, sample_one, marginals_mc,
                       pair_marginals_mc, means_mc, autocorrelations_mc,
                       autocovariances_mc, draw_node_observations,
                       simulate_queue_sis, continuous_sis_sampler)
from .smc import smc_sample

__all__ = [
    "Graph", "graph_from_edges", "random_regular_graph", "erdos_renyi_graph",
    "erdos_renyi_gnm", "random_tree", "star_graph", "path_graph",
    "RecursiveFactorTables", "FactorSpec", "TraceFactorSpec",
    "DampedFactorSpec", "RestrictedFactorSpec", "build_tables",
    "build_tables_t", "transition_probs",
    "SVDTrunc", "TruncThresh", "TruncBond", "TruncBondMax", "TruncBondThresh",
    "default_truncator", "TensorTrain", "flat_tt", "rand_tt", "evaluate",
    "lognorm", "normalization", "normalize", "normalize_eachmatrix",
    "marginals", "twovar_marginals", "orthogonalize_left",
    "orthogonalize_right", "compress", "tt_sum", "tt_dot", "bond_ranks",
    "mpem3_to_mpem2", "mpem3_to_mpem2_periodic", "evaluate_mpem3",
    "evaluate_mpem3_periodic", "SeededSketches", "MPBP", "mpbp",
    "periodic_mpbp", "infinite_regular_graph", "infinite_bipartite_graph",
    "mpbp_infinite_graph", "periodic_mpbp_infinite_graph",
    "mpbp_infinite_bipartite_graph", "bethe_free_energy_infinite_bipartite",
    "TruncVUMPS", "UniformMessage", "mpbp_stationary",
    "mpbp_stationary_infinite_graph",
    "mpbp_stationary_infinite_bipartite_graph", "iterate_stationary",
    "beliefs_stationary", "bethe_free_energy_stationary",
    "save_checkpoint", "load_checkpoint", "CheckpointManager",
    "bp_sweep", "bp_sweep_chunked", "iterate", "beliefs", "beliefs_tu",
    "pair_beliefs", "pair_beliefs_as_tt", "pair_beliefs_as_mpem",
    "pair_lognorms", "belief_lognorms", "bethe_free_energy_pair",
    "bethe_free_energy", "means", "autocorrelations", "autocovariances",
    "pair_correlations", "alternate_marginals", "alternate_correlations",
    "logprob", "expectation", "reset", "reset_messages", "reset_beliefs",
    "reset_observations", "is_periodic", "is_free_dynamics", "getT", "getN",
    "nstates", "CB_BP", "resolve_device", "pair_observations_directed",
    "pair_observations_nondirected", "pair_obs_undirected_to_directed",
    "mean_with_uncertainty", "bigsweep", "exact", "sampling", "smc",
    "parallel",
    "from_numpy_state", "to_numpy_state", "exact_prob", "site_marginals",
    "exact_marginals", "exact_pair_marginals", "exact_alternate_marginals",
    "exact_autocorrelations", "exact_autocovariances",
    "exact_marginal_expectations", "exact_pair_marginal_expectations",
    "exact_alternate_marginal_expectations", "SoftMarginSampler", "sample",
    "sample_one", "marginals_mc", "pair_marginals_mc", "means_mc",
    "autocorrelations_mc", "autocovariances_mc", "draw_node_observations",
    "simulate_queue_sis", "continuous_sis_sampler", "smc_sample",
]
