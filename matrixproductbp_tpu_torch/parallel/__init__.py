"""Multi-rank BP: graph partitioning, the halo-exchange sweep over
``torch.distributed`` ranks, and a launcher of spawned ranks.

Counterpart of ``matrixproductbp_tpu/parallel``.  Its GSPMD placement
(``shard.py``: ``shard_mpbp``, ``pad_graph``, ``sharded_beliefs``) has no
counterpart: :func:`halo_mpbp` spreads the state over the ranks, and the
halo layout pads each rank's block instead of padding the graph.
"""
from .partition import partition_nodes, edge_cut
from .halo import (HaloPlan, HaloState, halo_plan, halo_mpbp, halo_sweep,
                   halo_beliefs, halo_bethe_free_energy, halo_to_mpbp)
from .launch import spawn_ranks

__all__ = ["partition_nodes", "edge_cut", "HaloPlan", "HaloState",
           "halo_plan", "halo_mpbp", "halo_sweep", "halo_beliefs",
           "halo_bethe_free_energy", "halo_to_mpbp", "spawn_ranks"]
