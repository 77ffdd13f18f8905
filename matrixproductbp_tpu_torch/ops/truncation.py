"""SVD truncation policies.

Counterpart of ``matrixproductbp_tpu/ops/truncation.py``.  Shapes stay
static: a policy maps a descending singular-value vector ``s [..., k]`` to a
boolean keep-mask of the same shape; the SVD sweeps zero the discarded
directions and crop the sorted bond axis to a fixed capacity.  The sketch
sweep reads only the bond cap a policy implies (``max_bond``).
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["SVDTrunc", "TruncThresh", "TruncBond", "TruncBondMax",
           "TruncBondThresh", "default_truncator"]


def _below(s: torch.Tensor, d: int) -> torch.Tensor:
    """True on the first ``d`` entries of the last axis."""
    return torch.arange(s.shape[-1], device=s.device) < d


@dataclasses.dataclass(frozen=True)
class SVDTrunc:
    """Base truncation policy: maps singular values to a keep-mask."""

    def keep_mask(self, s: torch.Tensor) -> torch.Tensor:
        """s: [..., k] descending singular values -> bool mask [..., k]."""
        raise NotImplementedError

    @property
    def max_bond(self) -> int | None:
        """Static bond cap implied by the policy (None = capacity-limited)."""
        return None


@dataclasses.dataclass(frozen=True)
class TruncThresh(SVDTrunc):
    """Discard singular values below ``eps * ||sigma||_2``;
    ``TruncThresh(0.0)`` keeps every nonzero one."""

    eps: float = 1e-6

    def keep_mask(self, s: torch.Tensor) -> torch.Tensor:
        if self.eps == 0.0:
            return s > 0.0
        norm = torch.sqrt(torch.sum(s * s, dim=-1, keepdim=True))
        return s > self.eps * norm


@dataclasses.dataclass(frozen=True)
class TruncBond(SVDTrunc):
    """Keep the ``d`` largest singular values."""

    d: int

    def keep_mask(self, s: torch.Tensor) -> torch.Tensor:
        return _below(s, self.d) & (s > 0.0)

    @property
    def max_bond(self) -> int | None:
        return self.d


@dataclasses.dataclass(frozen=True)
class TruncBondMax(SVDTrunc):
    """Keep at most ``d`` singular values (the same rule as ``TruncBond``)."""

    d: int

    def keep_mask(self, s: torch.Tensor) -> torch.Tensor:
        return _below(s, self.d) & (s > 0.0)

    @property
    def max_bond(self) -> int | None:
        return self.d


@dataclasses.dataclass(frozen=True)
class TruncBondThresh(SVDTrunc):
    """Bond cap plus relative threshold."""

    d: int
    eps: float = 0.0

    def keep_mask(self, s: torch.Tensor) -> torch.Tensor:
        if self.eps > 0.0:
            norm = torch.sqrt(torch.sum(s * s, dim=-1, keepdim=True))
            thresh = s > self.eps * norm
        else:
            thresh = s > 0.0
        return _below(s, self.d) & thresh

    @property
    def max_bond(self) -> int | None:
        return self.d


def default_truncator() -> SVDTrunc:
    """Reference default: ``TruncThresh(1e-6)``."""
    return TruncThresh(1e-6)
