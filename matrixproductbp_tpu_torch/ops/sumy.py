"""Sum-type (banded) y-merge support.

Counterpart of ``matrixproductbp_tpu/ops/sumy.py`` and of
``_band_indicator`` (``matrixproductbp_tpu/ops/fused_stta.py:826-833``).
Every Glauber variant has ``prob_yy(y, y1, y2) = (y == y1 + y2 - off)``
(0-indexed): the cavity merge over y is a banded convolution, not a dense
3-tensor contraction.  :func:`y_expand` materialises the band as a gather
(a Toeplitz or Hankel slab), after which every merge contraction is an
ordinary einsum; :func:`band_indicator` is the same band as a dense
``prob_yy``, the form the merge F scan kernels take.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["y_expand", "band_indicator"]


def y_expand(A: torch.Tensor, off: int, axis: int, mode: str) -> torch.Tensor:
    """Split the y-axis of ``A`` into an index pair along the band.

    mode='diff':  out[..., y, b, ...] = A[..., y + off - b, ...]
    mode='sum':   out[..., u, v, ...] = A[..., u + v - off, ...]

    Out-of-range indices give 0 (the gathered entry times 0, as the JAX
    package computes it).  The new pair replaces ``axis``."""
    Y = A.shape[axis]
    ax = axis % A.ndim
    iy = torch.arange(Y, device=A.device)[:, None]
    jb = torch.arange(Y, device=A.device)[None, :]
    idx = iy + off - jb if mode == "diff" else iy + jb - off
    ok = (idx >= 0) & (idx < Y)
    out = torch.index_select(A, ax, idx.clamp(0, Y - 1).reshape(-1))
    shp = list(A.shape)
    out = out.reshape(shp[:ax] + [Y, Y] + shp[ax + 1:])
    mask_shape = [1] * ax + [Y, Y] + [1] * (A.ndim - ax - 1)
    return out * ok.reshape(mask_shape).to(A.dtype)


def band_indicator(Y: int, off: int, q: int, dtype=torch.float64,
                   device=None) -> torch.Tensor:
    """Dense ``prob_yy`` of the sum-type band: [Y(y), Y(u), Y(v), q], 1
    where ``u == y + off - v`` lies in range."""
    y = np.arange(Y)[:, None, None]
    u = np.arange(Y)[None, :, None]
    v = np.arange(Y)[None, None, :]
    band = (u == y + off - v) & (y + off - v >= 0) & (y + off - v < Y)
    band = np.ascontiguousarray(np.broadcast_to(band[..., None], (Y, Y, Y, q)))
    return torch.from_numpy(band).to(device=device, dtype=dtype)
