"""Small utilities (reference ``src/utils.jl``); a numpy copy of
``matrixproductbp_tpu/utils/misc.py``."""
from __future__ import annotations

import numpy as np

__all__ = ["mean_with_uncertainty", "sample_categorical"]


def mean_with_uncertainty(values, errors):
    """Mean of independent measurements with propagated standard error
    (reference ``mean_with_uncertainty``, ``utils.jl:24-35``)."""
    values = np.asarray(values, float)
    errors = np.asarray(errors, float)
    n = values.shape[0]
    return values.mean(axis=0), np.sqrt((errors ** 2).sum(axis=0)) / n


def sample_categorical(rng: np.random.Generator, p: np.ndarray) -> int:
    """Inverse-CDF draw (reference ``sample_noalloc``, ``utils.jl:10-21``)."""
    t = rng.random()
    c = 0.0
    for i, v in enumerate(p):
        c += v
        if c > t:
            return i
    return len(p) - 1
