"""Small host utilities (numpy copies of ``matrixproductbp_tpu/utils``)."""
from .misc import mean_with_uncertainty, sample_categorical

__all__ = ["mean_with_uncertainty", "sample_categorical"]
