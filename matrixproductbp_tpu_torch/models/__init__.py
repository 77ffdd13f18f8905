"""Model families: Glauber/Ising dynamics, epidemics (SIS, SIRS,
heterogeneous SIS), equilibrium oracles and inference metrics; counterpart
of ``matrixproductbp_tpu/models``.  SIS, SIRS and Glauber also have
stationary (T -> infinity, ``stationary.py``) constructors."""

from .sis import (SIS, SISFactorSpec, sis_tables, mpbp_sis,
                  periodic_mpbp_sis, mpbp_stationary_sis, SUSCEPTIBLE,
                  INFECTIOUS)
from .sirs import (SIRS, SIRSFactorSpec, mpbp_sirs, periodic_mpbp_sirs,
                   mpbp_stationary_sirs, RECOVERED)
from .sis_heterogeneous import (SISHeterogeneous, SISHeterogeneousFactorSpec,
                                mpbp_sis_heterogeneous,
                                periodic_mpbp_sis_heterogeneous)
from .glauber import (Ising, Glauber, potts2spin, spin2potts, energy,
                      HomogeneousGlauberFactorSpec, PMJGlauberFactorSpec,
                      IntegerGlauberFactorSpec, GenericGlauberFactorSpec,
                      glauber_factor_specs, mpbp_glauber,
                      periodic_mpbp_glauber, mpbp_stationary_glauber)
from .equilibrium import (RandomRegular, ErdosRenyi, equilibrium_observables,
                          equilibrium_magnetization, CB_Pop)
from .inference import find_infected_bp, roc, auc, kl_marginals, l1_marginals

__all__ = [
    "SIS", "SISFactorSpec", "sis_tables", "mpbp_sis",
    "periodic_mpbp_sis", "mpbp_stationary_sis", "SUSCEPTIBLE", "INFECTIOUS", "RECOVERED",
    "SIRS", "SIRSFactorSpec", "mpbp_sirs", "periodic_mpbp_sirs",
    "mpbp_stationary_sirs",
    "SISHeterogeneous", "SISHeterogeneousFactorSpec", "mpbp_sis_heterogeneous",
    "periodic_mpbp_sis_heterogeneous",
    "Ising", "Glauber", "potts2spin", "spin2potts", "energy",
    "HomogeneousGlauberFactorSpec", "PMJGlauberFactorSpec",
    "IntegerGlauberFactorSpec", "GenericGlauberFactorSpec",
    "glauber_factor_specs", "mpbp_glauber", "periodic_mpbp_glauber",
    "mpbp_stationary_glauber",
    "RandomRegular", "ErdosRenyi", "equilibrium_observables",
    "equilibrium_magnetization", "CB_Pop",
    "find_infected_bp", "roc", "auc", "kl_marginals", "l1_marginals",
]
