from .gn import GNState, FactoredProblem, factorize, gn_solve
from .posterior import Posterior
from .distributed import (
    DistributedFactoredProblem,
    DistributedPosterior,
    factorize_distributed,
    gn_solve_distributed,
)

__all__ = [
    "GNState",
    "FactoredProblem",
    "factorize",
    "gn_solve",
    "Posterior",
    "DistributedFactoredProblem",
    "DistributedPosterior",
    "factorize_distributed",
    "gn_solve_distributed",
]
