from ._reuse import clear_graph_cache
from .gn import GNState, FactoredProblem, factorize, gn_solve
from .posterior import Posterior
from .distributed import (
    DistributedFactoredProblem,
    DistributedPosterior,
    factorize_distributed,
    gn_solve_distributed,
)

__all__ = [
    "clear_graph_cache",
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
