from .gn import GNState, FactoredProblem, factorize, gn_solve
from .posterior import Posterior

__all__ = ["GNState", "FactoredProblem", "factorize", "gn_solve", "Posterior"]
