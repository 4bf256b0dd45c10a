from .spec import CollocationProblem, GPBlock, Misfit
from .elliptic import nonlinear_elliptic, nonlinear_elliptic_relaxed

__all__ = [
    "CollocationProblem",
    "GPBlock",
    "Misfit",
    "nonlinear_elliptic",
    "nonlinear_elliptic_relaxed",
]
