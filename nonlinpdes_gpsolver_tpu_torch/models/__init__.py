from .spec import CollocationProblem, GPBlock, Misfit
from .elliptic import nonlinear_elliptic, nonlinear_elliptic_relaxed
from .burgers import burgers
from .eikonal import eikonal
from .darcy import darcy_flow

__all__ = [
    "CollocationProblem",
    "GPBlock",
    "Misfit",
    "nonlinear_elliptic",
    "nonlinear_elliptic_relaxed",
    "burgers",
    "eikonal",
    "darcy_flow",
]
