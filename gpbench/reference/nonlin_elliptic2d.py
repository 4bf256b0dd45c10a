"""Plain reference of ``-Delta u + u^3 = f`` on the unit square (Dirichlet).

The GP collocation solve written from its mathematics: the latent ``z`` is
``u`` at the interior points, the observed functionals are
``[Delta u, u]`` at the interior points and ``u`` at the boundary, and
``Delta u`` is eliminated through the PDE (``Delta u = z^3 - f``). The
Gram matrix ``Theta`` of those functionals (``gaussian.py``) with its
adaptive nugget is factored once; Gauss-Newton minimizes
``|L^{-1} F(z)|^2``, ``F(z) = [z^3 - f, z, g]``, by full steps
``(J^T J)^{-1} J^T r`` from the given ``z0`` (a non-finite iterate is
rejected); the posterior mean at the test points is
``K(X_test, .) Theta^{-1} F(z*)``. ``f`` and ``g`` are worked out here in
closed form from the manufactured solution
``u = sin(pi x1) sin(pi x2) + 2 sin(4 pi x1) sin(4 pi x2)``.
"""

from __future__ import annotations

import math

import torch

from . import gaussian
from .linalg import Precision, gn_direction, whitening


def truth(X: torch.Tensor) -> torch.Tensor:
    x1, x2 = X[:, 0], X[:, 1]
    return (torch.sin(math.pi * x1) * torch.sin(math.pi * x2)
            + 2 * torch.sin(4 * math.pi * x1) * torch.sin(4 * math.pi * x2))


def rhs(X: torch.Tensor) -> torch.Tensor:
    """``-Delta u + u^3`` of :func:`truth`."""
    x1, x2 = X[:, 0], X[:, 1]
    s1 = torch.sin(math.pi * x1) * torch.sin(math.pi * x2)
    s4 = torch.sin(4 * math.pi * x1) * torch.sin(4 * math.pi * x2)
    return 2 * math.pi**2 * s1 + 64 * math.pi**2 * s4 + truth(X) ** 3


def solve(cfg: dict, inputs: dict, X_test: torch.Tensor, prec: Precision = Precision(),
          working_dtype: torch.dtype = torch.float32) -> dict:
    """``{"u": posterior mean at X_test, "z": the last iterate, "scales":
    the nugget scale worked out}`` in ``prec``; ``working_dtype`` (the
    configuration's) sets the nugget rule (``linalg.whitening``)."""
    dt = prec.dtype
    Xd, Xb = inputs["X_domain"].to(dt), inputs["X_boundary"].to(dt)
    z = inputs["z0"].to(dt)
    N = Xd.shape[0]
    a = 1.0 / (2.0 * cfg["sigma"] ** 2)
    segments = [("lap", Xd), ("id", Xd), ("id", Xb)]
    W, scale = whitening(segments, a, cfg["nugget"], dt, working_dtype)
    f, g = rhs(Xd), truth(Xb)

    def F(z):
        return torch.cat([z**3 - f, z, g])

    eye = torch.eye(N, dtype=dt, device=Xd.device)
    zeros = torch.zeros((Xb.shape[0], N), dtype=dt, device=Xd.device)
    for _ in range(cfg["gn_steps"]):
        J_raw = torch.cat([torch.diag(3 * z**2), eye, zeros])
        r = prec.mm(W, F(z)[:, None])[:, 0]
        z_new = z - gn_direction(prec, prec.mm(W, J_raw), r)
        if bool(torch.isfinite(z_new).all()):
            z = z_new
    weights = prec.mm(W.T, prec.mm(W, F(z)[:, None]))[:, 0]
    K = gaussian.cross("id", X_test.to(dt), segments, a)
    return {"u": prec.mm(K, weights[:, None])[:, 0], "z": z, "scales": {"u": scale}}
