"""Plain reference of the viscous Burgers equation ``u_t + alpha u u_x - nu u_xx = 0``
on (t, x) in [0, 1] x [-1, 1], ``u(0, x) = -sin(pi x)``, ``u = 0`` at ``x = +-1``.

The GP collocation solve written from its mathematics, under the
anisotropic Gaussian kernel (``anisotropic.py``, ``a_k = 1 / s_k^2`` for
the configuration's lengthscales). The latent ``z = (u, u_x, u_xx)`` at
the interior points; the observed functionals are ``[u_t, u_x, u_xx, u]``
at the interior points and ``u`` at the boundary points, and ``u_t`` is
eliminated through the PDE, ``u_t = nu u_xx - alpha u u_x``. The Gram
matrix ``Theta`` with its adaptive nugget is factored once (the nugget
scale worked out as ``linalg.py`` does); Gauss-Newton minimizes
``|L^{-1} F(z)|^2``, ``F(z) = [nu z_xx - alpha z_u z_x, z_x, z_xx, z_u, g]``,
from the given ``z0`` by exact steps ``(J^T J)^{-1} J^T r`` and the
guarded update (a step that is not finite or more than doubles the loss
is halved up to four times, the best finite trial kept; the loss before
the first step is that at ``z0``); the posterior mean at the test points
is ``K(X_test, .) Theta^{-1} F(z*)``. ``g`` is worked out here: ``-sin(pi
x)`` on ``t = 0`` and zero on the spatial faces.

Against the upstream script (``main_Burgers1d.py``, yifanc96/
NonLinPDEs-GPsolver): the same functionals and the same ``u_t``-eliminated
residual; the steps are Gauss-Newton steps on the whitened residual, where
upstream takes its step from an explicit Jacobian of the linearized PDE
(the two agree at a fixed point, not step by step).
"""

from __future__ import annotations

import math

import torch

from . import anisotropic
from .linalg import Precision, gn_direction


def boundary_values(Xb: torch.Tensor) -> torch.Tensor:
    """``-sin(pi x)`` on the initial-time face ``t = 0``, zero elsewhere."""
    return torch.where(Xb[:, 0] == 0.0, -torch.sin(math.pi * Xb[:, 1]),
                       torch.zeros_like(Xb[:, 1]))


def coefficients(cfg: dict) -> tuple:
    """``a_k = 1 / s_k^2`` of the configuration's lengthscales."""
    return tuple(1.0 / float(s) ** 2 for s in cfg["lengthscales"])


def solve(cfg: dict, inputs: dict, X_test: torch.Tensor, prec: Precision = Precision(),
          working_dtype: torch.dtype = torch.float32) -> dict:
    """``{"u": posterior mean at X_test, "z": the last iterate, "scales":
    the nugget scale worked out}`` in ``prec``; ``working_dtype`` (the
    configuration's) sets the nugget rule."""
    dt = prec.dtype
    Xd, Xb = inputs["X_domain"].to(dt), inputs["X_boundary"].to(dt)
    z = inputs["z0"].to(dt)
    N, dev = Xd.shape[0], Xd.device
    nu, alpha = float(cfg["nu"]), float(cfg["alpha"])
    a = coefficients(cfg)
    segments = [("d0", Xd), ("d1", Xd), ("d11", Xd), ("id", Xd), ("id", Xb)]
    W, scale = anisotropic.whitening(segments, a, cfg["nugget"], dt, working_dtype)
    g = boundary_values(Xb)

    def F(z):
        u, ux, uxx = z[:N], z[N : 2 * N], z[2 * N :]
        return torch.cat([nu * uxx - alpha * u * ux, ux, uxx, u, g])

    def residual(z):
        return prec.mm(W, F(z)[:, None])[:, 0]

    def jacobian(z):
        u, ux = z[:N], z[N : 2 * N]
        eye = torch.eye(N, dtype=dt, device=dev)
        J = torch.zeros((4 * N + Xb.shape[0], 3 * N), dtype=dt, device=dev)
        J[:N, :N] = torch.diag(-alpha * ux)
        J[:N, N : 2 * N] = torch.diag(-alpha * u)
        J[:N, 2 * N :] = nu * eye
        J[N : 2 * N, N : 2 * N] = eye
        J[2 * N : 3 * N, 2 * N :] = eye
        J[3 * N : 4 * N, :N] = eye
        return prec.mm(W, J)

    def trial(z, delta, s):
        zt = z - s * delta
        if not bool(torch.isfinite(zt).all()):
            return z, float("inf"), False
        r = residual(zt)
        return zt, float(torch.dot(r, r)), True

    r0 = residual(z)
    loss_in = float(torch.dot(r0, r0))
    for _ in range(cfg["gn_steps"]):
        delta = gn_direction(prec, jacobian(z), residual(z))
        zc, lc, fc = trial(z, delta, 1.0)
        if lc > 2.0 * loss_in:
            s = 1.0
            for _ in range(4):
                go_on = lc > 2.0 * loss_in
                s *= 0.5
                z2, l2, f2 = trial(z, delta, s)
                if go_on and l2 < lc:
                    zc, lc, fc = z2, l2, fc or f2
        if fc:
            z, loss_in = zc, lc
    weights = prec.mm(W.T, prec.mm(W, F(z)[:, None]))[:, 0]
    K = anisotropic.cross("id", X_test.to(dt), segments, a)
    return {"u": prec.mm(K, weights[:, None])[:, 0], "z": z, "scales": {"u": scale}}
