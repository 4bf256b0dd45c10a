"""Viscous Burgers equation ``u_t + alpha * u u_x - nu * u_xx = f`` on (t, x).

Counterpart of ``nonlinpdes_gpsolver_tpu/models/burgers.py``:

* coordinates are ``(t, x)``, usually under an anisotropic space-time kernel;
* observed functionals ``[u_t, u_x, u_xx, u] @ interior, u @ boundary``, the
  boundary being the initial-time face plus the spatial faces;
* latent ``z = (v0, v2, v3) = (u, u_x, u_xx)`` at the interior points
  (``3 N_d``); ``u_t`` is eliminated through the PDE,
  ``u_t = nu u_xx + f - alpha u u_x``.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..ops.assembly import Observable
from ..ops.kernels import SquaredExponential
from ..ops.operators import d, d2, identity
from ..utils import tracing
from .elliptic import Values, _eval_on, _latent_init
from .spec import CollocationProblem, GPBlock


@lru_cache(maxsize=None)
def _burgers_residual(alpha: float, nu: float, N_d: int):
    """The residual of one configuration (cached, as in the JAX package:
    a rebuilt problem shares its recorded loop)."""

    def residual(z, data):
        v0, v2, v3 = z[:N_d], z[N_d : 2 * N_d], z[2 * N_d :]
        u_t = nu * v3 + data["f"] - alpha * v0 * v2
        return torch.cat([u_t, v2, v3, v0, data["g"]])

    return residual


def burgers(
    kernel: SquaredExponential,
    X_domain: torch.Tensor,
    X_boundary: torch.Tensor,
    bdy_g: Values,
    rhs_f: Values = None,
    alpha: float = 1.0,
    nu: float = 0.02,
    init: str = "random",
    seed: int = 0,
) -> CollocationProblem:
    """The problem lives on the device and dtype of ``X_domain``;
    ``init='random'`` draws ``z0`` from a ``torch.Generator`` seeded with
    ``seed`` on that device (not the JAX package's draw)."""
    N_d = int(X_domain.shape[0])
    trace = tracing.Record()
    with trace.building():
        data = {"f": _eval_on(rhs_f, X_domain), "g": _eval_on(bdy_g, X_boundary)}
    residual = _burgers_residual(float(alpha), float(nu), N_d)
    observables = (
        Observable("domain", d(0)),        # u_t
        Observable("domain", d(1)),        # u_x
        Observable("domain", d2(1, 1)),    # u_xx
        Observable("domain", identity()),  # u
        Observable("boundary", identity()),
    )
    return CollocationProblem(
        name="burgers",
        blocks=(GPBlock("u", kernel, observables, residual),),
        points={"domain": X_domain, "boundary": X_boundary},
        data=data,
        latent_dim=3 * N_d,
        latent_init=_latent_init(init, 3 * N_d, seed, X_domain),
        trace=trace,
    )
