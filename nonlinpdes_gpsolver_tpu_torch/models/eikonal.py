"""Regularized Eikonal equation ``|grad u|^2 = f^2 + eps * Delta u``.

Counterpart of ``nonlinpdes_gpsolver_tpu/models/eikonal.py``. The right-hand
side is squared, as the reference's code (not its banner) has it:

* observed functionals ``[u_x1, u_x2, Delta u, u] @ interior, u @ boundary``;
* latent ``z = (v0, v1, v2) = (u, u_x1, u_x2)`` (``3 N_d``); ``Delta u`` is
  eliminated, ``Delta u = -(f^2 - v1^2 - v2^2) / eps``;
* the conventional initialization is zero.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..ops.assembly import Observable
from ..ops.kernels import SquaredExponential
from ..ops.operators import d, identity, laplacian
from ..utils import tracing
from .elliptic import Values, _eval_on, _latent_init
from .spec import CollocationProblem, GPBlock


@lru_cache(maxsize=None)
def _eikonal_residual(eps: float, N_d: int):
    """The residual of one configuration (cached, as in the JAX package)."""

    def residual(z, data):
        v0, v1, v2 = z[:N_d], z[N_d : 2 * N_d], z[2 * N_d :]
        lap_u = -(data["f"] ** 2 - v1**2 - v2**2) / eps
        return torch.cat([v1, v2, lap_u, v0, data["g"]])

    return residual


def eikonal(
    kernel: SquaredExponential,
    X_domain: torch.Tensor,
    X_boundary: torch.Tensor,
    rhs_f: Values,
    bdy_g: Values = None,
    eps: float = 0.1,
    init: str = "zero",
    seed: int = 0,
) -> CollocationProblem:
    """The problem lives on the device and dtype of ``X_domain``."""
    N_d = int(X_domain.shape[0])
    trace = tracing.Record()
    with trace.building():
        data = {"f": _eval_on(rhs_f, X_domain), "g": _eval_on(bdy_g, X_boundary)}
    residual = _eikonal_residual(float(eps), N_d)
    observables = (
        Observable("domain", d(0)),
        Observable("domain", d(1)),
        Observable("domain", laplacian()),
        Observable("domain", identity()),
        Observable("boundary", identity()),
    )
    return CollocationProblem(
        name="eikonal",
        blocks=(GPBlock("u", kernel, observables, residual),),
        points={"domain": X_domain, "boundary": X_boundary},
        data=data,
        latent_dim=3 * N_d,
        latent_init=_latent_init(init, 3 * N_d, seed, X_domain),
        trace=trace,
    )
