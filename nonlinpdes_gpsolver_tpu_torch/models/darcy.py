"""Darcy-flow inverse problem: infer ``a`` and ``u`` in ``-div(a grad u) = f``
from noisy point observations of ``u``.

Counterpart of ``nonlinpdes_gpsolver_tpu/models/darcy.py``: joint GPs on the
state ``u`` and the log-coefficient ``phi = log a``, coupled through the
eliminated Laplacian

    Delta u = -u_x1 phi_x1 - u_x2 phi_x2 - f exp(-phi)

plus the data misfit ``(1/noise^2) sum (u(X_data) - obs)^2``. The data
points are the first ``N_data`` rows of ``X_domain``.

Latent ``z = (w0, w1, w2, v0, v1, v2) = (phi, phi_x1, phi_x2, u, u_x1, u_x2)``
at the interior points (``6 N_d``). Gram layouts (row order):

* ``a`` block: ``[phi_x1, phi_x2, phi] @ interior``;
* ``u`` block: ``[u_x1, u_x2, Delta u, u] @ interior, u @ boundary``.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..ops.assembly import Observable
from ..ops.kernels import SquaredExponential
from ..ops.operators import d, identity, laplacian
from ..utils import tracing
from .elliptic import Values, _eval_on, _latent_init
from .spec import CollocationProblem, GPBlock, Misfit


@lru_cache(maxsize=None)
def _darcy_residuals(N_d: int, N_data: int):
    """``(residual_a, residual_u, data_misfit)`` of one configuration
    (cached, as in the JAX package); the split uses ``N_d`` and the misfit
    ``N_data``, Python integers."""

    def split(z):
        return tuple(z[k * N_d : (k + 1) * N_d] for k in range(6))

    def residual_a(z, data):
        w0, w1, w2, *_ = split(z)
        return torch.cat([w1, w2, w0])

    def residual_u(z, data):
        w0, w1, w2, v0, v1, v2 = split(z)
        lap_u = -v1 * w1 - v2 * w2 - data["f"] * torch.exp(-w0)
        return torch.cat([v1, v2, lap_u, v0, data["g"]])

    def data_misfit(z, data):
        return split(z)[3][:N_data] - data["obs"]

    return residual_a, residual_u, data_misfit


def darcy_flow(
    kernel_u: SquaredExponential,
    kernel_a: SquaredExponential,
    X_domain: torch.Tensor,
    X_boundary: torch.Tensor,
    data_u: torch.Tensor,
    rhs_f: Values,
    bdy_g: Values = None,
    noise_level: float = 1e-3,
    init: str = "random",
    seed: int = 0,
) -> CollocationProblem:
    """``data_u``: noisy observations of ``u`` at ``X_domain[:N_data]``. The
    problem lives on the device and dtype of ``X_domain``."""
    N_d = int(X_domain.shape[0])
    trace = tracing.Record()
    with trace.building():
        data = {
            "f": _eval_on(rhs_f, X_domain),
            "g": _eval_on(bdy_g, X_boundary),
            "obs": data_u.to(device=X_domain.device, dtype=X_domain.dtype),
        }
    residual_a, residual_u, data_misfit = _darcy_residuals(N_d, int(data_u.shape[0]))

    obs_a = (
        Observable("domain", d(0)),
        Observable("domain", d(1)),
        Observable("domain", identity()),
    )
    obs_u = (
        Observable("domain", d(0)),
        Observable("domain", d(1)),
        Observable("domain", laplacian()),
        Observable("domain", identity()),
        Observable("boundary", identity()),
    )
    return CollocationProblem(
        name="darcy_flow",
        blocks=(
            GPBlock("a", kernel_a, obs_a, residual_a),
            GPBlock("u", kernel_u, obs_u, residual_u),
        ),
        points={"domain": X_domain, "boundary": X_boundary},
        data=data,
        latent_dim=6 * N_d,
        misfits=(Misfit("data", data_misfit, 1.0 / float(noise_level) ** 2),),
        latent_init=_latent_init(init, 6 * N_d, seed, X_domain),
        trace=trace,
    )
