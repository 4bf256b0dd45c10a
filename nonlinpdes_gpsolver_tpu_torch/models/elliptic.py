"""Nonlinear elliptic equation ``-Delta u + alpha * u^m = f`` (Dirichlet BC).

Counterpart of ``nonlinpdes_gpsolver_tpu/models/elliptic.py``:

* observed functionals ``[Delta u @ interior, u @ interior, u @ boundary]``;
* elimination form: latent ``z`` = interior values of ``u``, with the
  Laplacian eliminated through the PDE, ``Delta u = alpha u^m - f``;
* relaxed (penalty) form: latent ``(v, w) ~ (Delta u, u)`` and the PDE
  residual penalized with weight ``1/pen_lambda``.

``rhs_f`` and ``bdy_g`` are callables of one point, evaluated over the
points with ``torch.func.vmap``, or tensors of values, or ``None`` (zero).
The callables are evaluated once, when the problem is built, into the
problem's ``data``. The residuals come from ``lru_cache``'d factories, as
in the JAX package: one configuration gives the same function objects on
every rebuild, so that a problem rebuilt on fresh points and data shares
its recorded Gauss-Newton loop (``solvers/_reuse.py``). They close over
Python scalars only; every tensor reaches them through ``data``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Union

import torch

from ..ops.assembly import Observable
from ..ops.kernels import SquaredExponential
from ..ops.operators import identity, laplacian
from ..utils import tracing
from .spec import CollocationProblem, GPBlock, Misfit

Values = Union[Callable[[torch.Tensor], torch.Tensor], torch.Tensor, None]


def _eval_on(fn: Values, X: torch.Tensor) -> torch.Tensor:
    if fn is None:
        return torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)
    if isinstance(fn, torch.Tensor):
        return fn.to(device=X.device, dtype=X.dtype)
    return torch.func.vmap(fn)(X).to(X.dtype)


def _observables():
    return (
        Observable("domain", laplacian()),
        Observable("domain", identity()),
        Observable("boundary", identity()),
    )


@lru_cache(maxsize=None)
def _elliptic_residual(alpha: float, m: int):
    """The elimination form's residual (cached: one function per
    configuration)."""

    def residual(z, data):
        # [Delta u; u_int; u_bd] with Delta u eliminated via the PDE
        return torch.cat([alpha * z**m - data["f"], z, data["g"]])

    return residual


@lru_cache(maxsize=None)
def _elliptic_relaxed_residuals(alpha: float, m: int, N_d: int):
    """The penalty form's block residual and PDE penalty (cached)."""

    def residual(z, data):
        return torch.cat([z, data["g"]])  # [v; w; g] - linear in z

    def pde_penalty(z, data):
        v, w = z[:N_d], z[N_d:]
        return -v + alpha * w**m - data["f"]

    return residual, pde_penalty


def _latent_init(init: str, size: int, seed: int, like: torch.Tensor):
    def latent_init() -> torch.Tensor:
        if init == "zero":
            return torch.zeros(size, dtype=like.dtype, device=like.device)
        gen = torch.Generator(device=like.device).manual_seed(seed)
        return torch.randn(size, generator=gen, dtype=like.dtype, device=like.device)

    return latent_init


def nonlinear_elliptic(
    kernel: SquaredExponential,
    X_domain: torch.Tensor,
    X_boundary: torch.Tensor,
    rhs_f: Values,
    bdy_g: Values,
    alpha: float = 1.0,
    m: int = 3,
    init: str = "random",
    seed: int = 0,
) -> CollocationProblem:
    """Elimination form: latent z = u at the interior points.

    The problem lives on the device and dtype of ``X_domain``. ``init='random'``
    draws ``z0`` from a ``torch.Generator`` seeded with ``seed`` on that
    device; it is not the JAX package's draw (pass that through
    :func:`..interop.problem_from_numpy`).
    """
    N_d = X_domain.shape[0]
    trace = tracing.Record()
    with trace.span("build"):
        data = {"f": _eval_on(rhs_f, X_domain), "g": _eval_on(bdy_g, X_boundary)}
    residual = _elliptic_residual(float(alpha), int(m))
    return CollocationProblem(
        name="nonlinear_elliptic",
        blocks=(GPBlock("u", kernel, _observables(), residual),),
        points={"domain": X_domain, "boundary": X_boundary},
        data=data,
        latent_dim=N_d,
        latent_init=_latent_init(init, N_d, seed, X_domain),
        trace=trace,
    )


def nonlinear_elliptic_relaxed(
    kernel: SquaredExponential,
    X_domain: torch.Tensor,
    X_boundary: torch.Tensor,
    rhs_f: Values,
    bdy_g: Values,
    alpha: float = 1.0,
    m: int = 3,
    pen_lambda: float = 1e-10,
    init: str = "random",
    seed: int = 0,
) -> CollocationProblem:
    """Penalty form: latent z = (v, w) ~ (Delta u, u) at the interior points.

    Loss: ``||L^{-1}[v; w; g]||^2 + (1/pen_lambda)||-v + alpha w^m - f||^2``.
    """
    N_d = int(X_domain.shape[0])
    trace = tracing.Record()
    with trace.span("build"):
        data = {"f": _eval_on(rhs_f, X_domain), "g": _eval_on(bdy_g, X_boundary)}
    residual, pde_penalty = _elliptic_relaxed_residuals(float(alpha), int(m), N_d)
    return CollocationProblem(
        name="nonlinear_elliptic_relaxed",
        blocks=(GPBlock("u", kernel, _observables(), residual),),
        points={"domain": X_domain, "boundary": X_boundary},
        data=data,
        latent_dim=2 * N_d,
        misfits=(Misfit("pde", pde_penalty, 1.0 / pen_lambda),),
        latent_init=_latent_init(init, 2 * N_d, seed, X_domain),
        trace=trace,
    )
