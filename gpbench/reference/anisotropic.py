"""Derivative blocks of the anisotropic Gaussian kernel, in closed form,
and the regularized factor of a Gram matrix of them.

``k(x, y) = exp(-sum_k a_k (x_k - y_k)^2)``, one ``a_k`` per dimension
(a lengthscale ``s_k`` gives ``a_k = 1 / s_k^2``). The kernel is a
product over dimensions, so with ``u = x - y`` a derivative of order ``n``
in dimension ``k`` is ``(-sqrt(a_k))^n H_n(sqrt(a_k) u_k) exp(-a_k u_k^2)``
(``H_n`` the physicists' Hermite polynomials, ``gaussian.py``'s form with
the dimension's own ``a_k``), and a derivative taken on ``y`` is minus one
taken on ``u``. The operators: ``"id"``, ``"d0"``, ``"d1"`` (first
derivatives in the two coordinates) and ``"d11"`` (the second derivative
in the second coordinate). Plain PyTorch, in the dtype of the points.

:func:`whitening` is ``linalg.whitening`` with these blocks: the
trace-adaptive nugget and the same nugget-scale rule (``linalg.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from .gaussian import _d1
from .linalg import escalation_start, factors_in

OPS = {
    "id": ((1.0, (0, 0)),),
    "d0": ((1.0, (1, 0)),),
    "d1": ((1.0, (0, 1)),),
    "d11": ((1.0, (0, 2)),),
}


def block(op_x: str, op_y: str, X: torch.Tensor, Y: torch.Tensor,
          a: Sequence[float]) -> torch.Tensor:
    """``(op_x (x) op_y) k`` on rows ``X`` and columns ``Y``."""
    U = X[:, None, :] - Y[None, :, :]
    g = torch.exp(-sum(a_k * U[..., k] ** 2 for k, a_k in enumerate(a)))
    out = torch.zeros_like(g)
    for cx, ax in OPS[op_x]:
        for cy, ay in OPS[op_y]:
            term = torch.full_like(g, cx * cy * (-1.0) ** sum(ay))
            for k, a_k in enumerate(a):
                n = ax[k] + ay[k]
                if n:
                    term = term * _d1(n, U[..., k], a_k)
            out += term
    return out * g


def gram(segments, a: Sequence[float]) -> torch.Tensor:
    """The symmetric Gram matrix of ``segments``, a list of ``(op, points)``."""
    rows = []
    for op_i, X_i in segments:
        rows.append(torch.cat([block(op_i, op_j, X_i, X_j, a) for op_j, X_j in segments], dim=1))
    return torch.cat(rows, dim=0)


def cross(op_x: str, X: torch.Tensor, segments, a: Sequence[float],
          chunk: int = 4096) -> torch.Tensor:
    """The cross-Gram of ``op_x`` at ``X`` against ``segments``, in row chunks."""
    return torch.cat([
        torch.cat([block(op_x, op_j, xs, X_j, a) for op_j, X_j in segments], dim=1)
        for xs in torch.split(X, chunk)])


def prior_diagonal(op: str, a: Sequence[float]) -> float:
    """``(op (x) op) k`` at ``u = 0``, the diagonal of that block."""
    x = torch.zeros((1, len(a)), dtype=torch.float64)
    return float(block(op, op, x, x, a)[0, 0])


def adaptive_nugget(segments, a: Sequence[float], nugget: float, dtype, device) -> torch.Tensor:
    """The diagonal regularizer of a Gram matrix of ``segments``: ``nugget``
    on identity rows, ``nugget`` times the ratio of the block's trace to
    that of all identity rows on a derivative block."""
    identity = sum(X.shape[0] for op, X in segments if op == "id")
    parts = []
    for op, X in segments:
        n = X.shape[0]
        ratio = 1.0 if op == "id" else n * prior_diagonal(op, a) / identity
        parts.append(torch.full((n,), nugget * ratio, dtype=dtype, device=device))
    return torch.cat(parts)


def whitening(segments, a: Sequence[float], nugget: float, dtype, working_dtype,
              max_rungs: int = 8):
    """``(W, scale)``: ``W = L^{-1}`` for the Cholesky factor ``L`` of
    ``Theta + scale diag(nug)`` in ``dtype``, the scale worked out as
    ``linalg.whitening`` does (from ``linalg.escalation_start``, tenfold
    while the matrix equilibrated in ``working_dtype`` has no factor stored
    in it, ``linalg.factors_in``, or the factorization in ``dtype`` fails)."""
    X = segments[0][1]
    theta = gram(segments, a)
    nug = adaptive_nugget(segments, a, nugget, dtype, X.device)
    if working_dtype == dtype:
        theta_w, nug_w = theta, nug
    else:
        segs_w = [(op, P.to(working_dtype)) for op, P in segments]
        theta_w = gram(segs_w, a)
        nug_w = adaptive_nugget(segs_w, a, nugget, working_dtype, X.device)
    scale = escalation_start(nugget, working_dtype)
    for _ in range(max_rungs):
        A_w = theta_w + torch.diag(scale * nug_w)
        d = torch.rsqrt(torch.diagonal(A_w))
        E = d[:, None] * A_w * d[None, :]
        E.fill_diagonal_(1.0)
        del A_w
        ok = factors_in(E.to(torch.float64), working_dtype)
        del E
        if ok:
            L, info = torch.linalg.cholesky_ex(theta + torch.diag(scale * nug))
            if int(info) == 0 and bool(torch.isfinite(L).all()):
                del theta, theta_w
                eye = torch.eye(L.shape[0], dtype=dtype, device=X.device)
                return torch.linalg.solve_triangular(L, eye, upper=False), scale
        scale *= 10.0
    raise FloatingPointError(f"no Cholesky factor up to nugget scale {scale:g}")
