"""Derivative blocks of the isotropic Gaussian kernel, in closed form.

``k(x, y) = exp(-a |x - y|^2)`` with ``a = 1 / (2 sigma^2)``. With
``u = x - y``, a derivative of order ``n`` in dimension ``k`` is
``d^n/du_k^n exp(-a u_k^2) = (-sqrt(a))^n H_n(sqrt(a) u_k) exp(-a u_k^2)``
(``H_n`` the physicists' Hermite polynomials), and a derivative taken on
``y`` is minus one taken on ``u``. An operator is a sum of such
derivatives: ``"id"``, ``"d0"``, ``"d1"`` (first derivatives in x1, x2)
and ``"lap"`` (the Laplacian). Plain PyTorch, in the dtype of the points.
"""

from __future__ import annotations

import math

import torch

OPS = {
    "id": ((1.0, (0, 0)),),
    "d0": ((1.0, (1, 0)),),
    "d1": ((1.0, (0, 1)),),
    "lap": ((1.0, (2, 0)), (1.0, (0, 2))),
}


def _hermite(n: int, t: torch.Tensor) -> torch.Tensor:
    if n == 0:
        return torch.ones_like(t)
    h_prev, h = torch.ones_like(t), 2 * t
    for k in range(1, n):
        h_prev, h = h, 2 * t * h - 2 * k * h_prev
    return h


def _d1(n: int, u: torch.Tensor, a: float) -> torch.Tensor:
    """``d^n/du^n`` of ``exp(-a u^2)``, without the exponential."""
    return (-math.sqrt(a)) ** n * _hermite(n, math.sqrt(a) * u)


def block(op_x: str, op_y: str, X: torch.Tensor, Y: torch.Tensor, a: float) -> torch.Tensor:
    """``(op_x (x) op_y) k`` on rows ``X`` and columns ``Y``."""
    U = X[:, None, :] - Y[None, :, :]
    g = torch.exp(-a * torch.sum(U * U, dim=-1))
    out = torch.zeros_like(g)
    for cx, ax in OPS[op_x]:
        for cy, ay in OPS[op_y]:
            term = torch.full_like(g, cx * cy * (-1.0) ** sum(ay))
            for k in range(X.shape[1]):
                n = ax[k] + ay[k]
                if n:
                    term = term * _d1(n, U[..., k], a)
            out += term
    return out * g


def gram(segments, a: float) -> torch.Tensor:
    """The symmetric Gram matrix of ``segments``, a list of ``(op, points)``."""
    rows = []
    for op_i, X_i in segments:
        rows.append(torch.cat([block(op_i, op_j, X_i, X_j, a) for op_j, X_j in segments], dim=1))
    return torch.cat(rows, dim=0)


def cross(op_x: str, X: torch.Tensor, segments, a: float, chunk: int = 4096) -> torch.Tensor:
    """The cross-Gram of ``op_x`` at ``X`` against ``segments``, in row chunks."""
    return torch.cat([
        torch.cat([block(op_x, op_j, xs, X_j, a) for op_j, X_j in segments], dim=1)
        for xs in torch.split(X, chunk)])


def prior_diagonal(op: str, a: float, dim: int = 2) -> float:
    """``(op (x) op) k`` at ``u = 0``, the diagonal of that block."""
    x = torch.zeros((1, dim), dtype=torch.float64)
    return float(block(op, op, x, x, a)[0, 0])
