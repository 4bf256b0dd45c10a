"""Ground truths of the benchmark's problems, frozen.

* The manufactured elliptic solution and its right-hand side
  ``f = -Delta u + u^3``, copied from
  ``nonlinpdes_gpsolver_tpu_torch/workloads.py`` at commit 1237319
  (``u_elliptic``, ``elliptic_rhs``): callables of one point, as the
  program's model constructor takes them.
* The Darcy coefficient and the 80x80 finite-volume solve of
  ``-div(a grad u) = 1``, copied from
  ``nonlinpdes_gpsolver_tpu_torch/utils/classical.py``
  (``five_point_operator``, ``darcy_fd_solve``) and ``workloads.py``
  (``darcy_a``, ``darcy_truth``) at commit 1237319, NumPy and SciPy only.
* The observations: that solve interpolated bilinearly to the data points
  (what ``RegularGridInterpolator`` does in ``workloads.py::
  darcy_observations``, here on the points' device so that a draw needs no
  host read) plus Gaussian noise drawn by the caller.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch


def u_elliptic(x: torch.Tensor) -> torch.Tensor:
    """``sin(pi x1) sin(pi x2) + 2 sin(4 pi x1) sin(4 pi x2)`` at one point."""
    return torch.sin(torch.pi * x[0]) * torch.sin(torch.pi * x[1]) + 2 * torch.sin(
        4 * torch.pi * x[0]
    ) * torch.sin(4 * torch.pi * x[1])


def elliptic_rhs(alpha: float = 1.0, m: int = 3):
    """``f = -Delta u + alpha u^m`` of :func:`u_elliptic`, one point at a time."""

    def f(x):
        return -torch.trace(torch.func.hessian(u_elliptic)(x)) + alpha * u_elliptic(x) ** m

    return f


def darcy_a(x1, x2):
    """``a = exp(s) + exp(-s)``, ``s = sin(2 pi x1) + sin(2 pi x2)`` (NumPy)."""
    s = np.sin(2 * np.pi * x1) + np.sin(2 * np.pi * x2)
    return np.exp(s) + np.exp(-s)


def five_point_operator(ax: np.ndarray, ay: np.ndarray, h: float) -> sp.csr_matrix:
    """Sparse ``-div(a grad .)`` on the interior with a zero Dirichlet ring,
    from the coefficient on the vertical (``ax``) and horizontal (``ay``) faces."""
    N = ax.shape[0]
    diag = (ax[:, :-1] + ax[:, 1:] + ay[:-1, :] + ay[1:, :]).ravel()
    east = np.hstack([ax[:, 1:-1], np.zeros((N, 1))]).ravel()[:-1]
    north = ay[1:-1, :].ravel()
    A = sp.diags([diag, -east, -east, -north, -north], [0, 1, -1, N, -N],
                 shape=(N * N, N * N), format="csr")
    return A / h**2


def darcy_fd_solve(N: int, a_fn, f_fn):
    """``(x_full, y_full, u_full)``: ``-div(a grad u) = f`` on ``N x N``
    interior nodes, ``u_full[i, j] = u(x1=x_full[j], x2=y_full[i])`` with
    the zero boundary ring."""
    h = 1.0 / (N + 1)
    grid = np.arange(1, N + 1) * h
    mid = (np.arange(0, N + 1) + 0.5) * h
    ax = a_fn(*np.meshgrid(mid, grid))
    ay = a_fn(*np.meshgrid(grid, mid))
    A = five_point_operator(np.asarray(ax), np.asarray(ay), h)
    X1, X2 = np.meshgrid(grid, grid)
    u = spla.spsolve(A, np.asarray(f_fn(X1, X2)).ravel()).reshape(N, N)
    u_full = np.zeros((N + 2, N + 2))
    u_full[1:-1, 1:-1] = u
    full = np.concatenate([[0.0], grid, [1.0]])
    return full, full, u_full


def darcy_truth():
    """The 80x80 grid (the ring included) and the finite-volume solution on it."""
    return darcy_fd_solve(78, darcy_a, lambda x1, x2: np.ones_like(x1))


def bilinear(xs: np.ndarray, U: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of ``U[i, j] = u(x1=xs[j], x2=xs[i])`` on the
    uniform grid ``xs`` at the points ``X`` (rows ``(x1, x2)``), in ``U``'s dtype."""
    n = len(xs) - 1
    h = (xs[-1] - xs[0]) / n
    t = (X.to(U.dtype) - float(xs[0])) / h
    j = torch.clamp(torch.floor(t[:, 0]).long(), 0, n - 1)
    i = torch.clamp(torch.floor(t[:, 1]).long(), 0, n - 1)
    fx, fy = t[:, 0] - j, t[:, 1] - i
    return ((1 - fy) * ((1 - fx) * U[i, j] + fx * U[i, j + 1])
            + fy * ((1 - fx) * U[i + 1, j] + fx * U[i + 1, j + 1]))
