"""Classical (host-side) solvers used to manufacture ground truth.

A copy of ``nonlinpdes_gpsolver_tpu/utils/classical.py`` (NumPy and SciPy
only): the port keeps its own, so that importing it never imports the JAX
package. Tests hold the two copies to equal outputs.

Capability match for ``reference_solver/`` upstream
(``Cole_Hopf_for_Eikonal.py:7-36``, ``FD_for_Darcy_flow.py:8-33``) and the
Burgers Cole-Hopf quadrature truth (``main_Burgers1d.py:87-92``). These run
once per experiment on the host to produce accuracy targets - plain
NumPy/SciPy sparse is the right tool, not the TPU.

Shared core: a variable-coefficient 5-point finite-volume operator for
``-div(a grad u)`` with homogeneous Dirichlet conditions on the unit square,
built from face-midpoint coefficient samples.

Grid conventions: interior nodes ``x_j = (j+1) h``, ``j = 0..N-1``,
``h = 1/(N+1)``; unknowns flattened row-major as ``u[i, j]`` with ``i`` the
x2 (row) index and ``j`` the x1 (column) index.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def five_point_operator(ax: np.ndarray, ay: np.ndarray, h: float) -> sp.csr_matrix:
    """Sparse ``-div(a grad .)`` on the interior, Dirichlet-0 boundary.

    ``ax[i, j]``: coefficient on the vertical face between ``u[i, j-1]`` and
    ``u[i, j]`` (shape ``(N, N+1)``); ``ay[i, j]``: coefficient on the
    horizontal face between ``u[i-1, j]`` and ``u[i, j]`` (shape
    ``(N+1, N)``).
    """
    N = ax.shape[0]
    diag = (ax[:, :-1] + ax[:, 1:] + ay[:-1, :] + ay[1:, :]).ravel()
    # east face of u[i,j] couples to u[i,j+1]; zero across row ends
    east = ax[:, 1:-1]
    east = np.hstack([east, np.zeros((N, 1))]).ravel()[:-1]
    # north face of u[i,j] couples to u[i+1,j]
    north = ay[1:-1, :].ravel()
    A = sp.diags(
        [diag, -east, -east, -north, -north],
        [0, 1, -1, N, -N],
        shape=(N * N, N * N),
        format="csr",
    )
    return A / h**2


def darcy_fd_solve(
    N: int,
    a_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
    f_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Solve ``-div(a grad u) = f`` on the unit square, u=0 on boundary.

    ``a_fn`` / ``f_fn`` take vectorized ``(x1, x2)`` arrays. Returns
    ``(x_full, y_full, u_full)`` where ``u_full`` is ``(N+2, N+2)`` including
    the zero boundary ring and ``u_full[i, j] = u(x1=x_full[j], x2=y_full[i])``.
    """
    h = 1.0 / (N + 1)
    grid = (np.arange(1, N + 1)) * h
    mid = (np.arange(0, N + 1) + 0.5) * h
    # vertical faces: x1 at midpoints, x2 at grid rows
    ax = a_fn(*np.meshgrid(mid, grid))          # (N, N+1)
    # horizontal faces: x1 at grid columns, x2 at midpoints
    ay = a_fn(*np.meshgrid(grid, mid))          # (N+1, N)
    A = five_point_operator(np.asarray(ax), np.asarray(ay), h)
    X1, X2 = np.meshgrid(grid, grid)
    f = np.asarray(f_fn(X1, X2)).ravel()
    u = spla.spsolve(A, f).reshape(N, N)
    u_full = np.zeros((N + 2, N + 2))
    u_full[1:-1, 1:-1] = u
    full = np.concatenate([[0.0], grid, [1.0]])
    return full, full, u_full


def eikonal_cole_hopf_solve(N: int, eps: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Regularized Eikonal ``|grad u|^2 = 1 + eps Delta u`` on the unit square,
    u=0 on the boundary, via the Cole-Hopf transform ``u = -eps log v``:
    ``v`` solves the screened Poisson problem ``eps^2 (-Delta v) + v = 0`` with
    ``v = 1`` on the boundary (interior system with boundary values moved to
    the right-hand side). Returns interior-grid ``(X1, X2, u)`` with
    ``u[i, j] = u(x1_j, x2_i)``.
    """
    h = 1.0 / (N + 1)
    ones_x = np.ones((N, N + 1))
    ones_y = np.ones((N + 1, N))
    A = five_point_operator(ones_x, ones_y, h)
    M = sp.identity(N * N, format="csr") + eps**2 * A
    # rhs: boundary ring contributes v_bd = 1 through each cut face
    rhs = np.zeros((N, N))
    rhs[0, :] += eps**2 / h**2
    rhs[-1, :] += eps**2 / h**2
    rhs[:, 0] += eps**2 / h**2
    rhs[:, -1] += eps**2 / h**2
    v = spla.spsolve(M, rhs.ravel()).reshape(N, N)
    u = -eps * np.log(v)
    grid = (np.arange(1, N + 1)) * h
    X1, X2 = np.meshgrid(grid, grid)
    return X1, X2, u


def burgers_cole_hopf_truth(nu: float, n_quad: int = 80) -> Callable:
    """Closed-form viscous Burgers solution for ``u_t + u u_x = nu u_xx``,
    ``u(0, x) = -sin(pi x)``, periodic-free-space Cole-Hopf integral evaluated
    by Gauss-Hermite quadrature (the truth used by the upstream Burgers
    script, ``main_Burgers1d.py:87-92``). Returns ``u(t, x)`` accepting
    scalars or arrays (vectorized via NumPy broadcasting).
    """
    q, w = np.polynomial.hermite.hermgauss(n_quad)

    def u(t, x):
        t = np.asarray(t, dtype=np.float64)
        x = np.asarray(x, dtype=np.float64)
        tt, xx = np.broadcast_arrays(t, x)
        shifted = xx[..., None] - np.sqrt(4.0 * nu * tt)[..., None] * q
        expo = np.exp(-np.cos(np.pi * shifted) / (2.0 * np.pi * nu))
        num = np.sum(w * np.sin(np.pi * shifted) * expo, axis=-1)
        den = np.sum(w * expo, axis=-1)
        return -num / den

    return u
