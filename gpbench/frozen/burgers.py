"""The viscous Burgers problem's truth, sampler and boundary data, frozen.

* :func:`cole_hopf_truth`: the Cole-Hopf solution of ``u_t + u u_x = nu
  u_xx``, ``u(0, x) = -sin(pi x)``, by 80-point Gauss-Hermite quadrature
  (the truth of ``main_Burgers1d.py:87-92``, yifanc96/NonLinPDEs-GPsolver),
  copied from ``nonlinpdes_gpsolver_tpu_torch/utils/classical.py::
  burgers_cole_hopf_truth`` at commit 84de896. NumPy only.
* :func:`sample_random`: the space-time draw of ``utils/sampling.py::
  sample_random(..., domain=((0, 1), (-1, 1)), time_dependent=True)`` at
  the same commit: uniform interior points ``(t, x)``, then per-face
  uniform boundary points on the initial-time face ``t = 0``, then on
  ``x = 1`` and ``x = -1`` (the remainder of ``n_boundary`` over the faces
  goes to the first ones), each coordinate drawn in float64 and mapped to
  its interval, then cast.
* :func:`g`: the boundary values as a callable of one point, ``-sin(pi x)``
  at ``t = 0`` and zero on the spatial faces (``workloads.py::burgers_g``
  at the same commit), as a user script passes them.
"""

from __future__ import annotations

import numpy as np
import torch

DOMAIN = ((0.0, 1.0), (-1.0, 1.0))


def cole_hopf_truth(nu: float, n_quad: int = 80):
    """``u(t, x)`` on NumPy arrays (broadcast), in float64."""
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


def _face_counts(n: int, faces: int) -> list:
    base, rem = divmod(n, faces)
    return [base + (1 if i < rem else 0) for i in range(faces)]


def _uniform(gen, shape, lo, hi, dtype, device):
    u = torch.rand(shape, generator=gen, dtype=torch.float64, device=device)
    lo = torch.as_tensor(lo, dtype=torch.float64, device=device)
    hi = torch.as_tensor(hi, dtype=torch.float64, device=device)
    return (lo + (hi - lo) * u).to(dtype)


def sample_random(gen: torch.Generator, n_domain: int, n_boundary: int, dtype):
    """``(X_domain, X_boundary)`` in ``(t, x)`` on ``[0, 1] x [-1, 1]``, on
    ``gen``'s device."""
    device = gen.device
    (a0, b0), (a1, b1) = DOMAIN
    X_domain = _uniform(gen, (n_domain, 2), [a0, a1], [b0, b1], dtype, device)
    specs = [(1, (a1, b1), 0, a0), (0, (a0, b0), 1, b1), (0, (a0, b0), 1, a1)]
    parts = []
    for (free_ax, (lo, hi), fixed_ax, fixed_val), cnt in zip(specs,
                                                             _face_counts(n_boundary, 3)):
        if cnt == 0:
            continue
        pts = torch.empty((cnt, 2), dtype=dtype, device=device)
        pts[:, free_ax] = _uniform(gen, (cnt,), lo, hi, dtype, device)
        pts[:, fixed_ax] = fixed_val
        parts.append(pts)
    X_boundary = torch.cat(parts) if parts else torch.zeros((0, 2), dtype=dtype, device=device)
    return X_domain, X_boundary


def test_grid(n0: int, n1: int, dtype, device) -> torch.Tensor:
    """The ``n0 x n1`` grid on ``[0, 1] x [-1, 1]``, ends included, row-major in t."""
    (a0, b0), (a1, b1) = DOMAIN
    XX, YY = np.meshgrid(np.linspace(a0, b0, n0), np.linspace(a1, b1, n1), indexing="ij")
    return torch.as_tensor(np.stack([XX.ravel(), YY.ravel()], axis=1), dtype=dtype,
                           device=device)


test_grid.__test__ = False


def g(x: torch.Tensor) -> torch.Tensor:
    """``-sin(pi x)`` at ``t = 0``, zero on the spatial faces, at one point."""
    return torch.where(x[0] == 0.0, -torch.sin(torch.pi * x[1]), 0.0)
