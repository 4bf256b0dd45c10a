"""Collocation-point sampling on rectangular (space or time-space) domains.

Counterpart of ``nonlinpdes_gpsolver_tpu/utils/sampling.py``, on a
``torch.Generator`` instead of ``jax.random`` (so the draws differ from the
JAX package's for the same seed; parity tests pass the same points to
both). ``N_boundary`` is honoured exactly: the remainder after dividing the
points across faces goes to the first faces.

* ``time_dependent=False``: domain ``[a0,b0] x [a1,b1]``, boundary = all four
  faces.
* ``time_dependent=True``: coordinates are ``(t, x)``; the boundary is the
  initial-time face ``t=a0`` plus the spatial faces ``x=a1`` and ``x=b1``.

Every function returns tensors on CUDA unless given ``device="cpu"`` (the
sampler: a generator on the CPU), in the device's default dtype.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.backend import default_dtype, resolve_device


def _face_counts(n: int, faces: int) -> list[int]:
    base, rem = divmod(n, faces)
    return [base + (1 if i < rem else 0) for i in range(faces)]


def _uniform(gen, shape, lo, hi, dtype, device):
    u = torch.rand(shape, generator=gen, dtype=torch.float64, device=device)
    lo = torch.as_tensor(lo, dtype=torch.float64, device=device)
    hi = torch.as_tensor(hi, dtype=torch.float64, device=device)
    return (lo + (hi - lo) * u).to(dtype)


def sample_random(
    generator: torch.Generator,
    N_domain: int,
    N_boundary: int,
    domain=((0.0, 1.0), (0.0, 1.0)),
    time_dependent: bool = False,
    dtype: torch.dtype | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform interior points + per-face uniform boundary points, drawn from
    ``generator`` on its device."""
    device = generator.device
    dtype = dtype or default_dtype(device)
    (a0, b0), (a1, b1) = domain
    X_domain = _uniform(generator, (N_domain, 2), [a0, a1], [b0, b1], dtype, device)
    if not time_dependent:
        # faces: bottom (x2=a1), right (x1=b0), top (x2=b1), left (x1=a0)
        specs = [
            (0, (a0, b0), 1, a1),
            (1, (a1, b1), 0, b0),
            (0, (a0, b0), 1, b1),
            (1, (a1, b1), 0, a0),
        ]
    else:
        # faces: initial time (t=a0), x=b1, x=a1
        specs = [
            (1, (a1, b1), 0, a0),
            (0, (a0, b0), 1, b1),
            (0, (a0, b0), 1, a1),
        ]
    parts = []
    for (free_ax, (lo, hi), fixed_ax, fixed_val), cnt in zip(
        specs, _face_counts(N_boundary, len(specs))
    ):
        if cnt == 0:
            continue
        pts = torch.empty((cnt, 2), dtype=dtype, device=device)
        pts[:, free_ax] = _uniform(generator, (cnt,), lo, hi, dtype, device)
        pts[:, fixed_ax] = fixed_val
        parts.append(pts)
    X_boundary = (
        torch.cat(parts) if parts else torch.zeros((0, 2), dtype=dtype, device=device)
    )
    return X_domain, X_boundary


def sample_grid(
    N_domain: int,
    N_boundary: int,
    domain=((0.0, 1.0), (0.0, 1.0)),
    time_dependent: bool = False,
    device=None,
    dtype: torch.dtype | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform tensor-grid interior + boundary points; the grid resolution
    makes interior + boundary total about ``N_domain + N_boundary``."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    (a0, b0), (a1, b1) = domain
    n = int(np.sqrt(N_domain + N_boundary)) - 2
    xs = np.linspace(a0, b0, n + 2)
    ys = np.linspace(a1, b1, n + 2)
    XX, YY = np.meshgrid(xs, ys, indexing="ij")
    mask = np.zeros_like(XX, dtype=bool)
    if not time_dependent:
        interior = np.stack([XX[1:-1, 1:-1].ravel(), YY[1:-1, 1:-1].ravel()], axis=1)
        mask[0, :] = mask[-1, :] = mask[:, 0] = mask[:, -1] = True
    else:
        # (t, x): interior includes the final-time face; boundary = t=a0 and
        # x = a1 / b1 faces.
        interior = np.stack([XX[1:, 1:-1].ravel(), YY[1:, 1:-1].ravel()], axis=1)
        mask[0, :] = True
        mask[:, 0] = mask[:, -1] = True
    boundary = np.stack([XX[mask], YY[mask]], axis=1)
    return (
        torch.as_tensor(interior, dtype=dtype, device=device),
        torch.as_tensor(boundary, dtype=dtype, device=device),
    )


def test_grid(
    n0: int,
    n1: int,
    domain=((0.0, 1.0), (0.0, 1.0)),
    endpoint: bool = True,
    device=None,
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Dense evaluation grid (n0*n1, 2) for posterior testing/plotting."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    (a0, b0), (a1, b1) = domain
    xs = np.linspace(a0, b0, n0, endpoint=endpoint)
    ys = np.linspace(a1, b1, n1, endpoint=endpoint)
    XX, YY = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([XX.ravel(), YY.ravel()], axis=1)
    return torch.as_tensor(pts, dtype=dtype, device=device)


test_grid.__test__ = False  # a grid builder, not a test, for pytest
