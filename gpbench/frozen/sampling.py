"""Collocation points and test grids, frozen for the benchmark.

Copied from ``nonlinpdes_gpsolver_tpu_torch/utils/sampling.py`` at commit
1237319 (``_face_counts``, ``_uniform``, ``sample_random`` for the unit
square, ``test_grid``), so that a later change to the program's sampler
leaves the benchmark's inputs as they are. On the unit square the
original's affine map is the identity, so its host-to-device copies of
the bounds are left out; the draws are the same bits. ``sample_random`` draws from a
``torch.Generator`` on its device: uniform interior points, then per-face
uniform boundary points (bottom, right, top, left; the remainder of
``n_boundary`` over the faces goes to the first ones).
"""

from __future__ import annotations

import numpy as np
import torch


def _face_counts(n: int, faces: int) -> list:
    base, rem = divmod(n, faces)
    return [base + (1 if i < rem else 0) for i in range(faces)]


def _uniform(gen, shape, dtype, device):
    """Uniform on ``[0, 1)`` in float64, then ``dtype`` (the original's
    ``lo + (hi - lo) u`` on the unit square, where it is ``u`` itself)."""
    return torch.rand(shape, generator=gen, dtype=torch.float64, device=device).to(dtype)


def sample_random(gen: torch.Generator, n_domain: int, n_boundary: int, dtype):
    """``(X_domain, X_boundary)`` on the unit square, on ``gen``'s device."""
    device = gen.device
    X_domain = _uniform(gen, (n_domain, 2), dtype, device)
    specs = [(0, 1, 0.0), (1, 0, 1.0), (0, 1, 1.0), (1, 0, 0.0)]
    parts = []
    for (free_ax, fixed_ax, fixed_val), cnt in zip(specs, _face_counts(n_boundary, 4)):
        if cnt == 0:
            continue
        pts = torch.empty((cnt, 2), dtype=dtype, device=device)
        pts[:, free_ax] = _uniform(gen, (cnt,), dtype, device)
        pts[:, fixed_ax] = fixed_val
        parts.append(pts)
    X_boundary = torch.cat(parts) if parts else torch.zeros((0, 2), dtype=dtype, device=device)
    return X_domain, X_boundary


def test_grid(n0: int, n1: int, dtype, device) -> torch.Tensor:
    """The ``n0 x n1`` grid on the unit square, ends included, row-major in x1."""
    xs = np.linspace(0.0, 1.0, n0)
    ys = np.linspace(0.0, 1.0, n1)
    XX, YY = np.meshgrid(xs, ys, indexing="ij")
    return torch.as_tensor(np.stack([XX.ravel(), YY.ravel()], axis=1), dtype=dtype,
                           device=device)


test_grid.__test__ = False
