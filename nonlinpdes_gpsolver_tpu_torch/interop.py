"""Carry a problem's state across from the JAX package.

The solver has no trained weights: a problem's state is its arrays (the
collocation points, the right-hand side ``f`` and boundary values ``g``,
the initial latent ``z0``) and the kernel's ``inv_sq``. The JAX package
and the port draw random numbers differently, so a run that has to match
the JAX package takes these arrays from it as numpy arrays.

``data/elliptic_n900_inputs.npz`` holds the JAX package's canonical draw
(N_domain=900, N_boundary=124 from ``sample_random(PRNGKey(0), ...)``, the
``seed=1`` initial latent, and ``f``/``g`` of the manufactured solution of
``bench.py``), made on the CPU in float64.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Sequence

import numpy as np
import torch

from .models.elliptic import nonlinear_elliptic
from .models.spec import CollocationProblem
from .ops.backend import default_dtype, resolve_device
from .ops.kernels import SquaredExponential

CANONICAL_INPUTS = Path(__file__).resolve().parent / "data" / "elliptic_n900_inputs.npz"


def load_canonical_inputs() -> Dict[str, np.ndarray]:
    """The canonical N=900 draw: X_domain, X_boundary, f, g, z0, inv_sq."""
    with np.load(CANONICAL_INPUTS) as npz:
        return {k: npz[k] for k in npz.files}


def problem_from_numpy(
    X_domain: np.ndarray,
    X_boundary: np.ndarray,
    f: np.ndarray,
    g: np.ndarray,
    z0: np.ndarray,
    inv_sq: Sequence[float],
    device=None,
    dtype: torch.dtype | None = None,
    alpha: float = 1.0,
    m: int = 3,
) -> CollocationProblem:
    """The elimination-form nonlinear elliptic problem on these arrays.

    Built on ``device`` (CUDA unless ``device="cpu"``) in ``dtype`` (the
    device's default: f32 on the card, f64 on the CPU); its initial latent
    is ``z0``.
    """
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)

    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float64), dtype=dtype, device=device)

    prob = nonlinear_elliptic(
        SquaredExponential(tuple(float(a) for a in np.asarray(inv_sq).ravel())),
        t(X_domain), t(X_boundary), t(f), t(g), alpha=alpha, m=m,
    )
    z0 = t(z0)
    return dataclasses.replace(prob, latent_init=lambda: z0)
