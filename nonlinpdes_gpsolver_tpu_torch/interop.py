"""Carry a problem's state across from the JAX package.

The solver has no trained weights: a problem's state is its arrays (the
collocation points, the right-hand side ``f`` and boundary values ``g``,
the initial latent ``z0``, Darcy's observations) and the kernel's
``inv_sq``. The JAX package and the port draw random numbers differently,
so a run that has to solve the JAX package's exact problem takes these
arrays from it as numpy arrays.

``data/`` holds the JAX package's draws for the reference workloads of
``examples/bench_workloads.py``, made on the CPU in float64 (each file also
holds the model's scalars as 0-d arrays):

* ``elliptic_n900_inputs.npz``: N_domain=900, N_boundary=124 from
  ``sample_random(PRNGKey(0), ...)``, the ``seed=1`` latent, ``f``/``g`` of
  the manufactured solution of ``bench.py``;
* ``burgers_n1000_inputs.npz``: 1000/200 on ``(t, x) in [0,1]x[-1,1]`` from
  ``PRNGKey(0)``, the ``seed=3`` latent, the anisotropic [0.3, 0.05] kernel;
* ``eikonal_n1000_inputs.npz``: 1000/200 from ``PRNGKey(1)``, ``f = 1``,
  zero latent;
* ``darcy_n400_inputs.npz``: 400/100 from ``PRNGKey(5)``, the 60 noisy
  observations (80x80 FD solve, ``default_rng(9999)`` noise of 1e-3) and
  the ``seed=7`` latent;
* ``{burgers,eikonal,darcy}_notebook_*_inputs.npz``: the draws of the JAX
  package's demo notebooks (``notebooks/``), which the port's notebooks
  solve: Burgers 1000/200 from ``PRNGKey(2)`` with the precision-convention
  kernel [3, 20] and the ``seed=0`` latent; Eikonal 1000/200 from
  ``PRNGKey(0)``; Darcy 400/100 from ``PRNGKey(9999)``, 60 observations
  with ``default_rng(9999)`` noise and the ``seed=9999`` latent. The
  elliptic notebook's draw is ``elliptic_n900_inputs.npz``.

``PYTHONPATH=. python tests/test_torch_workloads.py`` writes them again from the JAX
package; the tests hold the saved files to a fresh draw.

A factorization is state too: :func:`factor_from_numpy` takes the JAX
package's mesh-path factor (a ``BlockCyclicFactor``'s arrays as numpy, and
its column scales) and returns the port's, dealt to the ranks of the
port's mesh, so that the port's Gauss-Newton steps and posterior can run on
a factor the JAX package computed.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Sequence

import numpy as np
import torch

from .models.burgers import burgers
from .models.darcy import darcy_flow
from .models.eikonal import eikonal
from .models.elliptic import nonlinear_elliptic
from .models.spec import CollocationProblem
from .ops.backend import default_dtype, resolve_device
from .ops.kernels import SquaredExponential
from .parallel.cholesky import BlockCyclicFactor, deal_saved_blocks
from .parallel.mesh import Mesh, make_mesh

DATA = Path(__file__).resolve().parent / "data"
INPUT_FILES = {
    "elliptic": DATA / "elliptic_n900_inputs.npz",
    "burgers": DATA / "burgers_n1000_inputs.npz",
    "eikonal": DATA / "eikonal_n1000_inputs.npz",
    "darcy": DATA / "darcy_n400_inputs.npz",
    "burgers_notebook": DATA / "burgers_notebook_n1000_inputs.npz",
    "eikonal_notebook": DATA / "eikonal_notebook_n1000_inputs.npz",
    "darcy_notebook": DATA / "darcy_notebook_n400_inputs.npz",
}


def load_inputs(workload: str) -> Dict[str, np.ndarray]:
    """One workload's saved draw: the keyword arguments of its constructor below."""
    with np.load(INPUT_FILES[workload]) as npz:
        return {k: npz[k] for k in npz.files}


def load_canonical_inputs() -> Dict[str, np.ndarray]:
    """The canonical N=900 draw: X_domain, X_boundary, f, g, z0, inv_sq."""
    return load_inputs("elliptic")


def _converter(device, dtype):
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)

    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float64), dtype=dtype, device=device)

    return t


def _kernel(inv_sq) -> SquaredExponential:
    return SquaredExponential(tuple(float(a) for a in np.asarray(inv_sq).ravel()))


def _starting_at(prob: CollocationProblem, z0: torch.Tensor) -> CollocationProblem:
    return dataclasses.replace(prob, latent_init=lambda: z0)


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
    is ``z0``. The constructors below follow the same rules.
    """
    t = _converter(device, dtype)
    prob = nonlinear_elliptic(
        _kernel(inv_sq), t(X_domain), t(X_boundary), t(f), t(g),
        alpha=float(alpha), m=int(m),
    )
    return _starting_at(prob, t(z0))


def burgers_from_numpy(X_domain, X_boundary, f, g, z0, inv_sq, alpha=1.0, nu=0.02,
                       device=None, dtype=None) -> CollocationProblem:
    """The Burgers problem on these arrays (``X`` in ``(t, x)`` order)."""
    t = _converter(device, dtype)
    prob = burgers(
        _kernel(inv_sq), t(X_domain), t(X_boundary), t(g), t(f),
        alpha=float(alpha), nu=float(nu),
    )
    return _starting_at(prob, t(z0))


def eikonal_from_numpy(X_domain, X_boundary, f, g, z0, inv_sq, eps=0.1,
                       device=None, dtype=None) -> CollocationProblem:
    """The regularized Eikonal problem on these arrays."""
    t = _converter(device, dtype)
    prob = eikonal(_kernel(inv_sq), t(X_domain), t(X_boundary), t(f), t(g), eps=float(eps))
    return _starting_at(prob, t(z0))


def factor_from_numpy(local: np.ndarray, diag_inv: np.ndarray, block: int, n: int, n_pad: int,
                      d_isqrt: np.ndarray, n_devices: int = 1, mesh: Mesh | None = None,
                      dtype: torch.dtype | None = None):
    """``(factor, col_scales)``: this rank's :class:`~.parallel.cholesky.
    BlockCyclicFactor` and ``d^{-1/2}`` from the JAX package's factor.

    ``local`` is the JAX factor's global ``(nb, B, n_pad)`` array as numpy,
    in the block-cyclic order of the ``n_devices``-device mesh it was
    computed on (device p's slots at ``p nbl .. (p + 1) nbl``), put back in
    natural row order here and dealt to the ranks of ``mesh``: rank p takes
    global blocks ``p, p + P, ...`` (the same slots, when the two meshes have
    the same size). ``diag_inv`` holds its ``(nb, B, B)`` diagonal-block
    inverses and ``d_isqrt`` the column scales returned with it, both
    replicated. The factor lands on ``mesh`` (default: a one-device mesh on
    the card) in ``dtype`` (the device's default).
    """
    mesh = make_mesh(1) if mesh is None else mesh
    t = _converter(mesh.device, dtype)
    nb = local.shape[0]
    if local.shape != (nb, block, n_pad) or nb * block != n_pad or diag_inv.shape != (nb, block, block):
        raise ValueError(f"local {local.shape} and diag_inv {diag_inv.shape} do not match "
                         f"block {block}, n_pad {n_pad}")
    mine = deal_saved_blocks(local, n_devices, mesh)
    factor = BlockCyclicFactor(t(mine), mesh, mesh.axis, int(block), int(n), int(n_pad),
                               t(diag_inv))
    return factor, t(d_isqrt)


def darcy_from_numpy(X_domain, X_boundary, f, g, obs, z0, inv_sq, noise_level=1e-3,
                     device=None, dtype=None) -> CollocationProblem:
    """The Darcy inverse problem on these arrays; both GP blocks use the
    kernel of ``inv_sq``, and ``obs`` observes ``u`` at ``X_domain[:len(obs)]``."""
    t = _converter(device, dtype)
    k = _kernel(inv_sq)
    prob = darcy_flow(
        k, k, t(X_domain), t(X_boundary), t(obs), t(f), t(g),
        noise_level=float(noise_level),
    )
    return _starting_at(prob, t(z0))
