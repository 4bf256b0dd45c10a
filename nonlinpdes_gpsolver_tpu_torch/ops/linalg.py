"""Dense linear algebra of the main path: guarded Cholesky and SPD solves.

Counterpart of the parts of ``nonlinpdes_gpsolver_tpu/ops/linalg.py`` (and
of the factorization in ``solvers/gn.py``) that the dense solve calls. The
JAX package built its factorizations from ``Precision.HIGHEST`` matmuls
because the TPU's native Cholesky and TRSM ran at bf16-pass precision; on
the card these are cuSOLVER/cuBLAS calls with TF32 off (set when the
package is imported), so only the numerical safeguards carry over:

* the nugget-escalation ladder both paths climb (``MAX_ESCALATIONS``,
  below): the equilibrated factorization, where a rung is accepted only if
  ``cholesky_ex`` reports success and the factor is finite (the
  factorization runs in f64, see :func:`equilibrated_cholesky`), and the
  plain one of ``factorize(equilibrate=False)``
  (:func:`cholesky_with_retry`);
* the Newton refinement of the triangular inverse;
* the ``1 + 32 eps`` floor on the unit diagonal of the equilibrated
  Gauss-Newton normal matrix, and of the small SPD inverse of the mesh
  path's deflation preconditioner (:func:`spd_inverse`);
* the fixed quality probe, cached (:func:`probe_vector`).

The dense factorization's outputs can be written into given storage
(``out``): a problem whose structure matches a released one's factors
into that storage, which its recorded Gauss-Newton loop reads
(``solvers/_reuse.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils import tracing
from .backend import is_accelerator

# The nugget-escalation ladder of both paths (the JAX package's policy): a
# block starts at escalation_start, a factor that fails is made again at
# ESCALATION times its scale, at most MAX_ESCALATIONS times, and a whitening
# verdict passes (accepted) below QUALITY_TOL.
MAX_ESCALATIONS = 8
ESCALATION = 10.0
QUALITY_TOL = 1e-2


def escalation_start(nugget: float, dtype) -> float:
    """``max(1, 4 eps / nugget)``: a nugget below a few ulps of the working
    dtype is no regularization at all."""
    return max(1.0, (4.0 * torch.finfo(dtype).eps) / max(nugget, 1e-300))


def accepted(quality: float, tol: float = QUALITY_TOL) -> bool:
    """Whether a verdict read on the host passes: finite and below ``tol``."""
    return math.isfinite(quality) and quality < tol


def rungs_climbed(scale: float, start: float) -> int:
    """The tenfold escalations from ``start`` to ``scale``."""
    return round(math.log10(scale / start))


_PROBES: Dict[tuple, torch.Tensor] = {}


def probe_vector(n: int, dtype, device) -> torch.Tensor:
    """The JAX package's fixed quality probe (numpy seed 0, ``n`` standard
    normals), cached per ``(n, dtype, device)`` as its ``_PROBE_CACHE``
    caches it, so that a factorization draws and uploads nothing. Callers
    only read it."""
    key = (int(n), dtype, torch.device(device))
    v = _PROBES.get(key)
    if v is None:
        v = torch.as_tensor(np.random.default_rng(0).standard_normal(n), dtype=dtype,
                            device=device)
        _PROBES[key] = v
    return v


def equilibrate(
    theta: torch.Tensor, nug_diag: torch.Tensor, s: float, out: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(M, d_isqrt)``: ``M = D^{-1/2} (theta + s diag(nug)) D^{-1/2}`` in
    f64 with an exact unit diagonal (formed in ``out`` when given), and
    ``d_isqrt = D^{-1/2}`` in ``theta``'s dtype, ``D`` being the diagonal of
    the regularized matrix."""
    d_isqrt = torch.rsqrt(torch.diagonal(theta) + s * nug_diag)
    ds = d_isqrt.to(torch.float64)
    M = theta.to(torch.float64, copy=True) if out is None else out.copy_(theta)
    M.mul_(ds[:, None]).mul_(ds[None, :]).fill_diagonal_(1.0)
    return M, d_isqrt


def equilibrated_cholesky(
    theta: torch.Tensor, nug_diag: torch.Tensor, s0: float,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    work: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, float, int]:
    """Factor ``D^{-1/2} (theta + s diag(nug)) D^{-1/2}`` (unit diagonal).

    ``D`` is the diagonal of the regularized matrix. Starting at ``s = s0``,
    each rung whose factor fails (``info != 0`` or non-finite) retries at
    ``ESCALATION s``, for at most ``MAX_ESCALATIONS`` attempts. Returns
    ``(L, d_isqrt, s, rungs)`` with ``s`` the scale the accepted factor used
    and ``rungs`` the number of escalations it took.

    The factorization itself runs in f64 whatever ``theta``'s dtype, and
    ``L`` comes back in that dtype. This is the port's counterpart of the
    JAX package's precision-controlled factorization. An f32 Cholesky
    breaks down once the smallest eigenvalue of the equilibrated matrix
    falls below about ``eps * ||M||``: on an H100 that forced the
    16,200-row elliptic Gram's nugget up a hundredfold and missed the
    accuracy gate, while its f64 Cholesky, on the card's f64 tensor cores,
    took no longer than the f32 one (PERF.md).

    ``out = (L, d_isqrt)``: the accepted factor and scales are written
    there (no second copy of the factor is made in the working dtype).
    ``work``: an ``(n, n)`` f64 tensor the equilibrated matrix is formed
    in (it may share its bytes with ``out[0]``, written only after the
    factorization).
    """
    s = float(s0)
    for rung in range(MAX_ESCALATIONS):
        M, d_isqrt = equilibrate(theta, nug_diag, s, out=work)
        L, ok = cholesky_f64(M)
        del M
        if tracing.read(bool, ok):
            if out is None:
                return L.to(theta.dtype), d_isqrt, s, rung
            return out[0].copy_(L), out[1].copy_(d_isqrt), s, rung
        del L
        s *= ESCALATION
    raise FloatingPointError(
        f"Cholesky failed after {MAX_ESCALATIONS} nugget escalations from "
        f"{s0:g}x (last scale {s / ESCALATION:g}x)"
    )


def cholesky_with_retry(
    theta: torch.Tensor, nug_diag: torch.Tensor, max_retries: int = 6,
    escalation: float = ESCALATION,
    out: Optional[torch.Tensor] = None, work: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, float]:
    """``(L, s)``: the lower Cholesky factor of ``theta + s diag(nug)``,
    unequilibrated, with ``s`` escalated tenfold from 1 until it succeeds,
    for at most ``max_retries`` attempts (the JAX package's
    ``ops/linalg.py::cholesky_with_retry``, its 6 attempts and its error
    text included).

    The regularized matrix is formed and factored in f64 whatever
    ``theta``'s dtype, as :func:`equilibrated_cholesky` does,
    and ``L`` comes back in that dtype (written into ``out`` where given;
    ``work``: an ``(n, n)`` f64 tensor to form the matrix in)."""
    s = 1.0
    for _ in range(max_retries):
        M = theta.to(torch.float64, copy=True) if work is None else work.copy_(theta)
        M.diagonal().add_(s * nug_diag.to(torch.float64))
        L, ok = cholesky_f64(M)
        del M
        if tracing.read(bool, ok):
            return (L.to(theta.dtype) if out is None else out.copy_(L)), s
        del L
        s *= escalation
    raise FloatingPointError(
        f"Cholesky failed after {max_retries} nugget escalations "
        f"(final scale {s / escalation:g}); Gram matrix is numerically "
        "indefinite - increase the nugget or the kernel lengthscale."
    )


def cholesky_f64(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(L, ok)``: the lower Cholesky factor of the SPD matrix ``M``,
    computed and returned in f64, and whether it is usable (``cholesky_ex``
    reported success and the factor is finite), a device bool tensor (no
    host read; the caller reads it where it decides control flow).

    The one Cholesky of the Gram matrices on both paths: the dense
    factorization and each superblock diagonal of the mesh path's fused
    factorization share it, so that the two paths round alike (see
    :func:`equilibrated_cholesky` for why it is f64).
    """
    L, info = torch.linalg.cholesky_ex(M.to(torch.float64))
    return L, (info == 0) & torch.isfinite(L).all()


def whiten(L: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``L^{-1} v`` by forward substitution (``v`` a vector or columns)."""
    if v.dim() == 1:
        return torch.linalg.solve_triangular(L, v[:, None], upper=False)[:, 0]
    return torch.linalg.solve_triangular(L, v, upper=False)


def kernel_solve(L: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``L^{-T} L^{-1} v`` by two triangular solves."""
    col = v[:, None] if v.dim() == 1 else v
    y = torch.linalg.solve_triangular(L, col, upper=False)
    y = torch.linalg.solve_triangular(L.T, y, upper=True)
    return y[:, 0] if v.dim() == 1 else y


def tri_inverse(L: torch.Tensor) -> torch.Tensor:
    """Explicit ``L^{-1}`` (lower triangular; or of each matrix of a batch)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand_as(L)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def newton_refine_tri_inverse(
    L: torch.Tensor, W: torch.Tensor, steps: int = 1
) -> torch.Tensor:
    """Newton iteration on the left inverse, in place in ``W``:
    ``W <- W + (I - W L) W``.

    Each step squares the residual ``E = I - W L``. A raw f32 triangular
    inverse of these ill-conditioned equilibrated Gram factors carries
    ``||W L - I||`` around 1e-2 and one step brings it to about 1e-4; the
    JAX package measured the step moving the canonical solve's test L2 from
    9.5e-3 to 2.3e-3 on its accelerator. This is the dense two-matmul form
    (of each matrix of a batch, for a batch), with two temporaries the size
    of ``W``: ``E`` is formed from ``W L`` (negated, its diagonal raised by
    one: the same values as ``I - W L``), then ``W += E W``.
    """
    for _ in range(steps):
        E = W @ L
        E.neg_()
        E.diagonal(dim1=-2, dim2=-1).add_(1.0)
        W.add_(E @ W)
        del E
    return W


def spd_solve(H: torch.Tensor, g: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Solve the SPD Gauss-Newton system ``H x = g``.

    Plain Cholesky on the CPU; :func:`spd_solve_controlled` on the card.
    Where the factorization fails the result is NaN, as the JAX package's
    Cholesky gives it, so that the caller's non-finite guard rejects the
    step.
    """
    if jitter:
        H = H + jitter * torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    if not is_accelerator(H.device):
        L, info = torch.linalg.cholesky_ex(H)
        x = kernel_solve(L, g)
        return torch.where(info == 0, x, torch.full_like(x, float("nan")))
    return spd_solve_controlled(H, g)


def spd_inverse(H: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of a small SPD matrix, as ``ops/linalg.py::spd_inverse``
    of the JAX package: ``D^{-1/2} W^T W D^{-1/2}`` with ``W`` the inverse
    Cholesky factor of the equilibrated matrix, its unit diagonal floored at
    ``1 + 32 eps`` (of ``H``'s dtype). It serves the (r, r) projected
    operators of the mesh path's deflation preconditioner, applied every CG
    iteration. The factorization and inverse run in f64 (r <= 768: no
    measurable cost) and the result comes back in ``H``'s dtype; where the
    factorization fails the result is NaN, which the caller's guards reject.
    """
    d_isqrt = torch.rsqrt(torch.clamp(torch.diagonal(H), min=torch.finfo(H.dtype).tiny))
    Hs = (H * (d_isqrt[:, None] * d_isqrt[None, :])).to(torch.float64)
    Hs.fill_diagonal_(1.0 + 32.0 * torch.finfo(H.dtype).eps)
    L, info = torch.linalg.cholesky_ex(Hs)
    W = tri_inverse(L)
    inv = (W.T @ W).to(H.dtype) * (d_isqrt[:, None] * d_isqrt[None, :])
    return torch.where(info == 0, inv, torch.full_like(inv, float("nan")))


def spd_solve_controlled(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Equilibrated SPD solve with a ``32 eps`` floor on the unit diagonal.

    The Gauss-Newton normal matrix has cond(J)^2, which at large N passes
    what f32 can represent; without the floor the factorization fails and
    every step is rejected. The relative bias on a well-conditioned system
    is O(32 eps). If the factorization still fails, the result is NaN, so
    the caller's non-finite guard rejects the step (no host sync here).
    """
    d = torch.diagonal(H)
    d_isqrt = torch.rsqrt(torch.clamp(d, min=torch.finfo(H.dtype).tiny))
    Hs = H * (d_isqrt[:, None] * d_isqrt[None, :])
    Hs.fill_diagonal_(1.0 + 32.0 * torch.finfo(H.dtype).eps)
    L, info = torch.linalg.cholesky_ex(Hs)
    col = (d_isqrt * g)[:, None]
    x = d_isqrt * torch.cholesky_solve(col, L, upper=False)[:, 0]
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))
