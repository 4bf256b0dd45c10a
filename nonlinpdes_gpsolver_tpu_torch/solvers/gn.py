"""Whitened Gauss-Newton on the dense single-device path.

Counterpart of the main-path part of ``nonlinpdes_gpsolver_tpu/solvers/gn.py``:

* :func:`factorize` assembles each GP block's Gram matrix with the
  trace-adaptive nugget and factors its equilibrated form, escalating the
  nugget until the factor is finite and, with ``solve_mode='inverse'``,
  until the whitening operator passes the quality probe;
* :func:`gn_solve` stacks the whitened block residuals ``L_b^{-1} F_b(z)``
  and the weighted misfits into ``r(z)``, and solves ``(J^T J) delta = J^T r``
  at each step, with the ``'structured'`` or the ``'direct'`` Jacobian.

The JAX package runs the loop as one compiled ``lax.scan``/``while_loop``;
here it is a Python loop over eager tensor ops. A step that would make the
iterate non-finite is rejected (z kept) without a host sync; only the
``tol`` plateau test reads the loss on the host. Quality checks run
eagerly during factorization.

``solve_mode='auto'`` is ``'inverse'`` (explicit whitening operator,
refined by one Newton step) on the card and ``'trsm'`` (triangular solves)
on the CPU, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..models.spec import CollocationProblem
from ..ops.assembly import adaptive_nugget_diag, gram_matrix, observable_sizes
from ..ops.backend import is_accelerator
from ..ops.linalg import (
    MAX_ESCALATIONS,
    equilibrated_cholesky,
    kernel_solve,
    newton_refine_tri_inverse,
    spd_solve,
    tri_inverse,
    whiten,
)

# Whitening-quality acceptance threshold of the JAX package.
QUALITY_TOL = 1e-2


@dataclasses.dataclass(frozen=True)
class FactoredProblem:
    """A problem plus factorizations of its regularized Gram matrices.

    ``factors[name]`` is the lower Cholesky factor of the equilibrated
    regularized Gram matrix ``D^{-1/2} (Theta + nugget) D^{-1/2}``, with
    ``col_scales[name] = d^{-1/2}``. ``inv_factors[name]`` holds the
    whitening operator ``L~^{-1} D^{-1/2}`` when ``solve_mode='inverse'``.
    ``nugget_scales[name]`` is the escalation factor the accepted factor
    used, and ``rungs[name]`` the number of tenfold escalations it took.
    """

    problem: CollocationProblem
    factors: Dict[str, torch.Tensor]
    inv_factors: Dict[str, torch.Tensor]
    nugget_scales: Dict[str, float]
    col_scales: Dict[str, torch.Tensor]
    rungs: Dict[str, int]

    def whiten(self, name: str, v: torch.Tensor) -> torch.Tensor:
        if name in self.inv_factors:
            return self.inv_factors[name] @ v
        s = self.col_scales[name]
        return whiten(self.factors[name], v * (s if v.dim() == 1 else s[:, None]))

    def kernel_solve(self, name: str, v: torch.Tensor) -> torch.Tensor:
        """``Theta^{-1} v`` through the equilibrated factor."""
        if name in self.inv_factors:
            W = self.inv_factors[name]
            return W.T @ (W @ v)
        s = self.col_scales[name]
        s = s if v.dim() == 1 else s[:, None]
        return s * kernel_solve(self.factors[name], v * s)

    def whitened_residual(self, z: torch.Tensor) -> torch.Tensor:
        p = self.problem
        parts = [self.whiten(b.name, b.residual(z, p.data)) for b in p.blocks]
        for m in p.misfits:
            parts.append(math.sqrt(m.weight) * m.residual(z, p.data))
        return torch.cat(parts)

    def loss(self, z: torch.Tensor) -> torch.Tensor:
        r = self.whitened_residual(z)
        return torch.dot(r, r)


class GNState(NamedTuple):
    z: torch.Tensor
    losses: torch.Tensor  # loss history, one entry per iteration (post-step)
    converged_finite: torch.Tensor  # False if any step was rejected as non-finite


def _probe_vec(n: int, dtype, device) -> torch.Tensor:
    """The JAX package's fixed whitening-quality probe (numpy seed 0)."""
    v = np.random.default_rng(0).standard_normal(n)
    return torch.as_tensor(v, dtype=dtype, device=device)


def _whiten_quality(inv, L, d_isqrt, v) -> float:
    """Relative whitening residual ``max|W(Lv) - v| / max|v|``."""
    w = inv @ ((L @ v) / d_isqrt)
    return float(torch.max(torch.abs(w - v)) / torch.max(torch.abs(v)))


def factorize(
    problem: CollocationProblem,
    nugget: float,
    nugget_type: str = "adaptive",
    solve_mode: str = "auto",
) -> FactoredProblem:
    """Assemble + regularize + factor every GP block's Gram matrix.

    Runs on the problem's device and dtype. The escalation starts at the
    dtype-aware scale ``s0 = max(1, 4 eps / nugget)``: a nugget below a few
    ulps of the working dtype is no regularization at all. With
    ``solve_mode='inverse'`` each accepted factor is inverted (plus one
    Newton step on the card), and a factor whose whitening residual on a
    fixed probe is not below ``QUALITY_TOL`` is escalated tenfold again.
    """
    device, dtype = problem.device, problem.dtype
    on_accelerator = is_accelerator(device)
    if solve_mode == "auto":
        solve_mode = "inverse" if on_accelerator else "trsm"
    if solve_mode not in ("inverse", "trsm"):
        raise ValueError(f"unknown solve_mode {solve_mode!r}")
    factors, inv_factors, scales, col_scales, rungs = {}, {}, {}, {}, {}
    eps = torch.finfo(dtype).eps
    for b in problem.blocks:
        theta = gram_matrix(b.kernel, b.observables, problem.points)
        sizes = observable_sizes(b.observables, problem.points)
        nug = adaptive_nugget_diag(theta, b.observables, sizes, nugget, nugget_type)
        s0 = max(1.0, (4.0 * eps) / max(nugget, 1e-300))
        s, total_rungs = s0, 0
        for _ in range(MAX_ESCALATIONS):
            L, d_isqrt, s, r = equilibrated_cholesky(theta, nug, s)
            total_rungs += r
            if solve_mode == "trsm":
                break
            inv = tri_inverse(L)
            if on_accelerator:
                inv = newton_refine_tri_inverse(L, inv)
            inv = inv * d_isqrt[None, :]
            q = _whiten_quality(inv, L, d_isqrt, _probe_vec(L.shape[0], dtype, device))
            if math.isfinite(q) and q < QUALITY_TOL:
                inv_factors[b.name] = inv
                break
            s *= 10.0  # finite but corrupted factor: escalate anyway
            total_rungs += 1
        else:
            raise FloatingPointError(
                f"block {b.name!r}: factor quality still bad after nugget "
                f"escalation to {s:g}x"
            )
        del theta
        factors[b.name] = L
        col_scales[b.name] = d_isqrt
        scales[b.name] = s
        rungs[b.name] = total_rungs
    return FactoredProblem(problem, factors, inv_factors, scales, col_scales, rungs)


def _slice_structure(problem: CollocationProblem):
    """Metadata for the structured Jacobian, or ``None``.

    The latent vector is ``s`` slices of length ``N`` (the interior point
    count) and every residual row depends only on latent entries at the
    same point; then the raw Jacobian is a stack of diagonals and the
    whitened panel ``J = W J_r`` is a sum of column-scaled slabs of ``W``.
    """
    pts = problem.points.get("domain")
    if pts is None:
        return None
    N = int(pts.shape[0])
    if N == 0 or problem.latent_dim % N:
        return None
    s = problem.latent_dim // N
    seginfo = []
    for b in problem.blocks:
        segs, off = [], 0
        for sz in observable_sizes(b.observables, problem.points):
            segs.append((off, int(sz)))
            off += int(sz)
        seginfo.append(tuple(segs))
    return s, N, tuple(seginfo)


def _block_diagonals(residual, data, z, s, N):
    """Per-slice diagonals ``D_j`` of the raw residual Jacobian, from ``s``
    slice-indicator JVPs (exact when the structure holds)."""
    outs = []
    for j in range(s):
        e = torch.zeros_like(z)
        e[j * N : (j + 1) * N] = 1.0
        outs.append(torch.func.jvp(lambda zz: residual(zz, data), (z,), (e,))[1])
    return outs


def validate_slice_structure(
    problem: CollocationProblem, structure, probes: int = 2
) -> bool:
    """Check the pointwise-slice structure on random tangents (one host sync).

    For random tangents ``v`` the structured prediction
    ``sum_j D_j[rows] * v[slice j]`` (zero on non-interior rows) must match
    the true JVP of the raw residuals.
    """
    p = problem
    s, N, seginfo = structure
    rng = np.random.default_rng(0)
    kw = dict(dtype=p.dtype, device=p.device)
    z = torch.as_tensor(rng.standard_normal(p.latent_dim), **kw)
    worst = torch.zeros((), **kw)
    for b, segs in zip(p.blocks, seginfo):
        f = lambda zz, _b=b: _b.residual(zz, p.data)  # noqa: E731
        D = _block_diagonals(b.residual, p.data, z, s, N)
        for _ in range(probes):
            v = torch.as_tensor(rng.standard_normal(p.latent_dim), **kw)
            actual = torch.func.jvp(f, (z,), (v,))[1]
            pred = torch.zeros_like(actual)
            for off, sz in segs:
                if sz != N:
                    continue
                pred[off : off + sz] = sum(
                    D[j][off : off + sz] * v[j * N : (j + 1) * N] for j in range(s)
                )
            scale = torch.max(torch.abs(actual)) + 1.0
            worst = torch.maximum(worst, torch.max(torch.abs(actual - pred)) / scale)
    return bool(worst < 1e-4)


def _structured_jacobian(fp: FactoredProblem, z, structure):
    """Whitened Jacobian panel from column slabs of the whitening operators;
    misfit rows come from a dense (small) ``jacfwd``."""
    p = fp.problem
    s, N, seginfo = structure
    parts = []
    for b, segs in zip(p.blocks, seginfo):
        D = _block_diagonals(b.residual, p.data, z, s, N)
        W = fp.inv_factors[b.name]
        cols = []
        for j in range(s):
            acc = None
            for off, sz in segs:
                if sz != N:
                    continue
                term = W[:, off : off + sz] * D[j][off : off + sz][None, :]
                acc = term if acc is None else acc + term
            cols.append(acc)
        parts.append(torch.cat(cols, dim=1))
    parts.extend(_misfit_jacobians(p, z))
    return torch.cat(parts, dim=0)


def _misfit_jacobians(p: CollocationProblem, z):
    return [
        math.sqrt(m.weight)
        * torch.func.jacfwd(lambda zz, _m=m: _m.residual(zz, p.data))(z)
        for m in p.misfits
    ]


def _direct_jacobian(fp: FactoredProblem, z):
    """Whitened Jacobian panel: the raw residual Jacobian (``jacfwd``) pushed
    through each block's whitening (linear, so it commutes)."""
    p = fp.problem
    parts = [
        fp.whiten(b.name, torch.func.jacfwd(lambda zz, _b=b: _b.residual(zz, p.data))(z))
        for b in p.blocks
    ]
    parts.extend(_misfit_jacobians(p, z))
    return torch.cat(parts, dim=0)


def gn_solve(
    fp: FactoredProblem,
    z0: torch.Tensor | None = None,
    max_iter: int = 8,
    step_size: float = 1.0,
    hessian_jitter: float = 0.0,
    step_solver: str = "auto",
    tol: float | None = None,
) -> GNState:
    """Run up to ``max_iter`` Gauss-Newton steps.

    Each step linearizes the whitened residual at ``z``, solves the normal
    system, and updates ``z <- z - step_size * delta``; a step producing a
    non-finite iterate is rejected and ``z`` kept.

    ``tol``: stop as soon as ``|loss_prev - loss| <= tol * loss`` (after at
    least two steps), or when a step was rejected; untaken iterations repeat
    the last loss in the history.

    ``step_solver``: ``'structured'`` (the whitened panel from column slabs
    of the whitening operator; needs ``solve_mode='inverse'`` factors and
    pointwise-per-slice residuals), ``'direct'`` (the full Jacobian panel),
    or ``'auto'``: ``'structured'`` where it applies, else ``'direct'``.
    The Krylov steps ``'cg'`` and ``'woodbury'`` are not ported yet.
    """
    p = fp.problem
    z = (p.init_latent() if z0 is None else torch.as_tensor(z0)).to(
        device=p.device, dtype=p.dtype
    )
    if step_solver in ("cg", "woodbury"):
        raise NotImplementedError(
            f"step_solver={step_solver!r} is not ported yet (slice 2 of the port)"
        )
    if step_solver not in ("auto", "structured", "direct"):
        raise ValueError(f"unknown step_solver {step_solver!r}")
    structure = None
    if step_solver in ("auto", "structured"):
        cand = _slice_structure(p)
        valid = (
            cand is not None
            and all(b.name in fp.inv_factors for b in p.blocks)
            and validate_slice_structure(p, cand)
        )
        if step_solver == "structured" and not valid:
            raise ValueError(
                "step_solver='structured' requires solve_mode='inverse' "
                "factors and pointwise-per-slice residuals (structure "
                "validation failed for this problem)"
            )
        structure = cand if valid else None

    def delta(z):
        J = _direct_jacobian(fp, z) if structure is None else _structured_jacobian(fp, z, structure)
        return spd_solve(J.T @ J, J.T @ fp.whitened_residual(z), jitter=hessian_jitter)

    ok = torch.ones((), dtype=torch.bool, device=p.device)
    losses = []
    prev = cur = math.inf
    for i in range(int(max_iter)):
        if tol is not None and i >= 2:
            if abs(prev - cur) <= tol * max(cur, torch.finfo(p.dtype).tiny):
                break
        z_new = z - step_size * delta(z)
        finite = torch.isfinite(z_new).all()
        z = torch.where(finite, z_new, z)
        ok = ok & finite
        losses.append(fp.loss(z))
        if tol is not None:
            prev, cur = cur, float(losses[-1])
            if not bool(ok):
                break
    losses = torch.stack(losses) if losses else torch.zeros(0, dtype=p.dtype, device=p.device)
    if losses.shape[0] < max_iter:
        pad = losses[-1:].expand(int(max_iter) - losses.shape[0])
        losses = torch.cat([losses, pad])
    return GNState(z=z, losses=losses, converged_finite=ok)
