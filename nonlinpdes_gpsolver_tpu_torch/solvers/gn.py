"""Whitened Gauss-Newton on the dense single-device path.

Counterpart of the main-path part of ``nonlinpdes_gpsolver_tpu/solvers/gn.py``:

* :func:`factorize` assembles each GP block's Gram matrix with the
  trace-adaptive nugget and factors its equilibrated form, escalating the
  nugget until the factor is finite and, with ``solve_mode='inverse'``,
  until the whitening operator passes the quality probe;
* :func:`gn_solve` stacks the whitened block residuals ``L_b^{-1} F_b(z)``
  and the weighted misfits into ``r(z)``, and solves ``(J^T J) delta = J^T r``
  at each step: with the ``'structured'`` or the ``'direct'`` Jacobian
  panel, or matrix-free by conjugate gradients (``'cg'``, and
  ``'woodbury'`` for misfit-coupled problems).

The JAX package runs the loop as one compiled ``lax.scan``/``while_loop``;
here it is a Python loop over eager tensor ops. A step that would make the
iterate non-finite is rejected (z kept) without a host sync; only the
``tol`` plateau test reads the loss on the host. The Krylov steps' CG loop
reads one boolean on the host per iteration (its exit test), where the JAX
package's ``while_loop`` keeps it on the device. Quality checks run eagerly
during factorization.

``solve_mode='auto'`` is ``'inverse'`` (explicit whitening operator,
refined by one Newton step) on the card and ``'trsm'`` (triangular solves)
on the CPU, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
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

    def whitened_residual(self, z: torch.Tensor, misfits: bool = True) -> torch.Tensor:
        """``r(z)``: the whitened block residuals, then (with ``misfits``)
        the square-root-weighted misfit residuals."""
        p = self.problem
        parts = [self.whiten(b.name, b.residual(z, p.data)) for b in p.blocks]
        if misfits:
            parts += [math.sqrt(m.weight) * m.residual(z, p.data) for m in p.misfits]
        return torch.cat(parts)

    def loss(self, z: torch.Tensor) -> torch.Tensor:
        r = self.whitened_residual(z)
        return torch.dot(r, r)


class GNState(NamedTuple):
    z: torch.Tensor
    losses: torch.Tensor  # loss history, one entry per iteration (post-step)
    converged_finite: torch.Tensor  # False if any step was rejected as non-finite
    # inner CG iterations per GN step (a CPU int64 tensor): zeros for the
    # exact steps and for untaken iterations; == cg_maxiter means the inner
    # solve stopped at its cap before reaching cg_tol
    cg_iters: torch.Tensor
    # the step solver that ``step_solver`` (``'auto'`` included) resolved to,
    # and the width of the spectral-deflation basis it used (0: none)
    step_solver: str = ""
    deflation_rank: int = 0


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


def identity_slice_rows(problem: CollocationProblem, structure):
    """For each latent slice ``j``, the ``(block index, row offset)`` of a
    residual segment that is exactly the identity on that slice, or
    ``None`` if a slice has none (``solvers/gn.py:616`` of the JAX
    package). Those rows give a selection ``S`` with ``S J = I``, whose
    prior restriction ``S Theta S^T`` spans the smooth latent modes: the
    mesh path's deflation basis. Checked with two random-tangent JVPs per
    candidate (numpy seed 7); one host read per candidate checked."""
    p = problem
    s, N, seginfo = structure
    rng = np.random.default_rng(7)
    kw = dict(dtype=p.dtype, device=p.device)
    z = torch.as_tensor(rng.standard_normal(p.latent_dim), **kw)
    t1 = torch.as_tensor(rng.standard_normal(p.latent_dim), **kw)
    t2 = torch.as_tensor(rng.standard_normal(p.latent_dim), **kw)
    found = [None] * s
    for bi, (b, segs) in enumerate(zip(p.blocks, seginfo)):
        _, jvp = torch.func.linearize(lambda zz, _b=b: _b.residual(zz, p.data), z)
        y1, y2 = jvp(t1), jvp(t2)
        for off, sz in segs:
            if sz != N:
                continue
            for j in range(s):
                if found[j] is not None:
                    continue
                ok = all(
                    float(torch.max(torch.abs(y[off : off + N] - t[j * N : (j + 1) * N])))
                    < 1e-6 * (1.0 + float(torch.max(torch.abs(t))))
                    for y, t in ((y1, t1), (y2, t2))
                )
                if ok:
                    found[j] = (bi, off)
                    break
    return tuple(found) if all(f is not None for f in found) else None


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


def _misfit_jacobian(m, data, z):
    """``(r_m(z), J_m)`` with ``J_m`` the misfit's (K, n) Jacobian, from K
    VJPs (misfit row counts are small by construction)."""
    F, vjp = torch.func.vjp(lambda zz: m.residual(zz, data), z)
    eye = torch.eye(F.shape[0], dtype=z.dtype, device=z.device)
    return F, torch.func.vmap(lambda e: vjp(e)[0])(eye)


def _misfit_jacobians(p: CollocationProblem, z):
    return [math.sqrt(m.weight) * _misfit_jacobian(m, p.data, z)[1] for m in p.misfits]


def _batched_cg(normal_op, B, tol, maxiter, M=None, X0=None, exit_agree=None):
    """Conjugate gradients on a matrix of right-hand sides sharing one SPD
    operator: the inner solve of the ``'cg'`` and ``'woodbury'`` steps.

    ``normal_op(V)`` applies the operator to each column of ``V`` (m, k).
    Per-column step lengths keep each column's recursion exact (k CG runs
    sharing their operator applications, not block CG). A column whose
    residual fell below ``tol * ||b||`` is frozen (alpha = beta = 0) while
    the others go on; the loop ends when all have, or at ``maxiter``.
    ``M`` is an optional preconditioner, ``X0`` an optional warm start (one
    more operator application for its residual). Returns ``(X, iters)``.

    The exit test reads one boolean on the host per iteration (a device
    sync on the card), where the JAX package's ``while_loop`` decides on
    the device; ``exit_agree`` maps it to the decision every rank of a mesh
    takes.
    """
    tol2 = float(tol) ** 2 * torch.sum(B * B, dim=0)
    prec = M if M is not None else (lambda R: R)
    if X0 is None:
        X, R = torch.zeros_like(B), B
    else:
        X, R = X0, B - normal_op(X0)
    Z = prec(R)
    P, gamma = Z, torch.sum(R * Z, dim=0)
    iters = 0
    while iters < maxiter:
        active = torch.sum(R * R, dim=0) > tol2
        stop = not bool(active.any())
        if exit_agree is not None:
            stop = exit_agree(stop)
        if stop:
            break
        Q = normal_op(P)
        denom = torch.sum(P * Q, dim=0)
        safe = active & (denom > 0)
        alpha = torch.where(safe, gamma / torch.where(safe, denom, 1.0), 0.0)
        X = X + alpha * P
        R = R - alpha * Q
        Z = prec(R)
        gamma_new = torch.sum(R * Z, dim=0)
        beta = torch.where(safe, gamma_new / torch.where(gamma > 0, gamma, 1.0), 0.0)
        P, gamma = Z + beta * P, gamma_new
        iters += 1
    return X, iters


def _normal_op(jvp, vjp, hessian_jitter):
    """``V -> J^T (J V) (+ jitter V)`` column by column (``vmap``) from a
    linearization's JVP and VJP."""

    def op(V):
        HV = torch.func.vmap(lambda v: vjp(jvp(v))[0], in_dims=1, out_dims=1)(V)
        return HV + hessian_jitter * V if hessian_jitter else HV

    return op


def _misfit_jacobi_precond(p: CollocationProblem, z):
    """Jacobi preconditioner of the ``'cg'`` normal solve, or ``None``
    without misfits.

    Heavily weighted misfits (``1/noise^2 ~ 1e6`` for the Darcy inverse) put
    entries of that scale on a few diagonal entries of ``J^T J`` while the
    whitened GP blocks contribute O(1..1e2). The misfits' exact part of
    ``diag(J^T J)`` is their weighted squared column sums; the GP blocks'
    part is taken as 1. The returned ``M`` divides each column of a panel
    by that diagonal (the JAX package divides an (m, 1) panel by an (m,)
    vector, which broadcasts to (m, m): fault R1, fixed here).
    """
    if not p.misfits:
        return None
    d = torch.ones_like(z)
    for m in p.misfits:
        J = _misfit_jacobian(m, p.data, z)[1]
        d = d + m.weight * torch.sum(J * J, dim=0)
    d = d[:, None]
    return lambda V: V / d


def _woodbury_pieces(p: CollocationProblem, z):
    """``(U, wvec, F)``: the (m, K) stacked misfit Jacobian transposes, the
    per-row weights and the stacked misfit residuals, so that the misfits'
    Hessian term is ``U diag(wvec) U^T`` and their gradient ``U (wvec F)``."""
    Us, ws, Fs = [], [], []
    for m in p.misfits:
        F, J = _misfit_jacobian(m, p.data, z)
        Us.append(J.T)
        ws.append(torch.full((F.shape[0],), m.weight, dtype=z.dtype, device=z.device))
        Fs.append(F)
    return torch.cat(Us, dim=1), torch.cat(ws), torch.cat(Fs)


def _woodbury_correct(X, U, wvec, hessian_jitter):
    """Combine the misfit-free solves ``X = H0^{-1} [g, U]`` into the step
    for ``H = H0 + U diag(w) U^T`` (Sherman-Morrison-Woodbury on the rank-K
    misfit term):

    ``H^{-1} g = X_g - X_U (diag(1/w) + U^T X_U)^{-1} (U^T X_g)``.

    The capacitance matrix is (K, K): K = 60 data rows for the reference
    Darcy inverse."""
    Xg, Xu = X[:, 0], X[:, 1:]
    C = torch.diag(1.0 / wvec) + U.T @ Xu
    y = spd_solve(C, U.T @ Xg, jitter=hessian_jitter)
    return Xg - Xu @ y


def _delta_cg(fp: FactoredProblem, z, hessian_jitter, cg_tol, cg_maxiter):
    """The ``'cg'`` step: Jacobi-preconditioned CG on ``J^T J`` (one JVP and
    one VJP per iteration), never forming the Jacobian."""
    r, jvp = torch.func.linearize(fp.whitened_residual, z)
    _, vjp = torch.func.vjp(fp.whitened_residual, z)
    X, iters = _batched_cg(
        _normal_op(jvp, vjp, hessian_jitter), vjp(r)[0][:, None], cg_tol, cg_maxiter,
        M=_misfit_jacobi_precond(fp.problem, z),
    )
    return X[:, 0], iters


def _delta_woodbury(fp: FactoredProblem, z, hessian_jitter, cg_tol, cg_maxiter, X0=None):
    """The ``'woodbury'`` step: batched CG on the misfit-free normal
    operator ``H0`` (whose spectrum is the whitened GP blocks'; the
    ``1/noise^2`` misfit rows are what stall plain CG) against ``[g, U]``,
    then the rank-K correction of :func:`_woodbury_correct`. Returns
    ``(delta, iters, X)``; ``X0`` warm-starts the inner solves (the mesh
    path's carry of the previous step's ``X``), zero when ``None``."""
    wr0 = functools.partial(fp.whitened_residual, misfits=False)
    r0, jvp0 = torch.func.linearize(wr0, z)
    _, vjp0 = torch.func.vjp(wr0, z)
    U, wvec, F = _woodbury_pieces(fp.problem, z)
    g = vjp0(r0)[0] + U @ (wvec * F)
    X, iters = _batched_cg(
        _normal_op(jvp0, vjp0, hessian_jitter), torch.cat([g[:, None], U], dim=1),
        cg_tol, cg_maxiter, X0=X0,
    )
    return _woodbury_correct(X, U, wvec, hessian_jitter), iters, X


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
    cg_tol: float = 1e-10,
    cg_maxiter: int | None = None,
    tol: float | None = None,
) -> GNState:
    """Run up to ``max_iter`` Gauss-Newton steps.

    Each step linearizes the whitened residual at ``z``, solves the normal
    system, and updates ``z <- z - step_size * delta``; a step producing a
    non-finite iterate is rejected and ``z`` kept.

    ``tol``: stop as soon as ``|loss_prev - loss| <= tol * loss`` (after at
    least two steps), or when a step was rejected; untaken iterations repeat
    the last loss in the history.

    ``step_solver``:

    * ``'structured'``: the whitened panel from column slabs of the
      whitening operator; needs ``solve_mode='inverse'`` factors and
      pointwise-per-slice residuals;
    * ``'direct'``: the full Jacobian panel, ``J^T J`` and a Cholesky solve;
    * ``'auto'``: ``'structured'`` where it applies, else ``'direct'``;
    * ``'cg'``: matrix-free Jacobi-preconditioned CG on ``J^T J``;
    * ``'woodbury'`` (problems with misfits only): batched CG on the
      misfit-free operator plus the exact rank-K misfit correction.

    The Krylov steps solve to ``cg_tol`` (relative residual) in at most
    ``cg_maxiter`` iterations (500 when ``None``: an inner solve that
    cannot converge ends there, and ``GNState.cg_iters`` shows it). They
    have no deflation, Levenberg floor or damped update (fault R3, as in
    the JAX package's dense path): at small nuggets in f32 their steps can
    be poor. Each step's inner CG starts from zero, as in the JAX package's
    dense path.
    """
    p = fp.problem
    z = (p.init_latent() if z0 is None else torch.as_tensor(z0)).to(
        device=p.device, dtype=p.dtype
    )
    if step_solver not in ("auto", "structured", "direct", "cg", "woodbury"):
        raise ValueError(f"unknown step_solver {step_solver!r}")
    if step_solver == "woodbury" and not p.misfits:
        raise ValueError(
            "step_solver='woodbury' is the misfit-coupled step; this problem "
            "has no misfit terms (use 'cg' or 'direct')"
        )
    cg_maxiter = 500 if cg_maxiter is None else int(cg_maxiter)
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
        if step_solver == "cg":
            return _delta_cg(fp, z, hessian_jitter, cg_tol, cg_maxiter)
        if step_solver == "woodbury":
            return _delta_woodbury(fp, z, hessian_jitter, cg_tol, cg_maxiter)[:2]
        J = _direct_jacobian(fp, z) if structure is None else _structured_jacobian(fp, z, structure)
        return spd_solve(J.T @ J, J.T @ fp.whitened_residual(z), jitter=hessian_jitter), 0

    ok = torch.ones((), dtype=torch.bool, device=p.device)
    losses, cg_iters = [], []
    prev = cur = math.inf
    for i in range(int(max_iter)):
        if tol is not None and i >= 2:
            if abs(prev - cur) <= tol * max(cur, torch.finfo(p.dtype).tiny):
                break
        step, iters = delta(z)
        cg_iters.append(iters)
        z_new = z - step_size * step
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
    cg_iters = torch.tensor(cg_iters + [0] * (int(max_iter) - len(cg_iters)), dtype=torch.int64)
    routed = step_solver if step_solver != "auto" else (
        "direct" if structure is None else "structured")
    return GNState(z=z, losses=losses, converged_finite=ok, cg_iters=cg_iters,
                   step_solver=routed)
