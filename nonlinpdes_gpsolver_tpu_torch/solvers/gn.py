"""The solver skeleton of both paths, and the dense single-device path.

Counterpart of the main-path part of ``nonlinpdes_gpsolver_tpu/solvers/gn.py``.
The dense path (here) and the mesh path (``solvers/distributed.py``) share
one skeleton and keep apart how they factor, how they solve a step and
what the host reads after it: the factored-problem contract
(:class:`_Factored`: the whitened residual and loss over the path's
``whiten``, and the one host read of the deferred quality verdicts), the
nugget ladder of ``ops/linalg.py``, and the Gauss-Newton driver
(:func:`_gauss_newton`: after the path's route, its loop, a :class:`_Loop`
on a :class:`_Carry`, and its read after each step). The dense path's
own: :func:`factorize` factors each GP block's equilibrated Gram matrix
(with ``solve_mode='inverse'`` also its whitening operator, held to the
quality probe), and :func:`gn_solve` solves ``(J^T J) delta = J^T r`` at
each step with the ``'structured'`` or the ``'direct'`` Jacobian panel, or
by conjugate gradients (``'cg'``, and ``'woodbury'`` with misfits).

The JAX package runs the loop as one compiled ``lax.scan``/``while_loop``.
Here a step is a function of tensors that keep their storage
(:class:`_Carry`), with no host read in it: the non-finite guard, the loss,
the ``tol`` plateau test and the loss history all stay on the device. On
the card it is recorded as CUDA graphs once it has run eagerly as its own
warm-up, and replayed (``ops/graphs.py``, :class:`_Loop`), by every problem
of one layout, as the JAX package keys its compiled loop on the problem's
structure (``solvers/_reuse.py``). The dense fixed-count loop reads
nothing until its end; with ``tol`` it reads the plateau flag once a step,
one step late. The Krylov steps' CG loop (:func:`_batched_cg`) keeps its
iterate and its iteration count on the device and reads its exit flag once
an iteration, one iteration late: at most one iteration a solve is spent
after the exit.

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
from ..ops.graphs import Flag, Recorder, routed as count_route, to_host
from ..ops.linalg import (
    ESCALATION,
    MAX_ESCALATIONS,
    accepted,
    cholesky_with_retry,
    equilibrated_cholesky,
    escalation_start,
    kernel_solve,
    newton_refine_tri_inverse,
    probe_vector,
    rungs_climbed,
    spd_solve,
    tri_inverse,
    whiten,
)
from ..utils import tracing
from . import _reuse


class _Factored:
    """The factored-problem contract of both paths: the whitened residual
    and loss over the path's own ``whiten``, and the deferred verdicts' one
    host read. A path's type holds ``problem``, ``nugget_scales``,
    ``col_scales`` and ``quality``, and defines ``whiten``. With
    ``defer_quality``, ``quality[name]`` is a device scalar until
    :meth:`resolve_pending` reads it (:attr:`pending_scales`)."""

    @property
    def pending_scales(self) -> Dict[str, float]:
        """The attempted nugget scale of every block whose verdict is still
        on the device (the JAX package's field; its in-executable ladder
        also leaves the scale there, the port's eager one does not)."""
        return {n: self.nugget_scales[n] for n, q in self.quality.items() if torch.is_tensor(q)}

    def _scale(self, name: str, v: torch.Tensor) -> torch.Tensor:
        s = self.col_scales.get(name)
        return v if s is None else v * (s if v.dim() == 1 else s[:, None])

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

    def resolve_pending(self, extra=()):
        """Read the pending verdicts (with the tensors ``extra``, in one
        host read) and settle them: ``quality`` becomes floats, in place.
        Returns ``(bad, extra_values)``: ``bad`` maps each block whose
        verdict failed (a quality not finite or not below ``QUALITY_TOL``)
        to its quality, and ``extra_values`` is the flat list of ``extra``'s
        values."""
        names = [n for n, q in self.quality.items() if torch.is_tensor(q)]
        parts = [t.reshape(-1).to(torch.float64) for t in extra]
        parts += [self.quality[n].reshape(1).to(torch.float64) for n in names]
        if not parts:
            return {}, []
        dev = parts[0].device
        vals = to_host(torch.cat([p.to(dev) for p in parts])).tolist()
        n_extra = len(vals) - len(names)
        bad = {}
        for n, q in zip(names, vals[n_extra:]):
            self.quality[n] = q
            if not accepted(q):
                bad[n] = q
        return bad, vals[:n_extra]


@dataclasses.dataclass(frozen=True)
class FactoredProblem(_Factored):
    """A problem plus factorizations of its regularized Gram matrices.

    ``factors[name]`` is the lower Cholesky factor of the equilibrated
    regularized Gram matrix ``D^{-1/2} (Theta + nugget) D^{-1/2}``, with
    ``col_scales[name] = d^{-1/2}``, or without ``col_scales[name]`` (from
    ``factorize(equilibrate=False)``) of ``Theta + nugget`` itself.
    ``inv_factors[name]`` holds the whitening operator ``L~^{-1} D^{-1/2}``
    (``L^{-1}``) when ``solve_mode='inverse'``.
    ``nugget_scales[name]`` is the escalation factor the accepted factor
    used, and ``rungs[name]`` the number of tenfold escalations it took.

    ``quality[name]`` is the block's deferred whitening-quality verdict
    (:class:`_Factored`). ``entry`` is the shared loops' entry whose
    storage these factors are (``solvers/_reuse.py``), a guest's
    ``_reuse.Guest`` (its factors its own, its loops the guest entry's),
    or ``None``; ``graphs`` holds the loops of a problem that is not bound
    to one (``gn_solve``), which go with it.
    """

    problem: CollocationProblem
    factors: Dict[str, torch.Tensor]
    inv_factors: Dict[str, torch.Tensor]
    nugget_scales: Dict[str, float]
    col_scales: Dict[str, torch.Tensor]
    rungs: Dict[str, int]
    quality: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    graphs: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)
    entry: object = dataclasses.field(default=None, repr=False, compare=False)

    def whiten(self, name: str, v: torch.Tensor) -> torch.Tensor:
        if name in self.inv_factors:
            return self.inv_factors[name] @ v
        return whiten(self.factors[name], self._scale(name, v))

    def kernel_solve(self, name: str, v: torch.Tensor) -> torch.Tensor:
        """``Theta^{-1} v`` through the (equilibrated) factor."""
        if name in self.inv_factors:
            W = self.inv_factors[name]
            return W.T @ (W @ v)
        return self._scale(name, kernel_solve(self.factors[name], self._scale(name, v)))


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


def _whiten_quality(inv, L, d_isqrt, v) -> torch.Tensor:
    """Relative whitening residual ``max|W(Lv) - v| / max|v|``, a device
    scalar."""
    w = inv @ ((L @ v) / d_isqrt)
    return torch.max(torch.abs(w - v)) / torch.max(torch.abs(v))


def factorize(
    problem: CollocationProblem,
    nugget: float,
    nugget_type: str = "adaptive",
    solve_mode: str = "auto",
    equilibrate: bool = True,
    defer_quality: bool = False,
    start_scales: Dict[str, float] | None = None,
) -> FactoredProblem:
    """Assemble + regularize + factor every GP block's Gram matrix.

    Runs on the problem's device and dtype, on the nugget ladder of
    ``ops/linalg.py``. The escalation starts at the dtype-aware scale
    ``s0 = max(1, 4 eps / nugget)``, or the block's ``start_scales`` entry
    if larger. With ``solve_mode='inverse'`` each accepted factor is
    inverted (plus one Newton step on the card), and a factor whose
    whitening residual on a fixed probe is not below ``QUALITY_TOL`` is
    escalated tenfold again. ``rungs`` counts from ``s0``.

    ``defer_quality`` (the JAX package's optimistic pipeline, ``gn.py:381``
    there): one quality probe a block, and no host read for it. The
    whitening verdict stays on the device in ``quality``; the caller reads it with its results and, on a
    failed verdict, factors again with ``start_scales`` ten times the
    attempted scale. The non-finite class still escalates inside the call
    (one read a Cholesky), as the JAX package's in-executable ladder does:
    only the finite-but-corrupt class waits for the caller. ``'trsm'``
    blocks have no probe and nothing pending.

    ``equilibrate=False`` (the JAX package's ``gn.py:487-490``): a plain
    Cholesky of ``Theta + s diag(nug)`` with ``s`` escalated tenfold from 1,
    at most 6 attempts (:func:`..ops.linalg.cholesky_with_retry`), and in
    ``'inverse'`` mode its triangular inverse; no column scales, no quality
    probe (``defer_quality`` and ``start_scales`` do not apply).

    The outputs go straight into the storage of a released problem of the
    same layout, whose recorded loop then serves this one
    (``solvers/_reuse.py``).
    """
    device, dtype = problem.device, problem.dtype
    on_accelerator = is_accelerator(device)
    if solve_mode == "auto":
        solve_mode = "inverse" if on_accelerator else "trsm"
    if solve_mode not in ("inverse", "trsm"):
        raise ValueError(f"unknown solve_mode {solve_mode!r}")
    factors, inv_factors, scales, col_scales, rungs = {}, {}, {}, {}, {}
    quality = {}
    inverse = solve_mode == "inverse"
    with tracing.span("factorize.bind"):
        key = _reuse.layout_key(problem, {
            b.name: dense_roles(sum(observable_sizes(b.observables, problem.points)), inverse,
                                equilibrate)
            for b in problem.blocks})
    with _reuse.claimed(key) as entry:
        out = entry.outputs() if entry is not None else {}
        for b in problem.blocks:
            with tracing.span("factorize.assemble"):
                theta = gram_matrix(b.kernel, b.observables, problem.points)
                sizes = observable_sizes(b.observables, problem.points)
                buf = out.get(b.name) or dense_storage(int(theta.shape[0]), inverse, dtype,
                                                       device, equilibrate)
                nug = adaptive_nugget_diag(theta, b.observables, sizes, nugget, nugget_type)
            if not equilibrate:
                with tracing.span("factorize.cholesky"):
                    L, s = cholesky_with_retry(theta, nug, out=buf["L"],
                                               work=_equilibration_work(buf))
                del theta
                if inverse:
                    with tracing.span("factorize.inverse"):
                        inv_factors[b.name] = buf["inv"].copy_(tri_inverse(L))
                factors[b.name], scales[b.name] = L, s
                rungs[b.name] = rungs_climbed(s, 1.0)
                continue
            s0 = escalation_start(nugget, dtype)
            s = max(s0, float((start_scales or {}).get(b.name, 1.0)))
            for _ in range(MAX_ESCALATIONS):
                with tracing.span("factorize.cholesky"):
                    L, d_isqrt, s, _ = equilibrated_cholesky(
                        theta, nug, s, out=(buf["L"], buf["d"]), work=_equilibration_work(buf))
                if solve_mode == "trsm":
                    break
                with tracing.span("factorize.inverse"):
                    inv = _refined_inverse(L, on_accelerator, d_isqrt, out=buf["inv"])
                with tracing.span("factorize.quality"):
                    v = probe_vector(L.shape[0], dtype, device)
                    q = _whiten_quality(inv, L, d_isqrt, v)
                if defer_quality:
                    inv_factors[b.name], quality[b.name] = inv, q
                    break
                if accepted(tracing.read(float, q)):
                    inv_factors[b.name] = inv
                    break
                s *= ESCALATION  # finite but corrupted factor: escalate anyway
            else:
                raise FloatingPointError(
                    f"block {b.name!r}: factor quality still bad after nugget "
                    f"escalation to {s:g}x"
                )
            del theta
            factors[b.name] = L
            col_scales[b.name] = d_isqrt
            scales[b.name] = s
            rungs[b.name] = rungs_climbed(s, s0)
        fp = FactoredProblem(problem, factors, inv_factors, scales, col_scales, rungs, quality)
        with tracing.span("factorize.bind"):
            _reuse.settle(fp, key, entry, dense_tensors(fp), dense_view, dense_role_storage)
    return fp


def dense_roles(n: int, inverse: bool, equilibrated: bool = True) -> tuple:
    """The stored tensors of a dense block of ``n`` rows, as
    ``((role, shape), ...)``: the factor, the column scales (where it is
    equilibrated) and, in ``'inverse'`` mode, the whitening operator
    (``solvers/_reuse.py``)."""
    roles = (("L", (n, n)),) + ((("d", (n,)),) if equilibrated else ())
    return roles + (("inv", (n, n)),) if inverse else roles


def dense_storage(n: int, inverse: bool, dtype, device,
                  equilibrated: bool = True) -> Dict[str, torch.Tensor]:
    """New storage of a dense block of ``n`` rows (:func:`dense_roles`),
    the matrices column-major, as torch's factorizations return them. With
    the whitening operator, the factor and it are one buffer, factor first:
    the f64 equilibrated matrix is formed in its bytes
    (:func:`_equilibration_work`) before either is written, so that the
    factorization's peak holds no more than it did without this storage."""
    kw = dict(dtype=dtype, device=device)
    if inverse:
        flat = torch.empty(2 * n * n, **kw)
        out = {"L": flat[: n * n].view(n, n).t(), "inv": flat[n * n :].view(n, n).t()}
    else:
        out = {"L": torch.empty((n, n), **kw).t()}
    if equilibrated:
        out["d"] = torch.empty(n, **kw)
    return out


def dense_role_storage(roles: tuple, dtype, device) -> Dict[str, torch.Tensor]:
    """:func:`dense_storage` of one block's :func:`dense_roles`."""
    shapes = dict(roles)
    return dense_storage(shapes["L"][0], "inv" in shapes, dtype, device, "d" in shapes)


def _equilibration_work(buf: Dict[str, torch.Tensor]):
    """The ``(n, n)`` f64 matrix over the bytes of a block's factor and
    whitening operator (:func:`dense_storage`), or ``None`` where they do
    not hold it (no operator, or not one buffer)."""
    L = buf["L"]
    n, start = L.shape[0], L.storage_offset() * L.element_size()
    if "inv" not in buf or start % 8 or L.untyped_storage().nbytes() < start + 8 * n * n:
        return None
    return torch.empty(0, dtype=torch.float64, device=L.device).set_(
        L.untyped_storage(), start // 8, (n, n))


def dense_tensors(fp: FactoredProblem) -> Dict[str, Dict[str, torch.Tensor]]:
    """``fp``'s stored tensors by block and role (:func:`dense_roles`)."""
    out = {}
    for b in fp.problem.blocks:
        t = {"L": fp.factors[b.name]}
        if b.name in fp.col_scales:
            t["d"] = fp.col_scales[b.name]
        if b.name in fp.inv_factors:
            t["inv"] = fp.inv_factors[b.name]
        out[b.name] = t
    return out


def dense_view(problem, tensors) -> FactoredProblem:
    """The factored problem an entry's loops run on, made of its storage."""
    return FactoredProblem(
        problem, {b: t["L"] for b, t in tensors.items()},
        {b: t["inv"] for b, t in tensors.items() if "inv" in t}, {},
        {b: t["d"] for b, t in tensors.items() if "d" in t}, {})


def _refined_inverse(L: torch.Tensor, refine: bool, d_isqrt: torch.Tensor,
                     out: torch.Tensor) -> torch.Tensor:
    """The whitening operator ``L^{-1} D^{-1/2}``, into ``out``; ``L^{-1}``
    is refined in place by one Newton step on the card."""
    W = tri_inverse(L)
    if refine:
        newton_refine_tri_inverse(L, W)
    return torch.mul(W, d_isqrt[None, :], out=out)


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


def _verdict_key(kind: str, problem: CollocationProblem, structure):
    """The key of a cached structure verdict: the JAX package's residual
    identities, structure and dtype, and the device type; ``None`` for an
    unhashable residual (checked without caching, as there)."""
    key = (kind, tuple(b.residual for b in problem.blocks), structure, problem.dtype,
           problem.device.type)
    try:
        hash(key)
    except TypeError:
        return None
    return key


def _cached_verdict(kind: str, problem, structure, check):
    key = _verdict_key(kind, problem, structure)
    if key is not None and key in _reuse.VERDICTS:
        return _reuse.VERDICTS[key]
    verdict = check(problem, structure)
    if key is not None:
        _reuse.VERDICTS[key] = verdict
    return verdict


def validate_slice_structure(
    problem: CollocationProblem, structure, probes: int = 2
) -> bool:
    """Check the pointwise-slice structure on random tangents (one host
    sync), once per residual identities, structure, dtype and device type
    (the JAX package's ``_STRUCTURE_CACHE``): model constructors build
    their residuals with cached factories, so a rebuilt problem of one
    configuration is not checked again.

    For random tangents ``v`` the structured prediction
    ``sum_j D_j[rows] * v[slice j]`` (zero on non-interior rows) must match
    the true JVP of the raw residuals.
    """
    return _cached_verdict("slices", problem, structure,
                           lambda p, st: _check_slice_structure(p, st, probes))


def _check_slice_structure(problem: CollocationProblem, structure, probes: int) -> bool:
    """:func:`validate_slice_structure`'s check, uncached."""
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
    candidate (numpy seed 7), one host read per candidate checked, once per
    key of :func:`validate_slice_structure` (the JAX package's
    ``_IDENTITY_ROW_CACHE``)."""
    return _cached_verdict("identity rows", problem, structure, _find_identity_rows)


def _find_identity_rows(problem: CollocationProblem, structure):
    """:func:`identity_slice_rows`' check, uncached."""
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


class _CGState:
    """The CG recursion's tensors, updated in place by :func:`_cg_iteration`
    (a recorded graph reads and writes the same storage): the iterate
    ``X``, residual ``R``, direction ``P``, ``gamma = R.M(R)`` per column,
    the squared stopping radii ``tol2``, the ``active`` columns, the count
    of iterations in which any column was active, and ``flag``, whether
    any column still is (the exit test the host reads). ``agree`` maps that
    test to the one every rank of a mesh takes, on the device (the mesh
    loop's :func:`..parallel.comm.agree_device`); ``None``: as it is."""

    def __init__(self, normal_op, B, tol, M=None, X0=None, agree=None):
        self.agree = agree
        self.tol2 = float(tol) ** 2 * torch.sum(B * B, dim=0)
        if X0 is None:
            self.X, self.R = torch.zeros_like(B), B.clone()
        else:
            self.X, self.R = X0.clone(), B - normal_op(X0)
        Z = M(self.R) if M is not None else self.R
        self.P = Z.clone()
        self.gamma = torch.sum(self.R * Z, dim=0)
        self.active = torch.sum(self.R * self.R, dim=0) > self.tol2
        self.iters = torch.zeros((), dtype=torch.int64, device=B.device)
        self.flag = torch.empty((), dtype=torch.bool, device=B.device)
        self.set_flag()

    def set_flag(self) -> None:
        """``flag``: whether any column is active (on any rank)."""
        flag = self.active.any()
        self.flag.copy_(flag if self.agree is None else self.agree(flag))

    def mask(self, go: torch.Tensor) -> None:
        """Freeze every column unless ``go`` (a skipped Gauss-Newton step)."""
        self.active &= go
        self.set_flag()


def _cg_iteration(st: _CGState, normal_op, M=None) -> None:
    """One CG iteration on every column at once, in place. A column that
    is not active takes alpha = beta = 0, so an iteration after every
    column stopped leaves ``X`` and ``R`` as they were."""
    active = st.active
    Q = normal_op(st.P)
    denom = torch.sum(st.P * Q, dim=0)
    safe = active & (denom > 0)
    alpha = torch.where(safe, st.gamma / torch.where(safe, denom, 1.0), 0.0)
    st.X.copy_(st.X + alpha * st.P)
    st.R.copy_(st.R - alpha * Q)
    Z = M(st.R) if M is not None else st.R
    gamma_new = torch.sum(st.R * Z, dim=0)
    beta = torch.where(safe, gamma_new / torch.where(st.gamma > 0, st.gamma, 1.0), 0.0)
    st.P.copy_(Z + beta * st.P)
    st.gamma.copy_(gamma_new)
    st.iters.add_(active.any().to(torch.int64))
    st.active.copy_(torch.sum(st.R * st.R, dim=0) > st.tol2)
    st.set_flag()


def _cg_loop(iterate, st: _CGState, maxiter: int) -> None:
    """Run ``iterate()`` (one CG iteration on ``st``) until no column is
    active, at most ``maxiter`` times. The exit flag is read one iteration
    late (:class:`..ops.graphs.Flag`): iteration i + 1 is queued before
    iteration i's flag is read, so the card never waits on the host, and
    the one iteration queued after the last active one changes nothing.
    On a mesh the flag is agreed on the device (``st.agree``), so every
    rank reads the same one."""
    flag = Flag(st.flag.device)
    flag.post(st.flag)
    for _ in range(int(maxiter)):
        iterate()
        if not flag.read():
            break
        flag.post(st.flag)


def _batched_cg(normal_op, B, tol, maxiter, M=None, X0=None):
    """Conjugate gradients on a matrix of right-hand sides sharing one SPD
    operator: the inner solve of the ``'cg'`` and ``'woodbury'`` steps.

    ``normal_op(V)`` applies the operator to each column of ``V`` (m, k).
    Per-column step lengths keep each column's recursion exact (k CG runs
    sharing their operator applications, not block CG). A column whose
    residual fell below ``tol * ||b||`` is frozen (alpha = beta = 0) while
    the others go on; the loop ends when all have, or at ``maxiter``.
    ``M`` is an optional preconditioner, ``X0`` an optional warm start (one
    more operator application for its residual). Returns ``(X, iters)``,
    ``iters`` a device scalar, as from the JAX package's ``while_loop``;
    the exit test is read as :func:`_cg_loop` says.
    """
    st = _CGState(normal_op, B, tol, M, X0)
    _cg_loop(lambda: _cg_iteration(st, normal_op, M), st, maxiter)
    return st.X, st.iters


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


def _linear_ops(fn, z):
    """``(fn(z), jvp, vjp)`` of ``fn`` at ``z``: the JVP re-evaluates ``fn``
    at ``z`` with each tangent (no traced linearization, whose trace would
    be redone on every call), the VJP reuses one autograd graph."""
    r, vjp = torch.func.vjp(fn, z)

    def jvp(v):
        return torch.func.jvp(fn, (z,), (v,))[1]

    return r, jvp, vjp


def _whitened_linear_ops(fp: FactoredProblem, z, misfits: bool = True):
    """:func:`_linear_ops` of the whitened residual, its JVP taken through
    the raw residuals and whitened after (the whitening is linear), so that
    an operator application whitens the tangent alone, not ``F(z)`` too."""
    p = fp.problem
    r, vjp = torch.func.vjp(functools.partial(fp.whitened_residual, misfits=misfits), z)

    def tangent(residual, v):
        return torch.func.jvp(lambda zz: residual(zz, p.data), (z,), (v,))[1]

    def jvp(v):
        parts = [fp.whiten(b.name, tangent(b.residual, v)) for b in p.blocks]
        if misfits:
            parts += [math.sqrt(m.weight) * tangent(m.residual, v) for m in p.misfits]
        return torch.cat(parts)

    return r, jvp, vjp


def _cg_system(fp: FactoredProblem, z, hessian_jitter):
    """The ``'cg'`` step's inner system at ``z``: ``(op, B, M, finish)``,
    Jacobi-preconditioned ``J^T J`` (one JVP and one VJP an application,
    never forming the Jacobian) against ``J^T r``; ``finish(X)`` is the
    step."""
    r, jvp, vjp = _whitened_linear_ops(fp, z)
    op = _normal_op(jvp, vjp, hessian_jitter)
    return op, vjp(r)[0][:, None], _misfit_jacobi_precond(fp.problem, z), lambda X: X[:, 0]


def _woodbury_system(fp: FactoredProblem, z, hessian_jitter):
    """The ``'woodbury'`` step's inner system at ``z``: batched CG on the
    misfit-free normal operator ``H0`` (whose spectrum is the whitened GP
    blocks'; the ``1/noise^2`` misfit rows are what stall plain CG) against
    ``[g, U]``; ``finish(X)`` is the rank-K correction of
    :func:`_woodbury_correct`."""
    r0, jvp0, vjp0 = _whitened_linear_ops(fp, z, misfits=False)
    U, wvec, F = _woodbury_pieces(fp.problem, z)
    g = vjp0(r0)[0] + U @ (wvec * F)
    B = torch.cat([g[:, None], U], dim=1)
    return (_normal_op(jvp0, vjp0, hessian_jitter), B, None,
            lambda X: _woodbury_correct(X, U, wvec, hessian_jitter))


def _delta_woodbury(fp: FactoredProblem, z, hessian_jitter, cg_tol, cg_maxiter, X0=None):
    """The ``'woodbury'`` step at ``z`` (eager): ``(delta, iters, X)``;
    ``X0`` warm-starts the inner solves (the mesh path's carry of the
    previous step's ``X``), zero when ``None``."""
    op, B, _, finish = _woodbury_system(fp, z, hessian_jitter)
    X, iters = _batched_cg(op, B, cg_tol, cg_maxiter, X0=X0)
    return finish(X), iters, X


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


class _Carry:
    """The Gauss-Newton loop's state, in tensors that keep their storage (a
    recorded step reads and writes them in place): the iterate ``z``, the
    finiteness verdict ``ok``, the step counter ``i``, the loss and
    inner-iteration histories, the current ``loss``, the last two losses
    ``prev`` and ``cur`` (the ``tol`` plateau test) and ``go``, whether the
    next step runs (always with ``tol=None``). Every step is masked by
    ``go``: a step queued after a ``tol`` stop changes nothing.
    ``Xw`` is the Krylov step's warm start (``None``: its CG starts from
    zero; the mesh path's ``'woodbury'`` step sets it)."""

    def __init__(self, z: torch.Tensor, max_iter: int, tol):
        dev, dt = z.device, z.dtype
        self.tol, self.max_iter = tol, int(max_iter)
        self.z = z.clone()
        self.ok = torch.ones((), dtype=torch.bool, device=dev)
        self.i = torch.zeros((), dtype=torch.int64, device=dev)
        self.losses = torch.zeros(self.max_iter, dtype=dt, device=dev)
        self.iters = torch.zeros(self.max_iter, dtype=torch.int64, device=dev)
        self.big = torch.full((), torch.finfo(dt).max, dtype=dt, device=dev)
        self.prev, self.cur, self.loss = self.big.clone(), self.big.clone(), self.big.clone()
        self.go = torch.ones((), dtype=torch.bool, device=dev)
        self.no_iters = torch.zeros((), dtype=torch.int64, device=dev)
        self.Xw = None

    def reset(self, z0: torch.Tensor) -> None:
        self.z.copy_(z0)
        self.ok.fill_(True)
        self.i.zero_()
        self.losses.zero_()
        self.iters.zero_()
        for t in (self.prev, self.cur, self.loss):
            t.copy_(self.big)
        self.go.fill_(True)
        if self.Xw is not None:
            self.Xw.zero_()

    def start(self, fp, z0: torch.Tensor) -> Flag:
        """Reset to ``z0`` for a solve on ``fp``; returns the flag the host
        reads after each step, ``go`` posted (the ``tol`` read)."""
        self.reset(z0)
        flag = Flag(z0.device)
        flag.post(self.go)
        return flag

    def update_go(self) -> None:
        """``go``: the JAX package's plateau predicate (``gn.py:879``); with
        ``tol=None`` it stays true."""
        if self.tol is None:
            return
        tiny = torch.finfo(self.z.dtype).tiny
        plateau = torch.abs(self.prev - self.cur) <= self.tol * torch.clamp(self.cur, min=tiny)
        self.go.copy_((self.i < self.max_iter) & (~plateau | (self.i < 2)) & self.ok)

    def commit(self, z_next, finite, loss, iters) -> None:
        """Record a step: its iterate, finiteness, loss and inner iterations."""
        idx = torch.clamp(self.i, max=self.max_iter - 1).view(1)
        g = self.go
        self.z.copy_(torch.where(g, z_next, self.z))
        self.ok.copy_(torch.where(g, self.ok & finite, self.ok))
        self.loss.copy_(torch.where(g, loss, self.loss))
        for hist, val in ((self.losses, loss), (self.iters, iters)):
            hist.index_copy_(0, idx, torch.where(g, val.view(1), hist.index_select(0, idx)))
        self.prev.copy_(torch.where(g, self.cur, self.prev))
        self.cur.copy_(torch.where(g, loss, self.cur))
        self.i.add_(g.to(torch.int64))
        self.update_go()

    def history(self):
        """``(losses, converged_finite)``, new tensors; with ``tol`` the
        untaken steps repeat the last loss."""
        taken = torch.arange(self.max_iter, device=self.i.device) < self.i
        return torch.where(taken, self.losses, self.cur), self.ok.clone()


class _Loop:
    """A configured Gauss-Newton step on a :class:`_Carry`, recorded on the
    card once it has run eagerly as its own warm-up (below).

    An exact step is ``delta_fn(fp, carry) -> delta``. A Krylov step is
    ``system_fn(fp, carry) -> (op, B, M, finish)``: its inner system,
    solved by the CG loop from ``carry.Xw``, and ``finish(X) -> delta``.
    Either way ``update(fp, carry, delta, iters)`` applies the step. Recorded, an
    exact step is one graph; a Krylov step three (the system and CG set-up,
    one CG iteration, the update) sharing one pool, with the CG loop's
    lagged exit reads between them (:func:`_cg_loop`); on a mesh
    ``flag_agree(fp, flag)`` agrees the exit flag over the ranks on the
    device, inside the recorded set-up and iteration.

    When to record: an exact step at the start of the loop's second call,
    its first call being the warm-up (a handful of exact steps cost less
    eagerly than a capture does, so a loop called once is not recorded); a
    Krylov step after its first step, whose CG iterations are the warm-up
    and repay the capture within the call. The count is the loop's, so a
    loop shared by the problems of one layout (``solvers/_reuse.py``)
    records at the second problem's solve and every later problem replays.
    Calls inside :func:`..ops.graphs.uncaptured` run eagerly and do not
    count.

    The loop holds no factored problem: each step is given the one it runs
    on (``fp``), and the recorded graphs read its tensors' storage.
    ``prepare(loop, fp)``, when set, computes the loop's per-problem state
    for ``fp`` (the mesh path's deflation basis), into the same storage once
    recorded; ``bound`` says for which bind it last did."""

    def __init__(self, carry: _Carry, update, delta_fn=None, system_fn=None, cg_tol=0.0,
                 cg_maxiter=0, flag_agree=None, capture=True, pool=None, prepare=None):
        self.carry, self.update = carry, update
        self.delta_fn, self.system_fn = delta_fn, system_fn
        self.cg_tol, self.cg_maxiter, self.flag_agree = cg_tol, cg_maxiter, flag_agree
        self.rec = Recorder(carry.z.device, capture, pool)
        self.cg = None  # the recorded step's CG state
        self.steps = 0
        self.prepare, self.bound = prepare, None
        self.deflation_rank = 0

    @property
    def krylov(self) -> bool:
        return self.system_fn is not None

    def _exact(self, fp):
        self.update(fp, self.carry, self.delta_fn(fp, self.carry), self.carry.no_iters)

    def _setup(self, fp):
        op, B, M, finish = self.system_fn(fp, self.carry)
        agree = (None if self.flag_agree is None
                 else functools.partial(self.flag_agree, fp))
        st = _CGState(op, B, self.cg_tol, M, self.carry.Xw, agree)
        st.mask(self.carry.go)
        return st, (op, M, finish)

    def _record(self, fp):
        rec = self.rec
        if not self.krylov:
            rec.capture("step", lambda: self._exact(fp))
            return
        ctx = []

        def setup():
            self.cg, parts = self._setup(fp)
            ctx.append(parts)

        rec.capture("setup", setup)
        op, M, finish = ctx.pop()
        rec.capture("iteration", lambda: _cg_iteration(self.cg, op, M))
        rec.capture("finish", lambda: self.update(fp, self.carry, finish(self.cg.X),
                                                  self.cg.iters))

    def step(self, fp) -> None:
        """One Gauss-Newton step on ``fp``, queued (recorded first if it is
        due, replayed once recorded)."""
        rec = self.rec
        live = rec.live
        warm_up = 1 if self.krylov else self.carry.max_iter
        if live and not rec.captured and self.steps >= warm_up:
            self._record(fp)
        if live and rec.captured:
            if not self.krylov:
                rec.replay("step")
            else:
                rec.replay("setup")
                _cg_loop(lambda: rec.replay("iteration"), self.cg, self.cg_maxiter)
                rec.replay("finish")
        elif not self.krylov:
            self._exact(fp)
        else:
            st, (op, M, finish) = self._setup(fp)
            _cg_loop(lambda: _cg_iteration(st, op, M), st, self.cg_maxiter)
            self.update(fp, self.carry, finish(st.X), st.iters)
        if live:
            self.steps += 1


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

    The loop reads nothing on the host but the ``tol`` flag (once a step,
    one step late) and the CG exit flag (once an iteration, one iteration
    late); on the card its step is replayed from CUDA graphs shared by the
    problems of ``fp``'s layout (module docstring).
    """
    p = fp.problem
    _check_step_solver(p, step_solver, ("auto", "structured", "direct", "cg", "woodbury"))
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
    routed = step_solver if step_solver != "auto" else (
        "direct" if structure is None else "structured")
    return _gauss_newton(
        fp, z0, max_iter, cg_maxiter, tol, routed,
        ("dense", routed, structure, float(step_size), float(hessian_jitter), float(cg_tol)),
        lambda z, max_iter, cg_maxiter, run_fp, pool: _dense_loop(
            z, routed, structure, max_iter, step_size, hessian_jitter, cg_tol, cg_maxiter, tol,
            pool),
        None if tol is None else _read_go)


def _check_step_solver(problem: CollocationProblem, step_solver: str, solvers: tuple) -> None:
    """``step_solver`` must be one of the path's ``solvers``; ``'woodbury'`` needs misfits."""
    if step_solver not in solvers:
        raise ValueError(f"unknown step_solver {step_solver!r}")
    if step_solver == "woodbury" and not problem.misfits:
        raise ValueError(
            "step_solver='woodbury' is the misfit-coupled step; this problem "
            "has no misfit terms (use 'cg' or 'direct')"
        )


def _gauss_newton(fp, z0, max_iter, cg_maxiter, tol, routed: str, key: tuple, make, read,
                  phase: str | None = None) -> GNState:
    """The Gauss-Newton driver of both paths, after the path's route: at
    most ``max_iter`` steps from ``z0`` of the loop ``key`` (completed here)
    that ``make(z, max_iter, cg_maxiter, run_fp, pool)`` makes, each
    followed by the path's host read ``read(run_fp, carry, flag)``, false
    to stop (``None``: none); ``phase`` names a span timing each step."""
    p = fp.problem
    z = (p.init_latent() if z0 is None else torch.as_tensor(z0)).to(device=p.device, dtype=p.dtype)
    cg_maxiter = 500 if cg_maxiter is None else int(cg_maxiter)
    max_iter = int(max_iter)
    key += (cg_maxiter, tol, max_iter, tuple(z.shape), z.dtype)
    loop, run_fp = _reuse.loop_for(fp, key, functools.partial(make, z, max_iter, cg_maxiter))
    count_route(routed)
    carry = loop.carry
    step = loop.step if phase is None else functools.partial(_timed_step, loop, phase)
    with loop.rec.scope():
        flag = carry.start(run_fp, z)
        for _ in range(max_iter):
            step(run_fp)
            if read is not None and not read(run_fp, carry, flag):
                break
    losses, ok = carry.history()
    cg_iters = (to_host(carry.iters) if loop.krylov
                else torch.zeros(max_iter, dtype=torch.int64))
    return GNState(z=carry.z.clone(), losses=losses, converged_finite=ok, cg_iters=cg_iters,
                   step_solver=routed, deflation_rank=loop.deflation_rank)


def _timed_step(loop: _Loop, phase: str, fp) -> None:
    with tracing.phase(phase, fp.problem.device):
        loop.step(fp)


def _read_go(fp, carry: _Carry, flag: Flag) -> bool:
    """The dense path's read with ``tol``: ``go``, one step late (a step
    queued after the stop changed nothing), posted again for the next."""
    if not flag.read():
        return False
    flag.post(carry.go)
    return True


def _dense_loop(z, solver, structure, max_iter, step_size, hessian_jitter, cg_tol,
                cg_maxiter, tol, pool) -> _Loop:
    """The dense path's :class:`_Loop` for one configuration: the guarded
    update ``z - step_size * delta`` (a non-finite iterate keeps ``z``)
    and the loss at the new iterate."""

    def update(fp, carry, delta, iters):
        z_new = carry.z - step_size * delta
        finite = torch.isfinite(z_new).all()
        z_next = torch.where(finite, z_new, carry.z)
        carry.commit(z_next, finite, fp.loss(z_next), iters)

    carry = _Carry(z, max_iter, tol)
    kw = dict(cg_tol=cg_tol, cg_maxiter=cg_maxiter, pool=pool)
    if solver in ("cg", "woodbury"):
        system = _cg_system if solver == "cg" else _woodbury_system
        return _Loop(carry, update, system_fn=lambda fp, c: system(fp, c.z, hessian_jitter), **kw)

    def delta_fn(fp, c):
        J = (_direct_jacobian(fp, c.z) if structure is None
             else _structured_jacobian(fp, c.z, structure))
        return spd_solve(J.T @ J, J.T @ fp.whitened_residual(c.z), jitter=hessian_jitter)

    return _Loop(carry, update, delta_fn=delta_fn, **kw)
