"""The mesh path across P ranks: fused factorization, Gauss-Newton and posterior.

Counterpart of ``nonlinpdes_gpsolver_tpu/solvers/distributed.py``, the path
past the dense wall. Per GP block, :func:`factorize_distributed` builds the
equilibrated factor with the fused assemble-and-factorize
(``parallel/fused.py``: K2 strips straight into the factor's panels) or the
two-pass path, inside the guarded escalation ladder; the Gram matrix itself
never exists on the fused path. :func:`gn_solve_distributed` then runs the
whitened Gauss-Newton loop with the mesh path's five step solvers and its
guards, and :class:`DistributedPosterior` extends the solution.

The JAX package runs the whole loop as one ``shard_map``'d ``lax.scan``;
here every rank runs the same Python loop over eager tensor ops, on its own
device with its own rows of each factor. Latent-sized quantities (``z``,
the gradient, the Krylov vectors) are replicated and computed on every rank;
the factor's solves (``parallel/cholesky.py``: ``solve_triangular`` at
P = 1, the panel loops across ranks) and the panels that are sharded by
column bring the ranks together. Every host read that decides control flow
(the CG exit test, the damped update's loss tests, the GN loop's guards,
the routing and the probes) is agreed across the ranks first
(``parallel/comm.py::agree``), so that no rank leaves a loop another stays
in. The steps (``:516-1008``):

* ``'structured'``/``'direct'``: the whitened Jacobian panel, sharded by
  column (each rank its ``ceil(m/P)`` raw columns, from per-slice residual
  diagonals or JVPs of its basis vectors, whitened by the column-sharded
  solve), ``J^T J`` accumulated around the ``ppermute`` ring and gathered,
  and one SPD solve;
* ``'cg'``: matrix-free CG on ``J^T J`` (one batched JVP, kernel solve and
  VJP an iteration), with the misfit Jacobi preconditioner, or the
  spectral deflation where it is on;
* ``'woodbury'``: batched CG on the misfit-free operator against
  ``[g, J_misfit^T]``, the rank-K Sherman-Morrison-Woodbury correction, the
  deflation preconditioner (or a Levenberg floor without it) and the warm
  start from the previous step's solutions;
* ``'normal'``: the exact normal matrix from the interior block of the
  kernel inverse, computed once per factorization by column-sharded kernel
  solves and one ``all_gather``.

Every step goes through the damped update (``:898-944``): a step that is
non-finite or more than doubles the loss is halved up to four times and the
best finite trial kept. Quality checks run eagerly (``defer_quality`` and
its pending device scalars are not ported). The CG loop reads one boolean
on the host per iteration, as the dense path's does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from ..models.spec import CollocationProblem
from ..ops.linalg import spd_inverse, spd_solve
from ..parallel import comm
from ..parallel.cholesky import (
    BlockCyclicFactor,
    _chol_sharded,
    kernel_solve_blockcyclic,
    matvec_blockcyclic,
    trsm_blockcyclic,
)
from ..parallel.fused import assemble_factor_fused, sampled_row_quality
from ..parallel.gram import assemble_gram_sharded
from ..parallel.mesh import Mesh
from .gn import (
    QUALITY_TOL,
    GNState,
    _batched_cg,
    _block_diagonals,
    _misfit_jacobi_precond,
    _misfit_jacobians,
    _normal_op,
    _probe_vec,
    _slice_structure,
    _woodbury_correct,
    _woodbury_pieces,
    identity_slice_rows,
    validate_slice_structure,
)
from .posterior import Posterior


@dataclasses.dataclass
class DistributedFactoredProblem:
    """A problem plus its block factors in the mesh path's layout (``:93``).

    ``factors[name]`` factors ``D^{-1/2} (Theta + s nug) D^{-1/2}`` with
    ``col_scales[name] = d^{-1/2}``; ``nugget_scales[name]`` is the scale
    ``s`` the accepted factor used and ``rungs[name]`` the tenfold
    escalations it took. ``quality[name]`` is the accepted factor's probe
    residual and ``stats[name]`` counts its factorization ``attempts`` and
    the ``superblocks`` computed over them (the fused path).
    """

    problem: CollocationProblem
    factors: Dict[str, BlockCyclicFactor]
    col_scales: Dict[str, torch.Tensor]
    nugget_scales: Dict[str, float]
    rungs: Dict[str, int]
    quality: Dict[str, float]
    stats: Dict[str, dict]

    @property
    def mesh(self) -> Mesh:
        return next(iter(self.factors.values())).mesh

    def agree(self, value, op: str):
        """A host read made the same on every rank (``comm.agree``)."""
        return comm.agree(self.mesh, value, op)

    def _scale(self, name: str, v: torch.Tensor) -> torch.Tensor:
        s = self.col_scales[name]
        return v * (s if v.dim() == 1 else s[:, None])

    def whiten(self, name: str, v: torch.Tensor, shard_cols: bool = False) -> torch.Tensor:
        """``L~^{-1} D^{-1/2} v`` (a vector or columns; with ``shard_cols``,
        this rank's own columns)."""
        return trsm_blockcyclic(self.factors[name], self._scale(name, v), shard_cols=shard_cols)

    def kernel_solve(self, name: str, v: torch.Tensor, shard_cols: bool = False) -> torch.Tensor:
        """``Theta^{-1} v`` through the equilibrated factor."""
        return self._scale(name, kernel_solve_blockcyclic(self.factors[name], self._scale(name, v),
                                                          shard_cols=shard_cols))

    def theta_apply(self, name: str, V: torch.Tensor) -> torch.Tensor:
        """``Theta_reg V = D^{1/2} L~ L~^T D^{1/2} V`` by two triangular
        products (``_theta_apply_mat``, ``:474``): across ranks a ``psum``
        and the re-interleaving ``all_gather``."""
        fac, s = self.factors[name], self.col_scales[name][:, None]
        layout = (fac.local, fac.mesh, fac.axis, fac.block)
        LtV = matvec_blockcyclic(*layout, V / s, trans=True)
        return matvec_blockcyclic(*layout, LtV, n=fac.n) / s

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


def factorize_distributed(
    problem: CollocationProblem,
    mesh: Mesh,
    nugget: float,
    nugget_type: str = "adaptive",
    axis: str = "p",
    block: int = 256,
    quality_tol: Optional[float] = None,
    max_attempts: int = 8,
    guard: bool = True,
    chunk_cols: int = 4096,
    fused: bool = True,
    start_scales: Optional[Dict[str, float]] = None,
    superblock_cols: int = 2048,
) -> DistributedFactoredProblem:
    """Assemble and factor every GP block with the failure ladder (``:135``).

    ``fused=True``: :func:`..parallel.fused.assemble_factor_fused` (which
    escalates tenfold itself while a superblock diagonal fails), then the
    sampled-row probe. ``fused=False``: the two-pass path, the whole
    equilibrated matrix (one K2 launch), a probe matvec against it, then its
    factorization in place. Either way a factor whose probe residual is not
    finite and below ``quality_tol`` (default ``QUALITY_TOL``) escalates the
    nugget tenfold and is factored again, for at most ``max_attempts``
    (``guard=False``: one attempt, no probe). The escalation starts at
    ``max(1, 4 eps / nugget)`` or the block's ``start_scales`` entry.
    """
    if problem.device != mesh.device:
        raise ValueError(f"the problem lies on {problem.device}, the mesh on {mesh.device}")
    quality_tol = QUALITY_TOL if quality_tol is None else quality_tol
    factors, col_scales, scales, rungs, quality, stats = {}, {}, {}, {}, {}, {}
    eps = torch.finfo(problem.dtype).eps
    for b in problem.blocks:
        s = s0 = max(1.0, (4.0 * eps) / max(nugget, 1e-300), (start_scales or {}).get(b.name, 1.0))
        fac = None
        q, attempts, superblocks = math.nan, 0, 0
        for _ in range(max_attempts if guard else 1):
            # no reference to a failed attempt's factor survives into the next one
            fac = res = arranged = lower = None
            if fused:
                res = assemble_factor_fused(
                    b.kernel, b.observables, problem.points, mesh, axis=axis, block=block,
                    nugget=nugget, nugget_type=nugget_type, nugget_scale=s,
                    chunk_cols=chunk_cols, superblock_cols=superblock_cols,
                )
                fac, d_isqrt, s = res.factor, res.d_isqrt, res.scale
                attempts += res.attempts
                superblocks += res.superblocks
                if not res.ok:
                    raise FloatingPointError(
                        f"block {b.name!r}: fused factorization still non-finite after "
                        f"nugget escalation to {s:g}x"
                    )
                if not guard:
                    break
                q = sampled_row_quality(fac, b.kernel, b.observables, problem.points, d_isqrt)
            else:
                arranged, d_isqrt = assemble_gram_sharded(
                    b.kernel, b.observables, problem.points, mesh, axis=axis, block=block,
                    nugget=nugget, nugget_type=nugget_type, nugget_scale=s,
                )
                attempts += 1
                n_pad = arranged.shape[2]
                if guard:  # against the matrix, before the factorization overwrites it
                    v = _probe_vec(n_pad, arranged.dtype, arranged.device)
                    y = matvec_blockcyclic(arranged, mesh, axis, block, v, n=n_pad)
                lower, winvs = _chol_sharded(arranged, mesh, axis, block)
                fac = BlockCyclicFactor(lower, mesh, axis, block, int(d_isqrt.shape[0]),
                                        n_pad, winvs)
                if not guard:
                    break
                w = matvec_blockcyclic(
                    lower, mesh, axis, block,
                    matvec_blockcyclic(lower, mesh, axis, block, v, trans=True, n=n_pad), n=n_pad,
                )
                q = comm.agree(mesh, float(torch.max(torch.abs(w - y)) / torch.max(torch.abs(y))),
                               "max")
            if math.isfinite(q) and q < quality_tol:
                break
            s *= 10.0  # finite but corrupt: escalate anyway
        else:
            raise FloatingPointError(
                f"block {b.name!r}: the mesh factorization failed the quality probe "
                f"after nugget escalation to {s / 10.0:g}x"
            )
        factors[b.name] = fac
        col_scales[b.name] = d_isqrt
        scales[b.name] = s
        rungs[b.name] = round(math.log10(s / s0))
        quality[b.name] = q
        stats[b.name] = {"attempts": attempts, "superblocks": superblocks}
    return DistributedFactoredProblem(problem, factors, col_scales, scales, rungs, quality, stats)


# --------------------------------------------------------------------------
# the Gauss-Newton steps
# --------------------------------------------------------------------------


def _linearize_blocks(fp: DistributedFactoredProblem, z):
    """Per GP block ``(name, F, jvp, vjp)`` of its raw residual at ``z``."""
    p = fp.problem
    lins = []
    for b in p.blocks:
        def f(zz, _b=b):
            return _b.residual(zz, p.data)

        F, jvp = torch.func.linearize(f, z)
        vjp = torch.func.vjp(f, z)[1]
        lins.append((b.name, F, jvp, vjp))
    return lins


def _gradient(fp: DistributedFactoredProblem, lins, z):
    """``J^T r``: the GP blocks' ``J_b^T Theta_b^{-1} F_b`` plus the misfits'
    weighted gradients."""
    g = torch.zeros_like(z)
    for name, F, _, vjp in lins:
        g = g + vjp(fp.kernel_solve(name, F))[0]
    if fp.problem.misfits:
        U, wvec, Fm = _woodbury_pieces(fp.problem, z)
        g = g + U @ (wvec * Fm)
    return g


def _h0_mat(fp: DistributedFactoredProblem, lins, hessian_jitter):
    """The misfit-free normal operator ``V -> (J^T J)_GP V (+ jitter V)``
    on (m, k) panels: per block one batched JVP, one multi-column kernel
    solve, one batched VJP (``:562``)."""

    def H0(V):
        out = hessian_jitter * V if hessian_jitter else torch.zeros_like(V)
        for name, _, jvp, vjp in lins:
            JV = torch.func.vmap(jvp, in_dims=1, out_dims=1)(V)
            KJV = fp.kernel_solve(name, JV)
            out = out + torch.func.vmap(lambda c, _v=vjp: _v(c)[0], in_dims=1, out_dims=1)(KJV)
        return out

    return H0


def _deflation_basis(fp: DistributedFactoredProblem, structure, id_rows, rank: int):
    """The smooth-mode basis of the Krylov steps (``:598``): ``rank``
    Gaussian probes (a ``torch.Generator`` seeded with 17 on the device)
    pushed through the prior restricted to the identity rows,
    ``S Theta S^T``, then orthonormalized by QR."""
    p, (_, N, _) = fp.problem, structure
    m = p.latent_dim
    r = min(rank, m)
    kw = dict(dtype=p.dtype, device=p.device)
    gen = torch.Generator(device=p.device).manual_seed(17)
    Om = torch.randn((m, r), generator=gen, **kw)
    Y = torch.zeros((m, r), **kw)
    for bi, b in enumerate(p.blocks):
        live = [(j, off) for j, (bj, off) in enumerate(id_rows) if bj == bi]
        if not live:
            continue
        E = torch.zeros((fp.factors[b.name].n, r), **kw)
        for j, off in live:
            E[off : off + N] = Om[j * N : (j + 1) * N]
        TY = fp.theta_apply(b.name, E)
        for j, off in live:
            Y[j * N : (j + 1) * N] = TY[off : off + N]
    return torch.linalg.qr(Y).Q


def _largest_eigenvalue(op, g):
    """Estimate of the largest eigenvalue of the SPD operator ``op`` (on
    (m, k) panels): four power iterations from ``g`` (``:642-648``, ``:775-781``)."""
    tiny = torch.finfo(g.dtype).tiny
    v = g / (torch.linalg.vector_norm(g) + tiny)
    lam = torch.ones((), dtype=g.dtype, device=g.device)
    for _ in range(4):
        hv = op(v[:, None])[:, 0]
        lam = torch.linalg.vector_norm(hv)
        v = hv / (lam + tiny)
    return lam


def _deflated_precond(op, g, V):
    """Two-level preconditioner of one step's operator (``:632``): the
    ``(r, r)`` projection ``V^T op(V)`` inverted on the smooth subspace,
    ``1/gamma`` on the rest, ``gamma`` a tenth of the largest eigenvalue
    from four power iterations from ``g``:
    ``M = V T^{-1} V^T + (I - V V^T) / gamma``."""
    Ti = spd_inverse(V.T @ op(V))
    gamma = _largest_eigenvalue(op, g) / 10.0

    def M(R):
        xv = V.T @ R
        return V @ (Ti @ xv) + (R - V @ xv) / gamma

    return M


def _cg_delta(fp, z, V_defl, hessian_jitter, cg_tol, cg_maxiter, exit_agree):
    """The ``'cg'`` step (``:660``): matrix-free CG on ``J^T J``;
    preconditioned by the deflation when ``V_defl`` is given, else by the
    misfits' Jacobi diagonal (none without misfits)."""
    p = fp.problem
    lins = _linearize_blocks(fp, z)
    g = _gradient(fp, lins, z)
    H0 = _h0_mat(fp, lins, hessian_jitter)
    mis = []
    for m in p.misfits:
        def f(zz, _m=m):
            return _m.residual(zz, p.data)

        mis.append((m.weight, _normal_op(torch.func.linearize(f, z)[1], torch.func.vjp(f, z)[1], 0.0)))

    def normal_op(V):
        out = H0(V)
        for w, op in mis:
            out = out + w * op(V)
        return out

    M = _deflated_precond(normal_op, g, V_defl) if V_defl is not None else (
        _misfit_jacobi_precond(p, z)
    )
    X, iters = _batched_cg(normal_op, g[:, None], cg_tol, cg_maxiter, M=M, exit_agree=exit_agree)
    return X[:, 0], iters


def _woodbury_delta(fp, z, X0, V_defl, hessian_jitter, cg_tol, cg_maxiter, exit_agree):
    """The ``'woodbury'`` step (``:712``): batched CG on the misfit-free
    operator ``H0`` against ``[g, U]``, warm-started from ``X0`` (the
    previous step's solutions, or zero), then the rank-K correction.

    With the deflation basis the preconditioned CG converges the inner
    solves; without it the inner operator is floored at
    ``lambda = hessian_jitter`` or ``256 eps lambda_max`` (four power
    iterations), a Levenberg-Marquardt step the outer loop absorbs. A
    non-finite panel is replaced by zeros so that it does not poison the
    next warm start. The capacitance solve takes ``hessian_jitter``, the
    rule of the dense path (fault R4: the JAX package's mesh path passes
    0.0 there). Returns ``(delta, iterations, X)``."""
    lins = _linearize_blocks(fp, z)
    g = _gradient(fp, lins, z)
    H0 = _h0_mat(fp, lins, hessian_jitter)
    if V_defl is not None:
        M, Hop = _deflated_precond(H0, g, V_defl), H0
    else:
        M = None
        if hessian_jitter:
            lam = hessian_jitter
        else:
            lam = 256.0 * torch.finfo(z.dtype).eps * _largest_eigenvalue(H0, g)

        def Hop(V):
            return H0(V) + lam * V

    U, wvec, _ = _woodbury_pieces(fp.problem, z)
    X, iters = _batched_cg(Hop, torch.cat([g[:, None], U], dim=1), cg_tol, cg_maxiter, M=M, X0=X0,
                           exit_agree=exit_agree)
    X = torch.where(torch.isfinite(X).all(), X, torch.zeros_like(X))
    return _woodbury_correct(X, U, wvec, hessian_jitter), iters, X


def _normal_state(fp: DistributedFactoredProblem, structure):
    """Per block the ``(s, N, s, N)`` interior block of the regularized
    kernel inverse, ``Theta^{-1}[int, int]`` (``_kernel_inverse_int``,
    ``:415``), by kernel solves on its identity columns, each rank solving
    its ``ceil(sN/P)`` of them (column-sharded), then one ``all_gather``;
    computed once."""
    _, N, seginfo = structure
    mesh, dev = fp.mesh, fp.problem.device
    ainvs = []
    for b, segs in zip(fp.problem.blocks, seginfo):
        live = [off for off, sz in segs if sz == N]
        rows = torch.cat([off + torch.arange(N, device=dev) for off in live])
        width = rows.shape[0]
        wloc = -(-width // mesh.size)
        cols = mesh.rank * wloc + torch.arange(wloc, device=dev)
        mine = cols < width
        E = torch.zeros((fp.factors[b.name].n, wloc), dtype=fp.problem.dtype, device=dev)
        E[rows[cols[mine]], torch.nonzero(mine)[:, 0]] = 1.0
        A = fp.kernel_solve(b.name, E, shard_cols=True)[rows]  # (sN, wloc): my columns
        A = comm.all_gather(mesh, A).permute(1, 0, 2).reshape(width, -1)[:, :width]
        ainvs.append(A.reshape(len(live), N, len(live), N))
    return ainvs


def _normal_delta(fp, z, structure, ainvs, hessian_jitter):
    """The ``'normal'`` step (``:807``): for pointwise-per-slice residuals
    ``H = J_raw^T Theta^{-1} J_raw`` is a sum of elementwise-scaled
    contractions of the interior inverse blocks; the misfits add their
    exact ``w J_m^T J_m``."""
    p = fp.problem
    s_lat, N, seginfo = structure
    m = p.latent_dim
    H = torch.zeros((m, m), dtype=z.dtype, device=z.device)
    lins = _linearize_blocks(fp, z)
    g = _gradient(fp, lins, z)
    for b, segs, A4 in zip(p.blocks, seginfo, ainvs):
        D = torch.stack(_block_diagonals(b.residual, p.data, z, s_lat, N))
        Dl = torch.stack([D[:, off : off + N] for off, sz in segs if sz == N], dim=1)
        rows = []
        for j in range(s_lat):  # one latent slice at a time bounds the temporaries
            Bj = torch.einsum("rq,rqsp->qsp", Dl[j], A4)
            rows.append(torch.einsum("qsp,ksp->qkp", Bj, Dl).reshape(N, m))
        H = H + torch.cat(rows)
    for Jm in _misfit_jacobians(p, z):
        H = H + Jm.T @ Jm
    return spd_solve(H, g, jitter=hessian_jitter)


def _panel_delta(fp, z, structure, hessian_jitter):
    """The ``'direct'`` (``structure=None``) and ``'structured'`` steps
    (``_panel_kernel``, ``:321``). Each rank builds the whitened Jacobian
    panel of its ``mloc = ceil(m/P)`` latent columns (raw columns from JVPs
    of its basis vectors, or from per-slice diagonals; zero past ``m``),
    whitened by the column-sharded solve, and its slice of ``J^T r``. A
    ``ppermute`` ring passes the panels around, each rank filling its
    ``(P mloc, mloc)`` column block of ``J^T J``: the ``n x m`` panel is
    never whole on one rank. One ``all_gather`` makes ``J^T J`` and the
    gradient whole, and every rank does the same SPD solve."""
    p, mesh = fp.problem, fp.mesh
    P_, rank = mesh.size, mesh.rank
    m = p.latent_dim
    mloc = -(-m // P_)
    c0 = rank * mloc  # this rank's live columns are c0 .. c0 + w - 1
    w = max(0, min(mloc, m - c0))
    own = torch.arange(w, device=z.device)
    if structure is None:  # the JVPs' directions: this rank's unit latent vectors
        basis = torch.zeros((mloc, m), dtype=z.dtype, device=z.device)
        basis[own, c0 + own] = 1.0
    J, r = [], []
    for i, b in enumerate(p.blocks):
        F = b.residual(z, p.data)
        if structure is None:
            def jvp(v, _b=b):
                return torch.func.jvp(lambda zz: _b.residual(zz, p.data), (z,), (v,))[1]
            Jcols = torch.func.vmap(jvp, in_dims=0, out_dims=1)(basis)
        else:
            s, N, seginfo = structure
            D = _block_diagonals(b.residual, p.data, z, s, N)
            Jcols = torch.zeros((F.shape[0], mloc), dtype=z.dtype, device=z.device)
            for off, sz in seginfo[i]:
                if sz != N:
                    continue  # boundary rows do not depend on z
                for j in range(s):  # slice j's columns j N .. (j + 1) N - 1, where owned
                    lo, hi = max(j * N, c0), min((j + 1) * N, c0 + w)
                    if lo < hi:
                        q = torch.arange(lo - j * N, hi - j * N, device=z.device)
                        Jcols[off + q, q + (j * N - c0)] = D[j][off + q]
        J.append(fp.whiten(b.name, Jcols, shard_cols=True))
        r.append(fp.whiten(b.name, F))
    J += [torch.nn.functional.pad(Jm[:, c0 : c0 + w], (0, mloc - w))
          for Jm in _misfit_jacobians(p, z)]
    r += [math.sqrt(m_.weight) * m_.residual(z, p.data) for m_ in p.misfits]
    J, r = torch.cat(J), torch.cat(r)
    Hcol = J.new_zeros((P_ * mloc, mloc))
    R = J
    for t in range(P_):  # after t hops this rank holds the panel of rank p - t
        src = (rank - t) % P_
        Hcol[src * mloc : (src + 1) * mloc] = R.T @ J
        if t + 1 < P_:
            R = comm.ppermute(mesh, R)
    H = comm.all_gather(mesh, Hcol).permute(1, 0, 2).reshape(P_ * mloc, P_ * mloc)
    g = comm.all_gather(mesh, J.T @ r).reshape(-1)
    pad = torch.arange(m, P_ * mloc, device=z.device)
    H[pad, pad] += 1.0  # the padded latent tail: zero columns, a unit diagonal
    return spd_solve(H, g, jitter=hessian_jitter)[:m]


def _damped_update(fp, z, delta, loss_in, step_size):
    """The guarded update (``:911``): the full step unless it is non-finite
    or more than doubles ``loss_in``; then halved up to four times, keeping
    the best finite trial. Returns ``(z, loss, finite)``; a step with no
    finite trial keeps ``z`` and ``loss_in``. Every test reads the values
    the ranks agree on (rank 0's losses)."""
    big = torch.tensor(torch.finfo(z.dtype).max, dtype=z.dtype, device=z.device)

    def value(t):
        return fp.agree(float(t), "first")

    def trial(s):
        z_t = z - (s * step_size) * delta
        if not fp.agree(bool(torch.isfinite(z_t).all()), "all"):
            return z, big, False
        r = fp.whitened_residual(z_t)
        return z_t, torch.dot(r, r), True

    s = 1.0
    z_b, l_b, f_b = trial(s)
    for _ in range(4):
        if not value(l_b) > 2.0 * value(loss_in):
            break
        s *= 0.5
        z2, l2, f2 = trial(s)
        if value(l2) < value(l_b):
            z_b, l_b, f_b = z2, l2, f_b or f2
    if not f_b:
        return z, loss_in, False
    return z_b, l_b, True


def _any_anisotropic(p: CollocationProblem) -> bool:
    return any(len(set(b.kernel.inv_sq)) > 1 for b in p.blocks)


def _auto_normal_budget(fp: DistributedFactoredProblem) -> int:
    """Bytes the ``'normal'`` step's replicated state may take (``:1011``):
    three quarters of the card's free memory (``torch.cuda.mem_get_info``,
    which already counts the factors), the least over the ranks (ranks that
    share a card see it differently); 10 GiB on the CPU, the JAX package's
    default without memory statistics."""
    dev = fp.problem.device
    if dev.type != "cuda":
        return 10 << 30
    free, _ = torch.cuda.mem_get_info(dev)
    return int(fp.agree(max(0, int(0.75 * free)), "min"))


def _normal_state_bytes(fp: DistributedFactoredProblem, structure, dtype) -> int:
    """Bytes of the ``'normal'`` step's state beyond the factors
    (``:1032``): the interior inverse blocks, the normal matrix and its
    solve's copy, and the slice contractions' temporaries."""
    _, N, seginfo = structure
    m = fp.problem.latent_dim
    total = 2 * m * m + m * N
    for segs in seginfo:
        s_b = sum(1 for _, sz in segs if sz == N)
        total += (s_b * N) ** 2 + s_b * N * N
    return total * torch.finfo(dtype).bits // 8


def default_deflation_rank(m: int) -> int:
    """The deflation basis's default width at latent dimension ``m``
    (``:1194-1196``): the kernel's effective-rank scale."""
    return min(768, max(32, m // 4))


def route_step_solver(fp: DistributedFactoredProblem, step_solver: str = "auto",
                      direct_panel_limit: int = 4096, normal_budget_bytes: Optional[int] = None):
    """``(solver, structure, candidate, valid)``: the step solver that
    ``step_solver`` resolves to (``'auto'``: see :func:`gn_solve_distributed`,
    ``:1116-1165``), the slice structure it uses (or ``None``), and the
    problem's candidate structure and whether it validated."""
    p = fp.problem
    if step_solver not in ("auto", "structured", "direct", "cg", "woodbury", "normal"):
        raise ValueError(f"unknown step_solver {step_solver!r}")
    if step_solver == "woodbury" and not p.misfits:
        raise ValueError(
            "step_solver='woodbury' is the misfit-coupled step; this problem has no "
            "misfit terms (use 'cg' or 'direct')"
        )
    cand = _slice_structure(p)
    valid = fp.agree(cand is not None and validate_slice_structure(p, cand), "all")
    if step_solver in ("structured", "normal"):
        if not valid:
            raise ValueError(
                f"step_solver={step_solver!r} requires pointwise-per-slice residuals "
                "(structure validation failed for this problem)"
            )
        return step_solver, cand, cand, valid
    if step_solver != "auto":
        return step_solver, None, cand, valid
    mloc = -(-p.latent_dim // fp.mesh.size)
    if mloc <= direct_panel_limit:
        return ("structured", cand, cand, valid) if valid else ("direct", None, cand, valid)
    aniso = _any_anisotropic(p)
    budget = _auto_normal_budget(fp) if normal_budget_bytes is None else normal_budget_bytes
    if p.misfits and valid and not aniso:
        return "woodbury", None, cand, valid
    if valid and aniso and _normal_state_bytes(fp, cand, p.dtype) <= budget:
        return "normal", cand, cand, valid
    return ("woodbury" if p.misfits else "cg"), None, cand, valid


def gn_solve_distributed(
    fp: DistributedFactoredProblem,
    z0: Optional[torch.Tensor] = None,
    max_iter: int = 8,
    step_size: float = 1.0,
    step_solver: str = "auto",
    hessian_jitter: float = 0.0,
    cg_tol: Optional[float] = None,
    cg_maxiter: Optional[int] = None,
    direct_panel_limit: int = 4096,
    tol: Optional[float] = None,
    normal_budget_bytes: Optional[int] = None,
    deflation_rank: Optional[int] = None,
) -> GNState:
    """Up to ``max_iter`` Gauss-Newton steps on the mesh path (``:1047``).

    ``step_solver='auto'`` (``:1116-1165``) keys on the panel width
    ``ceil(m / P)`` (here ``m``): at most ``direct_panel_limit``, the
    ``'structured'`` panel when the pointwise-slice structure validates,
    else ``'direct'``; past it, ``'woodbury'`` for an isotropic problem with
    misfits, ``'normal'`` for an anisotropic one whose state fits
    ``normal_budget_bytes`` (default :func:`_auto_normal_budget`), else
    ``'woodbury'`` with misfits and ``'cg'`` without.

    The deflation basis (``deflation_rank``, default
    ``min(768, max(32, m/4))``; 0 turns it off) serves ``'woodbury'``
    always and ``'cg'`` on anisotropic kernels or when ``deflation_rank``
    is given, wherever the identity-row map exists. ``cg_tol`` defaults to
    1e-10 in f64 and 1e-6 in f32, ``cg_maxiter`` to 500; ``cg_iters``
    reports each step's inner iterations.

    ``tol``: stop once ``|loss_prev - loss| <= tol * loss`` (after at least
    two steps), or after a step with no finite trial; untaken iterations
    repeat the last loss.
    """
    p = fp.problem
    z = (p.init_latent() if z0 is None else torch.as_tensor(z0)).to(device=p.device, dtype=p.dtype)
    m = p.latent_dim
    step_solver, structure, cand, valid = route_step_solver(
        fp, step_solver, direct_panel_limit, normal_budget_bytes
    )
    V_defl = None
    wants = step_solver == "woodbury" or (
        step_solver == "cg" and (_any_anisotropic(p) or deflation_rank)
    )
    if wants and valid and deflation_rank != 0:
        id_rows = identity_slice_rows(p, cand)
        if fp.agree(id_rows is not None, "all"):
            rank = default_deflation_rank(m) if deflation_rank is None else int(deflation_rank)
            V_defl = _deflation_basis(fp, cand, id_rows, rank)
    if cg_tol is None:
        cg_tol = 1e-10 if torch.finfo(p.dtype).eps < 1e-10 else 1e-6
    cg_maxiter = 500 if cg_maxiter is None else int(cg_maxiter)
    ainvs = _normal_state(fp, structure) if step_solver == "normal" else None
    kw = dict(hessian_jitter=hessian_jitter, cg_tol=cg_tol, cg_maxiter=cg_maxiter,
              exit_agree=lambda stop: fp.agree(stop, "all"))

    Xw = None  # the woodbury warm start: the previous step's inner solutions
    loss = fp.loss(z)
    ok = True
    losses, cg_iters = [], []
    prev = cur = math.inf
    for i in range(int(max_iter)):
        if tol is not None and (not ok or (i >= 2 and abs(prev - cur) <= tol * max(
                cur, torch.finfo(p.dtype).tiny))):
            break
        iters = 0
        if step_solver == "cg":
            delta, iters = _cg_delta(fp, z, V_defl, **kw)
        elif step_solver == "woodbury":
            delta, iters, Xw = _woodbury_delta(fp, z, Xw, V_defl, **kw)
        elif step_solver == "normal":
            delta = _normal_delta(fp, z, structure, ainvs, hessian_jitter)
        else:
            delta = _panel_delta(fp, z, structure if step_solver == "structured" else None,
                                 hessian_jitter)
        z, loss, finite = _damped_update(fp, z, delta, loss, step_size)
        ok = ok and finite
        losses.append(loss)
        cg_iters.append(iters)
        prev, cur = cur, fp.agree(float(loss), "first")
    losses = torch.stack(losses) if losses else torch.zeros(0, dtype=p.dtype, device=p.device)
    if losses.shape[0] < max_iter:
        losses = torch.cat([losses, losses[-1:].expand(int(max_iter) - losses.shape[0])])
    cg_iters = torch.tensor(cg_iters + [0] * (int(max_iter) - len(cg_iters)), dtype=torch.int64)
    return GNState(z=z, losses=losses, converged_finite=torch.tensor(ok, device=p.device),
                   cg_iters=cg_iters, step_solver=step_solver,
                   deflation_rank=0 if V_defl is None else int(V_defl.shape[1]))


class DistributedPosterior(Posterior):
    """Posterior means and variances on the mesh path (``:1442``).

    The representer weights ``Theta^{-1} F(z*)`` come from the factor's
    triangular solves (``_block_weights_dist``, ``:1314``), on every rank.
    ``extend`` and ``variance`` are the dense :class:`~.posterior.Posterior`'s
    on sharded test points (``_dist_extend``, ``:1340``; ``_dist_variance``,
    ``:1385``): each rank takes ``ceil(t/P)`` of them (the last point
    repeated to fill), extends them chunk by chunk, one K1 cross-Gram launch a
    chunk (``variance``: whitens each chunk's cross-Gram by the column-sharded
    solve), and one ``all_gather`` gives every rank the whole result. At
    P = 1 the one rank's share is every point, and the gather is the
    identity. The prior term of ``variance`` is the *unregularized*
    ``(op (x) op) kappa(x, x)``, the value the JAX package computes, whose
    docstring says "nugget-regularized" (fault R5).
    """

    def _my_points(self, X_test):
        mesh = self.fp.mesh
        X_test = X_test.to(device=self.fp.problem.device, dtype=self.fp.problem.dtype)
        t = int(X_test.shape[0])
        tloc = -(-t // mesh.size)
        idx = torch.clamp(mesh.rank * tloc + torch.arange(tloc, device=X_test.device), max=t - 1)
        return X_test[idx].contiguous(), t

    def _gathered(self, y, t):
        return comm.all_gather(self.fp.mesh, y).reshape(-1)[:t]

    def _whiten(self, name, C):
        return self.fp.whiten(name, C, shard_cols=True)

    def extend(self, X_test, block=None, op=None):
        mine, t = self._my_points(X_test)
        return self._gathered(super().extend(mine, block, op), t)

    def variance(self, X_test, block=None, op=None):
        mine, t = self._my_points(X_test)
        return self._gathered(super().variance(mine, block, op), t)
