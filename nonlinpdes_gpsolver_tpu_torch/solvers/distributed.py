"""The mesh path across P ranks: fused factorization, Gauss-Newton and posterior.

Counterpart of ``nonlinpdes_gpsolver_tpu/solvers/distributed.py``, the path
past the dense wall, on the skeleton of ``solvers/gn.py`` (the
factored-problem contract, the nugget ladder, the Gauss-Newton driver and
its recorded loop). What is the mesh path's own:

* :func:`factorize_distributed`: per GP block the equilibrated factor from
  the fused assemble-and-factorize (``parallel/fused.py``: K2 strips
  straight into the factor's panels; the Gram matrix never exists) or the
  two-pass path, each rank holding its block-cyclic rows, whose solves
  (``parallel/cholesky.py``) are :class:`DistributedFactoredProblem`'s
  ``whiten`` and ``kernel_solve``; its verdicts are agreed over the ranks
  before the one read;
* :func:`route_step_solver` and the five step solvers with their guards
  (below), whose state (the deflation basis, the ``'normal'`` blocks) is
  computed again for each problem a shared loop serves;
* the damped update (``:898-944``): a step that is non-finite or more than
  doubles the loss is halved up to four times and the best finite trial
  kept. The full step and its tests run on the device; the host reads
  once a step whether it must halve (:func:`_read_code`, which also says
  whether a ``tol`` stop came), and only then runs the halvings, with
  their tests on the device too;
* :class:`DistributedPosterior`.

Every rank runs the same loop on its own device; latent-sized quantities
(``z``, the gradient, the Krylov vectors) are replicated, the factor's
solves and the panels sharded by column bring the ranks together. The
loop is recorded with its collectives inside at P = 1 and across NCCL
ranks (:func:`_records`; the JAX package's loop is one compiled region at
every P). Each flag the host reads in it is agreed across the ranks on
the device, inside the step (``parallel/comm.py::agree_device``); a read
that routes or probes, outside the loop, is agreed on the host
(``parallel/comm.py::agree``). Either way no rank leaves a loop another
stays in. The steps (``:516-1008``):

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
  kernel inverse, computed once per factorization: at P = 1 from the
  interior columns of the factor's inverse and one symmetric product
  (``potri``'s order), across ranks by column-sharded kernel solves and one
  ``all_gather``. The current record times that state
  (``gauss_newton.normal_state``) and each step (``gauss_newton.normal_step``,
  summed) by CUDA events, as it times the phases.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional

import torch

from ..models.spec import CollocationProblem
from ..ops import normal_matrix
from ..ops.linalg import (ESCALATION, MAX_ESCALATIONS, QUALITY_TOL, accepted, equilibrated_solve,
                          escalation_start, probe_vector, rungs_climbed, spd_inverse, spd_solve)
from ..parallel import comm
from ..parallel.cholesky import (
    BlockCyclicFactor,
    _chol_sharded,
    kernel_solve_blockcyclic,
    matvec_blockcyclic,
    pad_to_blocks,
    trsm_blockcyclic,
)
from ..parallel.fused import assemble_factor_fused, sampled_row_quality
from ..parallel.gram import assemble_gram_sharded
from ..parallel.mesh import Mesh
from ..ops import graphs
from ..ops.graphs import Flag
from ..utils import tracing
from . import _reuse
from .gn import (
    GNState,
    _block_diagonals,
    _Carry,
    _check_step_solver,
    _Factored,
    _gauss_newton,
    _linear_ops,
    _Loop,
    _misfit_jacobi_precond,
    _misfit_jacobians,
    _normal_op,
    _slice_structure,
    _woodbury_correct,
    _woodbury_pieces,
    identity_slice_rows,
    validate_slice_structure,
)
from .posterior import Posterior


@dataclasses.dataclass
class DistributedFactoredProblem(_Factored):
    """A problem plus its block factors in the mesh path's layout (``:93``).

    ``factors[name]`` factors ``D^{-1/2} (Theta + s nug) D^{-1/2}`` with
    ``col_scales[name] = d^{-1/2}``; ``nugget_scales[name]`` is the scale
    ``s`` the accepted factor used and ``rungs[name]`` the tenfold
    escalations it took. ``quality[name]`` is the accepted factor's probe
    residual (:class:`.gn._Factored`) and ``stats[name]`` counts its
    factorization ``attempts`` and the ``superblocks`` computed over them
    (the fused path). ``entry`` and ``graphs`` are
    :class:`.gn.FactoredProblem`'s.
    """

    problem: CollocationProblem
    factors: Dict[str, BlockCyclicFactor]
    col_scales: Dict[str, torch.Tensor]
    nugget_scales: Dict[str, float]
    rungs: Dict[str, int]
    quality: Dict[str, float]
    stats: Dict[str, dict]
    graphs: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)
    entry: object = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def mesh(self) -> Mesh:
        return next(iter(self.factors.values())).mesh

    def agree(self, value, op: str):
        """A host read made the same on every rank (``comm.agree``)."""
        return comm.agree(self.mesh, value, op)

    def resolve_pending(self, extra=()):
        """The shared read of the deferred verdicts
        (:meth:`.gn._Factored.resolve_pending`), the values agreed on the
        device first: each verdict the largest over the ranks and each of
        ``extra`` rank 0's, so that every rank reads the same and a redo
        happens on all of them or on none."""
        mesh = self.mesh
        self.quality = {n: comm.agree_device(mesh, q, "max") if torch.is_tensor(q) else q
                        for n, q in self.quality.items()}
        return super().resolve_pending([comm.agree_device(mesh, t, "first") for t in extra])

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


def factorize_distributed(
    problem: CollocationProblem,
    mesh: Mesh,
    nugget: float,
    nugget_type: str = "adaptive",
    axis: str = "p",
    block: int = 256,
    quality_tol: Optional[float] = None,
    max_attempts: int = MAX_ESCALATIONS,
    guard: bool = True,
    chunk_cols: int = 4096,
    fused: bool = True,
    start_scales: Optional[Dict[str, float]] = None,
    superblock_cols: int = 2048,
    defer_quality: bool = False,
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
    ``max(1, 4 eps / nugget)`` or the block's ``start_scales`` entry if
    larger; ``rungs`` counts from the former (the ladder of
    ``ops/linalg.py``).

    ``defer_quality`` (``:176-240``): one attempt a block, and the probe's
    verdict stays on the device in ``quality`` for the caller to read with its results and, on a failed verdict, to
    factor again with escalated ``start_scales`` (:class:`..api.GPSolver`).
    The fused path's superblock ladder keeps its host reads: it escalates
    the non-finite class inside the call, as the JAX package's executable
    does.

    Where the loop is recorded (:func:`_records`), either path factors
    into the storage of a released problem of the same layout, whose
    recorded loop then serves this one (``solvers/_reuse.py``). The two
    store the same tensors in the same layout, so they share one key, as
    the JAX package's loop serves the factors of either. Across ranks the
    key holds the mesh (its size, this rank and the group), and the ranks
    agree on the entry they take.
    """
    if problem.device != mesh.device:
        raise ValueError(f"the problem lies on {problem.device}, the mesh on {mesh.device}")
    with tracing.span("factorize.bind"):
        key = mesh_key(problem, mesh, axis, block)
    with _reuse.claimed(key, mesh) as entry:
        dfp = _factorize_blocks(problem, mesh, nugget, nugget_type, axis, block, quality_tol,
                                max_attempts, guard, chunk_cols, fused, start_scales,
                                superblock_cols, defer_quality,
                                entry.outputs() if entry is not None else {})
        with tracing.span("factorize.bind"):
            _reuse.settle(dfp, key, entry, mesh_tensors(dfp),
                          functools.partial(mesh_view, mesh=mesh, axis=axis, block=block),
                          mesh_storage, mesh)
    return dfp


def mesh_key(problem: CollocationProblem, mesh: Mesh, axis: str, block: int):
    """The layout key of the fused factor's storage on ``mesh``
    (``solvers/_reuse.py``), or ``None`` where the loop is not shared
    (:func:`_records`)."""
    if not _records(mesh):
        return None
    return _reuse.layout_key(problem, mesh_roles(problem, mesh, block), (mesh, axis, block))


def mesh_roles(problem: CollocationProblem, mesh: Mesh, block: int) -> Dict[str, tuple]:
    """Per block the stored tensors of a fused factor, as ``((role,
    shape), ...)`` (``solvers/_reuse.py``): this rank's rows, the
    diagonal-block inverses and the column scales."""
    out = {}
    for b in problem.blocks:
        n = sum(int(problem.points[o.points].shape[0]) for o in b.observables)
        n_pad = pad_to_blocks(n, block, mesh.size)
        nb = n_pad // block
        out[b.name] = (("local", (nb // mesh.size, block, n_pad)),
                       ("diag_inv", (nb, block, block)), ("d", (n,)))
    return out


def mesh_storage(roles: tuple, dtype, device) -> Dict[str, torch.Tensor]:
    """New storage of one block's :func:`mesh_roles`, contiguous as the
    fused path makes it."""
    return {role: torch.empty(shape, dtype=dtype, device=device) for role, shape in roles}


def mesh_tensors(dfp: DistributedFactoredProblem) -> Dict[str, Dict[str, torch.Tensor]]:
    """``dfp``'s stored tensors by block and role (:func:`mesh_roles`)."""
    return {name: {"local": f.local, "diag_inv": f.diag_inv, "d": dfp.col_scales[name]}
            for name, f in dfp.factors.items()}


def mesh_view(problem: CollocationProblem, tensors, mesh: Mesh, axis: str,
              block: int) -> DistributedFactoredProblem:
    """The factored problem an entry's loops run on, made of its storage
    (``solvers/_reuse.py``)."""
    return DistributedFactoredProblem(
        problem, {b: BlockCyclicFactor(t["local"], mesh, axis, block, int(t["d"].shape[0]),
                                       int(t["local"].shape[2]), t["diag_inv"])
                  for b, t in tensors.items()},
        {b: t["d"] for b, t in tensors.items()}, {}, {}, {}, {})


def _factorize_blocks(problem, mesh, nugget, nugget_type, axis, block, quality_tol,
                      max_attempts, guard, chunk_cols, fused, start_scales, superblock_cols,
                      defer_quality, out) -> DistributedFactoredProblem:
    """:func:`factorize_distributed`'s ladder, the factors written into
    ``out[block]`` where given (the two-pass path writes into new storage of
    that layout otherwise)."""
    quality_tol = QUALITY_TOL if quality_tol is None else quality_tol
    factors, col_scales, scales, rungs, quality, stats = {}, {}, {}, {}, {}, {}
    s0 = escalation_start(nugget, problem.dtype)
    defer = defer_quality and guard
    roles = mesh_roles(problem, mesh, block)
    for b in problem.blocks:
        buf = out.get(b.name)
        if buf is None and not fused:
            buf = mesh_storage(roles[b.name], problem.dtype, mesh.device)
        s = max(s0, float((start_scales or {}).get(b.name, 1.0)))
        fac = None
        q, attempts, superblocks = math.nan, 0, 0
        for _ in range(max_attempts if guard and not defer else 1):
            # no reference to a failed attempt's factor survives into the next one
            fac = res = arranged = lower = None
            if fused:
                # K2 assembles inside the factorization: one span for both
                with tracing.span("factorize.cholesky"):
                    res = assemble_factor_fused(
                        b.kernel, b.observables, problem.points, mesh, axis=axis, block=block,
                        nugget=nugget, nugget_type=nugget_type, nugget_scale=s,
                        chunk_cols=chunk_cols, superblock_cols=superblock_cols,
                        out=None if buf is None else (buf["local"], buf["diag_inv"], buf["d"]),
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
                with tracing.span("factorize.quality"):
                    q = sampled_row_quality(fac, b.kernel, b.observables, problem.points,
                                            d_isqrt)
            else:
                arranged, d_isqrt = assemble_gram_sharded(
                    b.kernel, b.observables, problem.points, mesh, axis=axis, block=block,
                    nugget=nugget, nugget_type=nugget_type, nugget_scale=s, out=buf["local"],
                )
                d_isqrt = buf["d"].copy_(d_isqrt)
                attempts += 1
                n_pad = arranged.shape[2]
                if guard:  # against the matrix, before the factorization overwrites it
                    v = probe_vector(n_pad, arranged.dtype, arranged.device)
                    y = matvec_blockcyclic(arranged, mesh, axis, block, v, n=n_pad)
                lower, winvs = _chol_sharded(arranged, mesh, axis, block,
                                             diag_inv=buf["diag_inv"])
                fac = BlockCyclicFactor(lower, mesh, axis, block, int(d_isqrt.shape[0]),
                                        n_pad, winvs)
                if not guard:
                    break
                w = matvec_blockcyclic(
                    lower, mesh, axis, block,
                    matvec_blockcyclic(lower, mesh, axis, block, v, trans=True, n=n_pad), n=n_pad,
                )
                q = torch.max(torch.abs(w - y)) / torch.max(torch.abs(y))  # the same on every rank
            if defer:
                break
            q = tracing.read(float, q)
            if accepted(q, quality_tol):
                break
            s *= ESCALATION  # finite but corrupt: escalate anyway
        else:
            raise FloatingPointError(
                f"block {b.name!r}: the mesh factorization failed the quality probe "
                f"after nugget escalation to {s / ESCALATION:g}x"
            )
        factors[b.name] = fac
        col_scales[b.name] = d_isqrt
        scales[b.name] = s
        rungs[b.name] = rungs_climbed(s, s0)
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

        lins.append((b.name, *_linear_ops(f, z)))
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


def _cg_system(fp, z, V_defl, hessian_jitter):
    """The ``'cg'`` step's inner system at ``z`` (``:660``): ``(op, B, M,
    finish)``, matrix-free ``J^T J`` against the gradient, preconditioned by
    the deflation when ``V_defl`` is given, else by the misfits' Jacobi
    diagonal (none without misfits)."""
    p = fp.problem
    lins = _linearize_blocks(fp, z)
    g = _gradient(fp, lins, z)
    H0 = _h0_mat(fp, lins, hessian_jitter)
    mis = []
    for m in p.misfits:
        def f(zz, _m=m):
            return _m.residual(zz, p.data)

        _, jvp, vjp = _linear_ops(f, z)
        mis.append((m.weight, _normal_op(jvp, vjp, 0.0)))

    def normal_op(V):
        out = H0(V)
        for w, op in mis:
            out = out + w * op(V)
        return out

    M = _deflated_precond(normal_op, g, V_defl) if V_defl is not None else (
        _misfit_jacobi_precond(p, z)
    )
    return normal_op, g[:, None], M, lambda X: X[:, 0]


def _woodbury_system(fp, z, V_defl, hessian_jitter):
    """The ``'woodbury'`` step's inner system at ``z`` (``:712``): ``(op, B,
    M, U, wvec)``, the misfit-free operator ``H0`` against ``[g, U]``.

    With the deflation basis the preconditioned CG converges the inner
    solves; without it the inner operator is floored at
    ``lambda = hessian_jitter`` or ``256 eps lambda_max`` (four power
    iterations), a Levenberg-Marquardt step the outer loop absorbs. The
    rank-K correction follows in :func:`_woodbury_finish`."""
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
    return Hop, torch.cat([g[:, None], U], dim=1), M, U, wvec


def _woodbury_finish(X, U, wvec, hessian_jitter):
    """``(delta, X)``: a non-finite panel is replaced by zeros, so that it
    does not poison the next warm start, then the rank-K correction. The
    capacitance solve takes ``hessian_jitter``, the rule of the dense path
    (fault R4: the JAX package's mesh path passes 0.0 there)."""
    X = torch.where(torch.isfinite(X).all(), X, torch.zeros_like(X))
    return _woodbury_correct(X, U, wvec, hessian_jitter), X


def _normal_state(fp: DistributedFactoredProblem, structure):
    """Per block the ``(s, N, s, N)`` interior block of the regularized
    kernel inverse, ``Theta^{-1}[int, int]`` (``_kernel_inverse_int``,
    ``:415``), computed once a factorization: at P = 1 by
    :func:`_interior_inverse_potri`, across ranks by
    :func:`_interior_inverse_solves` (counted in
    ``ops/graphs.py::NORMAL_STATES``)."""
    _, N, seginfo = structure
    potri = fp.mesh.size == 1
    graphs.normal_state_routed("potri" if potri else "solves")
    ainvs = []
    for b, segs in zip(fp.problem.blocks, seginfo):
        live = [off for off, sz in segs if sz == N]
        A = (_interior_inverse_potri if potri else _interior_inverse_solves)(fp, b.name, live, N)
        ainvs.append(A.reshape(len(live), N, len(live), N))
    return ainvs


def _interior_inverse_solves(fp: DistributedFactoredProblem, name: str, live, N: int):
    """``Theta^{-1}[rows, rows]`` for the interior rows ``off .. off + N - 1``
    of each offset in ``live``, by kernel solves on their identity columns,
    each rank solving its ``ceil(width/P)`` of them (column-sharded), then
    one ``all_gather``. The result is mirrored from its lower triangle, as
    :func:`_interior_inverse_potri`'s is: contiguous and exactly symmetric,
    whatever ``width`` is against ``P`` (the gathered columns are padded to
    ``P ceil(width/P)``)."""
    mesh, dev = fp.mesh, fp.problem.device
    rows = torch.cat([off + torch.arange(N, device=dev) for off in live])
    width = rows.shape[0]
    wloc = -(-width // mesh.size)
    cols = mesh.rank * wloc + torch.arange(wloc, device=dev)
    mine = cols < width
    E = torch.zeros((fp.factors[name].n, wloc), dtype=fp.problem.dtype, device=dev)
    E[rows[cols[mine]], torch.nonzero(mine)[:, 0]] = 1.0
    A = fp.kernel_solve(name, E, shard_cols=True)[rows]  # (width, wloc): my columns
    A = comm.all_gather(mesh, A).permute(1, 0, 2).reshape(width, -1)[:, :width].tril()
    return A.add_(A.tril(-1).mT)


def _interior_inverse_potri(fp: DistributedFactoredProblem, name: str, live, N: int):
    """``Theta^{-1}[rows, rows]`` as :func:`_interior_inverse_solves` gives
    it, at P = 1, in LAPACK ``potri``'s order restricted to the interior
    columns: ``Y = L~^{-1} E S`` (``E`` the identity columns of the rows,
    in ascending order, ``S`` their equilibration scales), then ``Y^T Y``.

    Column ``c`` of ``Y`` is zero above its identity row ``r_c``, and both
    stages skip those zeros. The forward stage runs down the factor's row
    blocks (right-looking, the JAX package's block loop over ``diag_inv``):
    block ``k`` takes ``Y_k = W_kk R_k`` for the columns whose identity row
    lies at or above it, then subtracts ``L_{>k,k} Y_k`` from the rows below,
    one product each on strided views of the factor (no copy of it). The
    product stage fills the lower triangle of ``Y^T Y`` by panels of
    ``2 B`` columns, each product over the rows from the panel's first
    identity row, and mirrors it into the upper one, so that the result is
    exactly symmetric. The rows above the first interior row's block are
    never stored; nothing is read on the host."""
    fac, dtype, dev = fp.factors[name], fp.problem.dtype, fp.problem.device
    L, B, n = fac.matrix, fac.block, fac.n
    W = fac.inverses()
    width = len(live) * N
    base = live[0] // B * B  # Y's first stored row
    scale = fp.col_scales[name]
    Y = torch.zeros((n - base, width), dtype=dtype, device=dev)
    for j, off in enumerate(live):  # E S: the scales on the identity rows
        Y[off - base : off - base + N, j * N : (j + 1) * N].diagonal().copy_(scale[off : off + N])
    for k in range(base // B, -(-n // B)):
        lo, hi = k * B, min((k + 1) * B, n)
        c = sum(min(max(hi - off, 0), N) for off in live)  # columns live from here on
        Yk = Y[lo - base : hi - base, :c]
        Yk.copy_(W[k, : hi - lo, : hi - lo] @ Yk)
        if hi < n:
            Y[hi - base :, :c].addmm_(L[hi:n, lo:hi], Yk, alpha=-1.0)
    A = torch.empty((width, width), dtype=dtype, device=dev)
    for c0 in range(0, width, 2 * B):
        c1 = min(c0 + 2 * B, width)
        r0 = live[c0 // N] + c0 % N - base  # the panel's first identity row
        torch.mm(Y[r0:, c0:c1].mT, Y[r0:, :c1], out=A[c0:c1, :c1])
        D = A[c0:c1, c0:c1]
        D.copy_(D.tril() + D.tril(-1).mT)
        A[:c0, c0:c1] = A[c0:c1, :c0].mT
    return A


def _normal_delta(fp, z, structure, ainvs, hessian_jitter):
    """The ``'normal'`` step (``:807``): for pointwise-per-slice residuals
    ``H = J_raw^T Theta^{-1} J_raw`` is a sum of elementwise-scaled
    contractions of the interior inverse blocks; the misfits add their
    exact ``w J_m^T J_m``. On a card in float32, within the kernel's
    limits, :func:`_normal_delta_kernel` assembles the equilibrated matrix
    in one launch a block; elsewhere :func:`_normal_delta_einsum` forms
    ``H`` and hands it to ``spd_solve`` (counted in
    ``ops/graphs.py::NORMAL_ASSEMBLIES``)."""
    kernel = z.device.type == "cuda" and z.dtype == torch.float32 and normal_matrix.fits(
        ainvs, structure[0])
    graphs.normal_assembly_routed("kernel" if kernel else "einsum")
    return (_normal_delta_kernel if kernel else _normal_delta_einsum)(
        fp, z, structure, ainvs, hessian_jitter)


def _live_diagonals(p: CollocationProblem, z, structure):
    """Per block the ``(s, S, N)`` per-slice diagonals of the raw Jacobian
    on its ``S`` live (interior) segments."""
    s_lat, N, seginfo = structure
    out = []
    for b, segs in zip(p.blocks, seginfo):
        D = torch.stack(_block_diagonals(b.residual, p.data, z, s_lat, N))
        out.append(torch.stack([D[:, off : off + N] for off, sz in segs if sz == N], dim=1))
    return out


def _normal_delta_einsum(fp, z, structure, ainvs, hessian_jitter):
    """The step by :func:`..ops.normal_matrix.einsum_normal_matrix` and
    ``spd_solve``."""
    p = fp.problem
    g = _gradient(fp, _linearize_blocks(fp, z), z)
    pairs = list(zip(ainvs, _live_diagonals(p, z, structure)))
    H = normal_matrix.einsum_normal_matrix(pairs, _misfit_jacobians(p, z), z)
    return spd_solve(H, g, jitter=hessian_jitter)


def _normal_delta_kernel(fp, z, structure, ainvs, hessian_jitter):
    """The step with the equilibrated matrix assembled directly
    (:func:`_equilibrated_normal_matrix`), then
    :func:`..ops.linalg.equilibrated_solve`."""
    p = fp.problem
    g = _gradient(fp, _linearize_blocks(fp, z), z)
    pairs = list(zip(ainvs, _live_diagonals(p, z, structure)))
    return equilibrated_solve(*_equilibrated_normal_matrix(p, z, pairs, hessian_jitter), g)


def _equilibrated_normal_matrix(p: CollocationProblem, z, pairs, hessian_jitter):
    """``(Hs, sc)``: the matrix ``spd_solve(H, g, hessian_jitter)`` factors
    on the card and its scales, without forming ``H``. The scales come from
    ``d = diag(H) + hessian_jitter``, the diagonal taken from the inverse
    blocks' entries at ``q = p`` plus the misfits' squared column sums; the
    misfits' scaled product ``(J_m sc)^T (J_m sc)`` first (one product),
    then ``ops/normal_matrix.py`` adds every block's ``sc sc^T * H_b`` to
    it, exactly symmetric, with the floored diagonal. On CPU tensors
    ``normal_matrix`` runs its plain version."""
    d = normal_matrix.normal_diagonal(pairs)
    if hessian_jitter:
        d = d + hessian_jitter
    Jm = torch.cat(_misfit_jacobians(p, z)) if p.misfits else None
    if Jm is not None:
        d = d + (Jm * Jm).sum(dim=0)
    sc = torch.rsqrt(torch.clamp(d, min=torch.finfo(z.dtype).tiny))
    Ms = None if Jm is None else Jm * sc
    return normal_matrix.normal_matrix(pairs, sc, out=None if Ms is None else Ms.T @ Ms), sc


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


def _trial(fp, z, delta, s, step_size, big):
    """``(z_t, loss, finite)`` of the trial ``z - s step_size delta``; a
    non-finite trial is ``(z, big, False)``."""
    z_t = z - (s * step_size) * delta
    finite = torch.isfinite(z_t).all()
    z_t = torch.where(finite, z_t, z)
    r = fp.whitened_residual(z_t)
    return z_t, torch.where(finite, torch.dot(r, r), big), finite


class _MeshCarry(_Carry):
    """The mesh loop's :class:`..gn._Carry` plus the damped update's inputs
    and its full trial (for a step that must halve), and ``code``, the
    step's host read (:func:`_read_code`): bit 0 whether the full step must
    halve, bit 1 whether the step ran (``go`` before it)."""

    def __init__(self, z, max_iter, tol):
        super().__init__(z, max_iter, tol)
        self.z_in, self.delta, self.z1 = (torch.zeros_like(z) for _ in range(3))
        self.loss_in, self.l1 = self.loss.clone(), self.loss.clone()
        self.ok_in, self.f1 = self.ok.clone(), self.ok.clone()
        self.code = torch.zeros((), dtype=torch.int64, device=z.device)

    def start(self, fp, z0):
        """Reset to ``z0`` and its loss, the damped update's first input."""
        self.reset(z0)
        self.loss.copy_(fp.loss(z0))
        return Flag(z0.device)


def _damped_update(step_size):
    """The guarded update (``:911``), its full step on the device: the full
    step unless it is non-finite or more than doubles the incoming loss.
    The step is recorded as taken; ``code`` tells the host whether it must
    halve (:func:`_halve`), rank 0's on every rank."""

    def update(fp, c: _MeshCarry, delta, iters):
        go = c.go.clone()
        z1, l1, f1 = _trial(fp, c.z, delta, 1.0, step_size, c.big)
        for buf, val in ((c.z_in, c.z), (c.delta, delta), (c.loss_in, c.loss), (c.ok_in, c.ok),
                         (c.z1, z1), (c.l1, l1), (c.f1, f1)):
            buf.copy_(val)
        need = l1 > 2.0 * c.loss_in
        c.commit(z1, f1, torch.where(f1, l1, c.loss_in), iters)
        code = need.to(torch.int64) + 2 * go.to(torch.int64)
        c.code.copy_(comm.agree_device(fp.mesh, code, "first"))  # the same on every rank

    return update


def _halve(fp, c: _MeshCarry, step_size):
    """The rest of the guarded update, for a step whose full step failed
    its test: halved up to four times while the best trial still more than
    doubles the loss, the best finite trial kept (a step with no finite
    trial keeps ``z`` and the loss, and clears ``ok``). The tests are
    device masks, with no host read; the step's record is rewritten."""
    z, delta, loss_in = c.z_in, c.delta, c.loss_in
    zc, lc, fc = c.z1, c.l1, c.f1
    s = 1.0
    for _ in range(4):
        go_on = lc > 2.0 * loss_in
        s *= 0.5
        z2, l2, f2 = _trial(fp, z, delta, s, step_size, c.big)
        better = go_on & (l2 < lc)
        zc, lc, fc = torch.where(better, z2, zc), torch.where(better, l2, lc), fc | (f2 & better)
    loss = torch.where(fc, lc, loss_in)
    c.z.copy_(torch.where(fc, zc, z))
    c.loss.copy_(loss)
    c.ok.copy_(c.ok_in & fc)
    c.losses.index_copy_(0, (c.i - 1).view(1), loss.view(1))
    c.cur.copy_(loss)
    c.update_go()


def _read_code(step_size, fp, c: _MeshCarry, flag: Flag) -> bool:
    """The mesh path's read after each step: ``code``, agreed over the
    ranks inside the step. A step that followed the ``tol`` stop changed
    nothing and ends the loop; a full step that failed its test halves."""
    flag.post(c.code)
    code = flag.read()
    if not code & 2:
        return False
    if code & 1:
        _halve(fp, c, step_size)
    return True


def _records(mesh: Mesh) -> bool:
    """Whether the mesh loop is recorded as CUDA graphs on the card and
    shared by the problems of a layout (``solvers/_reuse.py``): with no
    group, and under NCCL at any P, whose collectives a graph holds. Not
    for gloo ranks on a card, which stage every collective through host
    memory that no graph can hold: their loop runs eagerly, unshared.
    gloo ranks on the CPU record nothing, as no CPU loop does, and share
    their entries as the card's ranks do."""
    return not (mesh.backend == "gloo" and mesh.device.type == "cuda")


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
    _check_step_solver(p, step_solver, ("auto", "structured", "direct", "cg", "woodbury", "normal"))
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

    ``tol`` as in :func:`.gn.gn_solve`; a step with no finite trial stops too.
    """
    p = fp.problem
    step_solver, structure, cand, valid = route_step_solver(
        fp, step_solver, direct_panel_limit, normal_budget_bytes
    )
    if cg_tol is None:
        cg_tol = 1e-10 if torch.finfo(p.dtype).eps < 1e-10 else 1e-6
    # whether the Krylov step deflates: it reads this problem's kernels,
    # which are in neither key, so it is a key of its own
    wants = step_solver == "woodbury" or (
        step_solver == "cg" and (_any_anisotropic(p) or bool(deflation_rank)))
    return _gauss_newton(
        fp, z0, max_iter, cg_maxiter, tol, step_solver,
        ("mesh", step_solver, structure, deflation_rank, wants, valid, float(step_size),
         float(hessian_jitter), float(cg_tol)),
        lambda z, max_iter, cg_maxiter, run_fp, pool: _mesh_loop(
            run_fp, z, step_solver, structure, cand, valid, wants, deflation_rank, max_iter,
            step_size, hessian_jitter, cg_tol, cg_maxiter, tol, pool),
        functools.partial(_read_code, step_size),
        "gauss_newton.normal_step" if step_solver == "normal" else None)


def _mesh_loop(fp, z, solver, structure, cand, valid, wants, deflation_rank, max_iter,
               step_size, hessian_jitter, cg_tol, cg_maxiter, tol, pool) -> _Loop:
    """The mesh path's :class:`..gn._Loop` for one configuration, with the
    state its steps keep across calls: the deflation basis (when ``wants``)
    and the ``'normal'`` step's inverse blocks. They depend on the
    problem's factors, so ``prepare`` computes them (set-up reads) for each
    problem the loop serves, into the storage a recording reads."""
    p = fp.problem
    state = {}

    def prepare(loop, fp):
        V_defl = None
        if wants and valid and deflation_rank != 0:
            id_rows = identity_slice_rows(fp.problem, cand)
            if fp.agree(id_rows is not None, "all"):
                rank = (default_deflation_rank(p.latent_dim) if deflation_rank is None
                        else int(deflation_rank))
                V_defl = _deflation_basis(fp, cand, id_rows, rank)
        _refill(state, "V_defl", V_defl)
        ainvs = None
        if solver == "normal":
            with tracing.phase("gauss_newton.normal_state", fp.problem.device):
                ainvs = _normal_state(fp, structure)
        _refill(state, "ainvs", ainvs)
        loop.deflation_rank = 0 if V_defl is None else int(V_defl.shape[1])

    carry = _MeshCarry(z, max_iter, tol)
    kw = dict(cg_tol=cg_tol, cg_maxiter=cg_maxiter, capture=_records(fp.mesh), pool=pool,
              flag_agree=lambda fp, flag: comm.agree_device(fp.mesh, flag, "any"),
              prepare=prepare)
    update = _damped_update(step_size)
    if solver == "cg":
        return _Loop(carry, update, system_fn=lambda fp, c: _cg_system(
            fp, c.z, state["V_defl"], hessian_jitter), **kw)
    if solver == "woodbury":
        def system_fn(fp, c):
            op, B, M, U, wvec = _woodbury_system(fp, c.z, state["V_defl"], hessian_jitter)
            if c.Xw is None:  # allocated in the first (eager) step, before any recording
                c.Xw = torch.zeros_like(B)

            def finish(X):
                delta, X = _woodbury_finish(X, U, wvec, hessian_jitter)
                c.Xw.copy_(torch.where(c.go, X, c.Xw))
                return delta

            return op, B, M, finish

        return _Loop(carry, update, system_fn=system_fn, **kw)

    def delta_fn(fp, c):
        if solver == "normal":
            return _normal_delta(fp, c.z, structure, state["ainvs"], hessian_jitter)
        return _panel_delta(fp, c.z, structure if solver == "structured" else None,
                            hessian_jitter)

    return _Loop(carry, update, delta_fn=delta_fn, **kw)


def _refill(state: dict, name: str, value) -> None:
    """Set ``state[name]`` to ``value`` (a tensor, a list of tensors or
    ``None``), into the tensors already there: a recorded step reads their
    storage."""
    old = state.get(name)
    if old is None:
        state[name] = value
        return
    for o, v in zip(old if isinstance(old, list) else [old],
                    value if isinstance(value, list) else [value]):
        o.copy_(v)


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

    def _extend(self, X_test, block, op):
        mine, t = self._my_points(X_test)
        return self._gathered(super()._extend(mine, block, op), t)

    def variance(self, X_test, block=None, op=None):
        mine, t = self._my_points(X_test)
        return self._gathered(super().variance(mine, block, op), t)
