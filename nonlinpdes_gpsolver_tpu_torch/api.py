"""User-facing solver facade: the dense path and the mesh path.

Counterpart of ``nonlinpdes_gpsolver_tpu/api.py``. Typical use::

    from nonlinpdes_gpsolver_tpu_torch import GPSolver, models, ops, utils

    prob = models.nonlinear_elliptic(ops.SquaredExponential.gaussian(0.2),
                                     X_domain, X_boundary, rhs_f, bdy_g)
    result = GPSolver(prob, nugget=1e-5).solve(max_iter=4)
    u_test = result.posterior.extend(X_test)

The problem's tensors decide the device and dtype (CUDA and f32 for a
problem built with the defaults). A problem whose largest Gram block has
16,384 rows or more, or any problem given ``mesh=parallel.make_mesh(1)``,
takes the mesh path on its device: the fused assemble-and-factorize, the
distributed Gauss-Newton steps and :class:`~.solvers.distributed.
DistributedPosterior` (``solvers/distributed.py``). A mesh of P ranks
(``parallel.make_mesh(P)`` in a process group of P ranks, each rank
running the same program) spreads that path over them. :class:`GPSolver`
picks the path once, when it is made: its factorization, its Gauss-Newton
function and its posterior class, on the skeleton both paths share
(``solvers/gn.py``).

On the card the factorization defers its quality verdicts
(``defer_quality``, the JAX package's optimistic pipeline) and the
Gauss-Newton loop replays CUDA graphs; ``solve`` reads the verdicts with
its results in one host read, and factors and solves again in the rare
case that one failed. The recorded loop is shared by every problem of one
structure (``solvers/_reuse.py``): once a solver and its results are gone,
a new ``GPSolver`` of the same structure factors into their storage and
replays their loop, on one device or on every rank of an NCCL mesh.

Each solver continues its problem's :class:`~.utils.tracing.Record`
(``trace``): the phases ``factorize``, ``gauss_newton`` and
``posterior_weights``, timed on the card by CUDA events and read after the
solve's one host read (no synchronize), their pieces, and the host's waits.
``SolveResult.timers`` holds them in seconds (``utils/tracing.py::KEYS``).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Optional

import numpy as np
import torch

from .models.spec import CollocationProblem
from .ops.backend import is_accelerator
from .ops.linalg import ESCALATION, MAX_ESCALATIONS
from .parallel.mesh import Mesh, make_mesh
from .solvers.distributed import DistributedPosterior, factorize_distributed, gn_solve_distributed
from .solvers.gn import GNState, factorize, gn_solve
from .solvers.posterior import Posterior
from .utils import tracing
from .utils.metrics import ErrorStats, error_stats

log = logging.getLogger("nonlinpdes_gpsolver_tpu_torch")

# The JAX package's dense-vs-mesh crossover (measured on its accelerator,
# api.py:52-57 there): from this many rows in the largest Gram block the
# solve takes the mesh path. chip_smoke.py's phase mesh_vs_dense measures
# the two paths at 16,200 rows on the card; the constant stays the JAX
# package's until a decision on that datum (ROADMAP).
_AUTO_MESH_GRAM_ROWS = 16384


@dataclasses.dataclass
class SolveResult:
    state: GNState
    posterior: Posterior  # a DistributedPosterior on the mesh path
    timers: dict  # seconds by utils/tracing.py's KEYS
    trace: Optional[tracing.Record] = None

    @property
    def z(self) -> torch.Tensor:
        return self.state.z

    @property
    def losses(self) -> np.ndarray:
        return self.state.losses.cpu().numpy()


def largest_gram_rows(problem: CollocationProblem) -> int:
    """Rows of the problem's largest Gram block."""
    return max(
        sum(int(problem.points[o.points].shape[0]) for o in b.observables)
        for b in problem.blocks
    )


class GPSolver:
    """Factorizes once, then supports repeated solves / posterior queries.

    ``mesh`` (a :class:`~.parallel.mesh.Mesh` from ``parallel.make_mesh``)
    runs the mesh path with ``mesh_block``-row blocks, on one device or
    across the mesh's ranks (every rank builds the same problem on its own
    device and calls this). ``auto_mesh`` (default on): with no ``mesh``,
    a problem whose largest Gram block has at least ``_AUTO_MESH_GRAM_ROWS``
    rows takes the mesh path on the problem's device, where the dense path
    would hold the Gram matrix, its f64 copy, the factor and the whitening
    operator at once. ``auto_mesh=False`` forces the dense path.
    ``solve_mode`` is the dense path's (see :func:`.solvers.gn.factorize`).

    ``defer_quality`` (default: on for a problem on the card, off on the
    CPU, as the JAX package decides by its backend): the factorization
    makes one attempt a block and leaves its verdict on the device, and
    :meth:`solve` reads it with the Gauss-Newton results in one host read.
    On a failed verdict it escalates the failing blocks' nugget tenfold
    past the attempted scale, drops the solve and releases the factors
    (``solvers/_reuse.py``), and factors and solves again into the same
    storage, for at most 8 rounds. Across ranks the verdicts and results
    are agreed on the device before that one read, so every rank reads the
    same and a redo happens on all of them or on none.
    """

    def __init__(
        self,
        problem: CollocationProblem,
        nugget: float = 1e-10,
        nugget_type: str = "adaptive",
        solve_mode: str = "auto",
        auto_mesh: bool = True,
        mesh: Optional[Mesh] = None,
        mesh_block: int = 512,
        defer_quality: Optional[bool] = None,
    ):
        self.trace = tracing.Record.continuing(problem.trace)
        with self.trace.solving():
            if mesh is None and auto_mesh:
                n_max = largest_gram_rows(problem)
                if n_max >= _AUTO_MESH_GRAM_ROWS:
                    mesh = make_mesh(1, device=problem.device)
                    log.info(
                        "auto_mesh: largest Gram block has %d rows (>= %d); the mesh path "
                        "on %s", n_max, _AUTO_MESH_GRAM_ROWS, problem.device,
                    )
            self.problem = problem
            self.mesh = mesh
            if defer_quality is None:
                defer_quality = is_accelerator(problem.device)
            if mesh is None:
                factor, path = factorize, dict(solve_mode=solve_mode)
                self._gn_solve, self._posterior = gn_solve, Posterior
            else:
                factor, path = factorize_distributed, dict(mesh=mesh, block=mesh_block)
                self._gn_solve, self._posterior = gn_solve_distributed, DistributedPosterior
            self._factor = functools.partial(factor, nugget=nugget, nugget_type=nugget_type,
                                             defer_quality=bool(defer_quality), **path)
            self._start_scales: dict = {}
            self._factorize()

    def _factorize(self):
        with self.trace.phase("factorize", self.problem.device):
            self.fp = self._factor(self.problem, start_scales=self._start_scales or None)
        for name, scale in self.fp.nugget_scales.items():
            if self.fp.rungs[name]:
                log.warning(
                    "block %r: nugget escalated to x%g (%d rungs) to keep the "
                    "factor finite and accurate", name, scale, self.fp.rungs[name],
                )

    def solve(
        self,
        max_iter: int = 8,
        step_size: float = 1.0,
        z0: Optional[torch.Tensor] = None,
        hessian_jitter: float = 0.0,
        step_solver: str = "auto",
        tol: Optional[float] = None,
    ) -> SolveResult:
        """Run the Gauss-Newton solve (:func:`.solvers.gn.gn_solve`, or on
        the mesh path :func:`.solvers.distributed.gn_solve_distributed`) and
        build the posterior at its solution. One host read takes the
        finiteness verdict, the losses and any pending quality verdicts
        (``defer_quality``); a failed verdict re-factors and solves again
        (the class docstring)."""
        kw = dict(z0=z0, max_iter=max_iter, step_size=step_size, hessian_jitter=hessian_jitter,
                  step_solver=step_solver, tol=tol)
        with self.trace.solving():
            state, post, finite, losses = self._solve(kw)
        if not finite:
            log.warning(
                "problem %r: at least one GN step was rejected as non-finite "
                "(nugget may be too small)", self.problem.name,
            )
        log.info("problem %r: GN losses %s", self.problem.name, losses)
        return SolveResult(state=state, posterior=post, timers=self.trace.timers(),
                           trace=self.trace)

    def _solve(self, kw):
        dev = self.problem.device
        for _ in range(MAX_ESCALATIONS):
            with self.trace.phase("gauss_newton", dev):
                state = self._gn_solve(self.fp, **kw)
            with self.trace.phase("posterior_weights", dev):
                post = self._posterior(self.fp, state.z)
            bad, (finite, *losses) = self.fp.resolve_pending((state.converged_finite, state.losses))
            if not bad:
                return state, post, finite, losses
            for name in bad:
                self._start_scales[name] = ESCALATION * self.fp.nugget_scales[name]
            log.warning(
                "problem %r: deferred quality verdict failed for block(s) %s; factoring "
                "again with the nugget escalated", self.problem.name, bad,
            )
            # drop every reference to the failed factors: their problem is then
            # gone, its bind released, and the next factorization writes into
            # their storage (solvers/_reuse.py)
            post = state = None  # noqa: F841
            self.fp = None
            self._factorize()
        raise FloatingPointError(
            f"problem {self.problem.name!r}: factorization quality still bad after "
            f"nugget escalation to {self._start_scales}"
        )

    @staticmethod
    def errors(pred, truth) -> ErrorStats:
        return error_stats(pred, truth)
