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
running the same program) spreads that path over them. Factorization
checks its quality eagerly, so there is no deferred verdict and no re-run
of a solve.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from .models.spec import CollocationProblem
from .parallel.mesh import Mesh, make_mesh
from .solvers.distributed import DistributedPosterior, factorize_distributed, gn_solve_distributed
from .solvers.gn import FactoredProblem, GNState, factorize, gn_solve
from .solvers.posterior import Posterior
from .utils.metrics import ErrorStats, PhaseTimers, error_stats

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
    timers: dict

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
    ):
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
        self.timers = PhaseTimers(problem.device)
        with self.timers.phase("factorize"):
            if mesh is not None:
                self.fp = factorize_distributed(
                    problem, mesh, nugget=nugget, nugget_type=nugget_type, block=mesh_block
                )
            else:
                self.fp: FactoredProblem = factorize(
                    problem, nugget=nugget, nugget_type=nugget_type, solve_mode=solve_mode
                )
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
        build the posterior at its solution."""
        kw = dict(z0=z0, max_iter=max_iter, step_size=step_size, hessian_jitter=hessian_jitter,
                  step_solver=step_solver, tol=tol)
        on_mesh = self.mesh is not None
        with self.timers.phase("gauss_newton"):
            state = (gn_solve_distributed if on_mesh else gn_solve)(self.fp, **kw)
        with self.timers.phase("posterior_weights"):
            post = (DistributedPosterior if on_mesh else Posterior)(self.fp, state.z)
        if not bool(state.converged_finite):
            log.warning(
                "problem %r: at least one GN step was rejected as non-finite "
                "(nugget may be too small)", self.problem.name,
            )
        return SolveResult(state=state, posterior=post, timers=self.timers.as_dict())

    @staticmethod
    def errors(pred, truth) -> ErrorStats:
        return error_stats(pred, truth)
