"""User-facing solver facade on the dense single-device path.

Counterpart of ``nonlinpdes_gpsolver_tpu/api.py``. Typical use::

    from nonlinpdes_gpsolver_tpu_torch import GPSolver, models, ops, utils

    prob = models.nonlinear_elliptic(ops.SquaredExponential.gaussian(0.2),
                                     X_domain, X_boundary, rhs_f, bdy_g)
    result = GPSolver(prob, nugget=1e-5).solve(max_iter=4)
    u_test = result.posterior.extend(X_test)

The problem's tensors decide the device and dtype (CUDA and f32 for a
problem built with the defaults). Factorization checks its quality eagerly,
so there is no deferred verdict and no re-run of a solve.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from .models.spec import CollocationProblem
from .solvers.gn import FactoredProblem, GNState, factorize, gn_solve
from .solvers.posterior import Posterior
from .utils.metrics import ErrorStats, PhaseTimers, error_stats

log = logging.getLogger("nonlinpdes_gpsolver_tpu_torch")

# The JAX package's dense-vs-mesh crossover (measured on its accelerator):
# at this many Gram rows it switches to the fused streaming mesh path,
# which is not ported yet.
_AUTO_MESH_GRAM_ROWS = 16384


@dataclasses.dataclass
class SolveResult:
    state: GNState
    posterior: Posterior
    timers: dict

    @property
    def z(self) -> torch.Tensor:
        return self.state.z

    @property
    def losses(self) -> np.ndarray:
        return self.state.losses.cpu().numpy()


class GPSolver:
    """Factorizes once, then supports repeated solves / posterior queries.

    ``auto_mesh`` (default on): a problem whose largest Gram block has at
    least 16,384 rows would take the JAX package's mesh path, which is not
    ported yet (slice 3 of the port), so it raises ``NotImplementedError``
    instead of running densely in silence. ``auto_mesh=False`` forces the
    dense path.
    """

    def __init__(
        self,
        problem: CollocationProblem,
        nugget: float = 1e-10,
        nugget_type: str = "adaptive",
        solve_mode: str = "auto",
        auto_mesh: bool = True,
    ):
        n_max = max(
            sum(int(problem.points[o.points].shape[0]) for o in b.observables)
            for b in problem.blocks
        )
        if auto_mesh and n_max >= _AUTO_MESH_GRAM_ROWS:
            raise NotImplementedError(
                f"largest Gram block has {n_max} rows (>= {_AUTO_MESH_GRAM_ROWS}):"
                " that size takes the mesh path, which is slice 3 of the port "
                "and not ported yet; pass auto_mesh=False to run it densely"
            )
        self.problem = problem
        self.timers = PhaseTimers(problem.device)
        with self.timers.phase("factorize"):
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
        """Run the Gauss-Newton solve (see :func:`.solvers.gn.gn_solve`) and
        build the posterior at its solution."""
        with self.timers.phase("gauss_newton"):
            state = gn_solve(
                self.fp, z0=z0, max_iter=max_iter, step_size=step_size,
                hessian_jitter=hessian_jitter, step_solver=step_solver, tol=tol,
            )
        with self.timers.phase("posterior_weights"):
            post = Posterior(self.fp, state.z)
        if not bool(state.converged_finite):
            log.warning(
                "problem %r: at least one GN step was rejected as non-finite "
                "(nugget may be too small)", self.problem.name,
            )
        return SolveResult(state=state, posterior=post, timers=self.timers.as_dict())

    @staticmethod
    def errors(pred, truth) -> ErrorStats:
        return error_stats(pred, truth)
