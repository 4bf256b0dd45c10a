"""Performance accounting: the JAX package's analytic FLOP model.

A copy of ``nonlinpdes_gpsolver_tpu/utils/profiling.py``'s
:func:`flop_model` and :func:`tflops`, so that wall-clock phase timers
convert to TFLOP/s by the same count in both packages. The count is the
model's (``n^3/3`` a Cholesky, ``40`` flops a Gram entry), not the work the
port's kernels and library calls do, so a rate from it is not a share of
the card's peak. The JAX module's ``trace`` (a ``jax.profiler`` wrapper) is
left out: nothing calls it.
"""

from __future__ import annotations

from typing import Dict

from ..models.spec import CollocationProblem


def flop_model(problem: CollocationProblem, gn_iters: int = 1) -> Dict[str, float]:
    """Approximate FLOPs per phase for a factored GN solve.

    Assembly: ~40 flops per Gram entry (difference, polynomial, exp) summed
    over blocks. Cholesky: n^3/3 per block. GN iteration: Jacobian whitening
    (n^2 m TRSM or matmul) + normal matrix (n m^2) + SPD solve (m^3/3).
    """
    out = {"assembly": 0.0, "cholesky": 0.0, "gn_per_iter": 0.0}
    m = problem.latent_dim
    for b in problem.blocks:
        n = sum(problem.points[o.points].shape[0] for o in b.observables)
        out["assembly"] += 40.0 * n * n
        out["cholesky"] += n**3 / 3.0
        out["gn_per_iter"] += n * n * m + 2.0 * n * m * m
    out["gn_per_iter"] += m**3 / 3.0
    out["gn_total"] = out["gn_per_iter"] * gn_iters
    out["total"] = out["assembly"] + out["cholesky"] + out["gn_total"]
    return out


def tflops(flops: float, seconds: float) -> float:
    return flops / max(seconds, 1e-12) / 1e12
