"""GP posterior mean and variance with cached representer weights.

Counterpart of ``nonlinpdes_gpsolver_tpu/solvers/posterior.py``. The
representer weights ``Theta^{-1} F(z*)`` are computed once per block; each
query is then a cross-Gram assembly (Gram tile kernel) plus one matvec,
evaluated in row chunks so that the cross-Gram temporary stays bounded at
any number of test points. The mesh path's
:class:`~.distributed.DistributedPosterior` is this class run against a
``DistributedFactoredProblem``, whose ``kernel_solve`` and ``whiten`` go
through its block factors.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.assembly import cross_gram, observable_sizes
from ..ops.gram_tile import gram_tile_pair_fn
from ..ops.operators import LinearOp, identity
from ..utils import tracing
from .gn import FactoredProblem


def _serving_chunk(rows: int, n_train: int, budget_elems: int = 1 << 26):
    """Row-chunk size bounding the cross-Gram temporary at ``budget_elems``
    elements (256 MB in f32), or ``None`` when the whole panel fits."""
    if rows * max(n_train, 1) <= budget_elems:
        return None
    return max(128, budget_elems // max(n_train, 1))


def _row_chunks(X: torch.Tensor, chunk):
    if chunk is None:
        return [X]
    return list(torch.split(X, chunk))


class Posterior:
    """Posterior means of every GP block at the Gauss-Newton solution."""

    def __init__(self, fp: FactoredProblem, z_star: torch.Tensor):
        self.fp = fp
        self.z_star = z_star
        p = fp.problem
        self._weights: Dict[str, torch.Tensor] = {
            b.name: fp.kernel_solve(b.name, b.residual(z_star, p.data))
            for b in p.blocks
        }

    def weights(self, block: str) -> torch.Tensor:
        return self._weights[block]

    def _block_op(self, block, op):
        p = self.fp.problem
        b = p.block(block) if block is not None else p.blocks[0]
        return b, (identity(b.kernel.dim) if op is None else op)

    def _whiten(self, name: str, C: torch.Tensor) -> torch.Tensor:
        return self.fp.whiten(name, C)

    def extend(
        self,
        X_test: torch.Tensor,
        block: str | None = None,
        op: LinearOp | None = None,
    ) -> torch.Tensor:
        """Posterior mean of ``op`` (default: point evaluation) applied to
        the block's GP at ``X_test`` (span ``extend``)."""
        with tracing.span("extend"):
            return self._extend(X_test, block, op)

    def _extend(self, X_test, block, op):
        b, op = self._block_op(block, op)
        p = self.fp.problem
        w = self._weights[b.name]
        X_test = X_test.to(device=w.device, dtype=w.dtype).contiguous()
        chunk = _serving_chunk(int(X_test.shape[0]), int(w.shape[0]))
        return torch.cat([
            cross_gram(b.kernel, op, xs, b.observables, p.points) @ w
            for xs in _row_chunks(X_test, chunk)
        ])

    def variance(
        self,
        X_test: torch.Tensor,
        block: str | None = None,
        op: LinearOp | None = None,
    ) -> torch.Tensor:
        """Pointwise posterior variance of ``op`` applied to the block's GP.

        ``var(x) = (op (x) op) kappa(x, x) - c(x)^T Theta^{-1} c(x)`` with
        ``c(x)`` the cross-covariance row, clipped at zero against rounding.
        The prior term is the *unregularized* ``(op (x) op) kappa(x, x)``
        (no nugget on it), while ``Theta`` in the quadratic form carries the
        nugget: the value the JAX package computes.
        """
        b, op = self._block_op(block, op)
        p, fp = self.fp.problem, self.fp
        X_test = X_test.to(device=p.device, dtype=p.dtype).contiguous()
        n_train = sum(observable_sizes(b.observables, p.points))
        chunk = _serving_chunk(int(X_test.shape[0]), n_train)
        parts = []
        for xs in _row_chunks(X_test, chunk):
            V = self._whiten(b.name, cross_gram(b.kernel, op, xs, b.observables, p.points).T)
            parts.append(torch.sum(V * V, dim=0))
        qv = torch.cat(parts)
        # kappa is stationary: the prior term is the closed form at u = 0,
        # the same for every test point (one 1x1 block on X_test's device).
        x0 = X_test[:1]
        prior = gram_tile_pair_fn(b.kernel, op, op)(x0, x0)[0, 0]
        return torch.clamp(prior - qv, min=0.0)

    def std(
        self,
        X_test: torch.Tensor,
        block: str | None = None,
        op: LinearOp | None = None,
    ) -> torch.Tensor:
        """Pointwise posterior standard deviation (see :meth:`variance`)."""
        return torch.sqrt(self.variance(X_test, block=block, op=op))
