"""Block Gram-matrix assembly for GP-PDE collocation.

Counterpart of ``nonlinpdes_gpsolver_tpu/ops/assembly.py``. A Gram matrix
or a cross-Gram is one :class:`~.gram_tile.GramPlan` run: on the card one
launch of the Gram kernel K1 writes every block into the preallocated
matrix, the mirrors of the upper blocks included (``kappa`` is symmetric and
stationary); on the CPU the plan's plain version walks the same blocks.

The trace-adaptive nugget keeps the JAX package's rule: derivative blocks
get ``nugget * trace(Theta_ii) / trace(Theta_anchor)`` on their diagonal,
identity blocks get ``nugget``, and the anchor is the union of all
identity-functional blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from .gram_tile import cross_plan, gram_plan
from .kernels import SquaredExponential
from .operators import LinearOp


@dataclasses.dataclass(frozen=True)
class Observable:
    """A batch of linear functionals: ``op`` evaluated at point-set ``points``."""

    points: str  # key into the points dict ('domain', 'boundary', ...)
    op: LinearOp


def observable_sizes(
    observables: Sequence[Observable], points: Dict[str, torch.Tensor]
) -> Tuple[int, ...]:
    return tuple(int(points[o.points].shape[0]) for o in observables)


def _offsets(sizes: Sequence[int]) -> list[int]:
    out, off = [], 0
    for s in sizes:
        out.append(off)
        off += s
    return out


def gram_matrix(
    kernel: SquaredExponential,
    observables: Sequence[Observable],
    points: Dict[str, torch.Tensor],
) -> torch.Tensor:
    """Assemble the symmetric block Gram matrix ``Theta``.

    ``Theta[I, J] = (op_I (x) op_J) kappa`` on the point panels of
    observables I (rows) and J (columns), on the points' device and dtype.
    """
    observables = tuple(observables)
    plan = gram_plan(kernel, observables, observable_sizes(observables, points))
    return plan.run([points[k] for k in plan.set_keys])


def cross_gram(
    kernel: SquaredExponential,
    row_op: LinearOp,
    X_rows: torch.Tensor,
    observables: Sequence[Observable],
    points: Dict[str, torch.Tensor],
) -> torch.Tensor:
    """Rectangular cross-covariance between ``row_op`` at ``X_rows`` and the
    training functionals; derivatives land on the y (training) side."""
    observables = tuple(observables)
    plan = cross_plan(
        kernel, row_op, int(X_rows.shape[0]), observables,
        observable_sizes(observables, points),
    )
    return plan.run([X_rows, *(points[k] for k in plan.set_keys)])


def adaptive_nugget_diag(
    theta: torch.Tensor,
    observables: Sequence[Observable],
    sizes: Sequence[int],
    nugget: float,
    nugget_type: str = "adaptive",
) -> torch.Tensor:
    """Diagonal regularizer following the upstream trace-ratio rule."""
    n_total = int(sum(sizes))
    kw = dict(dtype=theta.dtype, device=theta.device)
    if nugget_type == "none":
        return torch.zeros(n_total, **kw)
    if nugget_type == "identity":
        return torch.full((n_total,), nugget, **kw)
    if nugget_type != "adaptive":
        raise ValueError(f"unknown nugget_type {nugget_type!r}")

    offsets = _offsets(sizes)
    diag = torch.diagonal(theta)
    # anchor trace: union of identity-functional blocks
    anchor = 0.0
    for o, s, start in zip(observables, sizes, offsets):
        if o.op.is_identity:
            anchor = anchor + torch.sum(diag[start : start + s])
    parts = []
    for o, s, start in zip(observables, sizes, offsets):
        if o.op.is_identity:
            ratio = torch.ones((), **kw)
        else:
            ratio = torch.sum(diag[start : start + s]) / anchor
        parts.append(torch.full((s,), nugget, **kw) * ratio)
    return torch.cat(parts)


def regularized_gram(
    kernel: SquaredExponential,
    observables: Sequence[Observable],
    points: Dict[str, torch.Tensor],
    nugget: float,
    nugget_type: str = "adaptive",
) -> torch.Tensor:
    theta = gram_matrix(kernel, observables, points)
    sizes = observable_sizes(observables, points)
    nug = adaptive_nugget_diag(theta, observables, sizes, nugget, nugget_type)
    return theta + torch.diag(nug)
