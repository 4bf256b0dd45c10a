"""Constant-coefficient linear differential operators.

A :class:`LinearOp` is a finite sum ``sum_t c_t * d^{alpha_t}`` of partial
derivatives with constant coefficients, represented by (coefficient,
multi-index) pairs.  Gram blocks of a GP-PDE collocation problem are
``(L_x (x) L_y) kappa`` evaluated on point panels; the operator pair is the
*only* thing that distinguishes one block from another, so the whole
hand-enumerated derivative-kernel menu of the reference implementation
(``src/kernels.py:8-179`` upstream) collapses to this small algebra plus a
per-kernel-family "derivative compiler" (see :mod:`..ops.kernels`).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

MultiIndex = Tuple[int, ...]
Term = Tuple[float, MultiIndex]


def _merge_terms(terms: Iterable[Term]) -> Tuple[Term, ...]:
    """Combine duplicate multi-indices and drop zero coefficients."""
    acc: dict[MultiIndex, float] = {}
    for coef, alpha in terms:
        alpha = tuple(int(a) for a in alpha)
        acc[alpha] = acc.get(alpha, 0.0) + float(coef)
    merged = tuple(
        (c, a) for a, c in sorted(acc.items()) if c != 0.0
    )
    return merged


@dataclasses.dataclass(frozen=True)
class LinearOp:
    """``sum_t c_t * d^{alpha_t}`` acting on functions of ``dim`` variables."""

    dim: int
    terms: Tuple[Term, ...]
    label: str = ""

    def __post_init__(self):
        for _, alpha in self.terms:
            if len(alpha) != self.dim:
                raise ValueError(
                    f"multi-index {alpha} has wrong length for dim={self.dim}"
                )

    # ---- algebra -------------------------------------------------------
    def __add__(self, other: "LinearOp") -> "LinearOp":
        if other.dim != self.dim:
            raise ValueError("dimension mismatch")
        return LinearOp(self.dim, _merge_terms(self.terms + other.terms))

    def __rmul__(self, scalar: float) -> "LinearOp":
        return LinearOp(
            self.dim, _merge_terms((scalar * c, a) for c, a in self.terms)
        )

    def __mul__(self, scalar: float) -> "LinearOp":
        return self.__rmul__(scalar)

    def __neg__(self) -> "LinearOp":
        return (-1.0) * self

    def __sub__(self, other: "LinearOp") -> "LinearOp":
        return self + (-other)

    def compose(self, other: "LinearOp") -> "LinearOp":
        """Operator composition (derivatives commute, coefficients multiply)."""
        if other.dim != self.dim:
            raise ValueError("dimension mismatch")
        terms = []
        for c1, a1 in self.terms:
            for c2, a2 in other.terms:
                terms.append((c1 * c2, tuple(i + j for i, j in zip(a1, a2))))
        return LinearOp(self.dim, _merge_terms(terms))

    # ---- queries -------------------------------------------------------
    @property
    def order(self) -> int:
        return max((sum(a) for _, a in self.terms), default=0)

    @property
    def is_identity(self) -> bool:
        return self.terms == ((1.0, (0,) * self.dim),)

    def max_order_per_dim(self) -> Tuple[int, ...]:
        out = [0] * self.dim
        for _, alpha in self.terms:
            for k, a in enumerate(alpha):
                out[k] = max(out[k], a)
        return tuple(out)

    def __repr__(self):  # pragma: no cover - debugging nicety
        if self.label:
            return f"LinearOp<{self.label}>"
        return f"LinearOp(dim={self.dim}, terms={self.terms})"


# ---- constructors ------------------------------------------------------
def identity(dim: int = 2) -> LinearOp:
    """The identity functional (point evaluation)."""
    return LinearOp(dim, ((1.0, (0,) * dim),), label="id")


def d(i: int, dim: int = 2) -> LinearOp:
    """First partial derivative along axis ``i``."""
    alpha = tuple(1 if k == i else 0 for k in range(dim))
    return LinearOp(dim, ((1.0, alpha),), label=f"d{i}")


def d2(i: int, j: int, dim: int = 2) -> LinearOp:
    """Second partial derivative ``d_i d_j``."""
    alpha = [0] * dim
    alpha[i] += 1
    alpha[j] += 1
    return LinearOp(dim, ((1.0, tuple(alpha)),), label=f"d{i}d{j}")


def laplacian(dim: int = 2) -> LinearOp:
    """``sum_i d_i^2``."""
    terms = []
    for i in range(dim):
        alpha = tuple(2 if k == i else 0 for k in range(dim))
        terms.append((1.0, alpha))
    return LinearOp(dim, tuple(terms), label="lap")
