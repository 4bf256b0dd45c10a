"""Squared-exponential kernel family and its closed-form derivative blocks.

Counterpart of ``nonlinpdes_gpsolver_tpu/ops/kernels.py``. Every derivative
block of the separable kernel ``kappa(x, y) = prod_k exp(-a_k (x_k - y_k)^2)``
is ``P(u) * kappa(u)`` with ``u = x - y`` and ``P`` built from the
Hermite-style recurrence ``p_0 = 1, p_{n+1} = p_n' - 2 a u p_n``.

:func:`_compiled_pair_fn` evaluates that closed form with plain tensor ops.
It is the *plain version* of the Gram tile kernel (``ops/gram_tile.py``):
the wrapper runs it for CPU tensors, and the chip check holds the CUDA
kernel against it. :func:`ad_pair_fn` builds the same blocks by nested
``torch.func.grad`` and serves the tests as an oracle.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from .operators import LinearOp


def _derivative_poly_coeffs(n: int, a: float) -> np.ndarray:
    """Coefficients (ascending powers) of p_n with d^n/du^n e^{-a u^2} = p_n e^{-a u^2}."""
    c = np.zeros(n + 1, dtype=np.float64)
    c[0] = 1.0
    cur = c[: 1]
    for _ in range(n):
        nxt = np.zeros(cur.size + 1, dtype=np.float64)
        # derivative of the polynomial part
        for i in range(1, cur.size):
            nxt[i - 1] += i * cur[i]
        # -2 a u * p
        nxt[1:] += -2.0 * a * cur
        cur = nxt
    out = np.zeros(n + 1, dtype=np.float64)
    out[: cur.size] = cur
    return out


def _polyval(coeffs: np.ndarray, u: torch.Tensor) -> torch.Tensor:
    """Horner evaluation with static coefficients, in the dtype of ``u``."""
    acc = torch.full_like(u, float(coeffs[-1]))
    for c in coeffs[-2::-1]:
        acc = acc * u + float(c)
    return acc


# Cody-Waite split of ln2 (the constants of the JAX package, rounded to f32):
# LN2_HI has ~12 trailing zero bits, so k * LN2_HI is exact in f32 for the k
# range the kernel produces (q <~ 90 before underflow).
_LN2_HI = float(np.float32(0.693359375))
_LN2_LO = float(np.float32(-2.12194440e-4))
_INV_LN2 = float(np.float32(1.4426950408889634))
_TAYLOR = tuple(
    float(np.float32(c))
    for c in (1.0 / 720.0, -1.0 / 120.0, 1.0 / 24.0, -1.0 / 6.0, 0.5, -1.0, 1.0)
)
_TAYLOR_TOP = float(np.float32(-1.0 / 5040.0))


def exp_neg_accurate(q: torch.Tensor) -> torch.Tensor:
    """``exp(-q)`` for ``q >= 0``, within about 1 ulp in f32.

    The same routine as the JAX package: Cody-Waite reduction
    ``q = k ln2 + t`` with ``k`` rounded half to even, a degree-7 Taylor
    polynomial for ``e^{-t}`` (``|t| <= ln2/2``), and ``2^{-k}`` assembled in
    the exponent bits. Each constant is an f32 value, so every product and
    sum rounds to f32 as it does in the JAX version. In f64 it is
    ``torch.exp(-q)``.
    """
    if q.dtype != torch.float32:
        return torch.exp(-q)
    k = torch.round(q * _INV_LN2)
    t = (q - k * _LN2_HI) - k * _LN2_LO
    p = torch.full_like(q, _TAYLOR_TOP)
    for c in _TAYLOR:
        p = p * t + c
    k = torch.clamp(k, -126.0, 126.0)
    pow2 = ((127 - k.to(torch.int32)) << 23).view(torch.float32)
    return p * pow2


@dataclasses.dataclass(frozen=True)
class SquaredExponential:
    """Separable SE kernel ``prod_k exp(-a_k (x_k - y_k)^2)``.

    ``inv_sq`` holds the per-dimension coefficients ``a_k`` as Python floats.

    * :meth:`gaussian`: isotropic, ``a_k = 1/(2 sigma^2)``;
    * :meth:`anisotropic` with ``convention='lengthscale'``: ``a_k = 1/s_k^2``,
      or ``convention='precision'``: ``a_k = s_k^2``.
    """

    inv_sq: Tuple[float, ...]

    @property
    def dim(self) -> int:
        return len(self.inv_sq)

    @classmethod
    def gaussian(cls, sigma: float, dim: int = 2) -> "SquaredExponential":
        a = 1.0 / (2.0 * float(sigma) ** 2)
        return cls(tuple([a] * dim))

    @classmethod
    def anisotropic(
        cls, scales: Sequence[float], convention: str = "lengthscale"
    ) -> "SquaredExponential":
        if convention == "lengthscale":
            return cls(tuple(1.0 / float(s) ** 2 for s in scales))
        if convention == "precision":
            return cls(tuple(float(s) ** 2 for s in scales))
        raise ValueError(f"unknown convention {convention!r}")

    def kappa(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        u = x - y
        a = torch.as_tensor(self.inv_sq, dtype=u.dtype, device=u.device)
        return torch.exp(-torch.sum(a * u * u, dim=-1))

    def pair_fn(
        self, op_x: LinearOp, op_y: LinearOp
    ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
        """Plain ``block(X, Y) -> (N, M)`` evaluating ``(op_x (x) op_y) kappa``."""
        return _compiled_pair_fn(self.inv_sq, op_x.terms, op_y.terms)


@lru_cache(maxsize=None)
def _compiled_pair_fn(inv_sq, terms_x, terms_y):
    dim = len(inv_sq)
    # Combine term pairs, dedup by total per-dim derivative order.
    combined: dict[Tuple[int, ...], float] = {}
    for cx, ax in terms_x:
        for cy, ay in terms_y:
            sign = -1.0 if (sum(ay) % 2) else 1.0
            beta = tuple(i + j for i, j in zip(ax, ay))
            combined[beta] = combined.get(beta, 0.0) + cx * cy * sign
    polys = {
        beta: tuple(
            _derivative_poly_coeffs(b, inv_sq[k]) if b > 0 else None
            for k, b in enumerate(beta)
        )
        for beta in combined
    }

    def block(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        u = X[:, None, :] - Y[None, :, :]
        q = sum(inv_sq[k] * u[..., k] * u[..., k] for k in range(dim))
        g = exp_neg_accurate(q)
        total = torch.zeros(u.shape[:2], dtype=u.dtype, device=u.device)
        for beta, coef in combined.items():
            if coef == 0.0:
                continue
            term = torch.full(u.shape[:2], coef, dtype=u.dtype, device=u.device)
            for k, coeffs in enumerate(polys[beta]):
                if coeffs is not None:
                    term = term * _polyval(coeffs, u[..., k])
            total = total + term
        return total * g

    return block


def ad_pair_fn(
    kappa: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    op_x: LinearOp,
    op_y: LinearOp,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Derivative block via nested ``torch.func.grad`` (test oracle)."""

    def one_pair(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for cx, ax in op_x.terms:
            for cy, ay in op_y.terms:
                f = kappa
                for k, n in enumerate(ax):
                    for _ in range(n):
                        f = _grad_component(f, 0, k)
                for k, n in enumerate(ay):
                    for _ in range(n):
                        f = _grad_component(f, 1, k)
                total = total + cx * cy * f(x, y)
        return total

    def block(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        inner = torch.func.vmap(one_pair, in_dims=(None, 0))
        return torch.func.vmap(inner, in_dims=(0, None))(X, Y)

    return block


def _grad_component(f, argnum: int, axis: int):
    def g(x, y):
        if argnum == 0:
            return torch.func.grad(lambda xx: f(xx, y))(x)[axis]
        return torch.func.grad(lambda yy: f(x, yy))(y)[axis]

    return g
