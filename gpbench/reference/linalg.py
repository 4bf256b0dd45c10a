"""The plain reference's linear algebra and its precision.

A :class:`Precision` names the dtype the reference computes in and how its
matrix products round: ``"float64"`` (the reference), or ``"tf32"`` (the
control: float32 with every matrix product's inputs rounded to TF32's 10
bits of mantissa, as the card's tensor cores take them, accumulated in
float32). The rounding is done here, so that the control reads the same
on the CPU and on the card.

The regularization follows the configuration: the trace-adaptive nugget
(identity blocks ``nugget``, a derivative block ``nugget`` times the ratio
of its trace to that of the identity blocks), scaled by
``max(1, 4 eps / nugget)`` of the configuration's working dtype (a nugget
below a few ulps of it regularizes nothing), and by ten again for as long
as the equilibrated matrix, assembled in that working dtype, has no
Cholesky factor stored in it (:func:`whitening`): the scale a solver in
that dtype settles on, worked out again here.
"""

from __future__ import annotations

import dataclasses

import torch

from . import gaussian


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str = "float64"

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.name == "float64" else torch.float32

    def mm(self, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            A, B = round_tf32(A), round_tf32(B)
        return A @ B


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value (10 mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(x), rounded.view(torch.float32), x)


def adaptive_nugget(segments, a: float, nugget: float, dtype, device) -> torch.Tensor:
    """The diagonal regularizer of a Gram matrix of ``segments``."""
    identity = sum(X.shape[0] for op, X in segments if op == "id")
    parts = []
    for op, X in segments:
        n = X.shape[0]
        ratio = 1.0 if op == "id" else n * gaussian.prior_diagonal(op, a) / identity
        parts.append(torch.full((n,), nugget * ratio, dtype=dtype, device=device))
    return torch.cat(parts)


def escalation_start(nugget: float, working_dtype: torch.dtype) -> float:
    return max(1.0, 4.0 * torch.finfo(working_dtype).eps / nugget)


def factors_in(E: torch.Tensor, working_dtype, block: int = 2048) -> bool:
    """Whether the left-looking Cholesky factorization of ``E`` (float64)
    runs to its end with the factor stored in ``working_dtype`` and every
    product and diagonal block factored in float64: block columns of
    ``block``, each diagonal block's float64 factor must exist and be
    finite."""
    n = E.shape[0]
    L = torch.zeros(E.shape, dtype=working_dtype, device=E.device)
    for c0 in range(0, n, block):
        c1 = min(c0 + block, n)
        left = L[c0:, :c0].to(torch.float64)
        panel = E[c0:, c0:c1] - left @ left[: c1 - c0].T
        Ld, info = torch.linalg.cholesky_ex(panel[: c1 - c0])
        if int(info) != 0 or not bool(torch.isfinite(Ld).all()):
            return False
        L[c0:c1, c0:c1] = Ld.to(working_dtype)
        if c1 < n:
            below = torch.linalg.solve_triangular(Ld, panel[c1 - c0 :].T, upper=False).T
            L[c1:, c0:c1] = below.to(working_dtype)
    return True


def whitening(segments, a: float, nugget: float, dtype, working_dtype, max_rungs: int = 8):
    """``(W, scale)`` of the Gram matrix ``Theta`` of ``segments`` with its
    adaptive nugget: ``W = L^{-1}`` for the Cholesky factor ``L`` of
    ``Theta + scale diag(nug)`` in ``dtype``. The scale starts at
    :func:`escalation_start` and is raised tenfold while that matrix,
    assembled and equilibrated to a unit diagonal in ``working_dtype``
    (the configuration's), has no Cholesky factor stored in that dtype
    (:func:`factors_in`), or while the factorization in ``dtype`` fails."""
    X = segments[0][1]
    theta = gaussian.gram(segments, a)
    nug = adaptive_nugget(segments, a, nugget, dtype, X.device)
    if working_dtype == dtype:
        theta_w, nug_w = theta, nug
    else:
        segs_w = [(op, P.to(working_dtype)) for op, P in segments]
        theta_w = gaussian.gram(segs_w, a)
        nug_w = adaptive_nugget(segs_w, a, nugget, working_dtype, X.device)
    eye = torch.eye(theta.shape[0], dtype=dtype, device=X.device)
    scale = escalation_start(nugget, working_dtype)
    for _ in range(max_rungs):
        A_w = theta_w + torch.diag(scale * nug_w)
        d = torch.rsqrt(torch.diagonal(A_w))
        E = d[:, None] * A_w * d[None, :]
        E.fill_diagonal_(1.0)
        ok = factors_in(E.to(torch.float64), working_dtype)
        del A_w, E
        if ok:
            L, info = torch.linalg.cholesky_ex(theta + torch.diag(scale * nug))
            if int(info) == 0 and bool(torch.isfinite(L).all()):
                return torch.linalg.solve_triangular(L, eye, upper=False), scale
        scale *= 10.0
    raise FloatingPointError(f"no Cholesky factor up to nugget scale {scale:g}")


def gn_direction(prec: Precision, J: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The Gauss-Newton step ``(J^T J)^{-1} J^T r``, by an LU solve (a
    control's rounded normal matrix need not stay positive definite); not
    a number where the normal equations are not finite."""
    H, g = prec.mm(J.T, J), prec.mm(J.T, r[:, None])
    if not bool(torch.isfinite(H).all() and torch.isfinite(g).all()):
        return torch.full_like(r[: J.shape[1]], float("nan"))
    return torch.linalg.solve(H, g)[:, 0]
