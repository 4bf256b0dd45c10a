"""The equilibrated Gram matrix of the mesh path, assembled by one K2 launch a rank.

Counterpart of ``nonlinpdes_gpsolver_tpu/parallel/gram.py``. Two facts of a
stationary kernel make the mesh path's equilibration cheap: the diagonal of
``Theta`` is constant on each observable's segment, ``(L (x) L) kappa(0)``,
so the trace-adaptive nugget and the scale ``d^{-1/2} = rsqrt(c + s nug)``
need one evaluation per observable (:func:`_equilibration_parts`); and the
column segments of a strip are contiguous per observable.

:func:`assemble_gram_sharded` is the two-pass path's assembly, kept as the
reference of the fused factorization (``tests/test_torch_fused.py``, as
``tests/test_fused.py`` holds the JAX package's): the padded, equilibrated,
regularized matrix ``D^{-1/2} (Theta + s nug) D^{-1/2}``, unit diagonal and
identity tail included, in one K2 launch over the ``(n_pad, n_pad)``
window; across ranks each rank's launch writes only its own block-cyclic
rows (a rank-mapped plan), as the JAX package's ``shard_map`` body does
(``:56-123``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.assembly import observable_sizes
from .cholesky import pad_to_blocks
from .mesh import Mesh


def _segments(observables, points) -> Tuple[Tuple[int, int, object], ...]:
    """Static ``(start, size, op)`` row/column layout of the block Gram
    matrix (``:45``)."""
    segs, off = [], 0
    for o in observables:
        size = int(points[o.points].shape[0])
        segs.append((off, size, o.op))
        off += size
    return tuple(segs)


def _diag_const(kernel, op) -> float:
    """``(op (x) op) kappa(x, x)``, the same at every ``x`` (stationarity),
    by the closed form at one point in f64."""
    x0 = torch.zeros((1, kernel.dim), dtype=torch.float64)
    return float(kernel.pair_fn(op, op)(x0, x0)[0, 0])


def _equilibration_parts(kernel, segs_pts, nugget_type: str, nugget: float, dtype,
                         device="cpu"):
    """Per-row ``(diagonal constant, nugget share)`` vectors of length n
    (``:141``): the constant ``(L (x) L) kappa(0)`` of each segment, and its
    share of the trace-adaptive nugget (identity segments ``nugget``, the
    others ``nugget * size c / anchor``, the anchor being the identity
    segments' trace). The equilibration at scale ``s`` is
    ``rsqrt(c + s nug)``."""
    consts = [_diag_const(kernel, op) for _, _, op in segs_pts]
    if nugget_type == "none":
        nuggets = [0.0] * len(segs_pts)
    elif nugget_type == "identity":
        nuggets = [float(nugget)] * len(segs_pts)
    elif nugget_type == "adaptive":
        anchor = sum(size * c for (_, size, op), c in zip(segs_pts, consts) if op.is_identity)
        nuggets = [
            float(nugget) * (1.0 if op.is_identity else size * c / anchor)
            for (_, size, op), c in zip(segs_pts, consts)
        ]
    else:
        raise ValueError(f"unknown nugget_type {nugget_type!r}")
    kw = dict(dtype=dtype, device=device)
    c_vec = torch.cat([torch.full((size,), c, **kw) for (_, size, _), c in zip(segs_pts, consts)])
    nug_vec = torch.cat(
        [torch.full((size,), g, **kw) for (_, size, _), g in zip(segs_pts, nuggets)]
    )
    return c_vec, nug_vec


def _equilibration_diag(kernel, segs_pts, nugget_scale, nugget_type: str, nugget: float,
                        dtype, device="cpu"):
    """``d^{-1/2}`` of the equilibrated regularized Gram matrix at the
    escalation scale ``nugget_scale`` (``:184``)."""
    c_vec, nug_vec = _equilibration_parts(kernel, segs_pts, nugget_type, nugget, dtype, device)
    return torch.rsqrt(c_vec + float(nugget_scale) * nug_vec)


def window_sets(plan, points):
    """The point sets of a window plan: row slices of ``points``."""
    return [points[key][lo:hi] for key, lo, hi in plan.set_keys]


def assemble_gram_sharded(kernel, observables, points, mesh: Mesh, axis: str = "p",
                          block: int = 256, nugget: float = 1e-10,
                          nugget_type: str = "adaptive", nugget_scale: float = 1.0, out=None):
    """This rank's ``(nbl, B, n_pad)`` shard of the equilibrated regularized
    Gram matrix, and ``d^{-1/2}`` (``:248``): one K2 launch writes
    ``1 if i == j else d_i d_j Theta_ij`` over the rank's rows of the padded
    matrix, the identity tail included; into ``out`` (contiguous, of the
    shard's shape) where given."""
    from .fused import window_plan

    observables = tuple(observables)
    segs = _segments(observables, points)
    n = sum(size for _, size, _ in segs)
    ref = points[observables[0].points]
    d_isqrt = _equilibration_diag(kernel, segs, nugget_scale, nugget_type, nugget, ref.dtype,
                                  ref.device)
    n_pad = pad_to_blocks(n, block, mesh.size)
    d_pad = torch.cat([d_isqrt, d_isqrt.new_ones(n_pad - n)])
    plan = window_plan(kernel, observables, observable_sizes(observables, points), 0, n_pad,
                       n_pad, mesh.size, mesh.rank, block)
    out = (torch.empty(plan.shape, dtype=ref.dtype, device=mesh.device) if out is None
           else out.view(plan.shape))
    plan.run_equilibrated(window_sets(plan, points), d_pad, d_pad, out=out)
    return out.view(-1, block, n_pad), d_isqrt
