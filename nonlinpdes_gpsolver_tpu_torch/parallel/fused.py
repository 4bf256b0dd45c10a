"""Fused assemble-and-factorize: the Gram matrix is never materialized.

Counterpart of ``nonlinpdes_gpsolver_tpu/parallel/fused.py``, at P = 1. The
factor ``L`` (``n_pad x n_pad``, zero to start) is built left-looking in
superblocks of ``S`` columns (:func:`_superblocks`). Superblock ``j``,
columns ``[c0, c0 + S)``:

1. one K2 launch writes the equilibrated strip of the trailing rows
   ``[c0, n_pad)`` x ``S`` columns straight into the factor's column panel
   ``L[c0:, c0:c0+S]`` (the JAX package evaluates it in XLA, ``:188-212``,
   because its Pallas kernel miscompiled inside that executable;
   ``:168-181``);
2. the update ``panel -= L[c0:, :c0] L[c0:c0+S, :c0]^T``, as GEMMs over
   ``chunk_cols``-wide column chunks (``:218-238``), accumulated in f64:
   in f32 the rounding of sums over up to ``n`` products reaches the size
   of the nugget's share of the Schur complement, and on an H100 the
   16,200-row elliptic factor then took two tenfold rungs (the dense path
   one) and missed the accuracy gate (fault P3, ROADMAP); in f64 it took
   one (PERF.md);
3. the ``S x S`` diagonal is factored once and inverted, both in f64 (the
   dense path's Cholesky, ``ops/linalg.py::cholesky_f64``: the f32 one
   failed on positive definite matrices, fault P1), its inverse refined by
   one Newton step; the ``B x B`` diagonal blocks of that inverse are the
   factor's ``diag_inv`` (``:241-257``);
4. the panel solve below the diagonal is one GEMM against the inverse
   (``:259-272``), in f64, stored in the factor's dtype.

Kernel evaluations cover the lower triangle only; the update GEMMs run at
the textbook ``n^3/6`` multiply-adds; device memory holds the factor, the
f64 panel, one f64 copy of an update chunk and the small diagonal pieces.

Escalation (``:292-311``): a superblock diagonal whose f64 Cholesky fails
(one host read per superblock) ends the attempt; the factor is zeroed and
the next attempt runs at ten times the nugget scale. No second factor is
ever alive. The finite-but-wrong class is guarded by
:func:`sampled_row_quality` (``:451-515``): a few rows of the equilibrated
matrix, assembled again by K1 cross-Gram launches, against ``L (L^T v)``.

Zero start: every read of ``L`` at columns ``>= c0`` returns 0 in
superblock ``j`` (those columns are written at their own step), and the
rows above a panel are never written, so the factor's upper triangle is 0.
"""

from __future__ import annotations

import itertools
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..ops.assembly import cross_gram, observable_sizes
from ..ops.gram_tile import GramPlan
from ..ops.linalg import cholesky_f64, newton_refine_tri_inverse, tri_inverse
from .cholesky import BlockCyclicFactor, pad_to_blocks
from .gram import _diag_const, _equilibration_parts, _segments, window_sets
from .mesh import Mesh, check_one_device


def _superblocks(nb: int, F: int):
    """Partition of the ``nb`` block-columns into superblocks of at most
    ``F`` block-columns, the last possibly smaller (``:90``)."""
    F = max(1, min(F, nb))
    return [(k, min(F, nb - k)) for k in range(0, nb, F)]


def _seg_ranges(segs, c0: int, c1: int, n: int):
    """``(op, lo, hi)`` column ranges of the segment layout cut to the
    window ``[c0, c1)`` (offsets relative to ``c0``), with ``op=None`` for
    the padding tail beyond ``n`` (``:97``)."""
    ranges = []
    for start, size, op in segs:
        lo, hi = max(start, c0), min(start + size, c1)
        if hi > lo:
            ranges.append((op, lo - c0, hi - c0))
    if c1 > n:
        ranges.append((None, max(n, c0) - c0, c1 - c0))
    return ranges


@lru_cache(maxsize=512)
def window_plan(kernel, observables, sizes, c0: int, c1: int, n_pad: int) -> GramPlan:
    """The K2 plan of rows ``[c0, n_pad)`` x columns ``[c0, c1)`` of the
    padded equilibrated Gram matrix of ``observables`` (point counts
    ``sizes``): one superblock window, or with ``c0 = 0, c1 = n_pad`` the
    whole matrix. :func:`_seg_ranges` cuts the segment layout on both axes;
    each block pairs a row range with a column range, its point sets are
    row slices of the segments' point sets (``plan.set_keys`` holds
    ``(key, lo, hi)``, shared where they coincide), and fill blocks cover
    the padding rows and columns. Cached, one plan per window."""
    offs = list(itertools.accumulate(sizes, initial=0))
    n = offs[-1]
    if not 0 <= c0 < min(n, c1) or c1 > n_pad:
        raise ValueError(f"window [{c0}, {c1}) of {n} rows padded to {n_pad}")
    indexed = [(start, size, i) for i, (start, size) in enumerate(zip(offs, sizes))]
    rows = [r for r in _seg_ranges(indexed, c0, n_pad, n) if r[0] is not None]
    cols = [r for r in _seg_ranges(indexed, c0, c1, n) if r[0] is not None]
    set_of = {}

    def set_index(i, lo, hi):  # observable i's points at window offsets [lo, hi)
        key = (observables[i].points, c0 + lo - offs[i], c0 + hi - offs[i])
        return set_of.setdefault(key, len(set_of))

    entries = [
        (observables[i].op, observables[j].op, set_index(i, rlo, rhi), set_index(j, clo, chi),
         rlo, clo, False)
        for i, rlo, rhi in rows
        for j, clo, chi in cols
    ]
    h, S, real = n_pad - c0, c1 - c0, n - c0
    real_cols = min(n, c1) - c0
    fills = [(real, 0, h - real, S)] if h > real else []
    if S > real_cols:
        fills.append((0, real_cols, real, S - real_cols))
    keys = tuple(set_of)
    return GramPlan(kernel, entries, [hi - lo for _, lo, hi in keys], (h, S), keys,
                    fills=fills, equilibrated=True)


def check_tf32_off() -> None:
    """The update GEMMs and panel solves need full f32 products."""
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: the mesh path's factor "
            "needs full f32 products (the package turns TF32 off when imported)"
        )


def _superblock(L, winvs, d_pad, kb0: int, F: int, B: int, plan_of, sets_of,
                chunk_cols: int) -> bool:
    """Superblock ``kb0 .. kb0 + F - 1`` of the factor, in place; False if
    its diagonal's Cholesky failed (one host read)."""
    c0, S = kb0 * B, F * B
    f64 = torch.float64
    panel = L[c0:, c0 : c0 + S]
    plan = plan_of(c0, c0 + S)
    plan.run_equilibrated(sets_of(plan), d_pad[c0:], d_pad[c0 : c0 + S], out=panel)
    acc = panel.to(f64)  # the panel itself when the factor is f64
    Wc = max(1, chunk_cols // B) * B
    for start in range(0, c0, Wc):
        stop = min(start + Wc, c0)
        acc.addmm_(L[c0:, start:stop].to(f64), L[c0 : c0 + S, start:stop].to(f64).T, alpha=-1.0)
    L_sup, ok = cholesky_f64(acc[:S])
    if not ok:
        return False
    W_sup = newton_refine_tri_inverse(L_sup, tri_inverse(L_sup))
    winvs[kb0 : kb0 + F] = W_sup.view(F, B, F, B).diagonal(dim1=0, dim2=2).permute(2, 0, 1)
    if panel.shape[0] > S:
        panel[S:] = acc[S:] @ W_sup.T
    panel[:S] = L_sup
    return True


class FusedFactor(NamedTuple):
    """What :func:`assemble_factor_fused` returns."""

    factor: BlockCyclicFactor
    d_isqrt: torch.Tensor  # the equilibration of the accepted (or last) attempt, length n
    scale: float  # the nugget scale the accepted factor used (advanced past the last on failure)
    ok: bool  # a finite factor within max_attempts
    attempts: int  # factorization attempts (1 + escalations)
    superblocks: int  # superblocks computed over all attempts


def assemble_factor_fused(kernel, observables, points, mesh: Mesh, axis: str = "p",
                          block: int = 256, nugget: float = 1e-10,
                          nugget_type: str = "adaptive", nugget_scale: float = 1.0,
                          chunk_cols: int = 4096, superblock_cols: int = 2048,
                          max_attempts: int = 8) -> FusedFactor:
    """Factor the never-materialized equilibrated regularized Gram matrix
    (``:395``), escalating the nugget scale tenfold from ``nugget_scale``
    while a superblock diagonal fails, for at most ``max_attempts``
    attempts. ``superblock_cols`` is the panel width ``S`` (the JAX
    package's 2048, measured on its accelerator; a multiple of ``block``)."""
    check_one_device(mesh)
    check_tf32_off()
    observables = tuple(observables)
    sizes = observable_sizes(observables, points)
    ref = points[observables[0].points]
    dtype, device = ref.dtype, mesh.device
    n = sum(sizes)
    n_pad = pad_to_blocks(n, block, mesh.size)
    nb, pad = n_pad // block, n_pad - n
    c_vec, nug_vec = _equilibration_parts(kernel, _segments(observables, points), nugget_type,
                                          nugget, dtype, device)
    # the padding's identity tail: constant 1, no nugget, so d = 1 exactly
    c_pad = torch.cat([c_vec, c_vec.new_ones(pad)])
    nug_pad = torch.cat([nug_vec, nug_vec.new_zeros(pad)])

    def plan_of(c0, c1):
        return window_plan(kernel, observables, sizes, c0, c1, n_pad)

    def sets_of(plan):
        return window_sets(plan, points)

    L = torch.zeros((n_pad, n_pad), dtype=dtype, device=device)
    winvs = torch.zeros((nb, block, block), dtype=dtype, device=device)
    sbs = _superblocks(nb, max(1, superblock_cols // block))
    s, done = float(nugget_scale), 0
    for attempt in range(1, max_attempts + 1):
        if attempt > 1:
            L.zero_()
        d_pad = torch.rsqrt(c_pad + s * nug_pad)
        for kb0, F in sbs:
            done += 1
            if not _superblock(L, winvs, d_pad, kb0, F, block, plan_of, sets_of, chunk_cols):
                break
        else:
            fac = BlockCyclicFactor(L.view(nb, block, n_pad), mesh, axis, block, n, n_pad, winvs)
            return FusedFactor(fac, d_pad[:n], s, True, attempt, done)
        s *= 10.0
    fac = BlockCyclicFactor(L.view(nb, block, n_pad), mesh, axis, block, n, n_pad, winvs)
    return FusedFactor(fac, d_pad[:n], s, False, max_attempts, done)


def _sampled_rows_matvec(kernel, observables, points, row_layout, d_isqrt, v):
    """``(rows, A~[rows, :] v)`` for the sampled rows (``:451``): each
    segment's rows assembled again by one K1 cross-Gram launch,
    independently of the factorization. ``row_layout`` holds
    ``(op, points key, segment row offset, local indices)`` per segment."""
    n = d_isqrt.shape[0]
    vn = v[:n] * d_isqrt
    rows_all, ys = [], []
    for op, key, off, idx in row_layout:
        idx_t = torch.as_tensor(idx, device=v.device)
        strip = cross_gram(kernel, op, points[key][idx_t], observables, points)
        rows = off + idx_t
        d_r = d_isqrt[rows]
        y = (strip @ vn) * d_r
        # the assembled matrix has an exact unit diagonal (the nugget is
        # folded into d): correct the sampled rows' diagonal term
        # theta(x, x) d^2 -> 1
        y = y + v[rows] * (1.0 - d_r * d_r * _diag_const(kernel, op))
        rows_all.append(rows)
        ys.append(y)
    return torch.cat(rows_all), torch.cat(ys)


def sampled_row_quality(fac: BlockCyclicFactor, kernel, observables, points, d_isqrt,
                        rows_per_segment: int = 32) -> float:
    """Relative residual ``max|(L L^T v - A~ v)[S]| / max|(A~ v)[S]|`` on
    the fixed probe ``v`` (numpy seed 0) over ``rows_per_segment`` evenly
    spaced rows of every segment (``:478``); one host read."""
    observables = tuple(observables)
    layout = []
    for o, (off, size, op) in zip(observables, _segments(observables, points)):
        take = min(rows_per_segment, size)
        idx = tuple(np.linspace(0, size - 1, take).astype(int).tolist())
        layout.append((op, o.points, off, idx))
    Lm = fac.matrix
    v = torch.as_tensor(np.random.default_rng(0).standard_normal(fac.n_pad), dtype=Lm.dtype,
                        device=Lm.device)
    rows, y = _sampled_rows_matvec(kernel, observables, points, layout, d_isqrt, v)
    w = Lm @ (Lm.T @ v)
    return float(torch.max(torch.abs(w[rows] - y)) / torch.max(torch.abs(y)))
