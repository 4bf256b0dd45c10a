"""Fused assemble-and-factorize: the Gram matrix is never materialized.

Counterpart of ``nonlinpdes_gpsolver_tpu/parallel/fused.py``. The factor
``L`` (``n_pad x n_pad``, zero to start; each rank holds its block-cyclic
rows, ``parallel/cholesky.py``) is built left-looking in superblocks of
``S`` columns (:func:`_superblocks`). Superblock ``j``, columns
``[c0, c0 + S)``, on each rank:

1. one K2 launch writes the equilibrated strip of the rank's trailing rows
   (its rows of ``[c0, n_pad)``) x ``S`` columns straight into its column
   panel (the JAX package evaluates it in XLA, ``:188-212``, because its
   Pallas kernel miscompiled inside that executable; ``:168-181``); across
   ranks the plan is rank-mapped (``window_plan``);
2. the update ``panel -= L[rows, :c0] L[c0:c0+S, :c0]^T``, as GEMMs over
   ``chunk_cols``-wide column chunks (``:218-238``), accumulated in f64.
   Across ranks the superblock's ``S`` rows over ``[0, c0)`` are gathered
   from their owners once per superblock (the JAX package gathers every
   rank's candidate rows per chunk, ``:234``, P times the bytes). In f64:
   in f32 the rounding of sums over up to ``n`` products reaches the size
   of the nugget's share of the Schur complement, and on an H100 the
   16,200-row elliptic factor then took two tenfold rungs (the dense path
   one) and missed the accuracy gate (fault P3, ROADMAP); in f64 it took
   one (PERF.md);
3. the ``S x S`` diagonal (its f64 rows gathered from their owners,
   ``:243``) is factored once and inverted, both in f64 (the dense path's
   Cholesky, ``ops/linalg.py::cholesky_f64``: the f32 one failed on positive
   definite matrices, fault P1), its inverse refined by one Newton step;
   every rank does this on the same gathered bits, the JAX package's
   replicated diagonal; the ``B x B`` diagonal blocks of that inverse are the
   factor's ``diag_inv`` (``:241-257``);
4. the panel solve below the diagonal is one GEMM against the inverse
   (``:259-272``), in f64, stored in the factor's dtype.

Kernel evaluations cover the lower triangle only; the update GEMMs run at
the textbook ``n^3/6`` multiply-adds (``n^3/6P`` a rank); device memory
holds the factor's shard, the f64 panel, one f64 copy of an update chunk,
the gathered superblock rows and the small diagonal pieces.

Escalation (``:292-311``): a superblock diagonal whose f64 Cholesky fails
(one host read per superblock, agreed across ranks) ends the attempt; the
factor is zeroed and the next attempt runs at ten times the nugget scale.
No second factor is ever alive. The finite-but-wrong class is guarded by
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
from ..ops.linalg import (ESCALATION, MAX_ESCALATIONS, cholesky_f64, newton_refine_tri_inverse,
                          probe_vector, tri_inverse)
from ..utils import tracing
from . import comm
from .cholesky import BlockCyclicFactor, first_slot, local_row, matvec_blockcyclic, pad_to_blocks
from .gram import _diag_const, _equilibration_parts, _segments, window_sets
from .mesh import Mesh


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
def window_plan(kernel, observables, sizes, c0: int, c1: int, n_pad: int, ranks: int = 1,
                rank: int = 0, block: int = 0) -> GramPlan:
    """The K2 plan of rows ``[c0, n_pad)`` x columns ``[c0, c1)`` of the
    padded equilibrated Gram matrix of ``observables`` (point counts
    ``sizes``): one superblock window, or with ``c0 = 0, c1 = n_pad`` the
    whole matrix. :func:`_seg_ranges` cuts the segment layout on both axes;
    each block pairs a row range with a column range, its point sets are
    row slices of the segments' point sets (``plan.set_keys`` holds
    ``(key, lo, hi)``, shared where they coincide), and fill blocks cover
    the padding rows and columns. Cached, one plan per window.

    With ``ranks > 1`` the plan is rank ``rank``'s: its rows are the rank's
    ``block``-row blocks of the window, as a run of its local rows that
    starts at its first slot at or after ``c0`` (``c0`` is a multiple of
    ``block``), and the K2 launch maps them back to the window
    (``GramPlan.row_map``). The segments, sets and scales stay global."""
    offs = list(itertools.accumulate(sizes, initial=0))
    n = offs[-1]
    # across ranks the padding (under P blocks) may hold whole superblocks; on
    # one device a window starts inside the matrix
    if not 0 <= c0 < c1 <= n_pad or (ranks == 1 and c0 >= n):
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
    h, S, real = n_pad - c0, c1 - c0, max(0, n - c0)
    real_cols = max(0, min(n, c1) - c0)
    fills = [(real, 0, h - real, S)] if h > real else []
    if S > real_cols and real:
        fills.append((0, real_cols, real, S - real_cols))
    if not set_of:  # a window in the padding: fill blocks only, and one empty set
        set_of[(observables[0].points, 0, 0)] = 0
    keys = tuple(set_of)
    set_sizes = [hi - lo for _, lo, hi in keys]
    if ranks == 1:
        return GramPlan(kernel, entries, set_sizes, (h, S), keys, fills=fills,
                        equilibrated=True)
    if c0 % block or n_pad % (block * ranks):
        raise ValueError(f"window at {c0} of {n_pad} rows does not fit {ranks} ranks of "
                         f"{block}-row blocks")
    L0 = first_slot(c0 // block, ranks, rank) * block

    def local(lo, hi):  # (first local row, count) of my rows of window rows [lo, hi)
        a, b = (local_row(c0 + r, block, ranks, rank) for r in (lo, hi))
        return a - L0, b - a

    mapped = []
    for op_x, op_y, xs, ys, rlo, clo, mirror in entries:
        lv, cnt = local(rlo, rlo + set_sizes[xs])
        mapped.append((op_x, op_y, xs, ys, lv, clo, mirror, cnt, rlo))
    fills = [(*local(r0, r0 + nr), f0, nf) for r0, f0, nr, nf in fills]
    fills = [(lv, f0, cnt, nf) for lv, cnt, f0, nf in fills if cnt]
    n_local = (n_pad // (block * ranks)) * block - L0
    return GramPlan(kernel, mapped, set_sizes, (n_local, S), keys, fills=fills,
                    equilibrated=True,
                    row_map=(ranks, block, L0, rank * block - c0, h))


def check_tf32_off() -> None:
    """The update GEMMs and panel solves need full f32 products."""
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: the mesh path's factor "
            "needs full f32 products (the package turns TF32 off when imported)"
        )


def _gather_rows(mesh: Mesh, rows: torch.Tensor, kb0: int, F: int, B: int) -> torch.Tensor:
    """The ``F B`` rows of superblock blocks ``kb0 .. kb0 + F - 1``, in order,
    on every rank, from ``rows``: this rank's own of them (the first rows of
    its panel). Each rank pads its share to the largest one for the
    ``all_gather``."""
    P_ = mesh.size
    most = -(-F // P_)
    mine = rows.new_zeros((most * B, *rows.shape[1:]))
    mine[: rows.shape[0]] = rows
    parts = comm.all_gather(mesh, mine)
    out = []
    for g in range(kb0, kb0 + F):
        q = g % P_
        j = g // P_ - first_slot(kb0, P_, q)
        out.append(parts[q, j * B : (j + 1) * B])
    return torch.cat(out)


def _superblock(L, winvs, d_pad, kb0: int, F: int, B: int, mesh: Mesh, plan, sets,
                chunk_cols: int) -> bool:
    """Superblock ``kb0 .. kb0 + F - 1`` of this rank's factor rows ``L``
    (``(nbl B, n_pad)``), in place; False if its diagonal's Cholesky failed
    (one host read, agreed across ranks). At P = 1 the superblock's rows and
    diagonal are views of the panel; across ranks they are gathered."""
    P_, p = mesh.size, mesh.rank
    c0, S = kb0 * B, F * B
    f64 = torch.float64
    L0 = first_slot(kb0, P_, p) * B  # my first row at or below the superblock
    own = [g - kb0 for g in range(kb0, kb0 + F) if g % P_ == p]  # my superblock blocks
    mine = len(own) * B  # their rows: the first of my panel
    panel = L[L0:, c0 : c0 + S]
    if panel.shape[0]:
        plan.run_equilibrated(sets, d_pad[c0:], d_pad[c0 : c0 + S], out=panel)
    acc = panel.to(f64)  # the panel itself when the factor is f64
    if c0:
        R = L[c0 : c0 + S, :c0] if P_ == 1 else _gather_rows(mesh, L[L0 : L0 + mine, :c0], kb0,
                                                              F, B)
        Wc = max(1, chunk_cols // B) * B
        for start in range(0, c0, Wc):
            stop = min(start + Wc, c0)
            acc.addmm_(L[L0:, start:stop].to(f64), R[:, start:stop].to(f64).T, alpha=-1.0)
        del R
    D = acc[:S] if P_ == 1 else _gather_rows(mesh, acc[:mine], kb0, F, B)
    L_sup, ok = cholesky_f64(D)
    if not comm.agree(mesh, tracing.read(bool, ok), "all"):
        return False
    W_sup = newton_refine_tri_inverse(L_sup, tri_inverse(L_sup))
    winvs[kb0 : kb0 + F] = W_sup.view(F, B, F, B).diagonal(dim1=0, dim2=2).permute(2, 0, 1)
    if panel.shape[0] > mine:
        panel[mine:] = acc[mine:] @ W_sup.T
    panel[:mine] = L_sup.view(F, B, S)[own].reshape(mine, S)
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
                          max_attempts: int = MAX_ESCALATIONS, out=None) -> FusedFactor:
    """Factor the never-materialized equilibrated regularized Gram matrix
    (``:395``), escalating the nugget scale tenfold from ``nugget_scale``
    while a superblock diagonal fails, for at most ``max_attempts``
    attempts (the ladder of ``ops/linalg.py``). ``superblock_cols`` is the
    panel width ``S`` (the JAX package's 2048, measured on its accelerator;
    a multiple of ``block``).
    Every rank calls it with the same problem and gets its own shard.
    ``out = (local, diag_inv, d_isqrt)``: storage of the factor's shapes to
    factor into (a released factor of the same layout,
    ``solvers/_reuse.py``) instead of new tensors."""
    check_tf32_off()
    observables = tuple(observables)
    sizes = observable_sizes(observables, points)
    ref = points[observables[0].points]
    dtype, device = ref.dtype, mesh.device
    n = sum(sizes)
    n_pad = pad_to_blocks(n, block, mesh.size)
    nb, pad = n_pad // block, n_pad - n
    nbl = nb // mesh.size
    c_vec, nug_vec = _equilibration_parts(kernel, _segments(observables, points), nugget_type,
                                          nugget, dtype, device)
    # the padding's identity tail: constant 1, no nugget, so d = 1 exactly
    c_pad = torch.cat([c_vec, c_vec.new_ones(pad)])
    nug_pad = torch.cat([nug_vec, nug_vec.new_zeros(pad)])

    if out is None:
        local = torch.zeros((nbl, block, n_pad), dtype=dtype, device=device)
        winvs = torch.zeros((nb, block, block), dtype=dtype, device=device)
        d_out = None
    else:
        local, winvs, d_out = out
        local.zero_()
        winvs.zero_()
    L = local.view(nbl * block, n_pad)
    sbs = _superblocks(nb, max(1, superblock_cols // block))
    plans = {}
    for kb0, F in sbs:
        plan = window_plan(kernel, observables, sizes, kb0 * block, (kb0 + F) * block, n_pad,
                           mesh.size, mesh.rank, block)
        plans[kb0] = plan, window_sets(plan, points)
    s, done, ok = float(nugget_scale), 0, False
    for attempt in range(1, max_attempts + 1):
        if attempt > 1:
            L.zero_()
        d_pad = torch.rsqrt(c_pad + s * nug_pad)
        for kb0, F in sbs:
            done += 1
            if not _superblock(L, winvs, d_pad, kb0, F, block, mesh, *plans[kb0], chunk_cols):
                break
        else:
            ok = True
            break
        s *= ESCALATION
    d_isqrt = d_pad[:n] if d_out is None else d_out.copy_(d_pad[:n])
    fac = BlockCyclicFactor(local, mesh, axis, block, n, n_pad, winvs)
    return FusedFactor(fac, d_isqrt, s, ok, attempt, done)


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
                        rows_per_segment: int = 32) -> torch.Tensor:
    """Relative residual ``max|(L L^T v - A~ v)[S]| / max|(A~ v)[S]|`` on
    the fixed probe ``v`` (numpy seed 0) over ``rows_per_segment`` evenly
    spaced rows of every segment (``:478``), the largest over the ranks
    (each assembles the rows itself; ``w`` is the same on every rank): a
    device scalar, the same on every rank (no host read)."""
    observables = tuple(observables)
    layout = []
    for o, (off, size, op) in zip(observables, _segments(observables, points)):
        take = min(rows_per_segment, size)
        idx = tuple(np.linspace(0, size - 1, take).astype(int).tolist())
        layout.append((op, o.points, off, idx))
    loc, mesh = fac.local, fac.mesh
    v = probe_vector(fac.n_pad, loc.dtype, loc.device)
    rows, y = _sampled_rows_matvec(kernel, observables, points, layout, d_isqrt, v)
    Ltv = matvec_blockcyclic(loc, mesh, fac.axis, fac.block, v, trans=True)
    w = matvec_blockcyclic(loc, mesh, fac.axis, fac.block, Ltv)
    q = torch.max(torch.abs(w[rows] - y)) / torch.max(torch.abs(y))
    return comm.all_gather(mesh, q.reshape(1)).max()
