"""Gram assembly kernel K1: whole derivative-kernel Gram matrices on the card.

Counterpart of ``nonlinpdes_gpsolver_tpu/ops/pallas_gram.py``. The CUDA
kernel (``csrc/gram_tile.cu``) evaluates

    out[i, j] = sum_beta c_beta * prod_k p_{beta_k}(u_k) * exp(-sum_k a_k u_k^2)

with ``u = x_i - y_j`` for every block of a :class:`GramPlan` in one launch.
A plan lists the blocks of one output matrix: for each, its operator pair's
merged term table (:func:`pack_terms`, from the same :func:`_combined_terms`
as the Pallas kernel), its row and column point sets, its offsets in the
output, whether the kernel also writes its transpose (the mirror block of a
symmetric Gram matrix), and whether it is symmetric (same operator, same
points), so that only its upper tiles are computed. Plans are cached by
:func:`gram_plan` (a training Gram matrix), :func:`cross_plan` (a
cross-Gram) and :func:`pair_plan` (one block, behind
:func:`gram_tile_pair_fn`).

K2, a kernel of its own in the same source, walks the same plans with an
equilibrating epilogue (the strips of the JAX package's mesh path,
``parallel/fused.py:188`` and ``parallel/gram.py:109``): an *equilibrated*
plan (``equilibrated=True``, built by ``parallel/fused.py::window_plan``)
computes every entry of its blocks, has fill blocks for the padding, and
runs through :meth:`GramPlan.run_equilibrated`, which writes
``1 if i == j else d_r[i] d_c[j] K[i, j]`` into an output view that starts
on the matrix's diagonal. K2 stores its finished tiles by TMA while it
evaluates the next (:meth:`GramPlan.k2_tiles` lists which tiles go that
way). A *rank-mapped* K2 plan (``row_map``) writes only the rows that one
rank of a P-rank mesh owns in the block-cyclic layout, into that rank's
local rows (``csrc/gram_tile.cu``, "K2 on a rank's block-cyclic rows").

Which version runs depends only on where the tensors lie: for CPU tensors
:meth:`GramPlan.run` walks the blocks with the plain version
(``SquaredExponential.pair_fn``, and for K2 the same scaling and unit
diagonal in torch); for CUDA tensors it launches the kernel, in f32 or f64,
and raises for any other dtype. ``LAUNCHES`` and ``K2_LAUNCHES`` count
kernel launches, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import bisect
import ctypes
import dataclasses
import itertools
import math
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

from .kernels import SquaredExponential, _derivative_poly_coeffs
from .operators import LinearOp

# Limits of csrc/gram_tile.cu, in the order of gram_plan_limits(); checked
# against the built library when it is loaded.
_LIMITS = dict(
    dim=3, degree=8, terms=64, plan_terms=128, sets=8, blocks=36, tables=36,
    tile=64, block_ints=10,
)
MAX_DIM = _LIMITS["dim"]
MAX_DEGREE = _LIMITS["degree"]
MAX_TERMS = _LIMITS["terms"]
TILE = _LIMITS["tile"]
_STEPS = MAX_DEGREE // 2 + 1  # Horner coefficients in u^2 per polynomial
_MIRROR, _SYMMETRIC, _FILL = 1, 2, 8

LAUNCHES = 0
"""Number of K1 launches in this process (the wrapper adds one per launch)."""
K2_LAUNCHES = 0
"""Number of K2 launches (the equilibrated strip kernel) in this process."""


def _combined_terms(inv_sq, terms_x, terms_y):
    """(coefficient, per-dim polynomial coeff tables) for each merged beta."""
    combined = {}
    for cx, ax in terms_x:
        for cy, ay in terms_y:
            sign = -1.0 if (sum(ay) % 2) else 1.0
            beta = tuple(i + j for i, j in zip(ax, ay))
            combined[beta] = combined.get(beta, 0.0) + cx * cy * sign
    out = []
    for beta, coef in combined.items():
        if coef == 0.0:
            continue
        polys = tuple(
            tuple(_derivative_poly_coeffs(b, a)) if b > 0 else None
            for b, a in zip(beta, inv_sq)
        )
        out.append((coef, polys))
    return tuple(out)


def pack_terms(inv_sq, terms_x, terms_y):
    """The kernel's tables as float64/int32 numpy arrays.

    ``table``: ``inv_sq`` (dim values), then per merged term its coefficient
    and, per dimension, the ascending Horner coefficients of its polynomial
    zero-padded to ``MAX_DEGREE + 1``. ``degs``: (n_terms, dim) polynomial
    degrees, 0 where the term has no factor in that dimension.
    """
    dim = len(inv_sq)
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"the Gram tile kernel takes dim 1..{MAX_DIM}, got {dim}")
    terms = _combined_terms(inv_sq, terms_x, terms_y)
    if len(terms) > MAX_TERMS:
        raise ValueError(
            f"operator pair has {len(terms)} merged terms; the kernel takes "
            f"at most {MAX_TERMS}"
        )
    table = [float(a) for a in inv_sq]
    degs = []
    for coef, polys in terms:
        table.append(float(coef))
        for coeffs in polys:
            row = np.zeros(MAX_DEGREE + 1)
            if coeffs is not None:
                if len(coeffs) > MAX_DEGREE + 1:
                    raise ValueError(
                        f"derivative order {len(coeffs) - 1} exceeds the "
                        f"kernel's maximum {MAX_DEGREE}"
                    )
                row[: len(coeffs)] = coeffs
            table.extend(row.tolist())
            degs.append(0 if coeffs is None else len(coeffs) - 1)
    return (
        np.asarray(table, np.float64),
        np.asarray(degs, np.int32).reshape(len(terms), dim),
    )


@dataclasses.dataclass(frozen=True)
class PlanBlock:
    """One block of a plan: ``out[row_off:+n, col_off:+m]`` is
    ``(op_x (x) op_y) kappa`` of table ``table`` on point sets
    ``x_set`` (rows) and ``y_set`` (columns)."""

    row_off: int
    col_off: int
    n: int
    m: int
    x_set: int
    y_set: int
    table: int
    mirror: bool  # also write the transpose at out[col_off:+m, row_off:+n]
    symmetric: bool  # same operator and points on the diagonal: upper tiles only
    tile_start: int  # first flat tile index of the block in the launch grid
    fill: bool = False  # K2 padding: zeros (and the unit diagonal), no points
    x_row0: int = 0  # window row of the row set's first point (row_off unless row-mapped)

    @property
    def tiles(self) -> int:
        tm, tn = -(-self.n // TILE), -(-self.m // TILE)
        return tm * (tm + 1) // 2 if self.symmetric else tm * tn


class GramPlan:
    """One K1 launch: a ``shape`` output assembled from ``len(set_sizes)`` point sets.

    ``entries`` lists ``(op_x, op_y, x_set, y_set, row_off, col_off, mirror)``
    per block; ``set_sizes`` the number of points in each set. Empty blocks
    are dropped; operator pairs that repeat share one table.

    ``equilibrated=True`` makes it a K2 plan: no block is mirrored or
    computed as symmetric, ``fills`` lists ``(row_off, col_off, n, m)``
    blocks of padding, and it runs through :meth:`run_equilibrated`.

    ``row_map = (P, B, L0, shift, d_rows)`` makes a K2 plan rank-mapped: its
    rows are local rows of one rank's shard, local row ``v`` of the output
    is window row ``((L0 + v) // B) * P * B + (L0 + v) % B + shift``
    (:meth:`window_rows`), and each entry carries two more fields, its row
    count and ``x_row0``, the window row of its row set's first point; the
    row scales ``d_r`` hold one scale per window row (``d_rows`` of them).
    """

    def __init__(self, kernel: SquaredExponential, entries, set_sizes, shape, set_keys=(),
                 fills=(), equilibrated: bool = False, row_map=None):
        self.kernel = kernel
        self.set_keys = tuple(set_keys)  # the points dict's key of each training set
        self.set_sizes = tuple(int(s) for s in set_sizes)
        self._set_shapes = tuple((s, kernel.dim) for s in self.set_sizes)
        self.shape = tuple(int(s) for s in shape)
        self.equilibrated = bool(equilibrated)
        if len(self.set_sizes) > _LIMITS["sets"]:
            raise ValueError(f"a plan takes at most {_LIMITS['sets']} point sets")
        if fills and not self.equilibrated:
            raise ValueError("fill blocks belong to equilibrated (K2) plans")
        if row_map is not None and not self.equilibrated:
            raise ValueError("a row map belongs to equilibrated (K2) plans")
        self.row_map = None if row_map is None else tuple(int(v) for v in row_map[:4])
        self.d_rows = self.shape[0] if row_map is None else int(row_map[4])
        table_of, self.pairs, blocks, tiles = {}, [], [], 0
        for op_x, op_y, xs, ys, row_off, col_off, mirror, *mapped in entries:
            n, m = self.set_sizes[xs], self.set_sizes[ys]
            x_row0 = row_off
            if self.row_map is not None:
                n, x_row0 = mapped
            key = (op_x.terms, op_y.terms)
            if key not in table_of:
                table_of[key] = len(self.pairs)
                self.pairs.append((op_x, op_y))
            if n == 0 or m == 0:
                continue
            if mirror and self.equilibrated:
                raise ValueError("an equilibrated (K2) plan has no mirrored blocks")
            symmetric = (
                not self.equilibrated and not mirror and key[0] == key[1] and xs == ys
                and row_off == col_off
            )
            if (row_off + n > self.shape[0] or col_off + m > self.shape[1]
                    or (mirror and (col_off + m > self.shape[0] or row_off + n > self.shape[1]))):
                raise ValueError(f"block at ({row_off}, {col_off}) lies outside {self.shape}")
            blk = PlanBlock(row_off, col_off, n, m, xs, ys, table_of[key], bool(mirror),
                            symmetric, tiles, x_row0=x_row0)
            blocks.append(blk)
            tiles += blk.tiles
        for row_off, col_off, n, m in fills:
            if n < 1 or m < 1 or row_off + n > self.shape[0] or col_off + m > self.shape[1]:
                raise ValueError(f"fill block ({row_off}, {col_off}, {n}, {m}) outside {self.shape}")
            blk = PlanBlock(row_off, col_off, n, m, 0, 0, 0, False, False, tiles, fill=True,
                            x_row0=row_off)
            blocks.append(blk)
            tiles += blk.tiles
        self.blocks = tuple(blocks)
        self.n_tiles = tiles
        if len(self.blocks) > _LIMITS["blocks"] or len(self.pairs) > _LIMITS["tables"]:
            raise ValueError(
                f"a plan takes at most {_LIMITS['blocks']} blocks and "
                f"{_LIMITS['tables']} operator pairs"
            )
        self.tables = tuple(
            pack_terms(kernel.inv_sq, ox.terms, oy.terms) for ox, oy in self.pairs
        )
        self._pack()

    def _pack(self):
        """Flatten the tables and descriptors into the kernel's arrays."""
        dim = self.kernel.dim
        # p_b has the parity of b: poly[k, b, i] is its coefficient of
        # u^(b - 2 i), so that the kernel runs Horner in u^2.
        poly = np.zeros((dim, MAX_DEGREE + 1, _STEPS))
        coef, degs, term_start = [], [], [0]
        stride = MAX_DEGREE + 1
        for table, tdegs in self.tables:
            rows = table[dim:].reshape(len(tdegs), 1 + dim * stride)
            for row, deg in zip(rows, tdegs):
                coef.append(row[0])
                degs.append(deg)
                for k, b in enumerate(deg):
                    # p_b depends only on (k, b): one copy per plan
                    cf = row[1 + k * stride : 1 + k * stride + b + 1]
                    poly[k, b, : b // 2 + 1] = cf[b::-2]
            term_start.append(len(coef))
        if len(coef) > _LIMITS["plan_terms"]:
            raise ValueError(
                f"plan has {len(coef)} merged terms; the kernel takes at most "
                f"{_LIMITS['plan_terms']} per launch"
            )
        self._arrays = dict(
            inv_sq=np.asarray(self.kernel.inv_sq, np.float64),
            poly=np.ascontiguousarray(poly),
            coef=np.asarray(coef, np.float64),
            degs=np.asarray(degs, np.int32).reshape(-1, dim),
            term_start=np.asarray(term_start, np.int32),
            blocks=np.asarray(
                [[b.row_off, b.col_off, b.n, b.m, b.x_set, b.y_set, b.table,
                  _MIRROR * b.mirror + _SYMMETRIC * b.symmetric + _FILL * b.fill, b.x_row0,
                  b.tile_start]
                 for b in self.blocks] or np.zeros((0, _LIMITS["block_ints"])),
                np.int32,
            ),
            row_map=np.asarray(self.row_map or (0, 0, 0, 0), np.int32),
        )
        self._params = {}  # the kernel's packed parameters, per dtype

    def _packed(self, lib, is_double: int):
        """The plan's kernel parameters for one dtype, packed once."""
        params = self._params.get(is_double)
        if params is None:
            a = {k: v.ctypes.data for k, v in self._arrays.items()}
            params = ctypes.create_string_buffer(lib.gram_plan_params_size(is_double))
            err = lib.gram_plan_pack(
                is_double, self.kernel.dim, len(self.set_sizes), a["blocks"], len(self.blocks),
                a["inv_sq"], a["poly"], a["coef"], a["degs"], a["term_start"],
                len(self.tables), a["row_map"], params,
            )
            if err != 0:
                raise RuntimeError(f"gram_tile kernel refused the plan: CUDA error {err}")
            params = self._params[is_double] = ctypes.addressof(params), params
        return params[0]

    def tile_coords(self, index: int) -> Tuple[int, int, int]:
        """(block, tile row, tile column) of flat tile ``index``, as the
        kernel maps its CTA index (symmetric blocks: upper tiles by columns)."""
        b = bisect.bisect_right([blk.tile_start for blk in self.blocks], index) - 1
        blk = self.blocks[b]
        local = index - blk.tile_start
        if blk.symmetric:
            tc = int((math.sqrt(8.0 * local + 1.0) - 1.0) * 0.5)
            while tc * (tc + 1) // 2 > local:
                tc -= 1
            while (tc + 1) * (tc + 2) // 2 <= local:
                tc += 1
            return b, local - tc * (tc + 1) // 2, tc
        tr, tc = divmod(local, -(-blk.m // TILE))
        return b, tr, tc

    def _checked_out(self, sets, out):
        """Check the point sets and ``out``; ``out`` (allocated if ``None``)."""
        if len(sets) != len(self._set_shapes):
            raise ValueError(f"plan takes {len(self._set_shapes)} point sets, got {len(sets)}")
        ref = sets[0]
        dtype, dev = ref.dtype, ref.get_device()  # an int: cheaper than Tensor.device
        for s, shape in zip(sets, self._set_shapes):
            if s.dtype != dtype or s.get_device() != dev:
                raise ValueError("point sets must share device and dtype")
            if s.shape != shape:
                raise ValueError(f"point sets must be {shape}; got {tuple(s.shape)}")
        n, m = self.shape
        if out is None:
            return torch.empty(self.shape, dtype=dtype, device=ref.device)
        if (
            out.shape != self.shape or out.dtype != dtype or out.get_device() != dev
            or (m > 1 and out.stride(1) != 1) or (n > 1 and out.stride(0) < m)
        ):
            raise ValueError(
                f"out must be an {self.shape} {dtype} view on {ref.device} with unit "
                f"column stride; got {tuple(out.shape)} strides {out.stride()}"
            )
        return out

    def run(self, sets: Sequence[torch.Tensor], out: torch.Tensor | None = None):
        """Assemble into ``out`` (allocated if ``None``; else a view of
        ``shape`` with unit column stride, such as a slot of a larger
        matrix) from the point sets, ``sets[s]`` of shape (set_sizes[s], dim)."""
        if self.equilibrated:
            raise ValueError("an equilibrated (K2) plan runs through run_equilibrated")
        out = self._checked_out(sets, out)
        ref = sets[0]
        if ref.is_cuda:
            self._launch(sets, out, ref.get_device())
        elif ref.is_cpu:
            self._plain(sets, out)
        else:
            raise ValueError(f"no Gram tile implementation for device {ref.device}")
        return out

    def run_equilibrated(self, sets: Sequence[torch.Tensor], d_r: torch.Tensor,
                         d_c: torch.Tensor, out: torch.Tensor | None = None):
        """K2: ``out[i, j] = 1 if i == j else d_r[i] d_c[j] K[i, j]``, every
        entry written once (fill blocks: 0 off the diagonal). ``out`` is a
        view of ``shape`` with unit column stride whose first entry lies on
        the matrix's diagonal; ``d_r`` and ``d_c`` hold one scale per row and
        per column of it, contiguous, like the point sets."""
        if not self.equilibrated:
            raise ValueError("run_equilibrated needs an equilibrated (K2) plan")
        out = self._checked_out(sets, out)
        ref = sets[0]
        for v, size in ((d_r, self.d_rows), (d_c, self.shape[1])):
            if (v.shape != (size,) or v.dtype != ref.dtype or v.get_device() != ref.get_device()
                    or not v.is_contiguous()):
                raise ValueError(
                    f"scales must be contiguous ({size},) {ref.dtype} on {ref.device}; "
                    f"got {tuple(v.shape)} {v.dtype} on {v.device}"
                )
        if ref.is_cuda:
            self._launch(sets, out, ref.get_device(), d_r, d_c)
        elif ref.is_cpu:
            self._plain_equilibrated(sets, d_r, d_c, out)
        else:
            raise ValueError(f"no Gram tile implementation for device {ref.device}")
        return out

    def window_rows(self, device=None) -> torch.Tensor:
        """The window row of each output row: the output's rows unless the
        plan is rank-mapped."""
        v = torch.arange(self.shape[0], device=device)
        if self.row_map is None:
            return v
        P, B, L0, shift = self.row_map
        return ((L0 + v) // B) * P * B + (L0 + v) % B + shift

    def k2_tiles(self, out: torch.Tensor):
        """K2's walk into the view ``out``, tile by tile as the kernel makes
        it: ``(rows, cols, diag, by_tma)``, the tile's row and column slices,
        whether it holds a unit-diagonal entry (the kernel compares window
        rows with columns on those tiles only), and whether a TMA box stores
        it. A box needs a view whose base and row stride are 16-byte
        multiples; it starts on a 16-byte boundary and clips at the view's
        edge only, so it takes a tile whose first column lies on one and
        that reaches the box's edge or the view's. The threads store the
        others."""
        if not self.equilibrated:
            raise ValueError("k2_tiles walks an equilibrated (K2) plan")
        vec = 16 // out.element_size()  # entries in 16 bytes
        ldo = max(out.stride(0), self.shape[1])
        tma = out.data_ptr() % 16 == 0 and ldo % vec == 0
        h = max(b.row_off + b.n for b in self.blocks)
        s = max(b.col_off + b.m for b in self.blocks)
        w = self.window_rows()
        tiles = []
        for index in range(self.n_tiles):
            b, tr, tc = self.tile_coords(index)
            blk = self.blocks[b]
            r0, c0 = blk.row_off + tr * TILE, blk.col_off + tc * TILE
            nr, nc = min(TILE, blk.n - tr * TILE), min(TILE, blk.m - tc * TILE)
            wt = w[r0 : r0 + nr]
            tiles.append((slice(r0, r0 + nr), slice(c0, c0 + nc),
                          bool(((wt >= c0) & (wt < c0 + nc)).any()),
                          tma and c0 % vec == 0 and (nr == TILE or r0 + nr == h)
                          and (nc == TILE or c0 + nc == s)))
        return tiles

    def _plain_equilibrated(self, sets, d_r, d_c, out):
        """K2's plain version: the blocks one by one (each row's point picked
        by its window row), the scaling, the unit diagonal."""
        w = self.window_rows(out.device)
        for b in self.blocks:
            rows, cols = slice(b.row_off, b.row_off + b.n), slice(b.col_off, b.col_off + b.m)
            if b.fill:
                out[rows, cols] = 0.0
                continue
            op_x, op_y = self.pairs[b.table]
            out[rows, cols] = self.kernel.pair_fn(op_x, op_y)(sets[b.x_set][w[rows] - b.x_row0],
                                                              sets[b.y_set])
        out.mul_(d_r[w][:, None] * d_c[None, :])
        on = w < self.shape[1]
        out[torch.nonzero(on)[:, 0], w[on]] = 1.0

    def _plain(self, sets, out):
        """The kernel's plain version: the blocks one by one."""
        for b in self.blocks:
            if b.fill:
                out[b.row_off : b.row_off + b.n, b.col_off : b.col_off + b.m] = 0.0
                continue
            op_x, op_y = self.pairs[b.table]
            val = self.kernel.pair_fn(op_x, op_y)(sets[b.x_set], sets[b.y_set])
            if b.symmetric:  # the upper triangle and its mirror, as the kernel writes it
                val = torch.triu(val) + torch.triu(val, 1).T
            out[b.row_off : b.row_off + b.n, b.col_off : b.col_off + b.m] = val
            if b.mirror:
                out[b.col_off : b.col_off + b.m, b.row_off : b.row_off + b.n] = val.T

    def _launch(self, sets, out, dev: int, d_r=None, d_c=None):
        """K1, or K2 when the scales ``d_r``, ``d_c`` are given."""
        global LAUNCHES, K2_LAUNCHES
        dtype = out.dtype
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"the Gram tile kernel takes float32 or float64, got {dtype}")
        if not all(s.is_contiguous() for s in sets):
            raise ValueError("point sets must be contiguous")
        if not self.blocks:
            return
        lib = _kernel_lib()
        is_double = int(dtype == torch.float64)
        pts = (ctypes.c_void_p * len(sets))(*[s.data_ptr() for s in sets])
        err = lib.gram_plan_launch(
            is_double, self._packed(lib, is_double), out.data_ptr(),
            max(out.stride(0), self.shape[1]),
            None if d_r is None else d_r.data_ptr(), None if d_c is None else d_c.data_ptr(),
            ctypes.addressof(pts), len(sets),
            torch._C._cuda_getCurrentRawStream(dev),  # current_stream(dev).cuda_stream
        )
        if err != 0:
            raise RuntimeError(f"gram_tile kernel launch failed: CUDA error {err}")
        if d_r is None:
            LAUNCHES += 1
        else:
            K2_LAUNCHES += 1


def _set_keys(observables) -> Tuple[str, ...]:
    """The distinct point-set keys of ``observables``, in order."""
    return tuple(dict.fromkeys(o.points for o in observables))


@lru_cache(maxsize=256)
def gram_plan(kernel: SquaredExponential, observables, sizes) -> GramPlan:
    """Plan of the symmetric Gram matrix of ``observables`` (a tuple of
    ``Observable``; ``sizes`` their point counts): the upper blocks with
    their mirrors, the diagonal blocks as symmetric. Its point sets are the
    distinct ``Observable.points`` keys in order (``plan.set_keys``)."""
    keys = _set_keys(observables)
    set_of = {k: i for i, k in enumerate(keys)}
    set_sizes = [0] * len(keys)
    for o, s in zip(observables, sizes):
        set_sizes[set_of[o.points]] = s
    offs = list(itertools.accumulate(sizes, initial=0))
    entries = [
        (oi.op, oj.op, set_of[oi.points], set_of[oj.points], offs[i], offs[j], j != i)
        for i, oi in enumerate(observables)
        for j, oj in enumerate(observables) if j >= i
    ]
    return GramPlan(kernel, entries, set_sizes, (offs[-1], offs[-1]), keys)


@lru_cache(maxsize=256)
def cross_plan(kernel: SquaredExponential, row_op: LinearOp, n_rows: int, observables,
               sizes) -> GramPlan:
    """Plan of the cross-Gram of ``row_op`` at ``n_rows`` points (set 0)
    against the training functionals (sets 1.., ``plan.set_keys``)."""
    keys = _set_keys(observables)
    set_of = {k: i + 1 for i, k in enumerate(keys)}
    set_sizes = [n_rows] + [0] * len(keys)
    for o, s in zip(observables, sizes):
        set_sizes[set_of[o.points]] = s
    offs = list(itertools.accumulate(sizes, initial=0))
    entries = [
        (row_op, o.op, 0, set_of[o.points], 0, off, False)
        for o, off in zip(observables, offs)
    ]
    return GramPlan(kernel, entries, set_sizes, (n_rows, offs[-1]), keys)


@lru_cache(maxsize=256)
def pair_plan(kernel: SquaredExponential, op_x: LinearOp, op_y: LinearOp, n: int,
              m: int) -> GramPlan:
    """Plan of one ``(n, m)`` block on two point sets (never symmetric)."""
    return GramPlan(kernel, [(op_x, op_y, 0, 1, 0, 0, False)], (n, m), (n, m))


@lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("gram_tile")
    lib.gram_plan_params_size.argtypes = [ctypes.c_int]
    lib.gram_plan_params_size.restype = ctypes.c_int
    lib.gram_plan_pack.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.gram_plan_pack.restype = ctypes.c_int
    lib.gram_plan_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.gram_plan_launch.restype = ctypes.c_int
    lib.gram_plan_limits.argtypes = [ctypes.c_void_p]
    lib.gram_plan_limits.restype = None
    got = (ctypes.c_int * len(_LIMITS))()
    lib.gram_plan_limits(ctypes.addressof(got))
    if list(got) != list(_LIMITS.values()):
        raise RuntimeError(
            f"csrc/gram_tile.cu limits {list(got)} differ from ops/gram_tile.py "
            f"{list(_LIMITS.values())}"
        )
    return lib


def gram_tile_pair_fn(kernel: SquaredExponential, op_x: LinearOp, op_y: LinearOp):
    """Block evaluator ``block(X, Y, out=None) -> (N, M)`` for ``(op_x (x) op_y) kappa``.

    ``X: (N, dim)`` holds the row points and ``Y: (M, dim)`` the column
    points. ``out``, if given, is an ``(N, M)`` view with unit column stride,
    such as a slot of a larger matrix; the block is written into it.
    CUDA tensors go to the kernel (a one-block plan); CPU tensors to the
    plain version.
    """

    def block(X: torch.Tensor, Y: torch.Tensor, out: torch.Tensor | None = None):
        if X.dim() != 2 or Y.dim() != 2:
            raise ValueError(f"X and Y must be 2-D; got {tuple(X.shape)} and {tuple(Y.shape)}")
        plan = pair_plan(kernel, op_x, op_y, int(X.shape[0]), int(Y.shape[0]))
        return plan.run((X, Y), out)

    return block
