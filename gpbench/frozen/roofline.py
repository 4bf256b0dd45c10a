"""The work of a Gram matrix, and the least time for it on the card.

The per-entry arithmetic is a frozen copy of ``chip_smoke.py::k1_bound_ms``
at commit 1237319: each distinct entry costs ``dim`` subtractions, ``3 dim``
operations for ``q = sum a_k u_k^2``, 25 for the accurate exponential, one
final product and (K2, the equilibrated kernel) two scaling products; each
merged derivative term of the operator pair costs one sum plus, in every
dimension where it differentiates to order ``d > 0``, a Horner polynomial
and its product, ``2 d + 1`` operations. The merged terms are those of
``op_x (x) op_y`` with the same total derivative order in every dimension
combined (their coefficient summed), as the program's kernels also merge them.

The work is counted from the problem's shapes, never from the program's
plans: bytes are each entry written once and each point coordinate read
once (K2: the row scales too), operations are each distinct entry's
(a symmetric diagonal block counts its upper triangle). Peaks are the
NVIDIA H100 SXM data sheet's: 3.35 TB/s of HBM, 67 TFLOP/s in f32 and
34 TFLOP/s in f64 outside the tensor cores.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
EXP_OPS = 25

# An operator is a tuple of (coefficient, per-dimension derivative orders).
Op = Tuple[Tuple[float, Tuple[int, ...]], ...]
IDENTITY: Op = ((1.0, (0, 0)),)
D0: Op = ((1.0, (1, 0)),)
D1: Op = ((1.0, (0, 1)),)
LAPLACIAN: Op = ((1.0, (2, 0)), (1.0, (0, 2)))


def merged_terms(op_x: Op, op_y: Op) -> list:
    """The derivative orders of ``op_x (x) op_y`` with a non-zero merged coefficient."""
    combined = {}
    for cx, ax in op_x:
        for cy, ay in op_y:
            sign = -1.0 if sum(ay) % 2 else 1.0
            beta = tuple(i + j for i, j in zip(ax, ay))
            combined[beta] = combined.get(beta, 0.0) + cx * cy * sign
    return [beta for beta, c in combined.items() if c != 0.0]


def entry_ops(op_x: Op, op_y: Op, dim: int = 2, equilibrated: bool = False) -> int:
    """Operations of one entry of the block ``op_x (x) op_y``."""
    ops = dim + 3 * dim + EXP_OPS + 1 + 2 * int(equilibrated)
    for beta in merged_terms(op_x, op_y):
        ops += 1 + sum(2 * d + 1 for d in beta if d > 0)
    return ops


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float
    bytes: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def scaled(self, k: float) -> "Work":
        return Work(self.flops * k, self.bytes * k)


def gram_work(segments: Sequence[Tuple[Op, int]], points: int, esize: int, dim: int = 2,
              lower_only: bool = False, equilibrated: bool = False) -> Work:
    """Work of the symmetric Gram matrix of ``segments`` (operator, number
    of points) over ``points`` distinct points: every entry written once,
    or with ``lower_only`` (a factorization's strips) the lower triangle;
    each point coordinate read once, and with ``equilibrated`` one scale
    per row."""
    n = sum(s for _, s in segments)
    flops = 0.0
    for i, (op_i, n_i) in enumerate(segments):
        for j, (op_j, n_j) in enumerate(segments):
            if j > i:
                continue
            entries = n_i * (n_i + 1) // 2 if i == j else n_i * n_j
            flops += entries * entry_ops(op_i, op_j, dim, equilibrated)
    written = n * (n + 1) // 2 if lower_only else n * n
    read = points * dim + (n if equilibrated else 0)
    return Work(flops, float(esize * (written + read)))


def cross_work(rows: int, row_op: Op, segments: Sequence[Tuple[Op, int]], points: int,
               esize: int, dim: int = 2) -> Work:
    """Work of the cross-Gram of ``row_op`` at ``rows`` points against
    ``segments`` over ``points`` distinct points."""
    n = sum(s for _, s in segments)
    flops = sum(rows * n_j * entry_ops(row_op, op_j, dim) for op_j, n_j in segments)
    return Work(float(flops), float(esize * (rows * n + (rows + points) * dim)))


def least_seconds(work: Work, dtype_name: str = "float32") -> Tuple[float, str]:
    """``(seconds, "bytes"|"operations")``: the least time for ``work``
    and which limit binds."""
    t_bytes = work.bytes / HBM_BYTES_PER_S
    t_ops = work.flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
