"""The block-cyclic factor layout and its triangular algebra, at P = 1.

Counterpart of ``nonlinpdes_gpsolver_tpu/parallel/cholesky.py``. The JAX
package splits an ``n_pad x n_pad`` matrix into ``nb`` row blocks of ``B``
rows and deals block ``g`` to device ``g % P``; its factor lives as a
``(nb, B, n_pad)`` array in that block-cyclic order, with the refined
inverses of the ``B x B`` diagonal blocks beside it (``diag_inv``). At
P = 1 the block permutation is the identity (:func:`_block_perm`), so the
``(nb, B, n_pad)`` array *is* the dense row-major lower factor and
``local.view(n_pad, n_pad)`` is that factor. This module keeps the JAX
package's layout and names, so that the several-device form (slice 4) has
a place for its sharding, and computes on the dense view:

* the triangular solves (forward, transposed; the JAX package's
  column-sharded variants are the same solves at P = 1) are
  ``torch.linalg.solve_triangular`` on the whole padded factor, whose
  padding rows are the identity;
* the two-pass factorization is the dense path's f64 Cholesky
  (``ops/linalg.py::cholesky_f64``) of the arranged matrix, written back
  in place;
* ``diag_inv`` is still produced (the Newton-refined inverses of the
  diagonal blocks), for slice 4 and for the interop with the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.linalg import cholesky_f64, newton_refine_tri_inverse, tri_inverse
from .mesh import Mesh, check_one_device


def pad_to_blocks(n: int, block: int, n_dev: int) -> int:
    """Smallest padded size that is a multiple of ``block * n_dev`` (``:47``)."""
    q = block * n_dev
    return ((n + q - 1) // q) * q


def _block_perm(nb: int, P_: int) -> np.ndarray:
    """Permutation placing global block-row ``g = j*P + p`` at sharded
    position ``p*nbl + j`` (device p, slot j); the identity at P = 1 (``:53``)."""
    nbl = nb // P_
    perm = np.empty(nb, dtype=np.int64)
    for p in range(P_):
        for j in range(nbl):
            perm[p * nbl + j] = j * P_ + p
    return perm


@dataclasses.dataclass
class BlockCyclicFactor:
    """Lower Cholesky factor in the block-cyclic row layout (``:64``).

    ``local`` is ``(nb, B, n_pad)``; at P = 1 its rows are in natural order
    and :attr:`matrix` is the ``(n_pad, n_pad)`` factor, whose padding rows
    and columns are the identity. ``diag_inv`` holds the Newton-refined
    inverses of the ``B x B`` diagonal blocks, ``(nb, B, B)``.
    """

    local: torch.Tensor
    mesh: Mesh
    axis: str
    block: int
    n: int  # original (unpadded) size
    n_pad: int
    diag_inv: Optional[torch.Tensor] = None

    @property
    def matrix(self) -> torch.Tensor:
        """The ``(n_pad, n_pad)`` lower factor (a view of ``local``)."""
        check_one_device(self.mesh)
        return self.local.view(self.n_pad, self.n_pad)

    def dense(self) -> torch.Tensor:
        """The ``(n, n)`` lower factor (a view)."""
        return self.matrix[: self.n, : self.n]


def shard_rows_blockcyclic(A: torch.Tensor, mesh: Mesh, axis: str, block: int) -> torch.Tensor:
    """Pad a dense ``(n, n)`` matrix with an identity tail and arrange it
    into the ``(nb, B, n_pad)`` layout on the mesh's device (``:97``)."""
    n = A.shape[0]
    n_pad = pad_to_blocks(n, block, mesh.size)
    Ap = torch.zeros((n_pad, n_pad), dtype=A.dtype, device=mesh.device)
    Ap[:n, :n] = A
    Ap.diagonal()[n:] = 1.0
    return Ap.view(n_pad // block, block, n_pad)


def unshard_rows_blockcyclic(local: torch.Tensor, mesh: Mesh, axis: str, block: int,
                             n: int) -> torch.Tensor:
    """The ``(n, n)`` leading block of an arranged matrix (``:119``)."""
    check_one_device(mesh)
    return local.reshape(local.shape[0] * block, -1)[:n, :n]


def diag_inverses(local: torch.Tensor, mesh: Mesh, axis: str, block: int) -> torch.Tensor:
    """The ``(nb, B, B)`` Newton-refined inverses of the factor's diagonal
    blocks (``:249``), for a factor that arrived without them."""
    check_one_device(mesh)
    nb = local.shape[0]
    blocks = local.view(nb, block, nb, block).diagonal(dim1=0, dim2=2).permute(2, 0, 1)
    return newton_refine_tri_inverse(blocks, tri_inverse(blocks))


def _chol_sharded(arranged: torch.Tensor, mesh: Mesh, axis: str, block: int):
    """Factor the arranged SPD matrix in place (``:224``, the two-pass
    path): the f64 Cholesky of its dense view, cast back into
    ``arranged``. Returns ``(factor, diag_inv)``; a failed factorization
    leaves NaN in ``arranged``, as the JAX package's does, for the caller's
    quality probe to reject."""
    A = arranged.view(arranged.shape[0] * block, -1)
    L, ok = cholesky_f64(A)
    A.copy_(L if ok else torch.full_like(L, float("nan")))
    del L
    return arranged, diag_inverses(arranged, mesh, axis, block)


def cholesky_blockcyclic(A: torch.Tensor, mesh: Mesh, axis: str = "p",
                         block: int = 256) -> BlockCyclicFactor:
    """Factor a dense SPD matrix into the block-cyclic layout (``:282``)."""
    n = A.shape[0]
    arranged = shard_rows_blockcyclic(A, mesh, axis, block)
    local, winvs = _chol_sharded(arranged, mesh, axis, block)
    return BlockCyclicFactor(local, mesh, axis, block, n, arranged.shape[0] * block, winvs)


def _padded(V: torch.Tensor, n_pad: int) -> torch.Tensor:
    """``V`` (a vector or columns) with zero rows appended up to ``n_pad``."""
    if V.shape[0] == n_pad:
        return V
    return torch.cat([V, V.new_zeros((n_pad - V.shape[0], *V.shape[1:]))])


def matvec_blockcyclic(local: torch.Tensor, mesh: Mesh, axis: str, block: int,
                       v: torch.Tensor, trans: bool = False, n: Optional[int] = None):
    """``A v`` (or ``A^T v``) for a matrix in the arranged layout (``:351``),
    ``v`` zero-padded to ``n_pad``; the first ``n`` entries (default
    ``len(v)``)."""
    check_one_device(mesh)
    A = local.view(local.shape[0] * block, -1)
    n = v.shape[0] if n is None else n
    vp = _padded(v, A.shape[0])
    return ((A.T if trans else A) @ vp)[:n]


def trsm_blockcyclic(factor: BlockCyclicFactor, V: torch.Tensor,
                     trans: bool = False) -> torch.Tensor:
    """``L^{-1} V`` (or ``L^{-T} V`` with ``trans``) for ``V`` of ``n`` rows,
    a vector or columns (``:492``). The padding rows of the factor are the
    identity, so the solve on the zero-padded ``V`` is exact."""
    if V.shape[0] != factor.n:
        raise ValueError(f"V has {V.shape[0]} rows, factor expects {factor.n}")
    L = factor.matrix
    col = _padded(V[:, None] if V.dim() == 1 else V, factor.n_pad)
    if trans:
        Y = torch.linalg.solve_triangular(L.mT, col, upper=True)
    else:
        Y = torch.linalg.solve_triangular(L, col, upper=False)
    Y = Y[: factor.n]
    return Y[:, 0] if V.dim() == 1 else Y


def kernel_solve_blockcyclic(factor: BlockCyclicFactor, V: torch.Tensor) -> torch.Tensor:
    """``L^{-T} L^{-1} V`` (``:540``)."""
    return trsm_blockcyclic(factor, trsm_blockcyclic(factor, V), trans=True)
