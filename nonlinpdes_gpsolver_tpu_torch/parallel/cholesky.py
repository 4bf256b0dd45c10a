"""The block-cyclic factor layout and its triangular algebra over P ranks.

Counterpart of ``nonlinpdes_gpsolver_tpu/parallel/cholesky.py``. An
``n_pad x n_pad`` matrix is split into ``nb`` row blocks of ``B`` rows, and
global block ``g = j P + p`` lives on rank ``p`` as its slot ``j``: each
rank holds its ``(nbl, B, n_pad)`` shard (``nbl = nb / P``), the JAX
package's ``shard_map`` view of the sharded ``(nb, B, n_pad)`` array. The
refined inverses of the ``B x B`` diagonal blocks (``diag_inv``,
``(nb, B, B)``) are replicated on every rank.

At P = 1 the shard is the dense row-major lower factor (its padding rows
the identity), and a triangular solve takes the route :func:`trsm_route`
picks: a narrow float32 panel on the card goes to the row-block kernel
(``ops/trsm_rowblock.py``, the JAX package's panel loop over ``diag_inv``
in one launch), every other solve to ``torch.linalg.solve_triangular``
(cuBLAS runs wide panels as GEMM updates near the FFMA rate; the CPU and
f64 keep their numbers). Across ranks they are the JAX package's panel
loops over the ``diag_inv`` blocks:

* forward (``:368``): the owner of block ``k`` computes
  ``y_k = W_kk (v_k - L_{k,<k} y_{<k})`` and broadcasts it, ``B x m``
  values a step; the JAX package all-gathers the whole ``B x n_pad`` row
  block instead, ``P n_pad^2`` values a solve, for the same arithmetic;
* transposed (``:397``): each rank's part of ``L_{>k,k}^T y_{>k}`` from its
  own rows, summed over the ranks (``psum``) a step;
* column-sharded (``:435``; each rank solves its own columns): the forward
  solve broadcasts the owner's row prefix, the transposed one gathers block
  column ``k``.

The panel loops are what a recorded Gauss-Newton step replays across NCCL
ranks (a kernel solve of a CG iteration makes ``2 nb`` collectives): they
read nothing on the host and allocate only what each replay allocates
again, and while the owner of a block computes and the others receive,
every rank makes the same collectives in the same order.

The two-pass factorization is the JAX package's right-looking panel
algorithm across ranks (``:128-247``), each diagonal block factored in f64
from the owner's broadcast; at P = 1 it is the dense path's f64 Cholesky.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops import graphs
from ..ops.linalg import cholesky_f64, newton_refine_tri_inverse, tri_inverse
from ..ops.trsm_rowblock import MAX_COLS, STEP, trsm_rowblock
from ..utils import tracing
from . import comm
from .mesh import Mesh


def pad_to_blocks(n: int, block: int, n_dev: int) -> int:
    """Smallest padded size that is a multiple of ``block * n_dev`` (``:47``)."""
    q = block * n_dev
    return ((n + q - 1) // q) * q


def _block_perm(nb: int, P_: int) -> np.ndarray:
    """Permutation placing global block-row ``g = j*P + p`` at sharded
    position ``p*nbl + j`` (device p, slot j) (``:53``)."""
    nbl = nb // P_
    perm = np.empty(nb, dtype=np.int64)
    for p in range(P_):
        for j in range(nbl):
            perm[p * nbl + j] = j * P_ + p
    return perm


def deal_saved_blocks(saved: np.ndarray, saved_size: int, mesh: Mesh) -> np.ndarray:
    """This rank's ``(nb / P, B, n_pad)`` shard of a factor kept as its global
    ``(nb, B, n_pad)`` array in the slot order of a ``saved_size``-rank mesh
    (rank q's slots at ``q nbl .. (q + 1) nbl``, the JAX package's sharded
    layout and its checkpoint's): the blocks go back to natural row order and
    rank p of ``mesh`` takes global blocks ``p, p + P, ...`` (the same slots
    when the two meshes have the same size). Only this rank's blocks are
    copied. ``nb`` must divide by ``mesh.size``."""
    nb = saved.shape[0]
    if nb % mesh.size:
        raise ValueError(f"{nb} block rows do not deal to {mesh.size} ranks (nb % P != 0)")
    natural = np.argsort(_block_perm(nb, saved_size))  # global block g sits at slot natural[g]
    return np.asarray(saved)[natural[mesh.rank :: mesh.size]]


def first_slot(g: int, P_: int, p: int) -> int:
    """The first slot of rank ``p`` whose global block is at least ``g``."""
    return max(0, -(-(g - p) // P_))


def local_row(R: int, B: int, P_: int, p: int) -> int:
    """The local row of rank ``p`` of the first global row it owns at or
    after ``R``: the owned rows of any global interval are one contiguous
    run of local rows."""
    g = R // B
    if g % P_ == p:
        return (g // P_) * B + R % B
    return first_slot(g, P_, p) * B


def _interleave(parts: torch.Tensor) -> torch.Tensor:
    """``(P, nbl, ...)`` gathered slots to the ``(nb, ...)`` global block order."""
    return parts.transpose(0, 1).reshape(-1, *parts.shape[2:])


def _global_blocks(mesh: Mesh, nbl: int, device) -> torch.Tensor:
    """The global block index of each of this rank's slots."""
    return torch.arange(nbl, device=device) * mesh.size + mesh.rank


@dataclasses.dataclass
class BlockCyclicFactor:
    """Lower Cholesky factor in the block-cyclic row layout (``:64``).

    ``local`` is this rank's ``(nbl, B, n_pad)`` shard; at P = 1 its rows are
    in natural order and :attr:`matrix` is the ``(n_pad, n_pad)`` factor,
    whose padding rows and columns are the identity. ``diag_inv`` holds the
    Newton-refined inverses of the ``B x B`` diagonal blocks, ``(nb, B, B)``,
    on every rank.
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
        """The ``(n_pad, n_pad)`` lower factor (a view of ``local``), at P = 1."""
        if self.mesh.size != 1:
            raise ValueError("a factor across ranks has no local matrix; use dense()")
        return self.local.view(self.n_pad, self.n_pad)

    def inverses(self) -> torch.Tensor:
        """``diag_inv``, computed once (:func:`diag_inverses`, a collective
        across ranks) for a factor that arrived without it."""
        if self.diag_inv is None:
            self.diag_inv = diag_inverses(self.local, self.mesh, self.axis, self.block)
        return self.diag_inv

    def dense(self) -> torch.Tensor:
        """The ``(n, n)`` lower factor: a view at P = 1, else gathered to every
        rank (a collective; tests and interop)."""
        if self.mesh.size == 1:
            return self.matrix[: self.n, : self.n]
        return unshard_rows_blockcyclic(self.local, self.mesh, self.axis, self.block, self.n)


def shard_rows_blockcyclic(A: torch.Tensor, mesh: Mesh, axis: str, block: int) -> torch.Tensor:
    """This rank's ``(nbl, B, n_pad)`` shard of a dense ``(n, n)`` matrix
    padded with an identity tail (``:97``)."""
    n = A.shape[0]
    n_pad = pad_to_blocks(n, block, mesh.size)
    Ap = torch.zeros((n_pad, n_pad), dtype=A.dtype, device=mesh.device)
    Ap[:n, :n] = A
    Ap.diagonal()[n:] = 1.0
    arranged = Ap.view(n_pad // block, block, n_pad)
    return arranged if mesh.size == 1 else arranged[mesh.rank :: mesh.size].contiguous()


def unshard_rows_blockcyclic(local: torch.Tensor, mesh: Mesh, axis: str, block: int,
                             n: int) -> torch.Tensor:
    """The ``(n, n)`` leading block of a sharded matrix, on every rank (``:119``)."""
    if mesh.size == 1:
        return local.reshape(local.shape[0] * block, -1)[:n, :n]
    return _interleave(comm.all_gather(mesh, local)).reshape(-1, local.shape[2])[:n, :n]


def diag_inverses(local: torch.Tensor, mesh: Mesh, axis: str, block: int,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``(nb, B, B)`` Newton-refined inverses of the factor's diagonal
    blocks (``:249``), for a factor that arrived without them: each rank
    inverts its own blocks, then one ``all_gather`` (written into ``out``
    where given). Row-major, as the fused factorization writes them and the
    row-block kernel reads them."""
    nbl = local.shape[0]
    nb = nbl * mesh.size
    g = _global_blocks(mesh, nbl, local.device)
    blocks = local.view(nbl, block, nb, block)[torch.arange(nbl, device=local.device), :, g]
    mine = newton_refine_tri_inverse(blocks, tri_inverse(blocks)).contiguous()
    winvs = _interleave(comm.all_gather(mesh, mine))
    return winvs if out is None else out.copy_(winvs)


def _chol_sharded(arranged: torch.Tensor, mesh: Mesh, axis: str, block: int,
                  chunk_cols: int = 4096, diag_inv: Optional[torch.Tensor] = None):
    """Factor the sharded SPD matrix in place (``:224``, the two-pass
    path). Returns ``(factor, diag_inv)``, the latter written into
    ``diag_inv`` where given; a failed factorization leaves NaN in
    ``arranged``, as the JAX package's does, for the caller's quality
    probe to reject.

    At P = 1: the f64 Cholesky of the dense view, cast back (no host read:
    a failure writes NaN on the device). Across ranks:
    the right-looking panel algorithm (``:128``): step ``k`` broadcasts the
    owner's diagonal block, every rank factors it in f64 and refines its
    inverse (the same bits on every rank, so the failure flag agrees), solves
    its own panel rows below it, and one ``all_gather`` shares the finished
    panel column for every rank's trailing update of its own rows, in
    ``chunk_cols``-wide column chunks."""
    B = block
    if mesh.size == 1:
        A = arranged.view(arranged.shape[0] * B, -1)
        L, ok = cholesky_f64(A)
        A.copy_(torch.where(ok, L, torch.full_like(L, float("nan"))))
        del L
        return arranged, diag_inverses(arranged, mesh, axis, block, out=diag_inv)
    P_, p = mesh.size, mesh.rank
    nbl, _, n_pad = arranged.shape
    nb = nbl * P_
    dtype, dev = arranged.dtype, arranged.device
    f64 = torch.float64
    winvs = (torch.zeros((nb, B, B), dtype=dtype, device=dev) if diag_inv is None
             else diag_inv.zero_())
    L2 = arranged.view(nbl * B, n_pad)
    Wc = max(1, chunk_cols // B) * B
    for k in range(nb):
        kB, owner, slot = k * B, k % P_, k // P_
        cand = arranged[slot, :, kB : kB + B] if p == owner else arranged.new_empty((B, B))
        A_kk = comm.broadcast(mesh, cand, owner)
        L_kk, ok = cholesky_f64(A_kk)
        if not comm.agree(mesh, tracing.read(bool, ok), "all"):
            arranged.fill_(float("nan"))
            return arranged, winvs
        W_kk = newton_refine_tri_inverse(L_kk, tri_inverse(L_kk))
        winvs[k] = W_kk.to(dtype)
        if p == owner:
            arranged[slot, :, kB : kB + B] = L_kk.to(dtype)
        jb = first_slot(k + 1, P_, p)  # my slots below block k
        colk = arranged[jb:, :, kB : kB + B]
        Lcol = (colk.to(f64) @ W_kk.T).to(dtype)
        colk.copy_(Lcol)
        contrib = arranged.new_zeros((nbl, B, B))
        contrib[jb:] = Lcol
        C = _interleave(comm.all_gather(mesh, contrib)).reshape(n_pad, B)
        rows = Lcol.reshape(-1, B)
        for c0 in range(kB + B, n_pad, Wc):
            c1 = min(c0 + Wc, n_pad)
            L2[jb * B :, c0:c1] -= rows @ C[c0:c1].T
    # zero the strictly upper remnants of the trailing updates
    rg = (_global_blocks(mesh, nbl, dev)[:, None] * B + torch.arange(B, device=dev)).reshape(-1)
    L2.masked_fill_(torch.arange(n_pad, device=dev)[None, :] > rg[:, None], 0.0)
    return arranged, winvs


def cholesky_blockcyclic(A: torch.Tensor, mesh: Mesh, axis: str = "p",
                         block: int = 256, chunk_cols: int = 4096) -> BlockCyclicFactor:
    """Factor a dense SPD matrix (replicated on every rank) into the
    block-cyclic layout (``:282``)."""
    n = A.shape[0]
    arranged = shard_rows_blockcyclic(A, mesh, axis, block)
    local, winvs = _chol_sharded(arranged, mesh, axis, block, chunk_cols)
    n_pad = arranged.shape[2]
    return BlockCyclicFactor(local, mesh, axis, block, n, n_pad, winvs)


def _padded(V: torch.Tensor, n_pad: int) -> torch.Tensor:
    """``V`` (a vector or columns) with zero rows appended up to ``n_pad``."""
    if V.shape[0] == n_pad:
        return V
    return torch.cat([V, V.new_zeros((n_pad - V.shape[0], *V.shape[1:]))])


def matvec_blockcyclic(local: torch.Tensor, mesh: Mesh, axis: str, block: int,
                       v: torch.Tensor, trans: bool = False, n: Optional[int] = None):
    """``A v`` (or ``A^T v``) for a sharded matrix (``:351``), ``v`` a vector
    or columns, zero-padded to ``n_pad``, on every rank; the first ``n`` rows
    (default ``len(v)``). Across ranks: ``A v`` is each rank's rows and one
    ``all_gather``; ``A^T v`` each rank's rows against its entries of ``v``
    and one ``psum``."""
    nbl = local.shape[0]
    A = local.reshape(nbl * block, -1)
    n = v.shape[0] if n is None else n
    vp = _padded(v, A.shape[1])
    if mesh.size == 1:
        return ((A.T if trans else A) @ vp)[:n]
    if not trans:
        rows = (A @ vp).reshape(nbl, block, *vp.shape[1:])
        return _interleave(comm.all_gather(mesh, rows)).reshape(vp.shape)[:n]
    g = _global_blocks(mesh, nbl, vp.device)
    v_my = vp.reshape(-1, block, *vp.shape[1:])[g].reshape(nbl * block, *vp.shape[1:])
    return comm.psum(mesh, A.T @ v_my)[:n]


def _trsm_forward(factor: BlockCyclicFactor, V: torch.Tensor, shard_cols: bool) -> torch.Tensor:
    """``L^{-1} V`` across ranks, ``V`` padded ``(n_pad, m)``: block by block,
    the owner's ``W_kk (v_k - L_{k,<k} y_{<k})``. Replicated ``V``: the owner
    solves and broadcasts ``y_k``. Column-sharded ``V`` (each rank its own
    columns): the owner broadcasts its row prefix ``L_{k,<k}``."""
    mesh, B, W = factor.mesh, factor.block, factor.diag_inv
    P_, p = mesh.size, mesh.rank
    L3 = factor.local
    Y = torch.zeros_like(V)
    for k in range(factor.n_pad // B):
        kB, owner = k * B, k % P_
        mine = p == owner
        if shard_cols:
            if k:
                row = L3[k // P_, :, :kB] if mine else L3.new_empty((B, kB))
                row = comm.broadcast(mesh, row, owner)
                rhs = V[kB : kB + B] - row @ Y[:kB]
            else:
                rhs = V[:B]
            Y[kB : kB + B] = W[k] @ rhs
            continue
        if mine:
            yk = W[k] @ (V[kB : kB + B] - L3[k // P_, :, :kB] @ Y[:kB])
        else:
            yk = V.new_empty((B, V.shape[1]))
        Y[kB : kB + B] = comm.broadcast(mesh, yk, owner)
    return Y


def _trsm_transposed(factor: BlockCyclicFactor, V: torch.Tensor, shard_cols: bool) -> torch.Tensor:
    """``L^{-T} V`` across ranks, ``V`` padded ``(n_pad, m)``, from the last
    block up: ``y_k = W_kk^T (v_k - L_{>k,k}^T y_{>k})``. Replicated ``V``:
    each rank's part of the sum from its own rows, one ``psum`` a step.
    Column-sharded ``V``: block column ``k`` of ``L`` is gathered, and each
    rank contracts it against its own columns."""
    mesh, B, W = factor.mesh, factor.block, factor.diag_inv
    P_, p = mesh.size, mesh.rank
    L3 = factor.local
    nbl, nb = L3.shape[0], factor.n_pad // B
    Y = torch.zeros_like(V)
    Y_my = V.new_zeros((nbl * B, V.shape[1]))  # my rows of Y, slot by slot
    for k in reversed(range(nb)):
        kB = k * B
        if shard_cols:
            C = _interleave(comm.all_gather(mesh, L3[:, :, kB : kB + B])).reshape(-1, B)
            total = C[kB + B :].T @ Y[kB + B :]
        else:  # one batched product over my slots below k, on strided views (no copy)
            jb = first_slot(k + 1, P_, p)
            part = L3[jb:, :, kB : kB + B].transpose(1, 2) @ Y_my[jb * B :].view(-1, B, V.shape[1])
            total = comm.psum(mesh, part.sum(0))
        yk = W[k].T @ (V[kB : kB + B] - total)
        Y[kB : kB + B] = yk
        if k % P_ == p:
            Y_my[(k // P_) * B : (k // P_ + 1) * B] = yk
    return Y


def trsm_route(device: torch.device, dtype: torch.dtype, P: int, k: int, block: int) -> str:
    """Where a triangular solve of ``k`` columns on a factor of ``block``-row
    blocks over ``P`` ranks goes: ``"kernel"`` (the row-block kernel) for a
    float32 panel of at most ``MAX_COLS`` columns on a card at P = 1 with
    blocks of whole 256-row steps, else ``"library"``. The kernel takes even
    one column, where it is bound by reading the factor: on Burgers'
    21,000-row factor in 512-row blocks it took 0.710 ms (forward) and 0.707
    ms (transposed) against cuBLAS's 1.422 and 1.192 (NVIDIA H100 80GB HBM3,
    700 W)."""
    if P == 1 and device.type == "cuda" and dtype == torch.float32 and k <= MAX_COLS \
            and block % STEP == 0:
        return "kernel"
    return "library"


def trsm_blockcyclic(factor: BlockCyclicFactor, V: torch.Tensor, trans: bool = False,
                     shard_cols: bool = False) -> torch.Tensor:
    """``L^{-1} V`` (or ``L^{-T} V`` with ``trans``) for ``V`` of ``n`` rows,
    a vector or columns (``:492``). ``shard_cols``: ``V`` holds this rank's
    own columns, solved against the shared factor (per-rank memory ``n m/P``
    for a panel of ``m`` columns); otherwise ``V`` and the result are the
    same on every rank. The padding rows of the factor are the identity, so
    the solve on the zero-padded ``V`` is exact."""
    if V.shape[0] != factor.n:
        raise ValueError(f"V has {V.shape[0]} rows, factor expects {factor.n}")
    col = V[:, None] if V.dim() == 1 else V
    if factor.mesh.size == 1:
        L = factor.matrix
        route = trsm_route(L.device, L.dtype, 1, col.shape[1], factor.block)
        graphs.trsm_routed(route)
        if route == "kernel":
            Y = trsm_rowblock(L, factor.inverses(), col, trans)
        elif trans:
            Y = torch.linalg.solve_triangular(L.mT, _padded(col, factor.n_pad), upper=True)
        else:
            Y = torch.linalg.solve_triangular(L, _padded(col, factor.n_pad), upper=False)
    else:
        factor.inverses()  # the panel loops read factor.diag_inv
        Y = (_trsm_transposed if trans else _trsm_forward)(factor, _padded(col, factor.n_pad),
                                                           shard_cols)
    Y = Y[: factor.n]
    return Y[:, 0] if V.dim() == 1 else Y


def kernel_solve_blockcyclic(factor: BlockCyclicFactor, V: torch.Tensor,
                             shard_cols: bool = False) -> torch.Tensor:
    """``L^{-T} L^{-1} V`` (``:540``)."""
    return trsm_blockcyclic(factor, trsm_blockcyclic(factor, V, shard_cols=shard_cols),
                            trans=True, shard_cols=shard_cols)
