"""The equilibrated normal matrix of the mesh path's ``'normal'`` step.

For pointwise-per-slice residuals the Gauss-Newton matrix of the GP blocks
is ``H = sum_b J_b^T Theta_b^{-1} J_b``, and with ``J_b`` a stack of
per-slice diagonals each entry is a small contraction of the block's
interior inverse ``A`` (``(S, N, S, N)``: ``S`` live segments of ``N``
interior points) with the diagonals ``Dl`` (``(s, S, N)``, ``s`` latent
slices)::

    H[jN+q, kN+p] = sum_b sum_r Dl[j,r,q] sum_s A[r,q,s,p] Dl[k,s,p]

:func:`normal_matrix` writes ``sc sc^T * H`` for the equilibration scales
``sc``, exactly symmetric, with ``1 + 32 eps`` on the diagonal (the matrix
:func:`..linalg.spd_solve_controlled` factors), in one pass a block over
``A``, optionally added to a matrix given (the misfits' scaled product).
:func:`normal_diagonal` gives ``diag(H)`` from the ``S x S`` diagonal
entries of each ``A`` at ``q = p``, for the scales, without forming ``H``.

It replaces no TPU kernel: the JAX package forms ``H`` with XLA einsums.
On the card one launch of ``csrc/normal_matrix.cu`` a block does it,
bound by bytes: it reads the half of ``A`` that its symmetry leaves
(``A[r,q,s,p] = A[s,p,r,q]``: the tiles with ``q >= p``) and writes each
value of the result at its place and at its mirror; every sum runs in a
fixed order, so that launches and graph replays give the same bits (the
source's note). Entry ``(jN+q, kN+p)`` is computed where ``q > p``, or
``q = p`` and ``j >= k``, and mirrored elsewhere.

Which version runs depends only on where the tensors lie: for CPU tensors
:func:`normal_matrix` runs the plain version (:func:`normal_matrix_plain`:
the einsum assembly of ``H`` off the kernel's route,
:func:`einsum_normal_matrix`, scaled and mirrored); for CUDA tensors it launches the kernel and
raises for what the kernel does not take (:func:`fits` says what it
takes). ``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import torch

# Limits of csrc/normal_matrix.cu, in the order of normal_matrix_limits();
# checked against the built library when it is loaded.
_LIMITS = dict(tile=32, max_segments=4, max_slices=6)
MAX_SEGMENTS = _LIMITS["max_segments"]
MAX_SLICES = _LIMITS["max_slices"]

LAUNCHES = 0
"""Number of kernel launches in this process (the wrapper adds one per launch)."""

Pairs = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def floor_value(dtype: torch.dtype) -> float:
    """The equilibrated diagonal, ``1 + 32 eps`` of ``dtype``."""
    return 1.0 + 32.0 * torch.finfo(dtype).eps


def fits(blocks: Sequence[torch.Tensor], s: int) -> bool:
    """Whether the kernel takes the inverse blocks ``A`` (``(S, N, S, N)``)
    at ``s`` latent slices: float32 on a card, ``S <= MAX_SEGMENTS`` and
    ``s <= MAX_SLICES`` (any ``N``)."""
    return 1 <= s <= MAX_SLICES and all(
        A.device.type == "cuda" and A.dtype == torch.float32 and 1 <= A.shape[0] <= MAX_SEGMENTS
        for A in blocks)


def normal_diagonal(pairs: Pairs) -> torch.Tensor:
    """``diag(H)`` (``s N``) of the unscaled normal matrix of the blocks,
    from each ``A``'s ``S x S`` entries at ``q = p``."""
    d = None
    for A, Dl in pairs:
        Ad = A.diagonal(dim1=1, dim2=3)  # (S, S, N): A[r, q, s, q]
        db = torch.einsum("jrq,rsq,jsq->jq", Dl, Ad, Dl).reshape(-1)
        d = db if d is None else d + db
    return d


def _shapes(pairs: Pairs, sc: torch.Tensor) -> Tuple[int, int]:
    if not pairs:
        raise ValueError("normal_matrix needs at least one (A, Dl) block")
    s, _, N = pairs[0][1].shape
    for A, Dl in pairs:
        S = Dl.shape[1]
        if Dl.dim() != 3 or Dl.shape[0] != s or Dl.shape[2] != N or A.shape != (S, N, S, N):
            raise ValueError(f"blocks must be A (S, N, S, N) and Dl (s, S, N) of one s and N, got "
                             f"A {tuple(A.shape)}, Dl {tuple(Dl.shape)}")
    if sc.shape != (s * N,):
        raise ValueError(f"sc must be ({s * N},), got {tuple(sc.shape)}")
    return s, N


def _mirrored(X: torch.Tensor) -> torch.Tensor:
    """``X`` (``(s, N, s, N)``) with every entry taken from its direct place,
    ``(j, q, k, p)`` with ``q > p`` or ``q = p`` and ``j >= k``: exactly
    symmetric."""
    s, N = X.shape[0], X.shape[1]
    i, jj = torch.arange(N, device=X.device), torch.arange(s, device=X.device)
    q, p = i.view(1, N, 1, 1), i.view(1, 1, 1, N)
    j, k = jj.view(s, 1, 1, 1), jj.view(1, 1, s, 1)
    return torch.where((q > p) | ((q == p) & (j >= k)), X, X.permute(2, 3, 0, 1))


def einsum_normal_matrix(pairs: Pairs, Jms: Sequence[torch.Tensor],
                         like: torch.Tensor) -> torch.Tensor:
    """``H`` itself (unscaled, in ``like``'s dtype and device) by slice
    contractions of each block's ``(A, Dl)``, one latent slice at a time
    (which bounds the temporaries), plus the misfits' ``J_m^T J_m``: the
    assembly of the ``'normal'`` step off the kernel's route."""
    s, _, N = pairs[0][1].shape
    m = s * N
    H = torch.zeros((m, m), dtype=like.dtype, device=like.device)
    for A4, Dl in pairs:
        rows = []
        for j in range(s):
            Bj = torch.einsum("rq,rqsp->qsp", Dl[j], A4)
            rows.append(torch.einsum("qsp,ksp->qkp", Bj, Dl).reshape(N, m))
        H = H + torch.cat(rows)
    for Jm in Jms:
        H = H + Jm.T @ Jm
    return H


def normal_matrix_plain(pairs: Pairs, sc: torch.Tensor,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's plain version: ``sc sc^T * H`` of
    :func:`einsum_normal_matrix`, added to ``out`` where given (which
    receives the result), taken from its direct places, then the floored
    diagonal."""
    s, N = _shapes(pairs, sc)
    m = s * N
    H = (sc[:, None] * sc[None, :]) * einsum_normal_matrix(pairs, (), sc)
    if out is not None:
        H = out + H
    H = _mirrored(H.view(s, N, s, N)).reshape(m, m)
    H.diagonal().fill_(floor_value(sc.dtype))
    if out is None:
        return H
    return out.copy_(H)


def normal_matrix(pairs: Pairs, sc: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sc sc^T * sum_b H_b``, exactly symmetric, its diagonal ``1 + 32
    eps``, added to ``out`` (``(s N, s N)``) where given and written into
    it; else into a new matrix. CPU tensors: the plain version. CUDA
    tensors: one launch a block, float32, within :func:`fits`."""
    global LAUNCHES
    if sc.device.type == "cpu":
        return normal_matrix_plain(pairs, sc, out)
    s, N = _shapes(pairs, sc)
    m = s * N
    tensors: List[torch.Tensor] = [sc] + [t for pair in pairs for t in pair]
    if out is not None:
        tensors.append(out)
        if out.shape != (m, m):
            raise ValueError(f"out must be ({m}, {m}), got {tuple(out.shape)}")
    if (not fits([A for A, _ in pairs], s) or any(Dl.dtype != sc.dtype for _, Dl in pairs)
            or sc.dtype != torch.float32 or (out is not None and out.dtype != sc.dtype)):
        raise TypeError(f"the normal-matrix kernel takes float32 blocks of at most {MAX_SEGMENTS} "
                        f"segments and {MAX_SLICES} slices, got {[tuple(A.shape) for A, _ in pairs]} "
                        f"in {sc.dtype}")
    if any(t.device != sc.device for t in tensors):
        raise ValueError("every tensor of the normal matrix must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the normal-matrix kernel takes contiguous tensors")
    H = torch.empty((m, m), dtype=sc.dtype, device=sc.device) if out is None else out
    lib = _kernel_lib()
    stream = torch._C._cuda_getCurrentRawStream(sc.device.index)  # current_stream().cuda_stream
    for i, (A, Dl) in enumerate(pairs):
        err = lib.normal_matrix_launch(
            A.data_ptr(), Dl.data_ptr(), sc.data_ptr(), H.data_ptr(), Dl.shape[1], s, N,
            int(out is not None or i > 0), int(i == len(pairs) - 1), floor_value(sc.dtype), stream)
        if err != 0:
            raise RuntimeError(f"normal_matrix kernel launch failed: CUDA error {err}")
        LAUNCHES += 1
    return H


@lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("normal_matrix")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.normal_matrix_launch.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
    lib.normal_matrix_launch.restype = i
    lib.normal_matrix_limits.argtypes = [p]
    lib.normal_matrix_limits.restype = None
    got = (ctypes.c_int * len(_LIMITS))()
    lib.normal_matrix_limits(ctypes.addressof(got))
    if list(got) != list(_LIMITS.values()):
        raise RuntimeError(f"csrc/normal_matrix.cu limits {list(got)} differ from "
                           f"ops/normal_matrix.py {list(_LIMITS.values())}")
    return lib
