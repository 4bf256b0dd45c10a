"""Triangular solves of narrow panels on the mesh path's P = 1 factor.

``Y = L^{-1} V`` or ``Y = L^{-T} V`` for the lower factor ``L`` of a
:class:`~..parallel.cholesky.BlockCyclicFactor` at P = 1 (its ``matrix``:
``n_pad x n_pad``, row-major, the padding rows the identity) and its
``diag_inv``, for ``V`` of at most :data:`MAX_COLS` columns.

Counterpart of the JAX package's ``_trsm_kernel`` and ``_trsm_t_kernel``
(``nonlinpdes_gpsolver_tpu/parallel/cholesky.py:368-465``), which are plain
JAX, not Pallas: step by step over row blocks, the right-hand side less the
product of the solved blocks, finished by one product with the refined
inverse of the diagonal block, never by substitution. A step here is
:data:`STEP` (256) rows; a factor block of ``B = 256 r`` rows lends its
``r`` diagonal step-blocks as the steps' inverses.

On the card one launch of ``csrc/trsm_rowblock.cu`` does a whole solve. It
is bound by the f32 FFMA rate at the Woodbury step's 61 columns (TF32 is
below the solver's precision) and by reading the lower triangle at one
column; cuBLAS ``trsm`` ran those panels at a few percent of either. Its
design (the source's note): a persistent launch of one block an SM, 16 or
32 blocks owning the chain of diagonal steps, the others taking the
off-diagonal tiles by an atomic ticket in dependency order and multiplying
them as the chain releases each step, every sum in a fixed order, so that
two launches give the same bits and a recorded CUDA graph replays it. It
stores nothing beyond the call: its scratch (the padded output, two
steps of right-hand sides, the counters) comes from ``torch.empty`` and
``torch.zeros`` in :func:`trsm_rowblock`, a recorded memset zeroing the
counters on every replay.

Which version runs depends only on where the tensors lie: for CPU tensors
:func:`trsm_rowblock` runs the plain version (:func:`trsm_rowblock_plain`,
the same blocked algorithm in torch); for CUDA tensors it launches the
kernel and raises for what the kernel does not take. ``LAUNCHES`` counts
the launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

# Limits of csrc/trsm_rowblock.cu, in the order of trsm_rowblock_limits();
# checked against the built library when it is loaded.
_LIMITS = dict(step=256, max_cols=64, piece=16, quarter=64)
STEP = _LIMITS["step"]
MAX_COLS = _LIMITS["max_cols"]
CHUNK_ROWS = 4096
"""Columns an off-diagonal work item sums before it adds its sum to its
row's. Of 1,024, 2,048, 4,096 and 8,192 at 256-row steps, 4,096 gave the
least time for a Woodbury CG iteration's four solves at Darcy's shapes
(12,750 and 9,000 rows, 61 columns): 1.91 ms against 1.93-1.97 (NVIDIA H100
80GB HBM3, 700 W)."""


LAUNCHES = 0
"""Number of kernel launches in this process (the wrapper adds one per launch)."""


def _step_inverse(diag_inv: torch.Tensor, k: int) -> torch.Tensor:
    """The refined inverse of the factor's ``k``-th diagonal step-block: a
    diagonal block of ``diag_inv[k // r]`` (a lower triangular inverse's
    diagonal blocks are the inverses of the diagonal blocks)."""
    r = diag_inv.shape[-1] // STEP
    o = (k % r) * STEP
    return diag_inv[k // r, o : o + STEP, o : o + STEP]


def _check_shapes(L: torch.Tensor, diag_inv: torch.Tensor, V: torch.Tensor) -> None:
    n_pad = L.shape[0]
    B = diag_inv.shape[-1]
    if L.dim() != 2 or L.shape[1] != n_pad or n_pad % STEP:
        raise ValueError(f"L must be (n_pad, n_pad) with n_pad a multiple of {STEP}, got {tuple(L.shape)}")
    if diag_inv.dim() != 3 or B % STEP or n_pad % B or diag_inv.shape != (n_pad // B, B, B):
        raise ValueError(f"diag_inv {tuple(diag_inv.shape)} is not (n_pad / B, B, B) with B a "
                         f"multiple of {STEP} for n_pad {n_pad}")
    if V.dim() != 2 or V.shape[0] > n_pad or V.shape[1] < 1:
        raise ValueError(f"V must be (n <= {n_pad}, k >= 1), got {tuple(V.shape)}")


def trsm_rowblock_plain(L: torch.Tensor, diag_inv: torch.Tensor, V: torch.Tensor,
                        trans: bool = False) -> torch.Tensor:
    """The kernel's plain version: the blocked row-block solve, step by step.
    ``V`` has ``n <= n_pad`` rows (the rest read as zero); returns the
    ``(n_pad, k)`` solution."""
    _check_shapes(L, diag_inv, V)
    n_pad, S = L.shape[0], STEP
    Vp = V.new_zeros((n_pad, V.shape[1]))
    Vp[: V.shape[0]] = V
    Y = torch.zeros_like(Vp)
    nb = n_pad // S
    for s in range(nb):
        k = nb - 1 - s if trans else s
        rows = slice(k * S, (k + 1) * S)
        W = _step_inverse(diag_inv, k)
        if trans:
            below = slice((k + 1) * S, n_pad)
            Y[rows] = W.T @ (Vp[rows] - L[below, rows].T @ Y[below])
        else:
            Y[rows] = W @ (Vp[rows] - L[rows, : k * S] @ Y[: k * S])
    return Y


def trsm_rowblock(L: torch.Tensor, diag_inv: torch.Tensor, V: torch.Tensor,
                  trans: bool = False) -> torch.Tensor:
    """``L^{-1} V`` (``L^{-T} V`` with ``trans``), ``(n_pad, k)``, for ``V``
    of ``n <= n_pad`` rows and ``k <= MAX_COLS`` columns (rows from ``n``
    read as zero). CPU tensors: the plain version. CUDA tensors: one launch,
    float32 only; the result is a view of the kernel's ``(n_pad, 16 or
    64)`` buffer where the panel fills more than half its columns, else a
    compact copy (a kept one-column result would otherwise hold 16 times
    its memory: 60 MB more reserved in the Burgers cell)."""
    global LAUNCHES
    if V.device.type == "cpu":
        return trsm_rowblock_plain(L, diag_inv, V, trans)
    _check_shapes(L, diag_inv, V)
    n_pad, k = L.shape[0], V.shape[1]
    if not (L.dtype == diag_inv.dtype == V.dtype == torch.float32):
        raise TypeError(f"the row-block kernel takes float32, got {L.dtype}, {diag_inv.dtype}, {V.dtype}")
    if not (L.device == diag_inv.device == V.device):
        raise ValueError("L, diag_inv and V must be on one device")
    if k > MAX_COLS:
        raise ValueError(f"the row-block kernel takes at most {MAX_COLS} columns, got {k}")
    if L.stride(1) != 1 or L.stride(0) % 4 or not diag_inv.is_contiguous():
        raise ValueError("L must have unit column stride and a row stride of whole 16-byte "
                         "units, diag_inv must be contiguous")
    if L.data_ptr() % 16 or diag_inv.data_ptr() % 16:
        raise ValueError("L and diag_inv must be 16-byte aligned")
    kc = 16 if k <= 16 else MAX_COLS
    S = STEP
    nb = n_pad // S
    dev = V.device
    Y = torch.empty((n_pad, kc), dtype=torch.float32, device=dev)
    R = torch.empty((2, S, kc), dtype=torch.float32, device=dev)
    flags = torch.zeros(2 + (2 + S // _LIMITS["quarter"]) * nb, dtype=torch.int32, device=dev)
    lib = _kernel_lib()
    err = lib.trsm_rowblock_launch(
        int(trans), kc, L.data_ptr(), L.stride(0), diag_inv.data_ptr(), diag_inv.shape[-1],
        V.data_ptr(), V.stride(0), V.stride(1), V.shape[0], Y.data_ptr(), R.data_ptr(),
        flags.data_ptr(), nb, k, CHUNK_ROWS // S, _sm_count(dev.index),
        torch._C._cuda_getCurrentRawStream(dev.index),  # current_stream(dev).cuda_stream
    )
    if err != 0:
        raise RuntimeError(f"trsm_rowblock kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return Y[:, :k] if 2 * k > kc else Y[:, :k].contiguous()


@lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("trsm_rowblock")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.trsm_rowblock_launch.argtypes = [i, i, p, ll, p, i, p, ll, ll, i, p, p, p, i, i, i, i, p]
    lib.trsm_rowblock_launch.restype = i
    lib.trsm_rowblock_prepare.argtypes = []
    lib.trsm_rowblock_prepare.restype = i
    lib.trsm_rowblock_limits.argtypes = [p]
    lib.trsm_rowblock_limits.restype = None
    got = (ctypes.c_int * len(_LIMITS))()
    lib.trsm_rowblock_limits(ctypes.addressof(got))
    if list(got) != list(_LIMITS.values()):
        raise RuntimeError(f"csrc/trsm_rowblock.cu limits {list(got)} differ from "
                           f"ops/trsm_rowblock.py {list(_LIMITS.values())}")
    err = lib.trsm_rowblock_prepare()
    if err != 0:
        raise RuntimeError(f"trsm_rowblock kernel set-up failed: CUDA error {err}")
    return lib
