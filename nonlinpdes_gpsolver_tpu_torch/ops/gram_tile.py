"""Gram tile kernel K1: derivative-kernel Gram blocks on the card.

Counterpart of ``nonlinpdes_gpsolver_tpu/ops/pallas_gram.py``. The CUDA
kernel (``csrc/gram_tile.cu``) evaluates

    out[i, j] = sum_beta c_beta * prod_k p_{beta_k}(u_k) * exp(-sum_k a_k u_k^2)

with ``u = x_i - y_j`` from a small table packed by :func:`_packed_table`
out of the same :func:`_combined_terms` as the Pallas kernel.

:func:`gram_tile_pair_fn` returns the block evaluator. Which version runs
depends only on where the tensors lie: for CPU tensors it runs the plain
version (``SquaredExponential.pair_fn``); for CUDA tensors it launches the
kernel, in f32 or f64, and raises for any other dtype. ``LAUNCHES`` counts
kernel launches, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from .kernels import SquaredExponential, _derivative_poly_coeffs
from .operators import LinearOp

# Limits of csrc/gram_tile.cu (kMaxDim, kMaxDeg, kMaxTerms); checked against
# the built library when it is loaded.
MAX_DIM = 3
MAX_DEGREE = 8
MAX_TERMS = 64

LAUNCHES = 0
"""Number of K1 launches in this process (the wrapper adds one per launch)."""


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


@lru_cache(maxsize=None)
def _packed_table(inv_sq, terms_x, terms_y, dtype: torch.dtype, device: torch.device):
    """Device copies of :func:`pack_terms`, cached per pair, dtype and device."""
    table, degs = pack_terms(inv_sq, terms_x, terms_y)
    return (
        torch.as_tensor(table, dtype=dtype, device=device),
        torch.as_tensor(degs, device=device).reshape(-1),
        degs.shape[0],
    )


@lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("gram_tile")
    lib.gram_tile_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.gram_tile_launch.restype = ctypes.c_int
    for fn in (lib.gram_tile_max_terms, lib.gram_tile_max_degree):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    if (lib.gram_tile_max_terms(), lib.gram_tile_max_degree()) != (
        MAX_TERMS, MAX_DEGREE,
    ):
        raise RuntimeError("csrc/gram_tile.cu limits differ from ops/gram_tile.py")
    return lib


def _launch(kernel, op_x, op_y, X, Y, out):
    global LAUNCHES
    dtype = X.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the Gram tile kernel takes float32 or float64, got {dtype}")
    if Y.device != X.device or Y.dtype != dtype:
        raise ValueError("X and Y must share device and dtype")
    if X.dim() != 2 or Y.dim() != 2 or X.shape[1] != kernel.dim or Y.shape[1] != kernel.dim:
        raise ValueError(
            f"X and Y must be (n, {kernel.dim}) and (m, {kernel.dim}); "
            f"got {tuple(X.shape)} and {tuple(Y.shape)}"
        )
    if not (X.is_contiguous() and Y.is_contiguous()):
        raise ValueError("X and Y must be contiguous")
    n, m = X.shape[0], Y.shape[0]
    if out is None:
        out = torch.empty((n, m), dtype=dtype, device=X.device)
    if (
        out.shape != (n, m) or out.dtype != dtype or out.device != X.device
        or (m > 1 and out.stride(1) != 1) or (n > 1 and out.stride(0) < m)
    ):
        raise ValueError(
            f"out must be an ({n}, {m}) {dtype} view on {X.device} with unit "
            f"column stride; got {tuple(out.shape)} strides {out.stride()}"
        )
    table, degs, n_terms = _packed_table(
        kernel.inv_sq, op_x.terms, op_y.terms, dtype, X.device
    )
    if n == 0 or m == 0:
        return out
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = lib.gram_tile_launch(
        int(dtype == torch.float64), X.data_ptr(), Y.data_ptr(), out.data_ptr(),
        n, m, kernel.dim, max(out.stride(0), m), table.data_ptr(),
        degs.data_ptr(), n_terms, stream,
    )
    if err != 0:
        raise RuntimeError(f"gram_tile kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def gram_tile_pair_fn(kernel: SquaredExponential, op_x: LinearOp, op_y: LinearOp):
    """Block evaluator ``block(X, Y, out=None) -> (N, M)`` for ``(op_x (x) op_y) kappa``.

    ``X: (N, dim)`` holds the row points and ``Y: (M, dim)`` the column
    points. ``out``, if given, is an ``(N, M)`` view with unit column stride,
    such as a slot of a larger matrix; the block is written into it.
    CUDA tensors go to the kernel; CPU tensors to the plain version.
    """
    plain = kernel.pair_fn(op_x, op_y)

    def block(X: torch.Tensor, Y: torch.Tensor, out: torch.Tensor | None = None):
        if X.device.type == "cuda":
            return _launch(kernel, op_x, op_y, X, Y, out)
        if X.device.type != "cpu":
            raise ValueError(f"no Gram tile implementation for device {X.device}")
        res = plain(X, Y)
        if out is None:
            return res
        out.copy_(res)
        return out

    return block
