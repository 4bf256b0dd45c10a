"""Nonlinear elliptic equation ``-Delta u + alpha * u^m = f`` (Dirichlet BC).

Counterpart of ``nonlinpdes_gpsolver_tpu/models/elliptic.py``:

* observed functionals ``[Delta u @ interior, u @ interior, u @ boundary]``;
* elimination form: latent ``z`` = interior values of ``u``, with the
  Laplacian eliminated through the PDE, ``Delta u = alpha u^m - f``;
* relaxed (penalty) form: latent ``(v, w) ~ (Delta u, u)`` and the PDE
  residual penalized with weight ``1/pen_lambda``.

``rhs_f`` and ``bdy_g`` are callables of one point, evaluated over the
points with ``torch.func.vmap``, or tensors of values, or ``None`` (zero).
The callables are evaluated once, when the problem is built, into the
problem's ``data``; on a CUDA card that evaluation is recorded once per
callable's semantic key (:func:`_eval_key`) and shape, and replayed on
every later build (``ops/graphs.py::evaluated``), as the JAX package jits
its vmap once. The residuals come from ``lru_cache``'d factories, as
in the JAX package: one configuration gives the same function objects on
every rebuild, so that a problem rebuilt on fresh points and data shares
its recorded Gauss-Newton loop (``solvers/_reuse.py``). They close over
Python scalars only; every tensor reaches them through ``data``.
"""

from __future__ import annotations

import types
from functools import lru_cache
from typing import Callable, Hashable, Tuple, Union

import torch

from ..ops import graphs
from ..ops.assembly import Observable
from ..ops.kernels import SquaredExponential
from ..ops.operators import identity, laplacian
from ..utils import tracing
from .spec import CollocationProblem, GPBlock, Misfit

Values = Union[Callable[[torch.Tensor], torch.Tensor], torch.Tensor, None]


@lru_cache(maxsize=256)
def _code_names(code: types.CodeType) -> tuple:
    """The names ``code`` and the code objects nested in it read (a lambda
    returned by a factory reads its globals through an inner code object)."""
    names, todo = set(), [code]
    while todo:
        c = todo.pop()
        names.update(c.co_names)
        todo.extend(k for k in c.co_consts if isinstance(k, types.CodeType))
    return tuple(sorted(names))


def _token(v, held: list, keys: dict, module):
    """A hashable stand-in for a value a callable of ``module`` reads: a
    function of that module by its own key; a hashable value with its
    type; otherwise (and a tensor) its identity, ``v`` appended to
    ``held``."""
    if isinstance(v, types.FunctionType) and v.__module__ == module:
        return _fn_key(v, held, keys)
    if not isinstance(v, torch.Tensor):
        try:
            hash(v)
            return (type(v), v)
        except TypeError:
            pass
    held.append(v)
    return ("#id", id(v), type(v).__name__, str(getattr(v, "shape", None)),
            str(getattr(v, "dtype", None)))


def _cell(cell, held: list, keys: dict, module):
    try:
        return _token(cell.cell_contents, held, keys, module)
    except ValueError:  # a cell not yet bound
        return "#empty"


def _fn_key(fn: types.FunctionType, held: list, keys: dict):
    """The key of ``fn``; ``keys`` holds those made so far by ``id``
    (``None`` while one is being made: a function that reads itself)."""
    if id(fn) in keys:
        return keys[id(fn)] or ("#self", fn.__code__)
    keys[id(fn)] = None
    gl, mod = fn.__globals__, fn.__module__
    key = keys[id(fn)] = (
        fn.__code__,
        tuple(_token(d, held, keys, mod) for d in fn.__defaults__ or ()),
        tuple((k, _token(v, held, keys, mod))
              for k, v in sorted((fn.__kwdefaults__ or {}).items())),
        tuple(_cell(c, held, keys, mod) for c in fn.__closure__ or ()),
        tuple((n, _token(gl[n], held, keys, mod)) for n in _code_names(fn.__code__) if n in gl),
    )
    return key


def _eval_key(fn: Callable) -> Tuple[Hashable, tuple]:
    """``(key, held)``: the semantic key of a user data callable, ported
    from the JAX package's ``_eval_key`` (``models/elliptic.py`` there),
    and the objects it names by identity, which whatever keeps the key
    must keep alive (so that no live key's ``id`` is reused; the JAX
    package's key does not hold them).

    The key is the code object, the defaults, the closure cells' values and
    the values of the globals the code (and the code nested in it) reads.
    Two lambdas made by re-running one source line share it; rebinding a
    global or a closure cell the function reads changes it. A function of
    the same module among those values is keyed the same way, so that a
    helper the callable calls, or a lambda a wrapper closes over, is seen
    by what it reads; a function of another module (a library's) by its
    identity. A hashable value is keyed by its type and value, an
    unhashable one (and a tensor) by its identity, shape and dtype. A
    mutation in place of an object the function reads is the one change
    the key cannot see, as with ``jax.jit``'s own caching. A callable that
    is not a plain function is keyed by its identity."""
    held = [fn]
    if isinstance(fn, types.FunctionType):
        return _fn_key(fn, held, {}), tuple(held)
    return _token(fn, held, {}, None), tuple(held)


def _eval_on(fn: Values, X: torch.Tensor) -> torch.Tensor:
    if fn is None:
        return torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)
    if isinstance(fn, torch.Tensor):
        return fn.to(device=X.device, dtype=X.dtype)

    def compute(x):
        return torch.func.vmap(fn)(x).to(x.dtype)

    if not graphs.records_on(X.device):
        return compute(X)
    return graphs.evaluated(compute, X, *_eval_key(fn))


def _observables():
    return (
        Observable("domain", laplacian()),
        Observable("domain", identity()),
        Observable("boundary", identity()),
    )


@lru_cache(maxsize=None)
def _elliptic_residual(alpha: float, m: int):
    """The elimination form's residual (cached: one function per
    configuration)."""

    def residual(z, data):
        # [Delta u; u_int; u_bd] with Delta u eliminated via the PDE
        return torch.cat([alpha * z**m - data["f"], z, data["g"]])

    return residual


@lru_cache(maxsize=None)
def _elliptic_relaxed_residuals(alpha: float, m: int, N_d: int):
    """The penalty form's block residual and PDE penalty (cached)."""

    def residual(z, data):
        return torch.cat([z, data["g"]])  # [v; w; g] - linear in z

    def pde_penalty(z, data):
        v, w = z[:N_d], z[N_d:]
        return -v + alpha * w**m - data["f"]

    return residual, pde_penalty


def _latent_init(init: str, size: int, seed: int, like: torch.Tensor):
    def latent_init() -> torch.Tensor:
        if init == "zero":
            return torch.zeros(size, dtype=like.dtype, device=like.device)
        gen = torch.Generator(device=like.device).manual_seed(seed)
        return torch.randn(size, generator=gen, dtype=like.dtype, device=like.device)

    return latent_init


def nonlinear_elliptic(
    kernel: SquaredExponential,
    X_domain: torch.Tensor,
    X_boundary: torch.Tensor,
    rhs_f: Values,
    bdy_g: Values,
    alpha: float = 1.0,
    m: int = 3,
    init: str = "random",
    seed: int = 0,
) -> CollocationProblem:
    """Elimination form: latent z = u at the interior points.

    The problem lives on the device and dtype of ``X_domain``. ``init='random'``
    draws ``z0`` from a ``torch.Generator`` seeded with ``seed`` on that
    device; it is not the JAX package's draw (pass that through
    :func:`..interop.problem_from_numpy`).
    """
    N_d = X_domain.shape[0]
    trace = tracing.Record()
    with trace.building():
        data = {"f": _eval_on(rhs_f, X_domain), "g": _eval_on(bdy_g, X_boundary)}
    residual = _elliptic_residual(float(alpha), int(m))
    return CollocationProblem(
        name="nonlinear_elliptic",
        blocks=(GPBlock("u", kernel, _observables(), residual),),
        points={"domain": X_domain, "boundary": X_boundary},
        data=data,
        latent_dim=N_d,
        latent_init=_latent_init(init, N_d, seed, X_domain),
        trace=trace,
    )


def nonlinear_elliptic_relaxed(
    kernel: SquaredExponential,
    X_domain: torch.Tensor,
    X_boundary: torch.Tensor,
    rhs_f: Values,
    bdy_g: Values,
    alpha: float = 1.0,
    m: int = 3,
    pen_lambda: float = 1e-10,
    init: str = "random",
    seed: int = 0,
) -> CollocationProblem:
    """Penalty form: latent z = (v, w) ~ (Delta u, u) at the interior points.

    Loss: ``||L^{-1}[v; w; g]||^2 + (1/pen_lambda)||-v + alpha w^m - f||^2``.
    """
    N_d = int(X_domain.shape[0])
    trace = tracing.Record()
    with trace.building():
        data = {"f": _eval_on(rhs_f, X_domain), "g": _eval_on(bdy_g, X_boundary)}
    residual, pde_penalty = _elliptic_relaxed_residuals(float(alpha), int(m), N_d)
    return CollocationProblem(
        name="nonlinear_elliptic_relaxed",
        blocks=(GPBlock("u", kernel, _observables(), residual),),
        points={"domain": X_domain, "boundary": X_boundary},
        data=data,
        latent_dim=2 * N_d,
        misfits=(Misfit("pde", pde_penalty, 1.0 / pen_lambda),),
        latent_init=_latent_init(init, 2 * N_d, seed, X_domain),
        trace=trace,
    )
