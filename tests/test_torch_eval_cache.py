"""The model constructors' data evaluation on the CPU: the semantic key of a
user data callable (``models/elliptic.py::_eval_key``, ported from the JAX
package's, whose cases in ``tests/test_engine.py`` these follow), the
cache of recorded evaluations (``ops/graphs.py::evaluated``) with a
recording that fails, nothing recorded on the CPU, and the values against
the JAX package's ``_eval_on``. The recording itself needs a card
(``tests/test_torch_cuda.py``)."""

import gc
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinpdes_gpsolver_tpu_torch as tpt
from nonlinpdes_gpsolver_tpu.models.elliptic import _eval_on as jax_eval_on
from nonlinpdes_gpsolver_tpu_torch.models.elliptic import _eval_key, _eval_on
from nonlinpdes_gpsolver_tpu_torch.ops import graphs
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)


def _module(source: str, **values) -> types.ModuleType:
    """A user module made of ``source``, its globals set to ``values``."""
    mod = types.ModuleType("user_module")
    exec("import torch\n" + source, mod.__dict__)
    mod.__dict__.update(values)
    return mod


def _scaled(a):
    return lambda x: a * x[0]


def _one_line():
    return [lambda x: 2.0 * x[0] for _ in range(2)]


def _compat_wrappers():
    """``compat.solver_GP`` wraps a reference-style ``f(x1, x2)`` in new
    functions at each problem it sets up."""
    from nonlinpdes_gpsolver_tpu_torch.compat import _as_vec_fn

    def user_f(x1, x2):
        return torch.sin(x1) * x2

    return _as_vec_fn(user_f), _as_vec_fn(user_f)


def _tensor_closures():
    t = torch.ones(2, dtype=torch.float64)
    return [lambda x: (t * x).sum() for _ in range(2)]


class Unhashable:
    __hash__ = None

    def __init__(self, a):
        self.a = a


# (first callable, second callable) -> one key, or -> two keys
SAME = {
    "one_source_line": _one_line,
    "factory_closures": lambda: (tpt.workloads.elliptic_rhs(), tpt.workloads.elliptic_rhs()),
    "one_function": lambda: (tpt.workloads.u_elliptic, tpt.workloads.u_elliptic),
    "one_tensor": _tensor_closures,
    "compat_wrappers": _compat_wrappers,
}
OTHER = {
    "closure_value": lambda: (tpt.workloads.elliptic_rhs(1.0), tpt.workloads.elliptic_rhs(2.0)),
    "int_and_float": lambda: (_scaled(2), _scaled(2.0)),
    "defaults": lambda: ((lambda x, a=1.0: a * x[0]), (lambda x, a=3.0: a * x[0])),
    "two_tensors": lambda: (_scaled(torch.ones(2)), _scaled(torch.ones(2))),
    "other_code": lambda: (tpt.workloads.u_elliptic, tpt.workloads.burgers_g),
}


@pytest.mark.parametrize("case", sorted(SAME))
def test_callables_of_one_meaning_share_a_key(case):
    f, g = SAME[case]()
    assert f is not g or case == "one_function"
    (kf, _), (kg, _) = _eval_key(f), _eval_key(g)
    assert kf == kg and hash(kf) == hash(kg)


@pytest.mark.parametrize("case", sorted(OTHER))
def test_callables_of_another_meaning_get_another_key(case):
    f, g = OTHER[case]()
    assert _eval_key(f)[0] != _eval_key(g)[0]


@pytest.mark.parametrize("where", ["the_callable", "a_helper_it_calls"])
def test_a_rebound_global_is_a_miss_and_its_new_value_is_used(where):
    """Rebinding a module global the callable reads, or one read by a
    function of its module that it calls, changes its key."""
    mod = _module("def helper(x):\n    return AMP * x[0]\n"
                  "def f(x):\n    return AMP * x[0]\n"
                  "def g(x):\n    return helper(x)\n", AMP=2.0)
    fn = mod.f if where == "the_callable" else mod.g
    X = torch.tensor([[1.0, 0.0], [3.0, 0.0]], dtype=torch.float64)
    first = _eval_key(fn)[0]
    torch.testing.assert_close(_eval_on(fn, X), torch.tensor([2.0, 6.0], dtype=torch.float64))
    mod.AMP = 5.0
    assert _eval_key(fn)[0] != first
    torch.testing.assert_close(_eval_on(fn, X), torch.tensor([5.0, 15.0], dtype=torch.float64))
    mod.AMP = 2.0
    assert _eval_key(fn)[0] == first


def test_a_rebound_closure_cell_is_a_miss():
    a = 1.0

    def f(x):
        return a * x[0]

    first = _eval_key(f)[0]
    a = 4.0  # noqa: F841  (read by f through its cell)
    assert _eval_key(f)[0] != first


def test_a_function_that_reads_itself_has_a_key():
    mod = _module("def f(x, n=2):\n    return x[0] if n == 0 else f(x, n - 1)\n")
    key, held = _eval_key(mod.f)
    assert key == _eval_key(mod.f)[0] and held == (mod.f,)


@pytest.mark.parametrize("kind", ["unhashable", "tensor"])
def test_a_value_keyed_by_identity_is_held_with_the_key(kind):
    value = Unhashable(3.0) if kind == "unhashable" else torch.full((2,), 3.0)
    fn = (lambda x: value.a * x[0]) if kind == "unhashable" else (lambda x: (value * x).sum())
    key, held = _eval_key(fn)
    assert held == (fn, value)
    assert ("#id", id(value)) == key[3][0][:2]


@pytest.fixture
def failing_capture(monkeypatch):
    """Recordings that fail as a capture does on the card, counted."""
    calls = []

    def capture(self, compute, X):
        calls.append(X.shape)
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(graphs._Evaluation, "_capture", capture)
    graphs.clear_evaluations()
    graphs.reset_counts()
    yield calls
    graphs.clear_evaluations()
    graphs.reset_counts()


def _evaluate(fn, X):
    def compute(x):
        return torch.func.vmap(fn)(x).to(x.dtype)

    return graphs.evaluated(compute, X, *_eval_key(fn))


def test_a_failed_recording_leaves_its_key_eager_for_good(failing_capture):
    X = torch.rand(7, 2, dtype=torch.float64)
    fn = tpt.workloads.elliptic_rhs()
    want = torch.func.vmap(fn)(X)
    for _ in range(3):
        torch.testing.assert_close(_evaluate(tpt.workloads.elliptic_rhs(), X), want,
                                   rtol=0, atol=0)
    assert failing_capture == [(7, 2)]
    assert (graphs.EVAL_EAGER, graphs.EVAL_CAPTURES, graphs.EVAL_REPLAYS) == (1, 0, 0)
    (entry,) = graphs._EVALS.values()
    assert entry.graph is None and entry.why.startswith("RuntimeError: operation not permitted")
    _evaluate(fn, torch.rand(5, 2, dtype=torch.float64))  # another shape is another entry
    assert failing_capture == [(7, 2), (5, 2)] and len(graphs._EVALS) == 2


def test_an_entry_holds_what_its_key_names_by_identity(failing_capture):
    value = Unhashable(3.0)
    fn = lambda x: value.a * x[0]  # noqa: E731
    alive = weakref.ref(value)
    X = torch.rand(4, 2, dtype=torch.float64)
    torch.testing.assert_close(_evaluate(fn, X), 3.0 * X[:, 0])
    del fn, value
    gc.collect()
    assert alive() is not None  # no new object can take its id while the key lives
    graphs.clear_evaluations()
    gc.collect()
    assert alive() is None


def test_the_least_recently_used_entry_goes_first(failing_capture):
    X = torch.rand(3, 2, dtype=torch.float64)
    first = Unhashable(1.0)
    alive = weakref.ref(first)
    _evaluate(lambda x, v=first: v.a * x[0], X)
    del first
    for k in range(graphs.EVAL_LIMIT - 1):
        _evaluate(_scaled(float(k)), X)
    gc.collect()
    assert alive() is not None and len(graphs._EVALS) == graphs.EVAL_LIMIT
    _evaluate(_scaled(-1.0), X)
    gc.collect()
    assert alive() is None and len(graphs._EVALS) == graphs.EVAL_LIMIT


def _problem(name, X, Y):
    k = tpt.SquaredExponential.gaussian(0.3)
    if name == "elliptic":
        return tpt.models.nonlinear_elliptic(k, X, Y, tpt.workloads.elliptic_rhs(),
                                             tpt.workloads.u_elliptic)
    if name == "elliptic_relaxed":
        return tpt.models.nonlinear_elliptic_relaxed(k, X, Y, tpt.workloads.elliptic_rhs(),
                                                     tpt.workloads.u_elliptic)
    if name == "burgers":
        return tpt.models.burgers(k, X, Y, tpt.workloads.burgers_g, lambda x: 0.0 * x[0])
    if name == "eikonal":
        return tpt.models.eikonal(k, X, Y, lambda x: torch.ones_like(x[0]), None)
    return tpt.models.darcy_flow(k, k, X, Y, torch.zeros(4, dtype=X.dtype),
                                 lambda x: torch.ones_like(x[0]))


@pytest.mark.parametrize("name", ["elliptic", "elliptic_relaxed", "burgers", "eikonal",
                                  "darcy"])
def test_the_cpu_records_nothing(name):
    graphs.clear_evaluations()
    graphs.reset_counts()
    gen = torch.Generator().manual_seed(1)
    X, Y = tpt.utils.sample_random(gen, 20, 8, dtype=torch.float64)
    for _ in range(2):
        prob = _problem(name, X, Y)
        assert [s[0] for s in prob.trace.spans] == ["build"]
    assert (graphs.EVAL_CAPTURES, graphs.EVAL_REPLAYS, graphs.EVAL_EAGER) == (0, 0, 0)
    assert not graphs._EVALS
    assert not graphs.records_on("cpu") and graphs.records_on("cuda")
    with graphs.uncaptured():
        assert not graphs.records_on("cuda")


def _u_jax(x):
    return jnp.sin(jnp.pi * x[0]) * jnp.sin(jnp.pi * x[1]) + 2 * jnp.sin(
        4 * jnp.pi * x[0]
    ) * jnp.sin(4 * jnp.pi * x[1])


def _rhs_jax(x):
    return -jnp.trace(jax.hessian(_u_jax)(x)) + _u_jax(x) ** 3


def _burgers_g_jax(x):
    return jnp.where(x[0] == 0.0, -jnp.sin(jnp.pi * x[1]), 0.0)


PAIRS = {
    "elliptic_rhs": (tpt.workloads.elliptic_rhs(), _rhs_jax),
    "u_elliptic": (tpt.workloads.u_elliptic, _u_jax),
    "burgers_g": (tpt.workloads.burgers_g, _burgers_g_jax),
    "none": (None, None),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_values_match_the_jax_package(name):
    """f64 on the same points; a hessian by autodiff in both."""
    ours, theirs = PAIRS[name]
    rng = np.random.default_rng(5)
    X = rng.uniform(0.0, 1.0, (40, 2))
    X[:6, 0] = 0.0  # Burgers' initial line
    got = _eval_on(ours, torch.as_tensor(X))
    ref = np.asarray(jax_eval_on(theirs, jnp.asarray(X)))
    assert got.dtype == torch.float64 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-12 * max(1.0, float(np.abs(ref).max())))
