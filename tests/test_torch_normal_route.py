"""The mesh path's ``'normal'`` step on a Burgers problem (anisotropic
kernel, three latent slices): the count of Gauss-Newton loops by step
solver (``ops/graphs.py::STEP_SOLVERS``), the phases that time the step's
state once a factorization and its steps (``gauss_newton.normal_state``,
``gauss_newton.normal_step``), and on a card the same phases with no
synchronize on a warm solve's path, which replays its loop bitwise an
unshared eager solve.

The file imports nothing of JAX: on a machine with a card,
``python -m pytest --noconftest -q tests/test_torch_normal_route.py``.
"""

import pytest
import torch

import nonlinpdes_gpsolver_tpu_torch as tpt
from nonlinpdes_gpsolver_tpu_torch.ops import graphs
from nonlinpdes_gpsolver_tpu_torch.solvers import _reuse
from nonlinpdes_gpsolver_tpu_torch.solvers.distributed import gn_solve_distributed
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

NORMAL = ("gauss_newton.normal_state", "gauss_newton.normal_step")
DOMAIN = ((0.0, 1.0), (-1.0, 1.0))


def _g(x):
    return torch.where(x[0] == 0.0, -torch.sin(torch.pi * x[1]), 0.0)


def _burgers(seed=0, n_dom=48, n_bdy=16, device="cpu", dtype=torch.float64):
    gen = torch.Generator(device=device).manual_seed(seed)
    Xd, Xb = tpt.utils.sample_random(gen, n_dom, n_bdy, domain=DOMAIN, time_dependent=True,
                                     dtype=dtype)
    return tpt.models.burgers(tpt.SquaredExponential.anisotropic([0.3, 0.05]), Xd, Xb, _g,
                              nu=0.02, seed=seed)


def _elliptic(seed=0, n_dom=40, n_bdy=16):
    gen = torch.Generator().manual_seed(seed)
    Xd, Xb = tpt.utils.sample_random(gen, n_dom, n_bdy, dtype=torch.float64)
    return tpt.models.nonlinear_elliptic(
        tpt.SquaredExponential.gaussian(0.3), Xd, Xb,
        lambda x: torch.sin(torch.pi * x[0]) * torch.sin(torch.pi * x[1]), None)


def _mesh(device="cpu"):
    return tpt.parallel.make_mesh(1, device=device)


def _names(res):
    return [s[0] for s in res.trace.spans]


@pytest.fixture(autouse=True)
def _fresh_counts():
    graphs.reset_counts()
    yield
    graphs.reset_counts()


def test_every_loop_counts_its_step_solver():
    mesh = _mesh()
    s = tpt.GPSolver(_burgers(), nugget=1e-5, mesh=mesh, mesh_block=32)
    s.solve(max_iter=2, step_solver="normal")
    s.solve(max_iter=2, step_solver="normal")
    assert graphs.STEP_SOLVERS == {"normal": 2}
    # 'auto' past the panel limit: the anisotropic problem takes 'normal', the
    # isotropic one 'cg'
    gn_solve_distributed(s.fp, max_iter=1, direct_panel_limit=16)
    iso = tpt.GPSolver(_elliptic(), nugget=1e-8, mesh=mesh, mesh_block=16)
    gn_solve_distributed(iso.fp, max_iter=1, direct_panel_limit=8)
    tpt.GPSolver(_elliptic(), nugget=1e-8, solve_mode="trsm").solve(max_iter=1)
    assert graphs.STEP_SOLVERS == {"normal": 3, "cg": 1, "direct": 1}
    graphs.reset_counts()
    assert graphs.STEP_SOLVERS == {}


def test_the_normal_state_is_timed_once_a_factorization():
    mesh = _mesh()
    s = tpt.GPSolver(_burgers(1), nugget=1e-5, mesh=mesh, mesh_block=32)
    res = s.solve(max_iter=3, step_solver="normal")
    assert _names(res).count("gauss_newton.normal_state") == 1
    assert _names(res).count("gauss_newton.normal_step") == 3
    t = res.timers
    assert min(t[k] for k in NORMAL) > 0.0
    assert t["gauss_newton.normal_state"] + t["gauss_newton.normal_step"] <= t["gauss_newton"]
    for i, (name, *_rest) in enumerate(res.trace.spans):
        if name in NORMAL:
            assert res.trace.spans[res.trace.spans[i][3]][0] == "gauss_newton", name
    # the same factors solved again: the state is not computed again
    again = s.solve(max_iter=3, step_solver="normal")
    assert _names(again).count("gauss_newton.normal_state") == 1
    assert _names(again).count("gauss_newton.normal_step") == 6
    # a new problem of the layout factors into the released entry: its own state
    del s, res, again
    other = tpt.GPSolver(_burgers(2), nugget=1e-5, mesh=mesh, mesh_block=32)
    res = other.solve(max_iter=3, step_solver="normal")
    assert _names(res).count("gauss_newton.normal_state") == 1
    assert res.timers["gauss_newton.normal_state"] > 0.0


@pytest.mark.parametrize("kw", [
    {"step_solver": "structured"}, {"step_solver": "cg"},
], ids=["structured", "cg"])
def test_other_steps_leave_the_normal_keys_at_zero(kw):
    s = tpt.GPSolver(_burgers(3), nugget=1e-5, mesh=_mesh(), mesh_block=32)
    res = s.solve(max_iter=2, **kw)
    assert all(res.timers[k] == 0.0 for k in NORMAL), res.timers
    assert not set(NORMAL) & set(_names(res))
    assert graphs.STEP_SOLVERS == {kw["step_solver"]: 1}


@pytest.mark.cuda
def test_warm_normal_solves_never_synchronize_and_replay_bitwise(monkeypatch):
    """Fresh Burgers problems past the panel limit (latent 4,500) on a
    one-card mesh, each result held until the next: 'auto' routes them to
    'normal'; warm, with ``torch.cuda.synchronize`` made to raise, the
    phases time the state and the steps, and the replayed loop with its
    refilled inverse blocks is bitwise a solve that shares nothing with any
    entry and runs eagerly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cuda = torch.device("cuda")
    tpt.clear_graph_cache()
    mesh = _mesh(cuda)

    def solve(seed):
        prob = _burgers(seed, 1500, 300, device=cuda, dtype=torch.float32)
        return prob, tpt.GPSolver(prob, nugget=1e-5, mesh=mesh).solve(max_iter=8)

    held = None
    for seed in range(4):  # warm: entries made, loops recorded
        held = solve(seed)
    captures = graphs.CAPTURES

    def forbidden(*args, **kwargs):
        raise AssertionError("torch.cuda.synchronize on a solve's path")

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "synchronize", forbidden)
        prob, res = held = solve(7)
    assert graphs.CAPTURES == captures
    assert res.state.step_solver == "normal" and graphs.STEP_SOLVERS == {"normal": 5}
    t = res.timers
    assert min(t[k] for k in NORMAL) > 0.0, t
    assert t["gauss_newton.normal_state"] + t["gauss_newton.normal_step"] <= t["gauss_newton"]
    with graphs.uncaptured(), _reuse._unshared():
        ref = tpt.GPSolver(prob, nugget=1e-5, mesh=mesh).solve(max_iter=8)
    assert torch.equal(res.z, ref.z) and torch.equal(res.state.losses, ref.state.losses)
    del held, res, ref
    tpt.clear_graph_cache()
