"""The mesh path's ``'normal'`` step on a Burgers problem (anisotropic
kernel, three latent slices): the count of Gauss-Newton loops by step
solver (``ops/graphs.py::STEP_SOLVERS``), the phases that time the step's
state once a factorization and its steps (``gauss_newton.normal_state``,
``gauss_newton.normal_step``), and on a card the same phases with no
synchronize on a warm solve's path, which replays its loop bitwise an
unshared eager solve. The state at P = 1 in ``potri``'s order
(``_interior_inverse_potri``) against the kernel solves on identity
columns that the ranks keep (``_interior_inverse_solves``): in float64 on
the CPU on Burgers and Darcy problems, and on a card in float32 against a
float64 inverse.

The file imports nothing of JAX: on a machine with a card,
``python -m pytest --noconftest -q tests/test_torch_normal_route.py``.
"""

import pytest
import torch

import nonlinpdes_gpsolver_tpu_torch as tpt
from nonlinpdes_gpsolver_tpu_torch.ops import graphs
from nonlinpdes_gpsolver_tpu_torch.solvers import _reuse
from nonlinpdes_gpsolver_tpu_torch.solvers import distributed as tdist
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


def _darcy(seed=0, n_dom=48, n_bdy=16):
    gen = torch.Generator().manual_seed(seed)
    Xd, Xb = tpt.utils.sample_random(gen, n_dom, n_bdy, dtype=torch.float64)
    k = tpt.SquaredExponential.gaussian(0.4)
    return tpt.models.darcy_flow(k, k, Xd, Xb, torch.linspace(0.0, 0.01, 12, dtype=torch.float64),
                                 lambda x: torch.ones_like(x[0]), noise_level=1e-2, seed=3)


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


def _interior(fp, structure):
    """Per block the offsets of its interior segments."""
    _, N, seginfo = structure
    return [[off for off, sz in segs if sz == N] for segs in seginfo]


def _solves_state(fp, structure):
    """The state by the kernel solves on identity columns (the ranks' route)."""
    _, N, _ = structure
    return [tdist._interior_inverse_solves(fp, b.name, live, N).reshape(len(live), N, len(live), N)
            for b, live in zip(fp.problem.blocks, _interior(fp, structure))]


# (problem, nugget, mesh_block): the product's panels are 2 mesh_block columns
# wide, so 16 splits the 48-point segments and 32 and 64 span more than one;
# the forward stage's column groups are the factor's row blocks, which 16 and
# 32 do not align with the segments either
POTRI_CASES = [("burgers", 1e-5, 32), ("burgers", 1e-5, 16), ("burgers", 1e-5, 64),
               ("darcy", 1e-4, 32)]


@pytest.mark.parametrize("name,nugget,block", POTRI_CASES,
                         ids=[f"{c[0]}-b{c[2]}" for c in POTRI_CASES])
def test_potri_state_matches_the_solves(monkeypatch, name, nugget, block):
    """At P = 1 the interior inverse blocks in ``potri``'s order equal those
    of the kernel solves on identity columns to 1e-9 of their largest entry
    (float64), are exactly symmetric, and give the 3-step ``'normal'``
    iterate of the solves to 1e-8 of its scale; the counter says which
    route each state took."""
    prob = _burgers() if name == "burgers" else _darcy()
    fp = tdist.factorize_distributed(prob, _mesh(), nugget=nugget, block=block)
    structure = tdist._slice_structure(prob)
    new = tdist._normal_state(fp, structure)
    assert graphs.NORMAL_STATES == {"potri": 1, "solves": 0}
    assert len(new) == len(prob.blocks)
    for A, ref in zip(new, _solves_state(fp, structure)):
        width = ref.shape[0] * ref.shape[1]
        A2 = A.reshape(width, width)
        assert A.shape == ref.shape and A.dtype == torch.float64
        assert float((A - ref).abs().max()) <= 1e-9 * float(ref.abs().max())
        assert torch.equal(A2, A2.mT)
    st = gn_solve_distributed(fp, max_iter=3, step_solver="normal")
    # the ranks' route on a factorization of its own, so that its loop
    # computes the state again
    monkeypatch.setattr(tdist, "_interior_inverse_potri", tdist._interior_inverse_solves)
    fp2 = tdist.factorize_distributed(prob, _mesh(), nugget=nugget, block=block)
    ref = gn_solve_distributed(fp2, max_iter=3, step_solver="normal")
    assert st.step_solver == ref.step_solver == "normal"
    scale = float(ref.z.abs().max())
    assert float((st.z - ref.z).abs().max()) <= 1e-8 * scale
    torch.testing.assert_close(st.losses, ref.losses, rtol=1e-8, atol=0.0)


def test_potri_state_skips_rows_above_and_between_segments():
    """Interior rows that start past the factor's first row block, with a gap
    between the segments (boundary rows first and between them, as another
    problem may order its functionals): the same block as the solves."""
    fp = tdist.factorize_distributed(_burgers(4), _mesh(), nugget=1e-5, block=16)
    for live in ([40, 120], [37], [20, 68, 150]):
        A = tdist._interior_inverse_potri(fp, "u", live, 48)
        ref = tdist._interior_inverse_solves(fp, "u", live, 48)
        assert float((A - ref).abs().max()) <= 1e-9 * float(ref.abs().max()), live
        assert torch.equal(A, A.mT)


@pytest.mark.cuda
def test_potri_state_on_a_card_is_as_close_to_float64(monkeypatch):
    """1,000 + 200 Burgers points in float32 on a one-card mesh: the interior
    inverse block in ``potri``'s order is within 1.5 times the kernel solves'
    gap to the float64 inverse of the same float32 factor, and exactly
    symmetric."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cuda = torch.device("cuda")
    prob = _burgers(5, 1000, 200, device=cuda, dtype=torch.float32)
    fp = tdist.factorize_distributed(prob, _mesh(cuda), nugget=1e-5)
    structure = tdist._slice_structure(prob)
    _, N, _ = structure
    (live,) = _interior(fp, structure)
    A = tdist._interior_inverse_potri(fp, "u", live, N)
    ref = tdist._interior_inverse_solves(fp, "u", live, N)
    fac = fp.factors["u"]
    L = fac.dense().double()
    s = fp.col_scales["u"].double()
    Linv = torch.linalg.solve_triangular(L, torch.eye(fac.n, dtype=torch.float64, device=cuda),
                                         upper=False)
    rows = torch.cat([off + torch.arange(N, device=cuda) for off in live])
    Y = Linv[:, rows] * s[rows]
    exact = Y.mT @ Y
    gap = lambda X: float((X.double() - exact).abs().max() / exact.abs().max())  # noqa: E731
    assert gap(A) <= 1.5 * gap(ref), (gap(A), gap(ref))
    assert torch.equal(A, A.mT)


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
