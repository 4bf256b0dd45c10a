"""The Gauss-Newton loop shared by problems of one structure, on the CPU (f64).

The JAX package compiles its loop once per problem structure
(``solvers/gn.py::_gn_scan``, keyed on ``lru_cache``'d residual factories);
the port shares recorded loops, and the storage they read, among the
problems of one layout (``nonlinpdes_gpsolver_tpu_torch/solvers/_reuse.py``):
an entry per live problem, and a released one's storage for the next. On
the CPU nothing is recorded, but the sharing runs as on the card: a later
problem factors into a released entry's storage and solves through that
entry's loop, so its z is held here to its own JAX twin and, bitwise, to a
solve that shares nothing with any entry (``_reuse._unshared``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinpdes_gpsolver_tpu as gpt
import nonlinpdes_gpsolver_tpu_torch as tpt
from nonlinpdes_gpsolver_tpu.parallel.mesh import make_mesh as jax_mesh
from nonlinpdes_gpsolver_tpu.solvers import distributed as jdist
from nonlinpdes_gpsolver_tpu.solvers import gn as jgn
from nonlinpdes_gpsolver_tpu_torch.ops import assembly, graphs
from nonlinpdes_gpsolver_tpu_torch.solvers import _reuse
from nonlinpdes_gpsolver_tpu_torch.solvers import distributed as tdist
from nonlinpdes_gpsolver_tpu_torch.solvers import gn as tgn
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)

MESH = tpt.parallel.make_mesh(1, device="cpu")
INV_SQ = (1 / (2 * 0.3**2),) * 2
ANISO = (1 / (2 * 0.3**2), 1 / (2 * 0.2**2))


def _u(X):
    return np.sin(np.pi * X[:, 0]) * np.sin(np.pi * X[:, 1])


def _elliptic_arrays(n_dom, n_bdy, seed):
    """(X_domain, X_boundary, f, g, z0) of the elliptic problem, drawn with
    numpy ``seed``: one configuration, another instance per seed."""
    rng = np.random.default_rng(seed)
    Xd, Xb = rng.uniform(0, 1, (n_dom, 2)), rng.uniform(0, 1, (n_bdy, 2))
    return Xd, Xb, 2 * np.pi**2 * _u(Xd) + _u(Xd) ** 3, _u(Xb), rng.standard_normal(n_dom)


def _elliptic(arrays, alpha=1.0, m=3):
    Xd, Xb, f, g, z0 = arrays
    pj = gpt.models.nonlinear_elliptic(gpt.SquaredExponential(INV_SQ), jnp.asarray(Xd),
                                       jnp.asarray(Xb), jnp.asarray(f), jnp.asarray(g),
                                       alpha=alpha, m=m)
    pt = tpt.models.nonlinear_elliptic(tpt.SquaredExponential(INV_SQ),
                                       *map(torch.as_tensor, (Xd, Xb, f, g)), alpha=alpha, m=m)
    return pj, pt, z0


def _darcy(n_dom, n_bdy, seed, noise=1e-2):
    """The small Darcy inverse problem (sigma 0.3, 12 observations near
    linspace(0, 0.01), f = 1) on points and observations drawn with numpy
    ``seed``."""
    rng = np.random.default_rng(seed)
    Xd, Xb = rng.uniform(0, 1, (n_dom, 2)), rng.uniform(0, 1, (n_bdy, 2))
    obs = np.linspace(0.0, 0.01, 12) + 1e-3 * rng.standard_normal(12)
    f, g = np.ones(n_dom), np.zeros(n_bdy)
    z0 = 0.1 * rng.standard_normal(6 * n_dom)
    k = gpt.SquaredExponential(INV_SQ)
    pj = gpt.models.darcy_flow(k, k, jnp.asarray(Xd), jnp.asarray(Xb), jnp.asarray(obs),
                               jnp.asarray(f), jnp.asarray(g), noise_level=noise)
    pt = tpt.interop.darcy_from_numpy(Xd, Xb, f, g, obs, z0, INV_SQ, noise_level=noise,
                                      device="cpu")
    return pj, pt, z0


def _bound(fp):
    return _reuse.bound_entry(fp)


def _bound_as():
    """How the factorizations since the last ``graphs.reset_counts`` bound."""
    return (["made"] * graphs.ENTRIES + ["rebound"] * graphs.REBINDS
            + ["unshared"] * graphs.UNSHARED + ["guest"] * graphs.GUESTS)


def _stored(fp):
    """The tensors ``fp`` stores, by block and role (either path)."""
    return (tdist.mesh_tensors(fp) if isinstance(fp, tdist.DistributedFactoredProblem)
            else tgn.dense_tensors(fp))


def _storages(fp):
    return {t.untyped_storage().data_ptr() for roles in _stored(fp).values()
            for t in roles.values()}


def _unshared_solver(pt, **kw):
    """A solver of ``pt`` that shares nothing with any entry: its own
    factors, data and loops, none of them an entry's storage."""
    with _reuse._unshared():
        solver = tpt.GPSolver(pt, **kw)
    assert _bound(solver.fp) is None
    assert not any(_reuse._in_entry(t) for roles in _stored(solver.fp).values()
                   for t in roles.values())
    return solver


def _scale(z):
    return float(np.abs(z).max())


# -- the residual factories -----------------------------------------------------


def _models(package, name):
    return importlib.import_module(f"{package}.models.{name}")


jelliptic, jburgers, jeikonal, jdarcy = (_models("nonlinpdes_gpsolver_tpu", n) for n in
                                         ("elliptic", "burgers", "eikonal", "darcy"))
telliptic, tburgers, teikonal, tdarcy = (_models("nonlinpdes_gpsolver_tpu_torch", n) for n in
                                         ("elliptic", "burgers", "eikonal", "darcy"))

FACTORIES = [
    ("elliptic", jelliptic._elliptic_residual, telliptic._elliptic_residual, (1.0, 3),
     [(2.0, 3), (1.0, 2)]),
    ("elliptic_relaxed", jelliptic._elliptic_relaxed_residuals,
     telliptic._elliptic_relaxed_residuals, (1.0, 3, 50), [(2.0, 3, 50), (1.0, 2, 50),
                                                           (1.0, 3, 51)]),
    ("burgers", jburgers._burgers_residual, tburgers._burgers_residual, (1.0, 0.02, 50),
     [(2.0, 0.02, 50), (1.0, 0.01, 50), (1.0, 0.02, 51)]),
    ("eikonal", jeikonal._eikonal_residual, teikonal._eikonal_residual, (0.1, 50),
     [(0.2, 50), (0.1, 51)]),
    ("darcy", jdarcy._darcy_residuals, tdarcy._darcy_residuals, (50, 12), [(51, 12), (50, 13)]),
]


@pytest.mark.parametrize("name,jax_factory,port_factory,args,changed", FACTORIES,
                         ids=[c[0] for c in FACTORIES])
def test_factories_share_one_function_per_configuration(name, jax_factory, port_factory, args,
                                                        changed):
    """Each model's residual factory, in both packages, returns the same
    function objects for one configuration and others when any parameter
    changes; the port's model builds its problem from it."""
    for factory in (jax_factory, port_factory):
        assert factory(*args) is factory(*args)
        for other in changed:
            assert factory(*other) is not factory(*args)
    Xd, Xb, f, g, _ = _elliptic_arrays(30, 10, 0)
    t = [torch.as_tensor(a) for a in (Xd, Xb, f, g)]
    k = tpt.SquaredExponential(INV_SQ)
    M = tpt.models
    build = {
        "elliptic": lambda: M.nonlinear_elliptic(k, *t).blocks[0].residual,
        "elliptic_relaxed": lambda: M.nonlinear_elliptic_relaxed(k, *t).misfits[0].residual,
        "burgers": lambda: M.burgers(k, t[0], t[1], t[3]).blocks[0].residual,
        "eikonal": lambda: M.eikonal(k, *t).blocks[0].residual,
        "darcy": lambda: M.darcy_flow(k, k, t[0], t[1], t[2][:12], t[2]).misfits[0].residual,
    }[name]
    assert build() is build()


# -- one structure, two problems: the JAX package's twins -----------------------


@pytest.mark.parametrize("kind", ["elliptic", "darcy"])
def test_second_problem_binds_and_matches_jax(kind):
    """Two problems of one configuration from two numpy seeds, each through
    a JAX ``GPSolver`` and the port's (``'inverse'``, the structured step, 3
    steps at nugget 1e-8, Darcy 1e-6): the JAX package compiles its loop once for the
    pair and the port makes one entry and one loop, the second problem
    factoring into the first one's storage. Each port z is held to its own
    JAX z within 1e-7 of z's scale (``test_torch_solver.py::
    test_gn_steps_match_jax``)."""
    make = (lambda s: _elliptic(_elliptic_arrays(101, 30, s))) if kind == "elliptic" else (
        lambda s: _darcy(41, 14, s))
    nugget = 1e-8 if kind == "elliptic" else 1e-6
    before = jgn._gn_scan._cache_size()
    graphs.reset_counts()
    ptrs = []
    for seed in (10, 11):
        pj, pt, z0 = make(seed)
        zj = np.asarray(gpt.GPSolver(pj, nugget=nugget, solve_mode="inverse")
                        .solve(max_iter=3, z0=jnp.asarray(z0)).z)
        solver = tpt.GPSolver(pt, nugget=nugget, solve_mode="inverse")
        res = solver.solve(max_iter=3, z0=torch.as_tensor(z0))
        assert res.state.step_solver == "structured"
        np.testing.assert_allclose(res.z.numpy(), zj, rtol=0, atol=1e-7 * np.abs(zj).max())
        entry = _bound(solver.fp)
        ptrs.append(solver.fp.inv_factors[pt.blocks[0].name].data_ptr())
        del solver, res
    assert jgn._gn_scan._cache_size() == before + 1
    assert (graphs.ENTRIES, graphs.REBINDS, graphs.UNSHARED) == (1, 1, 0)
    assert len(entry.loops) == 1 and ptrs[0] == ptrs[1]


def test_live_solvers_never_share():
    """Three live solvers of one structure, solved alternately: the first
    two are bound to an entry each and the third is a guest of the
    layout's guest entry (``solvers/_reuse.py``), with no entry bound;
    their storage is disjoint, and each solve equals bitwise that
    problem's solve on a solver that shares nothing with any entry."""
    tpt.clear_graph_cache()
    graphs.reset_counts()
    pt = [_elliptic(_elliptic_arrays(80, 24, s))[1] for s in (1, 2, 3)]
    solvers = [tpt.GPSolver(p, nugget=1e-8, solve_mode="inverse") for p in pt]
    assert (graphs.ENTRIES, graphs.REBINDS, graphs.UNSHARED, graphs.GUESTS) == (2, 0, 0, 1)
    entries = [_bound(s.fp) for s in solvers]
    assert all(e is not None for e in entries[:2]) and len({id(e) for e in entries[:2]}) == 2
    assert entries[2] is None
    ptrs = [_storages(s.fp) for s in solvers]
    assert all(len(p) == 2 for p in ptrs)  # the factor and inverse buffer, the column scales
    assert len(set().union(*ptrs)) == 6
    zs = [solvers[i % 3].solve(max_iter=3).z for i in range(6)]
    del solvers, entries
    for i, p in enumerate(pt):
        fresh = _unshared_solver(p, nugget=1e-8, solve_mode="inverse").solve(max_iter=3).z
        assert torch.equal(zs[i], fresh) and torch.equal(zs[i + 3], fresh)


def test_a_changed_configuration_misses():
    """Changing ``alpha``, ``m``, N or a misfit weight makes another entry;
    changing ``step_size`` another loop of the same entry."""
    arrays = _elliptic_arrays(60, 20, 3)

    def made(pt):
        graphs.reset_counts()
        solver = tpt.GPSolver(pt, nugget=1e-8, solve_mode="inverse")
        solver.solve(max_iter=2)
        return (graphs.ENTRIES, graphs.REBINDS), solver

    assert made(_elliptic(arrays)[1])[0] == (1, 0)
    assert made(_elliptic(arrays)[1])[0] == (0, 1)
    for pt in (_elliptic(arrays, alpha=2.0)[1], _elliptic(arrays, m=2)[1],
               _elliptic(_elliptic_arrays(61, 20, 3))[1]):
        assert made(pt)[0] == (1, 0)
    _, solver = made(_elliptic(arrays)[1])
    solver.solve(max_iter=2, step_size=0.5)
    assert len(_bound(solver.fp).loops) == 2
    del solver
    assert made(_darcy(24, 10, 0)[1])[0] == (1, 0)
    assert made(_darcy(24, 10, 1)[1])[0] == (0, 1)
    assert made(_darcy(24, 10, 1, noise=2e-2)[1])[0] == (1, 0)


def test_structure_is_validated_once_per_key(monkeypatch):
    """``validate_slice_structure`` checks once per residual identities,
    structure, dtype and device type: a rebuilt problem of one
    configuration is not checked again, another ``alpha`` is."""
    calls = []
    real = tgn._check_slice_structure
    monkeypatch.setattr(tgn, "_check_slice_structure",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _reuse.VERDICTS.clear()
    for seed in (4, 5):
        pt = _elliptic(_elliptic_arrays(50, 16, seed))[1]
        st = tgn.gn_solve(tpt.factorize(pt, 1e-8, solve_mode="inverse"), max_iter=1)
        assert st.step_solver == "structured"
    assert len(calls) == 1
    pt = _elliptic(_elliptic_arrays(50, 16, 4), alpha=2.0)[1]
    tgn.gn_solve(tpt.factorize(pt, 1e-8, solve_mode="inverse"), max_iter=1)
    assert len(calls) == 2


def test_released_storage_is_written_again():
    """Once its owner is gone, the next factorization of the layout writes
    into the entry's storage (the same ``data_ptr``); while a tensor of the
    old factors is still held, it does not: the problem makes a new entry
    and the held tensor keeps its values."""
    tpt.clear_graph_cache()
    arrays = [_elliptic_arrays(50, 16, s) for s in (6, 7, 8)]
    graphs.reset_counts()
    fp = tpt.factorize(_elliptic(arrays[0])[1], 1e-8, solve_mode="inverse")
    ptr = fp.inv_factors["u"].data_ptr()
    del fp
    fp = tpt.factorize(_elliptic(arrays[1])[1], 1e-8, solve_mode="inverse")
    assert fp.inv_factors["u"].data_ptr() == ptr and graphs.REBINDS == 1
    kept = fp.inv_factors["u"]
    was = kept.clone()
    del fp
    fp = tpt.factorize(_elliptic(arrays[2])[1], 1e-8, solve_mode="inverse")
    assert fp.inv_factors["u"].data_ptr() != ptr
    assert (graphs.ENTRIES, graphs.REBINDS, graphs.UNSHARED) == (2, 1, 0)
    assert kept.data_ptr() == ptr and torch.equal(kept, was)


def test_factoring_into_storage_keeps_the_bits():
    """With the card's numerics (f32, the whitening operator refined by a
    Newton step), a factorization into a released entry's storage gives
    the bits and layouts of the plain sequence: the f64 Cholesky cast
    down, the triangular inverse, its Newton step, the column scales."""
    from nonlinpdes_gpsolver_tpu_torch.ops import assembly, linalg

    with tpt.ops.backend.card_numerics_on_cpu():
        p1, p2 = (tpt.models.nonlinear_elliptic(
            tpt.SquaredExponential(INV_SQ),
            *(torch.as_tensor(a, dtype=torch.float32) for a in _elliptic_arrays(70, 20, s)[:4]))
            for s in (12, 13))
        tpt.factorize(p1, 1e-5)  # made, then released
        graphs.reset_counts()
        fp = tpt.factorize(p2, 1e-5)
        assert graphs.REBINDS == 1
        b = p2.blocks[0]
        theta = assembly.gram_matrix(b.kernel, b.observables, p2.points)
        nug = assembly.adaptive_nugget_diag(theta, b.observables,
                                            assembly.observable_sizes(b.observables, p2.points),
                                            1e-5, "adaptive")
        L, d, _, _ = linalg.equilibrated_cholesky(theta, nug, 1.0)
        W = linalg.newton_refine_tri_inverse(L, linalg.tri_inverse(L)) * d[None, :]
    for got, ref in ((fp.factors["u"], L), (fp.inv_factors["u"], W), (fp.col_scales["u"], d)):
        assert torch.equal(got, ref) and got.stride() == ref.stride()


def test_mesh_woodbury_recomputes_its_deflation_basis():
    """The Darcy mesh ``'woodbury'`` loop at P = 1 computes its deflation
    basis again for a second problem of the layout: its z equals the z of a
    fresh solve of that problem on its own loop."""
    kw = dict(max_iter=2, step_solver="woodbury")
    pts = [_darcy(24, 10, s)[1] for s in (2, 3)]
    graphs.reset_counts()
    first = tpt.GPSolver(pts[0], nugget=1e-3, mesh=MESH, mesh_block=16)
    assert first.solve(**kw).state.deflation_rank > 0
    del first
    second = tpt.GPSolver(pts[1], nugget=1e-3, mesh=MESH, mesh_block=16)
    z = second.solve(**kw).z
    assert (graphs.ENTRIES, graphs.REBINDS) == (1, 1)
    del second
    tpt.clear_graph_cache()
    fresh = tpt.GPSolver(pts[1], nugget=1e-3, mesh=MESH, mesh_block=16).solve(**kw).z
    assert torch.equal(z, fresh)


@pytest.mark.parametrize("order", [(INV_SQ, ANISO), (ANISO, INV_SQ)],
                         ids=["isotropic_first", "anisotropic_first"])
def test_mesh_cg_deflates_as_each_kernel_asks(order):
    """Two elliptic problems of one layout on the mesh at P = 1, one with
    an isotropic kernel and one with an anisotropic one (kernels are in
    neither key), solved with ``'cg'``: the anisotropic one deflates, the
    isotropic one does not, and each z equals a fresh solve's."""
    kw = dict(max_iter=2, step_solver="cg")
    Xd, Xb, f, g, _ = _elliptic_arrays(60, 20, 14)
    pts = [tpt.models.nonlinear_elliptic(tpt.SquaredExponential(inv_sq),
                                         *map(torch.as_tensor, (Xd, Xb, f, g)))
           for inv_sq in order]
    tpt.clear_graph_cache()
    graphs.reset_counts()
    zs, ranks = [], []
    for pt in pts:
        st = tpt.GPSolver(pt, nugget=1e-8, mesh=MESH, mesh_block=16).solve(**kw).state
        zs.append(st.z)
        ranks.append(st.deflation_rank)
    assert (graphs.ENTRIES, graphs.REBINDS) == (1, 1)
    for pt, z, rank in zip(pts, zs, ranks):
        tpt.clear_graph_cache()
        fresh = tpt.GPSolver(pt, nugget=1e-8, mesh=MESH, mesh_block=16).solve(**kw).state
        assert rank == fresh.deflation_rank and (rank > 0) == (pt is pts[order.index(ANISO)])
        assert torch.equal(z, fresh.z)


def test_checkpoint_resumed_problem_binds(tmp_path):
    """A problem loaded from a checkpoint binds like a factorization: into
    the released entry's storage, and its solve is the saved factor's."""
    pt = _elliptic(_elliptic_arrays(50, 16, 9))[1]
    fp = tpt.factorize(pt, 1e-8, solve_mode="inverse")
    z = tgn.gn_solve(fp, max_iter=2).z
    ptr = fp.inv_factors["u"].data_ptr()
    tpt.utils.save_solver_state(tmp_path / "fp.npz", fp)
    del fp
    graphs.reset_counts()
    loaded, _ = tpt.utils.load_solver_state(tmp_path / "fp.npz", pt)
    assert graphs.REBINDS == 1 and loaded.inv_factors["u"].data_ptr() == ptr
    assert torch.equal(tgn.gn_solve(loaded, max_iter=2).z, z)


# -- a loop that keeps its last result: an entry per live problem ---------------

HELD = {
    "elliptic": (lambda s: _elliptic(_elliptic_arrays(60, 20, s)),
                 dict(nugget=1e-8, solve_mode="inverse"), dict(nugget=1e-8, solve_mode="inverse")),
    "darcy": (lambda s: _darcy(24, 10, s), dict(nugget=1e-6, solve_mode="inverse"),
              dict(nugget=1e-6, solve_mode="inverse")),
    "mesh": (lambda s: _elliptic(_elliptic_arrays(60, 20, s)),
             dict(nugget=1e-8, mesh=MESH, mesh_block=16),
             dict(nugget=1e-8, mesh=jax_mesh(1), mesh_block=16)),
}


@pytest.mark.parametrize("kind", list(HELD))
def test_held_loop_alternates_two_entries(kind):
    """``res = GPSolver(p).solve()`` over six problems of one structure,
    each result kept until the next solve returns (the dense elliptic and
    Darcy problems, and the fused mesh path at P = 1): the first two make
    entries, every later one rebinds the entry its predecessor's
    predecessor released. Each z is held to its JAX twin within 1e-7 of
    its scale and bitwise to a solve that shares nothing with any entry;
    the JAX package compiles its dense loop once for the six."""
    make, kw, jax_kw = HELD[kind]
    tpt.clear_graph_cache()
    before = jgn._gn_scan._cache_size()
    binds, res = [], None
    for k in range(6):
        pj, pt, z0 = make(30 + k)
        zj = np.asarray(gpt.GPSolver(pj, **jax_kw).solve(max_iter=3, z0=jnp.asarray(z0)).z)
        graphs.reset_counts()
        res = tpt.GPSolver(pt, **kw).solve(max_iter=3, z0=torch.as_tensor(z0))
        binds.append(_bound_as())
        np.testing.assert_allclose(res.z.numpy(), zj, rtol=0, atol=1e-7 * _scale(zj))
        ref = _unshared_solver(pt, **kw).solve(max_iter=3, z0=torch.as_tensor(z0))
        assert torch.equal(res.z, ref.z) and torch.equal(res.state.losses, ref.state.losses)
        del ref
    assert binds == [["made"], ["made"]] + [["rebound"]] * 4
    assert len(_reuse.entries()) == 2
    if kind != "mesh":  # the JAX mesh path jits its loop per call
        assert jgn._gn_scan._cache_size() == before + 1


def test_a_device_keeps_one_released_entry_of_its_last_layout(monkeypatch):
    """After a held loop, and once its last result is gone, the device
    keeps one released entry: the one bound last, of the last layout.
    ``RETAINED_BYTES`` is its storage and data (no graph pool on the CPU).
    A factorization of another layout frees it before it allocates."""
    tpt.clear_graph_cache()
    res = None
    for k in range(4):
        pt = _elliptic(_elliptic_arrays(50, 16, 40 + k))[1]
        res = tpt.GPSolver(pt, nugget=1e-8, solve_mode="inverse").solve(max_iter=2)
    live = _bound(res.posterior.fp)
    assert sorted(e.released for e in _reuse.entries()) == [False, True]
    n, data = 2 * 50 + 16, sum(v.numel() for v in pt.data.values())
    nbytes = 8 * (2 * n * n + n + data)  # the factor and inverse, the column scales, the data
    assert graphs.RETAINED_BYTES == nbytes
    del res
    assert _reuse.entries() == [live] and live.released and graphs.RETAINED_BYTES == nbytes
    released_at_alloc = []
    real = tgn.dense_storage
    monkeypatch.setattr(tgn, "dense_storage", lambda *a, **k: released_at_alloc.append(
        [e for e in _reuse.entries() if e.released]) or real(*a, **k))
    fp = tpt.factorize(_darcy(24, 10, 0)[1], 1e-6, solve_mode="inverse")
    assert released_at_alloc == [[], []]  # one allocation a block
    assert _reuse.entries() == [_bound(fp)] and graphs.RETAINED_BYTES == 0


# -- factorize(equilibrate=False) -------------------------------------------------


@pytest.mark.parametrize("solve_mode", ["trsm", "inverse"])
@pytest.mark.parametrize("nugget,scale", [(1e-6, 1.0), (7e-18, 100.0)],
                         ids=["first_attempt", "retry"])
def test_unequilibrated_factorize_matches_jax(solve_mode, nugget, scale):
    """``factorize(equilibrate=False)`` against the JAX package's (f64): a
    plain Cholesky of ``Theta + s diag(nug)``, ``s`` escalated tenfold from
    1, the same accepted ``s`` in both packages (``retry``: the first two
    attempts fail), no column scales and no quality probe; in
    ``'inverse'`` mode the triangular inverse. With a first attempt that
    holds, the factor and inverse match the JAX ones within 1e-8 of their
    scale and two Gauss-Newton steps within 1e-7 of z's; after a retry the
    factor reproduces the regularized matrix and the inverse is its
    triangular inverse."""
    pj, pt, z0 = _elliptic(_elliptic_arrays(60, 20, 0))
    fj = gpt.factorize(pj, nugget, solve_mode=solve_mode, equilibrate=False)
    ft = tpt.factorize(pt, nugget, solve_mode=solve_mode, equilibrate=False)
    assert fj.nugget_scales == ft.nugget_scales == {"u": scale}
    assert ft.rungs == {"u": round(np.log10(scale))} and ft.col_scales == {} and ft.quality == {}
    assert set(ft.inv_factors) == ({"u"} if solve_mode == "inverse" else set())
    L = ft.factors["u"]
    if scale == 1.0:
        for got, ref in [(L, fj.factors["u"])] + [(ft.inv_factors[k], fj.inv_factors[k])
                                                   for k in ft.inv_factors]:
            ref = np.asarray(ref)
            np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-8 * _scale(ref))
        zj = np.asarray(jgn.gn_solve(fj, z0=jnp.asarray(z0), max_iter=2).z)
        st = tgn.gn_solve(ft, z0=torch.as_tensor(z0), max_iter=2)
        assert st.step_solver == ("structured" if solve_mode == "inverse" else "direct")
        np.testing.assert_allclose(st.z.numpy(), zj, rtol=0, atol=1e-7 * _scale(zj))
    else:
        b = pt.blocks[0]
        theta = assembly.gram_matrix(b.kernel, b.observables, pt.points)
        nug = assembly.adaptive_nugget_diag(theta, b.observables,
                                            assembly.observable_sizes(b.observables, pt.points),
                                            nugget, "adaptive")
        reg = theta + scale * torch.diag(nug)
        assert float((L @ L.T - reg).abs().max()) <= 1e-13 * float(reg.abs().max())
        if solve_mode == "inverse":
            assert torch.equal(ft.inv_factors["u"], tpt.ops.linalg.tri_inverse(L))


def test_unequilibrated_factorize_raises_as_jax():
    """A nugget that no escalation rescues: both packages raise
    ``FloatingPointError`` with the same text."""
    pj, pt, _ = _elliptic(_elliptic_arrays(60, 20, 0))
    with pytest.raises(FloatingPointError) as ej:
        gpt.factorize(pj, 1e-30, solve_mode="trsm", equilibrate=False)
    with pytest.raises(FloatingPointError) as et:
        tpt.factorize(pt, 1e-30, solve_mode="trsm", equilibrate=False)
    assert str(et.value) == str(ej.value)


def test_unequilibrated_problem_never_binds_an_equilibrated_entry():
    """An unequilibrated factorization stores no column scales, so its
    layout is another one: it does not bind a released equilibrated entry
    of the same problem structure, and the next unequilibrated problem
    rebinds its own, bitwise an unshared solve."""
    tpt.clear_graph_cache()
    graphs.reset_counts()
    pts = [_elliptic(_elliptic_arrays(50, 16, s))[1] for s in (60, 61, 62)]
    fp = tpt.factorize(pts[0], 1e-6, solve_mode="inverse")
    equilibrated = _bound(fp)
    del fp
    fu = tpt.factorize(pts[1], 1e-6, solve_mode="inverse", equilibrate=False)
    assert (graphs.ENTRIES, graphs.REBINDS) == (2, 0)
    assert _bound(fu).key != equilibrated.key
    assert equilibrated not in _reuse.entries() and equilibrated.tensors is None  # freed
    assert all("d" not in roles for roles in _bound(fu).tensors.values())
    del fu
    fu = tpt.factorize(pts[2], 1e-6, solve_mode="inverse", equilibrate=False)
    assert (graphs.ENTRIES, graphs.REBINDS) == (2, 1)
    z = tgn.gn_solve(fu, max_iter=2).z
    with _reuse._unshared():
        ref = tpt.factorize(pts[2], 1e-6, solve_mode="inverse", equilibrate=False)
    assert not any(_reuse._in_entry(t) for roles in _stored(ref).values() for t in roles.values())
    assert torch.equal(z, tgn.gn_solve(ref, max_iter=2).z)


# -- the two-pass mesh factorization ----------------------------------------------


def test_two_pass_mesh_problem_rebinds_and_matches_jax():
    """Two problems factored by the mesh path's two-pass factorization at
    P = 1, the first released before the second: the second writes into the
    first one's storage and binds its entry. Each z (3 steps) matches the
    JAX package's two-pass solve within 1e-7 of its scale and, bitwise, an
    unshared two-pass solve."""
    tpt.clear_graph_cache()
    graphs.reset_counts()
    kw = dict(nugget=1e-8, block=16, fused=False)
    ptrs = []
    for seed in (50, 51):
        pj, pt, z0 = _elliptic(_elliptic_arrays(60, 20, seed))
        jfp = jdist.factorize_distributed(pj, jax_mesh(1), **kw)
        zj = np.asarray(jdist.gn_solve_distributed(jfp, z0=jnp.asarray(z0), max_iter=3).z)
        dfp = tdist.factorize_distributed(pt, MESH, **kw)
        ptrs.append(_storages(dfp))
        z = tdist.gn_solve_distributed(dfp, z0=torch.as_tensor(z0), max_iter=3).z
        np.testing.assert_allclose(z.numpy(), zj, rtol=0, atol=1e-7 * _scale(zj))
        with _reuse._unshared():
            ref = tdist.factorize_distributed(pt, MESH, **kw)
        assert not _storages(ref) & ptrs[-1]
        assert torch.equal(z, tdist.gn_solve_distributed(ref, z0=torch.as_tensor(z0),
                                                         max_iter=3).z)
        del dfp, ref
    assert (graphs.ENTRIES, graphs.REBINDS, graphs.UNSHARED) == (1, 1, 2)
    assert ptrs[0] == ptrs[1]
