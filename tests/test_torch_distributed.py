"""The port's mesh-path Gauss-Newton, posterior and interop against the JAX
package's mesh path on a one-device mesh and against the port's dense
path (f64, CPU, the same numpy inputs), and the port twins of
``tests/test_distributed_solver.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinpdes_gpsolver_tpu as gpt
from nonlinpdes_gpsolver_tpu.parallel.mesh import make_mesh as jax_mesh
from nonlinpdes_gpsolver_tpu.solvers import distributed as jdist

import nonlinpdes_gpsolver_tpu_torch as tpt
from nonlinpdes_gpsolver_tpu_torch.parallel import make_mesh
from nonlinpdes_gpsolver_tpu_torch.solvers import distributed as tdist
from nonlinpdes_gpsolver_tpu_torch.solvers import gn as tgn
from test_torch_krylov import small_darcy
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_time_limit import limited, time_limit  # noqa: F401  (autouse fixture)

MESH = make_mesh(1, device="cpu")
# 16-row blocks and 32-column superblocks: several superblocks per factor
FACTOR_KW = dict(block=16, superblock_cols=32)
NUGGET = {"elliptic": 1e-8, "darcy": 1e-4}


def elliptic_pair(n_dom=80, n_bdy=24, seed=0, kernel=(0.3,)):
    """(JAX problem, port problem) of the elliptic equation on the same
    numpy points, u = sin(pi x) sin(pi y), both from z0 = 0 (from a random
    start the first step more than doubles the loss and the mesh path's
    damped update halves it, where the dense loop, fault R3, does not)."""
    rng = np.random.default_rng(seed)
    Xd, Xb = rng.uniform(0, 1, (n_dom, 2)), rng.uniform(0, 1, (n_bdy, 2))
    u = lambda X: np.sin(np.pi * X[:, 0]) * np.sin(np.pi * X[:, 1])  # noqa: E731
    f = 2 * np.pi**2 * u(Xd) + u(Xd) ** 3
    if len(kernel) == 1:
        kj, kt = gpt.SquaredExponential.gaussian(kernel[0]), tpt.SquaredExponential.gaussian(kernel[0])
    else:
        kj = gpt.SquaredExponential.anisotropic(kernel)
        kt = tpt.SquaredExponential.anisotropic(kernel)
    pj = gpt.models.nonlinear_elliptic(kj, jnp.asarray(Xd), jnp.asarray(Xb), jnp.asarray(f),
                                       jnp.asarray(u(Xb)), init="zero")
    pt = tpt.models.nonlinear_elliptic(kt, *map(torch.as_tensor, (Xd, Xb, f, u(Xb))), init="zero")
    return pj, pt


PROBLEMS = {"elliptic": elliptic_pair, "darcy": small_darcy}
# the Krylov steps to tight tolerances; 'cg' on the Darcy problem with the
# spectral deflation, as the JAX package offers it (deflation_rank)
STEP_KW = {
    ("elliptic", "cg"): {},
    ("darcy", "cg"): dict(cg_tol=1e-9, cg_maxiter=2000, deflation_rank=72),
    ("darcy", "woodbury"): dict(cg_tol=1e-9, cg_maxiter=2000),
}
CASES = [("elliptic", s) for s in ("structured", "direct", "cg", "normal")] + [
    ("darcy", s) for s in ("structured", "direct", "cg", "woodbury", "normal")]


@pytest.fixture(scope="module")
def factored():
    """Per problem: (JAX problem, port problem, JAX mesh factorization,
    port mesh factorization, port dense 'direct' reference state)."""
    out = {}
    with limited("the factored fixture"):
        for name, build in PROBLEMS.items():
            pj, pt = build()
            nug = NUGGET[name]
            jfp = jdist.factorize_distributed(pj, jax_mesh(1), nugget=nug, **FACTOR_KW)
            tfp = tdist.factorize_distributed(pt, MESH, nugget=nug, **FACTOR_KW)
            ref = tpt.gn_solve(tpt.factorize(pt, nug, solve_mode="trsm"), max_iter=3,
                               step_solver="direct")
            out[name] = (pj, pt, jfp, tfp, ref)
    return out


@pytest.mark.parametrize("name,solver", CASES)
def test_step_solvers_match_jax_mesh_and_dense_direct(factored, name, solver):
    """3 GN steps of each step solver: z within 1e-7 of its scale of the JAX
    package's mesh path (the same algorithm; the factorizations round alike
    but not bitwise, and the Krylov steps' inner solves stop at their
    tolerance, the deflation bases being drawn by different generators),
    the losses to rtol 1e-6; and within 1e-6 of the port's dense
    ``'direct'`` step."""
    pj, pt, jfp, tfp, ref = factored[name]
    kw = STEP_KW.get((name, solver), {})
    sj = jdist.gn_solve_distributed(jfp, max_iter=3, step_solver=solver, **kw)
    st = tdist.gn_solve_distributed(tfp, max_iter=3, step_solver=solver, **kw)
    zj = np.asarray(sj.z)
    np.testing.assert_allclose(st.z.numpy(), zj, rtol=0, atol=1e-7 * np.abs(zj).max())
    np.testing.assert_allclose(st.losses.numpy(), np.asarray(sj.losses), rtol=1e-6)
    assert bool(st.converged_finite)
    zd = ref.z.numpy()
    np.testing.assert_allclose(st.z.numpy(), zd, rtol=0, atol=1e-6 * np.abs(zd).max())
    iters = st.cg_iters.numpy()
    if solver in ("cg", "woodbury"):
        assert np.all((iters > 0) & (iters < 2000))
    else:
        assert not iters.any()


@pytest.mark.parametrize("name", ["elliptic", "darcy"])
def test_structured_matches_direct_and_auto(factored, name):
    """The structured panel (raw columns from per-slice diagonals) against
    the full jacfwd panel, 1e-9 (tests/test_distributed_solver.py:167 and
    :192); 'auto' picks it below the panel cap."""
    _, _, _, tfp, _ = factored[name]
    s = tdist.gn_solve_distributed(tfp, max_iter=3, step_solver="structured")
    d = tdist.gn_solve_distributed(tfp, max_iter=3, step_solver="direct")
    torch.testing.assert_close(s.z, d.z, rtol=0, atol=1e-9)
    a = tdist.gn_solve_distributed(tfp, max_iter=3)
    assert torch.equal(a.z, s.z)
    assert (a.step_solver, a.deflation_rank) == ("structured", 0)


def test_woodbury_matches_normal_darcy(factored):
    """The woodbury step (deflated batched CG + rank-K correction) tracks
    the exact normal step: losses to rtol 1e-5, z to 1e-5 of its scale; its
    inner iterations show, the exact step's are zero (:628)."""
    _, _, _, tfp, _ = factored["darcy"]
    norm = tdist.gn_solve_distributed(tfp, max_iter=3, step_solver="normal")
    wood = tdist.gn_solve_distributed(tfp, max_iter=3, step_solver="woodbury", cg_tol=1e-9,
                                      cg_maxiter=2000)
    np.testing.assert_allclose(wood.losses.numpy(), norm.losses.numpy(), rtol=1e-5)
    assert float((wood.z - norm.z).abs().max() / norm.z.abs().max()) < 1e-5
    assert wood.cg_iters.shape == (3,) and bool(((wood.cg_iters > 0) & (wood.cg_iters < 2000)).all())
    assert not norm.cg_iters.any()


def test_auto_past_the_panel_cap_takes_woodbury(factored):
    """Past the panel cap 'auto' routes the isotropic Darcy problem to
    woodbury, which at a tight inner tolerance reproduces the exact normal
    step to 1e-5 (:459)."""
    _, _, _, tfp, _ = factored["darcy"]
    assert tdist.route_step_solver(tfp, "auto", direct_panel_limit=8)[0] == "woodbury"
    auto = tdist.gn_solve_distributed(tfp, max_iter=3, direct_panel_limit=8, cg_tol=1e-11,
                                      cg_maxiter=4000)
    norm = tdist.gn_solve_distributed(tfp, max_iter=3, step_solver="normal")
    assert auto.cg_iters[0] > 0
    assert auto.step_solver == "woodbury"
    assert auto.deflation_rank == tdist.default_deflation_rank(tfp.problem.latent_dim)
    assert float((auto.z - norm.z).abs().max() / norm.z.abs().max()) < 1e-5


def test_cg_with_misfit_jacobi_preconditioner_makes_progress(factored):
    """Plain CG (no deflation) on the misfit-coupled problem, Jacobi
    preconditioned by the misfits' exact diagonal, within the default cap:
    finite losses, down tenfold (:515)."""
    _, _, _, tfp, _ = factored["darcy"]
    st = tdist.gn_solve_distributed(tfp, max_iter=3, step_solver="cg")
    losses = st.losses.numpy()
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0] / 10


def test_auto_routes_every_step_solver(factored):
    """'auto' on every route (:654): structured below the cap; direct where
    the slice structure fails; past the cap cg without misfits, woodbury
    with them (also past the 'normal' budget), normal for an anisotropic
    kernel within its budget; the budget on the CPU is 10 GiB."""
    _, pt, _, tfp, _ = factored["elliptic"]
    _, _, _, dfp, _ = factored["darcy"]
    route = lambda fp, **kw: tdist.route_step_solver(fp, "auto", **kw)[0]  # noqa: E731
    assert route(tfp) == "structured"
    assert route(tfp, direct_panel_limit=1) == "cg"
    assert route(dfp, direct_panel_limit=1, normal_budget_bytes=0) == "woodbury"
    assert tdist._auto_normal_budget(tfp) == 10 << 30
    _, aniso = elliptic_pair(40, 16, kernel=(0.3, 0.2))
    afp = tdist.factorize_distributed(aniso, MESH, nugget=1e-8, **FACTOR_KW)
    assert route(afp, direct_panel_limit=1, normal_budget_bytes=10**12) == "normal"
    assert route(afp, direct_panel_limit=1, normal_budget_bytes=0) == "cg"
    blk = pt.blocks[0]
    flipped = tpt.models.spec.CollocationProblem(
        "flipped", (tpt.models.spec.GPBlock("u", blk.kernel, blk.observables,
                                            lambda z, d: blk.residual(z.flip(0), d)),),
        pt.points, pt.data, pt.latent_dim)
    ffp = tdist.factorize_distributed(flipped, MESH, nugget=1e-8, **FACTOR_KW)
    assert route(ffp) == "direct"
    with pytest.raises(ValueError, match="structure"):
        tdist.gn_solve_distributed(ffp, step_solver="normal")
    with pytest.raises(ValueError, match="misfit"):
        tdist.gn_solve_distributed(tfp, step_solver="woodbury")
    st = tdist.gn_solve_distributed(dfp, max_iter=3, direct_panel_limit=1, normal_budget_bytes=0,
                                    cg_tol=1e-9, cg_maxiter=2000)
    assert st.cg_iters[0] > 0 and st.losses[-1] < st.losses[0] / 10
    assert st.step_solver == "woodbury"


def test_tol_plateau(factored):
    """tol=0 reproduces the fixed run exactly; a generous tol stops early
    and pads the history with the last loss; the facade passes it on."""
    _, pt, _, tfp, _ = factored["elliptic"]
    fixed = tdist.gn_solve_distributed(tfp, max_iter=4, step_solver="direct")
    zero = tdist.gn_solve_distributed(tfp, max_iter=4, step_solver="direct", tol=0.0)
    assert torch.equal(fixed.z, zero.z) and torch.equal(fixed.losses, zero.losses)
    st = tdist.gn_solve_distributed(tfp, max_iter=8, tol=0.2)
    losses = st.losses.numpy()
    assert losses.shape == (8,) and losses[-1] == losses[-2] == losses[-3]
    assert st.cg_iters.tolist()[-1] == 0
    res = tpt.GPSolver(pt, nugget=1e-8, mesh=MESH, mesh_block=16).solve(max_iter=8, tol=0.2)
    assert res.losses[-1] == res.losses[-2]


def test_capacitance_jitter_is_the_dense_rule(factored, monkeypatch):
    """Fault R4: the JAX package's mesh woodbury passes jitter 0.0 to its
    capacitance solve, its dense one ``hessian_jitter``. The port's mesh
    step passes ``hessian_jitter``, as its dense step does."""
    _, pt, _, tfp, _ = factored["darcy"]
    seen = {}

    def spy(where, real):
        def f(X, U, w, jitter):
            seen[where] = jitter
            return real(X, U, w, jitter)
        return f

    monkeypatch.setattr(tdist, "_woodbury_correct", spy("mesh", tdist._woodbury_correct))
    monkeypatch.setattr(tgn, "_woodbury_correct", spy("dense", tgn._woodbury_correct))
    kw = dict(max_iter=1, step_solver="woodbury", hessian_jitter=1e-3, cg_maxiter=50)
    tdist.gn_solve_distributed(tfp, **kw)
    tpt.gn_solve(tpt.factorize(pt, NUGGET["darcy"], solve_mode="trsm"), **kw)
    assert seen == {"mesh": 1e-3, "dense": 1e-3}


def test_posterior_matches_jax_and_dense(factored, monkeypatch):
    """Weights, the extension and the variance at one solution z*, against
    the JAX package's DistributedPosterior and the port's dense Posterior;
    row-chunked equals one panel. The variance's prior term is the
    unregularized kappa(x, x) = 1 (fault R5, the value the JAX package
    computes)."""
    from nonlinpdes_gpsolver_tpu_torch.solvers import posterior

    pj, pt, jfp, tfp, ref = factored["elliptic"]
    z = ref.z
    jpost = jdist.DistributedPosterior(jfp, jnp.asarray(z.numpy()))
    tpost = tdist.DistributedPosterior(tfp, z)
    dense = tpt.Posterior(tpt.factorize(pt, NUGGET["elliptic"], solve_mode="trsm"), z)
    Xt = gpt.utils.test_grid(13, 11)
    Xtt = torch.as_tensor(np.array(Xt))
    w = np.asarray(jpost._weights["u"])
    np.testing.assert_allclose(tpost.weights("u").numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max())
    ext, var = tpost.extend(Xtt), tpost.variance(Xtt)
    e_ref = np.asarray(jpost.extend(Xt))
    np.testing.assert_allclose(ext.numpy(), e_ref, rtol=0, atol=1e-8 * np.abs(e_ref).max())
    np.testing.assert_allclose(var.numpy(), np.asarray(jpost.variance(Xt)), rtol=0, atol=1e-9)
    torch.testing.assert_close(ext, dense.extend(Xtt), rtol=0, atol=1e-7 * float(ext.abs().max()))
    torch.testing.assert_close(var, dense.variance(Xtt), rtol=0, atol=1e-9)
    V = tfp.whiten("u", tpt.ops.cross_gram(tfp.problem.blocks[0].kernel, tpt.ops.identity(), Xtt,
                                           tfp.problem.blocks[0].observables, tfp.problem.points).T)
    torch.testing.assert_close(var, torch.clamp(1.0 - (V * V).sum(0), min=0.0), rtol=0, atol=1e-12)
    monkeypatch.setattr(posterior, "_serving_chunk", lambda rows, n, budget=0: 7)
    torch.testing.assert_close(tpost.extend(Xtt), ext, rtol=0, atol=1e-12)
    torch.testing.assert_close(tpost.variance(Xtt), var, rtol=0, atol=1e-12)
    torch.testing.assert_close(tpost.std(Xtt), torch.sqrt(var), rtol=0, atol=1e-12)


@pytest.mark.parametrize("n_devices", [1, 4])
def test_jax_factor_carries_across(factored, n_devices):
    """A JAX-computed mesh factor (on a 1- or 4-device mesh, block-cyclic
    order) carried into the port gives the JAX package's whitened residual
    (1e-12) and its first GN step (z within 1e-9 of its scale)."""
    pj, pt, _, _, _ = factored["elliptic"]
    jfp = jdist.factorize_distributed(pj, jax_mesh(n_devices), nugget=NUGGET["elliptic"],
                                      block=16)
    jf = jfp.factors["u"]
    fac, d = tpt.interop.factor_from_numpy(
        np.asarray(jf.local), np.asarray(jf.diag_inv), jf.block, jf.n, jf.n_pad,
        np.asarray(jfp.col_scales["u"]), n_devices=n_devices, mesh=MESH)
    fp = tdist.DistributedFactoredProblem(pt, {"u": fac}, {"u": d}, {"u": 1.0}, {"u": 0},
                                          {"u": 0.0}, {"u": {}})
    z0 = np.random.default_rng(3).standard_normal(pt.latent_dim)
    r_ref = np.asarray(jfp.whitened_residual(jnp.asarray(z0)))
    r = fp.whitened_residual(torch.as_tensor(z0)).numpy()
    np.testing.assert_allclose(r, r_ref, rtol=0, atol=1e-12 * np.abs(r_ref).max())
    sj = jdist.gn_solve_distributed(jfp, max_iter=1, step_solver="direct")
    st = tdist.gn_solve_distributed(fp, max_iter=1, step_solver="direct")
    zj = np.asarray(sj.z)
    np.testing.assert_allclose(st.z.numpy(), zj, rtol=0, atol=1e-9 * np.abs(zj).max())


def test_direct_step_traces_the_residual_once(monkeypatch):
    """Fault P4: the mesh path's ``'direct'`` step at P = 1 takes its
    Jacobian by one ``vmap`` of ``jvp`` over the basis, not by
    ``torch.func.linearize``, which retraced the residual on every call (3
    steps took 0.27-0.53 s on the card against 0.010-0.018 s). With
    ``linearize`` raising, 3 steps call the block residual 3 times a step
    (the residual, the batched JVP, the damped update's loss), after 4
    calls to set up (the slice structure, its validation, the first loss)."""
    import dataclasses

    _, pt = elliptic_pair()
    calls = [0]
    b = pt.blocks[0]

    def counted(z, data, _r=b.residual):
        calls[0] += 1
        return _r(z, data)

    pt = dataclasses.replace(pt, blocks=(dataclasses.replace(b, residual=counted),))
    dfp = tdist.factorize_distributed(pt, MESH, nugget=NUGGET["elliptic"], **FACTOR_KW)
    step_starts = []
    panel_delta = tdist._panel_delta

    def marked(*args, **kw):
        step_starts.append(calls[0])
        return panel_delta(*args, **kw)

    def no_linearize(*args, **kw):
        raise AssertionError("the 'direct' step called torch.func.linearize")

    monkeypatch.setattr(tdist, "_panel_delta", marked)
    monkeypatch.setattr(torch.func, "linearize", no_linearize)
    calls[0] = 0
    st = tdist.gn_solve_distributed(dfp, max_iter=3, step_solver="direct")
    assert st.step_solver == "direct" and bool(st.converged_finite)
    assert step_starts == [4, 7, 10] and calls[0] == 13
