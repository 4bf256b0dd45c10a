"""The port's Krylov Gauss-Newton steps (``'cg'`` and ``'woodbury'``) against
the JAX package and against the port's exact steps (f64, CPU, same numpy
inputs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinpdes_gpsolver_tpu as gpt
from nonlinpdes_gpsolver_tpu.solvers import gn as jgn

import nonlinpdes_gpsolver_tpu_torch as tpt
from nonlinpdes_gpsolver_tpu_torch.solvers import gn as tgn
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)


def test_batched_cg_and_woodbury_algebra():
    """Random SPD H0 plus a heavily weighted rank-K term (the misfit
    structure): batched CG at a tight tolerance plus the capacitance
    correction reproduces the dense solve of the full H, and a warm restart
    from the solution takes no iteration (the algebra of the JAX package's
    test_batched_cg_and_woodbury_algebra)."""
    rng = np.random.default_rng(0)
    m, K = 200, 9
    A = rng.standard_normal((m, m))
    H0 = A @ A.T + m * np.eye(m)
    U = rng.standard_normal((m, K))
    w = np.full(K, 1e6)
    g = rng.standard_normal(m)
    x_exact = np.linalg.solve(H0 + U @ np.diag(w) @ U.T, g)
    H0t, Ut = torch.as_tensor(H0), torch.as_tensor(U)
    R = torch.cat([torch.as_tensor(g)[:, None], Ut], dim=1)
    X, it = tgn._batched_cg(lambda V: H0t @ V, R, 1e-12, 5000)
    delta = tgn._woodbury_correct(X, Ut, torch.as_tensor(w), 0.0)
    assert np.linalg.norm(delta.numpy() - x_exact) / np.linalg.norm(x_exact) < 1e-8
    Xj, it_j = jgn._batched_cg(lambda V: jnp.asarray(H0) @ V, jnp.asarray(R.numpy()), 1e-12, 5000)
    assert 0 < it < 5000 and abs(it - int(it_j)) <= 2
    _, it2 = tgn._batched_cg(lambda V: H0t @ V, R, 1e-12, 5000, X0=X)
    assert it2 == 0


def _elliptic_pair(n_dom=60, n_bdy=24, seed=0):
    rng = np.random.default_rng(seed)
    Xd, Xb = rng.uniform(0, 1, (n_dom, 2)), rng.uniform(0, 1, (n_bdy, 2))
    u = lambda X: np.sin(np.pi * X[:, 0]) * np.sin(np.pi * X[:, 1])  # noqa: E731
    f = 2 * np.pi**2 * u(Xd) + u(Xd) ** 3
    z0 = rng.standard_normal(n_dom)
    kj, kt = gpt.SquaredExponential.gaussian(0.3), tpt.SquaredExponential.gaussian(0.3)
    pj = gpt.models.nonlinear_elliptic(kj, jnp.asarray(Xd), jnp.asarray(Xb), jnp.asarray(f),
                                       jnp.asarray(u(Xb)))
    pt = tpt.models.nonlinear_elliptic(kt, *map(torch.as_tensor, (Xd, Xb, f, u(Xb))))
    return pj, pt, z0


def _eikonal_pair(n_dom=60, n_bdy=24, seed=1):
    rng = np.random.default_rng(seed)
    Xd, Xb = rng.uniform(0, 1, (n_dom, 2)), rng.uniform(0, 1, (n_bdy, 2))
    f, g = np.ones(n_dom), np.zeros(n_bdy)
    kj, kt = gpt.SquaredExponential.gaussian(0.2), tpt.SquaredExponential.gaussian(0.2)
    pj = gpt.models.eikonal(kj, jnp.asarray(Xd), jnp.asarray(Xb), jnp.asarray(f), jnp.asarray(g))
    pt = tpt.models.eikonal(kt, *map(torch.as_tensor, (Xd, Xb, f, g)))
    return pj, pt, np.zeros(3 * n_dom)


# The JAX package's woodbury tests run the small Darcy at nugget 1e-4; the
# port's tests that are not parity checks run it at 1e-3, a third of the CG
# iterations (the port's eager CG costs milliseconds an iteration here).
JAX_DARCY_NUGGET = 1e-4
DARCY_NUGGET = 1e-3


def small_darcy():
    """The JAX package's small Darcy fixture (tests/test_distributed_solver.py):
    48/16 points from PRNGKey(2), sigma 0.4, 12 observations on
    linspace(0, 0.01), noise 1e-2, the seed-3 latent: (JAX problem, port
    problem)."""
    Xd, Xb = gpt.utils.sample_random(jax.random.PRNGKey(2), 48, 16)
    k = gpt.SquaredExponential.gaussian(0.4)
    obs = jnp.linspace(0.0, 0.01, 12)
    pj = gpt.models.darcy_flow(k, k, Xd, Xb, obs, rhs_f=lambda x: 1.0, noise_level=1e-2, seed=3)
    pt = tpt.interop.darcy_from_numpy(
        np.asarray(Xd), np.asarray(Xb), np.asarray(pj.data["f"]), np.asarray(pj.data["g"]),
        np.asarray(obs), np.asarray(pj.init_latent()), k.inv_sq, noise_level=1e-2, device="cpu",
    )
    return pj, pt


@pytest.mark.parametrize("pair", [_elliptic_pair, _eikonal_pair])
def test_cg_matches_jax(pair):
    """3 'cg' steps from the same z0 at nugget 1e-4 and cg_tol 1e-12: the
    two CG runs round differently, and each converges to the tolerance (in
    under 500 iterations at this nugget), so z agrees to 1e-7 of its scale
    and the losses to rtol 1e-7. The inner iteration counts agree to 5%:
    near convergence they move with the summation order (measured: up to 9
    of 453 between one and eight BLAS threads)."""
    pj, pt, z0 = pair()
    sj = gpt.gn_solve(gpt.factorize(pj, 1e-4), z0=jnp.asarray(z0), max_iter=3,
                      step_solver="cg", cg_tol=1e-12)
    st = tpt.gn_solve(tpt.factorize(pt, 1e-4), z0=torch.as_tensor(z0), max_iter=3,
                      step_solver="cg", cg_tol=1e-12)
    ref = np.asarray(sj.z)
    np.testing.assert_allclose(st.z.numpy(), ref, rtol=0, atol=1e-7 * np.abs(ref).max())
    np.testing.assert_allclose(st.losses.numpy(), np.asarray(sj.losses), rtol=1e-7)
    iters = st.cg_iters.numpy()
    assert np.all((iters > 0) & (iters < 500))
    assert np.all(np.abs(iters - np.asarray(sj.cg_iters)) <= 0.05 * iters), (iters, sj.cg_iters)


def test_woodbury_matches_jax_darcy():
    """2 'woodbury' steps on the small Darcy (trsm), nugget 1e-4, cg_tol
    1e-9, cg_maxiter 2000, as the JAX package's own woodbury tests run it:
    the loss trajectory to rtol 1e-6 and z to 1e-6 of its scale (each inner
    CG stops at 1e-9, and the capacitance correction amplifies the inner
    solves' differences); the JAX package's 'direct' step is within 1e-5 of
    both."""
    pj, pt = small_darcy()
    kw = dict(max_iter=2, step_solver="woodbury", cg_tol=1e-9, cg_maxiter=2000)
    fj = gpt.factorize(pj, JAX_DARCY_NUGGET, solve_mode="trsm")
    sj = gpt.gn_solve(fj, **kw)
    st = tpt.gn_solve(tpt.factorize(pt, JAX_DARCY_NUGGET, solve_mode="trsm"), **kw)
    ref = np.asarray(sj.z)
    np.testing.assert_allclose(st.z.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    np.testing.assert_allclose(st.losses.numpy(), np.asarray(sj.losses), rtol=1e-6)
    iters = st.cg_iters.numpy()
    assert np.all((iters > 0) & (iters < 2000))
    direct = np.asarray(gpt.gn_solve(fj, max_iter=2, step_solver="direct").z)
    assert np.abs(st.z.numpy() - direct).max() < 1e-5 * np.abs(direct).max()


def test_cg_with_misfit_matches_direct():
    """Fault R1: the JAX package's dense 'cg' step crashes on any problem
    with a misfit (its Jacobi preconditioner broadcasts an (m, 1) panel to
    (m, m)). The port's preconditioner divides column by column; its 'cg'
    step on the small Darcy, at the JAX tests' nugget 1e-4, tracks the
    port's 'direct' step."""
    _, pt = small_darcy()
    fp = tpt.factorize(pt, JAX_DARCY_NUGGET, solve_mode="trsm")
    sd = tpt.gn_solve(fp, max_iter=2, step_solver="direct")
    sc = tpt.gn_solve(fp, max_iter=2, step_solver="cg", cg_tol=1e-9, cg_maxiter=2000)
    np.testing.assert_allclose(sc.losses.numpy(), sd.losses.numpy(), rtol=1e-5)
    assert float((sc.z - sd.z).abs().max() / sd.z.abs().max()) < 1e-5
    assert np.all((sc.cg_iters.numpy() > 0) & (sc.cg_iters.numpy() < 2000))
    M = tgn._misfit_jacobi_precond(pt, pt.init_latent())
    V = torch.ones((pt.latent_dim, 1), dtype=torch.float64)
    assert M(V).shape == (pt.latent_dim, 1)


def test_cg_maxiter_cap_shows_in_cg_iters():
    """A capped inner solve is visible: every step reports cg_maxiter; the
    exact steps report zeros, and so do iterations a tol stop left untaken."""
    _, pt, z0 = _elliptic_pair(40, 16)
    fp = tpt.factorize(pt, 1e-10)
    st = tpt.gn_solve(fp, z0=torch.as_tensor(z0), max_iter=2, step_solver="cg",
                      cg_tol=1e-30, cg_maxiter=7)
    assert st.cg_iters.tolist() == [7, 7] and st.cg_iters.dtype == torch.int64
    assert tpt.gn_solve(fp, max_iter=2, step_solver="direct").cg_iters.tolist() == [0, 0]
    st = tpt.gn_solve(fp, max_iter=12, step_solver="cg", tol=1e-3)
    iters = st.cg_iters.numpy()
    assert iters[-1] == 0 and np.all(iters[: np.argmin(iters)] > 0)


def test_woodbury_needs_a_misfit_and_is_reached_through_the_facade():
    _, pt, _ = _elliptic_pair(30, 12)
    fp = tpt.factorize(pt, 1e-8)
    with pytest.raises(ValueError, match="misfit"):
        tpt.gn_solve(fp, step_solver="woodbury")
    _, darcy = small_darcy()
    res = tpt.GPSolver(darcy, nugget=DARCY_NUGGET, solve_mode="trsm").solve(max_iter=1,
                                                                  step_solver="woodbury")
    assert res.state.cg_iters.tolist()[0] > 0


def test_woodbury_warm_start_keeps_the_steps():
    """The inner solves warm-started from the previous GN step's solutions
    (the mesh path's carry) reach the same second step to the CG
    tolerance as from zero."""
    _, pt = small_darcy()
    fp = tpt.factorize(pt, DARCY_NUGGET, solve_mode="trsm")
    kw = dict(cg_tol=1e-9, cg_maxiter=2000)
    z = pt.init_latent()
    step, _, X = tgn._delta_woodbury(fp, z, 0.0, **kw)
    z = z - step
    cold, it_cold, _ = tgn._delta_woodbury(fp, z, 0.0, **kw)
    warm, it_warm, _ = tgn._delta_woodbury(fp, z, 0.0, X0=X, **kw)
    assert 0 < it_warm < 2000 and 0 < it_cold < 2000
    assert float((warm - cold).abs().max() / cold.abs().max()) < 1e-6
