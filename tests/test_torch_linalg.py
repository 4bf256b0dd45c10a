"""The port's guarded factorizations and SPD solves against the JAX package
(f64, CPU, same numpy inputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinpdes_gpsolver_tpu as gpt
from nonlinpdes_gpsolver_tpu.ops import linalg as jl
from nonlinpdes_gpsolver_tpu.solvers.gn import _equilibrated_cholesky

import nonlinpdes_gpsolver_tpu_torch as tpt
from nonlinpdes_gpsolver_tpu_torch.ops import linalg as tl
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)

N_DOM, N_BDY = 60, 20


def _observables(pkg):
    return (
        pkg.Observable("domain", pkg.laplacian()),
        pkg.Observable("domain", pkg.identity()),
        pkg.Observable("boundary", pkg.identity()),
    )


@pytest.fixture(scope="module")
def gram():
    """An elliptic Gram matrix and its adaptive nugget diagonal (1e-8)."""
    rng = np.random.default_rng(0)
    pts = {
        "domain": jnp.asarray(rng.uniform(0, 1, (N_DOM, 2))),
        "boundary": jnp.asarray(rng.uniform(0, 1, (N_BDY, 2))),
    }
    obs = _observables(gpt.ops)
    theta = gpt.ops.gram_matrix(gpt.SquaredExponential.gaussian(0.2), obs, pts)
    nug = gpt.ops.adaptive_nugget_diag(theta, obs, (N_DOM, N_DOM, N_BDY), 1e-8)
    return np.asarray(theta), np.asarray(nug)


def _t(a):
    return torch.as_tensor(np.array(a))


def test_equilibrated_factor_matches_jax(gram):
    """Same d^{-1/2} exactly; the factors come from two different Cholesky
    implementations, whose rounding differs by ~cond(L) eps (cond 4e4 here):
    1e-8 absolute on a unit-diagonal factor."""
    theta, nug = gram
    L, d_isqrt, s, ok = _equilibrated_cholesky(jnp.asarray(theta), jnp.asarray(nug), 1.0, False)
    Lt, dt, st, rungs = tl.equilibrated_cholesky(_t(theta), _t(nug), 1.0)
    assert bool(ok) and st == float(s) == 1.0 and rungs == 0
    np.testing.assert_array_equal(dt.numpy(), np.asarray(d_isqrt))
    np.testing.assert_allclose(Lt.numpy(), np.asarray(L), rtol=0, atol=1e-8)


def test_escalation_rungs_match_jax():
    """A matrix with one eigenvalue at -3e-6 and a 1e-9 nugget: both packages
    escalate tenfold until the nugget covers it, to the same scale."""
    rng = np.random.default_rng(1)
    Q, _ = np.linalg.qr(rng.standard_normal((30, 30)))
    ev = np.linspace(1.0, 2.0, 30)
    ev[0] = -3e-6
    M = (Q * ev) @ Q.T
    nug = np.full(30, 1e-9)
    _, _, s, ok = _equilibrated_cholesky(jnp.asarray(M), jnp.asarray(nug), 1.0, False)
    Lt, _, st, rungs = tl.equilibrated_cholesky(_t(M), _t(nug), 1.0)
    assert bool(ok) and st == float(s) == 1e4 and rungs == 4
    assert torch.isfinite(Lt).all()
    with pytest.raises(FloatingPointError):
        tl.equilibrated_cholesky(_t(M), _t(np.full(30, 1e-20)), 1.0)


def test_f32_matrix_is_factored_in_f64(gram):
    """An f32 Gram matrix is equilibrated in f32 and factored in f64; the
    factor comes back as the f32 rounding of that f64 factor, bit for bit.
    (The 1e-8 nugget is below f32 rounding, so the f32 matrix escalates.)"""
    theta, nug = gram
    th32, nug32 = _t(theta).float(), _t(nug).float()
    L, d_isqrt, s, rungs = tl.equilibrated_cholesky(th32, nug32, 1.0)
    assert L.dtype == d_isqrt.dtype == torch.float32 and s == 10.0**rungs
    assert torch.equal(d_isqrt, torch.rsqrt(torch.diagonal(th32) + s * nug32))
    ds = d_isqrt.double()
    M = th32.double() * (ds[:, None] * ds[None, :])
    M.fill_diagonal_(1.0)
    assert torch.equal(L, torch.linalg.cholesky(M).float())
    th64 = _t(theta)
    tl.equilibrated_cholesky(th64, _t(nug), 1.0)
    np.testing.assert_array_equal(th64.numpy(), theta)  # f64 input left as it was


def test_refined_tri_inverse_matches_jax(gram):
    """One Newton step on the triangular inverse of the same factor; the
    inverse's entries reach 1e4, so the gap is held relative to its scale."""
    theta, nug = gram
    L, *_ = _equilibrated_cholesky(jnp.asarray(theta), jnp.asarray(nug), 1.0, False)
    ref = np.asarray(jl.newton_refine_tri_inverse(L, jl.tri_inverse(L)))
    Lt = _t(L)
    W = tl.tri_inverse(Lt)
    got = tl.newton_refine_tri_inverse(Lt, W).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    # and it is a left inverse to working precision
    eye = np.eye(L.shape[0])
    assert np.abs(got @ np.asarray(L) - eye).max() < 1e-8


@pytest.mark.parametrize("which", ["controlled", "spd_solve"])
def test_spd_solves_match_jax(which):
    """cond(H) ~ 2e5: both solves agree to 1e-10 of the solution's scale."""
    rng = np.random.default_rng(2)
    A = rng.standard_normal((50, 50))
    H = A @ A.T + 1e-3 * np.eye(50)
    g = rng.standard_normal(50)
    if which == "controlled":
        ref = jl.spd_solve_controlled(jnp.asarray(H), jnp.asarray(g))
        got = tl.spd_solve_controlled(_t(H), _t(g))
    else:
        ref = jl.spd_solve(jnp.asarray(H), jnp.asarray(g), jitter=1e-9)
        got = tl.spd_solve(_t(H), _t(g), jitter=1e-9)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10 * np.abs(ref).max())


def test_spd_solve_controlled_fails_to_nan():
    """An indefinite system survives the 32-eps floor only as NaN, which the
    Gauss-Newton guard then rejects."""
    H = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    x = tl.spd_solve_controlled(H, torch.ones(2, dtype=torch.float64))
    assert torch.isnan(x).all()


@pytest.mark.parametrize("solve_mode", ["inverse", "trsm"])
def test_factorize_matches_jax(gram, solve_mode):
    """Whole factorization of an elliptic problem at nugget 1e-8: scales,
    rungs, column scales, and the whitening operator (inverse mode, which
    on the CPU is the unrefined triangular inverse in both packages)."""
    rng = np.random.default_rng(0)
    Xd, Xb = rng.uniform(0, 1, (N_DOM, 2)), rng.uniform(0, 1, (N_BDY, 2))
    f, g = rng.standard_normal(N_DOM), rng.standard_normal(N_BDY)
    kj = gpt.SquaredExponential.gaussian(0.2)
    pj = gpt.models.nonlinear_elliptic(kj, jnp.asarray(Xd), jnp.asarray(Xb), jnp.asarray(f), jnp.asarray(g))
    fj = gpt.factorize(pj, 1e-8, solve_mode=solve_mode)
    pt = tpt.interop.problem_from_numpy(Xd, Xb, f, g, np.zeros(N_DOM), kj.inv_sq, device="cpu")
    ft = tpt.factorize(pt, 1e-8, solve_mode=solve_mode)
    assert ft.nugget_scales == {"u": fj.nugget_scales["u"]} and ft.rungs == {"u": 0}
    np.testing.assert_allclose(ft.col_scales["u"].numpy(), np.asarray(fj.col_scales["u"]), rtol=1e-14)
    np.testing.assert_allclose(ft.factors["u"].numpy(), np.asarray(fj.factors["u"]), rtol=0, atol=1e-8)
    assert set(ft.inv_factors) == set(fj.inv_factors)
    if solve_mode == "inverse":
        ref = np.asarray(fj.inv_factors["u"])
        np.testing.assert_allclose(
            ft.inv_factors["u"].numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max()
        )
