"""The port's Burgers, Eikonal and Darcy-inverse models against the JAX
package, stage by stage, on the same numpy inputs (f64, CPU): each block's
Gram matrix, the residuals, the factors, three Gauss-Newton steps and the
posterior extension of each block."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinpdes_gpsolver_tpu as gpt
import nonlinpdes_gpsolver_tpu_torch as tpt
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)

N_DOM, N_BDY, NUGGET = 60, 24, 1e-6
MODELS = ["burgers", "eikonal", "darcy"]


def _build(name, pkg, arrays, as_array):
    """The model ``name`` of package ``pkg`` on ``arrays`` (numpy), turned
    into that package's arrays by ``as_array``."""
    a = {k: as_array(v) for k, v in arrays.items()}
    if name == "burgers":
        k = pkg.SquaredExponential.anisotropic([0.3, 0.05])
        return pkg.models.burgers(k, a["Xd"], a["Xb"], a["g"], a["f"], nu=0.02)
    k = pkg.SquaredExponential.gaussian(0.2)
    if name == "eikonal":
        return pkg.models.eikonal(k, a["Xd"], a["Xb"], a["f"], a["g"], eps=0.1)
    return pkg.models.darcy_flow(k, k, a["Xd"], a["Xb"], a["obs"], a["f"], a["g"],
                                 noise_level=1e-3)


def _arrays(name, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = ([0.0, -1.0], [1.0, 1.0]) if name == "burgers" else ([0.0, 0.0], [1.0, 1.0])
    out = {
        "Xd": rng.uniform(lo, hi, (N_DOM, 2)),
        "Xb": rng.uniform(lo, hi, (N_BDY, 2)),
        "f": rng.standard_normal(N_DOM),
        "g": rng.standard_normal(N_BDY),
    }
    if name != "burgers":  # the reference's data: f = 1, u = 0 on the boundary
        out.update(f=np.ones(N_DOM), g=np.zeros(N_BDY))
    if name == "darcy":
        out["obs"] = 0.01 * rng.standard_normal(12)
    return out


def _pair(name, seed=0):
    arrays = _arrays(name, seed)
    return (_build(name, gpt, arrays, jnp.asarray),
            _build(name, tpt, arrays, torch.as_tensor))


def _close(got, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("name", MODELS)
def test_gram_and_residuals_match_jax(name):
    """Each block's Gram matrix to rtol 1e-12 (the same closed form in the
    same order), and the block and misfit residuals at a random z to 1e-13."""
    pj, pt = _pair(name)
    assert pj.latent_dim == pt.latent_dim
    assert [b.name for b in pj.blocks] == [b.name for b in pt.blocks]
    z = np.random.default_rng(1).standard_normal(pj.latent_dim)
    for bj, bt in zip(pj.blocks, pt.blocks):
        ref = np.asarray(gpt.ops.gram_matrix(bj.kernel, bj.observables, pj.points))
        got = tpt.ops.gram_matrix(bt.kernel, bt.observables, pt.points)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())
        _close(bt.residual(torch.as_tensor(z), pt.data),
               bj.residual(jnp.asarray(z), pj.data), 1e-13)
    for mj, mt in zip(pj.misfits, pt.misfits):
        assert mt.weight == mj.weight
        _close(mt.residual(torch.as_tensor(z), pt.data),
               mj.residual(jnp.asarray(z), pj.data), 1e-13)


@pytest.mark.parametrize("name", MODELS)
def test_factors_match_jax(name):
    """The equilibrated factors of each block: 1e-8 absolute on a
    unit-diagonal factor (two Cholesky implementations, see
    test_torch_linalg), the same nugget scales."""
    pj, pt = _pair(name)
    fj = gpt.factorize(pj, NUGGET, solve_mode="trsm")
    ft = tpt.factorize(pt, NUGGET, solve_mode="trsm")
    for b in pt.blocks:
        assert ft.nugget_scales[b.name] == float(fj.nugget_scales[b.name])
        np.testing.assert_allclose(ft.factors[b.name].numpy(), np.asarray(fj.factors[b.name]),
                                   rtol=0, atol=1e-8)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("solve_mode,step", [("inverse", "structured"), ("trsm", "direct")])
def test_gn_steps_match_jax(name, solve_mode, step):
    """z after each of 3 GN steps from the same z0, to 1e-7 of z's scale,
    and the loss to rtol 1e-7 (the factorizations round differently and
    each step's solve amplifies that by the normal matrix's conditioning)."""
    pj, pt = _pair(name)
    z0 = 0.1 * np.random.default_rng(2).standard_normal(pj.latent_dim)
    fj = gpt.factorize(pj, NUGGET, solve_mode=solve_mode)
    ft = tpt.factorize(pt, NUGGET, solve_mode=solve_mode)
    zj, zt = jnp.asarray(z0), torch.as_tensor(z0)
    for _ in range(3):
        sj = gpt.gn_solve(fj, z0=zj, max_iter=1, step_solver=step)
        st = tpt.gn_solve(ft, z0=zt, max_iter=1, step_solver=step)
        zj, zt = sj.z, st.z
        _close(zt, zj, 1e-7)
        np.testing.assert_allclose(st.losses.numpy(), np.asarray(sj.losses), rtol=1e-7)
        assert bool(st.converged_finite) and st.cg_iters.tolist() == [0]


@pytest.mark.parametrize("name", MODELS)
def test_posterior_extend_matches_jax(name):
    """Each block's posterior mean on a test grid from the same z*, to 1e-8
    of its scale."""
    pj, pt = _pair(name, seed=3)
    z_star = np.random.default_rng(4).standard_normal(pj.latent_dim)
    post_j = gpt.Posterior(gpt.factorize(pj, NUGGET), jnp.asarray(z_star))
    post_t = tpt.Posterior(tpt.factorize(pt, NUGGET), torch.as_tensor(z_star))
    Xt = np.asarray(gpt.utils.test_grid(9, 7))
    for b in pt.blocks:
        _close(post_t.extend(torch.as_tensor(Xt), block=b.name),
               post_j.extend(jnp.asarray(Xt), block=b.name), 1e-8)


def test_latent_init():
    """Burgers and Darcy draw z0 from a torch.Generator (reproducible);
    Eikonal starts at zero."""
    for name in MODELS:
        prob = _pair(name)[1]
        z = prob.init_latent()
        assert z.shape == (prob.latent_dim,) and z.dtype == torch.float64
        assert torch.equal(z, prob.init_latent())
        assert bool((z == 0).all()) == (name == "eikonal")
