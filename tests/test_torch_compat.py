"""The port's ``solver_GP`` facade on the CPU in f64: twins of
``tests/test_compat.py`` (a reference-style driver script runs for every PDE
type string), a parity case against the JAX facade on the same points, and
the ``show_*`` figures.

Parity: the same ``get_sample`` points and ``initial_sol='zero'`` through both
facades; z and the test predictions within 1e-7 of their scale, the bound of
``tests/test_torch_solver.py::test_gn_steps_match_jax`` (the right-hand side
comes from each package's autodiff, and the two packages' solves round
differently).
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonlinpdes_gpsolver_tpu.compat import solver_GP as jax_solver_GP

from nonlinpdes_gpsolver_tpu_torch.compat import solver_GP
from nonlinpdes_gpsolver_tpu_torch.solvers.distributed import DistributedFactoredProblem
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)


def _cfg(**kw):
    ns = argparse.Namespace(
        kernel="Gaussian", kernel_parameter=0.2, nugget=1e-10,
        nugget_type="adaptive", GNsteps=4, step_size=1, initial_sol="rdm",
        alpha=1.0, m=3, nu=0.02, eps=0.1, randomseed=7, print_hist=False, device="cpu",
    )
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def u(x1, x2):
    return torch.sin(torch.pi * x1) * torch.sin(torch.pi * x2)


def f(x1, x2):
    uu = lambda x: u(x[0], x[1])  # noqa: E731
    x = torch.stack([x1, x2])
    return -torch.trace(torch.func.hessian(uu)(x)) + u(x1, x2) ** 3


def _truth(X):
    X = torch.as_tensor(X)
    return torch.func.vmap(lambda x: u(x[0], x[1]))(X)


def _grid(n):
    XX, YY = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n))
    return XX, YY, np.stack([XX.ravel(), YY.ravel()], axis=1)


def test_compat_elliptic_reference_driver_flow(capsys):
    """Mirrors main_NonLinElliptic2d.py steps 1-5 with (x1, x2) callables."""
    solver = solver_GP(_cfg(print_hist=True), PDE_type="Nonlinear_elliptic")
    solver.set_equation(bdy=u, rhs=f, domain=np.array([[0, 1], [0, 1]]))
    solver.auto_sample(300, 60, sampled_type="random")
    solver.solve(method="elimination")
    assert "iter = 4  Loss = " in capsys.readouterr().out

    stats_c = solver.collocation_pts_err(_truth(solver._X_domain), print_option=False)
    assert stats_c.l2 < 1e-4

    _, _, X_test = _grid(20)
    solver.test(X_test)
    stats_t = solver.get_test_error(_truth(X_test).numpy(), print_option=False)
    assert stats_t.l2 < 1e-4
    assert (solver.test_L2_err, solver.pts_L2_err) == (stats_t.l2, stats_c.l2)


def test_compat_relaxation_method():
    solver = solver_GP(_cfg(GNsteps=6), PDE_type="Nonlinear_elliptic")
    solver.set_equation(bdy=u, rhs=f)
    solver.auto_sample(200, 48)
    solver.solve(method="relaxation", pen_lambda=1e-10)
    assert solver.loss_hist[-1] < solver.loss_hist[0]
    assert solver._result.z.shape == (400,) and solver.sol_on_collocation_pts.shape == (200,)


def test_compat_burgers_time_dependent_sampling():
    solver = solver_GP(
        _cfg(kernel="anisotropic_Gaussian", kernel_parameter=[0.3, 0.05],
             nugget=1e-5, GNsteps=4),
        PDE_type="Burgers",
    )
    solver.set_equation(
        bdy=lambda x1, x2: torch.where(x1 == 0.0, -torch.sin(torch.pi * x2), 0.0),
        rhs=lambda x1, x2: 0.0,
        domain=np.array([[0, 1], [-1, 1]]),
    )
    solver.auto_sample(200, 60)
    # boundary must be the time-dependent faces
    Xb = solver._X_boundary.numpy()
    assert np.all((Xb[:, 0] == 0.0) | (np.abs(Xb[:, 1]) == 1.0))
    solver.solve()
    assert solver.loss_hist[-1] < solver.loss_hist[0]


def _darcy_solver():
    solver = solver_GP(_cfg(nugget=1e-8, GNsteps=4), PDE_type="Darcy_flow2d")
    solver.set_equation(bdy=lambda x1, x2: 0.0, rhs=lambda x1, x2: 1.0)
    solver.auto_sample_IP(120, 40, N_data=20)
    solver.get_observed_data(np.linspace(0, 0.01, 20), noise_level=1e-3)
    solver.solve()
    return solver


def test_compat_darcy_inverse_flow():
    solver = _darcy_solver()
    xx = np.linspace(0.05, 0.95, 10)
    XX, YY = np.meshgrid(xx, xx)
    solver.test(np.stack([XX.ravel(), YY.ravel()], axis=1))
    assert solver.extended_sol_u.shape == (100,)
    assert solver.extended_sol_a.shape == (100,)
    assert bool(torch.isfinite(solver.extended_sol_a).all())
    assert solver.X_data.shape == (20, 2)


def test_compat_rejects_unknown_pde():
    with pytest.raises(ValueError, match="Wave"):
        solver_GP(_cfg(), PDE_type="Wave")


def test_compat_relaxation_only_elliptic():
    solver = solver_GP(_cfg(), PDE_type="Eikonal")
    solver.set_equation(bdy=lambda x1, x2: 0.0, rhs=lambda x1, x2: 1.0)
    solver.auto_sample(50, 20)
    with pytest.raises(ValueError, match="relaxation"):
        solver.solve(method="relaxation")


def test_compat_mesh_passthrough():
    """cfg.mesh routes a reference-style driver onto the mesh path: 1 is
    the CPU alone; 2 needs a process group and raises without one."""
    results = {}
    for mesh in (0, 1):
        solver = solver_GP(_cfg(mesh=mesh, mesh_block=16), PDE_type="Nonlinear_elliptic")
        solver.set_equation(bdy=u, rhs=f, domain=np.array([[0, 1], [0, 1]]))
        solver.auto_sample(120, 32, sampled_type="random")
        solver.solve(method="elimination")
        results[mesh] = solver.test(_grid(10)[2]).numpy()
        # mesh=1 took the mesh path; mesh=0 the dense one
        assert isinstance(solver._result.posterior.fp, DistributedFactoredProblem) == (mesh != 0)
    np.testing.assert_allclose(results[0], results[1], rtol=1e-3, atol=1e-3)
    solver = solver_GP(_cfg(mesh=2), PDE_type="Nonlinear_elliptic")
    solver.set_equation(bdy=u, rhs=f)
    solver.auto_sample(40, 16)
    with pytest.raises(ValueError, match="process group"):
        solver.solve()


def test_compat_defaults_to_the_card(monkeypatch):
    """With no ``cfg.device`` the facade runs on the card, and says so
    without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg()
    del cfg.device
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solver_GP(cfg)


def test_compat_matches_jax_facade():
    """The same points (the JAX facade's ``auto_sample`` draw, given to both
    by ``get_sample``) and ``initial_sol='zero'``: z and the 20x20 test
    predictions within 1e-7 of their scale."""

    def uj(x1, x2):
        return jnp.sin(jnp.pi * x1) * jnp.sin(jnp.pi * x2)

    def fj(x1, x2):
        uu = lambda x: uj(x[0], x[1])  # noqa: E731
        x = jnp.stack([x1, x2])
        return -jnp.trace(jax.hessian(uu)(x)) + uj(x1, x2) ** 3

    cfg = dict(initial_sol="zero", nugget=1e-8, GNsteps=3)
    sj = jax_solver_GP(_cfg(**cfg), PDE_type="Nonlinear_elliptic")
    sj.set_equation(bdy=uj, rhs=fj)
    sj.auto_sample(120, 32)
    sj.solve()
    st = solver_GP(_cfg(**cfg), PDE_type="Nonlinear_elliptic")
    st.set_equation(bdy=u, rhs=f)
    st.get_sample(sj._X_domain, sj._X_boundary)
    st.solve()
    zj = np.asarray(sj._result.z)
    np.testing.assert_allclose(st._result.z.numpy(), zj, rtol=0, atol=1e-7 * np.abs(zj).max())
    X_test = _grid(20)[2]
    pj = sj.test(X_test)
    np.testing.assert_allclose(st.test(X_test).numpy(), pj, rtol=0,
                               atol=1e-7 * np.abs(pj).max())
    np.testing.assert_allclose(st.loss_hist, sj.loss_hist, rtol=1e-6)


def test_compat_figures(monkeypatch):
    """``show_loss_hist``, ``show_sample``, ``show_IP_result`` and
    ``contour_of_test_err`` draw their figures under the Agg backend; the
    Darcy panels refuse another PDE type."""
    monkeypatch.setenv("MPLBACKEND", "Agg")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    solver = _darcy_solver()
    XX, YY, X_test = _grid(8)
    solver.test(X_test)
    figs = [solver.show_loss_hist(), solver.show_sample(), solver.show_sample_IP(),
            solver.show_IP_result(X_test, truth_a=np.ones(64), truth_u=np.zeros(64))]
    assert len(figs[3].axes) == 8  # four panels and their colour bars
    ell = solver_GP(_cfg(GNsteps=2), PDE_type="Nonlinear_elliptic")
    ell.set_equation(bdy=u, rhs=f)
    ell.auto_sample(40, 16)
    ell.solve()
    ell.test(X_test)
    ell.get_test_error(_truth(X_test), print_option=False)
    figs.append(ell.contour_of_test_err(XX, YY))
    with pytest.raises(ValueError, match="Darcy"):
        ell.show_IP_result(X_test)
    for fig in figs:
        plt.close(fig)
