"""The port's reference workloads: its saved inputs against fresh JAX draws,
its copy of the classical truth solvers against the JAX package's, the
end-to-end CPU gates (f64) and the command-line scripts.

Run as a script, this file writes the port's input files again from the
JAX package (CPU, float64):

    PYTHONPATH=. python tests/test_torch_workloads.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.interpolate import RegularGridInterpolator

import nonlinpdes_gpsolver_tpu as gpt
from nonlinpdes_gpsolver_tpu.utils import classical as jc

import nonlinpdes_gpsolver_tpu_torch as tpt
from nonlinpdes_gpsolver_tpu_torch import workloads
from nonlinpdes_gpsolver_tpu_torch.utils import classical as tc
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)


def _inputs(prob, kernel, **scalars):
    out = {
        "X_domain": np.asarray(prob.points["domain"]),
        "X_boundary": np.asarray(prob.points["boundary"]),
        "f": np.asarray(prob.data["f"]),
        "g": np.asarray(prob.data["g"]),
        "z0": np.asarray(prob.init_latent()),
        "inv_sq": np.asarray(kernel.inv_sq),
    }
    out.update({k: np.asarray(v, dtype=np.float64) for k, v in scalars.items()})
    return out


def jax_burgers_draw():
    """``examples/bench_workloads.py``'s Burgers inputs, drawn by the JAX package."""
    Xd, Xb = gpt.utils.sample_random(
        jax.random.PRNGKey(0), 1000, 200, domain=((0.0, 1.0), (-1.0, 1.0)), time_dependent=True,
    )
    k = gpt.SquaredExponential.anisotropic([0.3, 0.05])

    def g(x):
        return jnp.where(x[0] == 0.0, -jnp.sin(jnp.pi * x[1]), 0.0)

    prob = gpt.models.burgers(k, Xd, Xb, g, nu=0.02, seed=3)
    return _inputs(prob, k, alpha=1.0, nu=0.02)


def jax_eikonal_draw(n_domain=1000, n_boundary=200):
    Xd, Xb = gpt.utils.sample_random(jax.random.PRNGKey(1), n_domain, n_boundary)
    k = gpt.SquaredExponential.gaussian(0.2)
    prob = gpt.models.eikonal(k, Xd, Xb, rhs_f=lambda x: 1.0, eps=0.1)
    return _inputs(prob, k, eps=0.1)


def jax_darcy_draw():
    xs, ys, U = jc.darcy_fd_solve(78, workloads.darcy_a, lambda x1, x2: np.ones_like(x1))
    Xd, Xb = gpt.utils.sample_random(jax.random.PRNGKey(5), 400, 100)
    Xdata = np.asarray(Xd[:60])
    clean = RegularGridInterpolator((ys, xs), U)(np.stack([Xdata[:, 1], Xdata[:, 0]], axis=1))
    noisy = clean + 1e-3 * np.random.default_rng(9999).standard_normal(60)
    k = gpt.SquaredExponential.gaussian(0.2)
    prob = gpt.models.darcy_flow(
        k, k, Xd, Xb, jnp.asarray(noisy), rhs_f=lambda x: 1.0, noise_level=1e-3, seed=7,
    )
    return {**_inputs(prob, k, noise_level=1e-3), "obs": noisy}


def jax_burgers_notebook_draw():
    """``notebooks/burgers_demo.ipynb``'s inputs: PRNGKey(2), 1000/200, the
    precision-convention kernel [3, 20], the seed-0 latent."""
    Xd, Xb = gpt.utils.sample_random(
        jax.random.PRNGKey(2), 1000, 200, domain=((0.0, 1.0), (-1.0, 1.0)), time_dependent=True,
    )
    k = gpt.SquaredExponential.anisotropic([3.0, 20.0], "precision")

    def g(x):
        return jnp.where(x[0] == 0.0, -jnp.sin(jnp.pi * x[1]), 0.0)

    prob = gpt.models.burgers(k, Xd, Xb, g, alpha=1.0, nu=0.02, seed=0)
    return _inputs(prob, k, alpha=1.0, nu=0.02)


def jax_eikonal_notebook_draw():
    """``notebooks/eikonal_demo.ipynb``'s inputs: PRNGKey(0), 1000/200, zero latent."""
    Xd, Xb = gpt.utils.sample_random(jax.random.PRNGKey(0), 1000, 200)
    k = gpt.SquaredExponential.gaussian(0.2)
    prob = gpt.models.eikonal(k, Xd, Xb, rhs_f=lambda x: 1.0, eps=0.1, init="zero", seed=0)
    return _inputs(prob, k, eps=0.1)


def jax_darcy_notebook_draw():
    """``notebooks/darcy_inverse_demo.ipynb``'s inputs: PRNGKey(9999), 400/100,
    60 observations with ``default_rng(9999)`` noise of 1e-3, the seed-9999 latent."""
    xs, ys, U = jc.darcy_fd_solve(78, workloads.darcy_a, lambda x1, x2: np.ones_like(x1))
    Xd, Xb = gpt.utils.sample_random(jax.random.PRNGKey(9999), 400, 100)
    Xdata = np.asarray(Xd[:60])
    clean = RegularGridInterpolator((ys, xs), U)(np.stack([Xdata[:, 1], Xdata[:, 0]], axis=1))
    noisy = clean + 1e-3 * np.random.default_rng(9999).standard_normal(60)
    k = gpt.SquaredExponential.gaussian(0.2)
    prob = gpt.models.darcy_flow(
        k, k, Xd, Xb, jnp.asarray(noisy), rhs_f=lambda x: 1.0, noise_level=1e-3, seed=9999,
    )
    return {**_inputs(prob, k, noise_level=1e-3), "obs": noisy}


DRAWS = {"burgers": jax_burgers_draw, "eikonal": jax_eikonal_draw, "darcy": jax_darcy_draw,
         "burgers_notebook": jax_burgers_notebook_draw,
         "eikonal_notebook": jax_eikonal_notebook_draw,
         "darcy_notebook": jax_darcy_notebook_draw}


@pytest.mark.parametrize("name", list(DRAWS))
def test_inputs_match_jax(name):
    saved = tpt.interop.load_inputs(name)
    fresh = DRAWS[name]()
    assert set(saved) == set(fresh)
    for k in fresh:
        assert saved[k].dtype == np.float64, k
        np.testing.assert_array_equal(saved[k], fresh[k], err_msg=k)


def test_classical_matches_jax():
    """The port's copy of the truth solvers gives the JAX package's arrays."""
    a = workloads.darcy_a
    for got, ref in zip(tc.darcy_fd_solve(40, a, lambda x1, x2: x1 + 1.0),
                        jc.darcy_fd_solve(40, a, lambda x1, x2: x1 + 1.0)):
        np.testing.assert_array_equal(got, ref)
    for got, ref in zip(tc.eikonal_cole_hopf_solve(30, 0.1), jc.eikonal_cole_hopf_solve(30, 0.1)):
        np.testing.assert_array_equal(got, ref)
    T, X = np.meshgrid(np.linspace(0, 1, 9), np.linspace(-1, 1, 11))
    np.testing.assert_array_equal(tc.burgers_cole_hopf_truth(0.02)(T, X),
                                  jc.burgers_cole_hopf_truth(0.02)(T, X))
    xs, ys, U = workloads.darcy_truth()
    Xd = np.random.default_rng(0).uniform(0, 1, (20, 2))
    clean = RegularGridInterpolator((ys, xs), U)(np.stack([Xd[:, 1], Xd[:, 0]], axis=1))
    np.testing.assert_array_equal(workloads.darcy_observations(Xd, 0.0, 0), clean)


def _check(w):
    res = w.solve()
    assert bool(res.state.converged_finite)
    metrics = w.metrics(res)
    assert not w.failures(metrics), metrics
    return metrics


def test_elliptic_passes_gate_on_cpu():
    """bench.py's canonical solve as the workload runs it: nugget 1e-5,
    4 GN steps, test L2 <= 3.402e-3."""
    _check(workloads.elliptic(device="cpu"))


def test_relaxed_elliptic_passes_gate_on_cpu():
    """The JAX package's relaxed-form acceptance run (400/80 from
    PRNGKey(3), the seed-2 latent, pen_lambda 1e-10, nugget 1e-12, 6 GN
    steps): test L2 < 5e-3 on the 30x30 grid."""
    Xd, Xb = gpt.utils.sample_random(jax.random.PRNGKey(3), 400, 80)
    k = gpt.SquaredExponential.gaussian(0.2)
    u = lambda x: jnp.sin(jnp.pi * x[0]) * jnp.sin(jnp.pi * x[1]) + 2 * jnp.sin(  # noqa: E731
        4 * jnp.pi * x[0]) * jnp.sin(4 * jnp.pi * x[1])
    pj = gpt.models.nonlinear_elliptic_relaxed(
        k, Xd, Xb, lambda x: -jnp.trace(jax.hessian(u)(x)) + u(x) ** 3, u, pen_lambda=1e-10, seed=2,
    )
    t = {key: torch.as_tensor(np.asarray(v)) for key, v in
         dict(Xd=Xd, Xb=Xb, f=pj.data["f"], g=pj.data["g"], z0=pj.init_latent()).items()}
    pt = tpt.models.nonlinear_elliptic_relaxed(
        tpt.SquaredExponential.gaussian(0.2), t["Xd"], t["Xb"], t["f"], t["g"], pen_lambda=1e-10,
    )
    res = tpt.GPSolver(pt, nugget=1e-12).solve(max_iter=6, z0=t["z0"])
    Xt = tpt.utils.test_grid(30, 30, device="cpu")
    err = tpt.GPSolver.errors(res.posterior.extend(Xt), torch.func.vmap(workloads.u_elliptic)(Xt))
    assert err.l2 < 5e-3, err


def test_burgers_passes_gate_on_cpu():
    """The JAX package's Burgers draw at the CLI size (1000/200, 8 GN
    steps), f64: test L2 <= 8e-3 (the JAX package reads 7.08e-3 here) and
    the loss down 1000-fold."""
    _check(workloads.burgers(device="cpu"))


def test_eikonal_passes_gate_on_cpu():
    """The JAX acceptance size: 400/96 from PRNGKey(1), tested on the 40x40
    FD grid, L2 <= 5e-3."""
    _check(workloads.eikonal(device="cpu", inputs=jax_eikonal_draw(400, 96), grid=40))


def test_darcy_passes_gate_on_cpu():
    """The JAX package's Darcy draw (400/100/60), f64: u L2 <= 5e-3 and the
    relative L2 of a <= 0.45."""
    _check(workloads.darcy(device="cpu"))


@pytest.mark.parametrize("name,argv", [
    ("elliptic", ["--N_domain", "40", "--N_boundary", "16", "--GNsteps", "2"]),
    ("elliptic", ["--N_domain", "30", "--N_boundary", "12", "--GNsteps", "2",
                  "--method", "relaxation", "--pen_lambda", "1e-6"]),
    ("burgers", ["--N_domain", "40", "--N_boundary", "16", "--GNsteps", "2"]),
    ("eikonal", ["--N_domain", "40", "--N_boundary", "16", "--GNsteps", "2",
                 "--sampled_type", "grid"]),
    ("darcy", ["--N_domain", "40", "--N_boundary", "16", "--N_data", "8", "--GNsteps", "1",
               "--nugget", "1e-2", "--noise_level", "1e-2", "--step_solver", "woodbury"]),
])
def test_example_script_runs_on_cpu(name, argv, capsys):
    import importlib

    script = importlib.import_module(f"nonlinpdes_gpsolver_tpu_torch.examples.{name}")
    errors = script.main(["--device", "cpu", *argv])
    assert all(np.isfinite(e.l2) for e in errors.values() if hasattr(e, "l2"))
    out = capsys.readouterr().out
    assert "[GN] losses" in out and "[Timers]" in out
    # the mesh path on one device runs; across ranks it needs a process group
    errors = script.main(["--device", "cpu", "--mesh", "1", "--mesh_block", "16", *argv])
    assert all(np.isfinite(e.l2) for e in errors.values() if hasattr(e, "l2"))
    with pytest.raises(ValueError, match="torchrun"):
        script.main(["--device", "cpu", "--mesh", "2", *argv])


def test_example_dtype_flags():
    cfg = tpt.utils.config.SolverConfig(device="cpu")
    assert tpt.utils.config.runtime(cfg) == (torch.device("cpu"), torch.float64)
    cfg.x64 = False
    assert tpt.utils.config.runtime(cfg)[1] == torch.float32


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    for name, draw in DRAWS.items():
        np.savez(tpt.interop.INPUT_FILES[name], **draw())
        print("wrote", tpt.interop.INPUT_FILES[name])
