"""The port's Gauss-Newton solve, posterior and solver facade against the JAX
package (f64, CPU, same numpy inputs), the canonical end-to-end gate, and
the port's import and device rules."""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinpdes_gpsolver_tpu as gpt
import nonlinpdes_gpsolver_tpu_torch as tpt
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
GATE_L2 = 3.402e-3  # BASELINE.md row 1, the bench.py accuracy gate


def _u_jax(x):
    return jnp.sin(jnp.pi * x[0]) * jnp.sin(jnp.pi * x[1]) + 2 * jnp.sin(
        4 * jnp.pi * x[0]
    ) * jnp.sin(4 * jnp.pi * x[1])


def _rhs_jax(x):
    return -jnp.trace(jax.hessian(_u_jax)(x)) + _u_jax(x) ** 3


def _u_torch(x):
    return torch.sin(torch.pi * x[0]) * torch.sin(torch.pi * x[1]) + 2 * torch.sin(
        4 * torch.pi * x[0]
    ) * torch.sin(4 * torch.pi * x[1])


def jax_canonical_draw():
    """bench.py's canonical inputs, drawn by the JAX package (CPU, x64)."""
    Xd, Xb = gpt.utils.sample_random(jax.random.PRNGKey(0), 900, 124)
    kernel = gpt.SquaredExponential.gaussian(0.2)
    prob = gpt.models.nonlinear_elliptic(kernel, Xd, Xb, _rhs_jax, _u_jax, seed=1)
    return {
        "X_domain": np.asarray(Xd),
        "X_boundary": np.asarray(Xb),
        "f": np.asarray(prob.data["f"]),
        "g": np.asarray(prob.data["g"]),
        "z0": np.asarray(prob.init_latent()),
        "inv_sq": np.asarray(kernel.inv_sq),
    }


def test_canonical_inputs_match_jax():
    saved = tpt.interop.load_canonical_inputs()
    fresh = jax_canonical_draw()
    assert set(saved) == set(fresh)
    for k in fresh:
        assert saved[k].dtype == np.float64, k
        np.testing.assert_array_equal(saved[k], fresh[k], err_msg=k)


def _small_problem(n_dom=80, n_bdy=24, seed=0):
    rng = np.random.default_rng(seed)
    Xd, Xb = rng.uniform(0, 1, (n_dom, 2)), rng.uniform(0, 1, (n_bdy, 2))
    f = np.asarray(jax.vmap(_rhs_jax)(jnp.asarray(Xd)))
    g = np.asarray(jax.vmap(_u_jax)(jnp.asarray(Xb)))
    z0 = rng.standard_normal(n_dom)
    return Xd, Xb, f, g, z0


def _jax_problem(Xd, Xb, f, g):
    return gpt.models.nonlinear_elliptic(
        gpt.SquaredExponential.gaussian(0.2), jnp.asarray(Xd), jnp.asarray(Xb),
        jnp.asarray(f), jnp.asarray(g),
    )


@pytest.mark.parametrize("solve_mode,step", [("inverse", "structured"), ("trsm", "direct")])
def test_gn_steps_match_jax(solve_mode, step):
    """z and the loss after each of 4 GN steps, from the same z0, at nugget
    1e-8. The two factorizations round differently (see test_torch_linalg)
    and each step's solve amplifies that by the normal matrix's
    conditioning: z is held to 1e-7 of its scale and the loss to rtol 1e-7."""
    Xd, Xb, f, g, z0 = _small_problem()
    fj = gpt.factorize(_jax_problem(Xd, Xb, f, g), 1e-8, solve_mode=solve_mode)
    pt = tpt.interop.problem_from_numpy(Xd, Xb, f, g, z0, (12.5, 12.5), device="cpu")
    ft = tpt.factorize(pt, 1e-8, solve_mode=solve_mode)
    zj, zt = jnp.asarray(z0), None
    for _ in range(4):
        sj = gpt.gn_solve(fj, z0=zj, max_iter=1, step_solver=step)
        st = tpt.gn_solve(ft, z0=zt, max_iter=1, step_solver=step)
        zj, zt = sj.z, st.z
        ref = np.asarray(zj)
        np.testing.assert_allclose(zt.numpy(), ref, rtol=0, atol=1e-7 * np.abs(ref).max())
        np.testing.assert_allclose(st.losses.numpy(), np.asarray(sj.losses), rtol=1e-7)
        assert bool(st.converged_finite)


def test_posterior_matches_jax():
    """Representer weights, the extension and the variance from the same
    solution z* (so only the factorizations' rounding differs)."""
    Xd, Xb, f, g, z0 = _small_problem(seed=1)
    fj = gpt.factorize(_jax_problem(Xd, Xb, f, g), 1e-8)
    z_star = np.array(gpt.gn_solve(fj, z0=jnp.asarray(z0), max_iter=3).z)
    pj = gpt.Posterior(fj, jnp.asarray(z_star))
    ft = tpt.factorize(
        tpt.interop.problem_from_numpy(Xd, Xb, f, g, z0, (12.5, 12.5), device="cpu"), 1e-8
    )
    pt = tpt.Posterior(ft, torch.as_tensor(z_star))
    w_ref = np.asarray(pj.weights("u"))
    np.testing.assert_allclose(
        pt.weights("u").numpy(), w_ref, rtol=0, atol=1e-6 * np.abs(w_ref).max()
    )
    Xt = np.array(gpt.utils.test_grid(13, 11))
    ref = np.asarray(pj.extend(jnp.asarray(Xt)))
    got = pt.extend(torch.as_tensor(Xt))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-8 * np.abs(ref).max())
    var_ref = np.asarray(pj.variance(jnp.asarray(Xt)))
    var = pt.variance(torch.as_tensor(Xt))
    # the variance is a difference of O(1) terms: compare at 1e-8 absolute
    np.testing.assert_allclose(var.numpy(), var_ref, rtol=0, atol=1e-8)
    np.testing.assert_allclose(pt.std(torch.as_tensor(Xt)).numpy(), np.sqrt(var.numpy()))


def test_extend_chunks_like_a_single_panel(monkeypatch):
    """Row-chunked extension (the serving budget) equals the one-panel one."""
    from nonlinpdes_gpsolver_tpu_torch.solvers import posterior

    Xd, Xb, f, g, z0 = _small_problem(n_dom=30, n_bdy=10, seed=2)
    ft = tpt.factorize(
        tpt.interop.problem_from_numpy(Xd, Xb, f, g, z0, (12.5, 12.5), device="cpu"), 1e-8
    )
    post = tpt.Posterior(ft, ft.problem.init_latent())
    Xt = tpt.utils.test_grid(17, 19, device="cpu")
    whole = post.extend(Xt)
    monkeypatch.setattr(posterior, "_serving_chunk", lambda rows, n, budget=0: 128)
    torch.testing.assert_close(post.extend(Xt), whole, rtol=0, atol=1e-12)


def test_relaxed_form_matches_jax():
    """Penalty form with its misfit rows, 3 direct GN steps from the same z0
    at nugget 1e-8, pen_lambda 1e-6 (the penalty weight scales the loss)."""
    Xd, Xb, f, g, _ = _small_problem(n_dom=50, n_bdy=16, seed=3)
    z0 = np.random.default_rng(4).standard_normal(100)
    pj = gpt.models.nonlinear_elliptic_relaxed(
        gpt.SquaredExponential.gaussian(0.2), jnp.asarray(Xd), jnp.asarray(Xb),
        jnp.asarray(f), jnp.asarray(g), pen_lambda=1e-6,
    )
    sj = gpt.gn_solve(gpt.factorize(pj, 1e-8), z0=jnp.asarray(z0), max_iter=3)
    pt = tpt.models.nonlinear_elliptic_relaxed(
        tpt.SquaredExponential.gaussian(0.2), torch.as_tensor(Xd), torch.as_tensor(Xb),
        torch.as_tensor(f), torch.as_tensor(g), pen_lambda=1e-6,
    )
    st = tpt.gn_solve(tpt.factorize(pt, 1e-8), z0=torch.as_tensor(z0), max_iter=3)
    ref = np.asarray(sj.z)
    np.testing.assert_allclose(st.z.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    np.testing.assert_allclose(st.losses.numpy(), np.asarray(sj.losses), rtol=1e-6)


def test_tol_plateau_stop_matches_jax():
    Xd, Xb, f, g, z0 = _small_problem(n_dom=40, n_bdy=12, seed=5)
    sj = gpt.gn_solve(
        gpt.factorize(_jax_problem(Xd, Xb, f, g), 1e-8), z0=jnp.asarray(z0),
        max_iter=12, tol=1e-3,
    )
    ft = tpt.factorize(
        tpt.interop.problem_from_numpy(Xd, Xb, f, g, z0, (12.5, 12.5), device="cpu"), 1e-8
    )
    st = tpt.gn_solve(ft, max_iter=12, tol=1e-3)
    ref = np.asarray(sj.losses)
    assert ref[-1] == ref[-2]  # the loop stopped early and padded the history
    np.testing.assert_allclose(st.losses.numpy(), ref, rtol=1e-6)


def test_canonical_solve_passes_gate_on_cpu():
    """bench.py's canonical solve from the JAX package's draw, f64 on the
    CPU at nugget 1e-13. The JAX package reaches test L2 8.4e-7 here; the
    port is held to the JAX package's own acceptance level, 1e-4 (at this
    nugget the two factorizations round differently)."""
    inp = tpt.interop.load_canonical_inputs()
    prob = tpt.interop.problem_from_numpy(**inp, device="cpu")
    res = tpt.GPSolver(prob, nugget=1e-13).solve(max_iter=4)
    Xt = tpt.utils.test_grid(60, 60, device="cpu")
    err = tpt.GPSolver.errors(res.posterior.extend(Xt), torch.func.vmap(_u_torch)(Xt))
    assert err.l2 <= 1e-4 and err.l2 <= GATE_L2, err
    assert bool(res.state.converged_finite)
    assert set(res.timers) == {
        "factorize", "gauss_newton", "posterior_weights", "build", "build.record",
        "build.replay", "factorize.assemble",
        "factorize.cholesky", "factorize.inverse", "factorize.quality", "factorize.bind",
        "gauss_newton.record", "gauss_newton.replay", "gauss_newton.normal_state",
        "gauss_newton.normal_step", "host_wait", "solver_host"}


@pytest.mark.parametrize("time_dependent", [False, True])
def test_sampling_matches_jax(time_dependent):
    """The grids are deterministic, so they are the JAX package's points
    exactly. The random draw comes from another generator: its shapes, its
    domain and the face each boundary point lies on match."""
    dom = ((0.0, 2.0), (-1.0, 1.0))
    got = tpt.utils.sample_grid(100, 40, dom, time_dependent, device="cpu")
    ref = gpt.utils.sample_grid(100, 40, dom, time_dependent)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        tpt.utils.test_grid(7, 5, dom, device="cpu").numpy(),
        np.asarray(gpt.utils.test_grid(7, 5, dom)),
    )
    Xd, Xb = tpt.utils.sample_random(torch.Generator().manual_seed(0), 50, 22, dom, time_dependent)
    Jd, Jb = gpt.utils.sample_random(jax.random.PRNGKey(0), 50, 22, dom, time_dependent)
    assert Xd.shape == Jd.shape and Xb.shape == Jb.shape and Xd.dtype == torch.float64
    for k, (lo, hi) in enumerate(dom):
        assert bool((Xd[:, k] >= lo).all() and (Xd[:, k] <= hi).all())
        np.testing.assert_array_equal(
            np.isin(Xb[:, k].numpy(), [lo, hi]), np.isin(np.asarray(Jb[:, k]), [lo, hi])
        )


def test_callable_rhs_matches_values():
    """A callable rhs (torch.func.vmap over torch.func.hessian) gives the
    JAX package's values of the same manufactured solution."""
    Xd, Xb, f, g, _ = _small_problem(n_dom=20, n_bdy=8, seed=6)

    def rhs(x):
        return -torch.trace(torch.func.hessian(_u_torch)(x)) + _u_torch(x) ** 3

    prob = tpt.models.nonlinear_elliptic(
        tpt.SquaredExponential.gaussian(0.2), torch.as_tensor(Xd), torch.as_tensor(Xb),
        rhs, _u_torch,
    )
    np.testing.assert_allclose(prob.data["f"].numpy(), f, rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(prob.data["g"].numpy(), g, rtol=1e-12, atol=1e-14)


def test_solver_guards(monkeypatch):
    """A Gram block at the mesh crossover takes the mesh path (its
    factorization is stubbed here: 16,400 rows are too many for the CPU
    test); the Krylov step solvers run; the generator-seeded latent is
    reproducible."""
    from nonlinpdes_gpsolver_tpu_torch import api

    Xd = torch.rand((8100, 2), dtype=torch.float64)
    Xb = torch.rand((200, 2), dtype=torch.float64)
    big = tpt.models.nonlinear_elliptic(
        tpt.SquaredExponential.gaussian(0.2), Xd, Xb, None, None
    )

    def routed(problem, mesh, **kw):
        raise LookupError(f"mesh path on {mesh.device}, block {kw['block']}")

    monkeypatch.setattr(api, "factorize_distributed", routed)
    with pytest.raises(LookupError, match="mesh path on cpu, block 512"):
        tpt.GPSolver(big, nugget=1e-5)
    Xd, Xb, f, g, z0 = _small_problem(n_dom=20, n_bdy=8)
    prob = tpt.models.nonlinear_elliptic(
        tpt.SquaredExponential.gaussian(0.2), torch.as_tensor(Xd), torch.as_tensor(Xb),
        torch.as_tensor(f), torch.as_tensor(g), seed=3,
    )
    assert torch.equal(prob.init_latent(), prob.init_latent())
    fp = tpt.factorize(prob, 1e-8)
    st = tpt.gn_solve(fp, max_iter=2, step_solver="cg", cg_maxiter=50)
    assert bool(torch.isfinite(st.z).all()) and all(0 < i <= 50 for i in st.cg_iters.tolist())
    with pytest.raises(ValueError, match="step_solver"):
        tpt.gn_solve(fp, step_solver="normal")


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inp = tpt.interop.load_canonical_inputs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpt.interop.problem_from_numpy(**inp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpt.utils.test_grid(4, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpt.ops.backend.resolve_device(None)
    assert tpt.utils.test_grid(4, 4, device="cpu").dtype == torch.float64


def test_card_numerics_on_cpu():
    """Inside the override CPU tensors take the card's rules (f32 by
    default, solve_mode 'auto' -> 'inverse'); outside it, the CPU's."""
    Xd, Xb, f, g, z0 = _small_problem(n_dom=20, n_bdy=8)
    prob = tpt.interop.problem_from_numpy(Xd, Xb, f, g, z0, (12.5, 12.5), device="cpu")
    backend = tpt.ops.backend
    assert not tpt.factorize(prob, 1e-8).inv_factors
    with backend.card_numerics_on_cpu():
        assert backend.default_dtype("cpu") == torch.float32
        assert set(tpt.factorize(prob, 1e-8).inv_factors) == {b.name for b in prob.blocks}
    assert backend.default_dtype("cpu") == torch.float64 and not backend.is_accelerator("cpu")


def test_tf32_is_off():
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_port_imports_no_jax():
    """The port, imported with jax and the JAX package blocked, runs a CPU
    elliptic solve and a 'woodbury' step of a small Darcy problem built from
    its saved inputs, and leaves neither in sys.modules. Importing it
    (``compat`` and ``utils.checkpoint`` included) imports no matplotlib,
    which the card's machine does not have."""
    code = textwrap.dedent(
        """
        import importlib.abc, sys
        BLOCKED = ("jax", "jaxlib", "nonlinpdes_gpsolver_tpu")
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        import torch
        import nonlinpdes_gpsolver_tpu_torch as tpt
        from nonlinpdes_gpsolver_tpu_torch import compat
        from nonlinpdes_gpsolver_tpu_torch.utils import checkpoint, plotting
        assert compat.solver_GP and checkpoint.load_solver_state and plotting.loss_history
        assert "matplotlib" not in sys.modules
        torch.set_num_threads(1)  # beside other test processes
        inp = tpt.interop.load_canonical_inputs()
        small = {k: v[:40] if k != "inv_sq" else v for k, v in inp.items()}
        prob = tpt.interop.problem_from_numpy(**small, device="cpu")
        res = tpt.GPSolver(prob, nugget=1e-8).solve(max_iter=2)
        res.posterior.extend(tpt.utils.test_grid(5, 5, device="cpu"))
        d = tpt.interop.load_inputs("darcy")
        n, nb, k = 40, 16, 8
        small = dict(d, X_domain=d["X_domain"][:n], X_boundary=d["X_boundary"][:nb],
                     f=d["f"][:n], g=d["g"][:nb], obs=d["obs"][:k],
                     z0=d["z0"].reshape(6, -1)[:, :n].ravel())
        darcy = tpt.interop.darcy_from_numpy(**small, device="cpu")
        st = tpt.GPSolver(darcy, nugget=1e-2).solve(max_iter=1, step_solver="woodbury").state
        assert bool(torch.isfinite(st.z).all()) and int(st.cg_iters[0]) > 0
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("ok")
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
