"""The port's one-device mesh, the block-cyclic layout's algebra at P = 1,
the facade's routes into the mesh path, and the mesh path's modules run
with JAX blocked (CPU, f64)."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import nonlinpdes_gpsolver_tpu_torch as tpt
from nonlinpdes_gpsolver_tpu_torch import api
from nonlinpdes_gpsolver_tpu_torch.parallel import cholesky, make_mesh
from nonlinpdes_gpsolver_tpu_torch.parallel.mesh import Mesh
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
MESH = make_mesh(1, device="cpu")


def test_mesh_is_one_device():
    """Outside a process group a mesh is one device with no group; a mesh of
    more ranks says how to start one (the ranks themselves are
    tests/test_torch_ranks.py)."""
    assert MESH.size == 1 and MESH.device == torch.device("cpu") and MESH.axis == "p"
    assert MESH.rank == 0 and MESH.group is None and MESH.backend is None
    assert make_mesh(device="cpu") == MESH
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        make_mesh(2, device="cpu")
    assert not tpt.parallel.initialize_distributed()
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")


def _spd(n, seed=0):
    A = np.random.default_rng(seed).standard_normal((n, n))
    return torch.as_tensor(A @ A.T / n + np.eye(n))


def test_block_cyclic_layout_and_solves_at_one_device():
    """At P = 1 the block permutation is the identity, the arranged matrix
    is the dense one with an identity tail, and the factor's solves,
    products and diagonal-block inverses are the dense ones (1e-12)."""
    n, B = 45, 8
    assert cholesky.pad_to_blocks(n, B, 1) == 48 and cholesky.pad_to_blocks(48, B, 1) == 48
    np.testing.assert_array_equal(cholesky._block_perm(6, 1), np.arange(6))
    A = _spd(n)
    arranged = cholesky.shard_rows_blockcyclic(A, MESH, "p", B)
    assert arranged.shape == (6, B, 48)
    full = arranged.view(48, 48)
    assert torch.equal(full[:n, :n], A) and torch.equal(full[n:, n:], torch.eye(3, dtype=A.dtype))
    assert torch.equal(cholesky.unshard_rows_blockcyclic(arranged, MESH, "p", B, n), A)
    v = torch.as_tensor(np.random.default_rng(1).standard_normal(n))
    torch.testing.assert_close(cholesky.matvec_blockcyclic(arranged, MESH, "p", B, v), A @ v)
    torch.testing.assert_close(cholesky.matvec_blockcyclic(arranged, MESH, "p", B, v, trans=True),
                               A.T @ v)
    fac = cholesky.cholesky_blockcyclic(A, MESH, block=B)
    L = torch.linalg.cholesky(A)
    torch.testing.assert_close(fac.dense(), L, rtol=0, atol=1e-12)
    V = torch.as_tensor(np.random.default_rng(2).standard_normal((n, 3)))
    for rhs in (V, V[:, 0]):
        torch.testing.assert_close(cholesky.trsm_blockcyclic(fac, rhs),
                                   torch.linalg.solve_triangular(L, rhs.reshape(n, -1),
                                                                 upper=False).reshape(rhs.shape))
        torch.testing.assert_close(cholesky.kernel_solve_blockcyclic(fac, rhs),
                                   torch.linalg.solve(A, rhs))
    torch.testing.assert_close(cholesky.trsm_blockcyclic(fac, V, trans=True),
                               torch.linalg.solve_triangular(L.T, V, upper=True))
    for k in range(6):
        blk = fac.matrix[k * B : (k + 1) * B, k * B : (k + 1) * B]
        torch.testing.assert_close(fac.diag_inv[k] @ blk, torch.eye(B, dtype=A.dtype),
                                   rtol=0, atol=1e-12)
    torch.testing.assert_close(cholesky.diag_inverses(fac.local, MESH, "p", B), fac.diag_inv)
    with pytest.raises(ValueError, match="rows"):
        cholesky.trsm_blockcyclic(fac, V[:-1])


def _elliptic(n_dom=40, n_bdy=16):
    rng = np.random.default_rng(4)
    Xd, Xb = rng.uniform(0, 1, (n_dom, 2)), rng.uniform(0, 1, (n_bdy, 2))
    u = np.sin(np.pi * Xd[:, 0]) * np.sin(np.pi * Xd[:, 1])
    f = 2 * np.pi**2 * u + u**3
    g = np.sin(np.pi * Xb[:, 0]) * np.sin(np.pi * Xb[:, 1])
    return tpt.models.nonlinear_elliptic(tpt.SquaredExponential.gaussian(0.3),
                                         *map(torch.as_tensor, (Xd, Xb, f, g)), init="zero")


def test_facade_mesh_path_matches_dense():
    """GPSolver with a one-device mesh: the mesh path end to end (factor,
    GN, DistributedPosterior), the dense path's solution and extension
    within 1e-6 of their scale."""
    prob = _elliptic()
    mesh = tpt.GPSolver(prob, nugget=1e-8, mesh=MESH, mesh_block=16).solve(max_iter=3)
    dense = tpt.GPSolver(prob, nugget=1e-8, solve_mode="trsm").solve(max_iter=3)
    assert isinstance(mesh.posterior, tpt.solvers.DistributedPosterior)
    assert not isinstance(dense.posterior, tpt.solvers.DistributedPosterior)
    assert set(mesh.timers) == {
        "factorize", "gauss_newton", "posterior_weights", "build", "build.record",
        "build.replay", "factorize.assemble",
        "factorize.cholesky", "factorize.inverse", "factorize.quality", "factorize.bind",
        "gauss_newton.record", "gauss_newton.replay", "gauss_newton.normal_state",
        "gauss_newton.normal_step", "host_wait", "solver_host"}
    torch.testing.assert_close(mesh.z, dense.z, rtol=0, atol=1e-6 * float(dense.z.abs().max()))
    Xt = tpt.utils.test_grid(9, 9, device="cpu")
    e = dense.posterior.extend(Xt)
    torch.testing.assert_close(mesh.posterior.extend(Xt), e, rtol=0, atol=1e-6 * float(e.abs().max()))


def test_auto_mesh_routes_by_the_threshold(monkeypatch):
    """auto_mesh sends a problem to the mesh path on its own device from
    _AUTO_MESH_GRAM_ROWS Gram rows (lowered here); below it, or with
    auto_mesh=False, the dense path; a mesh on another device is refused."""
    prob = _elliptic(20, 8)
    assert api.largest_gram_rows(prob) == 48
    monkeypatch.setattr(api, "_AUTO_MESH_GRAM_ROWS", 48)
    s = tpt.GPSolver(prob, nugget=1e-8)
    assert s.mesh == MESH and isinstance(s.fp, tpt.solvers.DistributedFactoredProblem)
    assert isinstance(s.solve(max_iter=1).posterior, tpt.solvers.DistributedPosterior)
    assert tpt.GPSolver(prob, nugget=1e-8, auto_mesh=False).mesh is None
    monkeypatch.setattr(api, "_AUTO_MESH_GRAM_ROWS", 49)
    assert tpt.GPSolver(prob, nugget=1e-8).mesh is None
    with pytest.raises(ValueError, match="lies on"):
        tpt.GPSolver(prob, nugget=1e-8, mesh=Mesh(torch.device("meta")))


@pytest.mark.parametrize("name,kw", [
    ("mesh_elliptic", dict(n_domain=500, n_boundary=100)),
    ("darcy_past_wall", dict(n_domain=300)),
])
def test_mesh_workloads_pass_their_gates_on_cpu(name, kw):
    """The two mesh-path workloads, cut to CPU sizes, in f64 on the port's
    own draw: mesh_elliptic's test L2 <= 3.402e-3; darcy_past_wall's u L2
    <= 5e-3 and a rel L2 <= 0.55."""
    w = getattr(tpt.workloads, name)(device="cpu", **kw)
    res = w.solve()
    assert isinstance(res.posterior, tpt.solvers.DistributedPosterior)
    metrics = w.metrics(res)
    assert not w.failures(metrics), metrics
    assert bool(res.state.converged_finite)


def test_mesh_modules_import_no_jax():
    """The mesh path's modules, imported with jax and the JAX package
    blocked, run a small mesh solve of each kind (structured, cg, and a
    Darcy woodbury step with its deflation) and leave neither in
    sys.modules."""
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
        torch.set_num_threads(1)  # beside other test processes
        from nonlinpdes_gpsolver_tpu_torch.parallel import cholesky, fused, gram, mesh
        from nonlinpdes_gpsolver_tpu_torch.solvers import distributed
        import nonlinpdes_gpsolver_tpu_torch as tpt
        m = mesh.make_mesh(1, device="cpu")
        inp = tpt.interop.load_canonical_inputs()
        small = {k: v[:40] if k != "inv_sq" else v for k, v in inp.items()}
        prob = tpt.interop.problem_from_numpy(**small, device="cpu")
        for solver in ("structured", "cg"):
            res = tpt.GPSolver(prob, nugget=1e-8, mesh=m, mesh_block=16).solve(
                max_iter=1, step_solver=solver)
            res.posterior.extend(tpt.utils.test_grid(5, 5, device="cpu"))
        d = tpt.interop.load_inputs("darcy")
        n, nb, k = 40, 16, 8
        small = dict(d, X_domain=d["X_domain"][:n], X_boundary=d["X_boundary"][:nb],
                     f=d["f"][:n], g=d["g"][:nb], obs=d["obs"][:k],
                     z0=d["z0"].reshape(6, -1)[:, :n].ravel())
        darcy = tpt.interop.darcy_from_numpy(**small, device="cpu")
        st = tpt.GPSolver(darcy, nugget=1e-2, mesh=m, mesh_block=16).solve(
            max_iter=1, step_solver="woodbury").state
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
