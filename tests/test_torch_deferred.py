"""The port's optimistic pipeline (``defer_quality``) and its sync-free
Gauss-Newton loop, on the CPU.

* Twins of the JAX package's deferred-quality tests
  (``tests/test_engine.py`` and ``tests/test_distributed_solver.py``): the
  same numpy inputs through the JAX ``GPSolver`` and the port's, the
  port's accepted nugget scales equal to the JAX package's and its z held
  to the JAX z. The mesh twins run the port at P = 1 and the JAX package on
  a one-device mesh, so that both factor alike.
* The loop's host reads, counted by patching every way a tensor reaches
  the host (``item``, ``tolist``, ``__bool__``, ``__float__``,
  ``__int__``): a fixed-count ``'structured'`` or ``'direct'`` loop reads
  nothing that grows with ``max_iter``; the Krylov steps read once a CG
  iteration; the mesh loop once a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinpdes_gpsolver_tpu as gpt
from nonlinpdes_gpsolver_tpu.models.spec import CollocationProblem as JProblem
from nonlinpdes_gpsolver_tpu.models.spec import GPBlock as JBlock
from nonlinpdes_gpsolver_tpu.ops.assembly import Observable as JObservable
from nonlinpdes_gpsolver_tpu.ops.operators import identity as jidentity
from nonlinpdes_gpsolver_tpu.parallel.mesh import make_mesh as jax_mesh
from nonlinpdes_gpsolver_tpu.solvers import gn as jgn

import nonlinpdes_gpsolver_tpu_torch as tpt
from nonlinpdes_gpsolver_tpu_torch.models.spec import CollocationProblem, GPBlock
from nonlinpdes_gpsolver_tpu_torch.ops import graphs
from nonlinpdes_gpsolver_tpu_torch.ops.assembly import Observable
from nonlinpdes_gpsolver_tpu_torch.ops.operators import identity
from nonlinpdes_gpsolver_tpu_torch.parallel import make_mesh
from nonlinpdes_gpsolver_tpu_torch.solvers import _reuse
from nonlinpdes_gpsolver_tpu_torch.solvers import distributed as tdist
from nonlinpdes_gpsolver_tpu_torch.solvers import gn as tgn
from test_torch_krylov import _elliptic_pair, small_darcy
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)

MESH = make_mesh(1, device="cpu")


def _identity_pair(Xd, Xb, sigma, g, dtype):
    """(JAX problem, port problem): one GP block observed by identity at
    the domain and boundary points, residual ``[z, g]`` (the JAX tests'
    fixture)."""
    n = Xd.shape[0]
    jd = jnp.float32 if dtype == torch.float32 else jnp.float64
    pj = JProblem(
        name="dup_deferred",
        blocks=(JBlock("u", gpt.SquaredExponential.gaussian(sigma),
                       (JObservable("domain", jidentity()), JObservable("boundary", jidentity())),
                       lambda z, data: jnp.concatenate([z, data["g"]])),),
        points={"domain": jnp.asarray(Xd, jd), "boundary": jnp.asarray(Xb, jd)},
        data={"g": jnp.asarray(g, jd)}, latent_dim=n, misfits=(),
    )
    pt = CollocationProblem(
        name="dup_deferred",
        blocks=(GPBlock("u", tpt.SquaredExponential.gaussian(sigma),
                        (Observable("domain", identity()), Observable("boundary", identity())),
                        lambda z, data: torch.cat([z, data["g"]])),),
        points={"domain": torch.as_tensor(Xd, dtype=dtype),
                "boundary": torch.as_tensor(Xb, dtype=dtype)},
        data={"g": torch.as_tensor(g, dtype=dtype)}, latent_dim=n,
    )
    return pj, pt


def _scale(ref) -> float:
    return float(np.abs(np.asarray(ref)).max())


def _fail_first(real, calls):
    """``real`` with its first call's quality verdict made NaN (an injected
    failure; ``real`` returns the verdict, or ``(inverse, verdict)``)."""

    def patched(*a, **k):
        out = real(*a, **k)
        calls.append(1)
        if len(calls) > 1:
            return out
        return (out[0], out[1] * np.nan) if isinstance(out, tuple) else out * np.nan

    return patched


@pytest.mark.parametrize("case", ["as_in_jax", "injected"])
def test_gpsolver_deferred_quality_retries_escalation(monkeypatch, case):
    """Twin of ``tests/test_engine.py::test_gpsolver_deferred_quality_retries_escalation``:
    4x duplicated collocation points, nugget 1e-6, inverse mode. The one
    deferred attempt is unescalated and its verdict pending until ``solve``.

    ``as_in_jax`` (f32, g = 0, as the JAX test): the JAX package's f32
    Cholesky fails at scale 1 and its in-executable ladder accepts 10; the
    port's f64 Cholesky (fault P1) factors at 1 and passes its verdict, as
    its eager ladder does (a recorded difference); z is 0 in both.
    ``injected`` (f64, g nonzero): the first verdict is made to fail in
    both packages; each factors again at 10x and accepts it, one rung; z
    within 1e-8 of its scale of the JAX z."""
    rng = np.random.default_rng(0)
    Xd = np.concatenate([rng.uniform(0, 1, (30, 2))] * 4)
    Xb = rng.uniform(0, 1, (10, 2))
    f32 = case == "as_in_jax"
    g = np.zeros(10) if f32 else np.sin(3.0 * Xb[:, 0]) * Xb[:, 1]
    pj, pt = _identity_pair(Xd, Xb, 0.5, g, torch.float32 if f32 else torch.float64)
    if not f32:
        monkeypatch.setattr(jgn, "_refine_scale_quality",
                            _fail_first(jgn._refine_scale_quality, []))
        monkeypatch.setattr(tgn, "_whiten_quality", _fail_first(tgn._whiten_quality, []))
    sj = gpt.GPSolver(pj, nugget=1e-6, dtype=jnp.float32 if f32 else None, defer_quality=True,
                      solve_mode="inverse")
    rj = sj.solve(max_iter=2)
    st = tpt.GPSolver(pt, nugget=1e-6, defer_quality=True, solve_mode="inverse")
    assert st.fp.nugget_scales["u"] == 1.0 and set(st.fp.quality) == {"u"}
    assert torch.is_tensor(st.fp.quality["u"]) and set(st.fp.pending_scales) == {"u"}
    rt = st.solve(max_iter=2)
    assert all(q < 1e-2 for q in st.fp.quality.values()) and not st.fp.pending_scales
    if f32:
        eager = tpt.factorize(pt, 1e-6, solve_mode="inverse")
        assert eager.nugget_scales == st.fp.nugget_scales == {"u": 1.0}
        assert eager.rungs == st.fp.rungs == {"u": 0} and sj.fp.nugget_scales == {"u": 10.0}
    else:
        assert st.fp.nugget_scales == sj.fp.nugget_scales == {"u": 10.0}
        assert st.fp.rungs == {"u": 1}
    assert bool(torch.isfinite(rt.z).all())
    np.testing.assert_allclose(rt.z.numpy(), np.asarray(rj.z), rtol=0,
                               atol=1e-6 if f32 else 1e-8 * _scale(rj.z))
    W, L = st.fp.inv_factors["u"], st.fp.factors["u"]
    v = torch.as_tensor(rng.standard_normal(L.shape[0]), dtype=L.dtype)
    resid = W @ ((L @ v) / st.fp.col_scales["u"]) - v
    assert float(resid.abs().max()) < 1e-2 * float(v.abs().max())


def test_gpsolver_redo_factors_into_the_released_storage(monkeypatch):
    """A failed deferred verdict (the injected one of
    :func:`test_gpsolver_deferred_quality_retries_escalation`) releases the
    solver's factors: the redo factors into their storage, the same entry
    of the shared loops (``solvers/_reuse.py``), and accepts the escalated
    scale."""
    rng = np.random.default_rng(0)
    Xd = np.concatenate([rng.uniform(0, 1, (30, 2))] * 4)
    Xb = rng.uniform(0, 1, (10, 2))
    _, pt = _identity_pair(Xd, Xb, 0.5, np.sin(3.0 * Xb[:, 0]) * Xb[:, 1], torch.float64)
    monkeypatch.setattr(tgn, "_whiten_quality", _fail_first(tgn._whiten_quality, []))
    graphs.reset_counts()
    st = tpt.GPSolver(pt, nugget=1e-6, defer_quality=True, solve_mode="inverse")
    ptrs = {k: t.data_ptr() for k, t in (("L", st.fp.factors["u"]), ("inv", st.fp.inv_factors["u"]))}
    rt = st.solve(max_iter=2)
    assert st.fp.nugget_scales == {"u": 10.0} and bool(torch.isfinite(rt.z).all())
    assert ptrs == {"L": st.fp.factors["u"].data_ptr(), "inv": st.fp.inv_factors["u"].data_ptr()}
    assert (graphs.ENTRIES, graphs.REBINDS, graphs.UNSHARED) == (1, 1, 0)


def test_deferred_non_finite_attempt_escalates_inside_the_call(monkeypatch):
    """A non-finite Cholesky escalates inside ``factorize`` under deferral
    too (one read a Cholesky, where the JAX package's ladder runs inside
    its executable): one factorization, and the accepted scale and rungs
    of the eager ladder, with the verdict still pending."""
    from nonlinpdes_gpsolver_tpu_torch.ops import linalg

    _, pt, z0 = _elliptic_pair(30, 12)

    def broken_once():
        calls, real = [], linalg.cholesky_f64

        def patched(M, *a, **k):
            L, ok = real(M, *a, **k)
            calls.append(1)
            return (torch.full_like(L, float("nan")), False) if len(calls) == 1 else (L, ok)

        return patched

    monkeypatch.setattr(linalg, "cholesky_f64", broken_once())
    eager = tpt.factorize(pt, 1e-8, solve_mode="inverse")
    monkeypatch.setattr(linalg, "cholesky_f64", broken_once())
    rounds = []
    real_factorize = tpt.api.factorize
    monkeypatch.setattr(tpt.api, "factorize", lambda *a, **k: rounds.append(1) or
                        real_factorize(*a, **k))
    st = tpt.GPSolver(pt, nugget=1e-8, solve_mode="inverse", defer_quality=True)
    assert st.fp.pending_scales["u"] == 10.0 and torch.is_tensor(st.fp.quality["u"])
    st.solve(z0=torch.as_tensor(z0), max_iter=2)
    assert len(rounds) == 1
    assert st.fp.nugget_scales == eager.nugget_scales == {"u": 10.0}
    assert st.fp.rungs == eager.rungs == {"u": 1}


def test_two_pass_non_finite_attempt_fails_its_deferred_verdict(monkeypatch):
    """The mesh path's two-pass factorization at P = 1 reads nothing (its
    Cholesky writes NaN on failure): under deferral a non-finite attempt
    shows only in the verdict, which fails, so the caller's next round
    escalates it (the JAX package's two-pass path does not defer)."""
    _, pt, _ = _elliptic_pair(30, 12)
    monkeypatch.setattr(tdist, "_chol_sharded", lambda *a, **k: (
        lambda o: (o[0].fill_(float("nan")), o[1]))(tpt.parallel.cholesky._chol_sharded(*a, **k)))
    dfp = tdist.factorize_distributed(pt, MESH, nugget=1e-8, block=16, fused=False,
                                      defer_quality=True)
    assert dfp.stats["u"]["attempts"] == 1 and torch.is_tensor(dfp.quality["u"])
    bad, _ = dfp.resolve_pending()
    assert set(bad) == {"u"} and not dfp.pending_scales


def test_gpsolver_deferred_quality_happy_path_single_attempt():
    """Twin of ``tests/test_engine.py::test_gpsolver_deferred_quality_happy_path_single_attempt``
    (f64): the deferred pipeline accepts the first attempt, with the JAX
    package's scales; its z equals the port's eager solve bitwise and the
    JAX z within 1e-6 (the JAX test's tolerance)."""
    rng = np.random.default_rng(1)
    Xd, Xb = rng.uniform(0, 1, (40, 2)), rng.uniform(0, 1, (12, 2))
    pj, pt = _identity_pair(Xd, Xb, 0.4, np.zeros(12), torch.float64)
    rj = gpt.GPSolver(pj, nugget=1e-8, defer_quality=True, solve_mode="inverse")
    zj = rj.solve(max_iter=3).z
    s_def = tpt.GPSolver(pt, nugget=1e-8, defer_quality=True, solve_mode="inverse")
    s_eager = tpt.GPSolver(pt, nugget=1e-8, defer_quality=False, solve_mode="inverse")
    r_def, r_eager = s_def.solve(max_iter=3), s_eager.solve(max_iter=3)
    assert s_def.fp.nugget_scales == s_eager.fp.nugget_scales == rj.fp.nugget_scales
    assert torch.equal(r_def.z, r_eager.z)
    np.testing.assert_allclose(r_def.z.numpy(), np.asarray(zj), rtol=0, atol=1e-6)


def _jax_mesh_elliptic(Xd, Xb):
    def u_truth(x):
        return jnp.sin(jnp.pi * x[0]) * jnp.sin(jnp.pi * x[1])

    def rhs_f(x):
        return -jnp.trace(jax.hessian(u_truth)(x)) + u_truth(x) ** 3

    return gpt.models.nonlinear_elliptic(gpt.SquaredExponential.gaussian(0.3), jnp.asarray(Xd),
                                         jnp.asarray(Xb), rhs_f, u_truth, seed=1)


def _jax_arrays(pj):
    """The JAX problem's points, data and initial latent, as numpy."""
    return [np.asarray(a) for a in (pj.points["domain"], pj.points["boundary"], pj.data["f"],
                                    pj.data["g"], pj.init_latent())]


def _port_twin(arrays, dtype):
    """The port's elliptic problem (sigma 0.3) on ``_jax_arrays``."""
    return tpt.interop.problem_from_numpy(*arrays, (1 / (2 * 0.3**2),) * 2, device="cpu",
                                          dtype=dtype)


@pytest.mark.parametrize("case", ["as_in_jax", "injected"])
def test_gpsolver_mesh_deferred_quality_retries_escalation(monkeypatch, case):
    """Twin of ``tests/test_distributed_solver.py::``
    ``test_gpsolver_mesh_deferred_quality_retries_escalation``:
    4x duplicated points, nugget 1e-6, 16-row blocks, the port at P = 1 and
    the JAX package on a one-device mesh; one deferred attempt, whose
    verdict ``solve`` reads.

    ``as_in_jax`` (f32, as the JAX test): the JAX package's f32 superblock
    Cholesky fails at scale 1 and its in-executable ladder accepts 10; the
    port's f64 one (fault P3's shared Cholesky) factors at 1 and passes its
    probe, as its eager ladder does (a recorded difference). ``injected``
    (f64): the first probe verdict is made to fail in both packages; each
    factors again at 10x and accepts it; z within 1e-8 of its scale of the
    JAX z."""
    from nonlinpdes_gpsolver_tpu.parallel import fused as jfused

    rng = np.random.default_rng(0)
    f32 = case == "as_in_jax"
    npd = np.float32 if f32 else np.float64
    Xd = np.concatenate([rng.uniform(0, 1, (30, 2)).astype(npd)] * 4)
    Xb = rng.uniform(0, 1, (12, 2)).astype(npd)
    if not f32:
        for mod in (jfused, tdist):
            patched = _fail_first(mod.sampled_row_quality, [])
            monkeypatch.setattr(mod, "sampled_row_quality", patched)
    jax.config.update("jax_enable_x64", not f32)
    try:
        pj = _jax_mesh_elliptic(Xd, Xb)
        sj = gpt.GPSolver(pj, nugget=1e-6, mesh=jax_mesh(1), mesh_block=16, defer_quality=True)
        rj = sj.solve(max_iter=2)
        arrays = _jax_arrays(pj)  # drawn here: the initial latent depends on x64
        scales_j, zj = dict(sj.fp.nugget_scales), np.asarray(rj.z)
    finally:
        jax.config.update("jax_enable_x64", True)
    pt = _port_twin(arrays, torch.float32 if f32 else torch.float64)
    st = tpt.GPSolver(pt, nugget=1e-6, mesh=MESH, mesh_block=16, defer_quality=True)
    assert set(st.fp.quality) == {"u"} and set(st.fp.pending_scales) == {"u"}
    assert torch.is_tensor(st.fp.quality["u"]) and st.fp.nugget_scales == {"u": 1.0}
    rt = st.solve(max_iter=2)
    assert not st.fp.pending_scales and all(q < 1e-2 for q in st.fp.quality.values())
    if f32:
        eager = tdist.factorize_distributed(pt, MESH, nugget=1e-6, block=16)
        assert eager.nugget_scales == st.fp.nugget_scales == {"u": 1.0} and scales_j == {"u": 10.0}
        assert eager.rungs == st.fp.rungs == {"u": 0}
        assert torch.equal(rt.z, tdist.gn_solve_distributed(eager, max_iter=2).z)
    else:
        assert st.fp.nugget_scales == scales_j == {"u": 10.0} and st.fp.rungs == {"u": 1}
        np.testing.assert_allclose(rt.z.numpy(), zj, rtol=0, atol=1e-8 * _scale(zj))
    assert bool(torch.isfinite(st.fp.whitened_residual(pt.init_latent())).all())
    assert bool(torch.isfinite(rt.z).all())


def test_gpsolver_mesh_deferred_happy_path_matches_eager():
    """Twin of ``tests/test_distributed_solver.py::``
    ``test_gpsolver_mesh_deferred_happy_path_matches_eager``
    (f64, nugget 1e-10, 16-row blocks): the deferred mesh pipeline accepts
    the first attempt; its z equals the port's eager mesh solve bitwise,
    and the JAX package's (one-device mesh, deferred) within 1e-8 of its
    scale."""
    Xd, Xb = (np.asarray(a) for a in gpt.utils.sample_random(jax.random.PRNGKey(0), 150, 40))
    pj = _jax_mesh_elliptic(Xd, Xb)
    sj = gpt.GPSolver(pj, nugget=1e-10, mesh=jax_mesh(1), mesh_block=16, defer_quality=True)
    zj = np.asarray(sj.solve(max_iter=3).z)
    pt = _port_twin(_jax_arrays(pj), torch.float64)
    s_def = tpt.GPSolver(pt, nugget=1e-10, mesh=MESH, mesh_block=16, defer_quality=True)
    s_eager = tpt.GPSolver(pt, nugget=1e-10, mesh=MESH, mesh_block=16, defer_quality=False)
    r_def, r_eager = s_def.solve(max_iter=3), s_eager.solve(max_iter=3)
    assert s_def.fp.nugget_scales == s_eager.fp.nugget_scales == sj.fp.nugget_scales
    assert torch.equal(r_def.z, r_eager.z)
    np.testing.assert_allclose(r_def.z.numpy(), zj, rtol=0, atol=1e-8 * _scale(zj))


def test_defer_default_and_checkpoint_settles(tmp_path):
    """``defer_quality`` is off by default on the CPU and on inside the
    card's numerics; a save settles a pending verdict first, and refuses a
    failed one."""
    _, pt, _ = _elliptic_pair(30, 12)
    assert not tpt.GPSolver(pt, nugget=1e-8, solve_mode="inverse").fp.pending_scales
    with tpt.ops.backend.card_numerics_on_cpu():
        assert tpt.GPSolver(pt, nugget=1e-8).fp.pending_scales
    fp = tpt.factorize(pt, 1e-8, solve_mode="inverse", defer_quality=True)
    tpt.utils.save_solver_state(tmp_path / "ok.npz", fp)
    assert not fp.pending_scales and isinstance(fp.quality["u"], float)
    fp = tpt.factorize(pt, 1e-8, solve_mode="inverse", defer_quality=True)
    fp.quality["u"] = torch.tensor(float("nan"), dtype=torch.float64)
    with pytest.raises(FloatingPointError, match="deferred quality verdict failed"):
        tpt.utils.save_solver_state(tmp_path / "bad.npz", fp)
    dfp = tdist.factorize_distributed(pt, MESH, nugget=1e-8, block=16, defer_quality=True)
    tpt.utils.save_distributed_state(tmp_path / "mesh.npz", dfp)
    assert not dfp.pending_scales and isinstance(dfp.quality["u"], float)


# -- host reads ------------------------------------------------------------------


class ReadCounter:
    """Counts every read of a tensor's values on the host while active."""

    NAMES = ("item", "tolist", "__bool__", "__float__", "__int__")

    def __init__(self, monkeypatch):
        self.n = 0
        for name in self.NAMES:
            real = getattr(torch.Tensor, name)

            def counted(t, *a, _real=real, **k):
                self.n += 1
                return _real(t, *a, **k)

            monkeypatch.setattr(torch.Tensor, name, counted)

    def __call__(self, fn):
        before = self.n
        out = fn()
        return out, self.n - before


@pytest.mark.parametrize("solve_mode,step", [("inverse", "structured"), ("trsm", "direct")])
def test_fixed_loop_reads_nothing_per_step(monkeypatch, solve_mode, step):
    """A fixed-count exact loop reads the host only in its set-up: the
    same count at 2 and at 6 steps (each call checking its structure, the
    verdict cache cleared, as the first solve of a layout does)."""
    _, pt, z0 = _elliptic_pair(30, 12)
    fp = tpt.factorize(pt, 1e-8, solve_mode=solve_mode)
    z0 = torch.as_tensor(z0)
    reads = ReadCounter(monkeypatch)

    def solve(max_iter):
        _reuse.VERDICTS.clear()
        return tpt.gn_solve(fp, z0=z0, max_iter=max_iter, step_solver=step)

    st2, n2 = reads(lambda: solve(2))
    st6, n6 = reads(lambda: solve(6))
    assert n2 == n6
    assert st6.step_solver == step and st6.cg_iters.tolist() == [0] * 6
    assert torch.equal(st6.losses[:2], st2.losses)


@pytest.mark.parametrize("step", ["cg", "woodbury"])
def test_krylov_reads_once_an_iteration(monkeypatch, step):
    """The Krylov steps' CG loop reads its exit flag once an iteration, one
    iteration late (at most one iteration a solve queued past the exit),
    plus one read of the iteration counts at the end. On the same system
    (its operator as a matrix) ``X`` and the iteration count are the JAX
    package's ``_batched_cg``'s; one more iteration after the exit changes
    neither."""
    if step == "cg":
        _, pt, z0 = _elliptic_pair(40, 16)
        fp, kw = tpt.factorize(pt, 1e-6), dict(cg_tol=1e-12)
        z0 = torch.as_tensor(z0)
    else:
        _, pt = small_darcy()
        fp, kw = tpt.factorize(pt, 1e-3, solve_mode="trsm"), dict(cg_tol=1e-9, cg_maxiter=2000)
        z0 = pt.init_latent()
    reads = ReadCounter(monkeypatch)
    graphs.reset_counts()
    st, n = reads(lambda: tpt.gn_solve(fp, z0=z0, max_iter=2, step_solver=step, **kw))
    iters = st.cg_iters.tolist()
    assert all(i > 0 for i in iters)
    assert graphs.HOST_READS <= sum(iters) + len(iters)
    n_base = reads(lambda: tpt.gn_solve(fp, z0=z0, max_iter=2, step_solver="direct"))[1]
    assert n - n_base <= sum(iters) + len(iters) + 1
    system = tgn._cg_system if step == "cg" else tgn._woodbury_system
    op, B, M, _ = system(fp, z0, 0.0)
    eye = torch.eye(B.shape[0], dtype=B.dtype)
    H, Mm = op(eye), None if M is None else M(eye)
    Hj, Mj = jnp.asarray(H.numpy()), None if M is None else jnp.asarray(Mm.numpy())
    maxiter = kw.get("cg_maxiter", 500)
    X, it = tgn._batched_cg(lambda V: H @ V, B, kw["cg_tol"], maxiter,
                            M=None if M is None else (lambda V: Mm @ V))
    Xj, it_j = jgn._batched_cg(lambda V: Hj @ V, jnp.asarray(B.numpy()), kw["cg_tol"], maxiter,
                               M=None if M is None else (lambda V: Mj @ V))
    # the tolerances of test_batched_cg_and_woodbury_algebra and test_cg_matches_jax:
    # near convergence the count moves with the summation order
    assert abs(int(it) - int(it_j)) <= 2 and 0 < int(it) < maxiter
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=0, atol=1e-7 * _scale(Xj))
    st_ = tgn._CGState(op, B, kw["cg_tol"], M)
    while bool(st_.flag) and int(st_.iters) < maxiter:
        tgn._cg_iteration(st_, op, M)
    assert not bool(st_.flag)
    X1, R1, n1 = st_.X.clone(), st_.R.clone(), int(st_.iters)
    tgn._cg_iteration(st_, op, M)
    assert torch.equal(st_.X, X1) and torch.equal(st_.R, R1) and int(st_.iters) == n1


@pytest.mark.parametrize("step", ["structured", "cg"])
def test_mesh_update_reads_once_a_step(monkeypatch, step):
    """The mesh loop reads the host once a step (the damped update's
    halving test, agreed across ranks), besides its CG exit reads and its
    set-up: 2 and 5 steps differ by 3 reads for an exact step. Each call
    checks its structure (the verdict cache cleared), as the first solve
    of a layout does."""
    from test_torch_distributed import elliptic_pair

    _, pt = elliptic_pair()
    dfp = tdist.factorize_distributed(pt, MESH, nugget=1e-8, block=16, superblock_cols=32)
    reads = ReadCounter(monkeypatch)

    def solve(max_iter):
        _reuse.VERDICTS.clear()
        return tdist.gn_solve_distributed(dfp, max_iter=max_iter, step_solver=step)

    graphs.reset_counts()
    st2, n2 = reads(lambda: solve(2))
    reads2 = graphs.HOST_READS
    graphs.reset_counts()
    st5, n5 = reads(lambda: solve(5))
    it2, it5 = sum(st2.cg_iters.tolist()), sum(st5.cg_iters.tolist())
    assert n5 - n2 <= 3 + (it5 - it2) + 3
    if step == "structured":
        assert n5 - n2 == 3 and reads2 == 2 and graphs.HOST_READS == 5
    else:
        assert graphs.HOST_READS <= 5 + it5 + 5 + 1
    assert bool(st5.converged_finite)


def test_mesh_halving_matches_the_eager_ladder():
    """A step whose full step more than doubles the loss is halved (from
    the elliptic fixture's random start): the device-masked halvings keep
    the best finite trial, as the eager ladder picks it."""
    from test_torch_distributed import elliptic_pair

    _, pt = elliptic_pair()
    dfp = tdist.factorize_distributed(pt, MESH, nugget=1e-8, block=16, superblock_cols=32)
    z0 = torch.as_tensor(np.random.default_rng(3).standard_normal(pt.latent_dim))
    st = tdist.gn_solve_distributed(dfp, z0=z0, max_iter=1, step_solver="direct")
    delta = tdist._panel_delta(dfp, z0, None, 0.0)
    loss0 = dfp.loss(z0)
    trials = [(s, z0 - s * delta) for s in (1.0, 0.5, 0.25, 0.125, 0.0625)]
    losses = [float(dfp.loss(z)) for _, z in trials]
    assert losses[0] > 2.0 * float(loss0)  # the full step fails its test
    best = None
    for k, (s, z) in enumerate(trials):
        if best is None or losses[k] < losses[best]:
            best = k
        if not losses[best] > 2.0 * float(loss0):
            break
    torch.testing.assert_close(st.z, trials[best][1], rtol=0, atol=1e-12)
    assert float(st.losses[0]) == pytest.approx(losses[best], rel=1e-12)
