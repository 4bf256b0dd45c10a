"""The port's mesh path across ranks, on the CPU in f64: P gloo ranks
(``tests/torch_rank_worker.py``, torch only) against the JAX package's mesh
path at the same P on the conftest's virtual devices, against numpy, and
against the port at P = 1; the port twins of ``tests/test_parallel.py``
and ``tests/test_distributed_solver.py`` at P = 2, and P = 4 once.

One module fixture writes the inputs (numpy seeds, and the JAX package's
draws as numpy), starts the worker for P = 2 and then P = 4 in the
background, computes the JAX references meanwhile, and waits for it; the
tests compare. Tolerances: the assembly 1e-12, a factor 1e-8 (of the JAX
package's, whose panel arithmetic rounds differently), z 1e-7 of its scale
against the JAX package's (the Krylov steps' inner solves stop at their
tolerance), and 1e-10 between the port at P and at 1 (the same arithmetic
but for the triangular solves: panel loops against one ``solve_triangular``;
a Krylov step's inner CG amplifies that rounding up to its own tolerance, so
its z is held there at ten times ``cg_tol``). Replicated results (the
factor's ``diag_inv``, z, the losses) must be the same bits on every rank.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nonlinpdes_gpsolver_tpu as gpt
from nonlinpdes_gpsolver_tpu.parallel import cholesky as jchol
from nonlinpdes_gpsolver_tpu.parallel import fused as jfused
from nonlinpdes_gpsolver_tpu.parallel import gram as jgram
from nonlinpdes_gpsolver_tpu.parallel.mesh import make_mesh as jax_mesh
from nonlinpdes_gpsolver_tpu.solvers import distributed as jdist

import torch_rank_worker as W

TESTS = Path(__file__).resolve().parent


def _spd(n, seed):
    A = np.random.default_rng(seed).standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


def _u(x):
    return jnp.sin(jnp.pi * x[0]) * jnp.sin(jnp.pi * x[1])


def _rhs(x):
    return -jnp.trace(jax.hessian(_u)(x)) + _u(x) ** 3


def _jax_elliptic(key, n, nb, seed=1):
    """tests/test_distributed_solver.py's ``_elliptic_problem`` draw."""
    Xd, Xb = gpt.utils.sample_random(jax.random.PRNGKey(key), n, nb)
    return gpt.models.nonlinear_elliptic(gpt.SquaredExponential.gaussian(0.3), Xd, Xb, _rhs, _u,
                                         seed=seed)


def _as_inputs(prefix, pj):
    return {prefix + "Xd": np.asarray(pj.points["domain"]),
            prefix + "Xb": np.asarray(pj.points["boundary"]),
            prefix + "f": np.asarray(pj.data["f"]), prefix + "g": np.asarray(pj.data["g"]),
            prefix + "z0": np.asarray(pj.init_latent()),
            prefix + "inv_sq": np.asarray(pj.blocks[0].kernel.inv_sq)}


def _step_problems():
    """(name -> JAX problem, inputs): tests/test_torch_distributed.py's
    elliptic pair (numpy seed 0, 80/24, sigma 0.3, z0 = 0) and small Darcy
    (PRNGKey(2), 48/16, sigma 0.4, 12 observations, the seed-3 latent)."""
    rng = np.random.default_rng(0)
    Xd, Xb = rng.uniform(0, 1, (80, 2)), rng.uniform(0, 1, (24, 2))
    u = lambda X: np.sin(np.pi * X[:, 0]) * np.sin(np.pi * X[:, 1])  # noqa: E731
    f = 2 * np.pi**2 * u(Xd) + u(Xd) ** 3
    ell = gpt.models.nonlinear_elliptic(gpt.SquaredExponential.gaussian(0.3), jnp.asarray(Xd),
                                        jnp.asarray(Xb), jnp.asarray(f), jnp.asarray(u(Xb)),
                                        init="zero")
    Xd2, Xb2 = gpt.utils.sample_random(jax.random.PRNGKey(2), 48, 16)
    k = gpt.SquaredExponential.gaussian(0.4)
    obs = jnp.linspace(0.0, 0.01, 12)
    dar = gpt.models.darcy_flow(k, k, Xd2, Xb2, obs, rhs_f=lambda x: 1.0, noise_level=1e-2, seed=3)
    inp = {"dXd": np.asarray(Xd2), "dXb": np.asarray(Xb2), "df": np.asarray(dar.data["f"]),
           "dg": np.asarray(dar.data["g"]), "dobs": np.asarray(obs),
           "dz0": np.asarray(dar.init_latent()), "dinv_sq": np.asarray(k.inv_sq)}
    return {"elliptic": ell, "darcy": dar}, {**_as_inputs("s", ell), **inp}


def _inputs():
    inp = {f"spd{n}": _spd(n, n) for n, _ in W.CHOL}
    inp.update({f"spd_mc{n}": _spd(n, n + 1) for n, _, _ in W.MULTICHUNK})
    inp.update(spd100=_spd(100, 3), spd160=_spd(160, 7), spd96=_spd(96, 11), spd144=_spd(144, 13),
               spd128=_spd(128, 17), spd_mv100=_spd(100, 23))
    rng = np.random.default_rng(1)
    inp.update(V160=rng.standard_normal((160, 64)), v96=rng.standard_normal(96),
               V144=rng.standard_normal((144, 5)), v128=rng.standard_normal(128),
               v100=rng.standard_normal(100))
    inp.update({f"Vcols{m}": rng.standard_normal((144, m)) for m in (5, 16, 24)})
    ell = _jax_elliptic(0, 150, 40)
    inp.update(_as_inputs("e", ell))
    inp.update(_as_inputs("t", _jax_elliptic(0, 96, 32)))
    steps, step_inp = _step_problems()
    inp.update(step_inp)
    inp["post_Xt"] = np.asarray(gpt.utils.test_grid(13, 11))
    inp["post_z"] = np.asarray(jax.vmap(_u)(steps["elliptic"].points["domain"]))  # near z*
    # the escalation fixture: 30 points four times over (tests/test_torch_fused.py)
    srng = np.random.default_rng(0)
    sXd = np.concatenate([srng.uniform(0, 1, (30, 2))] * 4)
    sXb = srng.uniform(0, 1, (12, 2))
    dup = gpt.models.nonlinear_elliptic(gpt.SquaredExponential.gaussian(0.3), jnp.asarray(sXd),
                                        jnp.asarray(sXb), _rhs, _u, seed=1)
    inp.update(_as_inputs("q", dup))
    # the JAX package's P = 2 factor of the elliptic step problem, for the interop case
    jfp = jdist.factorize_distributed(steps["elliptic"], jax_mesh(2), nugget=W.NUGGET["elliptic"],
                                      **W.FACTOR_KW)
    jf = jfp.factors["u"]
    inp.update(jf_local=np.asarray(jf.local), jf_diag_inv=np.asarray(jf.diag_inv),
               jf_n=np.asarray(jf.n), jf_n_pad=np.asarray(jf.n_pad),
               jf_d=np.asarray(jfp.col_scales["u"]),
               jf_z=np.random.default_rng(3).standard_normal(steps["elliptic"].latent_dim))
    return inp, ell, steps, jfp


def _jax_references(inp, ell, steps, jfp2):
    """The JAX package's mesh path at P = 2 (and 4) on the same inputs."""
    ref = {}
    for P in (2, 4):
        mesh = jax_mesh(P)
        b = ell.blocks[0]
        if P == 2:
            arranged, d = jgram.assemble_gram_sharded(b.kernel, b.observables, ell.points, mesh,
                                                      block=16, nugget=1e-9)
            ref["gram"] = jchol.unshard_rows_blockcyclic(arranged, mesh, "p", 16,
                                                         arranged.shape[0] * 16)
            ref["d"] = np.asarray(d)
        fac, _, _, _ = jfused.assemble_factor_fused(b.kernel, b.observables, ell.points, mesh,
                                                    **W.FUSED_KW)
        ref[f"fused_P{P}"] = np.asarray(fac.dense())
        ref[f"fused_winvs_P{P}"] = np.asarray(fac.diag_inv)
    ref["chol_P4"] = np.asarray(jchol.cholesky_blockcyclic(inp["spd100"], jax_mesh(4),
                                                           block=16).dense())
    fac = jchol.cholesky_blockcyclic(inp["spd160"], jax_mesh(2), block=16)
    ref["trsm_Y64"] = np.asarray(jchol.trsm_blockcyclic(fac, inp["V160"]))
    ref["chol160_P2"] = np.asarray(fac.dense())
    for name, prob in steps.items():
        for P in (2, 4):
            solvers = W.SOLVERS[name] if P == 2 else ("structured", "cg")
            if P == 4 and name == "darcy":
                continue
            fp = jfp2 if (P, name) == (2, "elliptic") else jdist.factorize_distributed(
                prob, jax_mesh(P), nugget=W.NUGGET[name], **W.FACTOR_KW)
            for solver in solvers:
                st = jdist.gn_solve_distributed(fp, max_iter=3, step_solver=solver,
                                                **W.STEP_KW.get((name, solver), {}))
                ref[f"{name}_{solver}_P{P}"] = (np.asarray(st.z), np.asarray(st.losses))
    post = jdist.DistributedPosterior(jfp2, jnp.asarray(inp["post_z"]))
    Xt = jnp.asarray(inp["post_Xt"])
    ref["post"] = (np.asarray(post._weights["u"]), np.asarray(post.extend(Xt)),
                   np.asarray(post.variance(Xt)))
    two = _jax_elliptic(0, 96, 32)
    st = jdist.gn_solve_distributed(jdist.factorize_distributed(two, jax_mesh(2), nugget=1e-9,
                                                                block=16),
                                    max_iter=2, step_solver="structured")
    ref["two_process"] = (np.asarray(st.z), np.asarray(st.losses))
    ref["interop_r"] = np.asarray(jfp2.whitened_residual(jnp.asarray(inp["jf_z"])))
    return ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(per P: the ranks' outputs, the JAX references, the inputs)."""
    d = tmp_path_factory.mktemp("ranks")
    inp, ell, steps, jfp2 = _inputs()
    np.savez(d / "inputs.npz", **inp)
    worker = subprocess.Popen([sys.executable, str(TESTS / "torch_rank_worker.py"), str(d), "2,4"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ref = _jax_references(inp, ell, steps, jfp2)
        log, _ = worker.communicate(timeout=600)
    finally:
        if worker.poll() is None:
            worker.kill()
            worker.communicate()
    assert worker.returncode == 0, log[-6000:]
    out = {}
    for P in (2, 4):
        out[P] = []
        for r in range(P):
            with np.load(d / f"out_P{P}_rank{r}.npz") as npz:
                out[P].append({k: npz[k] for k in npz.files})
    return out, ref, inp


def _close(got, want, atol):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _replicated(outs, key):
    """A result every rank holds: the same bits on every rank."""
    for o in outs[1:]:
        np.testing.assert_array_equal(o[key], outs[0][key])
    return outs[0][key]


# -- twins of tests/test_parallel.py ---------------------------------------------------


@pytest.mark.parametrize("n,block", W.CHOL)
def test_distributed_cholesky_matches_dense(ranks, n, block):
    """The two-pass panel Cholesky at P = 2 against numpy's (1e-8 n, as the
    JAX test holds it), on every rank alike; the diagonal-block inverses
    replicated bit for bit."""
    out, _, inp = ranks
    L = _replicated(out[2], f"cholesky_dense/L{n}_{block}")
    _close(L, np.linalg.cholesky(inp[f"spd{n}"]), 1e-8 * n)
    W_ = _replicated(out[2], f"cholesky_dense/winvs{n}_{block}")
    nb = W_.shape[0]
    for k in range(min(nb, n // block)):
        blk = L[k * block : (k + 1) * block, k * block : (k + 1) * block]
        _close(W_[k] @ blk, np.eye(block), 1e-12)


@pytest.mark.parametrize("n,block,chunk_cols", W.MULTICHUNK)
def test_distributed_cholesky_multichunk(ranks, n, block, chunk_cols):
    """Several update chunks give the one-chunk factor to rounding (1e-10)
    and numpy's (1e-8 n)."""
    out, _, inp = ranks
    got = _replicated(out[2], f"cholesky_multichunk/L{n}_{block}_{chunk_cols}")
    ref = _replicated(out[2], f"cholesky_multichunk/ref{n}_{block}_{chunk_cols}")
    _close(got, np.linalg.cholesky(inp[f"spd_mc{n}"]), 1e-8 * n)
    _close(got, ref, 1e-10)


def test_distributed_cholesky_nondivisible_mesh(ranks):
    """P = 4 ranks on 100 rows of 16-row blocks: padded to 128, 2 slots a
    rank; numpy's factor (1e-6, as the JAX test) and the JAX package's at
    P = 4 (1e-8)."""
    out, ref, inp = ranks
    L = _replicated(out[4], "cholesky_nondivisible/L")
    _close(L, np.linalg.cholesky(inp["spd100"]), 1e-6)
    _close(L, ref["chol_P4"], 1e-8)
    assert out[4][0]["cholesky_nondivisible/local_shape"].tolist() == [2, 16, 128]


@pytest.mark.parametrize("m", [1, 7, 64])
def test_distributed_trsm_matches_dense(ranks, m):
    """The forward solve (owner computes, broadcasts y_k) against numpy
    (1e-8) and, at 64 columns, the JAX package's at P = 2 (1e-10)."""
    out, ref, inp = ranks
    Y = _replicated(out[2], f"trsm/Y{m}")
    L = np.linalg.cholesky(inp["spd160"])
    _close(Y, np.linalg.solve(L, inp["V160"][:, :m]), 1e-8)
    if m == 64:
        _close(Y, ref["trsm_Y64"], 1e-10)


def test_distributed_trsm_vector_rhs(ranks):
    out, _, inp = ranks
    y = _replicated(out[2], "trsm/y_vec")
    assert y.shape == (96,)
    _close(y, np.linalg.solve(np.linalg.cholesky(inp["spd96"]), inp["v96"]), 1e-8)


def test_distributed_trsm_transposed(ranks):
    """The transposed solve (each rank's rows, one psum a step)."""
    out, _, inp = ranks
    Y = _replicated(out[2], "trsm/Y_trans")
    _close(Y, np.linalg.solve(np.linalg.cholesky(inp["spd144"]).T, inp["V144"]), 1e-8)


def test_distributed_kernel_solve(ranks):
    out, _, inp = ranks
    w = _replicated(out[2], "trsm/w_kernel")
    _close(w, np.linalg.solve(inp["spd128"], inp["v128"]), 1e-7)


@pytest.mark.parametrize("m", [5, 16, 24])
def test_trsm_column_sharded_matches_replicated(ranks, m):
    """Column-sharded right-hand sides (each rank its own columns, per-rank
    memory n m / P) in both directions, an odd m included."""
    out, _, inp = ranks
    L = np.linalg.cholesky(inp["spd144"])
    V = inp[f"Vcols{m}"]
    for trans in (0, 1):
        ref = np.linalg.solve(L.T if trans else L, V)
        for r, o in enumerate(out[2]):
            _close(o[f"trsm/cols{m}_{trans}"], ref[:, r::2], 1e-8)


def test_matvec_blockcyclic(ranks):
    """``A v`` from a row-sharded matrix (each rank 56 of the 112 padded
    rows) and ``L^T v`` from a factor's shard (1e-10)."""
    out, _, inp = ranks
    A, v = inp["spd_mv100"], inp["v100"]
    _close(_replicated(out[2], "matvec/Av"), A @ v, 1e-10)
    _close(_replicated(out[2], "matvec/Ltv"), np.linalg.cholesky(A).T @ v, 1e-10)
    assert out[2][1]["matvec/shard_rows"].tolist() == [7, 8, 112]


# -- the mesh path: assembly and the fused factor ----------------------------------------


def test_sharded_assembly_matches_jax(ranks):
    """Each rank's K2 launch (the rank-mapped plan's plain version here)
    writes its block-cyclic rows: gathered, the JAX package's P = 2
    assembly within 1e-12, the padding tail an exact identity."""
    out, ref, _ = ranks
    got = _replicated(out[2], "assembly_and_fused/gram")
    _close(got, ref["gram"], 1e-12)
    _close(_replicated(out[2], "assembly_and_fused/d"), ref["d"], 1e-14)
    n = 340
    tail = got[n:]
    want = np.zeros_like(tail)
    want[:, n:] = np.eye(tail.shape[0])
    np.testing.assert_array_equal(tail, want)
    np.testing.assert_array_equal(got[:n, n:], 0.0)


@pytest.mark.parametrize("P", [2, 4])
def test_fused_factor_matches_jax_and_one_rank(ranks, P):
    """The fused factor across P ranks (superblocks of 3 blocks, 2-block
    update chunks, the last superblock ragged; at P = 4 the last superblock
    leaves one rank without rows) against the JAX package's at the same P
    (1e-8, at nugget 1e-6: at 1e-9 the port's factor on one device already
    differs from the JAX package's by 1.3e-7, the conditioning of the
    rounding) and the port's on one device (1e-10); ``diag_inv`` the same
    bits on every rank, and the one-device one's to 1e-10."""
    out, ref, _ = ranks
    L = _replicated(out[P], "assembly_and_fused/L")
    _close(L, ref[f"fused_P{P}"], 1e-8)
    _close(L, _replicated(out[P], "assembly_and_fused/L1"), 1e-10)
    winvs = _replicated(out[P], "assembly_and_fused/winvs")
    _close(winvs, ref[f"fused_winvs_P{P}"], 1e-8 * np.abs(winvs).max())
    one = _replicated(out[P], "assembly_and_fused/winvs1")  # fewer padding blocks
    _close(winvs[: len(one)], one, 1e-10 * np.abs(winvs).max())
    assert int(out[P][0]["assembly_and_fused/attempts"]) == 1
    assert out[P][0]["assembly_and_fused/local_shape"].tolist() == [22 // P if P == 2 else 6, 16,
                                                                    352 if P == 2 else 384]


# -- the Gauss-Newton steps (tests/test_distributed_solver.py) -----------------------------


STEP_CASES = ([("elliptic", s, 2) for s in W.SOLVERS["elliptic"]]
              + [("darcy", s, 2) for s in W.SOLVERS["darcy"]]
              + [("elliptic", s, 4) for s in ("structured", "cg")])


@pytest.mark.parametrize("name,solver,P", STEP_CASES)
def test_step_solvers_across_ranks(ranks, name, solver, P):
    """3 GN steps of each step solver at P ranks: z the same bits on every
    rank, within 1e-7 of its scale of the JAX package's at the same P and
    1e-10 of the port's on one device (a Krylov step: ten times its
    ``cg_tol``); the losses to rtol 1e-6 of both (1e-10 of the one-device
    run for the exact steps); no rung."""
    out, ref, _ = ranks
    key = "steps_elliptic_4" if P == 4 else f"steps_{name}"
    z = _replicated(out[P], f"{key}/z_{solver}_P{P}")
    losses = _replicated(out[P], f"{key}/losses_{solver}_P{P}")
    z1 = out[P][0][f"{key}/z_{solver}_P1"]
    zj, lj = ref[f"{name}_{solver}_P{P}"]
    scale = np.abs(zj).max()
    _close(z, zj, 1e-7 * scale)
    np.testing.assert_allclose(losses, lj, rtol=1e-6)
    krylov = solver in ("cg", "woodbury")
    cg_tol = W.STEP_KW.get((name, solver), {}).get("cg_tol", 1e-10)
    _close(z, z1, (10 * cg_tol if krylov else 1e-10) * scale)
    np.testing.assert_allclose(losses, out[P][0][f"{key}/losses_{solver}_P1"],
                               rtol=1e-6 if krylov else 1e-10)
    assert bool(out[P][0][f"{key}/finite_{solver}_P{P}"])
    assert int(out[P][0][f"{key}/rungs"]) == 0
    iters = out[P][0][f"{key}/iters_{solver}_P{P}"]
    assert (iters > 0).all() if solver in ("cg", "woodbury") else not iters.any()


@pytest.mark.parametrize("name", ["elliptic", "darcy"])
def test_step_solvers_match_direct_across_ranks(ranks, name):
    """Every step solver at P = 2 against the 'direct' step at P = 2, 1e-6
    of z's scale (the Krylov steps to their inner tolerance)."""
    out, _, _ = ranks
    o = out[2][0]
    zd = o[f"steps_{name}/z_direct_P2"]
    for solver in W.SOLVERS[name]:
        _close(o[f"steps_{name}/z_{solver}_P2"], zd, 1e-6 * np.abs(zd).max())


@pytest.mark.parametrize("name", ["elliptic", "darcy"])
def test_normal_state_routes_by_mesh_size(ranks, name):
    """The 'normal' step's state (``ops/graphs.py::NORMAL_STATES``): across
    two ranks by the column-sharded kernel solves, on every rank, and on a
    one-device mesh in ``potri``'s order; once a factorization, and no state
    for the other step solvers."""
    out, _, _ = ranks
    for solver in W.SOLVERS[name]:
        want = {"P2": [0, 1], "P1": [1, 0]} if solver == "normal" else {"P2": [0, 0], "P1": [0, 0]}
        for tag, counts in want.items():
            got = _replicated(out[2], f"steps_{name}/states_{solver}_{tag}")
            assert got.tolist() == counts, (solver, tag, got)


def test_posterior_and_variance_across_ranks(ranks):
    """DistributedPosterior at P = 2 at the same z (the truth at the
    collocation points): the weights (1e-6 of their scale), the extension
    (1e-8) and the variance (1e-9) against the JAX package's at P = 2, and
    within 1e-10 of the one-device port's (the weights, one kernel solve of
    the ill-conditioned system at nugget 1e-8, 1e-9); the test points
    sharded and gathered back to every rank alike."""
    out, ref, _ = ranks
    w_j, e_j, v_j = ref["post"]
    w = _replicated(out[2], "posterior/w_P2")
    e = _replicated(out[2], "posterior/ext_P2")
    v = _replicated(out[2], "posterior/var_P2")
    o = out[2][0]
    _close(w, w_j, 1e-6 * np.abs(w_j).max())
    _close(e, e_j, 1e-8 * np.abs(e_j).max())
    _close(v, v_j, 1e-9)
    assert e.shape == v.shape == (143,) and (v >= 0).all()
    _close(w, o["posterior/w_P1"], 1e-9 * np.abs(w).max())
    _close(e, o["posterior/ext_P1"], 1e-10 * np.abs(e).max())
    _close(v, o["posterior/var_P1"], 1e-10)


@pytest.mark.parametrize("failure", W.ESCALATIONS)
def test_factorize_escalates_when_one_rank_fails(ranks, failure):
    """A failure that only rank 1 sees (its superblock Cholesky, its probe
    rows, its two-pass diagonal block) is agreed across the ranks: both take
    one tenfold rung (two attempts), both hold the factor that a start at
    that rung gives, and it whitens to finite values."""
    out, _, _ = ranks
    assert float(_replicated(out[2], f"escalation/{failure}/scale")) == 10.0
    assert int(_replicated(out[2], f"escalation/{failure}/rungs")) == 1
    assert int(_replicated(out[2], f"escalation/{failure}/attempts")) == 2
    L = _replicated(out[2], f"escalation/{failure}/L")
    np.testing.assert_array_equal(L, out[2][0][f"escalation/{failure}/want"])
    assert bool(_replicated(out[2], f"escalation/{failure}/finite"))


def test_gpsolver_facade_across_ranks(ranks):
    """GPSolver(mesh=make_mesh(2)) end to end: the 2-rank z and extension
    within 1e-10 of the one-device mesh's, a DistributedPosterior, and the
    extension within the JAX facade test's 1e-3 of the truth."""
    out, _, inp = ranks
    o = out[2][0]
    z = _replicated(out[2], "facade/z_P2")
    ext = _replicated(out[2], "facade/ext_P2")
    _close(z, o["facade/z_P1"], 1e-10 * np.abs(z).max())
    _close(ext, o["facade/ext_P1"], 1e-10 * np.abs(ext).max())
    assert str(o["facade/posterior_P2"]) == "DistributedPosterior"
    Xt = inp["post_Xt"]
    truth = np.sin(np.pi * Xt[:, 0]) * np.sin(np.pi * Xt[:, 1])
    assert np.sqrt(np.mean((ext - truth) ** 2)) < 1e-3


def test_two_process_distributed_solve(ranks):
    """The JAX package's two-process program (factorize, 2 structured
    steps on 96/32 points at nugget 1e-9) run by two torch ranks. The JAX
    test holds its two processes to its one-process P = 2 program at 1e-8,
    the same arithmetic; here the two ranks are held to the port's
    one-device run at 1e-10 of z's scale (losses rtol 1e-10), and to the JAX
    P = 2 program at 1e-6 of z's scale (losses, which reach 1e11 at this
    nugget, rtol 1e-5): at nugget 1e-9 the two packages' rounding parts z by
    1.9e-6 (1.8e-7 of its scale) on one device already, as much as at
    P = 2."""
    out, ref, _ = ranks
    zj, lj = ref["two_process"]
    z = _replicated(out[2], "two_process_solve/z_P2")
    losses = _replicated(out[2], "two_process_solve/losses_P2")
    scale = np.abs(zj).max()
    _close(z, out[2][0]["two_process_solve/z_P1"], 1e-10 * scale)
    np.testing.assert_allclose(losses, out[2][0]["two_process_solve/losses_P1"], rtol=1e-10)
    _close(z, zj, 1e-6 * scale)
    np.testing.assert_allclose(losses, lj, rtol=1e-5)


def test_jax_factor_dealt_to_ranks(ranks):
    """interop.factor_from_numpy deals the JAX package's P = 2 factor to the
    port's two ranks (rank p takes the JAX device p's slots): the whitened
    residual within 1e-12 of the JAX package's."""
    out, ref, inp = ranks
    nbl = inp["jf_local"].shape[0] // 2
    for r, o in enumerate(out[2]):
        np.testing.assert_array_equal(o["interop/local"], inp["jf_local"][r * nbl : (r + 1) * nbl])
    r_ref = ref["interop_r"]
    _close(_replicated(out[2], "interop/r"), r_ref, 1e-12 * np.abs(r_ref).max())


# -- the loop's agreements and its sharing across ranks ------------------------------------


@pytest.mark.parametrize("solver", ["structured", "cg"])
def test_mesh_loop_makes_no_host_agreement_a_step(ranks, solver):
    """At P = 2 the loop's step code and the CG exit flag are agreed on the
    device, inside the step: a solve makes one host agreement, the route's
    structure verdict, whether it takes 1 step or 3 (the host agreed each
    step's code and each CG iteration's exit flag before)."""
    out, _, _ = ranks
    for steps in (1, 3):
        assert int(_replicated(out[2], f"shared_loop/agreements_{solver}_{steps}")) == 1


def test_second_problem_rebinds_on_every_rank(ranks):
    """gloo ranks on the CPU form layout keys: a second problem of the
    layout, after the first is gone, factors into the first one's storage
    on both ranks (no entry made, one rebound, none unshared), and its
    solution and losses are the bits of the same problem solved unshared
    (``_reuse._unshared()``), the same on both ranks."""
    out, _, _ = ranks
    for o in out[2]:
        assert o["shared_loop/second/binds"].tolist() == [0, 1, 0]
        assert bool(o["shared_loop/second/in_entry"])
    z = _replicated(out[2], "shared_loop/second/z")
    np.testing.assert_array_equal(z, _replicated(out[2], "shared_loop/unshared/z"))
    np.testing.assert_array_equal(_replicated(out[2], "shared_loop/second/losses"),
                                  _replicated(out[2], "shared_loop/unshared/losses"))


def test_storage_held_on_one_rank_makes_new_entries_on_all(ranks):
    """Rank 1 alone holds a piece of a released factor: its entry is not
    free there, and the ranks' agreement makes both make a new entry for
    the next problem (a rank that rebinds while another makes an entry
    would record other graphs and collectives than it)."""
    out, _, _ = ranks
    for o in out[2]:
        assert o["shared_loop/held/binds"].tolist() == [1, 0, 0]


def test_third_live_problem_is_a_guest_on_every_rank(ranks):
    """Three live mesh problems of one layout at P = 2, every one kept: the
    first two make an entry each and the third is a guest on both ranks
    (the ranks agree on it), its factors its own; its first solve loads
    it into the guest entry, one more host agreement than a bound
    problem's solve (the guest entry, agreed once); its solution and
    losses are the bits of the same problem solved unshared, the same on
    both ranks, and so is its next solve, which copies nothing."""
    out, _, _ = ranks
    for o in out[2]:
        assert [o[f"sweep/binds{k}"].tolist() for k in range(3)] == [
            [1, 0, 0, 0], [1, 0, 0, 0], [0, 0, 0, 1]]
        assert [int(o[f"sweep/loads{k}"]) for k in range(3)] == [0, 0, 1]
        assert int(o["sweep/agreements2"]) == int(o["sweep/agreements0"]) + 1
        assert not bool(o["sweep/guest/bound"]) and not bool(o["sweep/guest/in_entry"])
        assert int(o["sweep/again/loads"]) == 0 and int(o["sweep/entries"]) == 3
    z = _replicated(out[2], "sweep/guest/z")
    np.testing.assert_array_equal(z, _replicated(out[2], "sweep/unshared/z"))
    np.testing.assert_array_equal(z, _replicated(out[2], "sweep/again/z"))
    np.testing.assert_array_equal(_replicated(out[2], "sweep/guest/losses"),
                                  _replicated(out[2], "sweep/unshared/losses"))


def test_ranks_that_disagree_on_the_guest_entry_make_a_new_one(ranks):
    """Rank 0 keeps a released guest entry that rank 1 has dropped: the
    next guest's first solve finds the ranks disagree on the layout's guest
    entry (its stamp), so rank 0 drops its own and both make a new one, and
    the guest's solve is the bits of its unshared solve on both ranks."""
    out, _, _ = ranks
    assert [int(o["sweep/disagree/kept"]) for o in out[2]] == [1, 0]
    for o in out[2]:
        assert bool(o["sweep/disagree/new"]) and int(o["sweep/disagree/hosting"]) == 1
    np.testing.assert_array_equal(_replicated(out[2], "sweep/disagree/z"),
                                  _replicated(out[2], "sweep/disagree/unshared_z"))
