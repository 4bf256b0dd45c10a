"""The port's checkpoint and FLOP model against the JAX package's, on the CPU in f64.

Twins of ``tests/test_checkpoint.py`` (the round trip with resume, the size
refusal, ``flop_model`` sane, the distributed round trip), a name refusal,
``flop_model`` equal to the JAX package's, and the files crossing packages
both ways: a JAX-saved dense file and an 8-device distributed file reloaded
in the port (at P = 1 here and on 2 gloo ranks), and port-saved files
reloaded by the JAX loader. Across ranks, ``tests/torch_rank_worker.py``
(group ``checkpoint``) saves at P = 4 and reloads at P = 2; this process
reloads the same file at P = 1.

Tolerances: a factor and z round-trip bitwise (the same f64 arrays); the
whitened residuals agree within 1e-8 of their scale between the packages
(the factor tolerance of ``tests/test_torch_linalg.py`` and the JAX test:
a JAX file holds no diagonal-block inverses, the JAX loader ignores the
port's, so they are rebuilt on load, and the two packages' solves round
differently), and within 1e-10 between the port at P = 4, 2 and 1 (the
same factor; panel loops against one ``solve_triangular``); a port file
reloaded by the port at P = 1 is bitwise.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinpdes_gpsolver_tpu as gpt
from nonlinpdes_gpsolver_tpu.parallel import make_mesh as jax_mesh
from nonlinpdes_gpsolver_tpu.solvers import distributed as jdist
from nonlinpdes_gpsolver_tpu.solvers import factorize as jfactorize
from nonlinpdes_gpsolver_tpu.solvers import gn_solve as jgn_solve
from nonlinpdes_gpsolver_tpu.utils import checkpoint as jck
from nonlinpdes_gpsolver_tpu.utils.profiling import flop_model as jflop_model

import nonlinpdes_gpsolver_tpu_torch as tpt
from nonlinpdes_gpsolver_tpu_torch.parallel import make_mesh
from nonlinpdes_gpsolver_tpu_torch.solvers import distributed as tdist
from nonlinpdes_gpsolver_tpu_torch.utils import checkpoint as tck
from nonlinpdes_gpsolver_tpu_torch.utils.profiling import flop_model
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_time_limit import limited, time_limit  # noqa: F401  (autouse fixture)


TESTS = Path(__file__).resolve().parent
MESH1 = make_mesh(1, device="cpu")


def _u(x):
    return torch.sin(torch.pi * x[0]) * torch.sin(torch.pi * x[1])


def _rhs(x):
    return -torch.trace(torch.func.hessian(_u)(x)) + _u(x) ** 3


def _problem(N=80, Nb=24, seed=0):
    """``tests/test_checkpoint.py``'s problem on the port's sampler."""
    Xd, Xb = tpt.utils.sample_random(torch.Generator().manual_seed(seed), N, Nb)
    k = tpt.SquaredExponential.gaussian(0.3)
    return tpt.models.nonlinear_elliptic(k, Xd, Xb, _rhs, _u, seed=1)


def _jax_problem(N=80, Nb=24, seed=0):
    """``tests/test_checkpoint.py``'s ``_problem``, and the port's problem on
    its arrays (points, f, g, z0) as numpy."""

    def u(x):
        return jnp.sin(jnp.pi * x[0]) * jnp.sin(jnp.pi * x[1])

    def rhs(x):
        return -jnp.trace(jax.hessian(u)(x)) + u(x) ** 3

    Xd, Xb = gpt.utils.sample_random(jax.random.PRNGKey(seed), N, Nb)
    k = gpt.SquaredExponential.gaussian(0.3)
    pj = gpt.models.nonlinear_elliptic(k, Xd, Xb, rhs, u, seed=1)
    arrays = {"Xd": np.asarray(Xd), "Xb": np.asarray(Xb), "f": np.asarray(pj.data["f"]),
              "g": np.asarray(pj.data["g"]), "z0": np.asarray(pj.init_latent()),
              "inv_sq": np.asarray(k.inv_sq)}
    pt = tpt.interop.problem_from_numpy(*arrays.values(), device="cpu")
    return pj, pt, arrays


def _close_to_scale(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


# -- twins of tests/test_checkpoint.py -----------------------------------------------


def test_checkpoint_roundtrip_and_resume(tmp_path):
    prob = _problem()
    fp = tpt.factorize(prob, nugget=1e-10)
    st = tpt.gn_solve(fp, max_iter=2)
    ckpt = tmp_path / "solve.npz"
    tck.save_solver_state(ckpt, fp, st)

    fp2, st2 = tck.load_solver_state(ckpt, prob)
    assert torch.equal(fp2.factors["u"], fp.factors["u"])
    assert torch.equal(fp2.col_scales["u"], fp.col_scales["u"])
    assert torch.equal(st2.z, st.z) and torch.equal(st2.losses, st.losses)
    assert fp2.nugget_scales == fp.nugget_scales and fp2.rungs == fp.rungs
    assert st2.cg_iters.tolist() == [0, 0] and bool(st2.converged_finite)

    # resuming from the checkpointed iterate must continue the descent
    st3 = tpt.gn_solve(fp2, z0=st2.z, max_iter=2)
    assert float(st3.losses[-1]) <= float(st2.losses[-1]) * 1.01

    # posterior from restored factors matches
    p1 = tpt.Posterior(fp, st.z).extend(prob.points["domain"][:5])
    p2 = tpt.Posterior(fp2, st2.z).extend(prob.points["domain"][:5])
    np.testing.assert_allclose(p2.numpy(), p1.numpy(), rtol=1e-12)


def test_checkpoint_rejects_mismatched_problem(tmp_path):
    prob = _problem()
    fp = tpt.factorize(prob, nugget=1e-10)
    ckpt = tmp_path / "solve.npz"
    tck.save_solver_state(ckpt, fp)
    with pytest.raises(ValueError, match="size"):
        tck.load_solver_state(ckpt, _problem(N=60))  # different size


def test_checkpoint_rejects_other_problem(tmp_path):
    """A file of the elliptic problem does not load into an Eikonal one, on
    either path."""
    prob = _problem()
    tck.save_solver_state(tmp_path / "dense.npz", tpt.factorize(prob, nugget=1e-10))
    tck.save_distributed_state(tmp_path / "mesh.npz",
                               tdist.factorize_distributed(prob, MESH1, nugget=1e-9, block=8))
    Xd, Xb = prob.points["domain"], prob.points["boundary"]
    other = tpt.models.eikonal(tpt.SquaredExponential.gaussian(0.3), Xd, Xb,
                               lambda x: torch.ones_like(x[0]))
    with pytest.raises(ValueError, match="'nonlinear_elliptic', got 'eikonal'"):
        tck.load_solver_state(tmp_path / "dense.npz", other)
    with pytest.raises(ValueError, match="'nonlinear_elliptic', got 'eikonal'"):
        tck.load_distributed_state(tmp_path / "mesh.npz", other, MESH1)
    with pytest.raises(ValueError, match="not a distributed checkpoint"):
        tck.load_distributed_state(tmp_path / "dense.npz", prob, MESH1)


def test_flop_model_sane():
    fm = flop_model(_problem(), gn_iters=4)
    n = 2 * 80 + 24
    assert abs(fm["cholesky"] - n**3 / 3) < 1e-6 * n**3
    assert fm["total"] > fm["cholesky"]


def test_flop_model_matches_jax():
    """The same counts as the JAX package's model on the same problem, for a
    one-block and a two-block (Darcy) problem."""
    pj, pt, _ = _jax_problem()
    assert flop_model(pt, gn_iters=3) == jflop_model(pj, gn_iters=3)
    d = tpt.interop.load_inputs("darcy")
    k = gpt.SquaredExponential.gaussian(0.2)
    dj = gpt.models.darcy_flow(k, k, jnp.asarray(d["X_domain"]), jnp.asarray(d["X_boundary"]),
                               jnp.asarray(d["obs"]), rhs_f=lambda x: 1.0, noise_level=1e-3)
    dt = tpt.interop.darcy_from_numpy(**d, device="cpu")
    assert flop_model(dt) == jflop_model(dj)
    assert tpt.utils.tflops(2e12, 2.0) == 1.0


def test_distributed_checkpoint_roundtrip(tmp_path):
    """The mesh path's factor round-trips at P = 1: z, the factor and its
    diagonal-block inverses bitwise (the file holds them), the nugget scales
    and rungs, and the whitened residual bitwise the original's. The saved
    inverses are moved one unit in the last place off what inverting the
    factor's blocks gives (here, in f64, the fused factorization's own are
    those bits), so that only the file can give them back."""
    prob = _problem()
    dfp = tdist.factorize_distributed(prob, MESH1, nugget=1e-9, block=8)
    W = dfp.factors["u"].diag_inv
    W.copy_(torch.nextafter(W, torch.full_like(W, float("inf"))))
    st = tdist.gn_solve_distributed(dfp, max_iter=2)
    ckpt = tmp_path / "dist.npz"
    tck.save_distributed_state(ckpt, dfp, st)

    dfp2, st2 = tck.load_distributed_state(ckpt, prob, MESH1)
    assert torch.equal(st2.z, st.z)
    assert torch.equal(dfp2.factors["u"].local, dfp.factors["u"].local)
    assert torch.equal(dfp2.factors["u"].diag_inv, dfp.factors["u"].diag_inv)
    assert dfp2.nugget_scales == dfp.nugget_scales and dfp2.rungs == dfp.rungs
    assert torch.equal(dfp2.whitened_residual(st2.z), dfp.whitened_residual(st.z))
    st3 = tdist.gn_solve_distributed(dfp2, z0=st2.z, max_iter=1)
    assert float(st3.losses[-1]) <= float(st2.losses[-1]) * 1.01


def test_distributed_checkpoint_without_inverses_rebuilds_them(tmp_path):
    """A mesh file without ``diag_inv__{block}`` (as the JAX package writes
    them) loads with the inverses rebuilt from the factor, row-major: within
    1e-10 of the saved ones and the whitened residual within 1e-10 of the
    original's."""
    prob = _problem()
    dfp = tdist.factorize_distributed(prob, MESH1, nugget=1e-9, block=8)
    st = tdist.gn_solve_distributed(dfp, max_iter=2)
    tck.save_distributed_state(tmp_path / "full.npz", dfp, st)
    with np.load(tmp_path / "full.npz") as data:
        assert data["diag_inv__u"].shape == tuple(dfp.factors["u"].diag_inv.shape)
        np.savez(tmp_path / "bare.npz", **{k: data[k] for k in data.files if k != "diag_inv__u"})

    dfp2, st2 = tck.load_distributed_state(tmp_path / "bare.npz", prob, MESH1)
    assert torch.equal(st2.z, st.z)
    assert dfp2.factors["u"].diag_inv.is_contiguous()
    _close_to_scale(dfp2.factors["u"].diag_inv, dfp.factors["u"].diag_inv, 1e-10)
    _close_to_scale(dfp2.whitened_residual(st2.z), dfp.whitened_residual(st.z), 1e-10)


# -- across packages -------------------------------------------------------------------


def test_jax_dense_file_loads_in_port(tmp_path):
    """A JAX-saved dense file (factor, column scales, 2 GN steps) in the port:
    the factor and z bitwise, the whitened residual within 1e-8 of the JAX
    package's, ``cg_iters`` zeros and the rungs from the scales."""
    pj, pt, _ = _jax_problem()
    fj = jfactorize(pj, nugget=1e-10)
    sj = jgn_solve(fj, max_iter=2)
    ckpt = tmp_path / "jax.npz"
    jck.save_solver_state(ckpt, fj, sj)

    fp, st = tck.load_solver_state(ckpt, pt)
    np.testing.assert_array_equal(fp.factors["u"].numpy(), np.asarray(fj.factors["u"]))
    np.testing.assert_array_equal(st.z.numpy(), np.asarray(sj.z))
    assert st.cg_iters.tolist() == [0, 0]
    assert fp.rungs == {"u": round(np.log10(fj.nugget_scales["u"]))}
    _close_to_scale(fp.whitened_residual(st.z), fj.whitened_residual(sj.z), 1e-8)


def test_port_dense_file_loads_in_jax(tmp_path):
    pj, pt, _ = _jax_problem()
    fp = tpt.factorize(pt, nugget=1e-10)
    st = tpt.gn_solve(fp, max_iter=2)
    ckpt = tmp_path / "port.npz"
    tck.save_solver_state(ckpt, fp, st)

    fj, sj = jck.load_solver_state(ckpt, pj)
    np.testing.assert_array_equal(np.asarray(fj.factors["u"]), fp.factors["u"].numpy())
    np.testing.assert_array_equal(np.asarray(sj.z), st.z.numpy())
    _close_to_scale(fj.whitened_residual(sj.z), fp.whitened_residual(st.z), 1e-8)


def _jax_eight_device_file(path):
    """The JAX package's 8-device mesh factor of ``_jax_problem`` (nugget
    1e-9, 8-row blocks) and 2 GN steps, saved; returns the whitened residual
    at its z."""
    pj, _, _ = _jax_problem()
    dfp = jdist.factorize_distributed(pj, jax_mesh(8), nugget=1e-9, block=8)
    st = jdist.gn_solve_distributed(dfp, max_iter=2)
    jck.save_distributed_state(path, dfp, st)
    return np.asarray(dfp.whitened_residual(st.z)), np.asarray(st.z)


def test_jax_distributed_file_loads_in_port(tmp_path, eight_devices):
    """The JAX package's 8-device file reloaded at P = 1: z bitwise, the
    factor in natural row order, the whitened residual within 1e-8."""
    r_jax, z_jax = _jax_eight_device_file(tmp_path / "jax8.npz")
    _, pt, _ = _jax_problem()
    dfp, st = tck.load_distributed_state(tmp_path / "jax8.npz", pt, MESH1)
    np.testing.assert_array_equal(st.z.numpy(), z_jax)
    assert dfp.factors["u"].local.shape == (24, 8, 192)
    _close_to_scale(dfp.whitened_residual(st.z), r_jax, 1e-8)


def test_port_distributed_file_loads_in_jax(tmp_path, eight_devices):
    """A port file saved at P = 1 (23 blocks of 8 rows) reloaded by the JAX
    loader on one device."""
    pj, pt, _ = _jax_problem()
    dfp = tdist.factorize_distributed(pt, MESH1, nugget=1e-9, block=8)
    st = tdist.gn_solve_distributed(dfp, max_iter=2)
    tck.save_distributed_state(tmp_path / "port1.npz", dfp, st)
    dj, sj = jck.load_distributed_state(tmp_path / "port1.npz", pj, jax_mesh(1))
    np.testing.assert_array_equal(np.asarray(sj.z), st.z.numpy())
    _close_to_scale(dj.whitened_residual(sj.z), dfp.whitened_residual(st.z), 1e-8)


def test_distributed_checkpoint_refuses_undealable_mesh(tmp_path):
    """24 block rows do not deal to 5 ranks (the JAX loader's refusal)."""
    _, pt, _ = _jax_problem()
    tck.save_distributed_state(tmp_path / "d.npz",
                               tdist.factorize_distributed(pt, MESH1, nugget=1e-9, block=8))
    with np.load(tmp_path / "d.npz") as data:
        saved = data["factor_local__u"]
    mesh5 = tpt.parallel.Mesh(torch.device("cpu"), size=5, rank=0)
    with pytest.raises(ValueError, match="do not deal to 5 ranks"):
        tpt.parallel.cholesky.deal_saved_blocks(saved, 1, mesh5)


# -- across ranks ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, eight_devices):
    """The worker's outputs at P = 4 (save) and P = 2 (reload), the JAX
    8-device file's residual and z, and the directory holding the files."""
    with limited("the checkpoint ranks fixture"):
        d = tmp_path_factory.mktemp("ckpt_ranks")
        _, _, arrays = _jax_problem()
        np.savez(d / "inputs.npz", **{"k" + k: v for k, v in arrays.items()})
        r_jax, z_jax = _jax_eight_device_file(d / "jax_P8.npz")
        log = subprocess.run([sys.executable, str(TESTS / "torch_rank_worker.py"), str(d), "4,2",
                              "checkpoint"], capture_output=True, text=True, timeout=300)
        assert log.returncode == 0, (log.stdout + log.stderr)[-6000:]
    out = {}
    for P in (4, 2):
        out[P] = []
        for r in range(P):
            with np.load(d / f"out_P{P}_rank{r}.npz") as npz:
                out[P].append({k: npz[k] for k in npz.files})
    return out, (r_jax, z_jax), d


def _replicated(outs, key):
    for o in outs[1:]:
        np.testing.assert_array_equal(o[key], outs[0][key])
    return outs[0][key]


def test_distributed_checkpoint_across_ranks(ranks):
    """Saved at P = 4, reloaded at P = 2 on ranks and at P = 1 here: z
    bitwise, every rank's shard the saved factor's blocks, the whitened
    residual within 1e-10 of the P = 4 run's, and a resumed step that keeps
    the loss down."""
    out, _, d = ranks
    z4 = _replicated(out[4], "checkpoint_save/z")
    r4 = _replicated(out[4], "checkpoint_save/r")
    _, pt, _ = _jax_problem()
    dfp1, st1 = tck.load_distributed_state(d / "port_P4.npz", pt, MESH1)
    np.testing.assert_array_equal(st1.z.numpy(), z4)
    # global block g = j P + p is rank p's slot j at P = 4, and row block g at P = 1
    natural = dfp1.factors["u"].local.numpy()
    for p, o in enumerate(out[4]):
        np.testing.assert_array_equal(o["checkpoint_save/local"], natural[p::4])
    for p, o in enumerate(out[2]):
        np.testing.assert_array_equal(o["checkpoint_load/port_P4/local"], natural[p::2])
    np.testing.assert_array_equal(_replicated(out[2], "checkpoint_load/port_P4/z"), z4)
    _close_to_scale(dfp1.whitened_residual(st1.z), r4, 1e-10)
    _close_to_scale(_replicated(out[2], "checkpoint_load/port_P4/r"), r4, 1e-10)
    _close_to_scale(_replicated(out[2], "checkpoint_load/port_P4/diag_inv"),
                    _replicated(out[4], "checkpoint_save/diag_inv"), 1e-10)
    resumed = _replicated(out[2], "checkpoint_load/resume/losses")
    assert resumed[-1] <= float(r4 @ r4) * 1.01


def test_jax_distributed_file_loads_on_ranks(ranks):
    """The JAX package's 8-device file at P = 2: z bitwise and the whitened
    residual within 1e-8 of the JAX package's."""
    out, (r_jax, z_jax), _ = ranks
    np.testing.assert_array_equal(_replicated(out[2], "checkpoint_load/jax_P8/z"), z_jax)
    _close_to_scale(_replicated(out[2], "checkpoint_load/jax_P8/r"), r_jax, 1e-8)


def test_port_rank_file_loads_in_jax(ranks):
    """The port's P = 4 file reloaded by the JAX loader on 4 and 2 devices."""
    out, _, d = ranks
    pj, _, _ = _jax_problem()
    r4 = _replicated(out[4], "checkpoint_save/r")
    for P in (4, 2):
        dj, sj = jck.load_distributed_state(d / "port_P4.npz", pj, jax_mesh(P))
        np.testing.assert_array_equal(np.asarray(sj.z), _replicated(out[4], "checkpoint_save/z"))
        _close_to_scale(dj.whitened_residual(sj.z), r4, 1e-8)

