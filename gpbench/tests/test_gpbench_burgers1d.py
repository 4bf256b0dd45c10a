"""The ``burgers1d`` configuration's pieces on the CPU, in float64 at tiny
sizes: the plain reference against the program on the dense path and on
the mesh path (its ``'normal'`` step, and ``'auto'``), the anisotropic
blocks against autograd and against the isotropic ones, the frozen truth
against the program's, and what decides ``correct`` failing where it has
to (the control, and a Gauss-Newton step that leaves its state
unchanged)."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import nonlinpdes_gpsolver_tpu_torch as tpt
from gpbench import generator, harness
from gpbench.frozen import burgers as fb
from gpbench.pdes import burgers1d
from gpbench.reference import anisotropic, gaussian
from gpbench.reference import burgers1d as burgers_ref
from gpbench.reference.linalg import Precision

ROOT = Path(__file__).resolve().parents[2]
CELL = "burgers-nd5000-fresh"
CFG = json.loads((ROOT / "gpbench" / "configs" / "burgers1d.json").read_text())
SIZES = {"n_domain": 60, "n_boundary": 20, "mesh": 0}


def _gap(p, r):
    return float(torch.max(torch.abs(p - r)) / torch.max(torch.abs(r)))


@pytest.fixture(scope="module")
def drawn():
    ctx = burgers1d.setup(CFG, "cpu", torch.float64)
    gen = torch.Generator().manual_seed(generator.solve_seed(5, 0))
    inputs = burgers1d.draw(CFG, SIZES, gen, torch.float64, ctx)
    expect = burgers_ref.solve(CFG, inputs, ctx["X_test"], Precision("float64"), torch.float64)
    return ctx, inputs, expect


@pytest.mark.parametrize("mesh,step_solver,routed", [
    (False, "auto", "direct"), (True, "normal", "normal"), (True, "auto", "structured"),
], ids=["dense", "mesh-normal", "mesh-auto"])
def test_reference_agrees_with_the_program_in_float64(drawn, mesh, step_solver, routed):
    ctx, inputs, expect = drawn
    kw = {"mesh": tpt.parallel.make_mesh(1, device="cpu"), "mesh_block": 32} if mesh else {}
    solver = tpt.GPSolver(burgers1d.build(tpt, CFG, inputs, ctx), nugget=CFG["nugget"],
                          nugget_type=CFG["nugget_type"], **kw)
    res = solver.solve(max_iter=CFG["gn_steps"], z0=inputs["z0"], step_solver=step_solver)
    assert res.state.step_solver == routed
    out = burgers1d.extend(res, ctx)
    for name in burgers1d.OUTPUTS:
        assert _gap(out[name], expect[name]) < 1e-6, name


def _autograd_block(ox, oy, a):
    """``(op_x (x) op_y) k`` at one pair of points by autograd."""
    A = torch.tensor(a, dtype=torch.float64)

    def k(x, y):
        return torch.exp(-torch.sum(A * (x - y) ** 2))

    def apply(op, f, argnum):
        if op == "id":
            return f
        if op in ("d0", "d1"):
            axis = int(op[1])
            return lambda x, y: torch.func.grad(f, argnums=argnum)(x, y)[axis]
        return lambda x, y: torch.func.hessian(f, argnums=argnum)(x, y)[1, 1]  # d11

    return apply(oy, apply(ox, k, 0), 1)


@pytest.mark.parametrize("ox,oy", [("d11", "d11"), ("d0", "d11"), ("d11", "d1"), ("d0", "d1"),
                                   ("id", "d11"), ("d1", "id"), ("d0", "d0")])
def test_anisotropic_blocks_match_derivatives_by_autograd(ox, oy):
    a = burgers_ref.coefficients(CFG)
    gen = torch.Generator().manual_seed(3)
    X = torch.rand(4, 2, dtype=torch.float64, generator=gen) * torch.tensor([1.0, 0.2])
    Y = torch.rand(3, 2, dtype=torch.float64, generator=gen) * torch.tensor([1.0, 0.2])
    f = _autograd_block(ox, oy, a)
    want = torch.tensor([[float(f(x, y)) for y in Y] for x in X], dtype=torch.float64)
    got = anisotropic.block(ox, oy, X, Y, a)
    assert torch.allclose(got, want, rtol=1e-10, atol=1e-8 * float(want.abs().max()))


def test_equal_lengthscales_give_the_isotropic_blocks():
    a = 1.0 / (2 * 0.2**2)
    gen = torch.Generator().manual_seed(4)
    X = torch.rand(5, 2, dtype=torch.float64, generator=gen)
    Y = torch.rand(6, 2, dtype=torch.float64, generator=gen)
    for ox in ("id", "d0", "d1"):
        for oy in ("id", "d0", "d1"):
            assert torch.allclose(anisotropic.block(ox, oy, X, Y, (a, a)),
                                  gaussian.block(ox, oy, X, Y, a), rtol=1e-13, atol=1e-12)
    assert anisotropic.prior_diagonal("d0", (a, a)) == pytest.approx(
        gaussian.prior_diagonal("d0", a), rel=1e-14)


def test_the_frozen_truth_is_the_programs():
    from nonlinpdes_gpsolver_tpu_torch.utils.classical import burgers_cole_hopf_truth

    t = np.array([0.0, 0.1, 0.35, 0.5, 0.77, 1.0])
    x = np.array([-1.0, -0.4, 0.0, 0.05, 0.6, 0.93])
    frozen, program = fb.cole_hopf_truth(0.02)(t, x), burgers_cole_hopf_truth(0.02)(t, x)
    assert np.array_equal(frozen, program)
    assert frozen[0] == pytest.approx(0.0, abs=1e-12)  # u(0, -1) = -sin(-pi)
    assert fb.cole_hopf_truth(0.02)(0.0, 0.5) == pytest.approx(-1.0, rel=1e-12)


def test_the_draw_lies_on_its_faces():
    gen = torch.Generator().manual_seed(9)
    Xd, Xb = fb.sample_random(gen, 50, 31, torch.float64)
    assert Xd.shape == (50, 2) and Xb.shape == (31, 2)
    assert bool(((Xd[:, 0] >= 0) & (Xd[:, 0] <= 1) & (Xd[:, 1] >= -1) & (Xd[:, 1] <= 1)).all())
    assert bool((Xb[:11, 0] == 0.0).all()) and bool((Xb[11:21, 1] == 1.0).all())
    assert bool((Xb[21:, 1] == -1.0).all())
    g = torch.func.vmap(fb.g)(Xb)
    assert torch.equal(g, burgers_ref.boundary_values(Xb))


def test_kernel_work_follows_the_path():
    ctx = {"X_test": torch.zeros((3600, 2))}
    small = burgers1d.kernel_work(CFG, SIZES, 4, ctx)
    big = burgers1d.kernel_work(CFG, {"n_domain": 5000, "n_boundary": 1000, "mesh": 0}, 4, ctx)
    assert set(small) == {"k1"} and set(big) == {"k1", "k2"}
    assert big["k2"].bytes == 4 * (21000 * 21001 // 2 + 6000 * 2 + 21000)


def test_the_control_reads_not_correct():
    cell = harness.Cell(ROOT, CELL)
    cell.mix = {**cell.mix, "n_domain": 400, "n_boundary": 80}
    dev = torch.device("cpu")
    stream = harness.Stream(None, cell, 17, dev, torch.float32,
                            cell.pde.setup(cell.cfg, dev, torch.float32))
    limits = cell.cfg["limits"]
    cmp = harness.compare(cell, stream, [(0, None)], limits, control=Precision("tf32"))
    checks, correct = harness.judge(cmp, limits)
    assert cmp["compared"] == [0] and not correct, checks


def _run():
    return harness.run(ROOT, CELL, 3_000_000_019, 0.3, False, time.perf_counter(), device="cpu",
                       sizes_override={"n_domain": 50, "n_boundary": 16})


def test_a_sound_run_is_correct():
    result, checks = _run()
    assert result["correct"], checks
    assert result["attempted"] >= 1 and list(result)[-1] == "checks"


def test_a_step_that_returns_its_state_unchanged_is_caught(monkeypatch):
    from nonlinpdes_gpsolver_tpu_torch.solvers import gn

    monkeypatch.setattr(gn._Loop, "step", lambda self, fp: None)
    result, checks = _run()
    assert not result["correct"], checks
