"""The plain reference agrees with the program at tiny sizes on the CPU,
where both compute in float64, on the dense path and on the mesh path."""

import json
from pathlib import Path

import pytest
import torch

import nonlinpdes_gpsolver_tpu_torch as tpt
from gpbench import generator
from gpbench.pdes import darcy_flow2d_inverse, nonlin_elliptic2d
from gpbench.reference import darcy_flow2d_inverse as darcy_ref
from gpbench.reference import gaussian
from gpbench.reference import nonlin_elliptic2d as elliptic_ref
from gpbench.reference.linalg import Precision

ROOT = Path(__file__).resolve().parents[2]


def _cfg(name):
    return json.loads((ROOT / "gpbench" / "configs" / f"{name}.json").read_text())


def _gap(p, r):
    return float(torch.max(torch.abs(p - r)) / torch.max(torch.abs(r)))


def _program(pde, cfg, sizes, inputs, ctx):
    mesh = tpt.parallel.make_mesh(1, device="cpu") if sizes["mesh"] else None
    solver = tpt.GPSolver(pde.build(tpt, cfg, inputs, ctx), nugget=cfg["nugget"],
                          nugget_type=cfg["nugget_type"], mesh=mesh)
    return pde.extend(solver.solve(max_iter=cfg["gn_steps"], z0=inputs["z0"]), ctx)


@pytest.mark.parametrize("pde,ref,sizes", [
    (nonlin_elliptic2d, elliptic_ref, {"n_domain": 60, "n_boundary": 20, "mesh": 0}),
    (darcy_flow2d_inverse, darcy_ref, {"n_domain": 60, "n_boundary": 20, "n_obs": 12, "mesh": 0}),
    (darcy_flow2d_inverse, darcy_ref, {"n_domain": 60, "n_boundary": 20, "n_obs": 12, "mesh": 1}),
], ids=["elliptic", "darcy-dense", "darcy-mesh"])
def test_reference_agrees_with_the_program_in_float64(pde, ref, sizes):
    cfg = _cfg(pde.__name__.rsplit(".", 1)[1])
    ctx = pde.setup(cfg, "cpu", torch.float64)
    inputs = pde.draw(cfg, sizes, torch.Generator().manual_seed(generator.solve_seed(5, 0)),
                      torch.float64, ctx)
    out = _program(pde, cfg, sizes, inputs, ctx)
    expect = ref.solve(cfg, inputs, ctx["X_test"], Precision("float64"), torch.float64)
    for name in pde.OUTPUTS:
        assert _gap(out[name], expect[name]) < 1e-6, name


def test_gaussian_blocks_match_derivatives_by_autograd():
    a = 1.0 / (2 * 0.2**2)
    X = torch.rand(4, 2, dtype=torch.float64)
    Y = torch.rand(3, 2, dtype=torch.float64)

    def k(x, y):
        return torch.exp(-a * torch.sum((x - y) ** 2))

    def lap(f, argnum):
        def g(x, y):
            H = torch.func.hessian(f, argnums=argnum)(x, y)
            return torch.trace(H)
        return g

    def d(f, argnum, axis):
        return lambda x, y: torch.func.grad(f, argnums=argnum)(x, y)[axis]

    cases = {("lap", "lap"): lap(lap(k, 0), 1), ("d0", "lap"): lap(d(k, 0, 0), 1),
             ("lap", "d1"): d(lap(k, 0), 1, 1), ("d0", "d1"): d(d(k, 0, 0), 1, 1),
             ("id", "d0"): d(k, 1, 0), ("lap", "id"): lap(k, 0)}
    for (ox, oy), f in cases.items():
        want = torch.tensor([[float(f(x, y)) for y in Y] for x in X], dtype=torch.float64)
        assert torch.allclose(gaussian.block(ox, oy, X, Y, a), want, rtol=1e-10, atol=1e-8)


def test_the_nugget_rule_escalates_where_the_working_dtype_cannot_factor():
    from gpbench.reference.linalg import escalation_start, whitening

    cfg = _cfg("darcy_flow2d_inverse")
    a = 1.0 / (2 * cfg["sigma"] ** 2)
    X = torch.rand(150, 2, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    segs = [("d0", X), ("d1", X), ("id", X)]
    _, s64 = whitening(segs, a, cfg["nugget"], torch.float64, torch.float64)
    _, s32 = whitening(segs, a, cfg["nugget"], torch.float64, torch.float32)
    assert s64 == 1.0
    assert s32 >= escalation_start(cfg["nugget"], torch.float32) > 1.0
