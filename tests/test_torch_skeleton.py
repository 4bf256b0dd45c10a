"""The skeleton the dense and mesh paths share (``solvers/gn.py``): the
Gauss-Newton driver's argument checks and the nugget ladder of
``ops/linalg.py``, held alike on both paths (the mesh path at P = 1)."""

import numpy as np
import pytest
import torch

import nonlinpdes_gpsolver_tpu_torch as tpt
from nonlinpdes_gpsolver_tpu_torch.ops import linalg
from nonlinpdes_gpsolver_tpu_torch.solvers import distributed as tdist
from nonlinpdes_gpsolver_tpu_torch.solvers import gn as tgn
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)

MESH = tpt.parallel.make_mesh(1, device="cpu")
NUGGET = 1e-8


def _elliptic():
    """A small elliptic problem (no misfits) in f64 on the CPU."""
    return tpt.workloads.mesh_elliptic(device="cpu", dtype=torch.float64, n_domain=40,
                                       n_boundary=12).problem


def _factor(path, problem, **kw):
    if path == "dense":
        return tpt.factorize(problem, NUGGET, solve_mode="inverse", **kw)
    return tdist.factorize_distributed(problem, MESH, nugget=NUGGET, block=16, **kw)


@pytest.mark.parametrize("path,step_solver,message", [
    ("dense", "bogus", "unknown step_solver 'bogus'"),
    ("dense", "normal", "unknown step_solver 'normal'"),  # the mesh path's step only
    ("mesh", "bogus", "unknown step_solver 'bogus'"),
    ("dense", "woodbury", "misfit-coupled step; this problem has no misfit terms"),
    ("mesh", "woodbury", "misfit-coupled step; this problem has no misfit terms"),
])
def test_gauss_newton_rejects_bad_step_solver(path, step_solver, message):
    """Each path checks ``step_solver`` against its own names, and
    ``'woodbury'`` needs misfits; the check comes before any step."""
    fp = _factor(path, _elliptic())
    solve = tpt.gn_solve if path == "dense" else tdist.gn_solve_distributed
    with pytest.raises(ValueError, match=message):
        solve(fp, max_iter=1, step_solver=step_solver)


def _failing(real, times):
    """``real`` with its first ``times`` quality verdicts made NaN (a
    planted failure)."""
    calls = []

    def patched(*a, **k):
        calls.append(1)
        out = real(*a, **k)
        return out * np.nan if len(calls) <= times else out

    return patched


@pytest.mark.parametrize("path", ["dense", "mesh"])
@pytest.mark.parametrize("failures,start", [(1, None), (2, 100.0)])
def test_ladder_climbs_the_same_tenfold_sequence(monkeypatch, path, failures, start):
    """Under ``failures`` planted quality failures both paths try the
    scales ``s, 10 s, ...`` from ``escalation_start`` (or a larger
    ``start_scales`` entry), accept the next one, and count its rungs from
    ``escalation_start``."""
    tried = []
    if path == "dense":
        real_chol = tgn.equilibrated_cholesky

        def chol(theta, nug, s, **kw):
            tried.append(s)
            return real_chol(theta, nug, s, **kw)

        monkeypatch.setattr(tgn, "equilibrated_cholesky", chol)
        monkeypatch.setattr(tgn, "_whiten_quality", _failing(tgn._whiten_quality, failures))
    else:
        real_fused = tdist.assemble_factor_fused

        def fused(*a, **kw):
            tried.append(kw["nugget_scale"])
            return real_fused(*a, **kw)

        monkeypatch.setattr(tdist, "assemble_factor_fused", fused)
        monkeypatch.setattr(tdist, "sampled_row_quality",
                            _failing(tdist.sampled_row_quality, failures))
    problem = _elliptic()
    s0 = linalg.escalation_start(NUGGET, problem.dtype)
    s = max(s0, start or 1.0)
    expected = [s]
    for _ in range(failures):
        s *= linalg.ESCALATION
        expected.append(s)
    fp = _factor(path, problem, start_scales=None if start is None else {"u": start})
    assert tried == expected
    assert fp.nugget_scales == {"u": expected[-1]}
    assert fp.rungs == {"u": linalg.rungs_climbed(expected[-1], s0)}
    assert fp.rungs["u"] == failures + (0 if start is None else 2)
