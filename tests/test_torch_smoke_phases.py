"""``chip_smoke.py``'s slice-5 phases rehearsed on the CPU in f64 at small
sizes, so that a fault in them shows here before a call on the card:
``checkpoint`` (the dense round trip on the canonical solve; the mesh case
on phase 4's problem cut to 300/60, reloaded in the child process that
blocks jax), ``compat`` and ``perf_report`` (the driver as a subprocess,
its sizes cut); and slice 7's ``structure_reuse``, with the card's numerics
(f32). Each phase's own checks run; the K1 launch counts are the card's and
are not asserted here, where the plain version stands in."""

import torch

import chip_smoke
import nonlinpdes_gpsolver_tpu_torch as tpt
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)

CPU = torch.device("cpu")


def _canonical():
    inp = tpt.interop.load_canonical_inputs()
    Xt = tpt.utils.test_grid(20, 20, device=CPU)
    return inp, Xt, torch.func.vmap(tpt.workloads.u_elliptic)(Xt)


def test_checkpoint_phase_on_cpu(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the child process, beside other test processes
    inp, Xt, truth = _canonical()
    res = tpt.GPSolver(tpt.interop.problem_from_numpy(**inp, device="cpu"), nugget=1e-5).solve(4)
    dense = chip_smoke.checkpoint_dense(tpt, res.posterior.fp, res.state, Xt, truth)
    assert dense["factor_bitwise"] and dense["z_bitwise"] and dense["extension_equal"]
    sizes = (300, 60)
    big = chip_smoke.large_problem(tpt, CPU, sizes)
    mres = tpt.GPSolver(big, nugget=1e-5, mesh=tpt.parallel.make_mesh(1, device=CPU),
                        mesh_block=64).solve(4)
    mesh = chip_smoke.checkpoint_mesh(mres.posterior.fp, mres.state, mres.timers["factorize"],
                                      sizes)
    child = mesh["child"]
    assert child["factor_bitwise"] and child["residual_rel_diff"] == 0.0
    assert mesh["gram_rows"] == 660 and mesh["file_bytes"] > 0 and child["jax_imported"] == []


def test_compat_phase_on_cpu():
    inp, Xt, truth = _canonical()
    out = chip_smoke.compat_phase(tpt, inp, Xt, truth, device="cpu")
    assert out["device"] == "cpu" and out["dtype"] == "float64" and len(out["losses"]) == 4


def test_perf_report_phase_on_cpu(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # perf_report's processes, as in the child above
    runs = [[a.replace("7800", "200").replace("900", "100") for a in argv]
            for argv in chip_smoke.PERF_REPORT_RUNS]
    report = chip_smoke.perf_report_phase(runs, ["--device", "cpu", "--gn_steps", "2"])
    assert [len(r["rows"]) for r in report] == [2, 1]
    assert [r["N"] for r in report[0]["rows"]] == [100.0, 200.0]


def test_structure_reuse_phase_on_cpu():
    """Three new problems of each structure (the canonical problem, phase
    4's and ``mesh_solve``'s cut to 500/100), with the card's numerics:
    each later problem factors into the first one's storage, passes its
    gate and equals its eager solve and an unshared solve of the same
    problem (on the CPU nothing is recorded); the same for phase 4's
    problem on the two-pass mesh factorization; and six held runs of the
    canonical and the mesh case (each result kept until the next solve
    returns) bind made, made, then rebound, each bitwise an unshared
    solve."""
    with tpt.ops.backend.card_numerics_on_cpu():
        out = chip_smoke.structure_reuse(tpt, CPU, names=("canonical", "large", "mesh"), runs=3,
                                         held=("canonical", "mesh"), large_sizes=(500, 100),
                                         mesh_sizes=(500, 100))
    held = out.pop("held")
    for rows in out.values():
        assert [r["bind"] for r in rows] == [["made"], ["rebound"], ["rebound"]]
        assert all(r["bitwise_eager"] and r["captures"] == 0 for r in rows)
        assert all(r["reference_unshared"] and r["bitwise_unshared"] for r in rows)
    assert out["mesh"][1]["step_solver"] == "structured"
    assert set(held) == {"canonical", "mesh"}
    for rows in held.values():
        assert [r["bind"] for r in rows] == [["made"]] * 2 + [["rebound"]] * 4
        assert all(r["reference_unshared"] and r["bitwise_unshared"] for r in rows)


def test_structure_reuse_sweep_on_cpu():
    """The phase's ``sweep`` case with the card's numerics, cut: six
    canonical problems and four of ``mesh_solve``'s cut to 500/100, every
    solver and result kept to the end: made, made, then guests of the
    guest entry, one guest load each, three entries at most, each solve
    bitwise an unshared solve and under its gate; once the results are
    gone the device keeps one released entry, and ``RETAINED_BYTES`` is
    its bytes (no graph pool on the CPU)."""
    with tpt.ops.backend.card_numerics_on_cpu():
        out = chip_smoke.structure_reuse(tpt, CPU, names=(), held=(), two_pass_runs=0,
                                         sweep={"canonical": 6, "mesh": 4},
                                         large_sizes=(500, 100), mesh_sizes=(500, 100))
    for name, n in (("canonical", 6), ("mesh", 4)):
        case = out["sweep"][name]
        rows = case["runs"]
        assert [r["bind"] for r in rows] == [["made"]] * 2 + [["guest"]] * (n - 2)
        assert [r["guest_loads"] for r in rows] == [0, 0] + [1] * (n - 2)
        assert [r["entries"] for r in rows] == [1, 2] + [3] * (n - 2)
        assert all(r["reference_unshared"] and r["bitwise_unshared"] for r in rows)
        assert case["released_entries"] == 1
        assert case["retained_bytes"] == case["retained_entry_bytes"] > 0
