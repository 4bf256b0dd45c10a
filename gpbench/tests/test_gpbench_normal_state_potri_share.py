"""The per-layer metric ``normal_state_potri_share``: its reader on a
stubbed counter (the share of the program's ``'normal'`` states computed in
``potri``'s order, nothing without the counter or without a state), the
program's counter itself (``"potri"`` on a one-device mesh), its entry in
``BENCHMARK.json`` against the contract, and a traced run of the Burgers
cell on the CPU, which at its cut size keeps to the dense path, computes no
state, and so leaves the metric out of its line."""

import json
import time
from pathlib import Path

import pytest
import torch

from gpbench import harness
from gpbench.tests import test_gpbench_contract as contract

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = "normal_state_potri_share"
CELL = "burgers-nd5000-fresh"


@pytest.mark.parametrize("counts,share", [
    ({"potri": 3, "solves": 1}, 0.75),
    ({"potri": 5, "solves": 0}, 1.0),
    ({"potri": 0, "solves": 7}, 0.0),
])
def test_the_reader_takes_the_potri_share(monkeypatch, counts, share):
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs

    monkeypatch.setattr(graphs, "NORMAL_STATES", counts)
    assert harness.reader(ROOT, NAME)({}) == pytest.approx(share)


def test_the_reader_reads_nothing_without_a_counted_state(monkeypatch):
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs

    read = harness.reader(ROOT, NAME)
    monkeypatch.setattr(graphs, "NORMAL_STATES", {"potri": 0, "solves": 0})
    assert read({}) is None
    monkeypatch.setattr(graphs, "NORMAL_STATES", {})
    assert read({}) is None
    monkeypatch.delattr(graphs, "NORMAL_STATES")  # the parent has no such counter
    assert read({}) is None


def test_a_one_device_state_reads_one():
    import nonlinpdes_gpsolver_tpu_torch as tpt
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs

    gen = torch.Generator().manual_seed(0)
    Xd, Xb = tpt.utils.sample_random(gen, 40, 12, domain=((0.0, 1.0), (-1.0, 1.0)),
                                     time_dependent=True, dtype=torch.float64)
    prob = tpt.models.burgers(tpt.SquaredExponential.anisotropic([0.3, 0.05]), Xd, Xb,
                              lambda x: -torch.sin(torch.pi * x[1]), seed=0)
    graphs.reset_counts()
    tpt.GPSolver(prob, nugget=1e-5, mesh=tpt.parallel.make_mesh(1, device="cpu"),
                 mesh_block=32).solve(max_iter=2, step_solver="normal")
    assert graphs.NORMAL_STATES == {"potri": 1, "solves": 0}
    assert harness.reader(ROOT, NAME)({}) == 1.0
    graphs.reset_counts()
    assert graphs.NORMAL_STATES == {"potri": 0, "solves": 0}


def test_the_entry_holds_to_the_contract():
    entry = next(m for m in BENCH["per_layer"] if m["name"] == NAME)
    assert entry["source"] == "program_counter" and entry["better"] == "higher"
    assert entry["unit"] == "share" and entry["workloads"] == [CELL]
    assert entry["moves"] == "solves_per_s"
    state = next(m for m in BENCH["per_layer"] if m["name"] == "normal_state_ms")
    assert entry["layer"] == state["layer"]
    names = [m["name"] for m in BENCH["per_layer"]]
    assert names.index(NAME) > names.index("trsm_kernel_share")  # appended after them
    contract.test_keys_and_sizes()
    contract.test_names_and_units_use_the_allowed_characters()
    contract.test_every_piece_is_found_by_name()


def test_a_traced_run_leaves_it_out_without_a_state():
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs

    graphs.reset_counts()
    result, _ = harness.run(ROOT, CELL, 3_000_000_019, 0.3, True, time.perf_counter(),
                            device="cpu", sizes_override={"n_domain": 50, "n_boundary": 16})
    assert "normal_route_share" in result["metrics"] and NAME not in result["metrics"]
    assert graphs.NORMAL_STATES == {"potri": 0, "solves": 0}
