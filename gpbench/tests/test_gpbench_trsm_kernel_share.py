"""The per-layer metric ``trsm_kernel_share``: its reader on a stubbed
counter (the share of the program's P = 1 triangular solves routed to the
row-block kernel, nothing without the counter or without a solve), its
entry in ``BENCHMARK.json`` against the contract, and a traced run of the
Darcy cell on the CPU, where every solve takes the library, so that it
reads 0."""

import json
import time
from pathlib import Path

import pytest

from gpbench import harness
from gpbench.tests import test_gpbench_contract as contract

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = "trsm_kernel_share"
CELLS = ["darcy-nd3000-fresh", "burgers-nd5000-fresh"]


@pytest.mark.parametrize("counts,share", [
    ({"kernel": 3, "library": 1}, 0.75),
    ({"kernel": 5, "library": 0}, 1.0),
    ({"kernel": 0, "library": 7}, 0.0),
])
def test_the_reader_takes_the_kernels_share(monkeypatch, counts, share):
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs

    monkeypatch.setattr(graphs, "TRSM_ROUTES", counts)
    assert harness.reader(ROOT, NAME)({}) == pytest.approx(share)


def test_the_reader_reads_nothing_without_a_counted_solve(monkeypatch):
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs

    read = harness.reader(ROOT, NAME)
    monkeypatch.setattr(graphs, "TRSM_ROUTES", {"kernel": 0, "library": 0})
    assert read({}) is None
    monkeypatch.delattr(graphs, "TRSM_ROUTES")  # the parent has no such counter
    assert read({}) is None


def test_the_entry_holds_to_the_contract():
    entry = next(m for m in BENCH["per_layer"] if m["name"] == NAME)
    assert entry["source"] == "program_counter" and entry["better"] == "higher"
    assert entry["unit"] == "share" and entry["workloads"] == CELLS
    assert entry["moves"] == "solves_per_s"
    trsm = next(m for m in BENCH["per_layer"] if m["name"] == "trsm_pct")
    assert entry["layer"] == trsm["layer"]
    assert BENCH["per_layer"][-1] is entry
    contract.test_keys_and_sizes()
    contract.test_names_and_units_use_the_allowed_characters()
    contract.test_every_piece_is_found_by_name()


def test_a_traced_run_reports_it():
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs

    graphs.reset_counts()
    result, _ = harness.run(ROOT, CELLS[0], 3_000_000_019, 0.3, True, time.perf_counter(),
                            device="cpu",
                            sizes_override={"n_domain": 50, "n_boundary": 16, "n_obs": 10})
    assert result["metrics"][NAME]["value"] == 0.0 and result["metrics"][NAME]["unit"] == "share"
    assert graphs.TRSM_ROUTES["library"] > 0
