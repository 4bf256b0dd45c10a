"""The per-layer metrics of the ``'normal'`` step (``normal_state_ms``,
``normal_step_ms``, ``normal_route_share``): their readers on hand-made
contexts, nothing read where the program has no such key or counter
(the parent's timers), their entries in ``BENCHMARK.json``, and a traced
run of the Burgers cell on the CPU that reports them."""

import json
import time
from pathlib import Path

import pytest

from gpbench import harness
from gpbench.tests import test_gpbench_contract as contract

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "burgers-nd5000-fresh"
KEYS = {"normal_state_ms": "gauss_newton.normal_state",
        "normal_step_ms": "gauss_newton.normal_step"}
PARENT = {"factorize": 0.1, "gauss_newton": 0.9, "posterior_weights": 0.003, "build": 0.0004,
          "host_wait": 0.8, "solver_host": 0.1}


def _ctx(*timers):
    return {"window": [{"timers": dict(t)} for t in timers]}


@pytest.mark.parametrize("metric", sorted(KEYS))
def test_a_span_reader_takes_the_mean_in_ms(metric):
    read = harness.reader(ROOT, metric)
    key = KEYS[metric]
    assert read(_ctx({**PARENT, key: 0.4}, {**PARENT, key: 0.6})) == pytest.approx(500.0)
    assert read(_ctx({**PARENT, key: 0.0})) == 0.0


@pytest.mark.parametrize("metric", sorted(KEYS))
def test_a_span_reader_reads_nothing_without_its_key(metric):
    read = harness.reader(ROOT, metric)
    assert read({"window": []}) is None
    assert read(_ctx(PARENT, PARENT)) is None
    assert read(_ctx({KEYS[metric]: 0.1}, PARENT)) is None


def test_the_route_share_reads_the_programs_counter(monkeypatch):
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs

    read = harness.reader(ROOT, "normal_route_share")
    monkeypatch.setattr(graphs, "STEP_SOLVERS", {"normal": 3, "cg": 1})
    assert read({}) == pytest.approx(0.75)
    monkeypatch.setattr(graphs, "STEP_SOLVERS", {"normal": 5})
    assert read({}) == 1.0
    monkeypatch.setattr(graphs, "STEP_SOLVERS", {})
    assert read({}) is None
    monkeypatch.delattr(graphs, "STEP_SOLVERS")  # the parent has no such counter
    assert read({}) is None


@pytest.mark.parametrize("name", ["normal_state_ms", "normal_step_ms", "normal_route_share"])
def test_the_entries_hold_to_the_contract(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert entry["workloads"] == [CELL] and entry["moves"] == "solves_per_s"
    assert entry["source"] == ("program_counter" if name.endswith("share") else "program_span")
    assert CELL in next(m for m in BENCH["end_to_end"] if m["name"] == "solves_per_s")["workloads"]
    layers = {m["layer"] for m in BENCH["per_layer"] if m["name"].startswith("normal_")}
    assert len(layers) == 1
    contract.test_keys_and_sizes()
    contract.test_names_and_units_use_the_allowed_characters()
    contract.test_every_piece_is_found_by_name()


def test_a_traced_run_reports_them():
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs

    graphs.reset_counts()
    result, _ = harness.run(ROOT, CELL, 3_000_000_019, 0.3, True, time.perf_counter(),
                            device="cpu", sizes_override={"n_domain": 50, "n_boundary": 16})
    metrics = result["metrics"]
    assert {"normal_state_ms", "normal_step_ms", "normal_route_share"} <= set(metrics), metrics
    # at this size the program keeps to the dense path: no 'normal' step ran
    assert metrics["normal_state_ms"]["value"] == metrics["normal_step_ms"]["value"] == 0.0
    assert metrics["normal_route_share"]["value"] == 0.0
    assert set(graphs.STEP_SOLVERS) == {"direct"}
