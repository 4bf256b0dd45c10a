"""The per-layer metrics read from the program's spans (``build_ms``,
``solver_host_ms``, ``host_wait_ms``): their readers on hand-made
contexts, their entries in ``BENCHMARK.json`` against the contract, and a
traced run of each cell on the CPU that reports them."""

import json
import time
from pathlib import Path

import pytest

from gpbench import harness
from gpbench.tests import test_gpbench_contract as contract

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = {"build_ms": "build", "solver_host_ms": "solver_host", "host_wait_ms": "host_wait"}
ENTRIES = {"build_ms.host_bound": "elliptic-n900-fresh",
           "solver_host_ms.host_bound": "elliptic-n900-fresh",
           "host_wait_ms.host_bound": "elliptic-n900-fresh",
           "host_wait_ms": "darcy-nd3000-fresh"}
TINY = {
    "elliptic-n900-fresh": {"n_domain": 50, "n_boundary": 16},
    "darcy-nd3000-fresh": {"n_domain": 50, "n_boundary": 16, "n_obs": 10},
}


def _ctx(*timers):
    return {"window": [{"timers": dict(t)} for t in timers]}


@pytest.mark.parametrize("metric", sorted(KEYS))
def test_a_reader_takes_the_mean_in_ms(metric):
    read = harness.reader(ROOT, metric)
    key = KEYS[metric]
    assert read(_ctx({key: 0.002, "factorize": 1.0}, {key: 0.004})) == pytest.approx(3.0)
    assert read(_ctx({key: 0.0})) == 0.0


@pytest.mark.parametrize("metric", sorted(KEYS))
def test_a_reader_reads_nothing_without_its_key(metric):
    read = harness.reader(ROOT, metric)
    assert read({"window": []}) is None
    # the parent's timers: the three phases only
    parent = {"factorize": 0.004, "gauss_newton": 0.003, "posterior_weights": 0.0005}
    assert read(_ctx(parent, parent)) is None
    assert read(_ctx({KEYS[metric]: 0.001}, parent)) is None


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_the_entries_hold_to_the_contract(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert entry["source"] == "program_span" and entry["unit"] == "ms"
    assert entry["better"] == "lower" and entry["workloads"] == [ENTRIES[name]]
    cell_e2e = {m["name"] for m in BENCH["end_to_end"]
                if ENTRIES[name] in m.get("workloads", [ENTRIES[name]])}
    assert entry["moves"] in cell_e2e
    layers = {m["layer"] for m in BENCH["per_layer"]
              if harness.base_name(m["name"]) == harness.base_name(name)}
    assert len(layers) == 1
    contract.test_keys_and_sizes()
    contract.test_names_and_units_use_the_allowed_characters()
    contract.test_every_piece_is_found_by_name()


@pytest.mark.parametrize("workload", sorted(TINY))
def test_a_traced_run_reports_them(workload):
    result, _ = harness.run(ROOT, workload, 3_000_000_019, 0.3, True, time.perf_counter(),
                            device="cpu", sizes_override=TINY[workload])
    want = {n for n, cell in ENTRIES.items() if cell == workload}
    assert want <= set(result["metrics"]), result["metrics"]
    assert all(result["metrics"][n]["value"] >= 0.0 for n in want)
