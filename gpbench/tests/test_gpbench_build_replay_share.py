"""The per-layer metric ``build_replay_share``: its reader on hand-made
contexts (the share of the window's solves whose ``build.replay`` is above
zero, nothing without the key), its entry in ``BENCHMARK.json`` against the
contract, and a traced run of the elliptic cell on the CPU, where nothing is
recorded, so that it reads 0."""

import json
import time
from pathlib import Path

import pytest

from gpbench import harness
from gpbench.tests import test_gpbench_contract as contract

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = "build_replay_share.host_bound"
CELL = "elliptic-n900-fresh"


def _ctx(*timers):
    return {"window": [{"timers": dict(t)} for t in timers]}


@pytest.mark.parametrize("replays,share", [
    ((0.0002, 0.0001, 0.0003, 0.0002), 1.0),
    ((0.0002, 0.0, 0.0001, 0.0), 0.5),
    ((0.0,), 0.0),
])
def test_the_reader_takes_the_share_of_replayed_builds(replays, share):
    read = harness.reader(ROOT, NAME)
    got = read(_ctx(*({"build": 0.001, "build.replay": r} for r in replays)))
    assert got == pytest.approx(share)


def test_the_reader_reads_nothing_without_its_key():
    read = harness.reader(ROOT, NAME)
    assert read({"window": []}) is None
    parent = {"build": 0.017, "factorize": 0.004, "solver_host": 0.005, "host_wait": 0.003}
    assert read(_ctx(parent, parent)) is None
    assert read(_ctx({**parent, "build.replay": 0.0001}, parent)) is None


def test_the_entry_holds_to_the_contract():
    entry = next(m for m in BENCH["per_layer"] if m["name"] == NAME)
    assert entry["source"] == "program_span" and entry["better"] == "higher"
    assert entry["workloads"] == [CELL] and entry["moves"] == "solves_per_s.host_bound"
    layers = {m["layer"] for m in BENCH["per_layer"] if m["name"].startswith("build_ms")}
    assert layers == {entry["layer"]}
    contract.test_keys_and_sizes()
    contract.test_names_and_units_use_the_allowed_characters()
    contract.test_every_piece_is_found_by_name()


def test_a_traced_run_reports_it():
    result, _ = harness.run(ROOT, CELL, 3_000_000_019, 0.3, True, time.perf_counter(),
                            device="cpu", sizes_override={"n_domain": 50, "n_boundary": 16})
    assert result["metrics"][NAME]["value"] == 0.0 and result["metrics"][NAME]["unit"] == "share"
