"""``BENCHMARK.json`` against the rules it is held to, the layout the
harness finds by name, and what the benchmark may import."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from gpbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]] + [m["name"] for m in _metrics()]
    for c in BENCH["configs"]:
        names += c["reduced"]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in _metrics())
    assert all(m["better"] in ("lower", "higher") for m in _metrics())
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
                 + [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
                 + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for group in (BENCH["configs"], BENCH["workloads"], _metrics()):
        assert len({x["name"] for x in group}) == len(group)


def test_every_piece_is_found_by_name():
    cells = {w["name"] for w in BENCH["workloads"]}
    configs = {c["name"]: c for c in BENCH["configs"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        cfg = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        assert (ROOT / "gpbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "gpbench" / "pdes" / f"{cfg['pde']}.py").is_file()
        assert (ROOT / "gpbench" / "reference" / f"{cfg['pde']}.py").is_file()
        assert set(cfg["limits"]) and all(0 < v < 1 for v in cfg["limits"].values())
        reported = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(w["name"] in m.get("workloads", cells) for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert (ROOT / "gpbench" / "layer_metrics" / f"{harness.base_name(m['name'])}.py").is_file()
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells)), m["name"]
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}
    assert all(c["file"].startswith("gpbench/") for c in BENCH["configs"])


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("where,banned", [
    ("gpbench/reference", {"jax", "jaxlib", "flax", "nonlinpdes_gpsolver_tpu",
                           "nonlinpdes_gpsolver_tpu_torch"}),
    ("gpbench", {"jax", "jaxlib", "flax", "nonlinpdes_gpsolver_tpu"}),
])
def test_no_forbidden_imports(where, banned):
    files = sorted((ROOT / where).rglob("*.py"))
    assert files
    found = {(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f) if m in banned}
    assert not found


def test_a_run_without_a_card_exits_with_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal needs a machine without one")
    proc = subprocess.run([sys.executable, str(ROOT / "gpbench" / "run.py"), "--workload",
                           BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode != 0
    assert "correct" not in proc.stdout
