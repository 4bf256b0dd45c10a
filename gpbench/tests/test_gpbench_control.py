"""What decides ``correct`` fails where it has to.

* The control: the plain reference in the precision just below the
  configuration's (TF32 products), put in the program's place, reads
  ``correct`` false through the harness's own comparison; the elliptic
  cell at its own size, the Darcy cell cut to a size a CPU test can hold.
* A whole run of a cell on the CPU (the harness's look for a card
  skipped, the program in float64 at a tiny size) reads ``correct`` true,
  and false once the timed path is broken underneath: a Gauss-Newton step
  that returns its state unchanged, or an answer altered where it is
  produced (the posterior's extension).
"""

import time
from pathlib import Path

import pytest
import torch

from gpbench import harness
from gpbench.reference.linalg import Precision

ROOT = Path(__file__).resolve().parents[2]
TINY = {
    "elliptic-n900-fresh": {"n_domain": 50, "n_boundary": 16},
    "darcy-nd3000-fresh": {"n_domain": 50, "n_boundary": 16, "n_obs": 10},
}


@pytest.mark.parametrize("workload,sizes", [
    ("elliptic-n900-fresh", None),
    ("darcy-nd3000-fresh", {"n_domain": 300, "n_boundary": 75, "n_obs": 60}),
])
def test_the_control_reads_not_correct(workload, sizes):
    cell = harness.Cell(ROOT, workload)
    if sizes:
        cell.mix = {**cell.mix, **sizes}
    dev = torch.device("cpu")
    stream = harness.Stream(None, cell, 17, dev, torch.float32,
                            cell.pde.setup(cell.cfg, dev, torch.float32))
    limits = cell.cfg["limits"]
    cmp = harness.compare(cell, stream, [(0, None)], limits, control=Precision("tf32"))
    checks, correct = harness.judge(cmp, limits)
    assert cmp["compared"] == [0] and not correct, checks


def _run(workload):
    result, checks = harness.run(ROOT, workload, 3_000_000_019, 0.3, False, time.perf_counter(),
                                 device="cpu", sizes_override=TINY[workload])
    return result, checks


@pytest.mark.parametrize("workload", sorted(TINY))
def test_a_sound_run_is_correct(workload):
    result, checks = _run(workload)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and list(result)[-1] == "checks"


@pytest.mark.parametrize("workload", sorted(TINY))
def test_a_step_that_returns_its_state_unchanged_is_caught(workload, monkeypatch):
    from nonlinpdes_gpsolver_tpu_torch.solvers import gn

    monkeypatch.setattr(gn._Loop, "step", lambda self, fp: None)
    result, checks = _run(workload)
    assert not result["correct"], checks


@pytest.mark.parametrize("workload", sorted(TINY))
def test_an_altered_answer_is_caught(workload, monkeypatch):
    from nonlinpdes_gpsolver_tpu_torch.solvers import posterior

    extend = posterior.Posterior.extend

    def altered(self, X_test, block=None, op=None):
        out = extend(self, X_test, block=block, op=op).clone()
        out[len(out) // 2] += 0.1 * float(torch.max(torch.abs(out)))
        return out

    monkeypatch.setattr(posterior.Posterior, "extend", altered)
    result, checks = _run(workload)
    assert not result["correct"], checks
