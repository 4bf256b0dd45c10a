"""The port's ``perf_report`` driver on the CPU at tiny sizes: each
workload, the dense path and the mesh path at P = 1 (``--mesh 1``, with
``--superblock``), prints its header and one row per size whose eight
columns parse as numbers, with a finite test L2; Darcy's note carries the
relative L2 of ``a``. The seconds and TF/s of a CPU run say nothing of the
card."""

import math

import pytest

from nonlinpdes_gpsolver_tpu_torch.examples import perf_report
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)

COLUMNS = ["N", "factor_s", "gn_s", "post_s", "chol_TF/s", "gn_TF/s", "gn_it/s", "test_L2"]
TINY = ["--device", "cpu", "--gn_steps", "1", "--test_grid", "10", "--N_data", "8",
        "--nugget", "1e-6"]


def _rows(out):
    lines = out.splitlines()
    head = lines.index(perf_report.HEADER)
    assert lines[head].split() == COLUMNS
    rows = []
    for line in lines[head + 1:]:
        fields = line.split()
        rows.append(dict(zip(COLUMNS, map(float, fields[:8])), note=" ".join(fields[8:])))
    return rows


@pytest.mark.parametrize("workload", ["elliptic", "burgers", "eikonal", "darcy"])
@pytest.mark.parametrize("mesh", [[], ["--mesh", "1", "--mesh_block", "16", "--superblock", "32"]],
                         ids=["dense", "mesh1"])
def test_perf_report_rows(workload, mesh, capsys):
    sizes = ["24", "40"] if workload == "elliptic" else ["24"]
    returned = perf_report.main(["--workload", workload, "--sizes", *sizes, *TINY, *mesh])
    out = capsys.readouterr().out
    assert f"workload={workload} device=cpu dtype=float64 mesh={'1' if mesh else 'off'}" in out
    rows = _rows(out)
    assert [int(r["N"]) for r in rows] == [int(s) for s in sizes]
    for row, ret in zip(rows, returned):
        assert math.isfinite(row["test_L2"]) and row["test_L2"] > 0
        assert all(row[k] >= 0 for k in COLUMNS)
        assert row["test_L2"] == pytest.approx(ret["test_L2"], rel=1e-3)
        assert ("a_relL2" in row["note"]) == (workload == "darcy")


def test_perf_report_warm_pass_and_mesh_needs_a_group(capsys):
    """``--warm`` reports the second pass (seed 1); ``--mesh 2`` without a
    process group raises ``ValueError``."""
    rows = perf_report.main(["--sizes", "24", "--warm", *TINY])
    assert len(_rows(capsys.readouterr().out)) == 1 and len(rows) == 1
    with pytest.raises(ValueError, match="torchrun"):
        perf_report.main(["--sizes", "24", "--mesh", "2", *TINY])
