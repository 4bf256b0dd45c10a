"""Execution smoke of the port's demo notebooks: each must run end to end.

Twin of ``tests/test_notebooks.py`` for ``nonlinpdes_gpsolver_tpu_torch/
notebooks/``. The recorded outputs there are full size, on the JAX
notebooks' draws; here each notebook runs shrunk by literal substitutions
on its cell sources (a small draw from the port's sampler in place of the
saved draw, 2 GN steps, a small test grid), which exercises every API the
notebook touches without asserting accuracy. Re-record the full outputs
with ``python nonlinpdes_gpsolver_tpu_torch/notebooks/execute_all.py``.
"""

from pathlib import Path

import pytest
from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)

nbformat = pytest.importorskip("nbformat")
nbclient = pytest.importorskip("nbclient")

NB_DIR = Path(__file__).resolve().parent.parent / "nonlinpdes_gpsolver_tpu_torch" / "notebooks"


def _draw(keys):
    return (f"Xd, Xb{', z0' if 'z0' in keys else ''} = (torch.as_tensor(draw[k], dtype=DTYPE, "
            f"device=DEVICE) for k in {keys})")


def _sampled(n, nb, seed, extra=""):
    return (f"Xd, Xb = tpt.utils.sample_random(torch.Generator(DEVICE).manual_seed({seed}), "
            f"{n}, {nb}{extra}); z0 = None")


# (notebook, [(text, replacement), ...]) - shrink sizes and iterations
SHRINK = {
    "elliptic_demo.ipynb": [
        (_draw(('X_domain', 'X_boundary', 'z0')), _sampled(80, 24, 0)),
        ("max_iter=4", "max_iter=2"),
        ("test_grid(60, 60", "test_grid(12, 12"),
    ],
    "burgers_demo.ipynb": [
        (_draw(('X_domain', 'X_boundary', 'z0')),
         _sampled(100, 30, 2, ", domain, time_dependent=True")),
        ("max_iter=12", "max_iter=2"),
        ("test_grid(60, 60", "test_grid(10, 10"),
    ],
    "eikonal_demo.ipynb": [
        (_draw(('X_domain', 'X_boundary')), _sampled(100, 30, 0)),
        ("max_iter=8", "max_iter=2"),
        ("eikonal_cole_hopf_solve(58", "eikonal_cole_hopf_solve(12"),
    ],
    "darcy_inverse_demo.ipynb": [
        (_draw(('X_domain', 'X_boundary', 'z0')), _sampled(60, 20, 9999)),
        ("N_data, noise = 60, 1e-3", "N_data, noise = 15, 1e-3"),
        ("max_iter=8", "max_iter=2"),
        ("darcy_fd_solve(78", "darcy_fd_solve(30"),
    ],
}


def test_every_notebook_has_a_shrink():
    assert sorted(p.name for p in NB_DIR.glob("*_demo.ipynb")) == sorted(SHRINK)


@pytest.mark.parametrize("name", sorted(SHRINK))
def test_notebook_executes(name, monkeypatch):
    monkeypatch.setenv("MPLBACKEND", "Agg")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # beside other test processes
    nb = nbformat.read(NB_DIR / name, as_version=4)
    subs = SHRINK[name]
    hit = {text: False for text, _ in subs}
    for cell in nb.cells:
        if cell.cell_type != "code":
            continue
        src = cell.source
        for text, rep in subs:
            if text in src:
                hit[text] = True
                src = src.replace(text, rep)
        cell.source = src
    missed = [t for t, ok in hit.items() if not ok]
    assert not missed, f"shrink texts out of date for {name}: {missed}"
    assert "DEVICE = 'cpu'" in nb.cells[1].source  # the recorded outputs' device
    client = nbclient.NotebookClient(
        nb, timeout=120, kernel_name="python3",
        resources={"metadata": {"path": str(NB_DIR)}},
    )
    client.execute()  # raises CellExecutionError on any failure
