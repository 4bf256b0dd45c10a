#!/usr/bin/env python
"""Execute every demo notebook of the port in place, recording outputs.

Counterpart of the JAX package's ``notebooks/execute_all.py``, for the
port's notebooks beside this file. Each notebook runs on the CPU in float64
(its first cell sets ``DEVICE = 'cpu'``) on the JAX notebook's own draw, so
that its recorded numbers stand beside the JAX notebook's. Run after any
change that could shift the recorded numbers:

    python nonlinpdes_gpsolver_tpu_torch/notebooks/execute_all.py            # all four
    python nonlinpdes_gpsolver_tpu_torch/notebooks/execute_all.py elliptic   # substring filter

A fast execution smoke (tiny sizes, no recording) runs with the tests:
``tests/test_torch_notebooks.py``.
"""

import sys
import time
from pathlib import Path

import nbformat
from nbclient import NotebookClient

HERE = Path(__file__).resolve().parent


def execute(path: Path) -> float:
    nb = nbformat.read(path, as_version=4)
    t0 = time.time()
    client = NotebookClient(
        nb,
        timeout=1800,
        kernel_name="python3",
        resources={"metadata": {"path": str(HERE)}},
    )
    client.execute()
    nbformat.write(nb, path)
    return time.time() - t0


def main():
    pattern = sys.argv[1] if len(sys.argv) > 1 else ""
    for path in sorted(HERE.glob("*_demo.ipynb")):
        if pattern and pattern not in path.name:
            continue
        print(f"executing {path.name} ...", flush=True)
        dt = execute(path)
        print(f"  done in {dt:.1f}s", flush=True)


if __name__ == "__main__":
    main()
