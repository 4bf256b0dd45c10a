#!/usr/bin/env python3
"""Rehearse the card's solve path on the CPU, before a run on the card.

    python3 scripts/torch_cpu_rehearsal.py [--workloads burgers eikonal darcy] [--krylov]

The port picks its numerics by device (``ops/backend.py::is_accelerator``):
on the card, ``solve_mode='inverse'`` with the Newton step, the
``'structured'`` GN step and the controlled SPD solve. This script turns
that rule on for CPU tensors (``ops/backend.py::card_numerics_on_cpu``),
runs each named workload of
``nonlinpdes_gpsolver_tpu_torch/workloads.py`` in f32 and prints one JSON
line with its metrics, gate failures, rungs and losses; with ``--krylov``
it runs ``chip_smoke.krylov_steps`` on the CPU. The Gram kernel's plain
version stands in for the kernel, so the results predict the card's to
rounding only, and its seconds are CPU seconds, not device times.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workloads", nargs="*", default=["burgers", "eikonal", "darcy"],
                    choices=["elliptic", "burgers", "eikonal", "darcy"])
    ap.add_argument("--krylov", action="store_true")
    args = ap.parse_args()

    import torch

    import nonlinpdes_gpsolver_tpu_torch as tpt
    from nonlinpdes_gpsolver_tpu_torch.ops.backend import card_numerics_on_cpu

    with card_numerics_on_cpu():
        for name in args.workloads:
            w = tpt.workloads.WORKLOADS[name](device="cpu", dtype=torch.float32)
            t0 = time.perf_counter()
            res = w.solve()
            metrics = w.metrics(res)
            print(json.dumps({
                "workload": name, "cpu_seconds": time.perf_counter() - t0, "metrics": metrics,
                "failures": w.failures(metrics), "rungs": res.posterior.fp.rungs,
                "losses": res.state.losses.tolist(),
            }), flush=True)
        if args.krylov:
            import chip_smoke

            steps = chip_smoke.krylov_steps(tpt, torch.device("cpu"))
            print(json.dumps({"krylov_steps_cpu": steps}), flush=True)


if __name__ == "__main__":
    main()
