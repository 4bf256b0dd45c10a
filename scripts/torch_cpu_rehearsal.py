#!/usr/bin/env python3
"""Rehearse the card's solve path on the CPU, before a run on the card.

    python3 scripts/torch_cpu_rehearsal.py [--workloads burgers eikonal darcy] [--krylov]
    python3 scripts/torch_cpu_rehearsal.py --workloads --ranks
    python3 scripts/torch_cpu_rehearsal.py --workloads --reuse

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

``--reuse`` runs ``chip_smoke.py``'s phase ``structure_reuse`` with the
card's numerics: five new problems of one structure, each on a new
``GPSolver``, for the canonical problem, the Darcy inverse problem, phase
4's problem cut to 700/100 and ``mesh_solve``'s cut to 500/100 (on the CPU
nothing is recorded, so every run is eager; the binds and the gates are the
card's).

``--ranks`` runs ``chip_smoke.py``'s phases ``mesh_ranks`` and ``mesh_nccl``
on the CPU in f64 at small sizes (``mesh_elliptic`` 500/100,
``darcy_past_wall`` 300, the NCCL phase's problem 400/100): two gloo ranks
beside the one-device runs, and the NCCL phase's code over gloo on one
rank (there is no NCCL on the CPU).
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
    ap.add_argument("--ranks", action="store_true")
    ap.add_argument("--reuse", action="store_true")
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
        if args.reuse:
            import chip_smoke

            t0 = time.perf_counter()
            reuse = chip_smoke.structure_reuse(
                tpt, torch.device("cpu"), names=("canonical", "darcy", "large", "mesh"),
                sweep=chip_smoke.SWEEP, large_sizes=(700, 100), mesh_sizes=(500, 100))
            print(json.dumps({"structure_reuse_cpu": reuse,
                              "cpu_seconds": time.perf_counter() - t0}), flush=True)
    if args.ranks:
        rehearse_ranks(tpt)


def rehearse_ranks(tpt):
    import torch

    import chip_smoke

    cpu = torch.device("cpu")
    sizes = {"mesh_elliptic": (500, 100), "darcy_past_wall": 300, "nccl": (400, 100)}
    p1 = {}
    for key, w in (("mesh_solve", tpt.workloads.mesh_elliptic(device=cpu, n_domain=500,
                                                               n_boundary=100)),
                   ("mesh_darcy", tpt.workloads.darcy_past_wall(device=cpu, n_domain=300))):
        res, metrics, timing = chip_smoke.mesh_run(w)
        p1[key] = {"metrics": metrics, **timing}
        if key == "mesh_solve":
            p1["z"] = res.z
    t0 = time.perf_counter()
    ranks = chip_smoke.mesh_ranks(cpu, p1, sizes)
    print(json.dumps({"mesh_ranks_cpu": ranks, "one_device": {k: p1[k]["metrics"] for k in
                                                               ("mesh_solve", "mesh_darcy")},
                      "cpu_seconds": time.perf_counter() - t0}), flush=True)
    n, nb = sizes["nccl"]
    Xd, Xb = tpt.utils.sample_random(torch.Generator().manual_seed(0), n, nb)
    prob = tpt.models.nonlinear_elliptic(tpt.SquaredExponential.gaussian(0.2), Xd, Xb,
                                         tpt.workloads.elliptic_rhs(), tpt.workloads.u_elliptic,
                                         seed=1)
    z1 = tpt.GPSolver(prob, nugget=1e-5, mesh=tpt.parallel.make_mesh(1, device=cpu)).solve(4).z
    t0 = time.perf_counter()
    nccl = chip_smoke.mesh_nccl(cpu, z1, sizes, backend="gloo")
    print(json.dumps({"mesh_nccl_cpu_over_gloo": nccl, "cpu_seconds": time.perf_counter() - t0}),
          flush=True)


if __name__ == "__main__":
    main()
