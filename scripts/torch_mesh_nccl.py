#!/usr/bin/env python3
"""The mesh path on every visible card, one rank each over NCCL, beside one card.

    python3 scripts/torch_mesh_nccl.py [--n_domain 20000] [--n_boundary 2500]

On a machine with P cards: the elliptic problem of ``chip_smoke.py``'s
phase ``mesh_nccl`` (sigma 0.2, nugget 1e-5, 4 GN steps, the port's sampler
with seed 0; 2 N_domain + N_boundary Gram rows) first on card 0 alone
(``make_mesh(1)``, cold then warm, then its Gauss-Newton loop alone,
replayed and eagerly: ``chip_smoke.gn_replayed_and_eager``), then on P
ranks over NCCL (``chip_smoke.mesh_nccl``: each rank on its own card, its
loop recorded with the NCCL collectives inside; cold, warm, the loop
replayed against its eager run, bitwise, and a second problem of the
layout that rebinds with no capture, bitwise its unshared solve). It
prints one JSON line: each run's seconds (end to end and by phase), GN
seconds and ms a CG iteration replayed and eager, captures, replays, host
reads and collectives, test L2, peak memory a rank and CG iterations, and
the P-rank solution's distance from the one-card one; then the cards'
names and power limits. The default size is ``mesh_elliptic``'s, 42,500
Gram rows. ``--device cpu`` rehearses it on the CPU over gloo with 4 ranks
(CPU seconds, not device times).
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n_domain", type=int, default=20000)
    ap.add_argument("--n_boundary", type=int, default=2500)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    import chip_smoke
    import nonlinpdes_gpsolver_tpu_torch as tpt

    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("no CUDA card is visible")
    n, nb = args.n_domain, args.n_boundary
    Xd, Xb = tpt.utils.sample_random(torch.Generator(device=dev).manual_seed(0), n, nb)
    prob = tpt.models.nonlinear_elliptic(tpt.SquaredExponential.gaussian(0.2), Xd, Xb,
                                         tpt.workloads.elliptic_rhs(), tpt.workloads.u_elliptic,
                                         seed=1)
    Xt = tpt.utils.test_grid(60, 60, device=dev)
    truth = torch.func.vmap(tpt.workloads.u_elliptic)(Xt)
    one = tpt.parallel.make_mesh(1, device=dev)

    def run():
        t0 = time.perf_counter()
        res = tpt.GPSolver(prob, nugget=1e-5, mesh=one).solve(max_iter=4)
        err = tpt.GPSolver.errors(res.posterior.extend(Xt), truth)
        chip_smoke.sync(dev)
        return res, err, time.perf_counter() - t0

    cold = run()[2]
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    res, err, secs = run()
    single = {"cold_seconds": cold, "e2e_seconds": secs, "phase_seconds": res.timers,
              "test_l2": err.l2, "cg_iters": res.state.cg_iters.tolist(),
              "step_solver": res.state.step_solver,
              "max_memory_allocated": torch.cuda.max_memory_allocated() if on_card else None}
    single["gn"], _ = chip_smoke.gn_replayed_and_eager(res.posterior.fp, 4)
    z1 = res.z
    del res
    if on_card:
        torch.cuda.empty_cache()
    sizes = {"nccl": (n, nb)}
    t0 = time.perf_counter()
    if on_card:
        ranks = chip_smoke.mesh_nccl(dev, z1, sizes)
    else:  # a CPU rehearsal: four gloo ranks
        ranks = chip_smoke.mesh_nccl(dev, z1, sizes, backend="gloo", world=4)
    print(json.dumps({"gram_rows": 2 * n + nb, "one_card": single, "ranks": ranks,
                      "seconds": time.perf_counter() - t0}), flush=True)
    if on_card:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
