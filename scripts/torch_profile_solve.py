#!/usr/bin/env python3
"""Where the device time of one port solve goes, by kernel.

    python3 scripts/torch_profile_solve.py [--sizes 900:124 7800:600]
        [--workloads burgers eikonal darcy mesh_elliptic darcy_past_wall] [--top 12]

For each size (the JAX package's canonical N=900 draw, and the port's
sampler with seed 0 for other sizes) it runs the elliptic solve of
``chip_smoke.py`` (f32, nugget 1e-5, 4 GN steps, extension to a 60x60 grid),
and for each named workload of ``nonlinpdes_gpsolver_tpu_torch/workloads.py``
(the mesh path's ``mesh_elliptic`` and ``darcy_past_wall`` too; ``--sizes``
with no value profiles no elliptic size) its solve and test extensions:
twice cold (on new solvers: the first makes the entry of its structure and
runs its exact loop eagerly, the second records it; ``solvers/_reuse.py``),
then under ``torch.profiler`` twice, each printing one JSON line:
``"solver": "new"``, a new ``GPSolver`` of that structure (its
factorization into the released storage, the recorded loop replayed), and
``"solver": "same"``, that solver's second solve (no factorization). Each
line holds how the new solver bound (``bind``), the synchronized wall
seconds of the profiled run, the device busy time (the union of all kernel
intervals, graph replays' kernels included), the idle share
``1 - busy / wall``, the solver's phase seconds, and the ``--top`` kernels
by total device time with their launch counts. Needs a CUDA card.
"""

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import nonlinpdes_gpsolver_tpu_torch as tpt

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sizes", nargs="*", default=["900:124", "7800:600"])
    ap.add_argument("--workloads", nargs="*", default=[],
                    choices=["elliptic", "burgers", "eikonal", "darcy", "mesh_elliptic",
                             "darcy_past_wall"])
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")

    u_truth, rhs_f = tpt.workloads.u_elliptic, tpt.workloads.elliptic_rhs()
    Xt = tpt.utils.test_grid(60, 60, device=dev)
    truth = torch.func.vmap(u_truth)(Xt)

    def size_case(size):
        n_dom, n_bdy = map(int, size.split(":"))

        def build():
            if (n_dom, n_bdy) == (900, 124):
                inp = tpt.interop.load_canonical_inputs()
                prob = tpt.interop.problem_from_numpy(**inp, device=dev)
            else:
                gen = torch.Generator(device=dev).manual_seed(0)
                Xd, Xb = tpt.utils.sample_random(gen, n_dom, n_bdy)
                prob = tpt.models.nonlinear_elliptic(
                    tpt.SquaredExponential.gaussian(0.2), Xd, Xb, rhs_f, u_truth, seed=1
                )
            return (tpt.GPSolver(prob, nugget=1e-5), 4,
                    lambda res: tpt.GPSolver.errors(res.posterior.extend(Xt), truth).l2)

        return {"n_domain": n_dom, "n_boundary": n_bdy}, build

    def workload_case(name):
        w = getattr(tpt.workloads, name)(device=dev)

        def build():
            mesh = tpt.parallel.make_mesh(1, device=dev) if w.mesh else None
            return (tpt.GPSolver(w.problem, nugget=w.nugget, mesh=mesh), w.max_iter,
                    lambda res: w.metrics(res)["test_l2"])

        return {"workload": name}, build

    def profiled(run):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
        busy_us, cur_s, cur_e = 0.0, None, None
        for s, e in spans:
            if cur_e is None or s > cur_e:
                busy_us += 0.0 if cur_e is None else cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy_us += cur_e - cur_s
        by_name = defaultdict(lambda: [0, 0.0])
        for e in kernels:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[: args.top]
        return out, {
            "wall_s": wall, "device_busy_s": busy_us / 1e6,
            "idle_share": 1.0 - busy_us / 1e6 / wall, "kernel_launches": len(kernels),
            "top_kernels": [{"name": n[:120], "launches": c, "ms": ms} for n, (c, ms) in top],
        }

    from nonlinpdes_gpsolver_tpu_torch.ops import graphs

    cases = [size_case(s) for s in args.sizes] + [workload_case(n) for n in args.workloads]
    for label, build in cases:
        for _ in range(2):  # cold: the entry made, then its loop recorded
            solver, steps, l2_of = build()
            l2_of(solver.solve(max_iter=steps))
            del solver
        torch.cuda.empty_cache()

        def new_solver():
            sv, n, l2 = build()
            res = sv.solve(max_iter=n)
            return sv, res, l2(res)

        def same_solver():
            res = solver.solve(max_iter=steps)
            return solver, res, l2_of(res)

        for kind, run in (("new", new_solver), ("same", same_solver)):
            before = {} if kind == "new" else solver.trace.timers()
            graphs.reset_counts()
            (solver, res, l2), prof_row = profiled(run)
            phases = {k: v - before.get(k, 0.0) for k, v in res.timers.items()}
            bind = {"made": graphs.ENTRIES, "rebound": graphs.REBINDS,
                    "unshared": graphs.UNSHARED, "captures": graphs.CAPTURES}
            print(json.dumps({
                **label, "solver": kind, "bind": bind, **prof_row, "phase_seconds": phases,
                "test_l2": l2, "rungs": res.posterior.fp.rungs,
                "cg_iters": res.state.cg_iters.tolist(),
            }), flush=True)
            del res
        del solver
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({"card": card}), flush=True)


if __name__ == "__main__":
    main()
