"""The same solves from several source trees in one call, one tree after
another: an A/B of two commits on one card.

    python3 scripts/torch_ab.py --what ranks --roots OLD . . OLD [--repeats 2] \
        [--n_domain 20000 --n_boundary 2500] [--device cpu] [--out FILE]
    python3 scripts/torch_ab.py --what dense --roots OLD . . OLD [--repeats 5]
    python3 scripts/torch_ab.py --what held --roots OLD . . OLD [--repeats 6]
    python3 scripts/torch_ab.py --what sweep --roots OLD . . OLD [--repeats 6]

``--roots`` lists source trees (each a checkout of the repo, e.g. a
``git archive`` of an older commit unpacked into a directory that
``.gitignore`` lists), run in the order given (old, new, new, old). Each
root runs in a fresh process that imports the port from that tree and
builds its kernels there first.

* ``ranks``: two ranks (``chip_smoke.py``'s phase ``mesh_ranks``: gloo, one
  card shared, every collective staged through host memory) run
  ``workloads.mesh_elliptic`` through ``w.solve(mesh)`` once cold and
  ``--repeats`` times warm, and report each run's phase seconds, the step
  solver, the CG iterations and the test L2. The default size is the chip
  smoke test's, 42,500 Gram rows.
* ``dense``: the four reference workloads (``w.solve()``) and the 16,200-row
  elliptic problem of ``chip_smoke.py``'s ``large_solve`` on the dense
  path, each with a new ``GPSolver`` a run (the last run's result dropped
  first, so that a tree that shares one recorded loop among the problems
  of one structure does), once cold and ``--repeats`` times warm: each
  run's end-to-end and Gauss-Newton seconds and captures, and the last
  run's losses.
* ``held``: the canonical problem, Darcy and the 16,200 rows, each
  ``--repeats`` new problems of one structure (the canonical and 16,200-row
  ones on fresh draws of the sampler, seeds 1, 2, ...), solved as ``res =
  GPSolver(p).solve()``: each run's result kept until the next run's solve
  returns. Per run: end-to-end and Gauss-Newton seconds, captures, how the
  factorization bound (made, rebound, unshared), and the allocated and
  reserved peaks; and the last run's losses.
* ``sweep``: the same cases solved as a sweep that keeps every solver and
  result to the end, ``--repeats`` problems each, and the 42,500-row mesh
  case (``workloads.mesh_elliptic`` at ``--n_domain``/``--n_boundary``, on
  seeds 1, 2, ...) with four. Per run
  the same numbers (a guest counts as ``guest``), the allocated and
  reserved memory after it, and the guest loads.

One JSON line a root goes to stdout and, with ``--out``, to that file.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

HERE = os.path.abspath(__file__)


def rank_main(rank, world, port, root, device, n, nb, repeats, tmp):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    sys.path.insert(0, root)
    import torch
    import torch.distributed as dist

    import nonlinpdes_gpsolver_tpu_torch as tpt
    from nonlinpdes_gpsolver_tpu_torch.parallel import initialize_distributed, make_mesh

    try:
        initialize_distributed(backend="gloo")
        mesh = make_mesh(world, device=device)
        w = tpt.workloads.mesh_elliptic(device=mesh.device, n_domain=n, n_boundary=nb)
        runs = []
        for _ in range(1 + repeats):
            t0 = time.perf_counter()
            res = w.solve(mesh)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            runs.append({"seconds": time.perf_counter() - t0, "phase_seconds": res.timers})
        out = {"rank": rank, "runs": runs, "step_solver": res.state.step_solver,
               "cg_iters": res.state.cg_iters.tolist(),
               "test_l2": w.metrics(res)["test_l2"]}
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def dense_runs(tpt, device, repeats):
    """``--what dense`` in one root: ``{name: {"runs": [[e2e, gn, captures],
    ...], "losses": [...]}}``."""
    import torch

    from nonlinpdes_gpsolver_tpu_torch.ops import graphs

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    def large():
        Xd, Xb = tpt.utils.sample_random(torch.Generator(device=device).manual_seed(0), 7800,
                                         600)
        prob = tpt.models.nonlinear_elliptic(tpt.SquaredExponential.gaussian(0.2), Xd, Xb,
                                             tpt.workloads.elliptic_rhs(),
                                             tpt.workloads.u_elliptic, seed=1)
        return lambda: tpt.GPSolver(prob, nugget=1e-5, auto_mesh=False).solve(max_iter=4)

    cases = {name: getattr(tpt.workloads, name)(device=device).solve
             for name in ("elliptic", "burgers", "eikonal", "darcy")}
    cases["large"] = large()
    out = {}
    for name, solve in cases.items():
        runs, res = [], None
        for _ in range(1 + repeats):
            res = None
            graphs.reset_counts()
            t0 = time.perf_counter()
            res = solve()
            sync()
            runs.append([time.perf_counter() - t0, res.timers["gauss_newton"], graphs.CAPTURES])
        out[name] = {"runs": runs, "losses": res.state.losses.tolist()}
        del res
    return out


def held_runs(tpt, device, runs, large=(7800, 600), sweep=False, mesh=(20000, 2500)):
    """``--what held`` (``sweep``: ``--what sweep``) in one root: ``{name:
    {"runs": [{...}, ...], "losses": [...]}}`` (``large``, ``mesh``: the
    16,200- and 42,500-row cases' N_domain and N_boundary)."""
    import torch

    from nonlinpdes_gpsolver_tpu_torch.ops import graphs

    cuda = torch.device(device).type == "cuda"
    W = tpt.workloads

    def elliptic(n_domain, n_boundary):
        def make(k):
            Xd, Xb = tpt.utils.sample_random(torch.Generator(device=device).manual_seed(k),
                                             n_domain, n_boundary)
            return tpt.models.nonlinear_elliptic(tpt.SquaredExponential.gaussian(0.2), Xd, Xb,
                                                 W.elliptic_rhs(), W.u_elliptic, seed=k)
        return make, 1e-5, 4

    darcy = W.darcy(device=device)
    cases = {"canonical": elliptic(900, 124),
             "darcy": (lambda k: W.darcy(device=device).problem, darcy.nugget, darcy.max_iter),
             "large": elliptic(*large)}
    if sweep:  # four problems: about 7.4 GB of factor each
        cases["mesh"] = (lambda k: W.mesh_elliptic(device=device, n_domain=mesh[0],
                                                   n_boundary=mesh[1], seed=k).problem, 1e-5, 4)
    out = {}
    for name, (make, nugget, max_iter) in cases.items():
        tpt.clear_graph_cache()
        if cuda:
            torch.cuda.empty_cache()
        rows, res, kept = [], None, []
        for k in range(4 if name == "mesh" else runs):
            problem = make(1 + k)
            if cuda:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            graphs.reset_counts()
            t0 = time.perf_counter()
            res = tpt.GPSolver(problem, nugget=nugget,
                               auto_mesh=name == "mesh").solve(max_iter=max_iter)
            if cuda:
                torch.cuda.synchronize(device)
            rows.append({
                "e2e_seconds": time.perf_counter() - t0,
                "gn_seconds": res.timers["gauss_newton"], "captures": graphs.CAPTURES,
                "replays": graphs.REPLAYS,
                "bind": (["made"] * graphs.ENTRIES + ["rebound"] * graphs.REBINDS
                         + ["unshared"] * graphs.UNSHARED
                         + ["guest"] * getattr(graphs, "GUESTS", 0)),
                "guest_loads": getattr(graphs, "GUEST_LOADS", None),
                "max_memory_allocated": torch.cuda.max_memory_allocated(device) if cuda else None,
                "max_memory_reserved": torch.cuda.max_memory_reserved(device) if cuda else None,
                "memory_allocated": torch.cuda.memory_allocated(device) if cuda else None,
                "memory_reserved": torch.cuda.memory_reserved(device) if cuda else None})
            if sweep:
                kept.append(res)
        out[name] = {"runs": rows, "losses": res.state.losses.tolist()}
        del res, kept
    tpt.clear_graph_cache()
    return out


def child(what, root, device, n, nb, repeats):
    """One root: build its kernels, then run ``what``."""
    sys.path.insert(0, root)
    import torch.multiprocessing as mp

    import nonlinpdes_gpsolver_tpu_torch as tpt

    if device.startswith("cuda"):
        from nonlinpdes_gpsolver_tpu_torch.ops import gram_tile

        gram_tile._kernel_lib()
    if what in ("dense", "held", "sweep"):
        t0 = time.perf_counter()
        cases = (dense_runs(tpt, device, repeats) if what == "dense"
                 else held_runs(tpt, device, repeats, sweep=what == "sweep", mesh=(n, nb)))
        print(json.dumps({"root": root, "package": os.path.dirname(tpt.__file__),
                          "seconds": time.perf_counter() - t0, "cases": cases}))
        return
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_main, args=(2, port, root, device, n, nb, repeats, tmp), nprocs=2,
                 join=True)
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
    print(json.dumps({"root": root, "package": os.path.dirname(tpt.__file__),
                      "seconds": time.perf_counter() - t0, "ranks": ranks}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--what", choices=("ranks", "dense", "held", "sweep"), default="ranks")
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--n_domain", type=int, default=20000)
    ap.add_argument("--n_boundary", type=int, default=2500)
    ap.add_argument("--repeats", type=int, default=None,
                    help="warm runs a root (default: 2 for ranks, 5 for dense, 6 for held "
                         "and sweep)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.repeats is None:
        args.repeats = {"ranks": 2, "dense": 5, "held": 6, "sweep": 6}[args.what]
    if args.child is not None:
        child(args.what, args.child, args.device, args.n_domain, args.n_boundary, args.repeats)
        return
    card = ""
    if args.device.startswith("cuda"):
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True).stdout
        print(card.strip())
    for root in args.roots:
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, HERE, "--what", args.what, "--child", root,
                               "--device", args.device,
                               "--n_domain", str(args.n_domain), "--n_boundary",
                               str(args.n_boundary), "--repeats", str(args.repeats)],
                              capture_output=True, text=True, cwd=root)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"root {root}: exit {proc.returncode}")
        line = proc.stdout.strip().splitlines()[-1]
        rec = json.loads(line)
        rec["what"], rec["card"] = args.what, card.strip()
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")


if __name__ == "__main__":
    main()
