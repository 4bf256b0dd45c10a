"""Per-phase seconds and TFLOP/s of the four reference workloads at one or more sizes.

Counterpart of ``examples/perf_report.py``, with its flags, less
``--platform``; ``--device`` (default ``cuda``) and ``--x64/--no-x64`` pick
where and in which dtype it runs::

    python -m nonlinpdes_gpsolver_tpu_torch.examples.perf_report --sizes 900 7800 --warm
    python -m nonlinpdes_gpsolver_tpu_torch.examples.perf_report --workload darcy --mesh 1 \
        --sizes 3000 --warm

``--workload`` selects the problem family at its reference CLI configuration
(elliptic, burgers, eikonal; darcy: the inverse problem with ``--N_data``
observations at ``--noise_level``); ``--sizes`` scales N_domain. Points come
from the port's sampler, a ``torch.Generator`` seeded with the run's seed
(0, and 1 for the ``--warm`` pass), not the JAX package's draws. ``--mesh
P`` solves on the mesh path over P ranks (1: the card alone; more: under
``torchrun``), with ``--mesh_block``-row blocks and ``--superblock``-column
superblocks. Each phase ends in ``torch.cuda.synchronize()``. TF/s are the
JAX package's FLOP model (``utils/profiling.py``) over a phase's seconds:
the model's count, not a share of the card's peak.
"""

import argparse
import time

import numpy as np
import torch

from .. import GPSolver, models
from ..ops.kernels import SquaredExponential
from ..solvers import Posterior, factorize, gn_solve
from ..solvers.distributed import DistributedPosterior, factorize_distributed, gn_solve_distributed
from ..utils.config import SolverConfig, runtime
from ..utils.profiling import flop_model, tflops
from ..utils.sampling import sample_random
from ..workloads import (
    BURGERS_DOMAIN,
    burgers_g,
    burgers_test,
    darcy_observations,
    darcy_test,
    darcy_truth,
    eikonal_test,
    elliptic_rhs,
    u_elliptic,
)
from ._cli import mesh_setup

HEADER = (f"{'N':>7} {'factor_s':>9} {'gn_s':>8} {'post_s':>8} "
          f"{'chol_TF/s':>10} {'gn_TF/s':>9} {'gn_it/s':>8} {'test_L2':>10}")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("--workload", type=str, default="elliptic",
                        choices=["elliptic", "burgers", "eikonal", "darcy"])
    parser.add_argument("--sizes", type=int, nargs="+", default=[900, 2000])
    parser.add_argument("--gn_steps", type=int, default=4)
    parser.add_argument("--nugget", type=float, default=1e-5)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--x64", action=argparse.BooleanOptionalAction, default=None,
                        help="f64 (or f32 with --no-x64); unset, the device's default")
    parser.add_argument("--warm", action="store_true",
                        help="run each size twice and report the second pass")
    parser.add_argument("--mesh", type=int, default=0,
                        help="solve on the mesh path over this many ranks (1 is valid: the "
                             "device alone)")
    parser.add_argument("--mesh_block", type=int, default=512)
    parser.add_argument("--superblock", type=int, default=2048)
    parser.add_argument("--step_solver", type=str, default="auto",
                        choices=["auto", "direct", "cg", "structured", "normal", "woodbury"])
    parser.add_argument("--cg_maxiter", type=int, default=None)
    parser.add_argument("--cg_tol", type=float, default=None)
    parser.add_argument("--tol", type=float, default=None,
                        help="loss-plateau stopping tolerance (gn_steps caps)")
    parser.add_argument("--test_grid", type=int, default=60)
    parser.add_argument("--N_data", type=int, default=60)
    parser.add_argument("--noise_level", type=float, default=1e-3)
    return parser.parse_args(argv)


def builders(args, device, dtype):
    """workload -> ``build(N, seed)``: ``(problem, X_test, truth, extra)``,
    ``extra(posterior)`` a note for the row (Darcy's relative L2 of ``a``)."""
    G = args.test_grid

    def points(N, n_b, seed, domain=((0.0, 1.0), (0.0, 1.0)), time_dependent=False):
        gen = torch.Generator(device=device).manual_seed(seed)
        return sample_random(gen, N, n_b, domain, time_dependent, dtype=dtype)

    def make_elliptic(N, seed):
        from ..utils.sampling import test_grid

        Xd, Xb = points(N, max(4, N // 8), seed)
        prob = models.nonlinear_elliptic(SquaredExponential.gaussian(0.2), Xd, Xb,
                                         elliptic_rhs(), u_elliptic, seed=seed + 1)
        Xt = test_grid(G, G, device=device, dtype=dtype)
        return prob, Xt, torch.func.vmap(u_elliptic)(Xt), None

    def make_burgers(N, seed):
        Xd, Xb = points(N, max(4, N // 5), seed, BURGERS_DOMAIN, True)
        kernel = SquaredExponential.anisotropic([0.3, 0.05], "lengthscale")
        prob = models.burgers(kernel, Xd, Xb, burgers_g, nu=0.02, seed=seed + 1)
        Xt, truth = burgers_test(0.02, device, dtype, G)
        return prob, Xt, truth, None

    def make_eikonal(N, seed):
        Xd, Xb = points(N, max(4, N // 5), seed)
        prob = models.eikonal(SquaredExponential.gaussian(0.2), Xd, Xb,
                              lambda x: torch.ones_like(x[0]), eps=0.1, init="zero",
                              seed=seed + 1)
        Xt, truth = eikonal_test(0.1, device, dtype)
        return prob, Xt, truth, None

    truth_darcy = darcy_truth() if args.workload == "darcy" else None

    def make_darcy(N, seed):
        Xd, Xb = points(N, max(4, N // 4), seed)
        noisy = darcy_observations(Xd[: args.N_data].cpu().double().numpy(), args.noise_level,
                                   seed, truth_darcy)
        kernel = SquaredExponential.gaussian(0.2)
        prob = models.darcy_flow(kernel, kernel, Xd, Xb, torch.as_tensor(noisy),
                                 lambda x: torch.ones_like(x[0]), noise_level=args.noise_level,
                                 seed=seed + 1)
        Xt, u_true, a_true = darcy_test(device, dtype, truth_darcy)

        def extra(post):
            pred_a = torch.exp(post.extend(Xt, block="a"))
            rel = GPSolver.errors(pred_a, a_true).l2 / float(torch.sqrt(torch.mean(a_true**2)))
            return f"a_relL2 {rel:.3f}"

        return prob, Xt, u_true, extra

    return {"elliptic": make_elliptic, "burgers": make_burgers, "eikonal": make_eikonal,
            "darcy": make_darcy}


def main(argv=None):
    """Print the table; return its rows (dicts of the printed numbers)."""
    args = parse_args(argv)
    device, dtype = runtime(SolverConfig(device=args.device, x64=args.x64))
    device, mesh_kw = mesh_setup(args, device)
    mesh = mesh_kw["mesh"]
    build = builders(args, device, dtype)[args.workload]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    step_kw = {k: v for k, v in (("cg_maxiter", args.cg_maxiter), ("cg_tol", args.cg_tol))
               if v is not None}
    print(f"workload={args.workload} device={device} dtype={str(dtype).split('.')[1]} "
          f"mesh={args.mesh or 'off'} solver={args.step_solver}")
    print(HEADER)

    def run(N, seed):
        prob, Xt, truth, extra = build(N, seed)
        sync()
        t0 = time.perf_counter()
        if mesh is not None:
            fp = factorize_distributed(prob, mesh, nugget=args.nugget, block=args.mesh_block,
                                       superblock_cols=args.superblock)
            sync()
            t1 = time.perf_counter()
            st = gn_solve_distributed(fp, max_iter=args.gn_steps, step_solver=args.step_solver,
                                      tol=args.tol, **step_kw)
            sync()
            t2 = time.perf_counter()
            post = DistributedPosterior(fp, st.z)
        else:
            fp = factorize(prob, nugget=args.nugget)
            sync()
            t1 = time.perf_counter()
            st = gn_solve(fp, max_iter=args.gn_steps, step_solver=args.step_solver, tol=args.tol,
                          **step_kw)
            sync()
            t2 = time.perf_counter()
            post = Posterior(fp, st.z)
        pred = post.extend(Xt, block="u" if args.workload == "darcy" else None)
        sync()
        t3 = time.perf_counter()
        err = GPSolver.errors(pred, truth)
        note = extra(post) if extra else ""
        iters = st.cg_iters.tolist()
        if any(iters):
            note = f"{note} cg_iters {iters}".strip()
        return prob, (t1 - t0, t2 - t1, t3 - t2), err, note

    rows = []
    for N in args.sizes:
        prob, ts, err, note = run(N, 0)
        if args.warm:
            prob, ts, err, note = run(N, 1)
        fm = flop_model(prob, gn_iters=args.gn_steps)
        row = {"N": N, "factor_s": ts[0], "gn_s": ts[1], "post_s": ts[2],
               "chol_TF/s": tflops(fm["cholesky"], ts[0]), "gn_TF/s": tflops(fm["gn_total"], ts[1]),
               "gn_it/s": args.gn_steps / ts[1], "test_L2": err.l2, "note": note}
        rows.append(row)
        print(f"{N:>7} {ts[0]:>9.3f} {ts[1]:>8.3f} {ts[2]:>8.3f} {row['chol_TF/s']:>10.2f} "
              f"{row['gn_TF/s']:>9.2f} {row['gn_it/s']:>8.1f} {err.l2:>10.3e}  {note}", flush=True)
    return rows


if __name__ == "__main__":
    main()
