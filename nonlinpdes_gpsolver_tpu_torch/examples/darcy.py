"""Darcy-flow inverse command-line script: infer a and u in -div(a grad u) = 1 on [0,1]^2
from noisy point values of u.

Counterpart of ``examples/darcy.py`` (truth
``a = exp(sin(2 pi x1) + sin(2 pi x2)) + exp(-sin(2 pi x1) - sin(2 pi x2))``,
observations from an 80x80 finite-volume solve interpolated to the data
points, plus Gaussian noise):

    python -m nonlinpdes_gpsolver_tpu_torch.examples.darcy --kernel gaussian \
        --kernel_parameter 0.2 --nugget 1e-8 --N_domain 400 --N_boundary 100 \
        --N_data 60 --noise_level 0.001 --GNsteps 8
"""

import argparse

import torch

from .. import GPSolver, models
from ..utils.config import SolverConfig, add_config_args, build_kernel, config_from_args, runtime
from ..workloads import darcy_observations, darcy_test, darcy_truth
from ._cli import add_solve_args, mesh_setup, sample_points


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    add_config_args(parser, SolverConfig(nugget=1e-8, N_domain=400, N_boundary=100,
                                         GNsteps=8, seed=9999))
    parser.add_argument("--N_data", type=int, default=60)
    parser.add_argument("--noise_level", type=float, default=1e-3)
    add_solve_args(parser)
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    device, dtype = runtime(cfg)
    device, mesh_kw = mesh_setup(args, device)

    truth = darcy_truth()  # the FD solve on the 80x80 grid (boundary ring included)
    Xd, Xb = sample_points(cfg, device, dtype)
    X_data = Xd[: args.N_data].cpu().double().numpy()
    noisy = darcy_observations(X_data, args.noise_level, cfg.seed, truth)
    kernel = build_kernel(cfg)
    prob = models.darcy_flow(
        kernel, kernel, Xd, Xb, torch.as_tensor(noisy), rhs_f=lambda x: torch.ones_like(x[0]),
        noise_level=args.noise_level, init=cfg.initial, seed=cfg.seed,
    )
    solver = GPSolver(prob, nugget=cfg.nugget, nugget_type=cfg.nugget_type,
                      **mesh_kw)
    res = solver.solve(max_iter=cfg.GNsteps, step_size=cfg.step_size,
                       step_solver=args.step_solver, tol=args.tol)
    print(f"[GN] losses: {res.losses}")

    Xt, u_true, a_true = darcy_test(device, dtype, truth)
    err_u = GPSolver.errors(res.posterior.extend(Xt, block="u"), u_true)
    err_a = GPSolver.errors(torch.exp(res.posterior.extend(Xt, block="a")), a_true)
    rel_a = err_a.l2 / float(torch.sqrt(torch.mean(a_true**2)))
    print(f"[Test error u] max {err_u.max:.4e}  L2 {err_u.l2:.4e}")
    print(f"[Test error a] max {err_a.max:.4e}  L2 {err_a.l2:.4e}  rel-L2 {rel_a:.3f}")
    print(f"[Timers] {res.timers}")
    return {"u": err_u, "a": err_a, "a_rel_l2": rel_a}


if __name__ == "__main__":
    main()
