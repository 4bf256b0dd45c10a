"""Regularized Eikonal command-line script: |grad u|^2 = f^2 + eps Delta u on [0,1]^2, u=0
on the boundary, f = 1.

Counterpart of ``examples/eikonal.py`` (truth by the Cole-Hopf FD solve on
the 58x58 interior grid):

    python -m nonlinpdes_gpsolver_tpu_torch.examples.eikonal --kernel gaussian \
        --kernel_parameter 0.2 --nugget 1e-5 --N_domain 1000 --N_boundary 200 --GNsteps 8
"""

import argparse

import torch

from .. import GPSolver, models
from ..utils.config import SolverConfig, add_config_args, build_kernel, config_from_args, runtime
from ..workloads import eikonal_test
from ._cli import add_solve_args, mesh_setup, sample_points


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    add_config_args(parser, SolverConfig(
        nugget=1e-5, N_domain=1000, N_boundary=200, GNsteps=8, initial="zero",
    ))
    parser.add_argument("--eps", type=float, default=0.1)
    add_solve_args(parser)
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    device, dtype = runtime(cfg)
    device, mesh_kw = mesh_setup(args, device)

    Xd, Xb = sample_points(cfg, device, dtype)
    prob = models.eikonal(
        build_kernel(cfg), Xd, Xb, rhs_f=lambda x: torch.ones_like(x[0]), eps=args.eps,
        init=cfg.initial, seed=cfg.seed,
    )
    solver = GPSolver(prob, nugget=cfg.nugget, nugget_type=cfg.nugget_type,
                      **mesh_kw)
    res = solver.solve(max_iter=cfg.GNsteps, step_size=cfg.step_size,
                       step_solver=args.step_solver, tol=args.tol)
    print(f"[GN] losses: {res.losses}")

    Xt, truth = eikonal_test(args.eps, device, dtype)
    errt = GPSolver.errors(res.posterior.extend(Xt), truth)
    print(f"[Test error] max {errt.max:.4e}  L2 {errt.l2:.4e}")
    print(f"[Timers] {res.timers}")
    return {"test": errt}


if __name__ == "__main__":
    main()
