"""Burgers command-line script: u_t + alpha u u_x - nu u_xx = 0 on (t,x) in [0,1]x[-1,1].

Counterpart of ``examples/burgers.py`` (IC u(0,x) = -sin(pi x), truth by
Cole-Hopf and Gauss-Hermite quadrature):

    python -m nonlinpdes_gpsolver_tpu_torch.examples.burgers --kernel anisotropic_gaussian \
        --kernel_parameter 0.3 0.05 --nugget 1e-5 --N_domain 1000 --N_boundary 200 --GNsteps 8
"""

import argparse

import numpy as np
import torch

from .. import GPSolver, models
from ..utils.classical import burgers_cole_hopf_truth
from ..utils.config import SolverConfig, add_config_args, build_kernel, config_from_args, runtime
from ..workloads import BURGERS_DOMAIN, burgers_g, burgers_test
from ._cli import add_solve_args, mesh_setup, sample_points


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    add_config_args(parser, SolverConfig(
        kernel="anisotropic_gaussian", kernel_parameter=[0.3, 0.05],
        nugget=1e-5, N_domain=1000, N_boundary=200, GNsteps=8,
    ))
    parser.add_argument("--alpha", type=float, default=1.0)
    parser.add_argument("--nu", type=float, default=0.02)
    add_solve_args(parser)
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    device, dtype = runtime(cfg)
    device, mesh_kw = mesh_setup(args, device)

    Xd, Xb = sample_points(cfg, device, dtype, BURGERS_DOMAIN, time_dependent=True)
    prob = models.burgers(
        build_kernel(cfg), Xd, Xb, burgers_g, alpha=args.alpha, nu=args.nu,
        init=cfg.initial, seed=cfg.seed,
    )
    solver = GPSolver(prob, nugget=cfg.nugget, nugget_type=cfg.nugget_type,
                      **mesh_kw)
    res = solver.solve(max_iter=cfg.GNsteps, step_size=cfg.step_size,
                       step_solver=args.step_solver, tol=args.tol)
    print(f"[GN] losses: {res.losses}")

    Xt, truth = burgers_test(args.nu, device, dtype)
    errt = GPSolver.errors(res.posterior.extend(Xt), truth)
    print(f"[Test error, space-time] max {errt.max:.4e}  L2 {errt.l2:.4e}")
    # time-slice errors as in the reference notebook
    u_truth = burgers_cole_hopf_truth(args.nu)
    xs = np.linspace(-1, 1, 200)
    for t_slice in (0.2, 0.5, 0.8):
        Xs = torch.as_tensor(np.stack([np.full_like(xs, t_slice), xs], axis=1),
                             dtype=dtype, device=device)
        errs = GPSolver.errors(res.posterior.extend(Xs),
                               torch.as_tensor(u_truth(t_slice, xs), dtype=dtype, device=device))
        print(f"[Test error, t={t_slice}] max {errs.max:.4e}  L2 {errs.l2:.4e}")
    print(f"[Timers] {res.timers}")
    return {"test": errt}


if __name__ == "__main__":
    main()
