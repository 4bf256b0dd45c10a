"""Nonlinear elliptic command-line script: -Delta u + alpha u^m = f on [0,1]^2.

Counterpart of ``examples/elliptic.py`` (manufactured truth
``u = sin(pi x1) sin(pi x2) + 2 sin(4 pi x1) sin(4 pi x2)``, f by autodiff):

    python -m nonlinpdes_gpsolver_tpu_torch.examples.elliptic --kernel gaussian \
        --kernel_parameter 0.2 --nugget 1e-13 --N_domain 900 --N_boundary 124 --GNsteps 4
"""

import argparse

import torch

from .. import GPSolver, models
from ..utils.config import SolverConfig, add_config_args, build_kernel, config_from_args, runtime
from ..utils.sampling import test_grid
from ..workloads import elliptic_rhs, u_elliptic
from ._cli import add_solve_args, mesh_setup, sample_points


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    add_config_args(parser, SolverConfig(nugget=1e-13, N_domain=900, N_boundary=124, GNsteps=4))
    parser.add_argument("--alpha", type=float, default=1.0)
    parser.add_argument("--m", type=int, default=3)
    add_solve_args(parser)
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    device, dtype = runtime(cfg)
    device, mesh_kw = mesh_setup(args, device)

    Xd, Xb = sample_points(cfg, device, dtype)
    relaxed = cfg.method == "relaxation"
    build = models.nonlinear_elliptic_relaxed if relaxed else models.nonlinear_elliptic
    extra = {"pen_lambda": cfg.pen_lambda} if relaxed else {}
    prob = build(
        build_kernel(cfg), Xd, Xb, elliptic_rhs(args.alpha, args.m), u_elliptic,
        alpha=args.alpha, m=args.m, init=cfg.initial, seed=cfg.seed, **extra,
    )
    solver = GPSolver(prob, nugget=cfg.nugget, nugget_type=cfg.nugget_type,
                      **mesh_kw)
    res = solver.solve(max_iter=cfg.GNsteps, step_size=cfg.step_size,
                       step_solver=args.step_solver, tol=args.tol)
    print(f"[GN] losses: {res.losses}")
    print(f"[Timers] {res.timers}")

    # collocation error uses the u-component of the latent
    z_u = res.z[Xd.shape[0]:] if relaxed else res.z
    errc = GPSolver.errors(z_u, torch.func.vmap(u_elliptic)(Xd))
    print(f"[Collocation error] max {errc.max:.4e}  L2 {errc.l2:.4e}")
    Xt = test_grid(60, 60, device=device, dtype=dtype)
    errt = GPSolver.errors(res.posterior.extend(Xt), torch.func.vmap(u_elliptic)(Xt))
    print(f"[Test error] max {errt.max:.4e}  L2 {errt.l2:.4e}")
    return {"collocation": errc, "test": errt}


if __name__ == "__main__":
    main()
