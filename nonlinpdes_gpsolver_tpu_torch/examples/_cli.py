"""What the four command-line scripts share: the solve flags, the mesh guard, sampling."""

from __future__ import annotations

import argparse

import torch

from ..utils.config import SolverConfig
from ..utils.sampling import sample_grid, sample_random


def add_solve_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--mesh", type=int, default=0,
                        help="the JAX package's mesh path; not ported (raises if nonzero)")
    parser.add_argument("--step_solver", type=str, default="auto",
                        choices=["auto", "structured", "direct", "cg", "woodbury"])
    parser.add_argument("--tol", type=float, default=None,
                        help="loss-plateau stopping tolerance (GNsteps caps)")


def check_mesh(args: argparse.Namespace) -> None:
    if args.mesh:
        raise NotImplementedError(
            "--mesh runs the distributed mesh path, which is slice 3 of the port "
            "and not ported yet"
        )


def sample_points(cfg: SolverConfig, device, dtype, domain=((0.0, 1.0), (0.0, 1.0)),
                  time_dependent: bool = False):
    """Interior and boundary points on ``device``: a grid, or a random draw
    from a ``torch.Generator`` seeded with ``cfg.seed`` there."""
    if cfg.sampled_type == "grid":
        return sample_grid(cfg.N_domain, cfg.N_boundary, domain, time_dependent,
                           device=device, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    return sample_random(gen, cfg.N_domain, cfg.N_boundary, domain, time_dependent, dtype=dtype)
