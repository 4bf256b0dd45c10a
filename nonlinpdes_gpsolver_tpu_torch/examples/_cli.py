"""What the four command-line scripts share: the solve and mesh flags, sampling."""

from __future__ import annotations

import argparse

import torch

from ..parallel.mesh import make_mesh
from ..utils.config import SolverConfig
from ..utils.sampling import sample_grid, sample_random


def add_solve_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--mesh", type=int, default=0,
                        help="solve on the mesh path over this many devices (0: the dense "
                             "path, or the mesh path past 16,384 Gram rows; only 1 is ported)")
    parser.add_argument("--mesh_block", type=int, default=512,
                        help="rows of a block of the mesh path's factor")
    parser.add_argument("--step_solver", type=str, default="auto",
                        choices=["auto", "structured", "direct", "cg", "woodbury", "normal"])
    parser.add_argument("--tol", type=float, default=None,
                        help="loss-plateau stopping tolerance (GNsteps caps)")


def solver_mesh_args(args: argparse.Namespace, device) -> dict:
    """``GPSolver``'s ``mesh`` and ``mesh_block`` from ``--mesh``/``--mesh_block``
    (``--mesh`` above 1 raises ``NotImplementedError``: slice 4)."""
    mesh = make_mesh(args.mesh, device=device) if args.mesh else None
    return {"mesh": mesh, "mesh_block": args.mesh_block}


def sample_points(cfg: SolverConfig, device, dtype, domain=((0.0, 1.0), (0.0, 1.0)),
                  time_dependent: bool = False):
    """Interior and boundary points on ``device``: a grid, or a random draw
    from a ``torch.Generator`` seeded with ``cfg.seed`` there."""
    if cfg.sampled_type == "grid":
        return sample_grid(cfg.N_domain, cfg.N_boundary, domain, time_dependent,
                           device=device, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    return sample_random(gen, cfg.N_domain, cfg.N_boundary, domain, time_dependent, dtype=dtype)
