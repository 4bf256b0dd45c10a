"""What the four command-line scripts share: the solve and mesh flags, sampling."""

from __future__ import annotations

import argparse

import torch

from ..parallel.mesh import initialize_distributed, make_mesh
from ..utils.config import SolverConfig
from ..utils.sampling import sample_grid, sample_random


def add_solve_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--mesh", type=int, default=0,
                        help="solve on the mesh path over this many ranks (0: the dense path, "
                             "or the mesh path past 16,384 Gram rows; more than 1: run under "
                             "`torchrun --nproc_per_node P`)")
    parser.add_argument("--mesh_block", type=int, default=512,
                        help="rows of a block of the mesh path's factor")
    parser.add_argument("--step_solver", type=str, default="auto",
                        choices=["auto", "structured", "direct", "cg", "woodbury", "normal"])
    parser.add_argument("--tol", type=float, default=None,
                        help="loss-plateau stopping tolerance (GNsteps caps)")


def mesh_setup(args: argparse.Namespace, device):
    """``(device, kwargs)``: the device to build the problem on, and
    ``GPSolver``'s ``mesh`` and ``mesh_block`` from ``--mesh``/``--mesh_block``.

    Under ``torchrun`` the process group starts first
    (``parallel.initialize_distributed``: NCCL, or gloo with ``--device cpu``)
    and each rank builds the problem on its own device, ``cuda:{LOCAL_RANK}``.
    ``--mesh`` above 1 without a process group raises ``ValueError``.
    """
    mesh = None
    if args.mesh:
        on_cpu = device.type == "cpu"
        if initialize_distributed(backend="gloo" if on_cpu else "nccl"):
            mesh = make_mesh(args.mesh, device="cpu" if on_cpu else None)
        else:
            mesh = make_mesh(args.mesh, device=device)
        device = mesh.device
    return device, {"mesh": mesh, "mesh_block": args.mesh_block}


def sample_points(cfg: SolverConfig, device, dtype, domain=((0.0, 1.0), (0.0, 1.0)),
                  time_dependent: bool = False):
    """Interior and boundary points on ``device``: a grid, or a random draw
    from a ``torch.Generator`` seeded with ``cfg.seed`` there."""
    if cfg.sampled_type == "grid":
        return sample_grid(cfg.N_domain, cfg.N_boundary, domain, time_dependent,
                           device=device, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    return sample_random(gen, cfg.N_domain, cfg.N_boundary, domain, time_dependent, dtype=dtype)
