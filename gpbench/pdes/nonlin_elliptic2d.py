"""The benchmark's side of ``nonlin_elliptic2d``: draws, the program's
problem, its outputs and gates, and the Gram work the kernels do.

A draw (one solve of the stream) is the interior and boundary points from
the frozen sampler and the latent start ``z0``, all from one
``torch.Generator`` on the device, seeded per solve. The program gets them
through its public model constructor, with the right-hand side and the
boundary values as callables of one point (``frozen/truths.py``), as a
user script passes them.
"""

from __future__ import annotations

import torch

from gpbench.frozen import roofline as rl
from gpbench.frozen.sampling import sample_random, test_grid
from gpbench.frozen.truths import elliptic_rhs, u_elliptic

OUTPUTS = ("u", "z")


def setup(cfg: dict, device, dtype) -> dict:
    X_test = test_grid(cfg["test_grid"], cfg["test_grid"], dtype, device)
    return {"X_test": X_test, "truth": torch.func.vmap(u_elliptic)(X_test),
            "rhs": elliptic_rhs()}


def draw(cfg: dict, sizes: dict, gen: torch.Generator, dtype, ctx: dict) -> dict:
    device = gen.device
    Xd, Xb = sample_random(gen, sizes["n_domain"], sizes["n_boundary"], dtype)
    z0 = torch.randn(sizes["n_domain"], generator=gen, dtype=dtype, device=device)
    return {"X_domain": Xd, "X_boundary": Xb, "z0": z0}


def build(tpt, cfg: dict, inputs: dict, ctx: dict):
    return tpt.models.nonlinear_elliptic(
        tpt.SquaredExponential.gaussian(cfg["sigma"]), inputs["X_domain"], inputs["X_boundary"],
        ctx["rhs"], u_elliptic)


def extend(result, ctx: dict) -> dict:
    return {"u": result.posterior.extend(ctx["X_test"]), "z": result.z}


def gate_values(outputs: dict, ctx: dict) -> torch.Tensor:
    """``[test_l2]`` on the device: the RMS error against the truth."""
    e = outputs["u"] - ctx["truth"]
    return torch.sqrt(torch.mean(e * e)).reshape(1)


GATES = ("test_l2",)


def kernel_work(cfg: dict, sizes: dict, esize: int, ctx: dict) -> dict:
    """Per solve: K1 writes the Gram matrix and the test cross-Gram."""
    nd, nb = sizes["n_domain"], sizes["n_boundary"]
    segs = [(rl.LAPLACIAN, nd), (rl.IDENTITY, nd), (rl.IDENTITY, nb)]
    rows = ctx["X_test"].shape[0]
    return {"k1": rl.gram_work(segs, nd + nb, esize) + rl.cross_work(rows, rl.IDENTITY, segs,
                                                                     nd + nb, esize)}
