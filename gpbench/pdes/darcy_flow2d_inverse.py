"""The benchmark's side of ``darcy_flow2d_inverse``: draws, the program's
problem, its outputs and gates, and the Gram work the kernels do.

Set-up solves the 80x80 finite-volume truth once and puts it on the
device. A draw is the interior and boundary points from the frozen
sampler, the latent start ``z0`` and the observation noise, all from one
``torch.Generator`` on the device, seeded per solve; the observations are
the truth interpolated bilinearly to the first ``n_obs`` interior points
plus that noise. The program gets them through its public model
constructor (``f = 1`` as values, ``u = 0`` on the boundary).
"""

from __future__ import annotations

import numpy as np
import torch

from gpbench.frozen import roofline as rl
from gpbench.frozen.sampling import sample_random
from gpbench.frozen.truths import bilinear, darcy_a, darcy_truth

OUTPUTS = ("u", "a", "z")


def setup(cfg: dict, device, dtype) -> dict:
    xs, ys, U = darcy_truth()
    X1, X2 = np.meshgrid(xs, ys)
    kw = dict(dtype=dtype, device=device)
    return {
        "xs": xs, "U": torch.as_tensor(U, dtype=torch.float64, device=device),
        "X_test": torch.as_tensor(np.stack([X1.ravel(), X2.ravel()], axis=1), **kw),
        "truth": torch.as_tensor(U.ravel(), **kw),
        "a_truth": torch.as_tensor(darcy_a(X1, X2).ravel(), **kw),
    }


def draw(cfg: dict, sizes: dict, gen: torch.Generator, dtype, ctx: dict) -> dict:
    device = gen.device
    nd, nb, k = sizes["n_domain"], sizes["n_boundary"], sizes["n_obs"]
    Xd, Xb = sample_random(gen, nd, nb, dtype)
    z0 = torch.randn(6 * nd, generator=gen, dtype=dtype, device=device)
    noise = torch.randn(k, generator=gen, dtype=torch.float64, device=device)
    obs = bilinear(ctx["xs"], ctx["U"], Xd[:k]) + cfg["noise"] * noise
    return {"X_domain": Xd, "X_boundary": Xb, "z0": z0, "obs": obs.to(dtype)}


def build(tpt, cfg: dict, inputs: dict, ctx: dict):
    k = tpt.SquaredExponential.gaussian(cfg["sigma"])
    Xd = inputs["X_domain"]
    return tpt.models.darcy_flow(k, k, Xd, inputs["X_boundary"], inputs["obs"],
                                 torch.ones(Xd.shape[0], dtype=Xd.dtype, device=Xd.device),
                                 noise_level=cfg["noise"])


def extend(result, ctx: dict) -> dict:
    post = result.posterior
    return {"u": post.extend(ctx["X_test"], block="u"),
            "a": torch.exp(post.extend(ctx["X_test"], block="a")), "z": result.z}


def gate_values(outputs: dict, ctx: dict) -> torch.Tensor:
    """``[test_l2, a_rel_l2]`` on the device."""
    e = outputs["u"] - ctx["truth"]
    a_rel = (torch.linalg.vector_norm(outputs["a"] - ctx["a_truth"])
             / torch.linalg.vector_norm(ctx["a_truth"]))
    return torch.stack([torch.sqrt(torch.mean(e * e)), a_rel])


GATES = ("test_l2", "a_rel_l2")


def kernel_work(cfg: dict, sizes: dict, esize: int, ctx: dict) -> dict:
    """Per solve: K1 writes the two test cross-Grams (the mesh path's
    Gram matrices are K2's); K2 writes each block's equilibrated Gram
    matrix once, its lower triangle (the factor's strips). On the dense
    path K1 writes the Gram matrices too."""
    nd, nb = sizes["n_domain"], sizes["n_boundary"]
    seg_a = [(rl.D0, nd), (rl.D1, nd), (rl.IDENTITY, nd)]
    seg_u = [(rl.D0, nd), (rl.D1, nd), (rl.LAPLACIAN, nd), (rl.IDENTITY, nd), (rl.IDENTITY, nb)]
    rows = ctx["X_test"].shape[0]
    cross = (rl.cross_work(rows, rl.IDENTITY, seg_a, nd, esize)
             + rl.cross_work(rows, rl.IDENTITY, seg_u, nd + nb, esize))
    grams = [(seg_a, nd), (seg_u, nd + nb)]
    if not sizes.get("mesh"):
        k1 = cross
        for segs, pts in grams:
            k1 = k1 + rl.gram_work(segs, pts, esize)
        return {"k1": k1}
    k2 = None
    for segs, pts in grams:
        w = rl.gram_work(segs, pts, esize, lower_only=True, equilibrated=True)
        k2 = w if k2 is None else k2 + w
    return {"k1": cross, "k2": k2}
