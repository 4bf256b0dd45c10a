"""The benchmark's side of ``burgers1d``: draws, the program's problem, its
outputs and gates, and the Gram work the kernels do.

Set-up puts the space-time test grid and the Cole-Hopf truth on it
(``frozen/burgers.py``, computed on the host in float64) on the device. A
draw (one solve of the stream) is the interior and boundary points of the
frozen space-time sampler and the latent start ``z0`` (``3 n_domain``: u,
u_x and u_xx at the interior points), all from one ``torch.Generator`` on
the device, seeded per solve. The program gets them through its public
model constructor, with the boundary values as a callable of one point and
no right-hand side, as a user script passes them; the solver picks its
path and its Gauss-Newton step itself.
"""

from __future__ import annotations

import torch

from gpbench.frozen import burgers as fb
from gpbench.frozen import roofline as rl

OUTPUTS = ("u", "z")
D11: rl.Op = ((1.0, (0, 2)),)  # u_xx: the second derivative in x, coordinates (t, x)
# Gram rows from which the program takes the mesh path by itself
# (nonlinpdes_gpsolver_tpu_torch/api.py::_AUTO_MESH_GRAM_ROWS at commit 84de896);
# there K2 writes the Gram matrix and K1 the test cross-Gram only.
MESH_ROWS = 16384


def setup(cfg: dict, device, dtype) -> dict:
    X_test = fb.test_grid(cfg["test_grid"], cfg["test_grid"], torch.float64, "cpu")
    truth = fb.cole_hopf_truth(cfg["nu"])(X_test[:, 0].numpy(), X_test[:, 1].numpy())
    return {"X_test": X_test.to(device=device, dtype=dtype),
            "truth": torch.as_tensor(truth, dtype=dtype, device=device)}


def draw(cfg: dict, sizes: dict, gen: torch.Generator, dtype, ctx: dict) -> dict:
    Xd, Xb = fb.sample_random(gen, sizes["n_domain"], sizes["n_boundary"], dtype)
    z0 = torch.randn(3 * sizes["n_domain"], generator=gen, dtype=dtype, device=gen.device)
    return {"X_domain": Xd, "X_boundary": Xb, "z0": z0}


def build(tpt, cfg: dict, inputs: dict, ctx: dict):
    kernel = tpt.SquaredExponential.anisotropic(cfg["lengthscales"])
    return tpt.models.burgers(kernel, inputs["X_domain"], inputs["X_boundary"], fb.g,
                              rhs_f=None, alpha=cfg["alpha"], nu=cfg["nu"])


def extend(result, ctx: dict) -> dict:
    return {"u": result.posterior.extend(ctx["X_test"]), "z": result.z}


def gate_values(outputs: dict, ctx: dict) -> torch.Tensor:
    """``[test_l2]`` on the device: the RMS error against the truth."""
    e = outputs["u"] - ctx["truth"]
    return torch.sqrt(torch.mean(e * e)).reshape(1)


GATES = ("test_l2",)


def kernel_work(cfg: dict, sizes: dict, esize: int, ctx: dict) -> dict:
    """Per solve: K1 writes the test cross-Gram, and on the dense path the
    Gram matrix too; on the mesh path (``mesh`` given, or ``MESH_ROWS``
    rows) K2 writes the equilibrated Gram matrix once, its lower triangle."""
    nd, nb = sizes["n_domain"], sizes["n_boundary"]
    segs = [(rl.D0, nd), (rl.D1, nd), (D11, nd), (rl.IDENTITY, nd), (rl.IDENTITY, nb)]
    cross = rl.cross_work(ctx["X_test"].shape[0], rl.IDENTITY, segs, nd + nb, esize)
    if not sizes.get("mesh") and 4 * nd + nb < MESH_ROWS:
        return {"k1": cross + rl.gram_work(segs, nd + nb, esize)}
    return {"k1": cross,
            "k2": rl.gram_work(segs, nd + nb, esize, lower_only=True, equilibrated=True)}
