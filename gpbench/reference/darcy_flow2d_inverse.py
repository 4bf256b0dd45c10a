"""Plain reference of the Darcy-flow inverse problem.

``-div(a grad u) = f`` with ``a = exp(phi)``, ``f = 1`` and ``u = 0`` on the
boundary of the unit square, ``u`` observed with noise at the first ``K``
interior points. Joint GPs on ``phi`` (block ``a``) and ``u`` (block
``u``), written from the mathematics:

* latent ``z = (phi, phi_x1, phi_x2, u, u_x1, u_x2)`` at the ``N``
  interior points;
* block ``a`` observes ``[phi_x1, phi_x2, phi]`` at the interior points,
  with values ``F_a(z) = [w1, w2, w0]``;
* block ``u`` observes ``[u_x1, u_x2, Delta u, u]`` at the interior points
  and ``u`` at the boundary, with ``Delta u = -u_x1 phi_x1 - u_x2 phi_x2
  - f exp(-phi)`` from the PDE: ``F_u(z) = [v1, v2, Delta u, v0, 0]``;
* the loss is ``|L_a^{-1} F_a|^2 + |L_u^{-1} F_u|^2 + |v0[:K] - obs|^2 /
  noise^2``;
* Gauss-Newton takes the exact step ``(J^T J)^{-1} J^T r`` under the guarded
  update of the configuration: the full step unless it is non-finite or
  more than doubles the loss, else halved up to four times, the best finite
  trial kept;
* the posterior means at the test points are ``K(X, .) Theta^{-1} F(z*)``
  of each block, and ``a = exp(phi)``.
"""

from __future__ import annotations

import torch

from . import gaussian
from .linalg import Precision, gn_direction, whitening


def solve(cfg: dict, inputs: dict, X_test: torch.Tensor, prec: Precision = Precision(),
          working_dtype: torch.dtype = torch.float32) -> dict:
    """``{"u", "a", "z", "scales"}``: the posterior means of ``u`` and
    ``a`` at ``X_test``, the last iterate and each block's nugget scale, in
    ``prec``; ``working_dtype`` (the configuration's) sets the nugget rule."""
    dt = prec.dtype
    Xd, Xb = inputs["X_domain"].to(dt), inputs["X_boundary"].to(dt)
    obs, z = inputs["obs"].to(dt), inputs["z0"].to(dt)
    dev = Xd.device
    N, K = Xd.shape[0], obs.shape[0]
    m = 6 * N
    a = 1.0 / (2.0 * cfg["sigma"] ** 2)
    weight = 1.0 / cfg["noise"] ** 2
    seg_a = [("d0", Xd), ("d1", Xd), ("id", Xd)]
    seg_u = [("d0", Xd), ("d1", Xd), ("lap", Xd), ("id", Xd), ("id", Xb)]
    W, scales = {}, {}
    for name, segs in (("a", seg_a), ("u", seg_u)):
        W[name], scales[name] = whitening(segs, a, cfg["nugget"], dt, working_dtype)
    zeros_b = torch.zeros(Xb.shape[0], dtype=dt, device=dev)

    def parts(z):
        return z.view(6, N).unbind(0)

    def F(z):
        w0, w1, w2, v0, v1, v2 = parts(z)
        lap = -v1 * w1 - v2 * w2 - torch.exp(-w0)
        return torch.cat([w1, w2, w0]), torch.cat([v1, v2, lap, v0, zeros_b])

    def residual(z):
        Fa, Fu = F(z)
        return torch.cat([prec.mm(W["a"], Fa[:, None])[:, 0], prec.mm(W["u"], Fu[:, None])[:, 0],
                          weight**0.5 * (z[3 * N : 3 * N + K] - obs)])

    def jacobian(z):
        w0, w1, w2, v0, v1, v2 = parts(z)
        eye = torch.eye(N, dtype=dt, device=dev)
        Ja = torch.zeros((3 * N, m), dtype=dt, device=dev)
        Ja[:N, N : 2 * N] = eye
        Ja[N : 2 * N, 2 * N : 3 * N] = eye
        Ja[2 * N :, :N] = eye
        Ju = torch.zeros((4 * N + Xb.shape[0], m), dtype=dt, device=dev)
        Ju[:N, 4 * N : 5 * N] = eye
        Ju[N : 2 * N, 5 * N :] = eye
        for col, dval in ((0, torch.exp(-w0)), (1, -v1), (2, -v2), (4, -w1), (5, -w2)):
            Ju[2 * N : 3 * N, col * N : (col + 1) * N] = torch.diag(dval)
        Ju[3 * N : 4 * N, 3 * N : 4 * N] = eye
        Jm = torch.zeros((K, m), dtype=dt, device=dev)
        Jm[:, 3 * N : 3 * N + K] = weight**0.5 * torch.eye(K, dtype=dt, device=dev)
        return torch.cat([prec.mm(W["a"], Ja), prec.mm(W["u"], Ju), Jm])

    def trial(z, delta, s):
        zt = z - s * delta
        if not bool(torch.isfinite(zt).all()):
            return z, float("inf"), False
        r = residual(zt)
        return zt, float(torch.dot(r, r)), True

    loss_in = float("inf")
    for _ in range(cfg["gn_steps"]):
        delta = gn_direction(prec, jacobian(z), residual(z))
        zc, lc, fc = trial(z, delta, 1.0)
        if lc > 2.0 * loss_in:
            s = 1.0
            for _ in range(4):
                go_on = lc > 2.0 * loss_in
                s *= 0.5
                z2, l2, f2 = trial(z, delta, s)
                if go_on and l2 < lc:
                    zc, lc, fc = z2, l2, fc or f2
        if fc:
            z, loss_in = zc, lc
    Fa, Fu = F(z)
    Xt = X_test.to(dt)
    out = {"z": z, "scales": scales}
    for name, segs, Fb in (("a", seg_a, Fa), ("u", seg_u, Fu)):
        w = prec.mm(W[name].T, prec.mm(W[name], Fb[:, None]))
        out[name] = prec.mm(gaussian.cross("id", Xt, segs, a), w)[:, 0]
    out["a"] = torch.exp(out["a"])
    return out
