#!/usr/bin/env python3
"""Why the port factors the equilibrated Gram matrix in f64 on the card.

    python3 scripts/torch_escalation_probe.py [--sizes 900:124 7800:600]

For each size (the canonical N=900 draw of the JAX package, and the port's
sampler with seed 0 for other sizes) it assembles the f32 Gram matrix on the
card with the Gram tile kernel at nugget 1e-5 and, for each escalation
scale s in 1, 10, 100, prints one JSON line with:

* ``info`` of ``cholesky_ex`` on the equilibrated matrix as the solver forms
  it (``linalg.equilibrate``: the f32 Gram scaled in f64), factored in f64
  and, cast down, in f32 (0 means the factorization succeeded), and the device
  milliseconds of each (CUDA events, mean of 3 after a warm-up);
* the extreme eigenvalues of that matrix, computed in f64;
* the whitening-quality residual the solver tests (``max|W(Lv) - v| /
  max|v|``, limit 1e-2) of the f64 factor cast to f32, with 0 and 1 Newton
  steps on its f32 triangular inverse;
* the scale the solver accepts and the test L2 of the whole solve at
  ``nugget = 1e-5 * s`` on a 60x60 grid.

Needs a CUDA card.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    import torch

    import nonlinpdes_gpsolver_tpu_torch as tpt
    from nonlinpdes_gpsolver_tpu_torch.ops import linalg
    from nonlinpdes_gpsolver_tpu_torch.solvers import gn

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sizes", nargs="+", default=["900:124", "7800:600"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")

    def u_truth(x):
        return torch.sin(torch.pi * x[0]) * torch.sin(torch.pi * x[1]) + 2 * torch.sin(
            4 * torch.pi * x[0]
        ) * torch.sin(4 * torch.pi * x[1])

    def rhs_f(x):
        return -torch.trace(torch.func.hessian(u_truth)(x)) + u_truth(x) ** 3

    def chol_ms(M):
        torch.linalg.cholesky_ex(M)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            torch.linalg.cholesky_ex(M)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 3

    Xt = tpt.utils.test_grid(60, 60, device=dev)
    truth = torch.func.vmap(u_truth)(Xt)
    for size in args.sizes:
        n_dom, n_bdy = map(int, size.split(":"))
        if (n_dom, n_bdy) == (900, 124):
            prob = tpt.interop.problem_from_numpy(**tpt.interop.load_canonical_inputs(), device=dev)
        else:
            gen = torch.Generator(device=dev).manual_seed(0)
            Xd, Xb = tpt.utils.sample_random(gen, n_dom, n_bdy)
            prob = tpt.models.nonlinear_elliptic(
                tpt.SquaredExponential.gaussian(0.2), Xd, Xb, rhs_f, u_truth, seed=1
            )
        b = prob.blocks[0]
        theta = tpt.ops.gram_matrix(b.kernel, b.observables, prob.points)
        sizes = tpt.ops.observable_sizes(b.observables, prob.points)
        nug = tpt.ops.adaptive_nugget_diag(theta, b.observables, sizes, 1e-5)
        probe = linalg.probe_vector(theta.shape[0], theta.dtype, dev)
        for s in (1.0, 10.0, 100.0):
            M64, d_isqrt = linalg.equilibrate(theta, nug, s)
            row = {"n_domain": n_dom, "n_boundary": n_bdy, "rows": theta.shape[0], "s": s}
            row["info_f32"] = int(torch.linalg.cholesky_ex(M64.float())[1])
            row["chol_f32_ms"] = chol_ms(M64.float())
            L, info = torch.linalg.cholesky_ex(M64)
            row["info_f64"] = int(info)
            row["chol_f64_ms"] = chol_ms(M64)
            ev = torch.linalg.eigvalsh(M64)
            row["eig_min"], row["eig_max"] = float(ev[0]), float(ev[-1])
            del ev, M64
            if int(info) == 0:
                L = L.float()
                W = linalg.tri_inverse(L)
                for steps in (0, 1):
                    Ws = linalg.newton_refine_tri_inverse(L, W, steps) if steps else W
                    row[f"quality_newton{steps}"] = float(gn._whiten_quality(
                        Ws * d_isqrt[None, :], L, d_isqrt, probe
                    ))
                del W, Ws
            del L
            torch.cuda.empty_cache()
            try:
                res = tpt.GPSolver(prob, nugget=1e-5 * s).solve(max_iter=4)
                err = tpt.GPSolver.errors(res.posterior.extend(Xt), truth)
                row["solve_scale"] = res.posterior.fp.nugget_scales["u"]
                row["test_l2"] = err.l2
                del res
            except FloatingPointError as exc:
                row["solve_error"] = str(exc)
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({"card": card}), flush=True)


if __name__ == "__main__":
    main()
