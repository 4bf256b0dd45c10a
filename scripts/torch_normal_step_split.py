#!/usr/bin/env python3
"""Where one warm ``'normal'`` Gauss-Newton step spends its device time.

    python3 scripts/torch_normal_step_split.py [--n_domain 5000 --n_boundary 1000]
        [--reps 5] [--out normal_split.json]

Builds a Burgers problem at the benchmark cell's size (5,000 + 1,000
points, latent 15,000, float32, a one-card mesh), factors it, computes the
``'normal'`` state once, and then runs the pieces of one step at a random
iterate, each warm once and then timed ``--reps`` times by CUDA events
(median) and profiled once by ``torch.profiler`` (the device time of its
kernels and the four largest):

* ``linearize_gradient``: the blocks' linearization and the gradient;
* ``diagonals``: the per-slice diagonals on the live segments;
* ``assembly_einsum``: the einsum assembly of ``H`` off the kernel's
  route (``ops/normal_matrix.py::einsum_normal_matrix``: three slice
  contractions, the ``cat`` and the add);
* ``equilibrate``: ``ops/linalg.py::equilibrate_floored``, the scales from
  ``diag(H)``, their outer product, the scaled copy and the ``1 + 32 eps``
  floor;
* ``assembly_kernel``: the scales from the inverse blocks' diagonal and
  the equilibrated matrix in one launch of the normal-matrix kernel, with
  its largest gap to ``equilibrate``'s matrix;
* ``cholesky``: ``cholesky_ex`` of the equilibrated matrix;
* ``solve``: ``cholesky_solve`` and the scaling;
* ``update``: the full trial of the guarded update (the whitened residual);
* ``step``: ``_normal_delta`` whole, as the loop runs it (the tree's route),
  with its peak of allocated memory.

Each piece calls the solver's own functions. Needs a CUDA card.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

DOMAIN = ((0.0, 1.0), (-1.0, 1.0))


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import nonlinpdes_gpsolver_tpu_torch as tpt
    from nonlinpdes_gpsolver_tpu_torch.ops import normal_matrix as nm
    from nonlinpdes_gpsolver_tpu_torch.ops.linalg import equilibrate_floored
    from nonlinpdes_gpsolver_tpu_torch.solvers import distributed as tdist

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n_domain", type=int, default=5000)
    ap.add_argument("--n_boundary", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    Xd, Xb = tpt.utils.sample_random(gen, args.n_domain, args.n_boundary, domain=DOMAIN,
                                     time_dependent=True, dtype=torch.float32)

    def g0(x):
        return torch.where(x[0] == 0.0, -torch.sin(torch.pi * x[1]), 0.0)

    prob = tpt.models.burgers(tpt.SquaredExponential.anisotropic([0.3, 0.05]), Xd, Xb, g0,
                              nu=0.02, seed=args.seed)
    solver = tpt.GPSolver(prob, nugget=1e-5, mesh=tpt.parallel.make_mesh(1, device=dev))
    fp = solver.fp
    structure = tdist._slice_structure(prob)
    ainvs = tdist._normal_state(fp, structure)
    z = 0.1 * torch.randn(prob.latent_dim, generator=gen, device=dev, dtype=torch.float32)
    m = prob.latent_dim
    st = {}

    def linearize_gradient():
        st["lins"] = tdist._linearize_blocks(fp, z)
        st["g"] = tdist._gradient(fp, st["lins"], z)

    def diagonals():
        st["Dls"] = tdist._live_diagonals(prob, z, structure)

    def assembly_einsum():
        st["H"] = nm.einsum_normal_matrix(list(zip(ainvs, st["Dls"])), (), z)

    def equilibrate():
        st["Hs"], st["d_isqrt"] = equilibrate_floored(st["H"])

    def assembly_kernel():
        st["Hk"] = tdist._equilibrated_normal_matrix(prob, z, list(zip(ainvs, st["Dls"])), 0.0)[0]

    def cholesky():
        st["L"], st["info"] = torch.linalg.cholesky_ex(st["Hs"])

    def solve():
        d_isqrt = st["d_isqrt"]
        x = d_isqrt * torch.cholesky_solve((d_isqrt * st["g"])[:, None], st["L"], upper=False)[:, 0]
        st["delta"] = torch.where(st["info"] == 0, x, torch.full_like(x, float("nan")))

    def update():
        st["trial"] = tdist._trial(fp, z, st["delta"], 1.0, 1.0, torch.tensor(1e30, device=dev))

    def step():
        st["step"] = tdist._normal_delta(fp, z, structure, ainvs, 0.0)

    pieces = [("linearize_gradient", linearize_gradient), ("diagonals", diagonals),
              ("assembly_einsum", assembly_einsum), ("equilibrate", equilibrate),
              ("assembly_kernel", assembly_kernel), ("cholesky", cholesky), ("solve", solve),
              ("update", update), ("step", step)]

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(args.reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        return ms

    def profiled(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        return sum(by_name.values()), [[n[:90], round(v, 4)] for n, v in top]

    rows = {}
    for name, fn in pieces:
        if name == "step":
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        ms = timed(fn)
        kernel_ms, top = profiled(fn)
        row = {"ms_median": statistics.median(ms), "ms": [round(v, 4) for v in ms],
               "kernel_ms": kernel_ms, "top": top}
        if name == "step":
            row["peak_above_base_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        if name == "assembly_kernel":
            row["max_gap_to_einsum"] = float((st["Hk"] - st["Hs"]).abs().max())
        rows[name] = row
        print(json.dumps({"piece": name, **row}), flush=True)
    delta_gap = float((st["step"] - st["delta"]).abs().max() / st["delta"].abs().max())
    out = {"card": card(), "torch": torch.__version__, "n_domain": args.n_domain,
           "n_boundary": args.n_boundary, "latent": m, "S": [int(A.shape[0]) for A in ainvs],
           "step_vs_pieces_rel_gap": delta_gap, "pieces": rows}
    print(json.dumps({"summary": {k: round(v["ms_median"], 3) for k, v in rows.items()},
                      "card": out["card"], "step_vs_pieces_rel_gap": delta_gap}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
