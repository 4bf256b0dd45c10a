#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one CUDA card and check its kernels.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases, each printing one JSON line (any failure raises and exits non-zero):

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
1. build of every CUDA kernel of the path from ``csrc/`` (seconds, ptxas log);
2. the Gram tile kernel K1 against its plain PyTorch version on the card:
   10 kernel x operator-pair cases at 1500 x 700 plus a ragged 33 x 17
   case, in f32 (limit 1e-5 of the block's scale) and f64 (1e-12); and the
   f32 exponential's error in ulp over q in [0, 87] (limit 4);
3. the canonical solve (the JAX package's N=900 draw, f32, nugget 1e-5,
   4 GN steps, extension to a 60x60 grid): a cold run, then a warm run
   timed with ``torch.cuda.synchronize()``, whose K1 launches must be
   exactly 9 and whose test L2 must pass the 3.402e-3 gate, and five more
   warm runs for the spread; then K1 at each of those 9 block shapes, timed
   and checked against the plain version;
4. the largest dense solve (16,200 Gram rows: N_domain 7800, N_boundary
   600 from the port's sampler, seed 0): the problem is built and timed
   apart, then a cold solve, then a warm solve with its K1 launches (9),
   memory peak and the same gate, and two more warm solves for the spread;
   then the training-Gram assembly time beside K1's bound;
5. the kernel summary line; then the card's name and power limit, and
   last ``{"ok": true, "device": {...}}``.

Bounds use the H100 SXM data sheet: 3.35 TB/s of HBM, 67 TFLOP/s in f32
and 34 TFLOP/s in f64 outside the tensor cores.
"""

import json
import math
import subprocess
import time

GATE_L2 = 3.402e-3  # BASELINE.md row 1, the bench.py accuracy gate
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
EXP_OPS = 25  # Cody-Waite exp: reduction, 7 Horner FMAs, exponent assembly


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` calls, after two
    warm-up calls (CUDA events around the whole run)."""
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_bound_ms(table_degs, dim, n, m, dtype_name):
    """Least time for one K1 block: each input read once and the output
    written once at the HBM rate, against the operations on the way."""
    esize = 4 if dtype_name == "float32" else 8
    n_terms = table_degs.shape[0]
    bytes_moved = esize * ((n + m) * dim + n * m + dim + n_terms * (1 + dim * 9)) + 4 * table_degs.size
    per_entry = dim + 3 * dim + EXP_OPS + 1  # u, q, exp, final product
    for row in table_degs:
        per_entry += 1 + sum(2 * int(d) + 1 for d in row if d > 0)  # Horner FMAs, products, sum
    flops = per_entry * n * m
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def u_truth(x):
    import torch

    return torch.sin(torch.pi * x[0]) * torch.sin(torch.pi * x[1]) + 2 * torch.sin(
        4 * torch.pi * x[0]
    ) * torch.sin(4 * torch.pi * x[1])


def rhs_f(x):
    import torch

    return -torch.trace(torch.func.hessian(u_truth)(x)) + u_truth(x) ** 3


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; no result")
    import numpy as np

    import nonlinpdes_gpsolver_tpu_torch as tpt
    from nonlinpdes_gpsolver_tpu_torch.ops import _build, gram_tile
    from nonlinpdes_gpsolver_tpu_torch.ops.operators import d, d2, identity, laplacian

    dev = torch.device("cuda")
    card = smi("name,power.limit")
    emit("device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    # -- 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    gram_tile._kernel_lib()
    build_s = time.perf_counter() - t0
    log_path = str(_build.library_path("gram_tile")) + ".log"
    with open(log_path) as fh:
        ptxas = [ln.strip() for ln in fh if "registers" in ln or "spill" in ln]
    emit("build", kernel="gram_tile", seconds=build_s, ptxas=ptxas)

    # -- 2. K1 against its plain version --------------------------------------
    kernels = {
        "iso sigma=0.2": tpt.SquaredExponential.gaussian(0.2),
        "aniso [0.3,0.05]": tpt.SquaredExponential.anisotropic([0.3, 0.05]),
    }
    pairs = [
        ("id", "id", identity(), identity()),
        ("lap", "id", laplacian(), identity()),
        ("lap", "lap", laplacian(), laplacian()),
        ("d0", "d0", d(0), d(0)),
        ("d11", "id", d2(1, 1), identity()),
    ]
    limits = {torch.float32: 1e-5, torch.float64: 1e-12}
    rng = np.random.default_rng(0)
    Xn, Yn = rng.uniform(0, 1, (1500, 2)), rng.uniform(0, 1, (700, 2))
    Xr, Yr = rng.uniform(0, 1, (33, 2)), rng.uniform(0, 1, (17, 2))
    cases = [(kn, k, ox, oy, a, b, Xn, Yn) for kn, k in kernels.items() for ox, oy, a, b in pairs]
    cases.append(("aniso [0.3,0.05]", kernels["aniso [0.3,0.05]"], "lap", "d1", laplacian(), d(1), Xr, Yr))
    rows, worst = [], {}
    for dtype, limit in limits.items():
        for kn, k, ox, oy, a, b, X, Y in cases:
            Xc = torch.as_tensor(X, dtype=dtype, device=dev)
            Yc = torch.as_tensor(Y, dtype=dtype, device=dev)
            got = gram_tile.gram_tile_pair_fn(k, a, b)(Xc, Yc)
            ref = k.pair_fn(a, b)(Xc, Yc)
            torch.cuda.synchronize()
            rel = float((got - ref).abs().max() / ref.abs().max())
            check(math.isfinite(rel) and rel <= limit, f"K1 {kn} {ox}x{oy} {dtype}: {rel:.3e} > {limit}")
            rows.append({"kernel": kn, "ops": f"{ox}x{oy}", "shape": list(got.shape),
                         "dtype": str(dtype).split(".")[1], "rel_err": rel})
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), rel)
    q = np.linspace(0.0, 87.0, 1 << 20)
    u32 = np.sqrt(q).astype(np.float32)
    q32 = (u32 * u32).astype(np.float32)  # the kernel's q = fl(u * u) for a = 1
    e = gram_tile.gram_tile_pair_fn(tpt.SquaredExponential((1.0,)), identity(1), identity(1))(
        torch.as_tensor(u32[:, None], device=dev), torch.zeros((1, 1), device=dev)
    )[:, 0].cpu().numpy()
    truth = np.exp(-q32.astype(np.float64))
    ulp = float((np.abs(e.astype(np.float64) - truth) / np.spacing(truth.astype(np.float32))).max())
    check(ulp <= 4.0, f"f32 exp error {ulp} ulp > 4")
    emit("k1_vs_plain", cases=rows, worst_rel_err=worst, limits={str(k): v for k, v in limits.items()},
         exp_f32_max_ulp=ulp, exp_q_range=[0.0, 87.0], exp_points=int(q.size))

    # -- 3. canonical solve ---------------------------------------------------
    inp = tpt.interop.load_canonical_inputs()
    Xt = tpt.utils.test_grid(60, 60, device=dev)
    truth_t = torch.func.vmap(u_truth)(Xt)

    def canonical():
        prob = tpt.interop.problem_from_numpy(**inp, device=dev)
        res = tpt.GPSolver(prob, nugget=1e-5).solve(max_iter=4)
        pred = res.posterior.extend(Xt)
        return prob, res, tpt.GPSolver.errors(pred, truth_t)

    t0 = time.perf_counter()
    canonical()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    gram_tile.LAUNCHES = 0
    t0 = time.perf_counter()
    prob, res, err = canonical()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = gram_tile.LAUNCHES
    repeats = []  # the spread of the warm time (the solve is host-bound at this size)
    for _ in range(5):
        t0 = time.perf_counter()
        canonical()
        torch.cuda.synchronize()
        repeats.append(time.perf_counter() - t0)
    emit("canonical_solve", n_domain=900, n_boundary=124, gram_rows=1924, dtype="float32",
         nugget=1e-5, gn_steps=4, e2e_seconds=warm_s, cold_seconds=cold_s,
         repeat_e2e_seconds=repeats,
         phase_seconds=res.timers, test_l2=err.l2, test_max=err.max,
         nugget_scales=res.posterior.fp.nugget_scales, rungs=res.posterior.fp.rungs,
         losses=res.state.losses.tolist(), k1_launches=launches, gate_l2=GATE_L2)
    check(launches == 9, f"canonical solve launched K1 {launches} times, expected 9")
    check(err.l2 <= GATE_L2, f"canonical test L2 {err.l2:.4e} > {GATE_L2}")
    check(bool(res.state.converged_finite), "canonical GN rejected a step")

    def main_path_blocks(problem, X_test):
        """The (kernel, op_x, op_y, X, Y) of every K1 launch of a solve:
        the upper training-Gram blocks, then the test cross-Gram blocks."""
        blk = problem.blocks[0]
        pts, obs = problem.points, blk.observables
        out = [(blk.kernel, oi.op, oj.op, pts[oi.points], pts[oj.points])
               for i, oi in enumerate(obs) for oj in obs[i:]]
        out += [(blk.kernel, identity(), o.op, X_test, pts[o.points]) for o in obs]
        return out

    def time_blocks(blocks, reps, plain_reps):
        out, max_abs, max_rel = [], 0.0, 0.0
        for k, a, b, X, Y in blocks:
            fn = gram_tile.gram_tile_pair_fn(k, a, b)
            plain = k.pair_fn(a, b)
            got, ref = fn(X, Y), plain(X, Y)
            diff = float((got - ref).abs().max())
            rel = diff / float(ref.abs().max())
            check(rel <= limits[X.dtype], f"K1 at main-path shape {tuple(got.shape)}: {rel:.3e}")
            max_abs, max_rel = max(max_abs, diff), max(max_rel, rel)
            _, degs = gram_tile.pack_terms(k.inv_sq, a.terms, b.terms)
            bound, by = k1_bound_ms(degs, k.dim, X.shape[0], Y.shape[0], str(X.dtype).split(".")[1])
            outbuf = torch.empty_like(got)
            out.append({"shape": [X.shape[0], Y.shape[0]], "ops": f"{a.label}x{b.label}",
                        "ms": time_ms(lambda: fn(X, Y, out=outbuf), reps),
                        "plain_ms": time_ms(lambda: plain(X, Y), plain_reps),
                        "bound_ms": bound, "bound_by": by})
            del got, ref, outbuf
        return out, max_abs, max_rel

    canon_blocks, canon_abs, canon_rel = time_blocks(main_path_blocks(prob, Xt), 50, 10)
    emit("k1_canonical_blocks", card=card, blocks=canon_blocks, max_abs_err=canon_abs,
         max_rel_err=canon_rel)

    # -- 4. largest dense solve ------------------------------------------------
    del prob, res
    gen = torch.Generator(device=dev).manual_seed(0)
    Xd, Xb = tpt.utils.sample_random(gen, 7800, 600)
    kernel = tpt.SquaredExponential.gaussian(0.2)
    t0 = time.perf_counter()
    big = tpt.models.nonlinear_elliptic(kernel, Xd, Xb, rhs_f, u_truth, seed=1)
    torch.cuda.synchronize()
    problem_s = time.perf_counter() - t0

    def large():
        res = tpt.GPSolver(big, nugget=1e-5).solve(max_iter=4)
        pred = res.posterior.extend(Xt)
        return res, pred, tpt.GPSolver.errors(pred, truth_t)

    t0 = time.perf_counter()
    large()
    torch.cuda.synchronize()
    big_cold_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    gram_tile.LAUNCHES = 0
    t0 = time.perf_counter()
    big_res, big_pred, big_err = large()
    torch.cuda.synchronize()
    big_s = time.perf_counter() - t0
    big_launches = gram_tile.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    big_repeats = []  # the spread of the warm time: solve, factor and phase seconds
    for _ in range(2):
        t0 = time.perf_counter()
        r, _, _ = large()
        torch.cuda.synchronize()
        big_repeats.append({"e2e_seconds": time.perf_counter() - t0, "phase_seconds": r.timers})
        del r
    finite = bool(torch.isfinite(big_pred).all()) and bool(torch.isfinite(big_res.z).all())
    obs = big.blocks[0].observables
    assembly_ms = time_ms(lambda: tpt.ops.gram_matrix(kernel, obs, big.points), 3)
    big_blocks, big_abs, big_rel = time_blocks(main_path_blocks(big, Xt), 5, 2)
    gram_bound = sum(b["bound_ms"] for b in big_blocks[:6])
    emit("large_solve", n_domain=7800, n_boundary=600, gram_rows=16200, dtype="float32",
         nugget=1e-5, gn_steps=4, problem_seconds=problem_s, cold_seconds=big_cold_s,
         e2e_seconds=big_s, phase_seconds=big_res.timers, repeats=big_repeats,
         max_memory_allocated=peak, test_l2=big_err.l2, test_max=big_err.max, finite=finite,
         nugget_scales=big_res.posterior.fp.nugget_scales, rungs=big_res.posterior.fp.rungs,
         losses=big_res.state.losses.tolist(), k1_launches=big_launches,
         gram_assembly_ms=assembly_ms, gram_k1_bound_ms=gram_bound,
         k1_blocks=big_blocks, max_abs_err=big_abs, max_rel_err=big_rel, card=card)
    check(finite, "large solve produced non-finite values")
    check(big_err.l2 <= GATE_L2, f"large test L2 {big_err.l2:.4e} > {GATE_L2}")
    check(big_launches == 9, f"large solve launched K1 {big_launches} times, expected 9")

    # -- 5. summary -------------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "gram_tile",
        "route": "cuda",
        "source": "nonlinpdes_gpsolver_tpu_torch/csrc/gram_tile.cu",
        "replaces": "nonlinpdes_gpsolver_tpu/ops/pallas_gram.py:54",
        "launches": launches,
        "max_abs_err": canon_abs,
        "ms": sum(b["ms"] for b in canon_blocks),
        "plain_ms": sum(b["plain_ms"] for b in canon_blocks),
        "bound_ms": sum(b["bound_ms"] for b in canon_blocks),
        "bound_by": max(canon_blocks, key=lambda b: b["bound_ms"])["bound_by"],
        "library_ms": None,
        "checked": True,
        "per": "the canonical solve's 9 launches, summed",
        "large_solve_ms": sum(b["ms"] for b in big_blocks),
        "large_solve_plain_ms": sum(b["plain_ms"] for b in big_blocks),
        "large_solve_bound_ms": sum(b["bound_ms"] for b in big_blocks),
        "large_solve_launches": big_launches,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
